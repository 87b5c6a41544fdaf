#!/usr/bin/env python3
"""Compare the port's gate speed between two trees on one CUDA card.

    python3 ab_gates_torch.py OLD_TREE [NEW_TREE]

Each tree is a checkout of this repository (NEW_TREE defaults to the one
that holds this script).  The trees run in turns, OLD, NEW, NEW, OLD, each
in a process of its own that builds the tree's kernels and imports the
tree's ``nufhe_tpu_torch``: keys from ``make_key_pair(DeterministicRNG(2026),
lwe_size=500)`` with the tree's default placement (the 'FFT' key from the
same arrays), then the warm ms/bit of NAND at batch 2^14 on the default
path in both engines, the per-step path (``chunk_steps=1``) and the lanes
path in both engines, and of MUX on the default path: three synchronised
host-clock runs each after a checked warm-up.  One JSON line a turn, then
the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

BATCH = 1 << 14


def one_tree(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.kernels import build
    if not os.path.abspath(nft.__file__).startswith(root + os.sep):
        raise RuntimeError("imported %s, not the tree %s" % (nft.__file__, root))
    t0 = time.time()
    build.build_all()
    out = {"tree": root, "build_s": time.time() - t0}
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    t0 = time.time()
    secret, cloud = nft.make_key_pair(nft.DeterministicRNG(2026), lwe_size=500)
    bk, ks = cloud.bootstrap_key, cloud.keyswitch_key
    cloud_fft = nft.cloud_key_from_arrays(
        nft.NuFHEParameters(transform_type='FFT', lwe_size=500), bk.bk_coeff,
        bk.cv, ks.ks_a, ks.ks_b, ks.ks_cv, ks.log2_base)
    torch.cuda.synchronize()
    out["keygen_s"] = time.time() - t0
    lanes = nft.PerformanceParameters(single_kernel_bootstrap=False)
    vms = {"default NTT": nft.VirtualMachine(cloud, device=dev),
           "default FFT": nft.VirtualMachine(cloud_fft, device=dev),
           "per-step NTT": nft.VirtualMachine(
               cloud, nft.PerformanceParameters(chunk_steps=1), device=dev),
           "lanes NTT": nft.VirtualMachine(cloud, lanes, device=dev),
           "lanes FFT": nft.VirtualMachine(cloud_fft, lanes, device=dev)}
    rng = np.random.RandomState(2026)
    x, y, z = (rng.randint(0, 2, BATCH).astype(bool) for _ in range(3))
    crng = nft.DeterministicRNG(2028)
    cx, cy, cz = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y, z))

    def ms_bit(vm, gate, args, want):
        first = getattr(vm, gate)(*args)
        torch.cuda.synchronize()
        if not np.array_equal(nft.decrypt(secret, first), want):
            raise AssertionError("%s decrypts wrong" % gate)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            getattr(vm, gate)(*args)
            torch.cuda.synchronize()
            times.append((time.time() - t) * 1e3 / BATCH)
        return times

    for label, vm in vms.items():
        out[label + " NAND"] = ms_bit(vm, "gate_nand", (cx, cy), ~(x & y))
    out["default NTT MUX"] = ms_bit(vms["default NTT"], "gate_mux",
                                    (cx, cy, cz), np.where(x, y, z))
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one_tree(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = os.path.abspath(sys.argv[1])
    new = os.path.abspath(sys.argv[2] if len(sys.argv) == 3
                          else os.path.dirname(os.path.abspath(__file__)))
    for tree in (old, new, new, old):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True, timeout=600)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
