#!/usr/bin/env python3
"""Drive nufhe_tpu_torch on one CUDA card and check every kernel it runs.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``nufhe_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and print ``ptxas``'s register/spill lines;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the small shapes and at the main path's shape (batch 4096);
4. the main path at the default parameters (n=500, N=1024, exact engine):
   host keygen from a seed, encrypt 4096 random bit pairs, ``gate_nand`` on
   the card, decrypt against the truth table, the largest phase error, the
   launch counts (500 CMUX steps and 1 keyswitch per gate, counted from 0
   just before the gate), and the card's output for 8 of the pairs against
   the same gate run on the CPU through the plain versions;
5. timing at batch 2^14: warm NAND ms/bit, and each kernel's ms per launch
   beside its plain version, a PyTorch library call where one computes the
   same function, and its bound;
6. a ``kernels`` JSON line, then the ``nvidia-smi`` line, then the result
   line ``{"ok": true, "device": {...}}``.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over 67e12/s.
Both kernels do 64-bit or 32-bit integer arithmetic outside the tensor
cores, for which the H100 data sheet states no rate; 67e12/s, its float32
rate outside the tensor cores, is the highest rate it states for such
units, so the bound is a least time.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SEED = 2026
MAIN_BATCH = 4096
TIMING_BATCH = 1 << 14


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(x, y):
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


def cmux_inputs(rng, batch, dev, tp):
    from nufhe_tpu_torch.ops import transform as tf
    acc = torch.from_numpy(
        rng.randint(-2**31, 2**31, (batch, 2, 1024)).astype(np.int32)).to(dev)
    p = torch.from_numpy(rng.randint(0, 2048, (batch,)).astype(np.int32)).to(dev)
    bk = rng.randint(-2**31, 2**31, (1, 2, tp.decomp_length, 2, 1024)).astype(np.int32)
    key_row = tf.bootstrap_key_transformed(bk, dev)[0].contiguous()
    return acc, p, key_row


def keyswitch_inputs(rng, batch, dev):
    from nufhe_tpu_torch.ops import lwe as dlwe
    in_size, l, base, out = 1024, 8, 4, 500
    ks_a = rng.randint(-2**31, 2**31, (in_size, l, base, out)).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (in_size, l, base)).astype(np.int32)
    ks_a[:, :, 0] = 0
    ks_b[:, :, 0] = 0
    ks_cv = np.full((in_size, l, base), 3e-9, np.float32)
    arrays, meta = dlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2, dev)
    a = torch.from_numpy(
        rng.randint(-2**31, 2**31, (batch, in_size)).astype(np.int32)).to(dev)
    return a, arrays["table"], meta


def check_kernels(nft, dev, rng, results):
    from nufhe_tpu_torch.ops import cmux, keyswitch as ks
    tp = nft.NuFHEParameters().tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    for batch in (64, MAIN_BATCH):
        acc, p, key_row = cmux_inputs(rng, batch, dev, tp)
        got = cmux.cmux_step(acc, p, key_row, **kw)
        want = cmux.cmux_step_plain(acc, p, key_row, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        print("K1 cmux_step vs plain, batch %d: max_abs_err %d" % (batch, err))
        if err:
            raise AssertionError("K1 disagrees with its plain version")
        results["cmux_step"]["max_abs_err"] = max(
            results["cmux_step"].get("max_abs_err", 0), err)
    for batch in (256, MAIN_BATCH):
        a, table, meta = keyswitch_inputs(rng, batch, dev)
        kkw = dict(decomp_length=meta.decomp_length, log2_base=meta.log2_base)
        got = ks.keyswitch_totals(a, table, **kkw)
        want = ks.keyswitch_totals_plain(a, table, **kkw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        print("K2 keyswitch vs plain, batch %d: max_abs_err %d" % (batch, err))
        if err:
            raise AssertionError("K2 disagrees with its plain version")
        results["keyswitch"]["max_abs_err"] = max(
            results["keyswitch"].get("max_abs_err", 0), err)


def main_path(nft, dev, rng):
    """Full-parameter NAND through the entry points; returns the launch
    counts of the gate and the keys for the timing phase."""
    from nufhe_tpu_torch.ops import cmux, keyswitch as ks
    t0 = time.time()
    secret, cloud = nft.make_key_pair(nft.DeterministicRNG(SEED))
    print("keygen (host, n=500, N=1024): %.1f s" % (time.time() - t0))
    vm = nft.VirtualMachine(cloud, device=dev)
    t0 = time.time()
    cloud.bootstrap_key.device(dev)
    cloud.keyswitch_key.device(dev)
    torch.cuda.synchronize()
    print("key preparation (transform + upload): %.1f s" % (time.time() - t0))

    crng = nft.DeterministicRNG(SEED + 1)
    x = rng.randint(0, 2, MAIN_BATCH).astype(bool)
    y = rng.randint(0, 2, MAIN_BATCH).astype(bool)
    cx = nft.encrypt(crng, secret, x, device=dev)
    cy = nft.encrypt(crng, secret, y, device=dev)

    torch.cuda.synchronize()
    cmux.launches = 0
    ks.launches = 0
    t0 = time.time()
    out = vm.gate_nand(cx, cy)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = {"cmux_step": cmux.launches, "keyswitch": ks.launches}
    print("main path: NAND on %d pairs in %.3f s (first call), launches %s"
          % (MAIN_BATCH, elapsed, json.dumps(counts)))
    if counts != {"cmux_step": 500, "keyswitch": 1}:
        raise AssertionError("expected 500 K1 and 1 K2 launches per gate")

    got = nft.decrypt(secret, out)
    if not np.array_equal(got, ~(x & y)):
        raise AssertionError("NAND decrypts wrong on %d of %d bits"
                             % (int((got != ~(x & y)).sum()), MAIN_BATCH))
    phase = nft.decrypt_phase(secret, out).astype(np.int64)
    mu = 2**29   # 1/8 of the torus
    want_phase = np.where(~(x & y), mu, -mu)
    err = (phase - want_phase + 2**31) % 2**32 - 2**31
    frac = float(np.abs(err).max()) / 2**32 / (1 / 16)
    if not (np.isfinite(out.current_variances.cpu().numpy()).all()
            and tuple(out.a.shape) == (MAIN_BATCH, 500)):
        raise AssertionError("unexpected output shape or non-finite cv")
    print("NAND decrypts to the truth table on all %d bits; largest phase "
          "error %.6f of the 1/16 margin" % (MAIN_BATCH, frac))

    # the same gate for 8 pairs on the CPU, through the plain versions
    vm_cpu = nft.VirtualMachine(cloud, device="cpu")
    t0 = time.time()
    sub = [nft.LweSampleArray(c.params, c.a[:8].cpu(), c.b[:8].cpu(),
                              c.current_variances[:8].cpu())
           for c in (cx, cy)]
    ref = vm_cpu.gate_nand(*sub)
    same = (torch.equal(ref.a, out.a[:8].cpu())
            and torch.equal(ref.b, out.b[:8].cpu()))
    print("card output vs plain CPU gate on 8 pairs: %s (%.1f s)"
          % ("bit-equal" if same else "DIFFERENT", time.time() - t0))
    if not same:
        raise AssertionError("card NAND differs from the plain CPU NAND")
    return counts, secret, cloud, vm


def timing(nft, dev, rng, secret, cloud, vm, results):
    from nufhe_tpu_torch.ops import cmux, keyswitch as ks
    crng = nft.DeterministicRNG(SEED + 2)
    x = rng.randint(0, 2, TIMING_BATCH).astype(bool)
    y = rng.randint(0, 2, TIMING_BATCH).astype(bool)
    cx = nft.encrypt(crng, secret, x, device=dev)
    cy = nft.encrypt(crng, secret, y, device=dev)
    out = vm.gate_nand(cx, cy)                       # warm-up
    torch.cuda.synchronize()
    if not np.array_equal(nft.decrypt(secret, out), ~(x & y)):
        raise AssertionError("NAND at batch 2^14 decrypts wrong")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        vm.gate_nand(cx, cy)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    ms_bit = [t * 1e3 / TIMING_BATCH for t in times]
    print("NAND warm, batch %d: %s ms/bit (gate %s s)"
          % (TIMING_BATCH, ms_bit, times))

    # K1 at the timing batch: the gate's own key row and a random accumulator
    tp = cloud.params.tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    b = TIMING_BATCH
    acc = torch.from_numpy(
        rng.randint(-2**31, 2**31, (b, 2, 1024)).astype(np.int32)).to(dev)
    p = torch.from_numpy(rng.randint(0, 2048, (b,)).astype(np.int32)).to(dev)
    key_row = cloud.bootstrap_key.device(dev)[0]
    cmux.cmux_step(acc, p, key_row, **kw)
    k1_ms = cuda_ms(lambda: cmux.cmux_step(acc, p, key_row, **kw), 20)
    k1_plain = cuda_ms(lambda: cmux.cmux_step_plain(acc, p, key_row, **kw), 2)
    macs = b * 64 * 2 * 32 * 32 * 4
    transform_adds = b * (4 + 2) * 6 * 32 * 32 * 2
    k1_bound, k1_by = bound_ms(2 * acc.numel() * 4 + p.numel() * 4
                               + key_row.numel() * 8,
                               2 * macs + transform_adds)
    results["cmux_step"].update(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                                bound_by=k1_by, library_ms=None)
    print("K1 batch %d: %.4f ms/launch, plain %.2f ms, bound %.4f ms (%s)"
          % (b, k1_ms, k1_plain, k1_bound, k1_by))

    # K2 at the timing batch: the gate's keyswitch table, random input
    ks_arrays, meta = cloud.keyswitch_key.device(dev)
    table = ks_arrays["table"]
    a = torch.from_numpy(
        rng.randint(-2**31, 2**31, (b, meta.input_size)).astype(np.int32)).to(dev)
    kkw = dict(decomp_length=meta.decomp_length, log2_base=meta.log2_base)
    got = ks.keyswitch_totals(a, table, **kkw)
    k2_ms = cuda_ms(lambda: ks.keyswitch_totals(a, table, **kkw), 5)
    k2_plain = cuda_ms(lambda: ks.keyswitch_totals_plain(a, table, **kkw), 1)
    # library yardstick: float64 product of the one-hot digit matrix with
    # the table (exact: every sum stays below 2^53), one-hot built outside
    digits = ks.keyswitch_digits(a, meta.decomp_length, meta.log2_base)
    rows = table.shape[0]
    onehot = torch.zeros((b, rows * 3), dtype=torch.float64, device=dev)
    nz = digits != 0
    cols = (torch.arange(rows, device=dev) * 3)[None, :] + digits - 1
    onehot.scatter_add_(1, torch.where(nz, cols, 0), nz.to(torch.float64))
    table64 = table.reshape(rows * 3, -1).to(torch.float64)
    lib = torch.mm(onehot, table64)
    lib_ms = cuda_ms(lambda: torch.mm(onehot, table64), 3)
    lib_i32 = ((lib.to(torch.int64) + 2**31) % 2**32 - 2**31)
    if not torch.equal(lib_i32, got[:, :table.shape[2]].to(torch.int64)):
        raise AssertionError("library yardstick disagrees with K2")
    count = int(got[:, -1].to(torch.int64).sum().item())
    k2_bound, k2_by = bound_ms(a.numel() * 4 + table.numel() * 4
                               + got.numel() * 4, count * table.shape[2])
    results["keyswitch"].update(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                                bound_by=k2_by, library_ms=lib_ms)
    print("K2 batch %d: %.4f ms/launch, plain %.2f ms, torch.mm f64 one-hot "
          "%.4f ms, bound %.4f ms (%s)"
          % (b, k2_ms, k2_plain, lib_ms, k2_bound, k2_by))
    del onehot, table64, lib


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print("card (name, power limit): %s" % smi)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)

    t0 = time.time()
    build.build_all()
    print("kernels built in %.1f s" % (time.time() - t0))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))

    results = {
        "cmux_step": dict(
            name="cmux_step", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/cmux_step.cu",
            replaces="nufhe_tpu/ops/pallas/blind_rotate.py:39"),
        "keyswitch": dict(
            name="keyswitch", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/keyswitch.cu",
            replaces="nufhe_tpu/ops/pallas/keyswitch.py:27"),
    }
    check_kernels(nft, dev, rng, results)

    counts, secret, cloud, vm = main_path(nft, dev, rng)
    for name, n in counts.items():
        results[name]["launches"] = n
    timing(nft, dev, rng, secret, cloud, vm, results)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
