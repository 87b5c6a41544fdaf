"""Multi-device gate evaluation with nufhe_tpu_torch on torch.distributed:
one process per card, the ciphertext batch split over the mesh's 'data'
dim (the port's counterpart of ``examples/multi_device.py``).

On K cards of one machine (NCCL):
    torchrun --nproc-per-node=K examples/multi_device_torch.py
On the CPU, K processes under gloo:
    torchrun --nproc-per-node=2 examples/multi_device_torch.py --cpu

Rank 0 makes the key pair and encrypts two random bit arrays; every rank
loads the cloud key and the ciphertexts from rank 0's containers (as
servers take them in), keeps its 'data' shard, runs the NAND on it
(``VirtualMachine.gate_nand``, the default path) and gathers the result,
which rank 0 decrypts and checks.  With ``--n-model M`` each group of M
consecutive ranks also runs the tensor-parallel bootstrap of the same NAND
on its shard (the lanes key split over the group, ``mode='limbs'`` and
``'slots'``) and checks it bit-equal to the data-parallel one.  ``--time``
prints rank 0's ms/bit of each at the global batch (host clock from a
barrier to a barrier, after a warm-up) and the time of one gate's
collectives alone, as one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

import nufhe_tpu_torch as nft
from nufhe_tpu_torch.numeric import phase_to_t32, wrap_i32
from nufhe_tpu_torch.ops import flat_engine as fe
from nufhe_tpu_torch.parallel import distributed as pdist, mesh as pmesh


def synced_s(fn, dev):
    """Seconds of ``fn()`` on every rank, from a barrier to a barrier."""
    dist.barrier()
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    dist.barrier()
    return out, time.time() - t0


def collectives_s(mode, shape, group, steps, dev):
    """Seconds of one gate's ``steps`` collectives alone, on channels of
    ``shape`` (this rank's)."""
    chan = torch.zeros(shape, dtype=torch.int32, device=dev)
    collective = fe.sum_channels if mode == 'limbs' else fe.gather_slots
    collective(chan, group)

    def run():
        for _ in range(steps):
            collective(chan, group)
    return synced_s(run, dev)[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU instead of NCCL on the cards")
    ap.add_argument("--lwe-size", type=int, default=None,
                    help="default 500 on cards, 32 with --cpu")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: 8 a rank)")
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--fft", action="store_true",
                    help="the rounded-key ('FFT') engine instead of 'NTT'")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    device = 'cpu' if args.cpu else None
    if args.cpu:
        torch.set_num_threads(1)
    lwe_size = args.lwe_size or (32 if args.cpu else 500)

    pdist.initialize(device=device)
    try:
        run(args, device, lwe_size)
    finally:
        dist.destroy_process_group()


def run(args, device, lwe_size):
    mesh = pdist.make_global_mesh(n_model=args.n_model, device=device)
    dev = pmesh.mesh_device(mesh)
    rank, world = dist.get_rank(), dist.get_world_size()
    batch = args.batch or 8 * world
    card = ""
    if dev.type == 'cuda':
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index)],
            check=True, capture_output=True, text=True,
            timeout=60).stdout.strip()

    # rank 0's key pair and ciphertexts, shipped as containers
    blobs = [None, None, None]
    if rank == 0:
        rng = nft.DeterministicRNG(0)
        secret, cloud = nft.make_key_pair(
            rng, lwe_size=lwe_size, device=dev,
            transform_type='FFT' if args.fft else 'NTT')
        bits = np.random.RandomState(1).randint(0, 2, (2, batch)).astype(bool)
        c1, c2 = (nft.encrypt(rng, secret, b, device=dev) for b in bits)
        blobs = [cloud.dumps(), c1.dumps(), c2.dumps()]
    dist.broadcast_object_list(blobs, src=0,
                               device=dev if dev.type == 'cuda' else None)
    cloud = nft.NuFHECloudKey.loads(blobs[0])
    c1, c2 = (nft.LweSampleArray.loads(b, dev) for b in blobs[1:])

    pmesh.shard_ciphertext(c1, mesh)
    pmesh.shard_ciphertext(c2, mesh)
    vm = nft.VirtualMachine(cloud, device=dev)
    res = vm.gate_nand(c1, c2)
    result = pmesh.gather_ciphertext(res, mesh)
    if rank == 0:
        if not np.array_equal(nft.decrypt(secret, result),
                              ~(bits[0] & bits[1])):
            raise AssertionError("the multi-device NAND decrypts wrong")
        print("multi-device NAND over %d bits on %d %s devices, mesh "
              "(data %d, model %d): OK" % (batch, world, dev.type,
                                           mesh.size(0), mesh.size(1)))
    report = dict(devices=world, kind=card or "cpu", lwe_size=lwe_size,
                  batch=batch, mesh=[mesh.size(0), mesh.size(1)],
                  engine='FFT' if args.fft else 'NTT')
    if args.time:
        vm.gate_nand(c1, c2)
        _, secs = synced_s(lambda: vm.gate_nand(c1, c2), dev)
        report["dp_nand_ms_bit"] = secs * 1e3 / batch

    if args.n_model > 1:
        # the same NAND's bootstrap, tensor-parallel over the model group
        lin_a = wrap_i32(-(c1.a.to(torch.int64) + c2.a.to(torch.int64)))
        lin_b = wrap_i32(int(phase_to_t32(1, 8)) - c1.b.to(torch.int64)
                         - c2.b.to(torch.int64))
        ks_arrays, ks_meta = cloud.keyswitch_key.device(dev)
        n_ch = 1 if args.fft else 2
        for mode in pmesh.MODES:
            bk = pmesh.shard_bootstrap_key(cloud.bootstrap_key.mac_rhs(dev),
                                           mesh, mode)
            fn = pmesh.sharded_bootstrap_fn(mesh, ks_meta,
                                            int(phase_to_t32(1, 8)),
                                            cloud.params.tgsw_params,
                                            mode=mode)
            a, b, _ = fn(lin_a, lin_b, bk, ks_arrays)
            if not (torch.equal(a, res.a) and torch.equal(b, res.b)):
                raise AssertionError("the %s-parallel NAND differs from the "
                                     "data-parallel one" % mode)
            if args.time:
                _, secs = synced_s(lambda: fn(lin_a, lin_b, bk, ks_arrays),
                                   dev)
                slots = 64 // (args.n_model if mode == 'slots' else 1)
                coll = collectives_s(
                    mode, (lin_b.shape[0], n_ch, 2, slots, 32),
                    mesh.get_group('model'), lwe_size, dev)
                report["tp_%s" % mode] = dict(
                    ms_bit=secs * 1e3 / batch, gate_s=secs,
                    collectives_s=coll, collective_share=coll / secs)
        if rank == 0:
            print("tensor-parallel NAND bootstraps (limbs, slots) equal the "
                  "data-parallel NAND on every rank")
    if rank == 0 and args.time:
        print(json.dumps({"multi_device_torch": report}))


if __name__ == "__main__":
    main()
