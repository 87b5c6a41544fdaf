"""Multi-process dryrun worker, launched by
``parallel.distributed.run_multiprocess_dryrun`` (and usable alone) as

    python -m nufhe_tpu_torch.parallel._mp_worker <coordinator> <nprocs> \
        <pid> [--device cuda|cpu] [--lwe-size 8] [--batch B] [--out F.npz]

Each process drives one device: NCCL on its card (the default; raises
without CUDA), or gloo on the CPU with ``--device cpu``.  Together
they form a (data, model) mesh, model 2 for an even ``nprocs``.  Every
process builds the JAX package's synthetic scheme state from
``RandomState(1234)`` (``nufhe_tpu/parallel/_mp_worker.py:23-44``), feeds
its 'data' slice of the batch, shards the lanes key over 'model', runs the
limbs- and the slots-sharded NAND bootstrap (a collective every CMUX step)
and asserts its output shard BIT-EXACTLY equal to the unsharded bootstrap.
Then the data-parallel gate: keys and ciphertexts from one seed on every
rank, ``shard_ciphertext``, ``VirtualMachine.gate_nand`` on the shard,
``gather_ciphertext``: equal to the one-device NAND bit for bit, and
decrypting to the truth table.  This checks the backend's int32 sum (it
must wrap mod 2^32, as the lo channel's sum does), process-group start-up,
the mesh, per-process batch feeding, the per-step collectives and output
gathering.  ``--out``: rank 0 writes the gathered outputs (npz).
(``examples/multi_device_torch.py`` times the same paths.)
"""

import argparse
import sys

NAND_SEED = 11


def _setup(lwe_size, batch, device):
    """The JAX package's ``_setup``: the same draws from the same seed, the
    lanes key and the keyswitch operand built on ``device``."""
    import numpy as np
    from ..params import NuFHEParameters
    from ..ops import lwe as dlwe
    from ..ops import tgsw

    params = NuFHEParameters(lwe_size=lwe_size)
    rng = np.random.RandomState(1234)
    limbs = rng.randint(
        -128, 128, (lwe_size, 4, 2, 64, 32, 5, 2)).astype(np.int8)
    bk_dev = tgsw.expand_bootstrap_key_device(limbs, device)
    ks_a = rng.randint(
        -2**31, 2**31, (1024, 8, 4, lwe_size)).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (1024, 8, 4)).astype(np.int32)
    # constant alpha^2 on nonzero digits like real keys (the count-based cv
    # accounting asserts this shape)
    ks_cv = np.full((1024, 8, 4), 3e-9, np.float32)
    ks_cv[:, :, 0] = 0
    ks_arrays, ks_meta = dlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2,
                                                       device)
    lwe_a = rng.randint(-2**31, 2**31, (batch, lwe_size)).astype(np.int32)
    lwe_b = rng.randint(-2**31, 2**31, (batch,)).astype(np.int32)
    return params, bk_dev, ks_arrays, ks_meta, lwe_a, lwe_b


def run(args, nprocs, pid):
    import numpy as np
    import torch
    import torch.distributed as dist
    import nufhe_tpu_torch as nft
    from ..numeric import phase_to_t32
    from ..ops import bootstrap as dboot
    from . import distributed as pdist
    from . import mesh as pmesh

    n_model = 2 if nprocs % 2 == 0 else 1
    mesh = pdist.make_global_mesh(n_model=n_model, device=args.device)
    n_data = mesh.size(0)
    dev = pmesh.mesh_device(mesh)

    # the lo channel's sum wraps mod 2^32: so must the backend's int32 sum
    x = torch.tensor([2**31 - 1 if pid == 0 else 1], dtype=torch.int32,
                     device=dev)
    dist.all_reduce(x)
    wrapped = (2**31 - 1 + nprocs - 1 + 2**31) % 2**32 - 2**31
    if int(x.item()) != wrapped:
        raise AssertionError("the backend's int32 sum gave %d, not %d"
                             % (int(x.item()), wrapped))

    batch = args.batch or n_data * 2
    params, bk_dev, ks_arrays, ks_meta, lwe_a, lwe_b = _setup(
        args.lwe_size, batch, dev)
    mu = int(phase_to_t32(1, 8))
    tp = params.tgsw_params

    # every process feeds only its 'data' slice of the global batch
    per = batch // n_data
    sl = slice(mesh.get_local_rank('data') * per,
               (mesh.get_local_rank('data') + 1) * per)
    ga, gb = pdist.global_batch(mesh, (lwe_a[sl], lwe_b[sl]))
    ks_repl = pmesh.replicate(ks_arrays, mesh)

    # the unsharded computation on this device
    ref_a, ref_b, _ = dboot.bootstrap_device(
        torch.from_numpy(lwe_a).to(dev), torch.from_numpy(lwe_b).to(dev),
        bk_dev, ks_arrays, ks_meta, mu, tp)
    saved = {}
    for mode in pmesh.MODES:
        bk_sharded = pmesh.shard_bootstrap_key(bk_dev, mesh, mode)
        fn = pmesh.sharded_bootstrap_fn(mesh, ks_meta, mu, tp, mode=mode)
        out_a, out_b, _ = fn(ga, gb, bk_sharded, ks_repl)
        if not (torch.equal(out_a, ref_a[sl])
                and torch.equal(out_b, ref_b[sl])):
            raise AssertionError("%s: shard %s differs from the unsharded "
                                 "bootstrap" % (mode, sl))
        group = mesh.get_group('data')
        saved[mode + "_a"] = pmesh._gather_batch(out_a, group).cpu().numpy()
        saved[mode + "_b"] = pmesh._gather_batch(out_b, group).cpu().numpy()

    # the data-parallel gate through the entry points
    rng = nft.DeterministicRNG(NAND_SEED)
    secret, cloud = nft.make_key_pair(rng, lwe_size=args.lwe_size, device=dev)
    bits_a = np.random.RandomState(0).randint(0, 2, batch).astype(bool)
    bits_b = np.random.RandomState(1).randint(0, 2, batch).astype(bool)
    ca = nft.encrypt(rng, secret, bits_a, device=dev)
    cb = nft.encrypt(rng, secret, bits_b, device=dev)
    vm = nft.VirtualMachine(cloud, device=dev)
    whole = vm.gate_nand(ca, cb)
    pmesh.shard_ciphertext(ca, mesh)
    pmesh.shard_ciphertext(cb, mesh)
    res = vm.gate_nand(ca, cb)
    got = pmesh.gather_ciphertext(res, mesh)
    if not (torch.equal(got.a, whole.a) and torch.equal(got.b, whole.b)):
        raise AssertionError("the gathered data-parallel NAND differs from "
                             "the one-device NAND")
    if not np.array_equal(nft.decrypt(secret, got), ~(bits_a & bits_b)):
        raise AssertionError("the data-parallel NAND decrypts wrong")
    saved.update(nand_a=got.a.cpu().numpy(), nand_b=got.b.cpu().numpy())
    if pid == 0 and args.out:
        np.savez(args.out, **saved)
    return n_data, n_model, batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lwe-size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    if args.device == "cpu":
        torch.set_num_threads(1)
    from . import distributed as pdist

    pdist.initialize(args.coordinator, args.nprocs, args.pid,
                     device=args.device)
    try:
        n_data, n_model, batch = run(args, args.nprocs, args.pid)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print("mp_worker %d/%d OK: mesh={'data': %d, 'model': %d} batch=%d "
          "bit-exact" % (args.pid, args.nprocs, n_data, n_model, batch))


if __name__ == "__main__":
    main()
