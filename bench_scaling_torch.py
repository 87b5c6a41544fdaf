"""Scaling benchmark: bootstrapped-NAND gates/sec against the number of
CUDA cards, the port of ``bench_scaling.py``.

Data parallelism over a (data, 1) mesh (``nufhe_tpu_torch.parallel``): the
batch of LWE samples is split over the cards at a fixed batch PER CARD (so
perfect scaling is linear gates/sec), the keys are on every card, and each
card runs the NAND's bootstrap on its shard (``sharded_bootstrap_fn``, the
lanes engine on ``mac_rhs``: 500 K4 launches and 1 K2 a call).  Prints one
JSON line per card count on stderr and a summary on stdout whose
``vs_baseline`` is the scaling efficiency against one card.

    python3 bench_scaling_torch.py                  # 1, 2, 4, ... cards
    NUFHE_SCALE_BATCH=4096 python3 bench_scaling_torch.py --devices 1
    python3 bench_scaling_torch.py --cpu            # gloo on the CPU (tests)

Knobs (``bench_scaling.py``'s): ``NUFHE_SCALE_BATCH`` (4096 a card),
``_LWE_SIZE`` (500), ``_RUNS`` (3), ``_INNER`` (2).  ``--devices N`` caps the
counts at N (default: every card; with ``--cpu``, 2 processes).

Where JAX sweeps the counts in one process, a process here drives one card:
for each count d this script starts d processes of itself on NCCL (gloo
with ``--cpu``), one card a rank, on a free localhost port, and the group is
torn down before the next count.  Every rank makes the same keys from one
seed (checked by a digest of the containers), takes its slice of the
inputs, and times chains of ``INNER`` dependent calls from a barrier to a
barrier on rank 0's host clock, best of ``RUNS``, after a warm-up chain.
Rank 0 checks the gathered output of the first call against one process's
``bootstrap_device`` on the whole batch, bit for bit.  Without ``--cpu``
and without a card the script exits non-zero.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

COUNTS = (1, 2, 4, 8, 16, 32)
CPU_PROCESSES = 2


def _knobs():
    return (int(os.environ.get("NUFHE_SCALE_BATCH", 4096)),
            int(os.environ.get("NUFHE_SCALE_LWE_SIZE", 500)),
            int(os.environ.get("NUFHE_SCALE_RUNS", 3)),
            int(os.environ.get("NUFHE_SCALE_INNER", 2)))


def inputs(batch, lwe_size):
    """``bench_scaling.py``'s random LWE samples from ``RandomState(0)``."""
    rs = np.random.RandomState(0)
    lwe_a = rs.randint(-2**31, 2**31, (batch, lwe_size)).astype(np.int32)
    lwe_b = rs.randint(-2**31, 2**31, (batch,)).astype(np.int32)
    return lwe_a, lwe_b


def nand_linear(a, b):
    """The NAND's linear part of samples (a, b): (-a, 1/8 - b), int32."""
    from nufhe_tpu_torch.numeric import phase_to_t32, wrap_i32
    return (wrap_i32(-a.to(torch.int64)),
            wrap_i32(int(phase_to_t32(1, 8)) - b.to(torch.int64)))


def output_digest(a, b):
    """sha256 of a bootstrap's output (a, b) as int32 bytes."""
    h = hashlib.sha256(a.cpu().numpy().astype(np.int32).tobytes())
    h.update(b.cpu().numpy().astype(np.int32).tobytes())
    return h.hexdigest()


def make_keys(lwe_size, dev):
    """The benchmark's key pair on ``dev`` (``DeterministicRNG(42)``)."""
    import nufhe_tpu_torch as nft
    return nft.make_key_pair(nft.DeterministicRNG(42), lwe_size=lwe_size,
                             device=dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worker(nprocs, rank, cpu):
    """One rank of a count of ``nprocs``: returns rank 0's JSON line."""
    import torch.distributed as dist
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.numeric import phase_to_t32
    from nufhe_tpu_torch.ops import bootstrap as dboot, keyswitch, lanes_step
    from nufhe_tpu_torch.parallel import distributed as pdist, mesh as pmesh

    per_card, lwe_size, runs, inner = _knobs()
    device = "cpu" if cpu else None
    mesh = pmesh.make_mesh(n_data=nprocs, n_model=1, device=device)
    dev = pmesh.mesh_device(mesh)

    _, cloud = make_keys(lwe_size, dev)
    digests = [None] * nprocs
    dist.all_gather_object(digests,
                           hashlib.sha256(cloud.dumps()).hexdigest())
    if len(set(digests)) != 1:
        raise AssertionError("the ranks' keys differ: %s" % digests)
    mu = int(phase_to_t32(1, 8))
    tgsw_params = cloud.params.tgsw_params
    bk = cloud.bootstrap_key.mac_rhs(dev)
    ks_arrays, ks_meta = cloud.keyswitch_key.device(dev)

    batch = per_card * nprocs
    lwe_a, lwe_b = inputs(batch, lwe_size)
    mine = slice(rank * per_card, (rank + 1) * per_card)
    ga, gb = pdist.global_batch(mesh, (lwe_a[mine], lwe_b[mine]))
    fn = pmesh.sharded_bootstrap_fn(mesh, ks_meta, mu, tgsw_params)

    def gate(a, b):
        return fn(*nand_linear(a, b), bk, ks_arrays)

    out_a, out_b, out_cv = gate(ga, gb)
    got = pmesh.gather_ciphertext(nft.LweSampleArray(
        cloud.params.in_out_params, out_a, out_b, out_cv), mesh)
    digest = None
    if rank == 0:
        ref_a, ref_b, _ = dboot.bootstrap_device(
            *nand_linear(torch.from_numpy(lwe_a).to(dev),
                         torch.from_numpy(lwe_b).to(dev)),
            bk, ks_arrays, ks_meta, mu, tgsw_params)
        if not (torch.equal(got.a, ref_a) and torch.equal(got.b, ref_b)):
            raise AssertionError("the gathered %d-way output differs from one "
                                 "process's bootstrap_device" % nprocs)
        digest = output_digest(got.a, got.b)

    def chain():
        b_cur = gb
        for _ in range(inner):
            _, b_cur, _ = gate(ga, b_cur)
        _sync(dev)

    chain()                                   # warm-up
    keyswitch.launches = lanes_step.launches = 0
    best = float("inf")
    for _ in range(runs):
        dist.barrier()
        _sync(dev)
        t0 = time.time()
        chain()
        dist.barrier()
        best = min(best, (time.time() - t0) / inner)
    calls = runs * inner
    launches = {"lanes_step": lanes_step.launches / calls,
                "keyswitch": keyswitch.launches / calls}
    if rank != 0:
        return None
    card = "cpu"
    if dev.type == "cuda":
        from bench_torch import nvidia_smi_line
        card = nvidia_smi_line()
    return {"chips": nprocs, "batch": batch, "per_chip_batch": per_card,
            "lwe_size": lwe_size, "s_per_gatecall": round(best, 6),
            "gates_per_sec": round(batch / best, 1),
            "launches_per_call": launches, "bit_exact": True,
            "out_sha256": digest, "card": card}


def _worker_main(coord, nprocs, rank, cpu):
    import torch.distributed as dist
    from nufhe_tpu_torch.parallel import distributed as pdist
    if cpu:
        torch.set_num_threads(1)
    pdist.initialize(coord, nprocs, rank,
                     local_device_ids=None if cpu else [rank],
                     device="cpu" if cpu else None)
    try:
        line = worker(nprocs, rank, cpu)
    finally:
        dist.destroy_process_group()
    if line is not None:
        print(json.dumps(line), flush=True)


def run_count(d, cpu, timeout=900.0):
    """``d`` processes of this script for one count; rank 0's line."""
    from nufhe_tpu_torch.parallel.distributed import run_processes
    extra = ["--cpu"] if cpu else []
    outs = run_processes(
        lambda coord, i: [sys.executable, os.path.abspath(__file__),
                          "--worker", coord, str(d), str(i)] + extra,
        d, timeout=timeout, name="bench_scaling_torch rank")
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError("rank 0 printed no result:\n%s" % outs[0][-3000:])
    return json.loads(lines[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU instead of NCCL on cards")
    ap.add_argument("--devices", type=int, default=None,
                    help="the largest count (default: every card; %d with "
                         "--cpu)" % CPU_PROCESSES)
    ap.add_argument("--worker", nargs=3, metavar=("COORD", "NPROCS", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        coord, nprocs, rank = args.worker
        _worker_main(coord, int(nprocs), int(rank), args.cpu)
        return 0
    if not args.cpu and not torch.cuda.is_available():
        print("bench_scaling_torch: no CUDA card (torch.cuda.is_available() "
              "is false); pass --cpu to run gloo on the CPU", file=sys.stderr)
        return 1
    if args.cpu:     # processes, not cards: any count runs
        largest = args.devices or CPU_PROCESSES
    else:
        largest = min(torch.cuda.device_count(),
                      args.devices or torch.cuda.device_count())
    counts = [d for d in COUNTS if d <= largest]
    per_card = _knobs()[0]
    results = []
    for d in counts:
        line = run_count(d, args.cpu)
        results.append((d, line["gates_per_sec"]))
        print(json.dumps(line), file=sys.stderr, flush=True)

    base = results[0][1]
    last_d, last_gps = results[-1]
    eff = last_gps / (base * last_d)
    print(json.dumps({
        "metric": "NAND gates/sec scaling ({} chip(s), per-chip batch {})"
                  .format(last_d, per_card),
        "value": round(last_gps, 1),
        "unit": "gates/sec",
        "vs_baseline": round(eff, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
