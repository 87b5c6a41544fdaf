"""The benchmark of nufhe_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload fft.nand_b16384 --seed 7 \\
        --seconds 30 --trace 0

Makes its keys and inputs from ``--seed`` on the card, prepares them with
the port, warms up the cell's own shapes (set-up, ``setup_s``), measures a
closed loop of the cell's requests for ``--seconds`` and holds a sample of
them against the plain reference in ``benchmark/reference/``.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.  A cell on four cards starts one process a
card (this one is rank 0) on a free localhost port.  ``--control 1`` runs
the configuration's control instead: the program's own path of lower
precision, whose ``correct`` has to come out false.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "nufhe_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: ``nufhe_tpu_torch`` is not ``nufhe_tpu``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _start_ranks(argv, world):
    """Ranks 1 .. world-1 of this run, one process a card."""
    coordinator = "tcp://127.0.0.1:%d" % _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + argv
        + ["--rank", str(r), "--coordinator", coordinator], env=env)
        for r in range(1, world)]
    return coordinator, procs


def _stop_ranks(procs, timeout):
    """Wait for every rank; end those still running after ``timeout``."""
    codes = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.lib import manifest, runner

    cell = manifest.Cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        log("benchmark: no CUDA card (torch.cuda.is_available() is false)")
        return 1
    if torch.cuda.device_count() < cell.chips:
        log("benchmark: %s needs %d cards, %d are visible"
            % (cell.name, cell.chips, torch.cuda.device_count()))
        return 1
    torch.set_num_threads(2)
    world, rank = cell.chips, args.rank
    procs = []
    if world > 1:
        from nufhe_tpu_torch.parallel import distributed as pdist
        coordinator = args.coordinator
        if rank == 0:
            coordinator, procs = _start_ranks(argv, world)
        pdist.initialize(coordinator, world, rank, local_device_ids=[rank])
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    try:
        result = runner.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), device, T_START,
                                 control=bool(args.control), rank=rank,
                                 world=world, log=log)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    codes = _stop_ranks(procs, timeout=120)
    if rank != 0:
        return 0
    if any(codes):
        log("benchmark: ranks 1..%d exited with %s" % (world - 1, codes))
        return 1
    found = forbidden_modules()
    if found:
        log("benchmark: the run loaded %s" % ", ".join(found))
        return 1
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        log("cards: %s" % "; ".join(card))
    except (OSError, subprocess.TimeoutExpired) as exc:
        log("cards: nvidia-smi not read (%s)" % exc)
    for name, c in result["checks"].items():
        log("check %s = %s, limit %s" % (name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
