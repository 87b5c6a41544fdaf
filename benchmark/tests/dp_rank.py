"""One rank of a small data-parallel run on the CPU (gloo), for the
tests: ``python dp_rank.py RANK WORLD COORDINATOR SEED CONTROL FAULT``.
Rank 0 prints the result's JSON as its last line."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmark.lib import runner  # noqa: E402
from benchmark.tests import faults  # noqa: E402
from benchmark.tests.conftest import small_cell  # noqa: E402
from nufhe_tpu_torch.parallel import distributed  # noqa: E402


def main(rank, world, coordinator, seed, control, fault):
    t_start = time.perf_counter()
    torch.set_num_threads(1)
    if fault != "none":
        faults.plant(fault)
    distributed.initialize(coordinator, world, rank, device="cpu")
    cell = small_cell("fft_dp4.nand_b65536", batch=8 * world, rows=6,
                      gates_per_request=2)
    cell.cfg["cards"] = world
    result = runner.run_cell(cell, seed, 0.5, False, "cpu", t_start,
                             control=control, rank=rank, world=world,
                             log=lambda *a: None)
    if rank == 0:
        print(json.dumps(result))


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), a[2], int(a[3]), a[4] == "1", a[5])
