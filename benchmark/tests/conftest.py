"""Tests of the benchmark: the manifest, its arithmetic, the reference
against the port's CPU path, and the check that decides ``correct``.

They run on the CPU at small sizes (``python -m pytest benchmark/tests
-q``); the tests marked ``card`` need a CUDA card, decide so inside their
fixture, and skip without one.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_cell(name, lwe_size=4, batch=64, rows=16, **traffic):
    """A cell of BENCHMARK.json at a size the CPU runs in seconds: a
    short CMUX ladder, a small batch, narrow integers."""
    from benchmark.lib import manifest
    cell = manifest.Cell(manifest.load(), name)
    cell.cfg["lwe_size"] = lwe_size
    tr = cell.traffic
    if tr["kind"] == "gate_chain":
        tr["batch"] = batch
        tr["check"]["rows"] = rows
    else:
        tr["integers"], tr["bits"] = 1, 4
    tr.update(traffic)
    return cell
