"""The check that decides ``correct``: sound small runs pass it, the
configuration's control (the program's own path of lower precision) and
each fault a cell can have fail it.  On the CPU at small sizes; the
controls at the cells' own sizes are runs of ``benchmark/run.py
--control 1`` on the card."""

import json
import socket
import subprocess
import sys
import time

import pytest

from benchmark.lib import runner
from benchmark.tests import faults
from benchmark.tests.conftest import ROOT, small_cell

ONE_CARD = ["fft.nand_b16384", "ntt.nand_b16384", "ntt.add16_x4"]
SEED = 2**31 + 17


def _run(cell, control=False, seed=SEED):
    return runner.run_cell(small_cell(cell), seed, 0.3, False, "cpu",
                           time.perf_counter(), control=control,
                           log=lambda *a: None)


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_runs_are_correct(cell):
    result = _run(cell)
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ONE_CARD)
def test_the_control_is_not_correct(cell):
    result = _run(cell, control=True)
    assert not result["correct"]
    assert result["checks"]["mismatch_words"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    from nufhe_tpu_torch import api
    from nufhe_tpu_torch.ops import bootstrap
    from nufhe_tpu_torch.parallel import mesh
    for module, attr in ((bootstrap, "blind_rotate"),
                         (bootstrap, "bootstrap_device"),
                         (api.VirtualMachine, "_gate"),
                         (api.VirtualMachine, "_uint"),
                         (mesh, "gather_ciphertext")):
        monkeypatch.setattr(module, attr, getattr(module, attr))
    faults.plant(fault)
    assert not _run(cell)["correct"]


def _data_parallel(control=False, fault="none", world=2):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coordinator = "tcp://127.0.0.1:%d" % sock.getsockname()[1]
    sock.close()
    script = str(ROOT / "benchmark" / "tests" / "dp_rank.py")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), coordinator, str(SEED),
         "1" if control else "0", fault], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("case", [
    ("sound", False, "none"), ("control", True, "none"),
    ("unchanged_state", False, "unchanged_state"),
    ("half_batch", False, "half_batch"),
    ("no_exchange", False, "no_exchange"),
    ("altered_answer", False, "altered_answer")], ids=lambda c: c[0])
def test_data_parallel_cell(case):
    name, control, fault = case
    result = _data_parallel(control, fault)
    assert result["correct"] == (name == "sound"), result["checks"]
