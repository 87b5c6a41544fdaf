"""``bench_scaling_torch.py`` (the port of ``bench_scaling.py``) with
``--cpu``: one and then two gloo processes at ``lwe_size=8`` and 4 samples
a process.  Its lines parse, and the output each count gathered on rank 0
(its sha256 in the line) equals one process's ``bootstrap_device`` on the
same inputs and keys, bit for bit.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_scaling_torch as scaling  # noqa: E402

LWE_SIZE = 8
PER_CARD = 4


@pytest.fixture(scope="module")
def lines():
    env = dict(os.environ, NUFHE_SCALE_LWE_SIZE=str(LWE_SIZE),
               NUFHE_SCALE_BATCH=str(PER_CARD), NUFHE_SCALE_RUNS="1",
               NUFHE_SCALE_INNER="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_scaling_torch.py"),
         "--cpu", "--devices", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    per_count = [json.loads(ln) for ln in proc.stderr.splitlines()
                 if ln.startswith("{")]
    (summary,) = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
    return per_count, summary


def test_lines_parse(lines):
    per_count, summary = lines
    assert [ln["chips"] for ln in per_count] == [1, 2]
    for ln in per_count:
        assert ln["batch"] == PER_CARD * ln["chips"]
        assert ln["per_chip_batch"] == PER_CARD
        assert ln["lwe_size"] == LWE_SIZE and ln["card"] == "cpu"
        assert ln["bit_exact"] is True
        assert ln["s_per_gatecall"] > 0
        # both rounded in the line: s to 1e-6, gates/s to 0.1
        assert ln["gates_per_sec"] == pytest.approx(
            ln["batch"] / ln["s_per_gatecall"], rel=1e-3, abs=0.05)
        # the plain versions on the CPU launch no kernel
        assert ln["launches_per_call"] == {"lanes_step": 0, "keyswitch": 0}
    assert set(summary) == {"metric", "value", "unit", "vs_baseline"}
    assert summary["metric"] == \
        "NAND gates/sec scaling (2 chip(s), per-chip batch %d)" % PER_CARD
    assert summary["value"] == per_count[-1]["gates_per_sec"]
    assert summary["vs_baseline"] == pytest.approx(
        per_count[1]["gates_per_sec"]
        / (2 * per_count[0]["gates_per_sec"]), abs=1e-3)


def test_gathered_output_equals_one_process(lines):
    from nufhe_tpu_torch.numeric import phase_to_t32
    from nufhe_tpu_torch.ops import bootstrap as dboot
    per_count, _ = lines
    _, cloud = scaling.make_keys(LWE_SIZE, "cpu")
    bk = cloud.bootstrap_key.mac_rhs("cpu")
    ks_arrays, ks_meta = cloud.keyswitch_key.device("cpu")
    for ln in per_count:
        lwe_a, lwe_b = scaling.inputs(ln["batch"], LWE_SIZE)
        a, b, _ = dboot.bootstrap_device(
            *scaling.nand_linear(torch.from_numpy(lwe_a),
                                 torch.from_numpy(lwe_b)),
            bk, ks_arrays, ks_meta, int(phase_to_t32(1, 8)),
            cloud.params.tgsw_params)
        assert scaling.output_digest(a, b) == ln["out_sha256"]
