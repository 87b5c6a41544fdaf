"""Kernel K12's plain version (the rotation forms,
``nufhe_tpu_torch/ops/rotate_forms.py``) against the JAX package, and
``tools/exp_round5_torch.py`` run in-process on the CPU.

``tools/exp_round5.py::main`` cannot be imported (it times TPU launches
as it runs).  Its four ``rotate_acc`` variants are asserted there equal to
the baseline's, so each form here is held against the baseline rebuilt
from the same ``nufhe_tpu`` calls, jnp on the CPU, no Pallas:
``rows_engine.rotate_acc`` for the plain barrel (with ``skip_low_bits=1``
on even amounts, and the deferred-carry form of T4's t5), and
``rows_engine.external_step`` chained for the forms' steps, in both key
forms, bit for bit; on the CPU the launch count does not move."""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw

from nufhe_tpu_torch.ops import flat_engine as fe
from nufhe_tpu_torch.ops import rotate_forms as rf
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 8
STEPS = 3
MODES = ("NTT", "FFT")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2043)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    bara = rng.randint(0, 2048, (STEPS, B)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (STEPS, 2, 2, 2, 1024)).astype(np.int32)
    out = dict(accum=accum, bara=bara)
    for mode in MODES:
        rhs = np.asarray(dtgsw.prepare_bootstrap_key_device(
            bk, exact=mode == "NTT"))
        a = re_.acc_rows_from_n(jnp.asarray(accum))
        for step in range(STEPS):
            a = re_.external_step(a, jnp.asarray(bara[step])[None, :],
                                  jnp.asarray(rhs[step]), mask1=2,
                                  decomp_length=2, log2_base=L2B,
                                  offset=OFFSET, mac_dtype=jnp.float32)
        out[mode] = (ttf.bootstrap_key_transformed(bk, "cpu", mode),
                     np.asarray(re_.acc_n_from_rows(a, 2)))
    return out


@pytest.mark.parametrize("kind", ["barrel", "deferred", "even"])
def test_barrel_matches_rotate_acc(inputs, kind):
    acc = inputs["accum"]
    p = np.random.RandomState(7).randint(0, 2048, (B,)).astype(np.int32)
    skip = 1 if kind == "even" else 0
    if skip:
        p &= ~1
    want = re_.acc_n_from_rows(re_.rotate_acc(
        re_.acc_rows_from_n(jnp.asarray(acc)), jnp.asarray(p)[None, :], 2,
        minus_one=True, skip_low_bits=skip), 2)
    acc_q = fe.q_from_n(torch.from_numpy(acc)).reshape(B, 2048)
    got = rf.barrel_rotate_q(acc_q, torch.from_numpy(p), skip_low_bits=skip,
                             deferred=kind == "deferred")
    assert np.array_equal(fe.n_from_q(got.reshape(B, 2, 1024)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", rf.FORMS)
def test_forms_match_chained_external_step(inputs, mode, form):
    key, want = inputs[mode]
    before = rf.launches
    got = rf.rotate_form(form, torch.from_numpy(inputs["accum"]),
                         torch.from_numpy(inputs["bara"]), key, 0, STEPS,
                         **KW)
    assert rf.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 2, 1024)
    assert np.array_equal(got.numpy(), want)


def test_rotate_form_rejects_bad_input(inputs):
    key = inputs["NTT"][0]
    acc = torch.from_numpy(inputs["accum"])
    bara = torch.from_numpy(inputs["bara"])
    with pytest.raises(ValueError):
        rf.rotate_form("t15", acc, bara, key, 0, 1, **KW)
    with pytest.raises(ValueError):
        rf.rotate_form("t11", acc, bara, key, 2, 2, **KW)
    with pytest.raises(ValueError):
        rf.rotate_form("t11", acc, bara[:, :4].contiguous(), key, 0, 1, **KW)


def test_exp_round5_on_cpu(capsys, monkeypatch):
    """The tool in-process on the CPU at batch 4 and 2 steps, both engines,
    with ``NUFHE_R5_TRICKS`` picking two forms; every form run equals the
    baseline (K3's plain version)."""
    sys.path.append(os.path.join(ROOT, "tools"))
    import exp_round5_torch as e5
    monkeypatch.setenv("NUFHE_R5_TRICKS", "t12,t14")
    for transform in ("ntt", "fft"):
        monkeypatch.setenv("NUFHE_BENCH_TRANSFORM", transform)
        res = e5.main(4, "cpu", n_steps=2, reps=1)
        assert set(res) == {"baseline", "t12", "t14"}
        assert all(r["exact"] for k, r in res.items() if k != "baseline")
    assert "t14 = t12+t13" in capsys.readouterr().out
