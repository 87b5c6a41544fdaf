"""Kernel K10's plain version (the step schedules,
``nufhe_tpu_torch/ops/step_schedules.py``) against the JAX package, and
``tools/exp_round3_torch.py`` run in-process on the CPU.

``tools/exp_round3.py::run`` cannot be imported (it times TPU launches as
it runs), so its seven bodies are rebuilt here from the same
``nufhe_tpu`` calls (``tools/exp_round3.py:64-134``), jnp on the CPU, no
Pallas: v0 (materialised digits, radix-4 transforms), v1 (``external_step``
radix-4), v2 (the packed radix-8 path with its combine and normalisation
unfused), v3 (``external_step``), and the pipelines p2, p4 (``make_pipe``)
and p2b (both dots early) over the batch's lane halves or quarters.  Each
schedule's plain version equals its body bit for bit at batch 8, in both
key forms; on the CPU the launch count does not move."""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw

from nufhe_tpu_torch.ops import step_schedules as ss
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 8
MODES = ("NTT", "FFT")
MAC = jnp.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2041)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    p = rng.randint(0, 2048, (B,)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (1, 2, 2, 2, 1024)).astype(np.int32)
    out = dict(accum=accum, p=p)
    for mode in MODES:
        out[mode] = (ttf.bootstrap_key_transformed(bk, "cpu", mode)[0],
                     np.asarray(dtgsw.prepare_bootstrap_key_device(
                         bk, exact=mode == "NTT"))[0])
    return out


def _front(a, p):
    rot = re_.rotate_acc(a, p, 2, minus_one=True)
    packed = re_.decomp_pack2(rot, 2, L2B, OFFSET)
    xt_pk = re_.dif_forward_packed2(packed, 2)
    return re_.packed_to_lhs(xt_pk, 2, MAC, raw=True)


def _back(dot_out, a):
    return (a + re_.dot_out_to_delta(dot_out, 2)).astype(jnp.int32)


def _pipe(n_parts, dots_early=False):
    def body(a, p, r):
        h = a.shape[-1] // n_parts
        parts_a = [a[:, i * h:(i + 1) * h] for i in range(n_parts)]
        parts_p = [p[:, i * h:(i + 1) * h] for i in range(n_parts)]
        lhs = [_front(parts_a[0], parts_p[0])] + [None] * (n_parts - 1)
        dots, outs = [None] * n_parts, [None] * n_parts
        for i in range(n_parts):
            dots[i] = re_._mac_dot_raw(lhs[i], r, MAC)
            if i + 1 < n_parts:
                lhs[i + 1] = _front(parts_a[i + 1], parts_p[i + 1])
            if not dots_early:
                outs[i] = _back(dots[i], parts_a[i])
        if dots_early:
            outs = [_back(d, pa) for d, pa in zip(dots, parts_a)]
        return jnp.concatenate(outs, axis=-1)
    return body


def _jax_body(name):
    def v0(a, p, r):
        rot = re_.rotate_acc(a, p, 2, minus_one=True)
        digits = re_.gadget_decomp(rot, 2, 2, L2B, OFFSET)
        delta = re_.transformed_mac(digits, r, mask1=2, g_total=4,
                                    mac_dtype=MAC, radix8=False)
        return (a + delta).astype(jnp.int32)

    def v1(a, p, r):
        return re_.external_step(a, p, r, mask1=2, decomp_length=2,
                                 log2_base=L2B, offset=OFFSET, mac_dtype=MAC,
                                 radix8=False)

    def v2(a, p, r):
        rot = re_.rotate_acc(a, p, 2, minus_one=True)
        packed = re_.decomp_pack2(rot, 2, L2B, OFFSET)
        xt_pk = re_.dif_forward_packed2(packed, 2)
        lhs = re_.packed_to_lhs(xt_pk, 2, MAC, raw=True)
        lo3, hi3 = re_._mac_dot(lhs, r, 2, MAC)
        delta = re_.mac_out_to_delta(lo3, hi3, 2, radix8=True)
        return (a + delta).astype(jnp.int32)

    def v3(a, p, r):
        return re_.external_step(a, p, r, mask1=2, decomp_length=2,
                                 log2_base=L2B, offset=OFFSET, mac_dtype=MAC)

    return {"v0": v0, "v1": v1, "v2": v2, "v3": v3, "p2": _pipe(2),
            "p2b": _pipe(2, dots_early=True), "p4": _pipe(4)}[name]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ss.SCHEDULES)
def test_schedules_match_jax_bodies(inputs, mode, name):
    key_row, rhs = inputs[mode]
    a = re_.acc_rows_from_n(jnp.asarray(inputs["accum"]))
    out = _jax_body(name)(a, jnp.asarray(inputs["p"])[None, :],
                          jnp.asarray(rhs))
    want = np.asarray(re_.acc_n_from_rows(out, 2))
    before = ss.launches
    got = ss.step_schedule(name, torch.from_numpy(inputs["accum"]),
                           torch.from_numpy(inputs["p"]), key_row, **KW)
    assert ss.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 2, 1024)
    assert np.array_equal(got.numpy(), want)


def test_step_schedule_rejects_bad_input(inputs):
    key_row = inputs["NTT"][0]
    acc = torch.from_numpy(inputs["accum"])
    p = torch.from_numpy(inputs["p"])
    with pytest.raises(ValueError):
        ss.step_schedule("p3", acc, p, key_row, **KW)
    with pytest.raises(ValueError):
        ss.step_schedule("v3", acc, p[:4], key_row, **KW)
    with pytest.raises(ValueError):
        ss.step_schedule("v3", acc[:, :1].contiguous(), p, key_row, **KW)
    with pytest.raises(ValueError):
        ss.step_schedule("v3", acc, p, key_row[:2], **KW)


def test_exp_round3_on_cpu(capsys, monkeypatch):
    """The tool in-process on the CPU at batch 4, both engines (host times
    only): every schedule runs and equals v3."""
    sys.path.append(os.path.join(ROOT, "tools"))
    import exp_round3_torch as e3
    for transform in ("ntt", "fft"):
        monkeypatch.setenv("NUFHE_BENCH_TRANSFORM", transform)
        res = e3.run(4, "cpu", reps=1)
        assert set(res) == set(ss.SCHEDULES)
        assert all(r["exact"] for r in res.values())
    out = capsys.readouterr().out
    assert "host ms (CPU)" in out and "p2b dots-early" in out
