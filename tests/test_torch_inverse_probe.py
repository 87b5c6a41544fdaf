"""Kernel K13's plain version (the inverse probes,
``nufhe_tpu_torch/ops/inverse_probe.py``) against the JAX package, and
``tools/exp_inverse_torch.py`` run in-process on the CPU.

``tools/exp_inverse.py`` cannot be imported (it times TPU launches at
import), so its bodies are copied here (``make_inverse``,
``tools/exp_inverse.py:36-81``, and ``run``'s stacking and
``normalize_dual``), jnp on the CPU over the rows engine's ``_roll``,
``_mask`` and ``rot_block``, no Pallas.  ``base`` and ``sliced`` equal
``rows_engine.dit_inverse`` + ``normalize_dual`` on the stacked input bit
for bit (and so does the copied ``make_inverse('full')``); ``notw`` and
``align`` equal the copied probes; the card's own ``noroll`` (every
rotation replaced by its sign) equals the same probe written here over
the same stages."""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nufhe_tpu.ops import rows_engine as re_

from nufhe_tpu_torch.ops import inverse_probe as ip

B = 8
LOG_L, M, R = re_.LOG_L, re_.M, re_.R
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inverse(tw_mode, partner_rolls=True):
    """``tools/exp_inverse.py:36-81``, with one more ``tw_mode``: 'sign',
    the card's noroll (each rotation's sign alone, the fold's Y too)."""
    def twiddle(x, step, h, stride):
        if h <= 1 or tw_mode == 'none':
            return x
        for b in range(h.bit_length() - 1):
            e = (step * (1 << b)) % (2 * R)
            if e == 0:
                continue
            neg = e >= R
            e_r = e - R if neg else e
            if tw_mode == 'align':
                e_r = (e_r // 8) * 8
            if tw_mode == 'sign':
                lanes = jax.lax.broadcasted_iota(jnp.int32, (x.shape[0], 1),
                                                 0) % R
                flip = re_._mask(x, 'mbit', stride, h, b) & (
                    (lanes < e_r) != neg)
                x = jnp.where(flip, -x, x)
                continue
            hi_roll = re_._roll(x, e_r) if e_r else x
            lo_roll = re_._roll(x, e_r - R)
            if neg:
                hi_roll, lo_roll = -hi_roll, lo_roll
            else:
                lo_roll = -lo_roll
            if e_r == 0:
                x = jnp.where(re_._mask(x, 'mbit', stride, h, b), hi_roll, x)
            else:
                x = jnp.where(
                    re_._mask(x, 'mbit_and_geq', stride, h, b, R, e_r),
                    hi_roll,
                    jnp.where(re_._mask(x, 'mbit', stride, h, b), lo_roll, x))
        return x

    def inverse(x, stride):
        for s in range(LOG_L - 1):
            mmax = 1 << s
            d = mmax * stride
            step = -(1 << (LOG_L - s - 1))
            is_lo = re_._mask(x, 'lt_mod', 2 * d, d)
            part = re_._roll(x, -d) if partner_rolls else x
            tw = twiddle(part, step, mmax, stride)
            x = jnp.where(is_lo, x + tw,
                          re_._roll(x - tw, d) if partner_rolls else x - tw)
        half = M * stride
        lo = x[:half]
        tw = twiddle(x[half:], -1, M, stride)
        s_plus = lo + tw
        s_minus = lo - tw
        if tw_mode == 'none':
            return s_plus + s_minus
        if tw_mode == 'sign':
            lanes = jax.lax.broadcasted_iota(jnp.int32, (half, 1), 0) % R
            return s_plus + jnp.where(lanes == 0, -s_minus, s_minus)
        return s_plus + re_.rot_block(s_minus, 1)
    return inverse


def _run(inverse, a):
    """``tools/exp_inverse.py``'s ``run`` body on a (2048, b) input."""
    x = jnp.concatenate([a, a, a, a], axis=0)
    folded = inverse(x, 4 * R)
    v = folded.reshape(M, 2, 2 * R, a.shape[-1])
    return np.asarray(re_.normalize_dual(v[:, 0], v[:, 1])).reshape(
        2 * re_.N, a.shape[-1])


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    a = np.random.RandomState(2047).randint(-2**31, 2**31, (2048, B)).astype(
        np.int32)
    return a, torch.from_numpy(np.ascontiguousarray(a.T))


def _port(name, a_t):
    before = ip.launches
    out = ip.inverse_probe(name, a_t)
    assert ip.launches == before
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, 2048)
    return out.numpy().T


@pytest.mark.parametrize("name", ["base", "sliced"])
def test_exact_probes_match_dit_inverse(inputs, name):
    a, a_t = inputs
    want = _run(lambda x, s: re_.dit_inverse(x, s), jnp.asarray(a))
    assert np.array_equal(_port(name, a_t), want)
    if name == "base":
        assert np.array_equal(_run(make_inverse('full'), jnp.asarray(a)),
                              want)


@pytest.mark.parametrize("name,mode", [("notw", "none"), ("align", "align"),
                                       ("noroll", "sign")])
def test_timing_probes_match_their_bodies(inputs, name, mode):
    a, a_t = inputs
    want = _run(make_inverse(mode), jnp.asarray(a))
    assert np.array_equal(_port(name, a_t), want)


def test_inverse_probe_rejects_bad_input(inputs):
    _, a_t = inputs
    with pytest.raises(ValueError):
        ip.inverse_probe("half", a_t)
    with pytest.raises(ValueError):
        ip.inverse_probe("base", a_t[:, :1024].contiguous())


def test_exp_inverse_on_cpu(capsys):
    sys.path.append(os.path.join(ROOT, "tools"))
    import exp_inverse_torch as ei
    res = ei.run(4, "cpu", reps=1)
    assert set(res["ms"]) == set(ip.PROBES) and res["sliced_exact"]
    assert "sliced exact: True" in capsys.readouterr().out
