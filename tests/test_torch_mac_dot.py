"""Kernel K7's plain versions (the MAC dot alone, ``nufhe_tpu_torch/ops/
mac_dot.py``) against the JAX package's dot in both forms, and
``tools/exp_int8_torch.py`` run in-process on the CPU.

``tools/exp_int8.py`` cannot be imported (it times TPU launches at import
time), so its bodies ``mac_int8`` and ``mac_bf16`` (``:25-38``) and the
kernel's fold and mask (``:43-46``) are rebuilt here in jnp on the CPU from
the same ``jax.lax.dot_general`` calls.  Inputs in [-128, 256), so that the
int8 cast wraps [128, 256) to negative values (the XLA convert) where the
bf16 cast keeps them; two chained calls.  (Both forms give the dot mod
2^8, so they agree wherever the bf16 cast is exact.)  Bit-exact; on the
CPU the launch count does not move."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nufhe_tpu_torch.ops import mac_dot as md

L, C, Q = 64, 256, 384
B = 64


def _jax_call(x, rhs, form):
    """One call of the JAX tool's kernel body on the CPU."""
    if form == "int8":
        out = jax.lax.dot_general(
            rhs, x.astype(jnp.int8),
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)
    else:
        out = jax.lax.dot_general(
            rhs, x.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32).astype(jnp.int32)
    o = out[:, :C, :] + jnp.concatenate(
        [out[:, C:, :], jnp.zeros((L, 2 * C - Q, x.shape[-1]), jnp.int32)],
        axis=1)
    return o & 255


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rs = np.random.RandomState(2033)
    rhs = rs.randint(-127, 128, (L, C, Q)).astype(np.int8)
    x = rs.randint(-128, 256, (L, C, B)).astype(np.int32)
    return rhs, x


@pytest.mark.parametrize("form", md.FORMS)
def test_mac_dot_matches_jax(inputs, form):
    rhs, x = inputs
    rhs_t = torch.from_numpy(rhs)
    rhs_j = jnp.asarray(rhs)
    if form == "bf16":
        rhs_t = rhs_t.to(torch.bfloat16)
        rhs_j = rhs_j.astype(jnp.bfloat16)
    got, want = torch.from_numpy(x), jnp.asarray(x)
    before = md.launches
    for _ in range(2):                 # the second call sees [0, 256)
        got = md.mac_dot(got, rhs_t)
        want = _jax_call(want, rhs_j, form)
        assert got.dtype == torch.int32 and tuple(got.shape) == (L, C, B)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert md.launches == before


def test_forms_agree_mod_256_while_bf16_is_exact(inputs):
    """The result is the dot mod 2^8, linear in the input, so the int8
    cast's wrap of [128, 256) (a multiple of 256 off) does not change it:
    the forms agree wherever the bf16 cast is exact (|x| <= 2^8), and
    differ where it rounds (odd x above 2^8)."""
    rhs, x = inputs
    r8 = torch.from_numpy(rhs)
    x1 = torch.from_numpy((x & 255).astype(np.int32))
    assert torch.equal(md.mac_dot(x1, r8),
                       md.mac_dot(x1, r8.to(torch.bfloat16)))
    big = torch.from_numpy((2 * (x & 255) + 257).astype(np.int32))
    assert not torch.equal(md.mac_dot(big, r8),
                           md.mac_dot(big, r8.to(torch.bfloat16)))


def test_mac_dot_rejects_bad_input(inputs):
    rhs, x = inputs
    xt, rt = torch.from_numpy(x), torch.from_numpy(rhs)
    with pytest.raises(TypeError):
        md.mac_dot(xt, rt.to(torch.int32))
    with pytest.raises(TypeError):
        md.mac_dot(xt.to(torch.int64), rt)
    with pytest.raises(ValueError):
        md.mac_dot(xt[:, :128].contiguous(), rt)


def test_exp_int8_on_cpu(capsys):
    """The tool in-process on the CPU at batch 8: both forms exact against
    their plain versions, host times only."""
    import os
    import sys
    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import exp_int8_torch as e8
    res = e8.run(8, "cpu", reps=1)
    assert set(res) == set(md.FORMS)
    assert all(r["exact"] and r["library_ms"] is None for r in res.values())
    assert "host ms (CPU)" in capsys.readouterr().out
