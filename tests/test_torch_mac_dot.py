"""Kernel K7's plain versions (the MAC dot alone, ``nufhe_tpu_torch/ops/
mac_dot.py``) against the JAX package's dot in both forms, at a batch of
whole 64-sample tiles and at a ragged one, a numpy mirror of the CUDA
kernel's shared-memory layouts and tiling, and ``tools/exp_int8_torch.py``
run in-process on the CPU.

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
B_RAGGED = 101        # not a multiple of 4: the kernel's masked path


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


@pytest.fixture(scope="module")
def ragged_x():
    return np.random.RandomState(2034).randint(
        -128, 256, (L, C, B_RAGGED)).astype(np.int32)


@pytest.mark.parametrize("batch", [B, B_RAGGED])
@pytest.mark.parametrize("form", md.FORMS)
def test_mac_dot_matches_jax(inputs, ragged_x, form, batch):
    rhs, x = inputs
    if batch == B_RAGGED:
        x = ragged_x
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
        assert got.dtype == torch.int32 and tuple(got.shape) == (L, C, batch)
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


# The CUDA kernel's layouts (kernels/csrc/mac_dot.cu), mirrored in numpy.
KSTEP_BYTES = 32                     # K bytes of one wgmma (k32 s8, k16 bf16)
ATOM_BYTES = Q * 128                 # 128 bytes of K for all q rows
GROUP_BYTES = 128 * 128              # 128 q rows of one atom


def _row_of_q(q):
    """Shared-memory row of rhs column q: [0,64) [256,320) [64,128)
    [320,384) [128,256)."""
    q = np.asarray(q)
    return np.where(q < 128, np.where(q < 64, q, q + 64),
                    np.where(q < 256, q + 128,
                             np.where(q < 320, q - 192, q - 128)))


def _swizzle128(addr):
    """The 128-byte swizzle of TMA and of wgmma's B128 layout: address bits
    [4, 7) ^= bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _rhs_image(rhs_l, esize):
    """rhs[l] (C, Q) as the kernel's transpose writes it: the 16 bytes of
    K chunk ch of row n at ka * ATOM_BYTES + n * 128 + ((ch ^ (n & 7)) <<
    4)."""
    k_bytes = rhs_l.T.copy().view(np.uint8).reshape(Q, C * esize)  # q-major
    image = np.zeros(C * Q * esize, np.uint8)
    n = _row_of_q(np.arange(Q))
    for ka in range(C * esize // 128):
        for ch in range(8):
            chunk = k_bytes[:, 128 * ka + 16 * ch:128 * ka + 16 * ch + 16]
            base = ka * ATOM_BYTES + n * 128 + ((ch ^ (n & 7)) << 4)
            image[base[:, None] + np.arange(16)] = chunk
    return image


@pytest.mark.parametrize("form", md.FORMS)
def test_kernel_layout_mirror(inputs, form):
    """What wgmma reads through K7's descriptors (start ka * ATOM_BYTES + g
    * GROUP_BYTES + 32 (ks & 3), 8-row atoms 1024 bytes apart, swizzled)
    is rhs^T for the group's q rows; the ring read of warp w, lane (gid,
    tig) at c row r is samples 16 w + 2 gid, + 1 of the TMA box; and the
    three groups' accumulators, folded on columns n and n + 64 and stored
    at those samples, give mac_dot_plain."""
    rhs, x = inputs
    esize = 1 if form == "int8" else 2
    rhs_l = rhs[0] if form == "int8" else (
        torch.from_numpy(rhs[0]).to(torch.bfloat16).view(torch.int16).numpy())
    image = _rhs_image(rhs_l, esize)
    kstep = KSTEP_BYTES // esize
    k_bytes = rhs_l.T.copy().view(np.uint8).reshape(Q, C * esize)
    q_of_row = np.argsort(_row_of_q(np.arange(Q)))
    n = np.arange(128)
    for g in range(3):
        for ks in range(C // kstep):
            start = ((ks >> 2) * ATOM_BYTES + g * GROUP_BYTES
                     + 32 * (ks & 3))
            addr = (start + (n[:, None] // 8) * 1024 + (n[:, None] % 8) * 128
                    + np.arange(KSTEP_BYTES))
            want = k_bytes[q_of_row[128 * g + n], 32 * ks:32 * ks + 32]
            assert np.array_equal(image[_swizzle128(addr)], want)
    # ring reads: 32-sample boxes of 128-byte rows; warp w, lane gid
    w, gid, r = np.meshgrid(np.arange(4), np.arange(8), np.arange(64),
                            indexing="ij")
    chunk16 = 4 * (w & 1) + (gid >> 1)
    kernel = ((w >> 1) * 8192 + r * 128 + ((chunk16 ^ (r & 7)) << 4)
              + 8 * (gid & 1))
    sample = 16 * w + 2 * gid
    tma = (sample // 32) * 8192 + _swizzle128(r * 128 + (sample % 32) * 4)
    assert np.array_equal(kernel, tma)
    # the tiling: per 64-sample tile and q group, D = A . B, fold n, n + 64
    rhs_t = torch.from_numpy(rhs[:2])
    if form == "bf16":
        rhs_t = rhs_t.to(torch.bfloat16)
    xs = torch.from_numpy(x[:2])
    b_rows = rhs_t.to(torch.float64)[:, :, q_of_row]           # (2, C, Q)
    lhs = md.lhs_values(xs, form)                              # (2, C, B)
    perm = (16 * (np.arange(64) // 16) + 2 * (np.arange(64) % 8)
            + (np.arange(64) % 16) // 8)            # M row -> sample
    got = torch.zeros(2, C, B, dtype=torch.int64)
    for g in range(3):
        d = torch.bmm(lhs[:, :, perm].transpose(1, 2),
                      b_rows[:, :, 128 * g:128 * g + 128])     # (2, 64, 128)
        if form == "bf16":
            d = d.to(torch.float32).to(torch.float64)
        d = d.to(torch.int64)
        if g < 2:
            got[:, 64 * g:64 * g + 64, perm] = (d[:, :, :64]
                                                + d[:, :, 64:]).transpose(1, 2)
        else:
            got[:, 128:, perm] = d.transpose(1, 2)
    assert torch.equal((got & 255).to(torch.int32),
                       md.mac_dot_plain(xs, rhs_t))


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


def test_mac_dot_cuts_tool(monkeypatch):
    """``tools/mac_dot_cuts_torch.py`` builds K7 with the measurement
    macros that ``mac_dot.cu`` defines, and refuses to run without a
    card."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.append(os.path.join(root, "tools"))
    import mac_dot_cuts_torch as mc
    source = open(os.path.join(root, "nufhe_tpu_torch", "kernels", "csrc",
                               "mac_dot.cu")).read()
    for macros in mc.CUTS.values():
        for macro in macros:
            assert "#ifdef %s\n" % macro in source, macro
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        mc.main([])

