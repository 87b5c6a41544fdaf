"""The port's chunked blind rotation (kernel K3's plain version), the
rounded-key ('FFT') form of the CMUX step (kernel K1's plain version) and
their oracles, against the JAX package: the Pallas kernels in interpret
mode and the numpy oracles.  Bit-exact throughout; on the CPU the launch
counters do not move."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ref import bootstrap_ref, polynomials_ref, tgsw_ref, transform_ref
from nufhe_tpu.ops import bootstrap as jboot
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw
from nufhe_tpu.ops.pallas import blind_rotate as pbr

from nufhe_tpu_torch.ops import blind_rotate as brc
from nufhe_tpu_torch.ops import bootstrap as tboot, cmux, transform as ttf
from nufhe_tpu_torch.params import NuFHEParameters as TParams
from nufhe_tpu_torch.ref import bootstrap_ref as t_bootstrap_ref
from nufhe_tpu_torch.ref import tgsw_ref as t_tgsw_ref
from nufhe_tpu_torch.ref import transform_ref as t_transform_ref

TP = NuFHEParameters().tgsw_params
KW = dict(offset=int(TP.offset), log2_base=TP.bs_log2_base)
MASK1 = 2


def _inputs(seed, b, rows):
    rng = np.random.RandomState(seed)
    accum = rng.randint(-2**31, 2**31, (b, MASK1, 1024)).astype(np.int32)
    bara = rng.randint(0, 2 * 1024, (b, rows)).astype(np.int32)
    bk_coeff = rng.randint(
        -2**31, 2**31,
        (rows, MASK1, TP.decomp_length, MASK1, 1024)).astype(np.int32)
    return accum, bara, bk_coeff


def _counts():
    return cmux.launches, brc.launches


def test_chunk_plain_matches_pallas_chunk_interpret():
    """Two launches of 2 steps (start 0 and 2) against the JAX package's
    chunked kernel on its own key form."""
    b, steps, chunk = 128, 4, 2
    accum, bara, bk_coeff = _inputs(21, b, steps)
    rot = pbr.make_blind_rotate_chunk(
        MASK1, TP.decomp_length, TP.bs_log2_base, int(TP.offset), chunk,
        lane_tile=128, mac_dtype=jnp.float32, interpret=True)
    bk_dev = dtgsw.prepare_bootstrap_key_device(bk_coeff)
    bara3 = jnp.asarray(bara.T).reshape(steps, 1, b)
    rows = re_.acc_rows_from_n(jnp.asarray(accum))
    for start in range(0, steps, chunk):
        rows = rot(rows, bara3, bk_dev, start)
    want = np.asarray(re_.acc_n_from_rows(rows, MASK1))

    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    acc = torch.from_numpy(accum)
    before = _counts()
    for start in range(0, steps, chunk):
        acc = brc.blind_rotate_chunk(acc, bara_t, key, start, chunk, **KW)
    assert _counts() == before          # CPU tensors take the plain version
    assert np.array_equal(acc.numpy(), want)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_chunk_equals_sequential_steps(transform_type):
    """Steps [1, 4) of a 5-step rotation in one launch equal three K1
    steps, in both key forms, and the oracle's rotation of those steps."""
    accum, bara, bk_coeff = _inputs(3, 4, 5)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    acc = torch.from_numpy(accum)
    got = brc.blind_rotate_chunk(acc, bara_t, key, 1, 3, **KW)
    want = acc
    for i in range(1, 4):
        want = cmux.cmux_step(want, bara_t[i], key[i], **KW)
    assert torch.equal(got, want)
    oracle = bootstrap_ref.blind_rotate(
        accum, bk_coeff[1:4], bara[:, 1:4], TP, exact=transform_type == 'NTT')
    assert np.array_equal(got.numpy(), oracle)


def _rounded_row_inputs(seed, b):
    accum, bara, bk_coeff = _inputs(seed, b, 1)
    hat = transform_ref.forward(bk_coeff) & np.uint64(2**38 - 1)
    # about one residue in 64 is a rounding tie, where the two sides of the
    # rounded key differ from plain negation
    assert ((hat & np.uint64(63)) == 32).sum() > 100
    return accum, bara[:, 0], bk_coeff


def test_rounded_step_matches_pallas_step_interpret():
    accum, powers, bk_coeff = _rounded_row_inputs(11, 128)
    step = pbr.make_external_step_rows(
        MASK1, TP.decomp_length, TP.bs_log2_base, int(TP.offset),
        lane_tile=128, mac_dtype=jnp.float32, interpret=True)
    bk_dev = dtgsw.prepare_bootstrap_key_device(bk_coeff, exact=False)
    rows = step(re_.acc_rows_from_n(jnp.asarray(accum)),
                jnp.asarray(powers)[None, :], bk_dev[0])
    want = np.asarray(re_.acc_n_from_rows(rows, MASK1))

    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    before = _counts()
    got = cmux.cmux_step(torch.from_numpy(accum), torch.from_numpy(powers),
                         key[0], **KW)
    assert _counts() == before
    assert np.array_equal(got.numpy(), want)


def test_rounded_step_matches_oracle():
    accum, powers, bk_coeff = _rounded_row_inputs(5, 6)
    shifted = polynomials_ref.shift_polynomial(accum, powers, minus_one=True)
    want = accum + tgsw_ref.tgsw_external_mul_rounded(shifted, bk_coeff, 0, TP)
    assert np.array_equal(
        accum + t_tgsw_ref.tgsw_external_mul_rounded(
            shifted, bk_coeff, 0, TParams().tgsw_params), want)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    assert np.array_equal(cmux.cmux_step(acc, p, key[0], **KW).numpy(), want)
    # negating the rounded +v side at run time is close but not bit-equal
    negated = torch.stack([key[0, 0], -key[0, 0]])
    assert not np.array_equal(cmux.cmux_step(acc, p, negated, **KW).numpy(),
                              want)


def test_rounded_key_matches_jax_sides():
    _, _, bk_coeff = _inputs(8, 1, 3)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT').numpy()
    assert key.shape == (3, 2, MASK1 * TP.decomp_length, MASK1, 64, 32)
    assert np.abs(key).max() <= 2**37
    hat = transform_ref.forward(bk_coeff)
    sides = transform_ref.rounded_key_sides(hat)
    for port_side, jax_side in zip(t_transform_ref.rounded_key_sides(hat), sides):
        assert np.array_equal(port_side, jax_side)
    mask = np.uint64(2**38 - 1)
    for s, q in enumerate(sides):
        want = ((q * np.uint64(64)) & mask).reshape(key[:, s].shape)
        assert np.array_equal(key[:, s].astype(np.uint64) & mask, want)


def test_port_oracles_match_jax():
    """The port's copies of the blind-rotation oracle (both modes), the
    coarse modulus switch and the variance estimate."""
    accum, bara, bk_coeff = _inputs(13, 2, 2)
    for exact in (True, False):
        assert np.array_equal(
            t_bootstrap_ref.blind_rotate(accum, bk_coeff, bara,
                                         TParams().tgsw_params, exact=exact),
            bootstrap_ref.blind_rotate(accum, bk_coeff, bara, TP, exact=exact))
    phases = np.arange(2048, dtype=np.int32)
    for bits in range(5):
        want = np.asarray(jboot.round_phase_coarse(jnp.asarray(phases), bits,
                                                   1024))
        assert np.array_equal(
            t_bootstrap_ref.round_phase_coarse_ref(phases, bits, 1024), want)
        assert np.array_equal(tboot.round_phase_coarse(
            torch.from_numpy(phases), bits, 1024).numpy(), want)
    for exact in (True, False):
        for bits in (0, 1, 3):
            assert t_bootstrap_ref.blind_rotate_variance(
                TParams().tgsw_params, 500, exact=exact,
                coarse_phase_bits=bits) == bootstrap_ref.blind_rotate_variance(
                    TP, 500, exact=exact, coarse_phase_bits=bits)


def test_wrappers_reject_bad_input():
    accum, bara, bk_coeff = _inputs(4, 2, 3)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    rkey = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    acc = torch.from_numpy(accum)
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    with pytest.raises(ValueError):      # start + chunk > n
        brc.blind_rotate_chunk(acc, bara_t, key, 1, 3, **KW)
    with pytest.raises(ValueError):      # negative start
        brc.blind_rotate_chunk(acc, bara_t, key, -1, 2, **KW)
    with pytest.raises(ValueError):      # key rows != steps
        brc.blind_rotate_chunk(acc, bara_t, key[:2], 0, 2, **KW)
    with pytest.raises(ValueError):      # not a key form: G = 3, O = 2
        brc.blind_rotate_chunk(acc, bara_t, key[:, :3], 0, 2, **KW)
    with pytest.raises(TypeError):
        brc.blind_rotate_chunk(acc, bara_t, key.to(torch.int32), 0, 2, **KW)
    with pytest.raises(TypeError):
        brc.blind_rotate_chunk(acc, bara_t.to(torch.int64), key, 0, 2, **KW)
    with pytest.raises(ValueError):      # bara_t is (n, B)
        brc.blind_rotate_chunk(acc, bara_t.t(), key, 0, 2, **KW)
    with pytest.raises(ValueError):      # a rounded row with one side
        cmux.cmux_step(acc, bara_t[0], rkey[0, :1], **KW)
    with pytest.raises(TypeError):
        cmux.cmux_step(acc, bara_t[0], rkey[0].to(torch.float64), **KW)
    with pytest.raises(ValueError):      # the key's form is not the engine's
        tboot.blind_rotate(acc, rkey, torch.from_numpy(bara),
                           TParams().tgsw_params, exact=True)
    assert brc.blind_rotate_chunk(acc, bara_t, rkey, 0, 3, **KW).shape \
        == acc.shape


def _k3_operand(key_row):
    """K3's on-chip key operand rule, written as the kernel writes it: the
    int64 key row (G, O, L, R) (or (2, G, O, L, R) rounded), any
    representative mod 2^38, -> two-sided limbs (exact: vlo = balanced
    x mod 64, then the 4 balanced radix-2^8 digits of (x - vlo) / 64 mod
    2^32 as the bytes of (y + 0x80808080) ^ 0x80808080; side 1 from -x;
    rounded: the digits of (x + 32) >> 6 of each stored side) -> per (g, o,
    slot, limb) a reversed 64-byte row, byte 31 - r the limb of side 0 at
    rotation r and byte 63 - r that of side 1 -> the (L, 256, Q) operand
    whose entry (c = g*64 + i*32 + u, q = s*64 + o*32 + k) is byte
    31 - k + u of the row that digit limb i meets in group s.  Natural slot
    order (slot t is frequency t)."""
    def radix256(y):
        word = (((y & 0xFFFFFFFF) + 0x80808080) & 0xFFFFFFFF) ^ 0x80808080
        digits = [(word >> (8 * q)) & 255 for q in range(4)]
        return [b - ((b & 128) << 1) for b in digits]      # signed bytes

    def split_exact(x):
        vlo = ((x + 32) & 63) - 32
        return [vlo] + radix256((x - vlo) >> 6) + [4 * vlo]

    rounded = key_row.dim() == 5
    if rounded:
        s0 = radix256((key_row[0] + 32) >> 6)
        s1 = radix256((key_row[1] + 32) >> 6)
        meets = {(0, s): s for s in range(4)}
        meets.update({(1, s): s - 1 for s in range(1, 4)})
    else:
        s0, s1 = split_exact(key_row), split_exact(-key_row)
        meets = {(0, s): s for s in range(5)}
        meets.update({(1, 1): 5, (1, 2): 1, (1, 3): 2, (1, 4): 3})
    g_sz, o_sz, l_sz, r_sz = s0[0].shape
    rows = torch.zeros((g_sz, o_sz, l_sz, len(s0), 64), dtype=torch.int64)
    lane = torch.arange(r_sz)
    for limb in range(len(s0)):
        rows[:, :, :, limb, 31 - lane] = s0[limb]
        rows[:, :, :, limb, 63 - lane] = s1[limb]
    n_groups = 4 if rounded else 5
    k = torch.arange(r_sz)
    at = 31 - k[:, None] + k[None, :]                       # [k, u]
    op = torch.zeros((l_sz, g_sz, 2, r_sz, n_groups, o_sz, r_sz),
                     dtype=torch.int64)
    for (i, s), limb in meets.items():
        vals = rows[:, :, :, limb][..., at]                 # (G, O, L, k, u)
        op[:, :, i, :, s] = vals.permute(2, 0, 4, 1, 3)     # (L, G, u, O, k)
    return op.reshape(l_sz, g_sz * 2 * r_sz, n_groups * o_sz * r_sz).to(
        torch.int8)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_k3_operand_rule_matches_build_mac_rhs(transform_type):
    """The rule K3 applies on chip to the int64 key gives the TPU's MAC
    operand (the port's build_mac_rhs of key_limbs_host) bit for bit, slot
    order permuted, on a key with rounding ties."""
    _, _, bk_coeff = _rounded_row_inputs(17, 1)
    exact = transform_type == 'NTT'
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    hat = transform_ref.forward(bk_coeff)[0]
    limbs = ttf.key_limbs_host(hat, exact=exact)
    want = ttf.build_mac_rhs(torch.from_numpy(
        limbs.reshape((MASK1 * TP.decomp_length, MASK1, 64, 32)
                      + limbs.shape[-2:])))
    got = _k3_operand(key[0])
    assert got.shape == want.shape
    assert torch.equal(got[torch.from_numpy(ttf.BITREV_L)], want)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_k3_operand_step_equals_cmux_step(transform_type):
    """One step in limb form on K3's operand (the lanes engine's step, with
    the q-layout around it) equals the plain K1 step bit for bit."""
    from nufhe_tpu_torch.ops import flat_engine as fe
    accum, powers, bk_coeff = _rounded_row_inputs(19, 6)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    op = _k3_operand(key[0])[torch.from_numpy(ttf.BITREV_L)]
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    acc_q = fe.q_from_n(acc).reshape(acc.shape[0], -1)
    got = fe.external_step(acc_q, p, op, mask1=MASK1,
                           decomp_length=TP.decomp_length, **KW)
    got = fe.n_from_q(got.reshape(acc.shape))
    assert torch.equal(got, cmux.cmux_step_plain(acc, p, key[0], **KW))
