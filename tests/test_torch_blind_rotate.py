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
    with pytest.raises(ValueError):      # not a key form
        brc.blind_rotate_chunk(acc, bara_t, key[:, :2], 0, 2, **KW)
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
