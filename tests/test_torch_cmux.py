"""The port's CMUX step (kernel K1's plain version) and its transformed key
against the JAX package: the Pallas step kernel in interpret mode, the
numpy oracle, and the oracle's forward transform.  Bit-exact throughout."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ref import tgsw_ref, polynomials_ref, transform_ref
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw
from nufhe_tpu.ops.pallas import blind_rotate as pbr

from nufhe_tpu_torch.ops import cmux, transform as ttf
from nufhe_tpu_torch.params import NuFHEParameters as TParams
from nufhe_tpu_torch.ref import tgsw_ref as t_tgsw_ref
from nufhe_tpu_torch.ref import transform_ref as t_transform_ref

TP = NuFHEParameters().tgsw_params
MASK1 = 2


def _inputs(seed, b, rows=1):
    rng = np.random.RandomState(seed)
    accum = rng.randint(-2**31, 2**31, (b, MASK1, 1024)).astype(np.int32)
    powers = rng.randint(0, 2 * 1024, (b,)).astype(np.int32)
    bk_coeff = rng.randint(
        -2**31, 2**31,
        (rows, MASK1, TP.decomp_length, MASK1, 1024)).astype(np.int32)
    return accum, powers, bk_coeff


def _port_step(accum, powers, key_row):
    launches = cmux.launches
    out = cmux.cmux_step(torch.from_numpy(accum), torch.from_numpy(powers),
                         key_row, offset=int(TP.offset),
                         log2_base=TP.bs_log2_base)
    assert cmux.launches == launches    # CPU tensors take the plain version
    return out.numpy()


def test_cmux_plain_matches_pallas_step_interpret():
    accum, powers, bk_coeff = _inputs(11, 128)
    step = pbr.make_external_step_rows(
        MASK1, TP.decomp_length, TP.bs_log2_base, int(TP.offset),
        lane_tile=128, mac_dtype=jnp.float32, interpret=True)
    bk_dev = dtgsw.prepare_bootstrap_key_device(bk_coeff)
    acc_rows = re_.acc_rows_from_n(jnp.asarray(accum))
    got_rows = step(acc_rows, jnp.asarray(powers)[None, :], bk_dev[0])
    want = np.asarray(re_.acc_n_from_rows(got_rows, MASK1))

    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    assert np.array_equal(_port_step(accum, powers, key[0]), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cmux_plain_matches_oracle(seed):
    accum, powers, bk_coeff = _inputs(seed, 6, rows=2)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    for row in range(2):
        shifted = polynomials_ref.shift_polynomial(
            accum, powers, minus_one=True)
        want = accum + tgsw_ref.tgsw_external_mul(shifted, bk_coeff, row, TP)
        assert np.array_equal(_port_step(accum, powers, key[row]), want)
        # the port's own copy of the oracle agrees
        port_tp = TParams().tgsw_params
        assert np.array_equal(
            accum + t_tgsw_ref.tgsw_external_mul(shifted, bk_coeff, row,
                                                 port_tp), want)


def test_cmux_plain_extreme_values():
    """Digits at both ends of their range and the largest key residues."""
    accum, powers, bk_coeff = _inputs(5, 4)
    accum[0] = 2**31 - 1
    accum[1] = -2**31
    bk_coeff[..., ::2] = 2**31 - 1
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    shifted = polynomials_ref.shift_polynomial(accum, powers, minus_one=True)
    want = accum + tgsw_ref.tgsw_external_mul(shifted, bk_coeff, 0, TP)
    assert np.array_equal(_port_step(accum, powers, key[0]), want)


def test_transformed_key_matches_jax_forward():
    _, _, bk_coeff = _inputs(3, 1, rows=3)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu").numpy()
    assert key.shape == (3, MASK1 * TP.decomp_length, MASK1, 64, 32)
    assert np.abs(key).max() <= 2**37
    want = transform_ref.forward(bk_coeff) & np.uint64(2**38 - 1)
    want = want.reshape(key.shape)
    assert np.array_equal(key.astype(np.uint64) & np.uint64(2**38 - 1), want)


def test_torch_transform_matches_jax_oracle():
    rng = np.random.RandomState(8)
    a = rng.randint(-2**31, 2**31, (5, 1024)).astype(np.int32)
    fwd = ttf.forward(torch.from_numpy(a)).numpy()
    assert np.array_equal(fwd.astype(np.uint64), transform_ref.forward(a))
    chat = rng.randint(0, 2**38, (5, 64, 32)).astype(np.int64)
    inv = ttf.inverse_unscaled(torch.from_numpy(chat)).numpy()
    want = transform_ref.inverse_unscaled(chat.astype(np.uint64))
    assert np.array_equal(inv.astype(np.uint64), want)
    # the port's numpy oracle: the exact product equals the schoolbook one
    b = rng.randint(-2**31, 2**31, (5, 1024)).astype(np.int32)
    prod = t_transform_ref.negacyclic_mul(a, b)
    assert np.array_equal(prod, t_transform_ref.schoolbook_negacyclic(a, b))
    assert np.array_equal(prod, transform_ref.negacyclic_mul(a, b))


def test_cmux_wrapper_rejects_bad_input():
    accum, powers, bk_coeff = _inputs(4, 2)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")[0]
    acc = torch.from_numpy(accum)
    p = torch.from_numpy(powers)
    kw = dict(offset=int(TP.offset), log2_base=TP.bs_log2_base)
    with pytest.raises(TypeError):
        cmux.cmux_step(acc.to(torch.int64), p, key, **kw)
    with pytest.raises(ValueError):
        cmux.cmux_step(acc[:, :1], p, key, **kw)
    with pytest.raises(ValueError):
        cmux.cmux_step(acc, p[:1], key, **kw)
    with pytest.raises(ValueError):      # G = 3 is not a multiple of O = 2
        cmux.cmux_step(acc, p, key[:3], **kw)
    with pytest.raises(ValueError):
        ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type='FFTW')
