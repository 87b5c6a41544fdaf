"""The rest of the flat engine's public surface in the port, against the
JAX functions that ``tests/test_ops_device.py`` tests and the numpy
oracles: ``monomial_shift``, ``tgsw_polynomial_decomp``, the exact and
rounded transformed external product, the batched ``negacyclic_mul_device``
and the polynomial transform facade.  Bit-exact, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu import polynomial_transform as jpt
from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ref import polynomials_ref, tgsw_ref, transform_ref as tr
from nufhe_tpu.ref import fft_ref as jfft, ntt_goldilocks as jntt
from nufhe_tpu.ops import tgsw as jtgsw, tlwe as jtlwe, transform as jtf

from nufhe_tpu_torch import polynomial_transform as tpt
from nufhe_tpu_torch.ops import lanes_step as k4
from nufhe_tpu_torch.ops import tgsw as ttgsw, tlwe as ttlwe
from nufhe_tpu_torch.ops import transform as ttf
from nufhe_tpu_torch.ref import fft_ref as tfft, ntt_goldilocks as tntt

N = 1024


@pytest.mark.parametrize("invert_powers,minus_one", [
    (False, False), (True, False), (False, True)])
def test_monomial_shift_matches_jax(invert_powers, minus_one):
    rng = np.random.RandomState(1)
    src = rng.randint(-2**31, 2**31, (4, 3, N)).astype(np.int32)
    powers = rng.randint(0, 2 * N, (4,)).astype(np.int32)
    powers[:2] = (0, 2 * N - 1)
    want = np.asarray(jtlwe.monomial_shift(
        jnp.asarray(src), jnp.asarray(powers), invert_powers=invert_powers,
        minus_one=minus_one))
    assert np.array_equal(want, polynomials_ref.shift_polynomial(
        src, powers, invert_powers=invert_powers, minus_one=minus_one))
    got = ttlwe.monomial_shift(torch.from_numpy(src), torch.from_numpy(powers),
                               invert_powers=invert_powers, minus_one=minus_one)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_tgsw_decomp_matches_jax():
    tp = NuFHEParameters().tgsw_params
    sample = np.random.RandomState(2).randint(
        -2**31, 2**31, (3, 2, N)).astype(np.int32)
    args = (int(tp.offset), tp.decomp_length, tp.bs_log2_base)
    want = np.asarray(jtgsw.tgsw_polynomial_decomp(jnp.asarray(sample), *args))
    assert np.array_equal(want, tgsw_ref.tgsw_polynomial_decomp(sample, tp))
    got = ttgsw.tgsw_polynomial_decomp(torch.from_numpy(sample), *args)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask_size", [1, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_external_mul_matches_jax(mask_size, exact):
    """The transformed external product through the lanes engine, exact
    and rounded key, against the JAX function and the oracle."""
    tp = NuFHEParameters(tlwe_mask_size=mask_size).tgsw_params
    mask1 = mask_size + 1
    rng = np.random.RandomState(3 + mask_size)
    accum = rng.randint(-2**31, 2**31, (2, mask1, N)).astype(np.int32)
    bk_coeff = rng.randint(-2**31, 2**31,
                           (2, mask1, tp.decomp_length, mask1, N)).astype(np.int32)
    args = (int(tp.offset), tp.decomp_length, tp.bs_log2_base)
    jkey = jtgsw.prepare_bootstrap_key_device(bk_coeff, exact=exact)
    tkey = ttgsw.prepare_bootstrap_key_device(bk_coeff, "cpu", exact=exact)
    assert np.array_equal(tkey.numpy(), np.asarray(jkey))
    oracle = (tgsw_ref.tgsw_external_mul if exact
              else tgsw_ref.tgsw_external_mul_rounded)
    before = k4.launches
    for row in range(2):
        want = np.asarray(jtgsw.tgsw_transformed_external_mul(
            jnp.asarray(accum), jkey, row, *args))
        assert np.array_equal(want, oracle(accum, bk_coeff, row, tp))
        got = ttgsw.tgsw_transformed_external_mul(
            torch.from_numpy(accum), tkey, row, *args)
        assert np.array_equal(got.numpy(), want)
    assert k4.launches == before


def test_negacyclic_mul_device_batched():
    rng = np.random.RandomState(6)
    small = rng.randint(-512, 512, (3, 4, N)).astype(np.int32)
    b = rng.randint(-2**31, 2**31, (3, 4, N)).astype(np.int32)
    want = np.asarray(jtf.negacyclic_mul_device(jnp.asarray(small), b))
    got = ttf.negacyclic_mul_device(torch.from_numpy(small), b)
    assert got.shape == (3, 4, N) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    flat_s, flat_b = small.reshape(-1, N), b.reshape(-1, N)
    assert np.array_equal(got.numpy().reshape(-1, N)[5],
                          tr.schoolbook_negacyclic(flat_s[5], flat_b[5]))
    # the key side may also be a tensor
    assert torch.equal(ttf.negacyclic_mul_device(torch.from_numpy(small[0]),
                                                 torch.from_numpy(b[0])),
                       got[0])


def test_polynomial_transform_facade_matches_jax():
    rng = np.random.RandomState(7)
    a = rng.randint(-2**31, 2**31, (3, N)).astype(np.int32)
    b = rng.randint(-2**31, 2**31, (3, N)).astype(np.int32)
    t = torch.from_numpy

    got = tpt.forward_device(t(a))
    assert got.shape == (3, 64, 32) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jpt.forward_device(jnp.asarray(a))))
    assert np.array_equal(ttf.forward_i32(t(a)).numpy(),
                          np.asarray(jtf.forward_i32(jnp.asarray(a))))
    x, y = a[:, :64].reshape(3, 2, 32), b[:, :64].reshape(3, 2, 32)
    assert np.array_equal(
        tpt.transformed_add_device(t(x), t(y)).numpy(),
        np.asarray(jpt.transformed_add_device(jnp.asarray(x), jnp.asarray(y))))
    small = rng.randint(-512, 512, (2, N)).astype(np.int32)
    # the JAX function under it is held against the port in
    # test_negacyclic_mul_device_batched; here the oracle
    prod = tpt.transformed_mul_device(t(small), b[:2]).numpy()
    for i in range(2):
        assert np.array_equal(prod[i], tr.schoolbook_negacyclic(small[i], b[i]))

    for name in ("NTT", "FFT", "N32"):
        mine, theirs = tpt.get_transform(name), jpt.get_transform(name)
        assert mine.name == theirs.name == name
        assert mine.transformed_dtype() == theirs.transformed_dtype()
        assert mine.transformed_length(N) == theirs.transformed_length(N)
        assert tpt.transform_supported(name) and jpt.transform_supported(name)
    assert not tpt.transform_supported("DCT")
    with pytest.raises(ValueError):
        tpt.get_transform("DCT")
    n32 = tpt.get_transform("N32")
    assert np.array_equal(
        n32.inverse_transform_ref(n32.transformed_space_mul_ref(
            n32.forward_transform_ref(small[0]), n32.forward_transform_ref(b[0]))),
        tr.schoolbook_negacyclic(small[0], b[0]))


def test_reference_transform_copies_match_jax():
    """The port's numpy copies of the Goldilocks NTT and complex FFT
    oracles, through the facade."""
    rng = np.random.RandomState(8)
    a = rng.randint(-2**31, 2**31, (2, 64)).astype(np.int32)
    b = rng.randint(-2**31, 2**31, (2, 64)).astype(np.int32)
    fa, fb = tntt.forward_transform(a), tntt.forward_transform(b)
    assert np.array_equal(fa, jntt.forward_transform(a))
    ntt = tpt.get_transform("NTT")
    prod = ntt.transformed_space_mul_prepared_ref(ntt.prepare_for_mul_ref(fa),
                                                  fb)
    assert np.array_equal(prod, ntt.transformed_space_mul_ref(fa, fb))
    assert np.array_equal(ntt.inverse_transform_ref(prod),
                          jntt.inverse_transform(jntt.transformed_space_mul(
                              fa, fb)))
    assert np.array_equal(ntt.transformed_space_add_ref(fa, fb),
                          jntt.transformed_space_add(fa, fb))
    small = rng.randint(-512, 512, (2, 64)).astype(np.int32)
    fft = tpt.get_transform("FFT")
    got = fft.inverse_transform_ref(fft.transformed_space_mul_ref(
        fft.forward_transform_ref(small), fft.forward_transform_ref(b)))
    want = jfft.inverse_transform(jfft.transformed_space_mul(
        jfft.forward_transform(small), jfft.forward_transform(b)))
    assert np.array_equal(got, want)
    assert np.array_equal(tfft.forward_transform(small),
                          jfft.forward_transform(small))
