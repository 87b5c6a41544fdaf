"""The port's numpy oracles (``nufhe_tpu_torch/ref/``, ``numeric``) bit for
bit against the JAX package's on the same seeded inputs; the port's
bootstrap oracle at a reduced LWE size in every mode; the port's CPU
bootstrap (the plain versions of its kernels) against it, as
``tests/test_bootstrap.py`` holds the JAX package's device bootstrap; and
``ops/lwe.keyswitch_digits`` against the JAX function."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu import numeric as jnum
from nufhe_tpu.ops import lwe as jlwe
from nufhe_tpu.params import NuFHEParameters as JParams
from nufhe_tpu.ref import bootstrap_ref as jboot_ref
from nufhe_tpu.ref import lwe_ref as jlwe_ref
from nufhe_tpu.ref import tlwe_ref as jtlwe_ref

import nufhe_tpu_torch as nft
from nufhe_tpu_torch import numeric as tnum
from nufhe_tpu_torch.ops import bootstrap as tboot
from nufhe_tpu_torch.ops import lwe as tlwe
from nufhe_tpu_torch.ref import bootstrap_ref, lwe_ref, tlwe_ref
from nufhe_tpu_torch.utils import errors_allclose

LWE_SIZE = 16
B = 4


def _i32(rng, shape):
    return rng.randint(-2**31, 2**31, shape).astype(np.int32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_t32_to_phase_ref():
    x = _i32(np.random.RandomState(1), (64,))
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    for mspace in (8, 2048):
        _same(tnum.t32_to_phase_ref(x, mspace), jnum.t32_to_phase_ref(x, mspace))


def test_lwe_oracles():
    rng = np.random.RandomState(2)
    key = rng.randint(0, 2, 24).astype(np.int32)
    msgs, na, nb = _i32(rng, (3, 5)), _i32(rng, (3, 5, 24)), _i32(rng, (3, 5))
    want = jlwe_ref.lwe_encrypt(msgs, key, na, nb, 0.01)
    got = lwe_ref.lwe_encrypt(msgs, key, na, nb, 0.01)
    for g, w in zip(got, want):
        _same(g, w)
    a, b, cv = want
    _same(lwe_ref.lwe_decrypt_phase(a, b, key),
          jlwe_ref.lwe_decrypt_phase(a, b, key))
    for add_to in (None, (na, nb, cv)):
        for g, w in zip(lwe_ref.lwe_linear(a, b, cv, -3, add_to),
                        jlwe_ref.lwe_linear(a, b, cv, -3, add_to)):
            _same(g, w)
    for g, w in zip(lwe_ref.lwe_noiseless_trivial(msgs, 24),
                    jlwe_ref.lwe_noiseless_trivial(msgs, 24)):
        _same(g, w)


def test_keyswitch_oracles():
    rng = np.random.RandomState(3)
    inp, dl, l2b, out = 40, 8, 2, 12
    ks_a = _i32(rng, (inp, dl, 4, out))
    ks_b = _i32(rng, (inp, dl, 4))
    ks_cv = rng.uniform(0, 1e-9, (inp, dl, 4)).astype(np.float32)
    src_a, src_b = _i32(rng, (B, inp)), _i32(rng, (B,))
    _same(lwe_ref.keyswitch_digits(src_a, dl, l2b),
          jlwe_ref.keyswitch_digits(src_a, dl, l2b))
    for g, w in zip(
            lwe_ref.lwe_keyswitch(ks_a, ks_b, ks_cv, src_a, src_b, dl, l2b),
            jlwe_ref.lwe_keyswitch(ks_a, ks_b, ks_cv, src_a, src_b, dl, l2b)):
        _same(g, w)


@pytest.mark.parametrize("dl, l2b", [(8, 2), (5, 3)])
def test_ops_keyswitch_digits(dl, l2b):
    a = _i32(np.random.RandomState(4), (3, B, 30))
    got = tlwe.keyswitch_digits(torch.from_numpy(a), dl, l2b)
    want = np.asarray(jlwe.keyswitch_digits(jnp.asarray(a), dl, l2b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), lwe_ref.keyswitch_digits(a, dl, l2b))


def test_tlwe_oracles():
    rng = np.random.RandomState(5)
    mu = _i32(rng, (3, 2, 64))
    for mask_size in (1, 2):
        for g, w in zip(tlwe_ref.tlwe_noiseless_trivial(mu, mask_size),
                        jtlwe_ref.tlwe_noiseless_trivial(mu, mask_size)):
            _same(g, w)
        acc = _i32(rng, (3, mask_size + 1, 64))
        for g, w in zip(tlwe_ref.tlwe_extract_lwe_samples(acc),
                        jtlwe_ref.tlwe_extract_lwe_samples(acc)):
            _same(g, w)


@pytest.fixture(scope="module")
def keys():
    """A host-made key pair at a reduced LWE size (the polynomial and
    transform sizes stay full) and random bootstrap inputs."""
    torch.set_num_threads(1)
    rng = nft.DeterministicRNG(2024)
    secret, cloud = nft.make_key_pair(rng, on_device=False, lwe_size=LWE_SIZE)
    inputs = np.random.RandomState(6)
    lwe_a, lwe_b = _i32(inputs, (B, LWE_SIZE)), _i32(inputs, (B,))
    return cloud, lwe_a, lwe_b


MODES = {
    "exact": dict(exact=True),
    "rounded": dict(exact=False),
    "coarse": dict(coarse_phase_bits=2),
    "no_keyswitch": dict(no_keyswitch=True),
}


def _oracle_args(cloud, transform_type):
    ks = cloud.keyswitch_key
    params = cloud.params
    tp = nft.NuFHEParameters(lwe_size=LWE_SIZE,
                             transform_type=transform_type).tgsw_params
    return ((ks.ks_a, ks.ks_b, ks.ks_cv), tnum.phase_to_t32(1, 8), tp,
            (params.ks_decomp_length, params.ks_log2_base))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bootstrap_oracle_matches_jax(keys, mode):
    cloud, lwe_a, lwe_b = keys
    kw = MODES[mode]
    tmode = 'FFT' if kw.get("exact") is False else 'NTT'
    ks, mu, tp, ksp = _oracle_args(cloud, tmode)
    got = bootstrap_ref.bootstrap(lwe_a, lwe_b, cloud.bootstrap_key.bk_coeff,
                                  ks, mu, tp, ksp, **kw)
    jtp = JParams(lwe_size=LWE_SIZE, transform_type=tmode).tgsw_params
    want = jboot_ref.bootstrap(lwe_a, lwe_b, cloud.bootstrap_key.bk_coeff,
                               ks, mu, jtp, ksp, **kw)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cpu_bootstrap_matches_oracle(keys, mode):
    """``ops/bootstrap.bootstrap_device`` on CPU tensors (the rows engine's
    plain K1 and the plain K2) against the port's oracle: a and b bit for
    bit, cv within ``errors_allclose``."""
    cloud, lwe_a, lwe_b = keys
    kw = MODES[mode]
    tmode = 'FFT' if kw.get("exact") is False else 'NTT'
    ks, mu, tp, ksp = _oracle_args(cloud, tmode)
    want = bootstrap_ref.bootstrap(lwe_a, lwe_b, cloud.bootstrap_key.bk_coeff,
                                   ks, mu, tp, ksp, **kw)
    if tmode == 'FFT':
        cloud = nft.cloud_key_from_arrays(
            nft.NuFHEParameters(lwe_size=LWE_SIZE, transform_type='FFT'),
            cloud.bootstrap_key.bk_coeff, cloud.bootstrap_key.cv,
            *ks, cloud.keyswitch_key.log2_base)
    arrays, meta = cloud.keyswitch_key.device("cpu")
    got = tboot.bootstrap_device(
        torch.from_numpy(lwe_a), torch.from_numpy(lwe_b),
        cloud.bootstrap_key.device("cpu"), arrays, meta, int(mu), tp,
        no_keyswitch=kw.get("no_keyswitch", False),
        coarse_phase_bits=kw.get("coarse_phase_bits", 0))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert errors_allclose(got[2], want[2])
    if tmode == 'FFT':     # the rounding variance term is in the oracle's cv
        assert (bootstrap_ref.blind_rotate_variance(tp, LWE_SIZE, exact=False)
                > bootstrap_ref.blind_rotate_variance(tp, LWE_SIZE))
