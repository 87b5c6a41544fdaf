"""Numpy oracle for the TLWE layer (``nufhe/tlwe_cpu.py`` formulas; mirror
of ``nufhe_tpu/ref/tlwe_ref.py``): trivial samples, sample extraction and
the encryption of zero that host keygen uses."""

import numpy as np

from ..numeric import Torus32, ErrorFloat
from . import transform_ref


def tlwe_noiseless_trivial(mu, mask_size: int):
    """(0, ..., 0, mu) samples.  Reference: ``nufhe/tlwe_cpu.py:26-38``.

    :param mu: (..., N) torus polynomials.
    :returns: a: (..., mask_size+1, N).
    """
    mu = np.asarray(mu, Torus32)
    shape = mu.shape[:-1]
    n = mu.shape[-1]
    a = np.zeros(shape + (mask_size + 1, n), Torus32)
    a[..., mask_size, :] = mu
    cv = np.zeros(shape, ErrorFloat)
    return a, cv


def tlwe_extract_lwe_samples(tlwe_a):
    """Extract LWE samples from TLWE samples.

    a_out[..., k*N + j] = tlwe_a[..., k, 0] for j = 0 else -tlwe_a[..., k, N-j];
    b_out = const coeff of the body polynomial.
    Reference: ``nufhe/tlwe_cpu.py:41-60``.
    """
    tlwe_a = np.asarray(tlwe_a)
    mask_size = tlwe_a.shape[-2] - 1
    n = tlwe_a.shape[-1]
    mask = tlwe_a[..., :mask_size, :]
    a = np.concatenate([mask[..., :1], -mask[..., :0:-1]], axis=-1)
    a = a.reshape(tlwe_a.shape[:-2] + (mask_size * n,)).astype(Torus32)
    b = tlwe_a[..., mask_size, 0].copy()
    return a, b


def tlwe_encrypt_zero(key, noises1, noises2, noise: float):
    """Homogeneous TLWE sample: b = noise2 + sum_i key_i * mask_noise_i.

    :param key: (mask_size, N) binary int32 polynomials.
    :param noises1: (..., mask_size, N) uniform torus (the mask).
    :param noises2: (..., N) gaussian torus (body noise).
    Reference: ``nufhe/tlwe_cpu.py:64-89`` (the negacyclic products are
    computed by the exact engine instead of the Goldilocks NTT refs).
    """
    noises1 = np.asarray(noises1, Torus32)
    noises2 = np.asarray(noises2, Torus32)
    mask_size, n = key.shape

    prods = transform_ref.negacyclic_mul(
        np.asarray(key, np.int32), noises1)      # (..., mask_size, N)
    body = (noises2 + prods.sum(-2, dtype=Torus32)).astype(Torus32)

    a = np.concatenate([noises1, body[..., None, :]], axis=-2)
    cv = np.full(noises2.shape[:-1], noise**2, ErrorFloat)
    return a, cv
