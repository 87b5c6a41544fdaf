"""Numpy oracle for the LWE layer (mirror of ``nufhe_tpu/ref/lwe_ref.py``,
formulas of ``nufhe/lwe_cpu.py``): host keyswitch-key generation, and the
exact-equality oracle of the port's LWE ops and keyswitch.
All torus arithmetic is int32 with natural wraparound.
"""

import numpy as np

from ..numeric import Torus32, ErrorFloat


def vec_mul_mat(a, b):
    """Reference: ``nufhe/lwe_cpu.py:23-24``."""
    return (a * b).sum(-1, dtype=Torus32)


def lwe_encrypt(messages, key, noises_a, noises_b, noise: float):
    """(a, b, cv) for LWE encryptions of ``messages``.

    Reference: ``nufhe/lwe_cpu.py:96-104``: b = message + noise_b + a.s.
    """
    a = np.asarray(noises_a, Torus32)
    b = (np.asarray(noises_b, Torus32) + np.asarray(messages, Torus32)
         + vec_mul_mat(a, key)).astype(Torus32)
    cv = np.full(b.shape, noise**2, ErrorFloat)
    return a, b, cv


def lwe_decrypt_phase(a, b, key):
    """Raw phase b - a.s.  Reference: ``nufhe/lwe_cpu.py:107-112``."""
    return (b - vec_mul_mat(a, key)).astype(Torus32)


def lwe_linear(source_a, source_b, source_cv, p, add_to=None):
    """result (+)= p * source.  Reference: ``nufhe/lwe_cpu.py:115-123``."""
    p = Torus32(p)
    ra = (p * source_a).astype(Torus32)
    rb = (p * source_b).astype(Torus32)
    rcv = (np.float64(p)**2 * source_cv).astype(ErrorFloat)
    if add_to is not None:
        aa, ab, acv = add_to
        ra = (aa + ra).astype(Torus32)
        rb = (ab + rb).astype(Torus32)
        rcv = (acv + rcv).astype(ErrorFloat)
    return ra, rb, rcv


def lwe_noiseless_trivial(mus, lwe_size):
    """(0, mu) samples.  Reference: ``nufhe/lwe_cpu.py:126-133``."""
    mus = np.asarray(mus, Torus32)
    a = np.zeros(mus.shape + (lwe_size,), Torus32)
    cv = np.zeros(mus.shape, ErrorFloat)
    return a, mus.copy(), cv


def make_keyswitch_key(in_key, out_key, noises_a, noises_b,
                       decomp_length: int, log2_base: int, noise: float):
    """Build the keyswitch key: encryptions of ``s'_i * h * 2^(32-(j+1)*base)``.

    Returns (ks_a, ks_b, ks_cv) of shapes
    (input_size, decomp_length, base, output_size), (.., base), (.., base).
    Reference: ``nufhe/lwe_cpu.py:27-59``.
    """
    input_size = in_key.shape[0]
    output_size = out_key.shape[0]
    base = 2**log2_base

    ks_a = np.zeros((input_size, decomp_length, base, output_size), Torus32)
    ks_b = np.zeros((input_size, decomp_length, base), Torus32)
    ks_cv = np.zeros((input_size, decomp_length, base), ErrorFloat)

    hs = np.arange(1, base).astype(np.int64)
    js = np.arange(decomp_length).astype(np.int64)
    # messages[i, j, h-1] = key_i * h * 2^(32 - (j+1)*log2_base), mod 2^32
    powers = np.int64(1) << (32 - (js[None, :, None] + 1) * log2_base)
    messages64 = in_key[:, None, None].astype(np.int64) * hs[None, None, :] * powers
    messages = (messages64 & 0xFFFFFFFF).astype(np.uint32).view(Torus32)

    # base slice h=0 stays the trivial encryption of zero
    ks_a[:, :, 1:, :] = noises_a
    ks_b[:, :, 1:] = (messages + np.asarray(noises_b, Torus32)
                      + vec_mul_mat(noises_a, out_key)).astype(Torus32)
    ks_cv[:, :, 1:] = noise**2
    return ks_a, ks_b, ks_cv


def keyswitch_digits(source_a, decomp_length: int, log2_base: int):
    """Keyswitch decomposition digits.

    aijs[..., l, j] = ((a_l + prec_offset) >> (32 - (j+1)*log2_base)) & mask
    Reference: ``nufhe/lwe_cpu.py:68-74`` (arithmetic shift on int32).
    """
    base = 2**log2_base
    prec_offset = Torus32(2**(32 - (1 + log2_base * decomp_length)))
    mask = Torus32(base - 1)
    js = np.arange(1, decomp_length + 1).reshape((1,) * source_a.ndim + (-1,))
    shifted = (source_a[..., None] + prec_offset).astype(Torus32)
    return ((shifted >> (32 - js * log2_base)) & mask).astype(np.int32)


def lwe_keyswitch(ks_a, ks_b, ks_cv, source_a, source_b,
                  decomp_length: int, log2_base: int):
    """Keyswitch: result = (0, b) - sum_{l,j} ks[l, j, digit_{l,j}].

    Reference: ``nufhe/lwe_cpu.py:62-93``.
    """
    input_size = ks_a.shape[0]
    output_size = ks_a.shape[-1]
    digits = keyswitch_digits(source_a, decomp_length, log2_base)

    result_a = np.zeros(source_b.shape + (output_size,), Torus32)
    result_b = source_b.copy().astype(Torus32)
    result_cv = np.zeros(source_b.shape, ErrorFloat)

    for l in range(input_size):
        for j in range(decomp_length):
            x = digits[..., l, j]
            result_a = (result_a - ks_a[l, j, x]).astype(Torus32)
            result_b = (result_b - ks_b[l, j, x]).astype(Torus32)
            result_cv = (result_cv + ks_cv[l, j, x]).astype(ErrorFloat)
    return result_a, result_b, result_cv
