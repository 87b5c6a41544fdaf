"""Host keyswitch-key generation (the keygen part of
``nufhe_tpu/ref/lwe_ref.py``, formulas of ``nufhe/lwe_cpu.py``).
All torus arithmetic is int32 with natural wraparound.
"""

import numpy as np

from ..numeric import Torus32, ErrorFloat


def vec_mul_mat(a, b):
    """Reference: ``nufhe/lwe_cpu.py:23-24``."""
    return (a * b).sum(-1, dtype=Torus32)


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
