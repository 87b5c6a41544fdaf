"""Numpy oracle for negacyclic monomial shifts of torus polynomials
(mirror of ``nufhe_tpu/ref/polynomials_ref.py``).

Reference semantics: ``nufhe/polynomials_cpu.py:25-59`` —
  shift(source, power)[j] = (X^power * source)[j]  in Z[X]/(X^N + 1),
with options ``invert_powers`` (use 2N - power) and ``minus_one``
(result = (X^power - 1) * source).
"""

import numpy as np

from ..numeric import Torus32


def shift_polynomial(source, powers, invert_powers=False, minus_one=False):
    """Negacyclic monomial multiplication, batched.

    :param source: (batch..., poly_batch..., N) int32.
    :param powers: (batch...,) integers in [0, 2N).
    :param invert_powers: use 2N - power instead of power.
    :param minus_one: multiply by (X^p - 1) instead of X^p.
    """
    source = np.asarray(source)
    powers = np.asarray(powers)
    n = source.shape[-1]
    batch_ndim = powers.ndim
    p = powers.astype(np.int64) % (2 * n)
    if invert_powers:
        p = (2 * n - p) % (2 * n)

    # X^p * source: out[j] = sign * source[(j - p) mod_neg 2N]
    j = np.arange(n)
    p_exp = p.reshape(p.shape + (1,) * (source.ndim - batch_ndim))
    src_idx = (j - p_exp) % (2 * n)
    sign = np.where(src_idx >= n, Torus32(-1), Torus32(1))
    src_idx = src_idx % n
    out = (np.take_along_axis(
        source, np.broadcast_to(src_idx, source.shape), axis=-1) * sign
        ).astype(Torus32)
    if minus_one:
        out = (out - source).astype(Torus32)
    return out
