"""Numpy oracle for the TGSW layer (``nufhe/tgsw_cpu.py`` formulas).

Mirror of ``nufhe_tpu/ref/tgsw_ref.py``: the exact and the rounded-key
external products.
"""

import numpy as np

from ..numeric import Torus32
from . import transform_ref


def tgsw_polynomial_decomp(sample, params):
    """Gadget decomposition of torus polynomials into signed digits.

    result[..., mask, j, :] = (((sample + offset) >> (32 - (j+1)*log2_base))
                               & (base-1)) - base/2
    Reference: ``nufhe/tgsw_cpu.py:26-49``.

    :param sample: (..., mask_size+1, N) Torus32.
    :returns: (..., mask_size+1, decomp_length, N) int32 in [-base/2, base/2).
    """
    sample = np.asarray(sample, Torus32)
    l = params.decomp_length
    log2_base = params.bs_log2_base
    base = 2**log2_base
    ps = np.arange(1, l + 1).reshape((1,) * (sample.ndim - 1) + (l, 1))
    shifted = (sample[..., None, :] + params.offset).astype(Torus32)
    return ((((shifted >> (32 - ps * log2_base)) & Torus32(base - 1))
             - Torus32(base // 2)).astype(np.int32))


def tgsw_external_mul(accum, bk_coeff, bk_row_idx, params):
    """External product in the coefficient domain:
    accum <- decomp(accum) . BK_row  (exact negacyclic products mod 2^32).

    :param accum: (..., mask_size+1, N) Torus32.
    :param bk_coeff: (rows, mask_size+1, decomp_length, mask_size+1, N)
        Torus32 — the *coefficient-domain* bootstrap key row matrix
        (TGSW sample: for each (mask_in, decomp) a TLWE sample of length
        mask_size+1).
    Reference semantics: ``nufhe/tgsw_cpu.py:82-106``.
    """
    mask1 = accum.shape[-2]
    decomp = tgsw_polynomial_decomp(accum, params)  # (..., mask1, l, N)
    row = bk_coeff[bk_row_idx]                      # (mask1, l, mask1, N)

    out = np.zeros_like(np.asarray(accum))
    for out_idx in range(mask1):
        terms_a = []
        terms_b = []
        for in_idx in range(mask1):
            for d in range(params.decomp_length):
                terms_a.append(decomp[..., in_idx, d, :])
                terms_b.append(row[in_idx, d, out_idx])
        out[..., out_idx, :] = transform_ref.negacyclic_mul_accum(terms_a, terms_b)
    return out.astype(Torus32)


def tgsw_external_mul_rounded(accum, bk_coeff, bk_row_idx, params):
    """Rounded-key ('FFT' mode) external product: the digit transforms in
    u64 wraparound, each product against the two-sided rounded key
    (``transform_ref.rounded_key_sides``), and the unscaled inverse taken
    mod 2^32 directly (no ``>> 6``: the key sides are already divided by
    64).  Deterministic and exact given the rounding."""
    mask1 = accum.shape[-2]
    decomp = tgsw_polynomial_decomp(accum, params)  # (..., mask1, l, N)
    row = bk_coeff[bk_row_idx]                      # (mask1, l, mask1, N)

    out = np.zeros_like(np.asarray(accum))
    for out_idx in range(mask1):
        acc_hat = None
        for in_idx in range(mask1):
            for d in range(params.decomp_length):
                dh = transform_ref.forward(decomp[..., in_idx, d, :])
                vh = transform_ref.forward(row[in_idx, d, out_idx])
                vpos, vneg = transform_ref.rounded_key_sides(vh)
                term = transform_ref.smul_sided(dh, vpos, vneg)
                acc_hat = term if acc_hat is None else acc_hat + term
        out[..., out_idx, :] = transform_ref.u64_to_i32(
            transform_ref.inverse_unscaled(acc_hat))
    return out.astype(Torus32)


def tgsw_add_message(samples_a, messages, params):
    """result += message * H (gadget matrix on the diagonal).

    :param samples_a: (batch..., mask_size+1, decomp_length, mask_size+1, N).
    Reference: ``nufhe/tgsw_cpu.py:109-126``.
    """
    samples_a = np.asarray(samples_a, Torus32).copy()
    messages = np.asarray(messages, np.int64)
    mask1 = samples_a.shape[-2]
    inc = (messages[..., None] * params.base_powers.astype(np.int64))
    inc = (inc & 0xFFFFFFFF).astype(np.uint32).view(Torus32)
    for mask_idx in range(mask1):
        samples_a[..., mask_idx, :, mask_idx, 0] = (
            samples_a[..., mask_idx, :, mask_idx, 0] + inc).astype(Torus32)
    return samples_a
