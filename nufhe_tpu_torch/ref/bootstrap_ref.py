"""Numpy oracle for the blind rotation, the coarse modulus switch and the
bootstrap noise bookkeeping (mirror of ``nufhe_tpu/ref/bootstrap_ref.py``,
both engine modes)."""

import numpy as np

from ..numeric import Torus32
from . import polynomials_ref, tgsw_ref


def blind_rotate(accum_a, bk_coeff, bara, params, exact=True):
    """Multiply the accumulator by X^{sum bara_i s_i} via the CMUX ladder.

    ACC <- BK_i x [(X^{bara_i} - 1) ACC] + ACC, for each key bit i.
    Reference: ``nufhe/bootstrap.py:96-142``.

    :param accum_a: (batch..., mask_size+1, N) Torus32.
    :param bk_coeff: coefficient-domain bootstrap key
        (n, mask_size+1, decomp_length, mask_size+1, N).
    :param bara: (batch..., n) int32 in [0, 2N).
    :param exact: False = rounded-key ('FFT' mode) external products.
    """
    n = bk_coeff.shape[0]
    mul = (tgsw_ref.tgsw_external_mul if exact
           else tgsw_ref.tgsw_external_mul_rounded)
    accum = np.asarray(accum_a, Torus32).copy()
    for i in range(n):
        shifted = polynomials_ref.shift_polynomial(
            accum, bara[..., i], minus_one=True)
        prod = mul(shifted, bk_coeff, i, params)
        accum = (accum + prod).astype(Torus32)
    return accum


def round_phase_coarse_ref(bara, bits, n_poly):
    """Round [0, 2N) rotation amounts to multiples of 2^bits with the
    zero-mean tie rule (exact ties follow the next-higher phase bit),
    wrapping mod 2N."""
    if not bits:
        return bara
    bara = np.asarray(bara).astype(np.int32)
    step = np.int32(1 << bits)
    half = np.int32(step >> 1)
    rem = bara & np.int32(step - 1)
    up = (rem > half) | ((rem == half) & (((bara >> bits) & 1) == 1))
    out = bara - rem + np.where(up, step, np.int32(0))
    return (out & np.int32(2 * n_poly - 1)).astype(np.int32)


def blind_rotate_variance(params, n_steps: int, exact=True,
                          coarse_phase_bits: int = 0) -> float:
    """Fresh-noise variance estimate through the n-step blind rotation
    (CGGI16 bound; sample extraction preserves variance):

        n * ( (k+1) * l * N * (B/2)^2 * Var(bk)
              + (k*N + 1) * 2^(-2*l*log2B) / 4 )

    The reference leaves the bootstrap output variances unfilled (TODO at
    ``nufhe/blind_rotate.py:254``); this estimate makes ``cv`` a usable
    noise-budget signal through gates.

    ``exact=False`` adds the rounded-key ('FFT' mode) terms: per step, the
    key-spectrum rounding (an error uniform in [-32, 31] a slot) gives each
    external-product polynomial pair an output variance of
    N * (B^2/12) * (64^2/12) / 32 in Torus32 units; and a constant 6.5e-6,
    the JAX package's measured one-time coupling of the structured test
    vector with the fixed rounding pattern (4.3e-6) with 1.5x headroom.

    ``coarse_phase_bits`` adds the rotation-amount error of the coarse
    modulus switch (``round_phase_coarse_ref``): per step e*s with
    E[s^2] = 1/2 and the exact second moment of zero-mean rounding to
    multiples of 2^bits, E[e^2] = (h(h-1)(2h-1)/3 + h^2) / (2h) with
    h = 2^(bits-1); one rotation step is 1/(2N) of the torus.
    """
    tlwe_params = params.tlwe_params
    k = tlwe_params.mask_size
    n_poly = tlwe_params.polynomial_degree
    l = params.decomp_length
    log2b = params.bs_log2_base
    bk_var = float(tlwe_params.min_noise) ** 2
    var = n_steps * (
        (k + 1) * l * n_poly * (2 ** (log2b - 1)) ** 2 * bk_var
        + (k * n_poly + 1) * 2.0 ** (-2 * l * log2b) / 4)
    if not exact:
        base_sq = float(2 ** log2b) ** 2
        pair_var_abs = n_poly * (base_sq / 12.0) * (64.0 ** 2 / 12.0) / 32.0
        var += n_steps * (k + 1) * l * pair_var_abs / 2.0 ** 64
        var += 6.5e-6
    if coarse_phase_bits:
        h = 2 ** (coarse_phase_bits - 1)
        e_sq = (h * (h - 1) * (2 * h - 1) / 3.0 + h * h) / (2.0 * h)
        var += n_steps * (e_sq / 2.0) / float(2 * n_poly) ** 2
    return var
