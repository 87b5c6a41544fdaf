"""Numpy oracle for the full bootstrap (``nufhe/bootstrap.py`` semantics;
mirror of ``nufhe_tpu/ref/bootstrap_ref.py``, both engine modes).

The golden host path: modulus switch, test-vector rotation, the n-step blind
rotation via exact external products, sample extraction, keyswitch.  The
port's bootstrap (every engine, on the card and on the CPU) is held bit for
bit against this module.
"""

import numpy as np

from ..numeric import Torus32, t32_to_phase_ref
from . import lwe_ref, polynomials_ref, tgsw_ref, tlwe_ref


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


def bootstrap(lwe_a, lwe_b, bk_coeff, ks, mu, params, ks_params,
              no_keyswitch=False, exact=True, coarse_phase_bits=0):
    """result = LWE(mu) if phase(x) > 0 else LWE(-mu), rebuilt from scratch.

    Reference: ``nufhe/bootstrap.py:154-229``.

    :param lwe_a: (batch..., n) Torus32; ``lwe_b``: (batch...,).
    :param bk_coeff: coefficient-domain bootstrap key.
    :param ks: (ks_a, ks_b, ks_cv) keyswitch key arrays or None.
    :param ks_params: (decomp_length, log2_base) for the keyswitch.
    :returns: (a, b, cv) in the in_out space (or extracted space).
    """
    tlwe_params = params.tlwe_params
    n_poly = tlwe_params.polynomial_degree
    mask_size = tlwe_params.mask_size

    barb = t32_to_phase_ref(lwe_b, 2 * n_poly)
    bara = t32_to_phase_ref(lwe_a, 2 * n_poly)
    if coarse_phase_bits:
        bara = round_phase_coarse_ref(bara, coarse_phase_bits, n_poly)

    # testvector = X^{2N - barb} * (mu, mu, ..., mu)
    testvect = np.full(lwe_b.shape + (n_poly,), Torus32(mu), Torus32)
    testvectbis = polynomials_ref.shift_polynomial(
        testvect, barb, invert_powers=True)

    accum, _ = tlwe_ref.tlwe_noiseless_trivial(testvectbis, mask_size)
    accum = blind_rotate(accum, bk_coeff, bara, params, exact=exact)

    ex_a, ex_b = tlwe_ref.tlwe_extract_lwe_samples(accum)
    ex_cv = np.full(
        ex_b.shape,
        blind_rotate_variance(params, lwe_a.shape[-1], exact=exact,
                              coarse_phase_bits=coarse_phase_bits),
        np.float32)

    if no_keyswitch:
        return ex_a, ex_b, ex_cv

    ks_a, ks_b, ks_cv = ks
    decomp_length, log2_base = ks_params
    out_a, out_b, out_cv = lwe_ref.lwe_keyswitch(
        ks_a, ks_b, ks_cv, ex_a, ex_b, decomp_length, log2_base)
    return out_a, out_b, (out_cv + ex_cv).astype(np.float32)


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
