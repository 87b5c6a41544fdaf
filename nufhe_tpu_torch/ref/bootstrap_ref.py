"""Bootstrap noise bookkeeping (the exact-mode part of
``nufhe_tpu/ref/bootstrap_ref.py``)."""


def blind_rotate_variance(params, n_steps: int) -> float:
    """Fresh-noise variance estimate through the n-step blind rotation
    (CGGI16 bound; sample extraction preserves variance):

        n * ( (k+1) * l * N * (B/2)^2 * Var(bk)
              + (k*N + 1) * 2^(-2*l*log2B) / 4 )

    The reference leaves the bootstrap output variances unfilled (TODO at
    ``nufhe/blind_rotate.py:254``); this estimate makes ``cv`` a usable
    noise-budget signal through gates.  Only the exact ('NTT') engine is
    ported, so the rounded-key terms are absent.
    """
    tlwe_params = params.tlwe_params
    k = tlwe_params.mask_size
    n_poly = tlwe_params.polynomial_degree
    l = params.decomp_length
    log2b = params.bs_log2_base
    bk_var = float(tlwe_params.min_noise) ** 2
    return n_steps * (
        (k + 1) * l * n_poly * (2 ** (log2b - 1)) ** 2 * bk_var
        + (k * n_poly + 1) * 2.0 ** (-2 * l * log2b) / 4)
