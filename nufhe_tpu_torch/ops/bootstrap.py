"""Gate bootstrap in PyTorch: modulus switch, blind rotation, extraction,
keyswitch (``nufhe_tpu/ops/bootstrap.py``'s counterpart, exact engine,
one CMUX step per launch).
"""

import torch

from . import cmux
from . import lwe as dlwe
from . import tlwe as dtlwe
from ..ref.bootstrap_ref import blind_rotate_variance


def t32_to_phase(phase, mspace_size: int):
    """Modulus switch of int32 torus values to [0, mspace_size): the
    nearest multiple of 1/mspace_size, computed as uint32 in int64.
    Reference: ``nufhe/numeric_functions_gpu.py:39-77``."""
    interv = 2**32 // mspace_size
    half = interv // 2
    phase_u = phase.to(torch.int64) & 0xFFFFFFFF
    return (((phase_u + half) & 0xFFFFFFFF) // interv).to(torch.int32)


def blind_rotate(accum_a, bk_dev, bara, tgsw_params):
    """ACC <- BK_i (x) [(X^{bara_i}-1) ACC] + ACC over all n key bits, one
    K1 launch per step.

    :param accum_a: (B, mask_size+1, N) int32.
    :param bk_dev: (n, G, O, L, R) int64 transformed key
        (``ops/transform.bootstrap_key_transformed``).
    :param bara: (B, n) int32 in [0, 2N).
    """
    offset = int(tgsw_params.offset)
    log2_base = tgsw_params.bs_log2_base
    acc = accum_a.contiguous()
    bara_t = bara.t().contiguous()              # (n, B): one row per step
    for i in range(bara.shape[-1]):
        acc = cmux.cmux_step(acc, bara_t[i], bk_dev[i], offset=offset,
                             log2_base=log2_base)
    return acc


def bootstrap_device(lwe_a, lwe_b, bk_dev, ks_arrays, ks_meta, mu,
                     tgsw_params, no_keyswitch=False):
    """Full gate bootstrap: LWE(mu) if phase > 0 else LWE(-mu), fresh noise.
    Reference: ``nufhe/bootstrap.py:154-229``.

    :param lwe_a: (B, n_in) int32; ``lwe_b``: (B,) int32.
    :returns: (a, b, cv) in the keyswitched (or extracted) LWE space.
    """
    tlwe_params = tgsw_params.tlwe_params
    n_poly = tlwe_params.polynomial_degree
    mask_size = tlwe_params.mask_size

    barb = t32_to_phase(lwe_b, 2 * n_poly)
    bara = t32_to_phase(lwe_a, 2 * n_poly)

    # testvector = X^{2N - barb} * (mu, ..., mu): for a constant vector the
    # shift is a sign pattern, +mu iff (k + barb) mod 2N < N
    k = torch.arange(n_poly, device=lwe_b.device)
    pos = (k + barb[..., None].to(torch.int64)) & (2 * n_poly - 1)
    mu_t = torch.tensor(int(mu), dtype=torch.int32, device=lwe_b.device)
    testvect = torch.where(pos < n_poly, mu_t, -mu_t)

    accum, _ = dtlwe.tlwe_noiseless_trivial(testvect, mask_size)
    accum = blind_rotate(accum, bk_dev, bara, tgsw_params)
    ex_a, ex_b = dtlwe.tlwe_extract_lwe_samples(accum)

    # fresh-noise estimate through the blind rotation (CGGI16 bound)
    var_br = blind_rotate_variance(tgsw_params, lwe_a.shape[-1])
    ex_cv = torch.full(ex_b.shape, var_br, dtype=torch.float32,
                       device=ex_b.device)
    if no_keyswitch:
        return ex_a, ex_b, ex_cv
    return dlwe.lwe_keyswitch(ks_arrays, ks_meta, ex_a, ex_b, source_cv=ex_cv)
