"""TLWE operations in PyTorch (``nufhe_tpu/ops/tlwe.py``'s counterpart)."""

import torch

from ..numeric import wrap_i32


def tlwe_noiseless_trivial(mu, mask_size: int):
    """(0,...,0, mu).  Reference: ``nufhe/tlwe_gpu.py:32-74``.

    :param mu: (batch..., N) int32.
    :returns: a: (batch..., mask_size+1, N) int32, cv: (batch...,) float32.
    """
    mu = mu.to(torch.int32)
    shape = mu.shape[:-1]
    zeros = torch.zeros(shape + (mask_size, mu.shape[-1]), dtype=torch.int32,
                        device=mu.device)
    a = torch.cat([zeros, mu[..., None, :]], dim=-2)
    cv = torch.zeros(shape, dtype=torch.float32, device=mu.device)
    return a, cv


def tlwe_extract_lwe_samples(tlwe_a):
    """LWE extraction with negacyclic coefficient reversal.

    a_out[k*N] = mask[k, 0]; a_out[k*N + j] = -mask[k, N-j] (j > 0);
    b_out = body[0].  Reference: ``nufhe/tlwe_gpu.py:77-108``.
    """
    mask_size = tlwe_a.shape[-2] - 1
    n = tlwe_a.shape[-1]
    mask = tlwe_a[..., :mask_size, :]
    # -x wraps for INT32_MIN exactly as the reference's int32 negation does
    rev = torch.flip(mask[..., 1:], dims=(-1,))
    a = torch.cat([mask[..., :1], -rev], dim=-1)
    a = a.reshape(tlwe_a.shape[:-2] + (mask_size * n,))
    b = tlwe_a[..., mask_size, 0]
    return a.contiguous(), b.contiguous()


def monomial_shift(source, powers, minus_one=False, invert_powers=False):
    """X^p * source (or (X^p - 1) * source) in Z[X]/(X^N + 1), mod 2^32,
    one power a batch element (``nufhe_tpu/ops/tlwe.py:34-67``, the
    reference's ``ShiftTorusPolynomial``, ``nufhe/polynomials_gpu.py:31-86``).

    :param source: (batch..., C..., N) int32 polynomials.
    :param powers: (batch...,) integers in [0, 2N).
    """
    n = source.shape[-1]
    p = powers.to(torch.int64) % (2 * n)
    if invert_powers:
        p = (2 * n - p) % (2 * n)
    p = p.reshape(tuple(p.shape) + (1,) * (source.dim() - p.dim()))
    src = (torch.arange(n, device=source.device) - p) % (2 * n)
    sign = torch.where(src >= n, -1, 1)
    idx = (src % n).expand(source.shape)
    out = torch.gather(source.to(torch.int64), -1, idx) * sign
    if minus_one:
        out = out - source.to(torch.int64)
    return wrap_i32(out)
