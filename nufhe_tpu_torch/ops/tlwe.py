"""TLWE operations in PyTorch (``nufhe_tpu/ops/tlwe.py``'s counterpart)."""

import torch


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
