"""The benchmark's own keys and ciphertexts, made on the device from the seed.

Both sides get the same: the program a cloud key built from these raw
arrays (``nufhe_tpu_torch.cloud_key_from_arrays``) and ciphertexts holding
these tensors, the reference the raw arrays themselves.  Every draw comes
from one ``torch.Generator`` on the device, in a few large calls, so one
seed gives the same keys and inputs on any card.
"""

import math

import torch

from ..reference.tfhe import MU, wrap32

NOISE_COEFF = math.sqrt(2 / math.pi)


def generator(seed, device, stream):
    """A generator on ``device`` for one purpose (``stream``) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % 2**63)
    return g


def _uniform32(g, shape):
    return torch.randint(-2**31, 2**31, shape, generator=g, device=g.device,
                         dtype=torch.int64)


def _gaussian32(g, shape, stdev):
    x = torch.randn(shape, generator=g, device=g.device, dtype=torch.float64)
    return wrap32(torch.round(x * stdev * 2.0**32).long())


def _negacyclic_matrix(z):
    """(N, N) float64 with a @ Z = a * z mod (X^N + 1) for a (.., N) row."""
    n = z.shape[-1]
    j = torch.arange(n, device=z.device).view(n, 1)
    k = torch.arange(n, device=z.device).view(1, n)
    zz = z[(k - j) % n].double()
    return torch.where(k >= j, zz, -zz)


class Secret:
    """The secret keys: the LWE key s (n,) and the TLWE key z (k, N)."""

    def __init__(self, cfg, g):
        self.cfg = cfg
        self.s = torch.randint(0, 2, (cfg['lwe_size'],), generator=g,
                               device=g.device, dtype=torch.int64)
        self.z = torch.randint(0, 2, (cfg['tlwe_mask_size'],
                                      cfg['tlwe_polynomial_degree']),
                               generator=g, device=g.device,
                               dtype=torch.int64)


def make_raw_cloud_key(cfg, secret, g):
    """The raw cloud key: the bootstrap key (n, k+1, l, k+1, N) int32 in
    the coefficient domain (TGSW encryptions of s_i under z) and the
    keyswitch tables (kN, t, base, n) / (kN, t, base) int32 from z to s,
    digit 0 the zero encryption.  Returns a dict of tensors on g's device
    and the float32 variances as Python numbers."""
    n, n_poly = cfg['lwe_size'], cfg['tlwe_polynomial_degree']
    k, l, lb = cfg['tlwe_mask_size'], cfg['bs_decomp_length'], \
        cfg['bs_log2_base']
    bs_stdev = cfg['bootstrap_noise_stdev']
    rows = n * (k + 1) * l
    mask = _uniform32(g, (rows, k, n_poly))
    body = _gaussian32(g, (rows, n_poly), bs_stdev)
    for m in range(k):
        body = body + torch.matmul(mask[:, m].double(),
                                   _negacyclic_matrix(secret.z[m])).long()
    bk = torch.cat([mask, wrap32(body)[:, None]], 1).view(n, k + 1, l, k + 1,
                                                           n_poly)
    powers = torch.tensor([2**(32 - (d + 1) * lb) for d in range(l)],
                          device=g.device)
    for m in range(k + 1):
        bk[:, m, :, m, 0] += secret.s[:, None] * powers
    bk = wrap32(bk)

    t, klb = cfg['ks_decomp_length'], cfg['ks_log2_base']
    base = 1 << klb
    in_key = secret.z.reshape(-1)
    ks_stdev = cfg['lwe_noise_stdev']
    ks_a = _uniform32(g, (in_key.shape[0], t, base, n))
    ks_a[:, :, 0] = 0
    js = torch.arange(1, t + 1, device=g.device).view(1, t, 1)
    vs = torch.arange(base, device=g.device).view(1, 1, base)
    message = in_key.view(-1, 1, 1) * vs * (1 << (32 - js * klb))
    ks_b = message + (ks_a * secret.s).sum(-1) \
        + _gaussian32(g, ks_a.shape[:-1], ks_stdev)
    ks_b[:, :, 0] = 0
    return {'bk_coeff': bk.to(torch.int32),
            'ks_a': ks_a.to(torch.int32),
            'ks_b': wrap32(ks_b).to(torch.int32),
            'bk_var': bs_stdev**2, 'ks_var': ks_stdev**2}


def encrypt(secret, bits, g):
    """LWE encryptions of ``bits`` (a bool tensor on g's device) under s:
    int64 (a (.., n), b (..,)) holding Torus32 values."""
    cfg = secret.cfg
    a = _uniform32(g, tuple(bits.shape) + (cfg['lwe_size'],))
    mu = torch.where(bits, MU, -MU)
    b = wrap32(mu + _gaussian32(g, bits.shape, cfg['lwe_noise_stdev'])
               + (a * secret.s).sum(-1))
    return a, b


def decrypt(secret, a, b):
    """The bits of LWE samples: the sign of b - a.s."""
    return wrap32(b.long() - (a.long() * secret.s).sum(-1)) > 0
