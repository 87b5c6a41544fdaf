"""The exact Nussbaumer transform in PyTorch, and the bootstrap key in the
form the CMUX step reads, for the exact ('NTT') and the rounded-key
('FFT') engine.

The CMUX step (``ops/cmux.py``) multiplies in the transform domain against
the bootstrap key.  The key is transformed once, on the host, with the numpy
oracle (``ref/transform_ref.forward``), and each residue is kept mod 2^38:
only bits 6..37 of the unscaled inverse survive the final ``>> 6`` and mod
2^32, and every stage is a ring operation, so a multiple of 2^38 in an
operand changes nothing.  Centred residues (|v| <= 2^37) keep each 64-bit
product and each 128-term sum free of wraparound.
"""

import numpy as np
import torch

from ..ref import transform_ref as tr

N, M, R, L, LOG_L, INV_SHIFT = tr.N, tr.M, tr.R, tr.L, tr.LOG_L, tr.INV_SHIFT
KEY_BITS = 38


def centred_residues(v_u64):
    """u64 residues -> int64 values mod 2^KEY_BITS in (-2^37, 2^37]."""
    r = (np.asarray(v_u64, np.uint64) & np.uint64(2**KEY_BITS - 1)).astype(np.int64)
    return np.where(r > 2**(KEY_BITS - 1), r - 2**KEY_BITS, r)


def bootstrap_key_transformed(bk_coeff, device, transform_type='NTT'):
    """Transform every key polynomial of a coefficient-domain bootstrap key.

    ``'NTT'`` (exact engine): one side, the residues themselves.

    ``'FFT'`` (rounded-key engine): two sides, side 0 = 64 * round(+v/64)
    and side 1 = 64 * round(-v/64) of each residue v mod 2^38, each rounded
    on its own (``ref/transform_ref.rounded_key_sides``) and centred.  The
    MAC uses side 1, not negated, on the terms that wrap around the
    negacyclic convolution, and side 0 on the rest.  Since
    (64 X mod 2^38) >> 6 = X mod 2^32, the CMUX step's inverse and final
    ``>> 6`` then give the rounded engine's result unchanged.

    :param bk_coeff: (n, mask1, l, mask1, N) int32 numpy array.
    :returns: (n, G = mask1*l, O = mask1, L, R) int64 tensor on ``device``
        ('NTT'), or (n, 2, G, O, L, R) with the side second ('FFT');
        g = o_in * l + d, matching ``ops/cmux`` and the kernels.
    """
    if transform_type not in ('NTT', 'FFT'):
        raise ValueError("transform_type must be 'NTT' or 'FFT', got %r"
                         % (transform_type,))
    bk_coeff = np.asarray(bk_coeff)
    n, mask1, l, mask1b, n_poly = bk_coeff.shape
    if mask1b != mask1 or n_poly != N:
        raise ValueError("unexpected bootstrap key shape %s" % (bk_coeff.shape,))
    hat = tr.forward(bk_coeff)                         # (n, mask1, l, mask1, L, R)
    if transform_type == 'NTT':
        key = centred_residues(hat).reshape(n, mask1 * l, mask1, L, R)
    else:
        sides = [centred_residues(q * np.uint64(64))
                 for q in tr.rounded_key_sides(hat)]
        key = np.stack(sides, axis=1).reshape(n, 2, mask1 * l, mask1, L, R)
    return torch.from_numpy(np.ascontiguousarray(key)).to(device)


# --- the transform on tensors (the CMUX step's plain version) ---

def _stage_tables(inverse):
    """Per DIT stage: (i, j, source index, sign) for all 32 butterflies and
    32 coefficients, the twiddle Y^e applied as a signed rotation."""
    tables = []
    base = -1 if inverse else 1
    r = np.arange(R)
    for stage in range(LOG_L):
        mmax = 1 << stage
        pairs = np.arange(L // 2)
        m = pairs & (mmax - 1)
        i = ((pairs >> stage) << (stage + 1)) + m
        j = i + mmax
        tw = (base * m * (1 << (LOG_L - stage - 1))) % (2 * R)
        neg = tw >= R
        sh = tw % R
        src = r[None, :] - sh[:, None]
        sign = np.where(src < 0, -1, 1) * np.where(neg, -1, 1)[:, None]
        tables.append((torch.from_numpy(i), torch.from_numpy(j),
                       torch.from_numpy(src % R),
                       torch.from_numpy(sign.astype(np.int64))))
    return tables


_TABLES = {False: _stage_tables(False), True: _stage_tables(True)}
_REV = torch.from_numpy(tr.bit_reverse(LOG_L))


def dft_l(data, inverse):
    """L-point DIT over S' = Z[Y]/(Y^R + 1): (..., L, R) int64 -> same.
    Equal to ``ref/transform_ref._dft_l`` as long as no value overflows
    int64 (the callers keep them far below)."""
    dev = data.device
    data = data[..., _REV.to(dev), :]
    for i, j, src, sign in _TABLES[inverse]:
        i, j, src, sign = i.to(dev), j.to(dev), src.to(dev), sign.to(dev)
        xi = data[..., i, :]
        xj = data[..., j[:, None], src] * sign
        data = data.clone()
        data[..., i, :] = xi + xj
        data[..., j, :] = xi - xj
    return data


def forward(a):
    """(..., N) integer tensor -> (..., L, R) int64 transform."""
    a = a.to(torch.int64)
    blocks = a.reshape(a.shape[:-1] + (R, M)).transpose(-1, -2)   # [j, i]
    padded = torch.cat([blocks, torch.zeros_like(blocks)], dim=-2)
    return dft_l(padded, inverse=False)


def inverse_unscaled(chat):
    """(..., L, R) int64 -> (..., N) holding ``L * c`` (fold included)."""
    p = dft_l(chat, inverse=True)
    hi = p[..., M:, :]
    y_hi = torch.cat([-hi[..., R - 1:], hi[..., :R - 1]], dim=-1)   # Y * P
    folded = p[..., :M, :] + y_hi
    return folded.transpose(-1, -2).reshape(chat.shape[:-2] + (N,))
