"""The exact Nussbaumer transform in PyTorch, and the bootstrap key in the
form the CMUX step reads.

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

    :param bk_coeff: (n, mask1, l, mask1, N) int32 numpy array.
    :returns: (n, G = mask1*l, O = mask1, L, R) int64 tensor on ``device``;
        g = o_in * l + d, matching ``ops/cmux`` and the kernel.
    """
    if transform_type != 'NTT':
        raise NotImplementedError(
            "only the exact ('NTT') engine is ported; transform_type=%r"
            % (transform_type,))
    bk_coeff = np.asarray(bk_coeff)
    n, mask1, l, mask1b, n_poly = bk_coeff.shape
    if mask1b != mask1 or n_poly != N:
        raise ValueError("unexpected bootstrap key shape %s" % (bk_coeff.shape,))
    hat = centred_residues(tr.forward(bk_coeff))       # (n, mask1, l, mask1, L, R)
    hat = hat.reshape(n, mask1 * l, mask1, L, R)
    return torch.from_numpy(np.ascontiguousarray(hat)).to(device)


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
