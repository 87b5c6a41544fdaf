"""The exact Nussbaumer transform in PyTorch, and the bootstrap key in the
form the CMUX step reads, for the exact ('NTT') and the rounded-key
('FFT') engine.

The CMUX step (``ops/cmux.py``) multiplies in the transform domain against
the bootstrap key.  The key is transformed once, on the host with the numpy
oracle (``ref/transform_ref.forward``) or on the device from its digit
planes (``ops/keygen``), and each residue is kept mod 2^38:
only bits 6..37 of the unscaled inverse survive the final ``>> 6`` and mod
2^32, and every stage is a ring operation, so a multiple of 2^38 in an
operand changes nothing.  Centred residues (|v| <= 2^37) keep each 64-bit
product and each 128-term sum free of wraparound.
"""

import numpy as np
import torch

from ..numeric import wrap_i32
from ..utils import to_device
from ..ref import transform_ref as tr

N, M, R, L, LOG_L, INV_SHIFT = tr.N, tr.M, tr.R, tr.L, tr.LOG_L, tr.INV_SHIFT
KEY_BITS = 38


def centred_residues(v_u64):
    """u64 residues -> int64 values mod 2^KEY_BITS in (-2^37, 2^37]."""
    r = (np.asarray(v_u64, np.uint64) & np.uint64(2**KEY_BITS - 1)).astype(np.int64)
    return np.where(r > 2**(KEY_BITS - 1), r - 2**KEY_BITS, r)


def _centred_residues_t(v):
    """int64 tensor -> its residues mod 2^KEY_BITS in (-2^37, 2^37]
    (:func:`centred_residues` on tensors; two's complement keeps the low
    bits of a negative value as the uint64 cast does)."""
    r = v & (2**KEY_BITS - 1)
    return torch.where(r > 2**(KEY_BITS - 1), r - 2**KEY_BITS, r)


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

    A numpy key is transformed on the host with the numpy oracle
    (``ref/transform_ref.forward``) and uploaded.  A tensor key is
    transformed on ``device`` without a trip through the host: the one-sided
    limbs of ``ops/keygen.bootstrap_key_limbs_device``, then
    :func:`two_sided_limbs_device` and :func:`rows_key_from_limbs`; the
    result is the same int64 tensor bit for bit.

    :param bk_coeff: (n, mask1, l, mask1, N) int32 numpy array or tensor.
    :returns: (n, G = mask1*l, O = mask1, L, R) int64 tensor on ``device``
        ('NTT'), or (n, 2, G, O, L, R) with the side second ('FFT');
        g = o_in * l + d, matching ``ops/cmux`` and the kernels.
    """
    if transform_type not in ('NTT', 'FFT'):
        raise ValueError("transform_type must be 'NTT' or 'FFT', got %r"
                         % (transform_type,))
    n, mask1, l, mask1b, n_poly = bk_coeff.shape
    if mask1b != mask1 or n_poly != N:
        raise ValueError("unexpected bootstrap key shape %s"
                         % (tuple(bk_coeff.shape),))
    if torch.is_tensor(bk_coeff):
        from . import keygen
        pos, delta = keygen.bootstrap_key_limbs_device(
            bk_coeff.to(device), exact=transform_type == 'NTT')
        return rows_key_from_limbs(two_sided_limbs_device(pos, delta), device)
    from .. import native
    bk_coeff = np.asarray(bk_coeff)
    hat = native.forward_u64(bk_coeff)                 # (n, mask1, l, mask1, L, R)
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


def forward_i32(x):
    """Forward transform of int32 polynomials, exact mod 2^32:
    (..., N) -> (..., L, R) int32 (``nufhe_tpu/ops/transform.py:130-141``).
    For |x| <= 2^25 the values are exact as integers."""
    return wrap_i32(forward(x))


# --- the TPU's key operand: int8 limbs and the MAC right-hand side ---
#
# The key residue v mod 2^38 (centred) is split at the inverse's >> 6:
# v = 2^6*vhi + vlo, vlo = balanced(v mod 64) in [-32, 31], and vhi carried
# mod 2^32 as 4 balanced radix-2^8 limbs (stored limb index 1..4; index 0
# is vlo).  The rounded-key ('FFT') form drops vlo and keeps the 4 limbs of
# vhi = round(v/64).  The accumulator side is 2 limbs of the forward
# transformed digits (|.| <= 2^14).  Mirrors ``nufhe_tpu/ops/transform.py``.

KEY_LIMB_BITS = 8
KEY_LIMBS = 5             # vlo + 4 vhi limbs
KEY_LIMBS_APPROX = 4      # rounded key: the 4 vhi limbs
ACC_LIMB_BITS = 8
ACC_LIMBS = 2
SHIFT_GROUPS = 5          # MAC output groups [B, A0..A3]
SHIFT_GROUPS_APPROX = 4   # rounded key: [A0..A3]

# (mask1, l) pairs that the CUDA kernels K1, K3 and K4 are built for: the
# default (mask size 1, l = 2) and the JAX package's one-knob variants
# tlwe_mask_size=2 and bs_decomp_length=3
KERNEL_SHAPES = ((2, 2), (3, 2), (2, 3))


def _limb_split_38(v, exact=True):
    """Centred int64 values in [-2^37, 2^37) -> int8 limbs (..., KL):
    [vlo, vhi_0..3] (exact) or [vhi_0..3] of round(v/64) (rounded)."""
    if exact:
        vlo = ((v + 32) & 63) - 32
        limbs = [vlo.astype(np.int8)]
        v = (v - vlo) >> 6
        n_rest = KEY_LIMBS - 1
    else:
        limbs = []
        v = (v + 32) >> 6
        n_rest = KEY_LIMBS_APPROX
    for _ in range(n_rest):
        l0 = ((v + 128) & 255) - 128
        limbs.append(l0.astype(np.int8))
        v = (v - l0) >> KEY_LIMB_BITS
    return np.stack(limbs, axis=-1)


def key_limbs_host(bhat_u64, exact=True):
    """Key transforms (uint64 residues, needed mod 2^38) -> the two-sided
    limb form: limbs of +v and of (-v mod 2^38), each split on its own, so
    nothing is negated later (a negated -128 limb would not fit int8).

    :returns: int8 (..., KEY_LIMBS, 2) (exact) or (..., KEY_LIMBS_APPROX,
        2); [..., 0] = limbs(+v), [..., 1] = limbs(-v mod 2^38).
    """
    r = np.asarray(bhat_u64, np.uint64) & np.uint64(2**38 - 1)
    v = r.astype(np.int64)
    v = v - ((v >> 37) << 38)
    w = ((np.uint64(2**38) - r) & np.uint64(2**38 - 1)).astype(np.int64)
    w = w - ((w >> 37) << 38)
    return np.stack([_limb_split_38(v, exact), _limb_split_38(w, exact)],
                    axis=-1)


def one_sided_limbs_host(limbs):
    """Compact form of the two-sided limbs: the +v side, plus (rounded
    form only) one 0/1 bit a residue, delta = (q+ + q-) mod 2^32, from
    which :func:`two_sided_limbs_host` rebuilds the -v side.

    :returns: (pos, delta): ``pos`` int8 (..., KL); ``delta`` uint8 of
        ``pos.shape[:-1]`` (rounded) or None (exact).
    """
    limbs = np.asarray(limbs)
    pos = np.ascontiguousarray(limbs[..., 0])
    if limbs.shape[-2] == KEY_LIMBS:
        return pos, None
    w = np.arange(KEY_LIMBS_APPROX, dtype=np.int64) * KEY_LIMB_BITS
    qp = (limbs[..., 0].astype(np.int64) << w).sum(-1)
    qn = (limbs[..., 1].astype(np.int64) << w).sum(-1)
    delta64 = (qp + qn) & np.int64(0xFFFFFFFF)
    if delta64.size and delta64.max() > 1:
        raise ValueError("inconsistent two-sided limbs (delta not 0/1)")
    return pos, delta64.astype(np.uint8)


def relimb_from_radix8(old):
    """Format-2 key containers' plain balanced radix-2^8 two-sided limbs ->
    the current A/B form (``nufhe_tpu/ops/transform.py:177-191``).  The
    5-digit balanced split gives back the centred mod-2^38 value exactly
    (|v| < 2^37), so the re-split loses nothing.

    :param old: int8 (..., KEY_LIMBS, 2) in the old format.
    :returns: int8 (..., KEY_LIMBS, 2) in the A/B format.
    """
    old = np.asarray(old)
    v = np.zeros(old.shape[:-2] + (2,), np.int64)
    for j in reversed(range(KEY_LIMBS)):
        v = (v << KEY_LIMB_BITS) + old[..., j, :].astype(np.int64)
    return np.stack(
        [_limb_split_38(v[..., 0]), _limb_split_38(v[..., 1])], axis=-1)


def rows_key_from_limbs(limbs, device):
    """Two-sided key limbs -> the rows engine's key, equal to
    :func:`bootstrap_key_transformed` of the coefficient key they came from.
    The limb count selects the form, as it does for the lanes key.  Runs on
    ``device`` (a numpy argument is uploaded first, as int8).

    Exact form (5 limbs): side 0 holds vlo and 4 digits of vhi mod 2^32,
    and v = vlo + 64 * vhi mod 2^38 is the residue itself.  Rounded form
    (4 limbs): side s holds q = round(+-v/64) mod 2^32, and 64 * q mod
    2^38 is the port's rounded side s (the 64 * 2^32 = 2^38 wrap is
    harmless).  Both are then centred as :func:`centred_residues` does.

    :param limbs: (n, G, O, L, R, KL, 2) int8 numpy array or tensor (L in
        natural frequency order, as ``ops/tgsw.bootstrap_key_limbs_host``
        gives).
    :returns: (n, G, O, L, R) int64 tensor on ``device`` (5 limbs), or
        (n, 2, G, O, L, R) (4 limbs).
    """
    kl = limbs.shape[-2]
    if kl not in (KEY_LIMBS, KEY_LIMBS_APPROX) or limbs.shape[-1] != 2:
        raise ValueError("limbs must end in (%d or %d, 2), got %s"
                         % (KEY_LIMBS, KEY_LIMBS_APPROX, tuple(limbs.shape)))
    limbs = to_device(limbs, device)
    shifts = torch.arange(4, device=limbs.device) * KEY_LIMB_BITS
    if kl == KEY_LIMBS:
        digs = limbs[..., 0].to(torch.int64)      # the +v side
        hi = (digs[..., 1:] << shifts).sum(-1)
        key = _centred_residues_t(digs[..., 0] + (hi << 6))
    else:
        q = (limbs.to(torch.int64) << shifts[:, None]).sum(-2)
        key = torch.movedim(_centred_residues_t(q << 6), -1, 1)
    return key.contiguous()


def _neg_side_digits(whi, n_digs):
    """Balanced radix-2^8 digits of ``whi`` (an int64 array or tensor, mod
    2^32 semantics), each in [-128, 127]."""
    digs = []
    for _ in range(n_digs):
        d = ((whi + 128) & 255) - 128
        digs.append(d)
        whi = (whi - d) >> KEY_LIMB_BITS
    return digs


def two_sided_limbs_host(pos, delta=None):
    """Inverse of :func:`one_sided_limbs_host`: the (..., KL, 2) int8
    two-sided form, equal to :func:`key_limbs_host`'s."""
    pos = np.asarray(pos)
    exact = pos.shape[-1] == KEY_LIMBS
    p64 = pos.astype(np.int64)
    if exact:
        vlo = p64[..., 0]
        digs = p64[..., 1:]
        boundary = vlo == -32
        carry = boundary.astype(np.int64)
        wlo = np.where(boundary, np.int64(-32), -vlo)
    else:
        if delta is None:
            raise ValueError("rounded-mode compact limbs need delta bits")
        digs = p64
        carry = np.asarray(delta).astype(np.int64)
    n_digs = digs.shape[-1]
    w = np.arange(n_digs, dtype=np.int64) * KEY_LIMB_BITS
    vhi = (digs << w).sum(-1)
    neg = ([wlo] if exact else []) + _neg_side_digits(carry - vhi, n_digs)
    return np.stack([pos, np.stack(neg, axis=-1).astype(np.int8)], axis=-1)


def two_sided_limbs_device(pos, delta=None):
    """:func:`two_sided_limbs_host` on tensors, on ``pos``'s device (the JAX
    package's ``two_sided_limbs_device``): the (..., KL, 2) int8 two-sided
    form from the +v side, in int64 so that nothing overflows; digits 0..3
    depend only on the low 32 bits, so it equals the host form bit for bit.

    :param pos: (..., KEY_LIMBS or KEY_LIMBS_APPROX) int8 tensor.
    :param delta: (...,) 0/1 tensor (rounded form), else None.
    """
    exact = pos.shape[-1] == KEY_LIMBS
    p64 = pos.to(torch.int64)
    if exact:
        vlo = p64[..., 0]
        digs = p64[..., 1:]
        boundary = vlo == -32
        carry = boundary.to(torch.int64)
        wlo = torch.where(boundary, -32, -vlo)
    else:
        if delta is None:
            raise ValueError("rounded-mode compact limbs need delta bits")
        digs = p64
        carry = delta.to(pos.device, torch.int64)
    n_digs = digs.shape[-1]
    w = torch.arange(n_digs, device=pos.device) * KEY_LIMB_BITS
    neg = ([wlo] if exact else []) + \
        _neg_side_digits(carry - (digs << w).sum(-1), n_digs)
    return torch.stack([pos, torch.stack(neg, dim=-1).to(torch.int8)], dim=-1)


BITREV_L = tr.bit_reverse(LOG_L)


def _mac_limb_table(exact):
    """(ACC_LIMBS, groups) indices into the key limbs extended by a zero
    (index KL) and, exact form only, 4*vlo (index KL+1): entry [i, s] is
    the key limb that accumulator limb i meets in output group s."""
    kl = KEY_LIMBS if exact else KEY_LIMBS_APPROX
    zero, four = kl, kl + 1
    table = np.empty((ACC_LIMBS, kl), np.int64)
    for s in range(kl):
        if exact:
            table[0, s] = s                     # B: vlo; A_{s-1}: vhi_{s-1}
            table[1, s] = zero if s == 0 else (four if s == 1 else s - 1)
        else:
            table[0, s] = s                     # A_s: vhi_s
            table[1, s] = zero if s == 0 else s - 1
    return torch.from_numpy(table)


def build_mac_rhs(limbs):
    """Two-sided key limbs -> the MAC right-hand side with the negacyclic
    signs built in, on the limbs' device; bit for bit the JAX package's
    ``build_mac_rhs`` (``nufhe_tpu/ops/transform.py:352-433``).

    rhs[..., p, c, q], c = g*2R + i*R + u, q = s*O*R + o*R + k, holds the
    limb of sgn(u, k) * bhat[g, o, t(p)] at rotation (k - u) % R that
    accumulator limb i meets in output group s; sgn = +1 where k >= u (the
    +v limbs), else the -v mod 2^38 limbs.  Groups, exact form (5 limbs):
    s=0 is the B channel (a0 x vlo), s=1..4 the A channel's radix-2^8
    pieces (a0 x vhi_{s-1}, a1 x 4*vlo for s=1, a1 x vhi_{s-2} above);
    rounded form (4 limbs): s=0..3 (a0 x vhi_s, a1 x vhi_{s-1}).  Slot p
    holds key frequency bitrev_6(p), the order of the lanes engine's
    forward and inverse transforms (the JAX package's
    ``bitrev_order=True``, the only order its callers use).

    :param limbs: (..., G, O, L, R, KL, 2) int8 tensor; KL selects the form.
    :returns: (..., L, G*2R, KL*O*R) int8.
    """
    kl = limbs.shape[-2]
    if kl not in (KEY_LIMBS, KEY_LIMBS_APPROX) or limbs.shape[-1] != 2:
        raise ValueError("limbs must end in (%d or %d, 2), got %s"
                         % (KEY_LIMBS, KEY_LIMBS_APPROX, tuple(limbs.shape)))
    exact = kl == KEY_LIMBS
    dev = limbs.device
    g, o_sz = limbs.shape[-6], limbs.shape[-5]
    lead = tuple(limbs.shape[:-6])
    limbs = limbs.index_select(-4, torch.from_numpy(BITREV_L).to(dev))
    # rows[..., u, k, :] = limbs[(k - u) % R] of side 0 (k >= u) or 1
    k = torch.arange(R, device=dev)
    idx = (k[None, :] - k[:, None]) % R                 # [u, k]
    wrap = (k[None, :] < k[:, None])[..., None]         # [u, k, 1]
    rows = torch.where(wrap, limbs[..., 1][..., idx, :],
                       limbs[..., 0][..., idx, :])      # (..., G,O,L,u,k,KL)
    extra = [torch.zeros_like(rows[..., :1])]
    if exact:
        extra.append(rows[..., :1] * 4)                 # 4*vlo in [-128, 124]
    rows = torch.cat([rows] + extra, dim=-1)
    arr = rows[..., _mac_limb_table(exact).to(dev)]
    # (..., G, O, L, u, k, i, s) -> (..., L, G, i, u, s, O, k)
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + a for a in (2, 0, 5, 3, 6, 1, 4))
    arr = arr.permute(perm)
    return arr.reshape(lead + (L, g * ACC_LIMBS * R, kl * o_sz * R))


def negacyclic_mul_device(a, b_coeff):
    """Exact batched negacyclic product mod 2^32 of small polynomials
    ``a`` (|a| <= 2^9) with arbitrary torus polynomials ``b_coeff``
    (``nufhe_tpu/ops/transform.py:436-464``): ``b_coeff`` is transformed on
    the host and expanded into one MAC operand a product, and the whole
    batch runs through ``ops/flat_engine.transformed_mac_flat`` as plain
    PyTorch on ``a``'s device.

    :param a: (..., N) int32 tensor; ``b_coeff``: (..., N) int32, numpy or
        tensor, of the same batch shape.
    :returns: (..., N) int32 on ``a``'s device.
    """
    from . import flat_engine as fe
    from .. import native
    lead = tuple(a.shape[:-1])
    af = a.reshape(-1, N)
    bf = np.asarray(b_coeff.cpu() if torch.is_tensor(b_coeff) else b_coeff)
    limbs = native.bootstrap_key_limbs(bf.reshape(-1, N))   # (B, L, R, KL, 2)
    rhs = build_mac_rhs(torch.from_numpy(limbs[:, None, None]).to(a.device))
    out = fe.transformed_mac_flat(fe.q_from_n(af), rhs, mask1=1, g_total=1)
    return fe.n_from_q(out).reshape(lead + (N,))
