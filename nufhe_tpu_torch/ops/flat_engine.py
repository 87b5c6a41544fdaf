"""The lanes-layout engine in plain PyTorch: one CMUX step on a q-layout
accumulator against the TPU's int8 key operand — the function of
``nufhe_tpu/ops/flat_engine.py`` and the plain version of kernel K4
(``ops/lanes_step.py``).

Its contract, kept from the JAX package:

- **q-layout**: coefficient n = i*32 + j of a polynomial lies at lane
  q = j*32 + i (j = Nussbaumer slot, i = lane of S' = Z[Y]/(Y^32 + 1)), so
  lanes j*32 .. j*32+31 hold the block A_j;
- **bit-reversed slots**: the forward transform leaves frequency
  bitrev_6(p) in slot p, and the inverse takes that order; the key's L axis
  is stored the same way (``ops/transform.build_mac_rhs``);
- **the MAC operand**: one key row is (L, C = G*2R, Q) int8, Q = 5*O*R
  (exact: groups B, A0..A3) or 4*O*R (rounded key: A0..A3, no B channel);
  the engine reads the form off Q.

The JAX package writes each stage as lane rolls and selects for the TPU;
here they are index tables and gathers over the same values.  The MAC runs
in float64, which is exact (each product is at most 2^14 in absolute
value, each 256-term sum at most 2^22), on any device.
"""

import torch

from ..numeric import wrap_i32
from . import transform as tf

N, M, R, L = tf.N, tf.M, tf.R, tf.L
INV_SHIFT = tf.INV_SHIFT
_BITREV = torch.from_numpy(tf.BITREV_L)


def q_from_n(x):
    """(..., 1024) coefficient order n = i*32 + j -> q-layout q = j*32 + i."""
    v = x.reshape(x.shape[:-1] + (R, M))
    return v.transpose(-1, -2).reshape(x.shape)


n_from_q = q_from_n  # the (i, j) swap is an involution


def rotate_q(x, p, minus_one=False):
    """X^p * x (or (X^p - 1) * x) in q-layout, one power a row.

    :param x: (rows, C*1024) int32, C polynomials in q-layout.
    :param p: (rows,) or (rows, 1) int32 in [0, 2N).
    """
    rows = x.shape[0]
    polys = x.reshape(rows, -1, N).to(torch.int64)
    q = torch.arange(N, device=x.device)
    c = (q & (R - 1)) * R + (q >> 5)                  # coefficient at lane q
    src = (c[None, :] - p.reshape(rows, 1).to(torch.int64)) % (2 * N)
    sign = torch.where(src >= N, -1, 1)
    n_src = src % N
    q_src = (n_src & (M - 1)) * R + (n_src >> 5)
    out = torch.gather(polys, 2, q_src[:, None, :].expand_as(polys))
    out = out * sign[:, None, :]
    if minus_one:
        out = out - polys
    return wrap_i32(out).reshape(x.shape)


def gadget_decomp_flat(rot, mask1, decomp_length, log2_base, offset):
    """(rows, mask1*1024) -> (rows, G*1024) signed digits in
    [-base/2, base/2), g = o*decomp_length + d."""
    base_half = 1 << (log2_base - 1)
    mask = (1 << log2_base) - 1
    shifted = (rot.to(torch.int64) + int(offset)) & 0xFFFFFFFF
    shifted = shifted.reshape(rot.shape[0], mask1, 1, N)
    sh = torch.tensor([32 - (d + 1) * log2_base for d in range(decomp_length)],
                      device=rot.device)[:, None]
    digits = ((shifted >> sh) & mask) - base_half       # (rows, O, l, N)
    return digits.to(torch.int32).reshape(rot.shape[0], -1)


def dif_forward_q(dig, n_poly=1):
    """Forward transform of q-layout polynomials.

    :param dig: (rows, n_poly*1024) int32.
    :returns: (rows, n_poly*2048) int32, mod 2^32 (exact as integers for
        |dig| <= 2^25); slot p (32 lanes) of each 2048-lane region holds
        a-hat[bitrev_6(p)].
    """
    rows = dig.shape[0]
    blocks = dig.reshape(rows, n_poly, M, R).to(torch.int64)   # A_j[i]
    padded = torch.cat([blocks, torch.zeros_like(blocks)], dim=-2)
    hat = tf.dft_l(padded, inverse=False)                      # natural order
    hat = hat.index_select(-2, _BITREV.to(dig.device))
    return wrap_i32(hat).reshape(rows, n_poly * 2 * N)


def dit_inverse_q(x, n_poly=1):
    """Unscaled inverse transform and fold, per 2048-lane region.

    :param x: (rows, n_poly*2048) int32, bit-reversed slot order.
    :returns: (rows, n_poly*1024) int32 q-layout holding L * c mod 2^32.
    """
    rows = x.shape[0]
    chat = x.reshape(rows, n_poly, L, R).to(torch.int64)
    chat = chat.index_select(-2, _BITREV.to(x.device))         # natural order
    coeffs = tf.inverse_unscaled(chat)                         # (rows, P, N)
    return q_from_n(wrap_i32(coeffs)).reshape(rows, n_poly * N)


def normalize_dual(a, b_):
    """(A, B) inverse outputs -> c = A + (B >> 6) mod 2^32; B is a multiple
    of 64, so the shift is exact.  Rounded key (``b_`` None): c = A."""
    if b_ is None:
        return a.to(torch.int32)
    return wrap_i32(a.to(torch.int64) + (b_.to(torch.int64) >> INV_SHIFT))


def key_groups(q_size, mask1):
    """Output groups of a key row of Q columns: 5 (exact) or 4 (rounded)."""
    groups, rem = divmod(q_size, mask1 * R)
    if rem or groups not in (tf.SHIFT_GROUPS, tf.SHIFT_GROUPS_APPROX):
        raise ValueError("a key row's Q must be 5 or 4 times %d, got %d"
                         % (mask1 * R, q_size))
    return groups


def transformed_mac_flat(digits, rhs_row, *, mask1, g_total):
    """sum_g digits_g * key_g: forward transform, per-slot MAC against the
    int8 key operand, the two channels, inverse, normalisation.

    :param digits: (rows, g_total*1024) int32 q-layout, small (|.| <= 2^9
        for the limbs to fit int8).
    :param rhs_row: (L, C, Q) int8 key row, or (rows, L, C, Q) with one
        row for each sample.
    :returns: (rows, mask1*1024) int32 q-layout product mod 2^32.
    """
    rows = digits.shape[0]
    n_groups = key_groups(rhs_row.shape[-1], mask1)
    xt = dif_forward_q(digits, n_poly=g_total).reshape(rows, g_total, L, R)
    a0 = ((xt + 128) & 255) - 128
    a1 = (xt - a0) >> 8
    # lhs[b, t, c], c = g*2R + i*R + u
    lhs = torch.stack([a0, a1], dim=2).permute(0, 3, 1, 2, 4)
    lhs = lhs.reshape(rows, L, g_total * tf.ACC_LIMBS * R).to(torch.float64)
    rhs = rhs_row.to(torch.float64)
    if rhs.dim() == 3:
        out = torch.einsum('btc,tcq->btq', lhs, rhs)
    else:
        out = torch.einsum('btc,btcq->btq', lhs, rhs)
    ps = out.to(torch.int64).reshape(rows, L, n_groups, mask1, R)
    if n_groups == tf.SHIFT_GROUPS:
        lo = (ps[:, :, 1] + (ps[:, :, 2] << 8) + (ps[:, :, 3] << 16)
              + (ps[:, :, 4] << 24))
        hi = ps[:, :, 0]
    else:
        lo = (ps[:, :, 0] + (ps[:, :, 1] << 8) + (ps[:, :, 2] << 16)
              + (ps[:, :, 3] << 24))
        hi = None

    def channel(x):          # (rows, L, O, R) -> (rows, O*2048) int32
        return wrap_i32(x.permute(0, 2, 1, 3).reshape(rows, mask1 * 2 * N))

    inv_lo = dit_inverse_q(channel(lo), n_poly=mask1)
    inv_hi = None if hi is None else dit_inverse_q(channel(hi), n_poly=mask1)
    return normalize_dual(inv_lo, inv_hi)


def external_mul_flat(sample_q, rhs_row, *, mask1, decomp_length, log2_base,
                      offset):
    """BK_row (x) decomp(sample): the transformed external product.

    :param sample_q: (rows, mask1*1024) int32 q-layout TLWE sample.
    :param rhs_row: (L, G*2R, Q) int8 from ``ops/transform.build_mac_rhs``.
    :returns: (rows, mask1*1024) int32 q-layout.
    """
    digits = gadget_decomp_flat(sample_q, mask1, decomp_length, log2_base,
                                offset)
    return transformed_mac_flat(digits, rhs_row, mask1=mask1,
                                g_total=mask1 * decomp_length)


def external_step(acc_q, p, rhs_row, *, mask1, decomp_length, log2_base,
                  offset):
    """One CMUX step: ACC + BK_row (x) decomp((X^p - 1) ACC), mod 2^32."""
    rot = rotate_q(acc_q, p, minus_one=True)
    delta = external_mul_flat(rot, rhs_row, mask1=mask1,
                              decomp_length=decomp_length,
                              log2_base=log2_base, offset=offset)
    return wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
