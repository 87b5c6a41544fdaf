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

Tensor parallelism (the JAX package's ``axis_name``, and the rows
engine's ``slot_axis_name``): :func:`mac_channels` is the MAC up to its two
channels, on a C-slice of whole g-blocks or a slot slice of the key;
:func:`sum_channels` and :func:`gather_slots` combine the shards' channels
over a ``torch.distributed`` process group; :func:`inverse_channels` is the
rest of the product.

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


def mac_channels(digits, rhs_row, *, mask1, g_total, slot_start=0):
    """The forward transform, the per-slot MAC against the int8 key operand
    and the two channels, before the inverse: what K4's grids 1 and 2 leave
    in device memory.

    :param digits: (rows, g_total*1024) int32 q-layout, small (|.| <= 2^9
        for the limbs to fit int8).
    :param rhs_row: (L_local, C, Q) int8 key row, or (rows, L_local, C, Q)
        with one row for each sample; C = g_total*2R.  ``L_local`` slots
        from ``slot_start`` (a slots shard), all 64 by default.
    :returns: (rows, n_ch, mask1, L_local, R) int32, K4's channel layout
        [b][ch][o][t][k]: ch 0 is lo = A0 + A1<<8 + A2<<16 + A3<<24 mod
        2^32, ch 1 (exact form only) is hi = B.
    """
    rows = digits.shape[0]
    l_local = rhs_row.shape[-3]
    xt = dif_forward_q(digits, n_poly=g_total).reshape(rows, g_total, L, R)
    xt = xt[:, :, slot_start:slot_start + l_local]
    a0 = ((xt + 128) & 255) - 128
    a1 = (xt - a0) >> 8
    return limb_channels(a0, a1, rhs_row, mask1=mask1)


def limb_channels(a0, a1, rhs_row, *, mask1):
    """The per-slot MAC of the digits' int8 limbs against the key operand
    and its two channels (the rest of :func:`mac_channels`).

    :param a0, a1: (rows, g, L_local, R) integer tensors in [-128, 128),
        the limbs of the transformed digits, slot order.
    :param rhs_row: as in :func:`mac_channels`, C = g*2R.
    :returns: (rows, n_ch, mask1, L_local, R) int32, as
        :func:`mac_channels`.
    """
    rows, g_total, l_local = a0.shape[:3]
    n_groups = key_groups(rhs_row.shape[-1], mask1)
    # lhs[b, t, c], c = g*2R + i*R + u
    lhs = torch.stack([a0, a1], dim=2).permute(0, 3, 1, 2, 4)
    lhs = lhs.reshape(rows, l_local, g_total * tf.ACC_LIMBS * R).to(
        torch.float64)
    rhs = rhs_row.to(torch.float64)
    if rhs.dim() == 3:
        out = torch.einsum('btc,tcq->btq', lhs, rhs)
    else:
        out = torch.einsum('btc,btcq->btq', lhs, rhs)
    ps = out.to(torch.int64).reshape(rows, l_local, n_groups, mask1, R)
    first = 1 if n_groups == tf.SHIFT_GROUPS else 0   # exact: [B, A0..A3]
    lo = (ps[:, :, first] + (ps[:, :, first + 1] << 8)
          + (ps[:, :, first + 2] << 16) + (ps[:, :, first + 3] << 24))
    chans = [lo] if first == 0 else [lo, ps[:, :, 0]]
    return wrap_i32(torch.stack(chans, dim=1).permute(0, 1, 3, 2, 4))


def inverse_channels(chan, mask1):
    """The inverse of the channels and the normalisation: (rows, n_ch,
    mask1, L, R) int32 -> (rows, mask1*1024) int32 q-layout product."""
    rows = chan.shape[0]
    inv = [dit_inverse_q(chan[:, ch].reshape(rows, mask1 * 2 * N),
                         n_poly=mask1) for ch in range(chan.shape[1])]
    return normalize_dual(inv[0], inv[1] if len(inv) > 1 else None)


def sum_channels(chan, group):
    """Limbs tensor parallelism: the channels summed over ``group``, in
    place.  The lo channel's sum wraps mod 2^32 in int32, as the JAX
    package's ``psum`` does; the hi channel's stays exact (below G * 2^24 in
    absolute value)."""
    import torch.distributed as dist
    dist.all_reduce(chan, op=dist.ReduceOp.SUM, group=group)
    return chan


def gather_slots(chan, group):
    """Slots tensor parallelism: every shard's channels over ``group``, as
    they lie: (n_shards, rows, n_ch, mask1, L_local, R), shard s holding
    slots s*L_local ..  K4's inverse grid reads this layout;
    :func:`slots_from_gathered` gives the plain order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = torch.empty((n * chan.shape[0],) + tuple(chan.shape[1:]),
                      dtype=chan.dtype, device=chan.device)
    # all_gather_single is the newer name; all_gather_into_tensor, the older
    # one, is deprecated where both exist
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, chan.contiguous(), group=group)
    return out.reshape((n,) + tuple(chan.shape))


def slots_from_gathered(gathered):
    """(n_shards, rows, n_ch, mask1, L_local, R) -> (rows, n_ch, mask1,
    n_shards*L_local, R)."""
    n, rows, n_ch, mask1, l_local, r = gathered.shape
    return gathered.permute(1, 2, 3, 0, 4, 5).reshape(
        rows, n_ch, mask1, n * l_local, r)


def transformed_mac_flat(digits, rhs_row, *, mask1, g_total, group=None,
                         slot_group=None):
    """sum_g digits_g * key_g: forward transform, per-slot MAC against the
    int8 key operand, the two channels, inverse, normalisation.

    :param digits: (rows, g_total*1024) int32 q-layout, small (|.| <= 2^9
        for the limbs to fit int8).
    :param rhs_row: (L, C, Q) int8 key row, or (rows, L, C, Q) with one
        row for each sample.
    :param group: limbs tensor parallelism (the JAX package's
        ``axis_name``): ``digits`` and ``rhs_row`` hold this rank's g-blocks,
        and the channels are summed over the process group before the
        inverse.
    :param slot_group: slots tensor parallelism (``slot_axis_name``):
        ``rhs_row`` holds this rank's contiguous slot slice of the key, and
        the channels are gathered over the group before the inverse.
    :returns: (rows, mask1*1024) int32 q-layout product mod 2^32.
    """
    if group is not None and slot_group is not None:
        raise ValueError("group (limbs) and slot_group (slots) exclude each "
                         "other")
    slot_start = 0
    if slot_group is not None:
        import torch.distributed as dist
        slot_start = dist.get_rank(slot_group) * rhs_row.shape[-3]
    chan = mac_channels(digits, rhs_row, mask1=mask1, g_total=g_total,
                        slot_start=slot_start)
    if group is not None:
        chan = sum_channels(chan, group)
    if slot_group is not None:
        chan = slots_from_gathered(gather_slots(chan, slot_group))
    return inverse_channels(chan, mask1)


def external_mul_flat(sample_q, rhs_row, *, mask1, decomp_length, log2_base,
                      offset, group=None, slot_group=None):
    """BK_row (x) decomp(sample): the transformed external product.

    :param sample_q: (rows, mask1*1024) int32 q-layout TLWE sample.
    :param rhs_row: (L, G*2R, Q) int8 from ``ops/transform.build_mac_rhs``;
        under ``group`` this rank's contiguous g-block C-slice (L,
        G_local*2R, Q), under ``slot_group`` its slot slice (L_local, C, Q).
    :param group, slot_group: tensor parallelism, as in
        :func:`transformed_mac_flat`.  Under ``group`` each rank decomposes
        the whole (replicated) sample and keeps its digit slice, from g-block
        rank * G_local.
    :returns: (rows, mask1*1024) int32 q-layout.
    """
    digits = gadget_decomp_flat(sample_q, mask1, decomp_length, log2_base,
                                offset)
    g_total = mask1 * decomp_length
    if group is not None:
        import torch.distributed as dist
        g_total = rhs_row.shape[-2] // (tf.ACC_LIMBS * R)
        start = dist.get_rank(group) * g_total * N
        digits = digits[:, start:start + g_total * N]
    return transformed_mac_flat(digits, rhs_row, mask1=mask1, g_total=g_total,
                                group=group, slot_group=slot_group)


def external_step(acc_q, p, rhs_row, *, mask1, decomp_length, log2_base,
                  offset, group=None, slot_group=None):
    """One CMUX step: ACC + BK_row (x) decomp((X^p - 1) ACC), mod 2^32;
    ``group``/``slot_group`` as in :func:`external_mul_flat`."""
    rot = rotate_q(acc_q, p, minus_one=True)
    delta = external_mul_flat(rot, rhs_row, mask1=mask1,
                              decomp_length=decomp_length,
                              log2_base=log2_base, offset=offset, group=group,
                              slot_group=slot_group)
    return wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
