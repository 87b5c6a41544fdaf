"""One CMUX step in the lanes layout: kernel K4's wrapper, and the blind
rotation over it.

The function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step`` (its body is
``ops/flat_engine.external_step``), on the JAX package's layout and key
operand:

- ``acc_q``: (B, mask1*N) int32, q-layout (``flat_engine.q_from_n``);
- ``p``: (B,) int32 in [0, 2N);
- ``key_row``: one row of ``ops/tgsw.prepare_bootstrap_key_device``,
  (L=64, C, Q) int8, C = G*2R (G = mask1*l), Q = 5*mask1*R exact or
  4*mask1*R rounded; the row's shape gives mask1, l and the form.

:func:`blind_rotate_lanes` is the port of ``blind_rotate_pallas``: n K4
launches.

Tensor parallelism (the JAX package's ``axis_name``/``slot_axis_name``
branches, ``ops/flat_engine.py:215-306``, ``ops/rows_engine.py:869-954``)
splits K4 around a collective: :func:`lanes_mac_shard` runs grid 1 (the
whole, replicated, forward transform) and grid 2 on a key shard,
:func:`lanes_inverse` runs grid 3 on the combined channels, and
:func:`lanes_step_sharded` is one step with the collective between them.
A key shard is the row's C-slice of whole g-blocks (``mode='limbs'``: the
channels are partial sums, summed over the group) or its slot slice
(``mode='slots'``: the channels of this shard's slots, gathered).
"""

import torch

from ..numeric import wrap_i32
from . import flat_engine as fe
from . import transform as tf

# launches of the CUDA kernel (not of the plain version), a step whole or
# split around a collective; the collectives between a split step's grids
launches = 0
collectives = 0

MODES = ('limbs', 'slots')
# the splits K4 is instantiated for (the switches of ``mac_shard`` and
# ``inverse_chunks`` in kernels/csrc/lanes_step.cu): the MAC grid on 1, 2 or
# 4 limbs shards (each G/n whole g-blocks; n must divide G) or on 1, 2, 4 or
# 8 slots shards, the inverse grid on as many slot chunks
KERNEL_SPLITS = {'limbs': (1, 2, 4), 'slots': (1, 2, 4, 8)}


def key_shape(key_row, mode=None, n_shards=1):
    """(mask1, decomp_length, rounded) of one (L, C, Q) key row: C =
    G*2R with G = mask1*l, Q = 5*mask1*R (exact) or 4*mask1*R (rounded).
    With ``mode``, the row is one of ``n_shards`` shards: (L, C/n_shards, Q)
    of whole g-blocks (``'limbs'``; n_shards must divide G) or (L/n_shards,
    C, Q) (``'slots'``; n_shards must divide L)."""
    if mode is not None and mode not in MODES:
        raise ValueError("mode must be 'limbs' or 'slots', got %r" % (mode,))
    if key_row.dim() != 3:
        raise ValueError("a key row must be (L, C, Q), got %s"
                         % (tuple(key_row.shape),))
    l_size, c_size, q_size = key_row.shape
    if mode == 'limbs':
        c_size *= n_shards
    elif mode == 'slots':
        l_size *= n_shards
    if l_size != tf.L or c_size % (tf.ACC_LIMBS * tf.R):
        raise ValueError("a key row must be (%d, G*%d, Q), got %s%s"
                         % (tf.L, tf.ACC_LIMBS * tf.R, tuple(key_row.shape),
                            "" if mode is None else " as one of %d %s shards"
                            % (n_shards, mode)))
    g_size = c_size // (tf.ACC_LIMBS * tf.R)
    for groups in (tf.SHIFT_GROUPS, tf.SHIFT_GROUPS_APPROX):
        mask1, rem = divmod(q_size, groups * tf.R)
        if not rem and mask1 and g_size % mask1 == 0:
            if mode == 'limbs' and key_row.shape[1] % (tf.ACC_LIMBS * tf.R):
                raise ValueError(
                    "mode='limbs' splits the key in whole g-blocks: "
                    "n_model=%d must divide G = %d" % (n_shards, g_size))
            return mask1, g_size // mask1, groups == tf.SHIFT_GROUPS_APPROX
    raise ValueError("a key row's Q must be 5 or 4 times mask1*%d with mask1 "
                     "dividing G = %d, got Q = %d" % (tf.R, g_size, q_size))


def lanes_step_plain(acc_q, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K4; any device."""
    mask1, decomp_length, _ = key_shape(key_row)
    return fe.external_step(acc_q, p, key_row, mask1=mask1,
                            decomp_length=decomp_length, log2_base=log2_base,
                            offset=offset)


def check_key(key, rows_shape, name, mode=None, n_shards=1):
    """``key`` is int8 of shape ``rows_shape`` + (L, C, Q) (a shard of it
    with ``mode``, as in :func:`key_shape`); returns whether it is the
    rounded form (Q = 4*mask1*R)."""
    if key.dtype != torch.int8:
        raise TypeError("%s takes an int8 key" % name)
    n = len(rows_shape)
    if tuple(key.shape[:n]) != tuple(rows_shape) or key.dim() != n + 3:
        raise ValueError("%s: key must be %s + (L, C, Q), got %s"
                         % (name, tuple(rows_shape), tuple(key.shape)))
    return key_shape(key[(0,) * n] if n else key, mode, n_shards)[2]


def _check_step(acc_q, p, key_row, mode=None, n_shards=1):
    """Checks of one step's operands; returns (mask1, decomp_length,
    rounded)."""
    if acc_q.dtype != torch.int32:
        raise TypeError("lanes_step takes an int32 accumulator")
    if key_row.dtype != torch.int8:
        raise TypeError("lanes_step takes an int8 key")
    mask1, decomp_length, rounded = key_shape(key_row, mode, n_shards)
    if acc_q.dim() != 2 or acc_q.shape[1] != mask1 * tf.N:
        raise ValueError("acc_q must be (B, %d), got %s"
                         % (mask1 * tf.N, tuple(acc_q.shape)))
    if p.dtype != torch.int32:
        raise TypeError("lanes_step takes int32 powers")
    if p.shape != (acc_q.shape[0],):
        raise ValueError("p must be (B,), got %s" % (tuple(p.shape),))
    if not (acc_q.device == p.device == key_row.device):
        raise ValueError("acc_q, p and key row must be on one device")
    return mask1, decomp_length, rounded


def _check_cuda(*tensors):
    if tensors[0].device.type != 'cuda':
        raise ValueError("lanes_step runs on CUDA or CPU, not %s"
                         % tensors[0].device)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lanes_step takes contiguous tensors")


def _call(acc_in, acc_out, p, key_row, limbs, chan, *, mask1, decomp_length,
          rounded, grids, offset=0, log2_base=1, g_local=None, slot_shards=1,
          shard=0, slot_chunks=1):
    """One call of K4's launcher: the grids named by the bit mask ``grids``
    (1 forward, 2 MAC, 4 inverse) on CUDA tensors; the MAC on shard
    ``shard`` of a split in ``g_local`` g-blocks (default: all G) or in
    ``slot_shards`` slot ranges, the inverse on ``slot_chunks`` shard-major
    chunks."""
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    from ..kernels import build
    fn = build.entry("lanes_step")
    stream = torch.cuda.current_stream(acc_in.device).cuda_stream
    ptr = [0 if t is None else t.data_ptr()
           for t in (p, key_row, limbs, chan)]
    code = fn(acc_in.data_ptr(), acc_out.data_ptr(), *ptr, acc_in.shape[0],
              mask1, decomp_length, int(offset) & 0xFFFFFFFF, int(log2_base),
              int(rounded), int(grids),
              mask1 * decomp_length if g_local is None else g_local,
              slot_shards, shard, slot_chunks, acc_in.device.index, stream)
    build.check("lanes_step", code)


def _limbs_scratch(acc_q, mask1, decomp_length):
    """The int8 limbs of the forward transforms, slot-major: (L, B, C)."""
    return torch.empty((tf.L, acc_q.shape[0],
                        mask1 * decomp_length * tf.ACC_LIMBS * tf.R),
                       dtype=torch.int8, device=acc_q.device)


def _channels(bsz, mask1, rounded, n_slots, device):
    """The MAC's output channels (lo, and hi in the exact form):
    (B, n_ch, mask1, n_slots, R) int32."""
    return torch.empty((bsz, 1 if rounded else 2, mask1, n_slots, tf.R),
                       dtype=torch.int32, device=device)


def _launch(acc_q, p, key_row, grids, *, offset, log2_base):
    """Launch the grids of K4 named by the bit mask ``grids`` (1 forward,
    2 MAC, 4 inverse; 7 is the step) on CUDA tensors."""
    mask1, decomp_length, rounded = _check_step(acc_q, p, key_row)
    _check_cuda(acc_q, p, key_row)
    if (mask1, decomp_length) not in tf.KERNEL_SHAPES:
        raise ValueError("the lanes_step kernel takes (mask1, l) in %s, not "
                         "(%d, %d)" % (tf.KERNEL_SHAPES, mask1, decomp_length))
    out = torch.empty_like(acc_q)
    _call(acc_q, out, p, key_row, _limbs_scratch(acc_q, mask1, decomp_length),
          _channels(acc_q.shape[0], mask1, rounded, tf.L, acc_q.device),
          mask1=mask1, decomp_length=decomp_length, rounded=rounded,
          grids=grids, offset=offset, log2_base=log2_base)
    return out


def lanes_step(acc_q, p, key_row, *, offset, log2_base):
    """K4: one CMUX step.  A CUDA tensor runs the kernel; a CPU tensor the
    plain version.  Returns a new tensor."""
    global launches
    if acc_q.device.type == 'cpu':
        _check_step(acc_q, p, key_row)
        return lanes_step_plain(acc_q, p, key_row, offset=offset,
                                log2_base=log2_base)
    out = _launch(acc_q, p, key_row, 7, offset=offset, log2_base=log2_base)
    launches += 1
    return out


def lanes_step_grids(acc_q, p, key_row, grids, *, offset, log2_base):
    """K4's grids named by ``grids`` alone, on CUDA tensors, to time them
    apart; the output is meaningful only for ``grids == 7``."""
    global launches
    out = _launch(acc_q, p, key_row, grids, offset=offset, log2_base=log2_base)
    launches += 1
    return out


def _shard_range(mode, shard, n_shards, mask1, decomp_length):
    """(g_local, g_first, slot_first, n_slots) of ``shard`` of ``n_shards``."""
    if not 0 <= shard < n_shards:
        raise ValueError("shard %d of %d" % (shard, n_shards))
    g_size = mask1 * decomp_length
    if mode == 'limbs':
        g_local = g_size // n_shards
        return g_local, shard * g_local, 0, tf.L
    n_slots = tf.L // n_shards
    return g_size, 0, shard * n_slots, n_slots


def lanes_mac_shard(acc_q, p, key_shard, *, shard, n_shards, mode, offset,
                    log2_base):
    """K4's grids 1 and 2 on one key shard: the rotation, digits and forward
    transform of the whole accumulator, then the MAC on shard ``shard`` of
    ``n_shards`` of a key row (``mode``: 'limbs' or 'slots', as in
    :func:`key_shape`).  Returns the shard's channels, (B, n_ch, mask1,
    L_local, R) int32: partial sums over its g-blocks (limbs; L_local = L)
    or its L_local = L/n_shards slots.  A CUDA tensor runs the kernel (the
    count moves in :func:`lanes_step_sharded`, the step's launch); a CPU
    tensor the plain version (``ops/flat_engine.mac_channels``)."""
    mask1, decomp_length, rounded = _check_step(acc_q, p, key_shard, mode,
                                                n_shards)
    g_local, g_first, slot_first, n_slots = _shard_range(
        mode, shard, n_shards, mask1, decomp_length)
    slot_shards = tf.L // n_slots
    if acc_q.device.type == 'cpu':
        rot = fe.rotate_q(acc_q, p, minus_one=True)
        digits = fe.gadget_decomp_flat(rot, mask1, decomp_length, log2_base,
                                       offset)
        digits = digits[:, g_first * tf.N:(g_first + g_local) * tf.N]
        return fe.mac_channels(digits, key_shard, mask1=mask1,
                               g_total=g_local, slot_start=slot_first)
    _check_cuda(acc_q, p, key_shard)
    if ((mask1, decomp_length) not in tf.KERNEL_SHAPES
            or n_shards not in KERNEL_SPLITS[mode]):
        raise ValueError("the lanes_step kernel takes (mask1, l) in %s and "
                         "%s %s shards, not (%d, %d) and %d"
                         % (tf.KERNEL_SHAPES, KERNEL_SPLITS[mode], mode,
                            mask1, decomp_length, n_shards))
    chan = _channels(acc_q.shape[0], mask1, rounded, n_slots, acc_q.device)
    _call(acc_q, acc_q, p, key_shard,
          _limbs_scratch(acc_q, mask1, decomp_length), chan, mask1=mask1,
          decomp_length=decomp_length, rounded=rounded, grids=3,
          offset=offset, log2_base=log2_base, g_local=g_local,
          slot_shards=slot_shards, shard=shard)
    return chan


def lanes_inverse(acc_q, chan):
    """K4's grid 3: acc_q + the inverse of the channels, normalised.

    :param chan: (B, n_ch, mask1, L, R) int32 (an unsplit or limbs step's
        channels, summed), or (n_shards, B, n_ch, mask1, L/n_shards, R) as a
        slots step's gather leaves them (``flat_engine.gather_slots``).
    """
    gathered = chan.dim() == 6
    mask1, n_ch = chan.shape[-3], chan.shape[-4]
    slot_chunks = chan.shape[0] if gathered else 1
    if (chan.dtype != torch.int32 or chan.shape[-1] != tf.R
            or chan.shape[-2] * slot_chunks != tf.L or n_ch not in (1, 2)
            or chan.shape[-5] != acc_q.shape[0]
            or acc_q.shape != (acc_q.shape[0], mask1 * tf.N)):
        raise ValueError("lanes_inverse: channels %s do not fit the "
                         "accumulator %s" % (tuple(chan.shape),
                                             tuple(acc_q.shape)))
    if acc_q.device.type == 'cpu':
        if gathered:
            chan = fe.slots_from_gathered(chan)
        delta = fe.inverse_channels(chan, mask1)
        return wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
    _check_cuda(acc_q, chan)
    if slot_chunks not in KERNEL_SPLITS['slots'] or mask1 not in (2, 3):
        raise ValueError("the lanes_step kernel's inverse takes mask1 2 or 3 "
                         "and %s slot shards, not %d and %d"
                         % (KERNEL_SPLITS['slots'], mask1, slot_chunks))
    out = torch.empty_like(acc_q)
    _call(acc_q, out, None, None, None, chan, mask1=mask1, decomp_length=0,
          rounded=n_ch == 1, grids=4, slot_chunks=slot_chunks)
    return out


def lanes_step_sharded(acc_q, p, key_shard, *, shard, n_shards, mode, group,
                       offset, log2_base):
    """One tensor-parallel CMUX step on this rank's key shard, shard
    ``shard`` of ``n_shards`` (``mode`` 'limbs' or 'slots', as in
    :func:`key_shape`): grids 1 and 2 (:func:`lanes_mac_shard`), the
    channels summed (limbs) or gathered (slots) over the process group
    ``group``, then grid 3 (:func:`lanes_inverse`).  CPU tensors run the
    plain versions of the grids.  Counts one collective, and on CUDA
    tensors one K4 launch."""
    global launches, collectives
    chan = lanes_mac_shard(acc_q, p, key_shard, shard=shard,
                           n_shards=n_shards, mode=mode, offset=offset,
                           log2_base=log2_base)
    if mode == 'limbs':
        chan = fe.sum_channels(chan, group)
    else:
        chan = fe.gather_slots(chan, group)
    out = lanes_inverse(acc_q, chan)
    collectives += 1
    if acc_q.device.type == 'cuda':
        launches += 1
    return out


def blind_rotate_lanes(acc_q, key, bara_t, *, offset, log2_base):
    """All n steps of the blind rotation, one K4 launch a step.

    :param acc_q: (B, mask1*N) int32 q-layout accumulator.
    :param key: (n, L, C, Q) int8 (``ops/tgsw.prepare_bootstrap_key_device``).
    :param bara_t: (n, B) int32 in [0, 2N), one row a step.
    """
    n = bara_t.shape[0]
    check_key(key, (n,), "blind_rotate_lanes")
    for i in range(n):
        acc_q = lanes_step(acc_q, bara_t[i], key[i], offset=offset,
                           log2_base=log2_base)
    return acc_q
