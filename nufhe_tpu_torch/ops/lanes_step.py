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
"""

import torch

from . import flat_engine as fe
from . import transform as tf

# launches of the CUDA kernel (not of the plain version)
launches = 0


def key_shape(key_row):
    """(mask1, decomp_length, rounded) of one (L, C, Q) key row: C =
    G*2R with G = mask1*l, Q = 5*mask1*R (exact) or 4*mask1*R (rounded)."""
    if key_row.dim() != 3 or key_row.shape[0] != tf.L \
            or key_row.shape[1] % (tf.ACC_LIMBS * tf.R):
        raise ValueError("a key row must be (%d, G*%d, Q), got %s"
                         % (tf.L, tf.ACC_LIMBS * tf.R, tuple(key_row.shape)))
    g_size = key_row.shape[1] // (tf.ACC_LIMBS * tf.R)
    q_size = key_row.shape[2]
    for groups in (tf.SHIFT_GROUPS, tf.SHIFT_GROUPS_APPROX):
        mask1, rem = divmod(q_size, groups * tf.R)
        if not rem and mask1 and g_size % mask1 == 0:
            return mask1, g_size // mask1, groups == tf.SHIFT_GROUPS_APPROX
    raise ValueError("a key row's Q must be 5 or 4 times mask1*%d with mask1 "
                     "dividing G = %d, got Q = %d" % (tf.R, g_size, q_size))


def lanes_step_plain(acc_q, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K4; any device."""
    mask1, decomp_length, _ = key_shape(key_row)
    return fe.external_step(acc_q, p, key_row, mask1=mask1,
                            decomp_length=decomp_length, log2_base=log2_base,
                            offset=offset)


def check_key(key, rows_shape, name):
    """``key`` is int8 of shape ``rows_shape`` + (L, C, Q); returns
    whether it is the rounded form (Q = 4*mask1*R)."""
    if key.dtype != torch.int8:
        raise TypeError("%s takes an int8 key" % name)
    n = len(rows_shape)
    if tuple(key.shape[:n]) != tuple(rows_shape) or key.dim() != n + 3:
        raise ValueError("%s: key must be %s + (L, C, Q), got %s"
                         % (name, tuple(rows_shape), tuple(key.shape)))
    return key_shape(key[(0,) * n] if n else key)[2]


def _check_step(acc_q, p, key_row):
    """Checks of one step's operands; returns (mask1, decomp_length,
    rounded)."""
    if acc_q.dtype != torch.int32:
        raise TypeError("lanes_step takes an int32 accumulator")
    if key_row.dtype != torch.int8:
        raise TypeError("lanes_step takes an int8 key")
    mask1, decomp_length, rounded = key_shape(key_row)
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


def _launch(acc_q, p, key_row, grids, *, offset, log2_base):
    """Launch the grids of K4 named by the bit mask ``grids`` (1 forward,
    2 MAC, 4 inverse; 7 is the step) on CUDA tensors."""
    mask1, decomp_length, rounded = _check_step(acc_q, p, key_row)
    if acc_q.device.type != 'cuda':
        raise ValueError("lanes_step runs on CUDA or CPU, not %s"
                         % acc_q.device)
    if (mask1, decomp_length) not in tf.KERNEL_SHAPES:
        raise ValueError("the lanes_step kernel takes (mask1, l) in %s, not "
                         "(%d, %d)" % (tf.KERNEL_SHAPES, mask1, decomp_length))
    if not (acc_q.is_contiguous() and p.is_contiguous()
            and key_row.is_contiguous()):
        raise ValueError("lanes_step takes contiguous tensors")
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    from ..kernels import build
    fn = build.entry("lanes_step")
    bsz = acc_q.shape[0]
    out = torch.empty_like(acc_q)
    # scratch: the int8 limbs of the forward transforms, slot-major, and
    # the MAC's output channels (lo, and hi in the exact form)
    limbs = torch.empty((tf.L, bsz, key_row.shape[1]), dtype=torch.int8,
                        device=acc_q.device)
    n_channels = 1 if rounded else 2
    chan = torch.empty((bsz, n_channels, mask1, tf.L, tf.R),
                       dtype=torch.int32, device=acc_q.device)
    stream = torch.cuda.current_stream(acc_q.device).cuda_stream
    code = fn(acc_q.data_ptr(), out.data_ptr(), p.data_ptr(),
              key_row.data_ptr(), limbs.data_ptr(), chan.data_ptr(), bsz,
              mask1, decomp_length, int(offset) & 0xFFFFFFFF, int(log2_base),
              int(rounded), int(grids), acc_q.device.index, stream)
    build.check("lanes_step", code)
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
