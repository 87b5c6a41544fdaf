"""One CMUX step in the lanes layout: kernel K4's wrapper, and the blind
rotation over it.

The function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step`` (its body is
``ops/flat_engine.external_step``), on the JAX package's layout and key
operand:

- ``acc_q``: (B, 2*N) int32, q-layout (``flat_engine.q_from_n``);
- ``p``: (B,) int32 in [0, 2N);
- ``key_row``: one row of ``ops/tgsw.prepare_bootstrap_key_device``,
  (L=64, C=256, Q) int8, Q = 320 exact or 256 rounded; Q selects the form.

:func:`blind_rotate_lanes` is the port of ``blind_rotate_pallas``: n K4
launches.
"""

import torch

from . import flat_engine as fe
from . import transform as tf

# launches of the CUDA kernel (not of the plain version)
launches = 0

MASK1 = 2
DECOMP_LENGTH = 2
C_SIZE = MASK1 * DECOMP_LENGTH * tf.ACC_LIMBS * tf.R      # 256
Q_EXACT = tf.SHIFT_GROUPS * MASK1 * tf.R                  # 320
Q_ROUNDED = tf.SHIFT_GROUPS_APPROX * MASK1 * tf.R         # 256


def lanes_step_plain(acc_q, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K4; any device."""
    return fe.external_step(acc_q, p, key_row, mask1=MASK1,
                            decomp_length=DECOMP_LENGTH, log2_base=log2_base,
                            offset=offset)


def check_key(key, rows_shape, name):
    """``key`` is int8 of shape ``rows_shape`` + (L, C, Q); returns
    whether it is the rounded form (Q = 256)."""
    if key.dtype != torch.int8:
        raise TypeError("%s takes an int8 key" % name)
    tail = tuple(key.shape[len(rows_shape):])
    if tuple(key.shape[:len(rows_shape)]) != tuple(rows_shape) or tail not in (
            (tf.L, C_SIZE, Q_EXACT), (tf.L, C_SIZE, Q_ROUNDED)):
        raise ValueError("%s: key must be %s + (%d, %d, %d or %d), got %s"
                         % (name, tuple(rows_shape), tf.L, C_SIZE, Q_EXACT,
                            Q_ROUNDED, tuple(key.shape)))
    return tail[-1] == Q_ROUNDED


def lanes_step(acc_q, p, key_row, *, offset, log2_base):
    """K4: one CMUX step.  A CUDA tensor runs the kernel; a CPU tensor the
    plain version.  Returns a new tensor."""
    global launches
    if acc_q.dtype != torch.int32:
        raise TypeError("lanes_step takes an int32 accumulator")
    if acc_q.dim() != 2 or acc_q.shape[1] != MASK1 * tf.N:
        raise ValueError("acc_q must be (B, %d), got %s"
                         % (MASK1 * tf.N, tuple(acc_q.shape)))
    rounded = check_key(key_row, (), "lanes_step")
    if p.dtype != torch.int32:
        raise TypeError("lanes_step takes int32 powers")
    if p.shape != (acc_q.shape[0],):
        raise ValueError("p must be (B,), got %s" % (tuple(p.shape),))
    if not (acc_q.device == p.device == key_row.device):
        raise ValueError("acc_q, p and key row must be on one device")
    if acc_q.device.type == 'cpu':
        return lanes_step_plain(acc_q, p, key_row, offset=offset,
                                log2_base=log2_base)
    if acc_q.device.type != 'cuda':
        raise ValueError("lanes_step runs on CUDA or CPU, not %s"
                         % acc_q.device)
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
    limbs = torch.empty((tf.L, bsz, C_SIZE), dtype=torch.int8,
                        device=acc_q.device)
    n_channels = 1 if rounded else 2
    chan = torch.empty((bsz, n_channels, MASK1, tf.L, tf.R),
                       dtype=torch.int32, device=acc_q.device)
    stream = torch.cuda.current_stream(acc_q.device).cuda_stream
    code = fn(acc_q.data_ptr(), out.data_ptr(), p.data_ptr(),
              key_row.data_ptr(), limbs.data_ptr(), chan.data_ptr(), bsz,
              int(offset) & 0xFFFFFFFF, int(log2_base), int(rounded),
              acc_q.device.index, stream)
    build.check("lanes_step", code)
    launches += 1
    return out


def blind_rotate_lanes(acc_q, key, bara_t, *, offset, log2_base):
    """All n steps of the blind rotation, one K4 launch a step.

    :param acc_q: (B, 2*N) int32 q-layout accumulator.
    :param key: (n, L, C, Q) int8 (``ops/tgsw.prepare_bootstrap_key_device``).
    :param bara_t: (n, B) int32 in [0, 2N), one row a step.
    """
    n = bara_t.shape[0]
    check_key(key, (n,), "blind_rotate_lanes")
    for i in range(n):
        acc_q = lanes_step(acc_q, bara_t[i], key[i], offset=offset,
                           log2_base=log2_base)
    return acc_q
