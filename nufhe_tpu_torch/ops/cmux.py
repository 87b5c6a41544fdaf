"""One CMUX step of the blind rotation: kernel K1's wrapper and its plain
PyTorch version.

    acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]

negacyclic in Z[X]/(N=1024), mod 2^32 — the function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step_rows`` (over
``ops/rows_engine.external_step``), in the port's own layout:

- ``acc``: (B, mask1, N) int32, batch-major;
- ``p``: (B,) int32 in [0, 2N);
- ``key_row``: one row of ``ops/transform.bootstrap_key_transformed``,
  int64: (G = mask1*l, O = mask1, L, R) for the exact engine, or
  (2, G, O, L, R) for the rounded-key engine, whose MAC reads side 1 on
  the terms that wrap around the negacyclic convolution.  The row's shape
  selects the form; the accumulator gives mask1 and the key G = mask1*l.
  The kernel is built for the (mask1, l) pairs of
  ``ops/transform.KERNEL_SHAPES`` and raises on any other.  It reads the
  row's int8 limb rows (``ops/key_rows``), prepared with the key.
"""

import torch

from ..numeric import wrap_i32
from . import key_rows as kr
from . import transform as tf

# launches of the CUDA kernel (not of the plain version)
launches = 0


def _digits(acc, p, offset, log2_base, decomp_length):
    """Rotation by (X^p - 1) and the signed gadget digits:
    (B, mask1, N) int32 -> (B, mask1*l, N) int64, g = o_in*l + d."""
    bsz, mask1, n = acc.shape
    acc64 = acc.to(torch.int64)
    c = torch.arange(n, device=acc.device)
    src = (c[None, :] - p.to(torch.int64)[:, None]) % (2 * n)      # (B, N)
    sign = torch.where(src >= n, -1, 1)
    src = (src % n)[:, None, :].expand(bsz, mask1, n)
    rot = torch.gather(acc64, 2, src) * sign[:, None, :]
    shifted = (rot - acc64 + offset) & 0xFFFFFFFF                  # u32 value
    base = 1 << log2_base
    digits = [((shifted >> (32 - (d + 1) * log2_base)) & (base - 1)) - base // 2
              for d in range(decomp_length)]
    return torch.stack(digits, dim=2).reshape(bsz, mask1 * decomp_length, n)


def cmux_step_plain(acc, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K1; any device.  The transform-domain MAC is
    a broadcast multiply-sum in int64, reduced mod 2^38 before the
    inverse: |dhat| <= 32 * 2^(log2_base-1) = 2^14 and |key| <= 2^37, so a
    sum of 32 * G products stays below G * 2^56 (2^58.6 at G = 6)."""
    rounded = key_row.dim() == 5
    g_size, o_size = key_row.shape[-4:-2]
    decomp_length = g_size // acc.shape[1]
    dig = _digits(acc, p, int(offset), log2_base, decomp_length)
    dhat = tf.forward(dig)                                   # (B, G, L, R)

    # kexp[g, o, t, k, u] = key[g, o, t, (k - u) % R] * (-1 if u > k), or,
    # rounded, the side-1 value (not negated) where u > k
    k = torch.arange(tf.R, device=acc.device)
    idx = (k[:, None] - k[None, :]) % tf.R
    wrap = k[None, :] > k[:, None]
    if rounded:
        kexp = torch.where(wrap, key_row[1][..., idx], key_row[0][..., idx])
    else:
        kexp = key_row[..., idx] * torch.where(wrap, -1, 1).to(torch.int64)
    out = torch.zeros((acc.shape[0], o_size, tf.L, tf.R), dtype=torch.int64,
                      device=acc.device)
    for u in range(tf.R):
        term = dhat[:, :, None, :, u, None] * kexp[None, ..., u]
        out += term.sum(dim=1)
    out &= (1 << tf.KEY_BITS) - 1
    coeffs = tf.inverse_unscaled(out)                        # (B, O, N)
    delta = (coeffs >> tf.INV_SHIFT) & 0xFFFFFFFF
    return wrap_i32(acc.to(torch.int64) + delta)


def check_acc(acc, name):
    """``acc`` is an int32 (B, mask1, N) accumulator; returns mask1."""
    if acc.dtype != torch.int32:
        raise TypeError("%s takes an int32 accumulator" % name)
    if acc.dim() != 3 or acc.shape[2] != tf.N:
        raise ValueError("acc must be (B, mask1, %d), got %s"
                         % (tf.N, tuple(acc.shape)))
    return acc.shape[1]


def check_key(key, rows_shape, name, mask1=None):
    """``key`` is int64 of shape ``rows_shape`` + one row form, (G, O, L,
    R) exact or (2, G, O, L, R) rounded, with O = mask1 (the
    accumulator's, when given) dividing G; returns whether it is the
    rounded form."""
    if key.dtype != torch.int64:
        raise TypeError("%s takes an int64 key" % name)
    tail = tuple(key.shape[len(rows_shape):])
    rounded = len(tail) == 5
    g_size, o_size = tail[-4:-2] if len(tail) in (4, 5) else (0, 0)
    if tuple(key.shape[:len(rows_shape)]) != tuple(rows_shape) \
            or len(tail) not in (4, 5) or (rounded and tail[0] != 2) \
            or tail[-2:] != (tf.L, tf.R) or not o_size \
            or g_size % o_size or (mask1 is not None and o_size != mask1):
        raise ValueError("%s: key must be %s + (G, O, %d, %d) or (2, G, O, "
                         "%d, %d) with O = mask1%s dividing G, got %s"
                         % (name, tuple(rows_shape), tf.L, tf.R, tf.L, tf.R,
                            "" if mask1 is None else " = %d" % mask1,
                            tuple(key.shape)))
    return rounded


def kernel_shape(key, mask1, name):
    """(mask1, l) of a checked key, for a kernel launch; raises ValueError
    for a pair that no kernel instantiates."""
    decomp_length = key.shape[-4] // mask1
    if (mask1, decomp_length) not in tf.KERNEL_SHAPES:
        raise ValueError("the %s kernel takes (mask1, l) in %s, not (%d, %d)"
                         % (name, tf.KERNEL_SHAPES, mask1, decomp_length))
    return mask1, decomp_length


def cmux_step(acc, p, key_row, *, offset, log2_base, rows=None):
    """K1: one CMUX step.  A CUDA tensor runs the kernel; a CPU tensor the
    plain version.  Returns a new tensor.  ``rows``: the key row's
    prepared rows (``ops/key_rows``), which the kernel reads: required on
    CUDA."""
    global launches
    mask1 = check_acc(acc, "cmux_step")
    rounded = check_key(key_row, (), "cmux_step", mask1)
    if p.dtype != torch.int32:
        raise TypeError("cmux_step takes int32 powers")
    if p.shape != (acc.shape[0],):
        raise ValueError("p must be (B,), got %s" % (tuple(p.shape),))
    if not (acc.device == p.device == key_row.device):
        raise ValueError("acc, p and key row must be on one device")
    if acc.device.type == 'cpu':
        return cmux_step_plain(acc, p, key_row, offset=offset,
                               log2_base=log2_base)
    if acc.device.type != 'cuda':
        raise ValueError("cmux_step runs on CUDA or CPU, not %s" % acc.device)
    if not (acc.is_contiguous() and p.is_contiguous()
            and key_row.is_contiguous()):
        raise ValueError("cmux_step takes contiguous tensors")
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    _, decomp_length = kernel_shape(key_row, mask1, "cmux_step")
    rows = kr.launch_rows(key_row, rounded, rows, None, 1, "cmux_step")
    from ..kernels import build
    fn = build.entry("cmux_step")
    out = torch.empty_like(acc)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    code = fn(acc.data_ptr(), out.data_ptr(), p.data_ptr(), rows.data_ptr(),
              acc.shape[0], mask1, decomp_length, int(offset) & 0xFFFFFFFF,
              int(log2_base), int(rounded), acc.device.index, stream)
    build.check("cmux_step", code)
    launches += 1
    return out
