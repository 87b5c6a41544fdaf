"""One CMUX step of the blind rotation: kernel K1's wrapper and its plain
PyTorch version.

    acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]

negacyclic in Z[X]/(N=1024), mod 2^32 — the function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step_rows`` (over
``ops/rows_engine.external_step``), in the port's own layout:

- ``acc``: (B, mask1, N) int32, batch-major;
- ``p``: (B,) int32 in [0, 2N);
- ``key_row``: one step of the rows engine's key in its device's form
  (``ops/key_rows.key_form``).  On the CPU, and for the plain version on
  any device, a row of ``ops/transform.bootstrap_key_transformed``, int64:
  (G = mask1*l, O = mask1, L, R) for the exact engine, or (2, G, O, L, R)
  for the rounded-key engine, whose MAC reads side 1 on the terms that
  wrap around the negacyclic convolution.  On CUDA the row's int8 limb
  rows (``ops/key_rows``), prepared with the key, which the kernel reads.
  The shape selects the form; the accumulator gives mask1 and the key G =
  mask1*l.  The kernel is built for the (mask1, l) pairs of
  ``ops/transform.KERNEL_SHAPES``, and the wrapper raises on any other.
"""

import ctypes
import functools

import torch

from ..numeric import wrap_i32
from . import key_rows as kr
from . import transform as tf

# launches of the CUDA kernel (not of the plain version), and those of
# them that ran as clusters of two blocks (:func:`cluster_size`)
launches = 0
paired_launches = 0


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


def check_step(name, acc, p, key_row, shape=None):
    """The inputs of a step-shaped launch (K1, K5, K8, K9, K10): ``acc``
    (:func:`check_acc`), int32 powers ``p`` (B,) and one step's key in its
    device's form (``key_rows.key_form``) with O = mask1, on one device;
    (mask1, l) = ``shape`` for a kernel built for that one.  Returns
    (rounded, mask1, l)."""
    mask1 = check_acc(acc, name)
    if p.dtype != torch.int32:
        raise TypeError("%s takes int32 powers" % name)
    if p.shape != (acc.shape[0],):
        raise ValueError("p must be (B,), got %s" % (tuple(p.shape),))
    if not (acc.device == p.device == key_row.device):
        raise ValueError("acc, p and key row must be on one device")
    return check_shape(name, kr.key_form(key_row, (), name, mask1), shape)


def check_shape(name, form, shape):
    """``form`` (rounded, mask1, l), with (mask1, l) = ``shape`` unless it
    is None."""
    if shape is not None and form[1:] != shape:
        raise ValueError("%s takes (mask1, l) = %s, got %s"
                         % (name, shape, form[1:]))
    return form


def launch(entry, acc, x, rows, args, *, offset, log2_base, rounded=None,
           out_polys=None):
    """Launch the K1/K3-family CUDA entry ``entry`` (``kernels/build.py``) on
    CUDA tensors: (acc, out, x, rows, B, *args, offset, log2_base[,
    rounded], device, stream), where ``x`` is a step's powers p (K1, K5,
    K8-K10) or the rotation amounts bara_t (K3, K6, K11, K12), ``rows``
    the key rows that the launch reads (checked by ``key_rows.key_form``)
    and ``args`` the entry's own integers; ``rounded`` None for an entry of
    the exact form alone (K5, K8), which takes no form argument.  Returns
    the output: like ``acc``, or (B, out_polys, N) int32."""
    if not (acc.is_contiguous() and x.is_contiguous()):
        raise ValueError("%s takes contiguous tensors" % entry)
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    from ..kernels import build
    fn = build.entry(entry)
    out = torch.empty_like(acc) if out_polys is None else torch.empty(
        (acc.shape[0], out_polys, tf.N), dtype=torch.int32, device=acc.device)
    form = () if rounded is None else (int(rounded),)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    code = fn(acc.data_ptr(), out.data_ptr(), x.data_ptr(), rows.data_ptr(),
              acc.shape[0], *args, int(offset) & 0xFFFFFFFF, int(log2_base),
              *form, acc.device.index, stream)
    build.check(entry, code)
    return out


@functools.lru_cache(maxsize=None)
def cluster_size(entry, mask1, decomp_length):
    """Blocks a cluster of the K1/K3 entry ``entry`` (``cmux_step``,
    ``blind_rotate_chunk``) at (mask1, l), as its launcher chooses them
    (``<entry>_cluster`` in the entry's library): 2 where a block holds two
    samples and the pair of blocks shares its MAC, else 1."""
    from ..kernels import build
    return build.function(entry, entry + "_cluster",
                          [ctypes.c_int, ctypes.c_int])(mask1, decomp_length)


def cmux_step(acc, p, key_row, *, offset, log2_base):
    """K1: one CMUX step.  A CUDA tensor runs the kernel on the key row's
    int8 rows; a CPU tensor the plain version on its int64 row
    (``key_rows.key_form``).  Returns a new tensor."""
    global launches, paired_launches
    rounded, mask1, decomp_length = check_step("cmux_step", acc, p, key_row)
    if acc.device.type == 'cpu':
        return cmux_step_plain(acc, p, key_row, offset=offset,
                               log2_base=log2_base)
    out = launch("cmux_step", acc, p, key_row, (mask1, decomp_length),
                 offset=offset, log2_base=log2_base, rounded=rounded)
    launches += 1
    paired_launches += cluster_size("cmux_step", mask1, decomp_length) > 1
    return out
