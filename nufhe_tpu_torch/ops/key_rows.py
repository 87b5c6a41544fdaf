"""The blind rotation's key limb rows: the row kernel's wrapper and its
plain PyTorch version.

K1 and K3 (``kernels/csrc/blind_rotate_body.cuh``) run their MAC on the
int8 tensor cores with the key as the A operand: per MAC slot p (frequency
rev6(p)) and (g, o), the two-sided int8 limbs of the key residue
(``ops/transform.key_limbs_host``: [vlo, vhi_0..3, 4*vlo] exact, the 4 vhi
limbs of each stored side rounded) as 64-byte Toeplitz rows, byte 31 - r
the limb of side 0 at rotation r, byte 63 - r that of side 1.  The rows
are prepared once with the key (``keys.BootstrapKey.device``), slot-major,
and the kernels copy a slot's rows into shared memory.

- ``key``: the transformed key of ``ops/transform``, int64, (..., G, O, L,
  R) exact or (..., 2, G, O, L, R) rounded;
- rows: int8 (..., L, G, O, 6, 64) exact or (..., L, G, O, 4, 64)
  rounded, slot p at index p of the L axis.

The rows are the rows engine's key on a CUDA device, the int64 key on the
CPU (:func:`prepare`); :func:`key_form` is the one reader of that choice.
"""

import torch

from . import transform as tf

# preparations of rows: launches of the CUDA kernel (not of the plain
# version)
rows_prepared = 0

_REV6 = torch.tensor([int(format(p, "06b")[::-1], 2) for p in range(tf.L)])


def rows_per_pair(rounded):
    """Limb rows of one (g, o): 6 exact, 4 rounded."""
    return 4 if rounded else 6


def rows_shape(key, rounded):
    """The rows' shape for ``key``, of the given form."""
    lead = tuple(key.shape[:key.dim() - (5 if rounded else 4)])
    g_size, o_size = key.shape[-4:-2]
    return lead + (tf.L, g_size, o_size, rows_per_pair(rounded), 64)


def _limbs(v, rounded):
    """The int8 limbs of residues ``v`` (any int64 representative mod
    2^38) as the row kernel splits them (key_rows.cu), stacked on a new
    third-last axis: exact [vlo, vhi_0..3, 4*vlo], rounded the vhi_0..3 of
    round(v / 64); the 4 balanced radix-2^8 digits of a word are the bytes
    of the word plus 0x80808080, each less 128."""
    if rounded:
        hi = (v + 32) >> 6
    else:
        vlo = ((v + 32) & 63) - 32
        hi = (v - vlo) >> 6
    word = (hi + 0x80808080) & 0xFFFFFFFF
    limbs = [((word >> (8 * q)) & 255) - 128 for q in range(4)]
    if not rounded:
        limbs = [vlo] + limbs + [4 * vlo]
    return torch.stack([x.to(torch.int8) for x in limbs], dim=-3)


def key_rows_plain(key, rounded):
    """Plain PyTorch version of the row kernel; any device."""
    if rounded:
        side0, side1 = key.select(-5, 0), key.select(-5, 1)
    else:
        side0, side1 = key, -key                      # side 1: -v mod 2^38
    # (..., G, O, rows, L, R) a side, byte 31 - r of a row at r
    sides = [_limbs(v, rounded).flip(-1) for v in (side0, side1)]
    rows = torch.cat(sides, dim=-1)           # (..., G, O, rows, L, 64)
    rows = rows.index_select(-2, _REV6.to(key.device))   # slot p: rev6(p)
    return rows.movedim(-2, -5).contiguous()


def key_rows(key, rounded):
    """The rows of ``key``.  A CUDA tensor runs the row kernel, counted in
    ``rows_prepared``; a CPU tensor the plain version."""
    global rows_prepared
    if key.device.type == 'cpu':
        return key_rows_plain(key, rounded)
    if key.device.type != 'cuda':
        raise ValueError("key_rows runs on CUDA or CPU, not %s" % key.device)
    if not key.is_contiguous():
        raise ValueError("key_rows takes a contiguous key")
    rows = torch.empty(rows_shape(key, rounded), dtype=torch.int8,
                       device=key.device)
    g_size, o_size = key.shape[-4:-2]
    steps = rows.numel() // (tf.L * g_size * o_size
                             * rows_per_pair(rounded) * 64)
    from ..kernels import build
    fn = build.entry("key_rows")
    stream = torch.cuda.current_stream(key.device).cuda_stream
    code = fn(key.data_ptr(), rows.data_ptr(), steps, g_size * o_size,
              int(rounded), key.device.index, stream)
    build.check("key_rows", code)
    rows_prepared += 1
    return rows


def prepare(key, rounded):
    """The rows engine's key on ``key``'s device: on a CUDA key its rows,
    by the row kernel (the int64 ``key`` is then the caller's to drop);
    elsewhere ``key`` itself, whose rotation runs the plain steps."""
    return key_rows(key, rounded) if key.device.type == 'cuda' else key


def key_form(key, lead, name, mask1=None):
    """The rows engine's key as a K1/K3-family wrapper takes it, checked:
    on a CUDA device the rows, int8 ``lead`` + (L, G, O, 6, 64) exact or
    ``lead`` + (L, G, O, 4, 64) rounded, contiguous and 16-byte aligned,
    of a (mask1, l) that a kernel instantiates (``transform.KERNEL_SHAPES``);
    on the CPU the int64 key, ``lead`` + (G, O, L, R) exact or ``lead`` +
    (2, G, O, L, R) rounded, of any (mask1, l), which the plain versions
    take.  ``lead`` is (n,) for a whole key, () for one step's row; O
    divides G and is ``mask1`` when given.  Returns (rounded, mask1, l);
    raises for anything else."""
    kind = key.device.type
    if kind not in ('cuda', 'cpu'):
        raise ValueError("%s runs on CUDA or CPU, not %s" % (name, key.device))
    return _read_form(key, lead, name, mask1, kind == 'cuda')


def _read_form(key, lead, name, mask1, rows):
    """:func:`key_form` on any device: the rows if ``rows``, else the int64
    key."""
    if key.dtype != (torch.int8 if rows else torch.int64):
        raise TypeError("%s takes the key as %s, got %s"
                        % (name, "its int8 rows on CUDA" if rows
                           else "int64 on the CPU", key.dtype))
    lead = tuple(lead)
    tail = tuple(key.shape[len(lead):])
    if rows:
        form = "(%d, G, O, 6 or 4, 64)" % tf.L
        ok = len(tail) == 5 and tail[0] == tf.L and tail[3] in (4, 6) \
            and tail[4] == 64
        rounded = ok and tail[3] == 4
        g_size, o_size = tail[1:3] if ok else (0, 0)
    else:
        form = "(G, O, %d, %d) or (2, G, O, %d, %d)" % ((tf.L, tf.R) * 2)
        rounded = len(tail) == 5
        ok = len(tail) in (4, 5) and (not rounded or tail[0] == 2) \
            and tail[-2:] == (tf.L, tf.R)
        g_size, o_size = tail[-4:-2] if ok else (0, 0)
    if tuple(key.shape[:len(lead)]) != lead or not o_size or g_size % o_size \
            or (mask1 is not None and o_size != mask1):
        raise ValueError("%s: key must be %s + %s with O = mask1%s dividing "
                         "G, got %s"
                         % (name, lead, form,
                            "" if mask1 is None else " = %d" % mask1,
                            tuple(key.shape)))
    shape = (o_size, g_size // o_size)
    if rows:
        if not key.is_contiguous() or key.data_ptr() % 16:
            raise ValueError("%s: the key's rows must be contiguous and "
                             "16-byte aligned" % name)
        if shape not in tf.KERNEL_SHAPES:
            raise ValueError("the %s kernel takes (mask1, l) in %s, not %s"
                             % (name, tf.KERNEL_SHAPES, shape))
    return (rounded,) + shape
