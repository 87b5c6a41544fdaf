"""Encrypted integer operators (``nufhe_tpu/models/integer.py``'s
counterpart).

``uint_min`` and the bit<->uint helpers mirror the reference
(``nufhe/operators_integer.py``); the adders, the multiplier, the
comparators, the signed family and the divider extend it, gate for gate as
the JAX package builds them, so the same inputs give the same ciphertexts.

Integers are big-endian bit arrays (index 0 = MSB), one ciphertext bit per
encrypted bit, with a leading batch axis.  Every circuit runs its gates on
``device`` (``None``: the device of its result).
"""

import numpy as np
import torch

from ..api import empty_ciphertext
from .gates import (
    gate_constant, gate_xnor, gate_xor, gate_and, gate_andyn, gate_or,
    gate_not, gate_copy, gate_mux)

# Ripple vs Kogge-Stone auto-selection (``parallel=None``): the JAX
# package's rule, kept as it is so that both packages pick the same circuit
# and so give the same ciphertexts.  The H100's own crossover is measured
# by ``chip_smoke.py`` (PERF.md); the rule is not retuned for it.
_FLAT_LANES = 128


def _auto_parallel(batch_lanes, width):
    """True (Kogge-Stone) when the folded batch*width gate calls are at
    most 64 bits (``batch_lanes * width * 2 <= 128``), else False (ripple,
    the fewest bootstraps)."""
    return batch_lanes * width * 2 <= _FLAT_LANES


def _resolve_parallel(parallel, x):
    if parallel is not None:
        return parallel
    width = x.shape[-1]
    batch_lanes = int(np.prod(x.shape[:-1])) if x.shape[:-1] else 1
    return _auto_parallel(batch_lanes, width)


def _device(device, answer):
    return answer.device if device is None else torch.device(device)


def _uint_to_bits(x, bitsize):
    return np.array([((int(x) >> i) & 1 != 0) for i in reversed(range(bitsize))])


def _bits_to_uint(bits, dtype):
    int_answer = 0
    for i in range(bits.size):
        int_answer = int_answer | (int(bits[i]) << (bits.size - i - 1))
    return dtype(int_answer)


def uintarray_to_bitarray(xs, itemsize=None):
    """Unsigned integer array -> big-endian bit array (extra trailing axis)."""
    xs = np.asarray(xs)
    if itemsize is None:
        itemsize = xs.itemsize * 8
    if not np.issubdtype(xs.dtype, np.unsignedinteger):
        raise TypeError("expected unsigned integers, got %s" % xs.dtype)
    res = np.vstack([_uint_to_bits(x, itemsize) for x in xs.flatten()])
    return res.reshape(xs.shape + (itemsize,))


def bitarray_to_uintarray(xs):
    """Big-endian bit array -> unsigned integer array (drops last axis).
    Widths that are not a power-of-two byte size use the next wider dtype."""
    xs = np.asarray(xs)
    itemsize = xs.shape[-1]
    dtype = next((dt for width, dt in ((8, np.uint8), (16, np.uint16),
                                       (32, np.uint32), (64, np.uint64))
                  if itemsize <= width), None)
    if dtype is None:
        raise ValueError("bit width %d exceeds 64" % itemsize)
    flat = xs.reshape(-1, itemsize)
    ints = [_bits_to_uint(flat[j], dtype) for j in range(flat.shape[0])]
    return np.array(ints).reshape(xs.shape[:-1])


def intarray_to_bitarray(xs, itemsize=None):
    """Signed integer array -> big-endian two's-complement bit array."""
    xs = np.asarray(xs)
    if itemsize is None:
        itemsize = xs.itemsize * 8
    if not np.issubdtype(xs.dtype, np.signedinteger):
        raise TypeError("expected signed integers, got %s" % xs.dtype)
    mod = 1 << itemsize
    flat = [_uint_to_bits(int(x) % mod, itemsize) for x in xs.flatten()]
    return np.vstack(flat).reshape(xs.shape + (itemsize,))


def bitarray_to_intarray(xs):
    """Big-endian two's-complement bit array -> signed integer array."""
    xs = np.asarray(xs)
    itemsize = xs.shape[-1]
    dtype = next((dt for width, dt in ((8, np.int8), (16, np.int16),
                                       (32, np.int32), (64, np.int64))
                  if itemsize <= width), None)
    if dtype is None:
        raise ValueError("bit width %d exceeds 64" % itemsize)
    half, mod = 1 << (itemsize - 1), 1 << itemsize
    flat = xs.reshape(-1, itemsize)
    ints = [int(_bits_to_uint(flat[j], np.uint64)) for j in range(flat.shape[0])]
    return np.array([v - mod if v >= half else v for v in ints],
                    dtype).reshape(xs.shape[:-1])


def _kogge_stone(cloud_key, G, P, device, keep_last_p=False, perf_params=None):
    """In-place Kogge-Stone inclusive scan of (generate, propagate) pairs.

    On entry ``G[..., i]`` / ``P[..., i]`` hold the per-bit generate /
    propagate values (big-endian: index 0 = MSB).  On exit ``G[..., i]``
    is the combined generate over indices ``i..w-1`` (i.e. over bit
    position ``i`` and everything less significant), and ``P[..., i]``
    the combined propagate (only if ``keep_last_p``; otherwise the last
    level skips the propagate update because no later level reads it).

    The combine is ``G' = P_hi ? G_lo : G_hi`` — a single bootstrapped
    MUX, valid because propagate excludes generate (``p=1 -> g=0``, an
    invariant the combine preserves) — and ``P' = P_hi AND P_lo``.  Each
    of the ``ceil(log2 w)`` levels is ONE batched MUX call (+ one batched
    AND), every bit position in the batch of the same bootstrap.
    """
    params = cloud_key.params
    w = G.shape[-1]
    d = 1
    while d < w:
        m = w - d
        tg = empty_ciphertext(params, G.shape[:-1] + (m,), device)
        gate_mux(cloud_key, tg, P[..., :m], G[..., d:], G[..., :m], device,
                 perf_params=perf_params)
        if keep_last_p or 2 * d < w:
            tp = empty_ciphertext(params, P.shape[:-1] + (m,), device)
            gate_and(cloud_key, tp, P[..., :m], P[..., d:], device,
                     perf_params=perf_params)
            P[..., :m] = tp
        G[..., :m] = tg
        d *= 2


def _compare_ladder(cloud_key, x, y, device, parallel=None, perf_params=None):
    """Comparison carry: returns an encrypted bit = [x > y].

    ``parallel=False``: bit-serial XNOR+MUX ladder (as in ``uint_min``) —
    at the highest differing bit position the carry becomes x_i; if all
    bits are equal it stays 0.  2w+1 dependent gate calls, 3w bootstraps.

    ``parallel=True``: the comparison is an associative scan over
    (gt, eq) pairs — ``gt' = eq_hi ? gt_lo : gt_hi`` — i.e. exactly the
    Kogge-Stone carry structure with generate=gt and propagate=eq.
    2 + ceil(log2 w) dependent batched calls (more total bootstrapped
    bits, all folded into the batch).
    """
    params = cloud_key.params
    itemsize = x.shape[-1]
    parallel = _resolve_parallel(parallel, x)
    if parallel:
        gt = empty_ciphertext(params, x.shape[:-1] + (itemsize,), device)
        eq = empty_ciphertext(params, x.shape[:-1] + (itemsize,), device)
        gate_andyn(cloud_key, gt, x, y, device, perf_params=perf_params)
        gate_xnor(cloud_key, eq, x, y, device, perf_params=perf_params)
        _kogge_stone(cloud_key, gt, eq, device, perf_params=perf_params)
        return gt[..., 0:1]
    carry = empty_ciphertext(params, x.shape[:-1] + (1,), device)
    tmp = empty_ciphertext(params, x.shape[:-1] + (1,), device)
    gate_constant(cloud_key, carry, False, device)
    for i in reversed(range(itemsize)):
        x_slice = x[..., i:i + 1]
        y_slice = y[..., i:i + 1]
        gate_xnor(cloud_key, tmp, x_slice, y_slice, device,
                  perf_params=perf_params)
        gate_mux(cloud_key, carry, tmp, carry, x_slice, device,
                 perf_params=perf_params)
    return carry


def uint_min(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """Encrypted minimum of two unsigned integers (big-endian bit arrays).

    The reference's example composite circuit: a comparator ladder, then a
    final MUX selecting the smaller operand (``parallel`` selects the
    log-depth comparator; see ``_compare_ladder``).
    Reference: ``nufhe/operators_integer.py:64-95``.
    """
    device = _device(device, answer)
    carry = _compare_ladder(cloud_key, a, b, device, parallel=parallel,
                            perf_params=perf_params)
    # carry == 0 -> a is not greater: answer = carry ? b : a
    gate_mux(cloud_key, answer, carry, b, a, device, perf_params=perf_params)
    return answer


def uint_max(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """Encrypted maximum of two unsigned integers (big-endian bit arrays):
    the same comparison ladder as ``uint_min`` with the final selection
    flipped."""
    device = _device(device, answer)
    carry = _compare_ladder(cloud_key, a, b, device, parallel=parallel,
                            perf_params=perf_params)
    # carry == 1 -> a > b: answer = carry ? a : b
    gate_mux(cloud_key, answer, carry, a, b, device, perf_params=perf_params)
    return answer


def uint_gt(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """answer = encrypted bit [a > b] (shape (..., 1))."""
    device = _device(device, answer)
    carry = _compare_ladder(cloud_key, a, b, device, parallel=parallel,
                            perf_params=perf_params)
    gate_copy(cloud_key, answer, carry, device)
    return answer


def uint_lt(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """answer = encrypted bit [a < b] (shape (..., 1))."""
    device = _device(device, answer)
    carry = _compare_ladder(cloud_key, b, a, device, parallel=parallel,
                            perf_params=perf_params)
    gate_copy(cloud_key, answer, carry, device)
    return answer


def uint_eq(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """answer = encrypted bit [a == b] (shape (..., 1)): tree AND-reduction
    of per-bit XNORs — one batched XNOR plus ceil(log2 w) batched ANDs
    (same bootstrap count as a sequential chain, log depth).  Already
    log-depth; ``parallel`` is accepted for signature uniformity with the
    other circuits and ignored."""
    device = _device(device, answer)
    params = cloud_key.params
    width = a.shape[-1]
    acc = empty_ciphertext(params, a.shape[:-1] + (width,), device)
    gate_xnor(cloud_key, acc, a, b, device, perf_params=perf_params)
    while width > 1:
        h = width // 2
        t = empty_ciphertext(params, a.shape[:-1] + (h,), device)
        gate_and(cloud_key, t, acc[..., :h], acc[..., h:2 * h], device,
                 perf_params=perf_params)
        acc[..., :h] = t
        if width % 2:  # odd element out: carry it into the next round
            acc[..., h:h + 1] = acc[..., width - 1:width]
        width = h + (width % 2)
    gate_copy(cloud_key, answer, acc[..., 0:1], device)
    return answer


def _uint_add_parallel(cloud_key, answer, a, b, device, perf_params=None):
    """Kogge-Stone addition (mod 2^w): 2 + 2*ceil(log2 w) dependent
    batched gate calls (the last scan level skips its propagate AND) vs
    the ripple adder's 3w sequential ones.

    carry into bit i = combined generate over the lower bits; the scan
    runs on (g = a AND b, p = a XOR b) and the sum is p XOR carry.
    """
    params = cloud_key.params
    w = answer.shape[-1]
    p0 = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    gate_xor(cloud_key, p0, a, b, device, perf_params=perf_params)
    if w == 1:
        answer[...] = p0      # single-bit add mod 2 is XOR
        return answer
    G = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    gate_and(cloud_key, G, a, b, device, perf_params=perf_params)
    P = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    P[...] = p0
    _kogge_stone(cloud_key, G, P, device, perf_params=perf_params)
    # carry into index i (< w-1) is G[..., i+1]; carry into the LSB is 0.
    s = empty_ciphertext(params, a.shape[:-1] + (w - 1,), device)
    gate_xor(cloud_key, s, p0[..., :w - 1], G[..., 1:], device,
             perf_params=perf_params)
    answer[..., :w - 1] = s
    answer[..., w - 1:w] = p0[..., w - 1:w]
    return answer


def _uint_sub_parallel(cloud_key, answer, a, b, device, perf_params=None):
    """Kogge-Stone subtraction a - b = a + NOT(b) + 1 (mod 2^w).

    Per-bit pairs are g = a AND NOT b, p = XNOR(a, b); the carry-in of 1
    turns the carry into bit i into (G OR P) over the lower bits.
    """
    params = cloud_key.params
    w = answer.shape[-1]
    p0 = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    gate_xnor(cloud_key, p0, a, b, device, perf_params=perf_params)
    if w == 1:
        gate_xor(cloud_key, answer, a, b, device, perf_params=perf_params)
        return answer
    G = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    gate_andyn(cloud_key, G, a, b, device, perf_params=perf_params)
    P = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    P[...] = p0
    _kogge_stone(cloud_key, G, P, device, keep_last_p=True,
                 perf_params=perf_params)
    c = empty_ciphertext(params, a.shape[:-1] + (w - 1,), device)
    gate_or(cloud_key, c, G[..., 1:], P[..., 1:], device,
            perf_params=perf_params)
    s = empty_ciphertext(params, a.shape[:-1] + (w - 1,), device)
    gate_xor(cloud_key, s, p0[..., :w - 1], c, device, perf_params=perf_params)
    answer[..., :w - 1] = s
    t = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    gate_not(cloud_key, t, p0[..., w - 1:w], device, perf_params=perf_params)
    answer[..., w - 1:w] = t
    return answer


def uint_add(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """Encrypted addition (mod 2^itemsize).

    ``parallel=False``: ripple carry, LSB to MSB —
        sum_i   = a_i XOR b_i XOR carry
        carry'  = (a_i XOR b_i) ? carry : a_i      (majority via MUX)
    — two bootstrapped gates plus one double-bootstrap MUX per bit: 3w
    dependent gate calls, the lowest total bootstrap count.

    ``parallel=True``: Kogge-Stone carry-lookahead — O(log2 w) dependent
    batched gate calls (each folding all bit positions into the batch),
    ~3x the bootstrapped bits.  ``parallel=None`` picks by
    ``_auto_parallel``.
    """
    device = _device(device, answer)
    if _resolve_parallel(parallel, a):
        return _uint_add_parallel(cloud_key, answer, a, b, device,
                                  perf_params=perf_params)
    params = cloud_key.params
    itemsize = answer.shape[-1]

    p = empty_ciphertext(params, a.shape[:-1] + (1,), device)  # a_i XOR b_i
    s = empty_ciphertext(params, a.shape[:-1] + (1,), device)  # sum bit
    carry = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    gate_constant(cloud_key, carry, False, device)

    for i in reversed(range(itemsize)):  # LSB (last index) to MSB
        a_slice = a[..., i:i + 1]
        b_slice = b[..., i:i + 1]
        gate_xor(cloud_key, p, a_slice, b_slice, device,
                 perf_params=perf_params)
        gate_xor(cloud_key, s, p, carry, device, perf_params=perf_params)
        answer[..., i:i + 1] = s
        # carry_out = p ? carry : a_i
        gate_mux(cloud_key, carry, p, carry, a_slice, device,
                 perf_params=perf_params)
    return answer


def uint_sub(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """Encrypted subtraction a - b (mod 2^itemsize): a + NOT(b) with
    carry-in 1.

    ``parallel=False``: ripple — per bit p = a XOR NOT(b) = XNOR(a, b);
    sum = p XOR carry; carry' = p ? carry : a_i.
    ``parallel=True``: Kogge-Stone carry-lookahead (see ``uint_add``).
    """
    device = _device(device, answer)
    if _resolve_parallel(parallel, a):
        return _uint_sub_parallel(cloud_key, answer, a, b, device,
                                  perf_params=perf_params)
    params = cloud_key.params
    itemsize = answer.shape[-1]

    p = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    s = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    carry = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    gate_constant(cloud_key, carry, True, device)

    for i in reversed(range(itemsize)):  # LSB (last index) to MSB
        a_slice = a[..., i:i + 1]
        b_slice = b[..., i:i + 1]
        gate_xnor(cloud_key, p, a_slice, b_slice, device,
                  perf_params=perf_params)
        gate_xor(cloud_key, s, p, carry, device, perf_params=perf_params)
        answer[..., i:i + 1] = s
        gate_mux(cloud_key, carry, p, carry, a_slice, device,
                 perf_params=perf_params)
    return answer


def uint_mul(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """Encrypted multiplication a * b (mod 2^itemsize): shift-and-add.

    For each bit j of ``b`` (LSB first) one batched AND masks the shifted
    operand a << j (the single b bit broadcasts over the w-j surviving
    product bits), which an adder accumulates into the top w-j bits of
    the result; carries past the MSB drop (mod 2^w).  Gate count with the
    ripple adder: w batched ANDs + ~3/2 w^2 single-bit bootstrapped
    gates; ``parallel=True`` swaps in the Kogge-Stone adder per partial
    product, cutting the dependent-call depth from O(w^2) to O(w log w).
    """
    device = _device(device, answer)
    params = cloud_key.params
    w = answer.shape[-1]
    parallel = _resolve_parallel(parallel, a)

    acc = empty_ciphertext(params, answer.shape, device)
    p = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    s = empty_ciphertext(params, a.shape[:-1] + (1,), device)
    carry = empty_ciphertext(params, a.shape[:-1] + (1,), device)

    # j = 0: acc = a AND b_lsb (no adder needed on a zero accumulator)
    gate_and(cloud_key, acc, a, b[..., w - 1:w], device,
             perf_params=perf_params)

    for j in range(1, w):  # b bit at LSB offset j = array index w-1-j
        width = w - j
        masked = empty_ciphertext(params, a.shape[:-1] + (width,), device)
        gate_and(cloud_key, masked, a[..., j:], b[..., w - 1 - j:w - j],
                 device, perf_params=perf_params)
        # acc[..., :width] += masked, LSB (index width-1) up to the MSB
        if parallel:
            t = empty_ciphertext(params, a.shape[:-1] + (width,), device)
            _uint_add_parallel(cloud_key, t, acc[..., :width], masked,
                               device, perf_params=perf_params)
            acc[..., :width] = t
            continue
        gate_constant(cloud_key, carry, False, device)
        for i in reversed(range(width)):
            acc_i = acc[..., i:i + 1]
            gate_xor(cloud_key, p, acc_i, masked[..., i:i + 1], device,
                     perf_params=perf_params)
            gate_xor(cloud_key, s, p, carry, device, perf_params=perf_params)
            if i > 0:  # carry out of the MSB is dropped
                # carry' = p ? carry : acc_i — BEFORE acc_i is overwritten
                gate_mux(cloud_key, carry, p, carry, acc_i, device,
                         perf_params=perf_params)
            acc[..., i:i + 1] = s
    gate_copy(cloud_key, answer, acc, device)
    return answer


# --- signed (two's complement) operators ---
#
# Big-endian bit arrays like the uint family, index 0 = sign bit.
# Addition/subtraction/equality are representation-identical to the
# unsigned circuits; comparisons reduce to the unsigned ones by flipping
# both sign bits (x -> x XOR 2^(w-1) maps signed order to unsigned
# order), which is a linear NOT — no extra bootstraps.

def _flip_msb(cloud_key, x, device, perf_params=None):
    """A copy of ``x`` with the sign bit negated (linear, unbootstrapped)."""
    params = cloud_key.params
    out = empty_ciphertext(params, x.shape, device)
    out[...] = x
    t = empty_ciphertext(params, x.shape[:-1] + (1,), device)
    gate_not(cloud_key, t, x[..., 0:1], device, perf_params=perf_params)
    out[..., 0:1] = t
    return out


def int_add(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """Signed addition (mod 2^w): two's complement makes this the same
    circuit as ``uint_add``."""
    return uint_add(cloud_key, answer, a, b, parallel=parallel,
                    perf_params=perf_params, device=device)


def int_sub(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """Signed subtraction (mod 2^w): identical to ``uint_sub``."""
    return uint_sub(cloud_key, answer, a, b, parallel=parallel,
                    perf_params=perf_params, device=device)


def int_eq(cloud_key, answer, a, b, parallel=None, perf_params=None,
           device=None):
    """Signed equality: identical to ``uint_eq``."""
    return uint_eq(cloud_key, answer, a, b, perf_params=perf_params,
                   device=device)


def int_gt(cloud_key, answer, a, b, parallel=None, perf_params=None,
           device=None):
    """answer = encrypted bit [a > b], signed (shape (..., 1))."""
    device = _device(device, answer)
    fa = _flip_msb(cloud_key, a, device, perf_params=perf_params)
    fb = _flip_msb(cloud_key, b, device, perf_params=perf_params)
    return uint_gt(cloud_key, answer, fa, fb, parallel=parallel,
                   perf_params=perf_params, device=device)


def int_lt(cloud_key, answer, a, b, parallel=None, perf_params=None,
           device=None):
    """answer = encrypted bit [a < b], signed (shape (..., 1))."""
    device = _device(device, answer)
    fa = _flip_msb(cloud_key, a, device, perf_params=perf_params)
    fb = _flip_msb(cloud_key, b, device, perf_params=perf_params)
    return uint_lt(cloud_key, answer, fa, fb, parallel=parallel,
                   perf_params=perf_params, device=device)


def int_min(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """Signed minimum: the unsigned comparator ladder on sign-flipped
    operands selects between the ORIGINAL operands."""
    device = _device(device, answer)
    fa = _flip_msb(cloud_key, a, device, perf_params=perf_params)
    fb = _flip_msb(cloud_key, b, device, perf_params=perf_params)
    carry = _compare_ladder(cloud_key, fa, fb, device, parallel=parallel,
                            perf_params=perf_params)
    gate_mux(cloud_key, answer, carry, b, a, device, perf_params=perf_params)
    return answer


def int_max(cloud_key, answer, a, b, parallel=None, perf_params=None,
            device=None):
    """Signed maximum (see ``int_min``)."""
    device = _device(device, answer)
    fa = _flip_msb(cloud_key, a, device, perf_params=perf_params)
    fb = _flip_msb(cloud_key, b, device, perf_params=perf_params)
    carry = _compare_ladder(cloud_key, fa, fb, device, parallel=parallel,
                            perf_params=perf_params)
    gate_mux(cloud_key, answer, carry, a, b, device, perf_params=perf_params)
    return answer


def int_neg(cloud_key, answer, a, perf_params=None, device=None):
    """answer = -a (two's complement, mod 2^w): NOT(a) + 1.

    The bit flip is linear (no bootstrap); the +1 carry into bit i is
    the AND of all lower flipped bits, computed by a log-depth suffix-AND
    scan — ceil(log2 w) batched ANDs plus one batched XOR.  The LSB of
    -a equals the LSB of a (copied, no gate).
    """
    device = _device(device, answer)
    params = cloud_key.params
    w = answer.shape[-1]
    if w == 1:
        answer[...] = a           # -a == a mod 2
        return answer
    p0 = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    gate_not(cloud_key, p0, a, device, perf_params=perf_params)
    P = empty_ciphertext(params, a.shape[:-1] + (w,), device)
    P[...] = p0
    d = 1
    while d < w:
        m = w - d
        tp = empty_ciphertext(params, a.shape[:-1] + (m,), device)
        gate_and(cloud_key, tp, P[..., :m], P[..., d:], device,
                 perf_params=perf_params)
        P[..., :m] = tp
        d *= 2
    s = empty_ciphertext(params, a.shape[:-1] + (w - 1,), device)
    gate_xor(cloud_key, s, p0[..., :w - 1], P[..., 1:], device,
             perf_params=perf_params)
    answer[..., :w - 1] = s
    answer[..., w - 1:w] = a[..., w - 1:w]
    return answer


def uint_divmod(cloud_key, quotient, remainder, a, b, parallel=None,
                perf_params=None, device=None):
    """Encrypted restoring division: quotient = a // b, remainder = a % b.

    Classic MSB-first restoring division over a (w+1)-bit working
    remainder: shift in the next dividend bit, compare against the
    divisor, subtract where it fits (the quotient bit), keep the smaller
    remainder via MUX.  ``parallel`` selects the log-depth comparator and
    subtractor per iteration.  Division by an encrypted zero yields
    quotient 2^w - 1 and remainder = a (the circuit's natural fixed
    point; there is no exception channel inside FHE).
    """
    device = _device(device, quotient)
    params = cloud_key.params
    w = quotient.shape[-1]

    rem = empty_ciphertext(params, a.shape[:-1] + (w + 1,), device)
    gate_constant(cloud_key, rem, False, device)
    b_ext = empty_ciphertext(params, a.shape[:-1] + (w + 1,), device)
    gate_constant(cloud_key, b_ext, False, device)
    b_ext[..., 1:] = b

    for i in range(w):  # MSB first
        rem2 = empty_ciphertext(params, a.shape[:-1] + (w + 1,), device)
        rem2[..., :w] = rem[..., 1:]
        rem2[..., w:w + 1] = a[..., i:i + 1]
        # [rem2 < b] -> quotient bit is its negation (linear NOT)
        lt = _compare_ladder(cloud_key, b_ext, rem2, device,
                             parallel=parallel, perf_params=perf_params)
        qb = empty_ciphertext(params, a.shape[:-1] + (1,), device)
        gate_not(cloud_key, qb, lt, device, perf_params=perf_params)
        quotient[..., i:i + 1] = qb
        diff = empty_ciphertext(params, a.shape[:-1] + (w + 1,), device)
        uint_sub(cloud_key, diff, rem2, b_ext, parallel=parallel,
                 perf_params=perf_params, device=device)
        newrem = empty_ciphertext(params, a.shape[:-1] + (w + 1,), device)
        gate_mux(cloud_key, newrem, qb, diff, rem2, device,
                 perf_params=perf_params)
        rem = newrem
    remainder[...] = rem[..., 1:]
    return quotient, remainder


def uint_div(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """answer = a // b (see ``uint_divmod`` for the b == 0 convention)."""
    scratch = empty_ciphertext(cloud_key.params, answer.shape,
                               _device(device, answer))
    uint_divmod(cloud_key, answer, scratch, a, b, parallel=parallel,
                perf_params=perf_params, device=device)
    return answer


def uint_mod(cloud_key, answer, a, b, parallel=None, perf_params=None,
             device=None):
    """answer = a % b (see ``uint_divmod`` for the b == 0 convention)."""
    scratch = empty_ciphertext(cloud_key.params, answer.shape,
                               _device(device, answer))
    uint_divmod(cloud_key, scratch, answer, a, b, parallel=parallel,
                perf_params=perf_params, device=device)
    return answer
