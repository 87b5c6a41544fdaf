"""Torus32 numerics.

The plaintext/ciphertext scalar domain is the discretized torus T = R/Z,
represented as 32-bit integers ("Torus32"): the int32 value ``x`` stands for
the real number ``x / 2^32 mod 1``.  All torus arithmetic is plain int32
wraparound arithmetic.

Mirrors ``nufhe_tpu/numeric.py`` (numpy, no framework), plus the torch
helpers the port needs to keep int32 wraparound well defined.
"""

import numpy as np
import torch

Torus32 = np.int32
Int32 = np.int32
ErrorFloat = np.float32


def phase_to_t32(phase, mspace_size: int):
    """Torus32 encoding of ``phase / mspace_size``.

    Reference: ``nufhe/numeric_functions.py:30-31``.
    """
    value = (int(phase) % mspace_size) * (2**32 // mspace_size)
    return np.array(value % 2**32, np.uint32).view(Torus32)[()]


def double_to_t32(d):
    """Fractional part of float(s) ``d`` as Torus32.

    Reference: ``nufhe/numeric_functions.py:39-40``.  The cast is performed
    through int64 with an explicit mod 2^32 so the wraparound semantics are
    well-defined for the full (-1, 1) fractional range.
    """
    d = np.asarray(d)
    frac = d - np.trunc(d)
    as_int = (frac * 2.0**32).astype(np.int64)
    return (as_int & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32).astype(Torus32)


def t32_to_phase_ref(phase, mspace_size: int):
    """Modulus switch: nearest multiple of 1/mspace_size, as an integer phase
    in ``[0, mspace_size)``.

    Reference kernel semantics: ``nufhe/numeric_functions_cpu.py:23-37``:
    ``((phase_u32 + interval/2) // interval)`` with ``interval = 2^32 / mspace``.
    """
    interv = np.uint32(2**32 // mspace_size)
    half = np.uint32(interv // 2)
    phase_u = np.asarray(phase).astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    return (((phase_u + half) % (2**32)) // interv).astype(Int32)


_1s8 = phase_to_t32(1, 8)


def bool_to_t32(bit):
    """Encode plaintext bit(s) as mu = +-1/8.  Reference: api_low_level.py:256-258."""
    bit = np.asarray(bit)
    return np.where(bit.astype(bool), Torus32(_1s8), Torus32(-_1s8)).astype(Torus32)


def t32_to_bool(mu):
    """Decode torus phase sign into a bit.  Reference: api_low_level.py:261-263."""
    return np.asarray(mu) > 0


def wrap_i32(x):
    """Reduce an integer tensor mod 2^32 into int32 (two's complement).

    Torch int32 arithmetic wraps on every backend in practice, but the port
    does its sums in int64 and wraps explicitly so that the result does not
    rest on C++ signed overflow."""
    x = x.to(torch.int64)
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)
