"""Exact Goldilocks-field NTT oracle (parity with the reference NTT backend).

Mirror of ``nufhe_tpu/ref/ntt_goldilocks.py`` (numpy only).

Re-implements the *mathematics* of the reference CPU NTT
(``nufhe/transform/ntt_cpu.py``, ``nufhe/transform/ntt.py:30-60``): the field
GF(p) with p = 2^64 - 2^32 + 1, the same fixed 2N-th root of unity the
reference GPU kernels use (so u64-domain vectors are comparable), and the
negacyclic twist convention of ``ntt_transform_ref``.

This module is *test-only*: the device path computes the identical results
through the Z/2^32 Nussbaumer engine (see ``transform_ref.py``); these
functions exist to prove that equivalence and to expose the reference's
transformed-domain representation for users who need it.

Arithmetic uses python ints via vectorized object arrays: slow but exact.
"""

import numpy as np

MODULUS = 2**64 - 2**32 + 1
_FACTORS = [2, 3, 5, 17, 257, 65537]  # prime factors of (modulus - 1)

# The fixed generator power the reference GPU kernels use
# (``nufhe/transform/ntt_cpu.py:97-109``).
_GPU_ROOT_BASE = 0xA70DC47E4CBDF43F

# Montgomery constant: inverse of 2^64 mod p (``polynomial_transform_ntt.py:66``).
R_INVERSE = 0xFFFFFFFE00000001


def _pow(x, e):
    return pow(x, e, MODULUS)


def inverse(x):
    return pow(x, MODULUS - 2, MODULUS)


def find_generator(start=2):
    """Smallest generator of GF(p)* at or above ``start``."""
    for w in range(start, MODULUS):
        if all(_pow(w, (MODULUS - 1) // q) != 1 for q in _FACTORS):
            return w


def root_of_unity(n):
    """Root of unity of order n matching the reference GPU tables."""
    assert 2**32 % n == 0
    return _pow(_GPU_ROOT_BASE, 2**32 // n)


def to_field(a):
    """Lift signed ints to GF(p) residues (object array of python ints)."""
    flat = [int(x) % MODULUS for x in np.asarray(a).ravel()]
    out = np.empty(len(flat), object)
    out[:] = flat
    return out.reshape(np.asarray(a).shape)


def field_to_u64(a):
    return np.vectorize(lambda x: np.uint64(x), otypes=[np.uint64])(a)


def field_to_i32(a):
    """mod-2^32 truncation with the reference's sign convention
    (``nufhe/transform/ntt_cpu.py:74-82``)."""
    med = MODULUS // 2

    def conv(x):
        return np.int32(np.uint32(x & 0xFFFFFFFF)) - np.int32(x > med)

    return np.vectorize(conv, otypes=[np.int32])(a)


def _ntt_iterative(data, inverse_transform):
    """Iterative radix-2 NTT over the last axis (object ints, exact)."""
    n = data.shape[-1]
    logn = n.bit_length() - 1
    data = data.copy()

    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for bit in range(logn):
        rev |= ((idx >> bit) & 1) << (logn - 1 - bit)
    data = data[..., rev]

    w = root_of_unity(n)
    if inverse_transform:
        w = inverse(w)

    for stage in range(logn):
        mmax = 1 << stage
        istep = mmax * 2
        for m in range(mmax):
            tw = _pow(w, m * (1 << (logn - stage - 1)))
            i = np.arange(m, n, istep)
            j = i + mmax
            temp = (data[..., j] * tw) % MODULUS
            data[..., j] = (data[..., i] - temp) % MODULUS
            data[..., i] = (data[..., i] + temp) % MODULUS

    if inverse_transform:
        n_inv = inverse(n)
        data = (data * n_inv) % MODULUS
    return data


def ntt(data, inverse_transform=False):
    """Plain (cyclic) NTT of GF(p) residues along the last axis."""
    return _ntt_iterative(to_field(data) if data.dtype != object else data,
                          inverse_transform)


def forward_transform(data):
    """Negacyclic forward transform, u64 output.

    Matches ``ntt_transform_ref(data, i32_conversion=True)``
    (``nufhe/transform/ntt.py:30-44``): twist by powers of the 2N-th root,
    then cyclic NTT.
    """
    n = data.shape[-1]
    w = root_of_unity(2 * n)
    coeffs = np.empty(n, object)
    coeffs[:] = [_pow(w, i) for i in range(n)]
    twisted = (to_field(data) * coeffs) % MODULUS
    return field_to_u64(_ntt_iterative(twisted, False))


def inverse_transform(data):
    """Negacyclic inverse transform with i32 conversion.

    Matches ``ntt_transform_ref(data, inverse=True, i32_conversion=True)``.
    """
    n = data.shape[-1]
    w = root_of_unity(2 * n)
    coeffs = np.empty(n, object)
    coeffs[:] = [inverse(_pow(w, i)) for i in range(n)]
    res = _ntt_iterative(to_field(data), True)
    res = (res * coeffs) % MODULUS
    return field_to_i32(res)


def transformed_space_add(d1, d2):
    return field_to_u64((to_field(d1) + to_field(d2)) % MODULUS)


def transformed_space_mul(d1, d2):
    return field_to_u64((to_field(d1) * to_field(d2)) % MODULUS)


def transformed_space_mul_prepared(d1, d2):
    """Montgomery product (``polynomial_transform_ntt.py:65-69``)."""
    return field_to_u64((to_field(d1) * to_field(d2) * R_INVERSE) % MODULUS)


def prepare_for_mul(d):
    """Montgomery preparation: multiply by 2^64 mod p
    (``nufhe/transform/arithmetic.py:161-195``)."""
    r = pow(2, 64, MODULUS)
    return field_to_u64((to_field(d) * r) % MODULUS)
