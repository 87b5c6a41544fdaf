"""Complex128 tangent-FFT oracle (parity with the reference FFT backend).

Mirror of ``nufhe_tpu/ref/fft_ref.py`` (numpy only).

Mirrors ``nufhe/transform/fft.py:27-51`` (``fft_transform_ref``): an i32
polynomial of length N is packed as N/2 complex values ``a_j - i*a_{j+N/2}``,
twisted by ``exp(-pi*i*j/N)`` and transformed with a length-N/2 complex FFT;
the negacyclic product of two polynomials is the pointwise product in this
domain.  Exactness for TFHE operand magnitudes (products bounded by 2^52,
``doc/source/implementation_details.rst``) follows from float64 rounding.

Host-side oracle only; the port's device path computes the same products
exactly through the Z/2^32 Nussbaumer engine.
"""

import numpy as np


def forward_transform(data):
    """(..., N) int32 -> (..., N/2) complex128."""
    n = data.shape[-1]
    batch_shape = data.shape[:-1]
    data = data.reshape(-1, n)
    coeffs = np.exp(-2j * np.pi * np.arange(n // 2) / n / 2)
    packed = data[:, : n // 2] - 1j * data[:, n // 2:]
    return np.fft.fft(packed * coeffs).reshape(batch_shape + (n // 2,))


def inverse_transform(data):
    """(..., N/2) complex128 -> (..., N) int32 (rounded, truncated mod 2^32)."""
    half = data.shape[-1]
    n = half * 2
    batch_shape = data.shape[:-1]
    data = data.reshape(-1, half)
    coeffs = np.exp(-2j * np.pi * np.arange(half) / n / 2)
    res = np.fft.ifft(data).conj() * coeffs

    def f64_to_i32(x):
        return np.round(x).astype(np.int64).astype(np.uint64).astype(
            np.uint32).view(np.int32)

    out = np.concatenate([f64_to_i32(res.real), f64_to_i32(res.imag)], axis=1)
    return out.reshape(batch_shape + (n,))


def transformed_space_add(d1, d2):
    return d1 + d2


def transformed_space_mul(d1, d2):
    return d1 * d2
