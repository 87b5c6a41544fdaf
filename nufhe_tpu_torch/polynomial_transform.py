"""Per-backend polynomial transform facade
(``nufhe_tpu/polynomial_transform.py``'s counterpart).

API parity with the reference facade (``nufhe/polynomial_transform.py``,
``polynomial_transform_ntt.py``, ``polynomial_transform_fft.py``): one
module interface per ``transform_type`` with the transformed dtype and
length, the reference (host) transforms and transformed-space arithmetic.
'NTT' is the Goldilocks-field domain, 'FFT' the complex128 domain, 'N32'
the engine's own Z/2^32 Nussbaumer domain.

The device operations run on the tensor's device through the port's exact
engine: the forward transform (exact mod 2^32), pointwise add, and the
exact product with one small-coefficient operand
(``ops/transform.negacyclic_mul_device``).  1/64 is not invertible mod
2^32, so there is no standalone general inverse; exact products go through
the engine's two-channel pipeline instead.
"""

import numpy as np
import torch

from .numeric import wrap_i32
from .ref import ntt_goldilocks, fft_ref
from .ref import transform_ref


class _NTTTransform:
    """Goldilocks-field NTT domain (reference: polynomial_transform_ntt.py)."""

    name = 'NTT'

    @staticmethod
    def transformed_dtype():
        return np.dtype('uint64')

    @staticmethod
    def transformed_length(n):
        return n

    forward_transform_ref = staticmethod(ntt_goldilocks.forward_transform)
    inverse_transform_ref = staticmethod(ntt_goldilocks.inverse_transform)
    transformed_space_add_ref = staticmethod(
        ntt_goldilocks.transformed_space_add)
    transformed_space_mul_ref = staticmethod(
        ntt_goldilocks.transformed_space_mul)
    transformed_space_mul_prepared_ref = staticmethod(
        ntt_goldilocks.transformed_space_mul_prepared)
    prepare_for_mul_ref = staticmethod(ntt_goldilocks.prepare_for_mul)


class _FFTTransform:
    """complex128 tangent-FFT domain (reference: polynomial_transform_fft.py)."""

    name = 'FFT'

    @staticmethod
    def transformed_dtype():
        return np.dtype('complex128')

    @staticmethod
    def transformed_length(n):
        return n // 2

    forward_transform_ref = staticmethod(fft_ref.forward_transform)
    inverse_transform_ref = staticmethod(fft_ref.inverse_transform)
    transformed_space_add_ref = staticmethod(fft_ref.transformed_space_add)
    transformed_space_mul_ref = staticmethod(fft_ref.transformed_space_mul)
    transformed_space_mul_prepared_ref = staticmethod(
        fft_ref.transformed_space_mul)

    @staticmethod
    def prepare_for_mul_ref(data):
        return data  # identity (reference: polynomial_transform_fft.py:91-100)


class _DeviceTransform:
    """The engine's own domain: Z/2^32 Nussbaumer, (L, R) layout."""

    name = 'N32'

    @staticmethod
    def transformed_dtype():
        return np.dtype('uint64')  # host residues mod 2^64

    @staticmethod
    def transformed_length(n):
        assert n == transform_ref.N
        return transform_ref.L * transform_ref.R

    forward_transform_ref = staticmethod(transform_ref.forward)
    inverse_transform_ref = staticmethod(
        lambda data: transform_ref.u64_to_i32(
            transform_ref.inverse_unscaled(data)
            >> np.uint64(transform_ref.INV_SHIFT)))
    transformed_space_add_ref = staticmethod(lambda a, b: a + b)
    transformed_space_mul_ref = staticmethod(transform_ref.smul)
    transformed_space_mul_prepared_ref = staticmethod(transform_ref.smul)

    @staticmethod
    def prepare_for_mul_ref(data):
        return data


_TRANSFORMS = {
    'NTT': _NTTTransform,
    'FFT': _FFTTransform,
    'N32': _DeviceTransform,
}


def forward_device(x):
    """Forward transform on the tensor's device, (..., N) int32 ->
    (..., L, R) int32, exact mod 2^32 (and exact as integers for
    |x| <= 2^25)."""
    from .ops import transform as tf
    return tf.forward_i32(x)


def transformed_add_device(ahat, bhat):
    """Pointwise add in the transform domain, mod 2^32."""
    return wrap_i32(ahat.to(torch.int64) + bhat.to(torch.int64))


def transformed_mul_device(ahat_small, b_coeff):
    """Exact negacyclic product where one operand has small coefficients
    (``ops/transform.negacyclic_mul_device``)."""
    from .ops import transform as tf
    return tf.negacyclic_mul_device(ahat_small, b_coeff)


def get_transform(transform_type):
    """Reference: ``nufhe/polynomial_transform.py:26-30``."""
    if transform_type not in _TRANSFORMS:
        raise ValueError("Unknown transform type: " + str(transform_type))
    return _TRANSFORMS[transform_type]


def transform_supported(transform_type, device=None):
    """Every transform type is supported on every device: the exact engine
    needs neither float64 nor uint64 arithmetic on the device."""
    return transform_type in _TRANSFORMS
