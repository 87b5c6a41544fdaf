"""Scheme parameters (mirror of ``nufhe_tpu/params.py``).

Default parameter set is identical to the reference
(``nufhe/api_low_level.py:44-66``): ~128-bit security, N=1024, n=500, k=1,
bootstrap decomposition (l=2, base 2^10), keyswitch decomposition
(t=8, base 2^2).
"""

import numpy as np

from .numeric import Torus32


class LweParams:
    """Reference: ``nufhe/lwe.py:53-68``."""

    def __init__(self, size: int, min_noise: float, max_noise: float):
        self.size = size
        self.min_noise = min_noise  # smallest noise that keeps the sample secure
        self.max_noise = max_noise  # largest noise that still decrypts

    def __eq__(self, other):
        return (
            self.__class__ == other.__class__
            and self.size == other.size
            and self.min_noise == other.min_noise
            and self.max_noise == other.max_noise)

    def __hash__(self):
        return hash((self.__class__, self.size, self.min_noise, self.max_noise))


class TLweParams:
    """Reference: ``nufhe/tlwe.py:48-74``."""

    def __init__(
            self, polynomial_degree: int, mask_size: int,
            min_noise: float, max_noise: float, transform_type):
        self.polynomial_degree = polynomial_degree  # must be a power of 2
        self.mask_size = mask_size                  # polynomials in the mask
        self.min_noise = min_noise
        self.max_noise = max_noise
        self.extracted_lweparams = LweParams(
            polynomial_degree * mask_size, min_noise, max_noise)
        self.transform_type = transform_type

    def __eq__(self, other):
        return (
            self.__class__ == other.__class__
            and self.polynomial_degree == other.polynomial_degree
            and self.mask_size == other.mask_size
            and self.min_noise == other.min_noise
            and self.max_noise == other.max_noise
            and self.transform_type == other.transform_type)

    def __hash__(self):
        return hash((
            self.__class__, self.polynomial_degree, self.mask_size,
            self.min_noise, self.max_noise, self.transform_type))


class TGswParams:
    """Reference: ``nufhe/tgsw.py:43-67``."""

    def __init__(self, tlwe_params: TLweParams, decomp_length: int, bs_log2_base: int):
        # 1/(base^(j+1)) as Torus32 for j = 0 .. decomp_length-1
        decomp_range = np.arange(1, decomp_length + 1)
        self.base_powers = (2**(32 - decomp_range * bs_log2_base)).astype(Torus32)

        # offset = base/2 * sum_j 2^(32 - j*bs_log2_base), truncated to Torus32
        offset = int(self.base_powers.astype(np.int64).sum()) * (2**bs_log2_base // 2)
        self.offset = np.array(offset % 2**32, np.uint32).view(Torus32)[()]

        self.decomp_length = decomp_length
        self.bs_log2_base = bs_log2_base
        self.tlwe_params = tlwe_params

    def __eq__(self, other):
        return (
            self.__class__ == other.__class__
            and self.decomp_length == other.decomp_length
            and self.bs_log2_base == other.bs_log2_base
            and self.tlwe_params == other.tlwe_params)

    def __hash__(self):
        return hash((
            self.__class__, self.decomp_length, self.bs_log2_base, self.tlwe_params))


class NuFHEParameters:
    """Parameters of the FHE scheme.

    :param transform_type: ``'NTT'`` or ``'FFT'`` — the reference's two
        backends.  ``'NTT'`` is the exact engine: every negacyclic product
        is the exact integer result mod 2^32.  ``'FFT'`` is the JAX
        package's rounded-key engine: the key spectrum is rounded to
        multiples of 64 (``ops/transform.bootstrap_key_transformed``), a
        tracked noise cost.  Both run through the same kernels.
    :param tlwe_mask_size: number of polynomials in the TLWE mask (k).

    The non-default knobs (``tlwe_polynomial_degree``, ``lwe_size``, ...) are
    exposed for testing; defaults match the reference exactly
    (``nufhe/api_low_level.py:44-66``).
    """

    def __init__(self, transform_type='NTT', tlwe_mask_size=1,
                 tlwe_polynomial_degree=1024, lwe_size=500,
                 bs_decomp_length=2, bs_log2_base=10,
                 ks_decomp_length=8, ks_log2_base=2):
        assert transform_type in ('FFT', 'NTT')
        assert tlwe_mask_size >= 1

        coeff = (2 / np.pi) ** 0.5
        ks_stdev = 1 / 2**15 * coeff        # keyswitch minimal noise stdev
        bs_stdev = 9e-9 * coeff             # bootstrap minimal noise stdev
        max_stdev = 1 / 2**4 / 4 * coeff    # max stdev for a 1/4 message space

        params_in = LweParams(lwe_size, ks_stdev, max_stdev)
        params_accum = TLweParams(
            tlwe_polynomial_degree, tlwe_mask_size, bs_stdev, max_stdev,
            transform_type)
        params_bs = TGswParams(params_accum, bs_decomp_length, bs_log2_base)

        self.ks_decomp_length = ks_decomp_length
        self.ks_log2_base = ks_log2_base
        self.in_out_params = params_in
        self.tgsw_params = params_bs

        self._transform_type = transform_type
        self._tlwe_mask_size = tlwe_mask_size
        self._key = (
            transform_type, tlwe_mask_size, tlwe_polynomial_degree, lwe_size,
            bs_decomp_length, bs_log2_base, ks_decomp_length, ks_log2_base)

    @property
    def transform_type(self):
        return self._transform_type

    def __hash__(self):
        return hash((self.__class__,) + self._key)

    def __eq__(self, other):
        return self.__class__ == other.__class__ and self._key == other._key
