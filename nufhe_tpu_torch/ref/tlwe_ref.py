"""Host TLWE encryption of zero for keygen (``nufhe/tlwe_cpu.py`` formulas;
the keygen part of ``nufhe_tpu/ref/tlwe_ref.py``)."""

import numpy as np

from ..numeric import Torus32, ErrorFloat
from . import transform_ref


def tlwe_encrypt_zero(key, noises1, noises2, noise: float):
    """Homogeneous TLWE sample: b = noise2 + sum_i key_i * mask_noise_i.

    :param key: (mask_size, N) binary int32 polynomials.
    :param noises1: (..., mask_size, N) uniform torus (the mask).
    :param noises2: (..., N) gaussian torus (body noise).
    Reference: ``nufhe/tlwe_cpu.py:64-89`` (the negacyclic products are
    computed by the exact engine instead of the Goldilocks NTT refs).
    """
    noises1 = np.asarray(noises1, Torus32)
    noises2 = np.asarray(noises2, Torus32)
    mask_size, n = key.shape

    prods = transform_ref.negacyclic_mul(
        np.asarray(key, np.int32), noises1)      # (..., mask_size, N)
    body = (noises2 + prods.sum(-2, dtype=Torus32)).astype(Torus32)

    a = np.concatenate([noises1, body[..., None, :]], axis=-2)
    cv = np.full(noises2.shape[:-1], noise**2, ErrorFloat)
    return a, cv
