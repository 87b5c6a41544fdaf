"""Ciphertext arrays (``nufhe_tpu/ciphertext.py``'s core).

``LweSampleArray`` is an array of LWE samples with a numpy-style ``shape``:
``a`` is shape+(n,) int32, ``b`` shape int32 and ``current_variances``
shape float32, all torch tensors on one device.
"""

import numpy as np
import torch

from .params import LweParams


class LweSampleArray:
    """A ciphertext object: an array of LWE samples (reference:
    ``nufhe/lwe.py:135-251``)."""

    def __init__(self, params: LweParams, a, b, current_variances):
        if a.shape[:-1] != b.shape or b.shape != current_variances.shape:
            raise ValueError(
                "Inconsistent shapes: {a}, {b}, {cv}".format(
                    a=tuple(a.shape), b=tuple(b.shape),
                    cv=tuple(current_variances.shape)))
        self.params = params
        self.a = a
        self.b = b
        self.current_variances = current_variances

    @classmethod
    def empty(cls, params: LweParams, shape, device):
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(shape)
        return cls(
            params,
            torch.zeros(shape + (params.size,), dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))

    @property
    def shape(self):
        return tuple(self.b.shape)

    @property
    def device(self):
        return self.b.device


def ciphertext_from_arrays(params: LweParams, a, b, cv, device):
    """A ciphertext holding the given numpy arrays, on ``device``."""
    return LweSampleArray(
        params,
        torch.from_numpy(np.array(a, np.int32)).to(device),
        torch.from_numpy(np.array(b, np.int32)).to(device),
        torch.from_numpy(np.array(cv, np.float32)).to(device))
