"""User API (``nufhe_tpu/api.py``'s ``encrypt``, ``decrypt`` and
``VirtualMachine``).  Everything runs on the CUDA card unless the caller
passes ``device='cpu'``."""

import numpy as np
import torch

from .numeric import bool_to_t32, t32_to_bool
from .params import NuFHEParameters
from .keys import NuFHESecretKey, NuFHECloudKey, make_key_pair
from .ciphertext import LweSampleArray
from .performance import PerformanceParameters
from .rng import rand_gaussian_torus32, rand_uniform_torus32
from .ops import lwe as dlwe
from .models import gates
from .models.gates import get_shape, result_shape


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is
    none: the CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nufhe_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def empty_ciphertext(params: NuFHEParameters, shape, device=None):
    """An all-zero ciphertext of the given message shape.
    Reference: ``nufhe/api_low_level.py:298-302``."""
    return LweSampleArray.empty(params.in_out_params, shape,
                                resolve_device(device))


def encrypt(rng, key: NuFHESecretKey, message, device=None):
    """Encrypt an array of bits.  Reference: ``nufhe/api_low_level.py:266-281``.

    RNG order matches the reference (``nufhe/lwe.py:325-333``): gaussian
    b-noise first, then uniform mask rows.
    """
    device = resolve_device(device)
    message = np.asarray(message)
    params = key.params
    lwe_size = params.in_out_params.size
    noise = params.in_out_params.min_noise

    mus = bool_to_t32(message)
    noises_b = rand_gaussian_torus32(rng, 0, noise, message.shape)
    noises_a = rand_uniform_torus32(rng, message.shape + (lwe_size,))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    a, b, cv = dlwe.lwe_encrypt(t(mus), t(key.lwe_key.key), t(noises_a),
                                t(noises_b), noise)
    return LweSampleArray(params.in_out_params, a, b, cv)


def decrypt_phase(key: NuFHESecretKey, ciphertext: LweSampleArray):
    """The raw phase b - a.s as an int32 numpy array."""
    k = torch.from_numpy(np.asarray(key.lwe_key.key, np.int32)).to(
        ciphertext.device)
    return dlwe.lwe_decrypt_phase(ciphertext.a, ciphertext.b, k).cpu().numpy()


def decrypt(key: NuFHESecretKey, ciphertext: LweSampleArray):
    """Decrypt to a boolean numpy array.
    Reference: ``nufhe/api_low_level.py:284-295``."""
    return t32_to_bool(decrypt_phase(key, ciphertext))


class VirtualMachine:
    """Executes gates on ciphertexts with an encapsulated cloud key.

    ``vm.gate_<op>(*args, dest=None)`` mirrors the reference
    (``nufhe/api_high_level.py:302-363``) for the 14 gates.
    ``perf_params`` (a ``PerformanceParameters``; unset: the defaults) is
    resolved for ``device`` once, here.
    """

    def __init__(self, cloud_key: NuFHECloudKey,
                 perf_params: PerformanceParameters = None, device=None):
        if perf_params is None:
            perf_params = PerformanceParameters(cloud_key.params)
        self.params = cloud_key.params
        self.cloud_key = cloud_key
        self.device = resolve_device(device)
        self.perf_params = perf_params.for_device(self.device)

    def empty_ciphertext(self, shape):
        return empty_ciphertext(self.params, shape, self.device)

    def _gate(self, name, *args, dest: LweSampleArray = None):
        if dest is None:
            dest = self.empty_ciphertext(
                result_shape(*[get_shape(arg) for arg in args]))
        getattr(gates, name)(self.cloud_key, dest, *args, device=self.device,
                             perf_params=self.perf_params)
        return dest

    def __getattr__(self, name):
        if name in gates.GATES:
            return lambda *args, **kwds: self._gate(name, *args, **kwds)
        raise AttributeError(name)


__all__ = ['empty_ciphertext', 'encrypt', 'decrypt', 'decrypt_phase',
           'make_key_pair', 'PerformanceParameters', 'VirtualMachine']
