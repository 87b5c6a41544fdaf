"""nufhe_tpu_torch: TFHE gate bootstrapping in PyTorch with hand-written
CUDA kernels for Hopper.

The PyTorch/CUDA port of ``nufhe_tpu``.  It imports neither JAX nor
``nufhe_tpu``.  Entry points run on the CUDA card unless the caller passes
``device='cpu'``, where every kernel is replaced by its plain PyTorch
version.
"""

from .params import NuFHEParameters
from .rng import DeterministicRNG, SecureRNG
from .keys import (
    NuFHESecretKey, NuFHECloudKey, make_key_pair, cloud_key_from_arrays,
    secret_key_from_array)
from .ciphertext import LweSampleArray, ciphertext_from_arrays
from .performance import PerformanceParameters
from .api import (
    empty_ciphertext, encrypt, decrypt, decrypt_phase, VirtualMachine)

__all__ = [
    'NuFHEParameters', 'DeterministicRNG', 'SecureRNG', 'NuFHESecretKey',
    'NuFHECloudKey', 'make_key_pair', 'cloud_key_from_arrays',
    'secret_key_from_array', 'LweSampleArray', 'ciphertext_from_arrays',
    'empty_ciphertext', 'encrypt', 'decrypt', 'decrypt_phase',
    'PerformanceParameters', 'VirtualMachine',
]
