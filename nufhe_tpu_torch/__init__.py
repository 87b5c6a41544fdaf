"""nufhe_tpu_torch: TFHE gate bootstrapping in PyTorch with hand-written
CUDA kernels for Hopper.

The PyTorch/CUDA port of ``nufhe_tpu``, with its export surface
(``nufhe_tpu/__init__.py``).  It imports neither JAX nor ``nufhe_tpu``.
Entry points run on the CUDA card unless the caller passes
``device='cpu'``, where every kernel is replaced by its plain PyTorch
version.
"""

from .params import NuFHEParameters
from .rng import DeterministicRNG, SecureRNG
from .keys import (
    NuFHESecretKey, NuFHECloudKey, make_key_pair, cloud_key_from_arrays,
    secret_key_from_array)
from .ciphertext import LweSampleArray, ciphertext_from_arrays, concatenate
from .performance import PerformanceParameters
from .api import (
    Context, VirtualMachine, DeviceID, find_devices, empty_ciphertext,
    encrypt, decrypt, decrypt_phase)
from .models.gates import (
    gate_nand, gate_or, gate_and, gate_xor, gate_xnor, gate_not, gate_copy,
    gate_constant, gate_nor, gate_andny, gate_andyn, gate_orny, gate_oryn,
    gate_mux)
from .models.integer import (
    uint_min, uint_max, uint_add, uint_sub, uint_mul, uint_gt, uint_lt,
    uint_eq, uint_div, uint_mod, uint_divmod, int_min, int_max, int_add,
    int_sub, int_neg, int_gt, int_lt, int_eq, uintarray_to_bitarray,
    bitarray_to_uintarray, intarray_to_bitarray, bitarray_to_intarray)


def clear_computation_cache(*args, **kwds):
    """Does nothing: the API-parity shim for the JAX package's
    ``clear_computation_cache`` (the reference's ``nufhe/
    computation_cache.py``).  The port compiles nothing at run time but
    its CUDA kernels, each built once per process at first use; the keys
    prepared for a device stay cached on their key objects."""


__all__ = [
    'NuFHEParameters', 'DeterministicRNG', 'SecureRNG', 'NuFHESecretKey',
    'NuFHECloudKey', 'make_key_pair', 'cloud_key_from_arrays',
    'secret_key_from_array', 'LweSampleArray', 'ciphertext_from_arrays',
    'concatenate', 'empty_ciphertext', 'encrypt', 'decrypt', 'decrypt_phase',
    'PerformanceParameters', 'Context', 'VirtualMachine', 'DeviceID',
    'find_devices', 'clear_computation_cache',
    'gate_nand', 'gate_or', 'gate_and', 'gate_xor', 'gate_xnor', 'gate_not',
    'gate_copy', 'gate_constant', 'gate_nor', 'gate_andny', 'gate_andyn',
    'gate_orny', 'gate_oryn', 'gate_mux',
    'uint_min', 'uint_max', 'uint_add', 'uint_sub', 'uint_mul', 'uint_gt',
    'uint_lt', 'uint_eq', 'uint_div', 'uint_mod', 'uint_divmod', 'int_min',
    'int_max', 'int_add', 'int_sub', 'int_neg', 'int_gt', 'int_lt', 'int_eq',
    'uintarray_to_bitarray', 'bitarray_to_uintarray', 'intarray_to_bitarray',
    'bitarray_to_intarray',
]
