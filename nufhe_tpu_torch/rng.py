"""Random number generation.

All randomness is generated on the host (mirroring the reference's design
rationale, ``nufhe/random_numbers.py:18-27``): RNG cost is negligible next to
bootstrapping, and host generation keeps key material bit-reproducible and
device-agnostic.  Results are numpy arrays; callers move them to device.

The call signatures, distributions and *call order* match the reference
(``nufhe/random_numbers.py``) so that a given ``DeterministicRNG`` seed
produces the same key material layout.
"""

import random
from os import urandom

import numpy as np

from .numeric import Torus32, Int32, double_to_t32


class DeterministicRNG:
    """Fast, seedable, not cryptographically secure RNG (for testing).

    Reference: ``nufhe/random_numbers.py:46-62``.
    """

    def __init__(self, seed=None):
        self.rng = np.random.RandomState(seed)

    def uniform_bool(self, shape):
        return self.rng.randint(0, 2, size=shape, dtype=Int32)

    def uniform_torus32(self, shape):
        return self.rng.randint(-(2**31), 2**31, size=shape, dtype=Torus32)

    def gauss(self, shape, std_dev):
        return self.rng.normal(size=shape, scale=std_dev)


class SecureRNG:
    """Cryptographically secure RNG backed by the OS entropy source.

    Reference: ``nufhe/random_numbers.py:65-130`` (os.urandom bits,
    Box-Muller transform over open-interval uniform floats).
    """

    def __init__(self):
        self.rng = random.SystemRandom()

    def uniform_bool(self, shape):
        length = int(np.prod(shape, dtype=np.int64))
        nbytes = (length + 7) // 8
        random_bytes = np.frombuffer(urandom(nbytes), np.uint8)
        random_bits = np.unpackbits(random_bytes)[:length]
        return random_bits.reshape(shape).astype(Int32)

    def uniform_torus32(self, shape):
        length = int(np.prod(shape, dtype=np.int64))
        nbytes = length * np.dtype(Int32).itemsize
        return np.frombuffer(urandom(nbytes), Int32).reshape(shape).copy()

    def _open_unit_interval(self, count):
        """``count`` doubles strictly inside (0, 1): a raw draw k of 53 bits
        is mapped to the midpoint (k + 1/2) / 2^53 of its dyadic cell, so 0
        and 1 are unreachable and log() below is always finite.  The low 11
        bits of the 64-bit draw are discarded so the conversion is exact in
        float64 (a full 64-bit value would round, and values >= 2^64 - 2^10
        would round up to 2^64, absorbing the midpoint and producing 1.0)."""
        raw = np.frombuffer(urandom(count * 8), np.uint64)
        return ((raw >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53

    def gauss(self, shape, std_dev):
        # Box-Muller: each pair of unit uniforms yields an (amplitude,
        # angle) polar draw, giving two independent standard normals.
        total = int(np.prod(shape, dtype=np.int64))
        pairs = (total + 1) // 2
        amplitude = np.sqrt(-2.0 * np.log(self._open_unit_interval(pairs)))
        angle = self._open_unit_interval(pairs) * (2.0 * np.pi)
        normals = np.concatenate(
            [amplitude * np.cos(angle), amplitude * np.sin(angle)])
        return normals[:total].reshape(shape) * std_dev


def rand_uniform_bool(rng, shape):
    return rng.uniform_bool(shape)


def rand_uniform_torus32(rng, shape):
    return rng.uniform_torus32(shape)


def rand_gaussian_torus32(rng, message, sigma: float, shape, centered=False):
    """Gaussian torus samples centered on ``message`` with stdev ``sigma``.

    Reference: ``nufhe/random_numbers.py:134-139`` (including the
    mean-subtraction option used for keyswitch key noise).
    """
    rfloats = rng.gauss(shape, sigma)
    if centered:
        rfloats = rfloats - rfloats.mean()
    return (Torus32(message) + double_to_t32(rfloats)).astype(Torus32)
