"""Encrypted 8-bit addition with nufhe_tpu_torch: ripple against
Kogge-Stone adders (the port of ``examples/integer_adder.py``).

Each encrypted integer is a big-endian array of encrypted bits; every gate
call batches all integers (and, in the parallel circuit, all bit
positions) into one bootstrap.  The ripple adder bootstraps the fewest
bits; the Kogge-Stone adder (``parallel=True``) runs O(log2 w) dependent
gate calls instead of O(w).

    python examples/integer_adder_torch.py               # CUDA card, n=500
    python examples/integer_adder_torch.py --device cpu  # CPU, lwe_size=64

The card runs the default parameters; the CPU takes the reduced
``lwe_size=64`` of the JAX example to stay quick.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import nufhe_tpu_torch as nft
from nufhe_tpu_torch.models.integer import (
    uint_add, uintarray_to_bitarray, bitarray_to_uintarray)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    cpu = parser.parse_args().device == "cpu"
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", torch.cuda.current_device())

    rng = nft.DeterministicRNG(42)
    secret_key, cloud_key = nft.make_key_pair(
        rng, device=device, **(dict(lwe_size=64) if cpu else {}))

    a_vals = np.array([17, 250, 200], np.uint8)
    b_vals = np.array([25, 10, 100], np.uint8)

    ca = nft.encrypt(rng, secret_key, uintarray_to_bitarray(a_vals),
                     device=device)
    cb = nft.encrypt(rng, secret_key, uintarray_to_bitarray(b_vals),
                     device=device)
    answer = nft.empty_ciphertext(cloud_key.params, ca.shape, device)

    for parallel in (False, True):
        t0 = time.perf_counter()
        uint_add(cloud_key, answer, ca, cb, parallel=parallel, device=device)
        got = bitarray_to_uintarray(nft.decrypt(secret_key, answer))
        dt = time.perf_counter() - t0
        name = "kogge-stone" if parallel else "ripple"
        print("%-11s %s + %s = %s  (%.2f s, first call)"
              % (name, a_vals, b_vals, got, dt))
        assert np.array_equal(got, a_vals + b_vals), (got, a_vals + b_vals)
    print("integer adder on %s: OK" % device)


if __name__ == "__main__":
    main()
