"""NAND of 32 encrypted bits through the high-level API of nufhe_tpu_torch
(the port of ``examples/gate_nand.py``).

    python examples/gate_nand_torch.py               # on the CUDA card
    python examples/gate_nand_torch.py --device cpu  # plain PyTorch, CPU

On the CPU the keys use ``lwe_size=64`` (a 64-step blind rotation instead
of 500) to keep the run short; the card runs the default parameters.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import nufhe_tpu_torch as nft

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = parser.parse_args()
cpu = args.device == "cpu"

size = 32

rng = nft.DeterministicRNG()
ctx = nft.Context(rng=rng, api="cpu" if cpu else None)
secret_key, cloud_key = ctx.make_key_pair(**(dict(lwe_size=64) if cpu else {}))
vm = ctx.make_virtual_machine(cloud_key)

bits = np.random.RandomState(0).binomial(1, 0.5, size=(2, size)).astype(bool)
bits1, bits2 = bits
reference = ~(bits1 & bits2)

ciphertext1 = ctx.encrypt(secret_key, bits1)
ciphertext2 = ctx.encrypt(secret_key, bits2)

result = vm.gate_nand(ciphertext1, ciphertext2)
answer_bits = ctx.decrypt(secret_key, result)

assert np.array_equal(answer_bits, reference)
print("NAND of", size, "encrypted bits on", ctx.device, ": OK")
