"""NAND of 32 encrypted bits through the low-level API of nufhe_tpu_torch
(the port of ``examples/gate_nand_low_level.py``).

    python examples/gate_nand_low_level_torch.py               # CUDA card
    python examples/gate_nand_low_level_torch.py --device cpu  # CPU

On the CPU the keys use ``lwe_size=64`` to keep the run short; the card
runs the default parameters.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import nufhe_tpu_torch as nft

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = parser.parse_args()
cpu = args.device == "cpu"
device = torch.device("cpu") if cpu else torch.device(
    "cuda", torch.cuda.current_device())

size = 32

rng = nft.DeterministicRNG()
secret_key, cloud_key = nft.make_key_pair(
    rng, device=device, **(dict(lwe_size=64) if cpu else {}))

bits = np.random.RandomState(0).binomial(1, 0.5, size=(2, size)).astype(bool)
bits1, bits2 = bits
reference = ~(bits1 & bits2)

ciphertext1 = nft.encrypt(rng, secret_key, bits1, device=device)
ciphertext2 = nft.encrypt(rng, secret_key, bits2, device=device)

result = nft.empty_ciphertext(cloud_key.params, ciphertext1.shape, device)
nft.gate_nand(cloud_key, result, ciphertext1, ciphertext2, device)

answer_bits = nft.decrypt(secret_key, result)
assert np.array_equal(answer_bits, reference)
print("NAND of", size, "encrypted bits (low-level API) on", device, ": OK")
