"""A client/cloud round trip through the containers of nufhe_tpu_torch
(the port of ``examples/serialization.py``): the client makes the keys and
encrypts, the cloud loads the cloud key and the ciphertexts from bytes and
computes XOR, the client decrypts the result from bytes.

    python examples/serialization_torch.py               # on the CUDA card
    python examples/serialization_torch.py --device cpu  # plain PyTorch, CPU

On the CPU the keys use ``lwe_size=64`` to keep the run short; the card
runs the default parameters.
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

# --- client side ---
ctx = nft.Context(rng=nft.SecureRNG(), api="cpu" if cpu else None)
secret_key, cloud_key = ctx.make_key_pair(**(dict(lwe_size=64) if cpu else {}))

bits = np.random.RandomState(0).binomial(1, 0.5, size=(2, 16)).astype(bool)
bits1, bits2 = bits

cloud_key_bytes = cloud_key.dumps()
ciphertext1_bytes = ctx.encrypt(secret_key, bits1).dumps()
ciphertext2_bytes = ctx.encrypt(secret_key, bits2).dumps()

# --- cloud side (no secret key) ---
cloud_key2 = nft.NuFHECloudKey.loads(cloud_key_bytes)
vm = nft.VirtualMachine(cloud_key2, device=ctx.device)
result = vm.gate_xor(
    nft.LweSampleArray.loads(ciphertext1_bytes, ctx.device),
    nft.LweSampleArray.loads(ciphertext2_bytes, ctx.device))
result_bytes = result.dumps()

# --- client side ---
answer = ctx.decrypt(secret_key, nft.LweSampleArray.loads(result_bytes,
                                                          ctx.device))
assert np.array_equal(answer, bits1 ^ bits2)
print("serialized XOR roundtrip (cloud key %d bytes) on %s: OK"
      % (len(cloud_key_bytes), ctx.device))
