"""XOR in both engine modes of nufhe_tpu_torch (the port of
``examples/transform_modes.py``): 'NTT', the exact transform, and 'FFT',
the rounded key, whose key limbs drop the 6 low bits of each residue.

    python examples/transform_modes_torch.py               # on the CUDA card
    python examples/transform_modes_torch.py --device cpu  # plain PyTorch

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

size = 16
bits = np.random.RandomState(0).binomial(1, 0.5, size=(2, size)).astype(bool)
bits1, bits2 = bits

for mode in ("NTT", "FFT"):
    rng = nft.DeterministicRNG(7)
    ctx = nft.Context(rng=rng, api="cpu" if cpu else None)
    secret_key, cloud_key = ctx.make_key_pair(
        transform_type=mode, **(dict(lwe_size=64) if cpu else {}))
    vm = ctx.make_virtual_machine(cloud_key)

    r = vm.gate_xor(ctx.encrypt(secret_key, bits1),
                    ctx.encrypt(secret_key, bits2))
    assert np.array_equal(ctx.decrypt(secret_key, r), bits1 ^ bits2)

    limbs = cloud_key.bootstrap_key.limbs()
    print("%s mode: XOR of %d bits OK; key limbs per slot %d, "
          "per-gate noise std estimate %.2e (torus)"
          % (mode, size, limbs.shape[-2],
             float(np.sqrt(r.current_variances.max().item()))))
print("both transform modes on %s: OK" % ctx.device)
