"""The port's RNGs, ``tests/test_api.py::test_both_rngs`` ported: both
give bits, int32 torus values and gaussians of the asked deviation; and a
``SecureRNG`` key pair (not reproducible, so held through decryption)
gives a NAND that decrypts to the truth table.
"""

import numpy as np
import pytest
import torch

import nufhe_tpu_torch as nft


@pytest.mark.parametrize("make_rng", [lambda: nft.DeterministicRNG(1),
                                      nft.SecureRNG],
                         ids=["deterministic", "secure"])
def test_both_rngs(make_rng):
    rng = make_rng()
    x = rng.uniform_bool((100,))
    assert set(np.unique(x)).issubset({0, 1})
    t = rng.uniform_torus32((100,))
    assert t.dtype == np.int32
    g = rng.gauss((1000,), 2.0)
    assert abs(float(np.std(g)) - 2.0) < 0.5


def test_secure_rng_keys_give_a_nand_that_decrypts():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = nft.SecureRNG()
        secret, cloud = nft.make_key_pair(rng, device="cpu", lwe_size=8)
        bits = np.random.RandomState(7).randint(0, 2, (2, 16)).astype(bool)
        ca, cb = (nft.encrypt(rng, secret, b, device="cpu") for b in bits)
        out = nft.VirtualMachine(cloud, device="cpu").gate_nand(ca, cb)
        assert np.array_equal(nft.decrypt(secret, out), ~(bits[0] & bits[1]))
    finally:
        torch.set_num_threads(threads)
