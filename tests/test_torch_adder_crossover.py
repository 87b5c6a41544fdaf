"""``tools/adder_crossover_torch.py`` (the port of
``tools/adder_crossover.py``) on the CPU at a reduced size: the file it
writes has the JAX tool's entry keys, and both adders' outputs decrypt to
numpy's sum (the ``*_ok`` flags, which a wrong adder turns false).  That
``uint_add`` gives the JAX package's ciphertexts, bit for bit, is held by
``tests/test_torch_integer.py``; this file does not repeat it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import adder_crossover_torch as crossover  # noqa: E402
import nufhe_tpu_torch as nft  # noqa: E402

# tools/adder_crossover.py's entry keys
ENTRY_KEYS = {"batch", "width", "ripple_ms", "ripple_ok", "kogge_stone_ms",
              "kogge_stone_ok", "winner"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_writes_the_jax_tools_entries(tmp_path):
    out = tmp_path / "crossover.json"
    results = crossover.run([2], [4], out=str(out), device="cpu", lwe_size=8)
    assert json.loads(out.read_text()) == results
    assert results["device"] == "cpu" and results["card"] is None
    (entry,) = results["grid"]
    assert set(entry) == ENTRY_KEYS
    assert (entry["batch"], entry["width"]) == (2, 4)
    assert entry["ripple_ok"] is True and entry["kogge_stone_ok"] is True
    assert entry["ripple_ms"] > 0 and entry["kogge_stone_ms"] > 0
    assert entry["winner"] == min(("ripple", "kogge_stone"),
                                  key=lambda f: entry[f + "_ms"])


def test_a_wrong_sum_is_flagged(monkeypatch):
    """An adder that leaves zeros decrypts to 0, not numpy's sum: both
    flags turn false (the seed's sums are not all 0)."""
    from nufhe_tpu_torch.models import integer

    def zeros(cloud, answer, a, b, parallel=None, device=None):
        nft.gate_constant(cloud, answer, np.zeros(answer.shape, bool),
                          device)

    monkeypatch.setattr(integer, "uint_add", zeros)
    rng = nft.DeterministicRNG(5)
    secret, cloud = nft.make_key_pair(rng, device="cpu", lwe_size=8)
    rs = np.random.RandomState(2 * 31 + 4)
    a, b = (nft.bitarray_to_uintarray(rs.randint(0, 2, (2, 4)) != 0)
            for _ in range(2))
    assert np.any((a.astype(np.int64) + b) % 16)
    (entry,) = crossover.sweep(cloud, secret, rng, [2], [4], "cpu", reps=1)
    assert entry["ripple_ok"] is False and entry["kogge_stone_ok"] is False
