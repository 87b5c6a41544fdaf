"""Ripple vs Kogge-Stone crossover sweep of nufhe_tpu_torch on one CUDA
card: the port of ``tools/adder_crossover.py``.

Times encrypted addition (``models/integer.uint_add``, ``parallel=False``
and ``True``) over a (batch x width) grid at the default parameters, the
best of 3 synchronised calls after a first call at that shape that is
checked against numpy, and writes the grid as JSON.  The table is the data
for a card-side ``parallel=None`` rule; the port keeps the JAX package's.

Usage: python3 tools/adder_crossover_torch.py [batches] [widths] [out.json]
       python3 tools/adder_crossover_torch.py 128,512,2048 8,16

Defaults: ``128,1024,4096``, ``8,16``, ``ADDER_CROSSOVER_torch.json`` in the
repo root.  Without a CUDA card it exits non-zero.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "ADDER_CROSSOVER_torch.json")


def _fence(x, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return int(x.reshape(-1)[0])


def sync_overhead(dev):
    """Best of 5: a bare synchronise and one scalar read."""
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    _fence(x, dev)
    best = float("inf")
    for _ in range(5):
        t0 = time.time()
        _fence(x, dev)
        best = min(best, time.time() - t0)
    return best


def sweep(cloud, secret, rng, batches, widths, device, reps=3):
    """Both adders at every (batch, width): returns the grid's entries,
    ``{"batch", "width", "ripple_ms", "ripple_ok", "kogge_stone_ms",
    "kogge_stone_ok", "winner"}`` (``tools/adder_crossover.py``'s), each
    time the best of ``reps`` synchronised calls less the synchronise's
    own cost, after a first call whose decryption is checked."""
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.models.integer import uint_add

    dev = torch.device(device)
    ov = sync_overhead(dev)
    grid = []
    for width in widths:
        for batch in batches:
            rs = np.random.RandomState(batch * 31 + width)
            a_bits = rs.randint(0, 2, (batch, width)) != 0
            b_bits = rs.randint(0, 2, (batch, width)) != 0
            ca = nft.encrypt(rng, secret, a_bits, device=dev)
            cb = nft.encrypt(rng, secret, b_bits, device=dev)
            ans = nft.empty_ciphertext(cloud.params, ca.shape, device=dev)
            expect = (nft.bitarray_to_uintarray(a_bits).astype(np.int64)
                      + nft.bitarray_to_uintarray(b_bits)) % (1 << width)

            entry = {"batch": batch, "width": width}
            for parallel, name in ((False, "ripple"), (True, "kogge_stone")):
                uint_add(cloud, ans, ca, cb, parallel=parallel, device=dev)
                _fence(ans.b, dev)
                ok = bool(np.array_equal(
                    nft.bitarray_to_uintarray(nft.decrypt(secret, ans))
                    .astype(np.int64), expect))
                best = float("inf")
                for _ in range(reps):
                    t0 = time.time()
                    uint_add(cloud, ans, ca, cb, parallel=parallel,
                             device=dev)
                    _fence(ans.b, dev)
                    best = min(best, time.time() - t0 - ov)
                entry[name + "_ms"] = round(best * 1e3, 2)
                entry[name + "_ok"] = ok
                print(f"B={batch:6d} w={width:2d} {name:12s}: "
                      f"{best * 1e3:9.1f} ms  ok={ok}", flush=True)
            entry["winner"] = ("kogge_stone"
                               if entry["kogge_stone_ms"] < entry["ripple_ms"]
                               else "ripple")
            grid.append(entry)
    return grid


def run(batches, widths, out=DEFAULT_OUT, device=None, lwe_size=500):
    """Keygen (``DeterministicRNG(5)``) on ``device`` (None: the current
    CUDA card, raising without one; 'cpu' for the tests), the sweep, and
    the JSON file ``{"device", "card", "grid"}`` written to ``out``.
    Returns the results."""
    import nufhe_tpu_torch as nft
    from bench_torch import nvidia_smi_line

    dev = nft.api.resolve_device(device)
    rng = nft.DeterministicRNG(5)
    print("keygen...", flush=True)
    secret, cloud = nft.make_key_pair(rng, device=dev, lwe_size=lwe_size)
    on_card = dev.type == "cuda"
    results = {
        "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
        "card": nvidia_smi_line() if on_card else None,
        "grid": sweep(cloud, secret, rng, batches, widths, dev)}
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", out)
    return results


def main(argv):
    if not torch.cuda.is_available():
        print("adder_crossover_torch: no CUDA card (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    batches = [int(x) for x in
               (argv[1] if len(argv) > 1 else "128,1024,4096").split(",")]
    widths = [int(x) for x in
              (argv[2] if len(argv) > 2 else "8,16").split(",")]
    run(batches, widths, argv[3] if len(argv) > 3 else DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
