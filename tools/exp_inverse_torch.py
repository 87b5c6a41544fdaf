"""The inverse probes of ``tools/exp_inverse.py`` on the card
(``nufhe_tpu_torch``), unless ``--device cpu`` is given.

Usage:
    python tools/exp_inverse_torch.py [batch]          # default 4096
    ... --device cpu    # the plain versions on the CPU (host seconds only)

The exact engine's dual-channel inverse alone (K13, ``ops/inverse_probe.py``)
on the JAX script's input: a (2048, batch) int32 accumulator from seed 0
(here transposed, one sample a row), stacked four times, inverted at a
t-group of 128 rows, folded and normalised.  The probes keep the JAX
names: base (one rotation a set bit of each twiddle), notw (no twiddles),
align (amounts rounded down to multiples of 8), noroll (the card's own:
each rotation's sign alone) and sliced (one rotation a butterfly, K3's
form); the middle three are wrong on purpose and used for timing only.
sliced is checked equal to base, as the JAX script checks it against
``dit_inverse``.  The tool prints ms a launch.

Timing on the card: CUDA events around ``reps`` launches after a warm-up
call (``nufhe_tpu_torch.utils.profiling.time_ms``).  The JAX script's
sync round trip is not needed (CUDA events time the device), and its
lane tile has no counterpart.  On the CPU the times are host seconds of
the plain versions, no device metric.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from microbench_torch import _where, time_ms  # noqa: E402
from nufhe_tpu_torch.ops import inverse_probe as ip  # noqa: E402


def inputs(batch, device):
    """The JAX script's accumulator (``RandomState(0)``, (2048, batch)),
    one sample a row."""
    rs = np.random.RandomState(0)
    a = rs.randint(-2**31, 2**31, (2048, batch)).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)


def run(batch=4096, device="cuda", reps=20):
    """{"ms": {probe: ms a launch}, "sliced_exact": bool}."""
    a = inputs(batch, device)
    print("batch %d" % batch, flush=True)
    out = {"ms": {}}
    for name in ip.PROBES:
        if name == "sliced":
            same = torch.equal(ip.inverse_probe("sliced", a),
                               ip.inverse_probe("base", a))
            out["sliced_exact"] = same
            print("sliced exact: %s" % same, flush=True)
        out["ms"][name] = time_ms(lambda: ip.inverse_probe(name, a), reps,
                                  device)
        print("%-10s: %9.4f %s" % (name, out["ms"][name], _where(device)),
              flush=True)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "versions on the CPU")
    run(int(argv[0]) if argv else 4096, dev)
