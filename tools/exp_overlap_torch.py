"""The forward/MAC overlap probe of ``tools/exp_overlap.py`` on the card
(``nufhe_tpu_torch``), unless ``--device cpu`` is given: the exact CMUX
step in two schedules.

Usage:
    python tools/exp_overlap_torch.py [batch]          # default 4096
    python tools/exp_overlap_torch.py [batch] --device cpu

  serial - K1 (``ops/cmux.py``): forward of every digit polynomial, the
           MAC, the inverse
  split  - K8 (``ops/step_overlap.py``): forward of digit half A; its MAC
           beside the forward of half B in other warps; the MAC of B; the
           inverse of A + B

First the two on the first 512 samples, which must be equal bit for bit
("split exact", as the JAX script asserts), then each timed at ``batch``.
Inputs: ``tools/microbench_torch.py``'s (seed 0), exact key.  Timing as
there (CUDA events; the JAX script's sync subtraction and its 512-sample
TPU tile have no counterpart).  On the CPU the times are host seconds of
the plain versions, no device metric.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from microbench_torch import _setup, _where, time_ms  # noqa: E402
from nufhe_tpu_torch.ops import cmux, key_rows as kr  # noqa: E402
from nufhe_tpu_torch.ops import step_overlap as so  # noqa: E402

CHECK = 512
# the JAX names (tools/exp_overlap.py:3-7)
SCHEDULES = {"serial": cmux.cmux_step, "split": so.step_overlap}


def run(batch, device="cuda", reps=20):
    """Both schedules at ``batch``: ms a step by schedule, and whether the
    split equals the serial step on the first samples."""
    acc, powers, row, kw = _setup(batch, device, exact=True)
    row = kr.prepare(row, False)                 # the device's form
    n = min(CHECK, batch)
    small, p_small = acc[:n].contiguous(), powers[:n].contiguous()
    exact = torch.equal(SCHEDULES["serial"](small, p_small, row, **kw),
                        SCHEDULES["split"](small, p_small, row, **kw))
    print("batch %d; split exact: %s" % (batch, exact), flush=True)
    out = {"exact": exact}
    for name, fn in SCHEDULES.items():
        out[name] = time_ms(lambda: fn(acc, powers, row, **kw), reps, device)
    print("serial: %.4f %s   split: %.4f %s"
          % (out["serial"], _where(device), out["split"], _where(device)),
          flush=True)
    return out


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "versions on the CPU")
    run(int(argv[0]) if argv else 4096, device)


if __name__ == "__main__":
    main(sys.argv[1:])
