"""The round-5 rotation forms of ``tools/exp_round5.py`` on the card
(``nufhe_tpu_torch``), unless ``--device cpu`` is given.

Usage:
    python tools/exp_round5_torch.py [batch]          # default 16384
    NUFHE_BENCH_TRANSFORM=fft NUFHE_R5_TRICKS=t12,t14 \\
        python tools/exp_round5_torch.py 16384
    ... --device cpu    # the plain versions on the CPU (host seconds only)

A 100-step rotation in one launch (the card's counterpart of the TPU's
in-program loop) on ``_setup``'s accumulator (seed 0) and key row,
broadcast to every step, with the rotation amounts from seed 1
(``tools/exp_round5.py:50-55``): the baseline is K3 (its one-load gather
of each rotated coefficient), then each form of the TPU's barrel (K12,
``ops/rotate_forms.py``): t11 whole rotated copies through shared memory,
t12 the j-rounds in registers, t13 the i-round selects fused into the
exchange, t14 both.  Each form's output is checked equal to the
baseline's; the tool prints ms a step.  ``NUFHE_R5_TRICKS`` picks forms
(comma-separated substrings of their names); reads
``NUFHE_BENCH_TRANSFORM`` (exact engine by default).

Timing on the card: CUDA events around ``reps`` launches after a warm-up
call (``nufhe_tpu_torch.utils.profiling.time_ms``); the JAX script's
``lane_tile`` has no counterpart.  On the CPU the times are host seconds
of the plain versions, no device metric.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from exp_round4_torch import against_k3, selected  # noqa: E402
from nufhe_tpu_torch.ops import rotate_forms as rf  # noqa: E402


def main(batch=16384, device="cuda", n_steps=100, exact=None, reps=3):
    """The baseline (K3) and each form selected by ``NUFHE_R5_TRICKS``:
    {name: {"ms_per_step", and "exact" for the forms}}; raises if a form's
    output is not the baseline's."""
    return against_k3(batch, device, n_steps, exact, reps,
                      selected(rf.FORMS, rf.LABELS, "NUFHE_R5_TRICKS"),
                      rf.LABELS, rf.rotate_form)


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
    main(int(argv[0]) if argv else 16384, dev)
