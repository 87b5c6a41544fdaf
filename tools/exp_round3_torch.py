"""The round-3 step schedules of ``tools/exp_round3.py`` on the card
(``nufhe_tpu_torch``), unless ``--device cpu`` is given.

Usage:
    python tools/exp_round3_torch.py [batch]          # default 4096
    NUFHE_BENCH_TRANSFORM=fft python tools/exp_round3_torch.py 16384
    ... --device cpu    # the plain versions on the CPU (host seconds only)

One CMUX step in seven schedules (K10, ``ops/step_schedules.py``; the JAX
names): v0 (digits materialised, the forward staged through shared
memory), v1 (fused digits, staged forward), v2 (the MAC's combine and the
normalisation as passes of their own), v3 (K1 itself), and the software
pipelines across a block's samples p2 (halves), p2b (both MACs before
either back) and p4 (quarters).  Each schedule's output is checked equal
to K1's (``ops/cmux.cmux_step``) on the same inputs (``_setup``, seed 0)
before it is timed; the tool prints ms a launch and ms/bit (x 500 steps /
batch).  Reads ``NUFHE_BENCH_TRANSFORM`` (exact engine by default).

Timing on the card: CUDA events around ``reps`` launches after a warm-up
call (``nufhe_tpu_torch.utils.profiling.time_ms``).  The JAX script's
``lane_tile`` sizes a TPU VMEM tile; the port's kernels fix their block
shape themselves.  The JAX script's ratio to 0.35 ms/bit (the reference's
gate) is left out: this is one step of a gate.  On the CPU the times are
host seconds of the plain versions, no device metric.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from microbench_torch import _setup, _where, exact_engine, time_ms  # noqa: E402
from nufhe_tpu_torch.ops import cmux, key_rows as kr  # noqa: E402
from nufhe_tpu_torch.ops import step_schedules as ss  # noqa: E402

N_LWE = 500       # steps of a gate's rotation: ms/bit = ms * 500 / batch


def run(batch, device="cuda", exact=None, reps=20):
    """Each schedule at ``batch``: {name: {"ms", "ms_bit", "exact"}}; raises
    if a schedule's output is not K1's."""
    if exact is None:
        exact = exact_engine()
    acc, powers, row, kw = _setup(batch, device, exact=exact)
    row = kr.prepare(row, not exact)             # the device's form
    print("mode=%s batch=%d" % ("exact" if exact else "rounded-key", batch),
          flush=True)
    ref = cmux.cmux_step(acc, powers, row, **kw)
    out = {}
    for name in ss.SCHEDULES:
        same = torch.equal(ss.step_schedule(name, acc, powers, row, **kw),
                           ref)
        print("%-22s exact=%s" % (ss.LABELS[name], same), flush=True)
        if not same:
            raise AssertionError("%s is not K1's step" % ss.LABELS[name])
        out[name] = {"exact": same}
    for name in ss.SCHEDULES:
        ms = time_ms(lambda: ss.step_schedule(name, acc, powers, row, **kw),
                     reps, device)
        out[name].update(ms=ms, ms_bit=ms * N_LWE / batch)
        print("%-22s: %9.4f %s  -> %.5f ms/bit" % (
            ss.LABELS[name], ms, _where(device), ms * N_LWE / batch),
            flush=True)
    return out


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    batch = int(argv[0]) if argv else 4096
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "versions on the CPU")
    run(batch, device)


if __name__ == "__main__":
    main(sys.argv[1:])
