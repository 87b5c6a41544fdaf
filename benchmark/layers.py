"""One traced run of a cell, and the card's idle time of its traced slice
put down to the program's spans (``lib/spans.py``).

    python3 benchmark/layers.py --workload ntt.add16_x4 --seed 7 \\
        --seconds 30

Runs ``benchmark/run.py`` with ``--trace 1`` and the same arguments in this
process (rank 0; a four-card cell starts its other ranks as ``run.py``
does), keeps rank 0's exported slice, prints ``run.py``'s result line and
then one JSON object: ``spans.readings`` of the slice (the idle split by
layer, the synchronising calls by span, and the per-call readings) with
the slice's idle time as ``device_busy`` reads it, for comparison.  The
runner does not hand the slice's events to the metric readers, so this
script wraps its export to keep them.
"""

import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import manifest, runner, spans, yardstick  # noqa: E402


@contextlib.contextmanager
def kept_events():
    """Inside: the events of every slice the runner exports are appended to
    the list this yields."""
    kept = []
    export = runner._export_events

    def export_and_keep(prof):
        events = export(prof)
        kept.append(events)
        return events

    runner._export_events = export_and_keep
    try:
        yield kept
    finally:
        runner._export_events = export


def report(events, cell):
    """``spans.readings`` of a cell's slice, and the slice's idle time as
    ``yardstick.device_busy`` reads it."""
    busy = yardstick.device_busy(events, runner.SLICE_SPAN)
    out = spans.readings(events, runner.SLICE_SPAN,
                         int(cell.traffic["trace_requests"]))
    out["device_busy_idle_us"] = busy["window_us"] - busy["busy_us"]
    out["window_us"] = busy["window_us"]
    return out


def main(argv=None):
    from benchmark import run
    argv = (sys.argv[1:] if argv is None else list(argv)) + ["--trace", "1"]
    args = run.parse(argv)
    with kept_events() as kept:
        code = run.main(argv)
    if code or args.rank:
        return code
    cell = manifest.Cell(manifest.load(), args.workload)
    print(json.dumps({"layers": report(kept[0], cell)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
