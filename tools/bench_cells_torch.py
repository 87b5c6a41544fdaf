"""Run ``bench_torch.py``'s cells, each in a process of its own on the card:
the cells of ``tools/run_artifacts_r5.sh`` (the JAX rounds' ``bench.py``
runs), as settings of the same command.

    python3 tools/bench_cells_torch.py [cell ...] > cells.jsonl

Prints one JSON line a cell, ``{"cell", "settings", "metric", "detail"}``:
the cell's name and environment settings and ``bench_torch.py``'s two
lines.  ``NUFHE_BENCH_RUNS`` and ``_INNER`` pass through (``chip_smoke.py``
runs every cell at 1 and 2).  A cell whose command fails raises.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> settings; the headline first (rounded-key 'FFT' NAND at 2^14)
CELLS = {
    "nand_fft": {"NUFHE_BENCH_TRANSFORM": "fft"},
    "nand_ntt": {"NUFHE_BENCH_TRANSFORM": "ntt"},
    "mux_ntt": {"NUFHE_BENCH_GATE": "mux", "NUFHE_BENCH_TRANSFORM": "ntt"},
    "mux_fft": {"NUFHE_BENCH_GATE": "mux", "NUFHE_BENCH_TRANSFORM": "fft"},
    # batch 2^16: one card's largest cell
    "nand_fft_b65536": {"NUFHE_BENCH_TRANSFORM": "fft",
                        "NUFHE_BENCH_BATCH": "65536"},
    # opt-in coarse modulus switch, level 1 (not the default)
    "nand_fft_coarse": {"NUFHE_BENCH_TRANSFORM": "fft",
                        "NUFHE_TPU_COARSE_PHASE_BITS": "1"},
}


def last_json(text, prefix="{"):
    """The last line of ``text`` that starts with ``prefix``, as JSON."""
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    if not lines:
        raise ValueError("no JSON line")
    return json.loads(lines[-1])


def run_cell(name, extra_env=None, timeout=900):
    """``bench_torch.py`` with cell ``name``'s settings (and
    ``extra_env``): ``{"cell", "settings", "metric", "detail"}``."""
    settings = CELLS[name]
    env = dict(os.environ, **settings, **(extra_env or {}))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError("bench_torch.py cell %s failed (rc %d):\n%s"
                           % (name, proc.returncode, proc.stderr[-3000:]))
    return {"cell": name, "settings": settings,
            "metric": last_json(proc.stdout),
            "detail": last_json(proc.stderr, '{"detail"')["detail"]}


def main(argv):
    for name in argv[1:] or CELLS:
        print(json.dumps(run_cell(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
