"""``BENCHMARK.json`` and the files it names, each found by name: a cell's
configuration, its traffic mix (``benchmark/traffic/<mix>.json``), the
client that drives the mix's kind (``benchmark/clients/<kind>.py``, or
``<kind>.<parallel>.py`` on several cards) and the readers of its
per-layer metrics (``benchmark/metrics/<metric>.py``).

A reader's file defines ``read(run)``, which returns the metric or None
where the run holds nothing to read.  It may declare ``COUNTERS``, a tuple
of program counters (dotted names of module-level ints under
``nufhe_tpu_torch``, such as ``"ops.blind_rotate.steps"``), which the run
resets before its traced slice and reads after it into
``run.slice_counters`` under those names; ``run.events`` holds the
slice's exported trace events.  It may define ``on_synthetic(run)``, the
value ``read`` has to give on the tests' synthetic trace."""

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError("no BENCHMARK.json at %s" % root)
    return json.loads(path.read_text())


def load_module(folder, name):
    """The module of ``benchmark/<folder>/<name>.py``; a dot in ``name``
    is part of the file's name, so the module sits in ``folder``'s
    package and its relative imports resolve there."""
    path = BENCH_DIR / folder / (name + ".py")
    if not path.is_file():
        raise FileNotFoundError("no %s" % path.relative_to(ROOT))
    module_name = "benchmark.%s.%s" % (folder.replace("/", "."),
                                       name.replace(".", "__"))
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[module_name]
            raise
    return sys.modules[module_name]


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


class Cell:
    """One entry of ``workloads`` with everything it reads."""

    def __init__(self, manifest, name, root=ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json; it has %s"
                           % (name, sorted(cells)))
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.cfg = json.loads((Path(root) / self.config_entry["file"])
                              .read_text())
        self.traffic = json.loads((BENCH_DIR / "traffic" / (
            self.entry["traffic"] + ".json")).read_text())
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if _reports(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if _reports(m, name) and m["moves"] in reported]

    @property
    def client_name(self):
        kind = self.traffic["kind"]
        if int(self.cfg.get("cards", 1)) > 1:
            return "%s.%s" % (kind, self.cfg["parallel"])
        return kind

    def client_class(self):
        return load_module("clients", self.client_name).Client

    def counters(self):
        """The program counters that the cell's per-layer readers declare,
        each with the first metric that declares it."""
        out = {}
        for m in self.per_layer:
            for name in getattr(reader_module(m["name"]), "COUNTERS", ()):
                out.setdefault(name, m["name"])
        return out


def reader_module(metric_name):
    """The module of a per-layer metric's own file."""
    return load_module("metrics", metric_name)


def reader(metric_name):
    """The ``read(run)`` function of a per-layer metric's own file."""
    return reader_module(metric_name).read
