"""BENCHMARK.json against the benchmark's contract, every file it names,
and the benchmark's arithmetic on synthetic numbers and traces."""

import json
import re
import shutil
import statistics
import time
import types

import pytest

from benchmark.lib import client, manifest, program, yardstick
from benchmark.tests.conftest import ROOT

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_text():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["source"].startswith("https://")
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if m in M["end_to_end"] else {"layer", "moves"})
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for name in names:
        assert NAME.match(name), name
    assert len(set(w["name"] for w in M["workloads"])) == len(CELLS)
    assert len(set(c["name"] for c in M["configs"])) == len(M["configs"])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_end_to_end_metrics_and_bounds():
    by_name = {m["name"]: m for m in M["end_to_end"]}
    assert by_name["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m["name"] for m in M["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2, cell
        layer = [m for m in M["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer, cell


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        assert TEXT.match(m["layer"])
    for m in M["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_four_card_cells_and_budget():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each allowed
    # run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_named_file_exists():
    for c in M["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert c["reduced"] == []
        for key in ("transform_type", "lwe_size", "tlwe_polynomial_degree",
                    "tlwe_mask_size", "bs_decomp_length", "bs_log2_base",
                    "ks_decomp_length", "ks_log2_base", "cards", "control",
                    "guarantees"):
            assert key in cfg, (c["name"], key)
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    for w in M["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / (w["traffic"] + ".json")) \
            .is_file()
        cell = manifest.Cell(M, w["name"])
        assert cell.chips == cell.cfg["cards"]
        assert issubclass(cell.client_class(), client.Client)
        if "reference" in cell.traffic:
            ref = manifest.load_module("reference/ops",
                                       cell.traffic["reference"])
            assert callable(ref.circuit) and callable(ref.plain)
    for m in M["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_window_rate_and_percentiles():
    assert yardstick.window_ms_per_bit(2.0, 100000) == pytest.approx(0.02)
    values = [float(v) for v in range(1, 201)]
    assert yardstick.percentile(values, 50) == 100.0
    assert yardstick.percentile(values, 95) == 190.0
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile(list(reversed(values)), 95) == 190.0
    # the spread the bounds are set from: quartiles as statistics gives them
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)


def test_roofline_formulas():
    ntt = {"tlwe_mask_size": 1, "bs_decomp_length": 2,
           "tlwe_polynomial_degree": 1024, "transform_type": "NTT"}
    fft = dict(ntt, transform_type="FFT")
    # 2 x 64 slots x 256 limbs x Q (320 exact, 256 rounded) a sample-step
    assert yardstick.cmux_mac_ops(ntt, 1, 1) == 2 * 64 * 256 * 320
    assert yardstick.cmux_mac_ops(fft, 1, 1) == 2 * 64 * 256 * 256
    # a NAND call at 2^14: 43.4 ms exact, 34.7 ms rounded, bound by ops
    assert yardstick.cmux_bound_s(ntt, 16384, 500) == pytest.approx(
        0.0434, rel=2e-3)
    assert yardstick.cmux_bound_s(fft, 16384, 500) == pytest.approx(
        0.03472, rel=2e-3)
    # one sample: bound by the key's bytes
    one = yardstick.cmux_bound_s(ntt, 1, 500)
    assert one == pytest.approx(
        yardstick.cmux_min_bytes(ntt, 1, 500) / yardstick.PEAK_BYTES_PER_S)
    assert yardstick.cmux_min_bytes(ntt, 1, 1) == 2 * 2 * 1024 * 4 + 4 \
        + 2 * 2 * 2 * 1024 * 4


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
@pytest.mark.parametrize("k, l", [(1, 2), (2, 3)])
def test_the_mac_count_follows_the_degree(mode, k, l):
    """L = 2 N / 32 slots: half the MAC at N = 512, all else equal."""
    cfg = {"tlwe_mask_size": k, "bs_decomp_length": l,
           "tlwe_polynomial_degree": 1024, "transform_type": mode}
    half = dict(cfg, tlwe_polynomial_degree=512)
    full = yardstick.cmux_mac_ops(cfg, 16384, 500)
    assert yardstick.cmux_mac_ops(half, 16384, 500) * 2 == full
    assert yardstick.cmux_mac_ops(dict(cfg, tlwe_polynomial_degree=256),
                                  16384, 500) * 4 == full


def _trace():
    """A span from 100 to 200 us with kernels inside, across and outside
    it, overlapping ones, a memcpy and a host event over the gap."""
    k = "kernel"
    return [
        {"cat": "user_annotation", "name": "s", "ts": 100, "dur": 100},
        {"cat": k, "name": "void (anonymous namespace)::blind_rotate_kernel"
         "<2, 2>(int const*)", "ts": 90, "dur": 20},        # 100-110
        {"cat": k, "name": "void blind_rotate_kernel<3>(int*)", "ts": 120,
         "dur": 30},                                          # 120-150
        {"cat": k, "name": "keyswitch_kernel", "ts": 140, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 170, "dur": 5},
        {"cat": k, "name": "late", "ts": 195, "dur": 50},     # 195-200
        {"cat": k, "name": "outside", "ts": 300, "dur": 50},
        {"cat": "cpu_op", "name": "aten::fill_", "ts": 175, "dur": 20},
        {"cat": "cpu_op", "name": "outer", "ts": 100, "dur": 100},
    ]


def test_device_busy_on_a_synthetic_trace():
    busy = yardstick.device_busy(_trace(), "s")
    assert busy["window_us"] == 100
    # 100-110, 120-160, 170-175, 195-200
    assert busy["busy_us"] == 10 + 40 + 5 + 5
    f = busy["functions"]
    assert f["blind_rotate_kernel"] == {"launches": 2, "us": 40.0}
    assert f["keyswitch_kernel"] == {"launches": 1, "us": 20.0}
    assert "outside" not in f and f["late"]["us"] == 5.0
    assert busy["gaps"][0] == (20.0, "aten::fill_")       # 175-195
    assert sorted(g for g, _ in busy["gaps"]) == [10.0, 10.0, 20.0]
    out = yardstick.breakdown(busy)
    assert out["device_ops"][0] == ["blind_rotate_kernel", 40e-6]
    assert out["idle_gaps"][0] == ["aten::fill_", 20e-6]
    with pytest.raises(ValueError):
        yardstick.device_busy(_trace(), "missing")


def test_kernel_function_names():
    kf = yardstick.kernel_function
    assert kf("void (anonymous namespace)::f<2, 2>(int*)") == "f"
    assert kf("keyswitch_kernel") == "keyswitch_kernel"
    assert kf("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::FillFunctor<int>>(int, T1, T2)") == \
        "at::native::vectorized_elementwise_kernel"


SYNTHETIC_COUNT = 7     # the slice value of every declared program counter


class _Run:
    """What a metric reader sees, from the synthetic trace: its events, and
    the launch counters and each counter that ``metrics`` (the cell's
    per-layer metrics by default) declare."""

    def __init__(self, cell, metrics=None):
        c = manifest.Cell(M, cell)
        self.cfg, self.traffic, self.world = c.cfg, c.traffic, c.cfg["cards"]
        self.events = _trace()
        self.busy = yardstick.device_busy(self.events, "s")
        self.busy_s, self.window_s = 60e-6, 100e-6
        if metrics is not None:
            c.per_layer = [{"name": name} for name in metrics]
        self.slice_counters = {"k2": 1, "k3": 2, "k1": 0, "k4": 0}
        self.slice_counters.update(dict.fromkeys(c.counters(),
                                                 SYNTHETIC_COUNT))
        self.slice_requests = 1
        self.key_prep_s = 0.05
        self.client = type("D", (), {"gather_s": [0.001, 0.003]})()


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_a_synthetic_trace(cell):
    run = _Run(cell)
    for m in M["per_layer"]:
        if cell in m.get("workloads", CELLS):
            _check_reader(m["name"], run)


def _check_reader(name, run):
    """The reader of the metric ``name`` on a synthetic run against its
    expectation: a branch here, or the value of ``on_synthetic(run)`` in
    the reader's own file.  That value is worked out from the synthetic
    trace's known durations and counts, so ``on_synthetic`` may be neither
    ``read`` itself nor call it."""
    module = manifest.reader_module(name)
    expect = getattr(module, "on_synthetic", None)
    if expect is not None and (expect is module.read or "read" in
                               expect.__code__.co_names):
        raise AssertionError("on_synthetic of %s reads its value through "
                             "read(), so it checks nothing" % name)
    value = module.read(run)
    if name == "key_prep_s":
        assert value == 0.05
    elif name.startswith("idle_share"):
        assert value == pytest.approx(40.0)
    elif name == "k2_ms_per_call.gates":
        assert value == pytest.approx(0.02)
    elif name == "torch_ms_per_call.gates":
        assert value == pytest.approx(5 / 1e3)    # the kernel "late"
    elif name == "k3_roofline.gates":
        tr = run.traffic
        samples = tr["batch"] * (2 if tr["gate"] == "mux" else 1)
        bound = yardstick.cmux_bound_s(run.cfg, samples,
                                       run.cfg["lwe_size"])
        assert value == pytest.approx(100 * bound / 40e-6)
    elif name == "k3_us_per_step.circuit":
        assert value == pytest.approx(40.0 / run.cfg["lwe_size"])
    elif name == "gate_calls_per_request.circuit":
        assert value == 1
    elif name == "gather_ms_per_request.dp4":
        assert value == pytest.approx(3.0)   # after the warm-up's
    elif name == "k4_roofline.dp4":
        assert value is None        # no K4 in the synthetic trace
        run.busy = {"functions": {"lanes_mac_kernel": {"us": 3e6},
                                  "lanes_inverse_kernel": {"us": 1e6}}}
        bound = yardstick.cmux_bound_s(run.cfg, 16384, 500)
        assert module.read(run) == pytest.approx(100 * bound / 4.0)
        run.busy = yardstick.device_busy(_trace(), "s")
    elif expect is not None:
        want = expect(run)
        if want is None:
            assert value is None, name
        else:
            assert value == pytest.approx(want), name
    else:
        raise AssertionError("no expectation for %s" % name)


PROBE = """
COUNTERS = ("ops.blind_rotate.steps",)


def read(run):
    spans = [e for e in run.events if e.get("cat") == "user_annotation"]
    return run.slice_counters["ops.blind_rotate.steps"] / len(spans)
"""


def test_a_reader_file_brings_its_counters_and_its_expectation(
        tmp_path, monkeypatch):
    """A metric's file alone declares a program counter, reads it and the
    slice's events, and carries its value on the synthetic trace
    (``on_synthetic``); a file with neither that nor a branch of
    ``_check_reader`` fails the synthetic-trace check."""
    folder = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR / "traffic", folder / "traffic")
    (folder / "metrics").mkdir()
    (folder / "metrics" / "probe_steps.gates.py").write_text(
        PROBE + "\n\ndef on_synthetic(run):\n    return 7.0\n")
    (folder / "metrics" / "probe_bare.gates.py").write_text(PROBE)
    monkeypatch.setattr(manifest, "BENCH_DIR", folder)
    run = _Run("fft.nand_b16384", ["probe_steps.gates", "probe_bare.gates"])
    assert run.slice_counters["ops.blind_rotate.steps"] == SYNTHETIC_COUNT
    _check_reader("probe_steps.gates", run)
    with pytest.raises(AssertionError, match="no expectation"):
        _check_reader("probe_bare.gates", run)


@pytest.mark.parametrize("expectation", [
    "on_synthetic = read\n",
    "def on_synthetic(run):\n    return read(run)\n"])
def test_an_expectation_may_not_come_from_the_reader(
        expectation, tmp_path, monkeypatch):
    """``on_synthetic`` that is ``read``, or calls it, fails the
    synthetic-trace check whatever it returns."""
    folder = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR / "traffic", folder / "traffic")
    (folder / "metrics").mkdir()
    (folder / "metrics" / "probe_self.gates.py").write_text(
        PROBE + "\n\n" + expectation)
    monkeypatch.setattr(manifest, "BENCH_DIR", folder)
    run = _Run("fft.nand_b16384", ["probe_self.gates"])
    with pytest.raises(AssertionError, match="checks nothing"):
        _check_reader("probe_self.gates", run)


@pytest.mark.parametrize("key", sorted(program.LAUNCHES))
def test_the_launch_counters_resolve(key):
    """Each launch counter the readers read by the benchmark's name is a
    program counter of the port, resolved as a declared one is."""
    module, attr = program.program_counter(program.LAUNCHES[key],
                                           "the harness")
    assert attr == "launches" and type(getattr(module, attr)) is int


@pytest.mark.parametrize("name", ["ops.blind_rotate.stepz", "steps",
                                  "ops.no_such_module.steps",
                                  "ops.blind_rotate.torch"])
def test_a_counter_that_does_not_resolve_raises(name):
    with pytest.raises(ValueError, match="probe.gates"):
        program.program_counter(name, "probe.gates")


def test_a_declared_counter_reads_its_slice_value(monkeypatch):
    """A traced CPU run of a small cell with a reader that declares
    ``ops.blind_rotate.steps``, counted here once a bootstrap: the run
    resets it before the slice (from 1000) and the reader sees the slice's
    count and the slice's events; a name that does not resolve stops the
    run and names the reader."""
    from nufhe_tpu_torch.ops import blind_rotate, bootstrap
    from benchmark.lib import runner
    from benchmark.tests.conftest import small_cell

    real = bootstrap.bootstrap_device

    def counted(*args, **kwds):
        blind_rotate.steps += 1
        return real(*args, **kwds)

    monkeypatch.setattr(bootstrap, "bootstrap_device", counted)
    monkeypatch.setattr(blind_rotate, "steps", 1000)
    seen = {}

    def read(run):
        seen["events"] = run.events
        return run.slice_counters["ops.blind_rotate.steps"]

    probe = types.SimpleNamespace(COUNTERS=("ops.blind_rotate.steps",),
                                  read=read)
    modules = manifest.reader_module
    monkeypatch.setattr(manifest, "reader_module", lambda name: probe
                        if name == "probe.gates" else modules(name))
    cell = small_cell("fft.nand_b16384")
    cell.per_layer.append({"name": "probe.gates", "unit": "steps"})
    assert cell.counters()["ops.blind_rotate.steps"] == "probe.gates"
    res = runner.run_cell(cell, 2**33 + 9, 0.1, True, "cpu",
                          time.perf_counter(), log=lambda *a: None)
    assert res["correct"]
    assert res["metrics"]["probe.gates"]["value"] == \
        cell.traffic["trace_requests"] * cell.traffic["gates_per_request"]
    assert any(e.get("name") == runner.SLICE_SPAN for e in seen["events"])
    probe.COUNTERS = ("ops.blind_rotate.stepz",)
    with pytest.raises(ValueError, match="probe.gates"):
        runner.run_cell(cell, 2**33 + 9, 0.1, True, "cpu",
                        time.perf_counter(), log=lambda *a: None)


def test_a_configuration_sets_performance_and_its_control():
    """A configuration's ``performance`` entry reaches the program's
    ``PerformanceParameters``; its control overrides it."""
    from benchmark.lib import data
    cfg = dict(manifest.Cell(M, "fft.nand_b16384").cfg, lwe_size=4,
               performance={"chunk_steps": 2, "coarse_phase_bits": 0})
    g = data.generator(1, "cpu", 0)
    raw = data.make_raw_cloud_key(cfg, data.Secret(cfg, g), g)
    prog = program.Program(cfg, raw, "cpu")
    assert (prog.perf.chunk_steps, prog.perf.coarse_phase_bits) == (2, 0)
    prog = program.Program(cfg, raw, "cpu", cfg["control"])
    assert (prog.perf.chunk_steps, prog.perf.coarse_phase_bits) == (2, 1)
    assert prog.params.transform_type == "FFT"


def test_files_are_found_by_name(tmp_path, monkeypatch):
    """A client kind and a reference circuit are files found by their
    names, with no list to edit."""
    folder = tmp_path / "benchmark"
    for sub in ("clients", "reference/ops", "lib"):
        (folder / sub).mkdir(parents=True)
    (folder / "clients" / "echo.fleet.py").write_text(
        "from ..lib.client import Client as Base\n"
        "class Client(Base):\n    pass\n")
    (folder / "reference" / "ops" / "twice.py").write_text(
        "def plain(x, y, w):\n    return 2 * x\n")
    monkeypatch.setattr(manifest, "BENCH_DIR", folder)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    assert issubclass(manifest.load_module("clients", "echo.fleet").Client,
                      client.Client)
    assert manifest.load_module("reference/ops", "twice").plain(3, 0, 1) == 6
    with pytest.raises(FileNotFoundError):
        manifest.load_module("clients", "absent")
