"""``lib/spans.py`` on synthetic traces, and ``layers.py``'s reading of a
small traced run on the CPU: the card's idle time put down to the
program's spans by measure, the synchronising calls inside them and the
device time of the work they launched."""

import time

import numpy as np
import pytest

from benchmark import layers
from benchmark.lib import runner, spans, yardstick
from benchmark.tests.conftest import small_cell

SLICE = runner.SLICE_SPAN


def _span(name, t0, t1):
    return {"cat": "user_annotation", "name": name, "ts": t0, "dur": t1 - t0}


def _kernel(t0, t1, corr=None, name="k"):
    e = {"cat": "kernel", "name": name, "ts": t0, "dur": t1 - t0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _runtime(name, t0, t1, corr=None):
    e = {"cat": "cuda_runtime", "name": name, "ts": t0, "dur": t1 - t0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _gate(t0, linear, boot):
    """A bootstrapped gate span and its children, a sync in its switch."""
    b0, b1 = boot
    return [_span("nufhe.gate", t0, b1 + 10),
            _span("nufhe.gate.linear", *linear),
            _span("nufhe.bootstrap", b0, b1),
            _span("nufhe.bootstrap.switch", b0, b0 + 40),
            _runtime("cudaMemcpyAsync", b0 + 10, b0 + 15),
            _runtime("cudaStreamSynchronize", b0 + 20, b0 + 30),
            _span("nufhe.blind_rotate", b0 + 40, b1 - 40),
            _span("nufhe.extract", b1 - 40, b1 - 20),
            _span("nufhe.keyswitch", b1 - 20, b1)]


def _trace():
    """A slice of 0-1000 us: an integer circuit of two gates (100-900), a
    gather (920-980) whose launch (correlation 7) runs a 30-us kernel, and
    the card busy 0-50, 260-390, 600-780, 940-970, 990-1000."""
    return ([_span(SLICE, 0, 1000),
             _span("nufhe.vm.uint_add", 100, 900)]
            + _gate(150, (160, 200), (210, 440))
            + _gate(500, (500, 520), (530, 790))
            + [_runtime("cudaDeviceSynchronize", 850, 860),
               _span("nufhe.mesh.gather", 920, 980),
               _runtime("cudaLaunchKernel", 930, 935, corr=7),
               _runtime("cudaLaunchKernel", 985, 988, corr=8),
               _kernel(-20, 50), _kernel(260, 390), _kernel(600, 780),
               _kernel(940, 970, corr=7, name="ncclDevKernel_AllGather"),
               _kernel(990, 1010, corr=8),
               _span("nufhe.gate", 1100, 1200)])     # after the slice


def test_idle_split_on_a_synthetic_trace():
    events = _trace()
    by_chain = spans.idle_by_chain(events, SLICE)
    parts = spans.idle_parts(by_chain)
    # idle 50-260, 390-600, 780-940, 970-990
    assert parts == {"gates": 110 + 60 + 100 + 20,
                     "vm_outside_gates": 50 + 50 + 100,
                     "other_spans": 20 + 10,
                     "no_span": 50 + 20 + 10}
    busy = yardstick.device_busy(events, SLICE)
    assert sum(parts.values()) == busy["window_us"] - busy["busy_us"] == 600
    inner = spans.by_innermost(by_chain)
    assert inner["nufhe.bootstrap.switch"] == 40 + 40    # 210-250, 530-570
    assert inner["nufhe.gate.linear"] == 40 + 20
    assert inner["nufhe.mesh.gather"] == 30
    assert by_chain[("nufhe.vm.uint_add", "nufhe.gate",
                     "nufhe.bootstrap", "nufhe.keyswitch")] == 20 + 10


def test_syncs_and_launched_device_time():
    events = _trace()
    assert spans.count(events, SLICE, "nufhe.gate") == 2
    assert spans.syncs_inside(events, SLICE, "nufhe.bootstrap") == 2
    assert spans.syncs_inside(events, SLICE, "nufhe.vm.uint_add") == 3
    assert spans.syncs_by_innermost(events, SLICE) == {
        "nufhe.bootstrap.switch": 2, "nufhe.vm.uint_add": 1}
    assert spans.device_us_launched_inside(
        events, SLICE, "nufhe.mesh.gather") == 30


def test_the_per_layer_readings():
    out = spans.readings(_trace(), SLICE, requests=2)
    assert out["idle_us"] == 600
    assert out["bootstrapped_gates"] == out["bootstraps"] == 2
    assert out["idle_in_gates_ms_per_call"] == pytest.approx(290 / 1e3 / 2)
    assert out["idle_in_circuit_ms_per_request"] == pytest.approx(
        200 / 1e3 / 2)
    assert out["syncs_per_bootstrap"] == 1.0
    assert out["gather_device_ms_per_request"] == pytest.approx(
        30 / 1e3 / 2)


def test_a_trace_without_program_spans_reads_nothing():
    """The parent's trace: the slice alone, all its idle under no span."""
    events = [e for e in _trace() if not e["name"].startswith("nufhe.")]
    out = spans.readings(events, SLICE, requests=2)
    assert out["idle_parts_us"]["no_span"] == out["idle_us"] == 600
    for name in ("idle_in_gates_ms_per_call",
                 "idle_in_circuit_ms_per_request", "syncs_per_bootstrap",
                 "gather_device_ms_per_request"):
        assert out[name] is None


@pytest.mark.parametrize("seed", range(6))
def test_the_parts_add_up_to_the_slice_idle(seed):
    """Random nested spans and random overlapping kernels."""
    r = np.random.RandomState(seed)
    events = [_span(SLICE, 0.0, 5000.0)]
    t = float(r.uniform(-50, 50))
    while t < 5200:
        t1 = t + float(r.uniform(50, 600))
        events.append(_span("nufhe.vm.uint_add", t, t1))
        g = t + float(r.uniform(0, 20))
        while g < t1 - 30:
            g1 = min(t1 - 1, g + float(r.uniform(10, 200)))
            events.append(_span("nufhe.gate", g, g1))
            events.append(_span("nufhe.bootstrap", g + (g1 - g) / 3, g1))
            g = g1 + float(r.uniform(0, 30))
        t = t1 + float(r.uniform(0, 100))
    for _ in range(300):
        k0 = float(r.uniform(-100, 5100))
        events.append(_kernel(k0, k0 + float(r.exponential(15))))
    parts = spans.idle_parts(spans.idle_by_chain(events, SLICE))
    busy = yardstick.device_busy(events, SLICE)
    assert sum(parts.values()) == pytest.approx(
        busy["window_us"] - busy["busy_us"], rel=1e-12, abs=1e-6)
    assert min(parts.values()) >= 0 and parts["other_spans"] == 0


def test_layers_reads_a_small_traced_run_on_the_cpu():
    """The adder cell at lwe_size 4 on 4-bit integers, traced: six
    bootstrapped gate calls a request under ``nufhe.vm.uint_add``; without
    the card every microsecond of the slice is idle."""
    cell = small_cell("ntt.add16_x4")
    with layers.kept_events() as kept:
        res = runner.run_cell(cell, 2**33 + 5, 0.1, True, "cpu",
                              time.perf_counter(), log=lambda *a: None)
    assert res["correct"] and len(kept) == 1
    out = layers.report(kept[0], cell)
    requests = cell.traffic["trace_requests"]
    assert out["bootstrapped_gates"] == out["bootstraps"] == 6 * requests
    assert out["idle_us"] == out["device_busy_idle_us"] == out["window_us"]
    parts = out["idle_parts_us"]
    assert sum(parts.values()) == pytest.approx(out["idle_us"])
    assert parts["gates"] > parts["vm_outside_gates"] > 0
    assert out["syncs_per_bootstrap"] == 0
    assert out["gather_device_ms_per_request"] is None
    assert runner._export_events.__name__ == "_export_events"
