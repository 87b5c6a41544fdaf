"""``bench_torch.py`` (the port of ``bench.py``) on the CPU: its chain
against the JAX package's same chain, bit for bit; its metric line against
``bench.py``'s; the device-idle parser on a synthetic ``torch.profiler``
trace; no idle share without a card; the command lines of the three
benchmark scripts failing without a card; and what they import.

The LWE size is reduced (8 blind-rotation steps); the polynomial and
transform sizes are full.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nufhe_tpu as jnf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

LWE_SIZE = 8
BATCH = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain path at these sizes gains little from more threads; one
    leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_chain(gate, transform, calls):
    """``bench.py``'s chain in the JAX package: keys from
    ``DeterministicRNG(42)``, the same encryptions, a NAND, then ``calls -
    1`` calls of ``run_gate`` with ``dest``."""
    rng = jnf.DeterministicRNG(42)
    secret, cloud = jnf.make_key_pair(rng, lwe_size=LWE_SIZE,
                                      transform_type=transform)
    bits_a = np.random.RandomState(0).randint(0, 2, BATCH).astype(bool)
    bits_b = np.random.RandomState(1).randint(0, 2, BATCH).astype(bool)
    ca = jnf.encrypt(rng, secret, bits_a)
    cb = jnf.encrypt(rng, secret, bits_b)
    vm = jnf.VirtualMachine(cloud)
    res = vm.gate_nand(ca, cb)
    for _ in range(calls - 1):
        if gate == "mux":
            res = vm.gate_mux(ca, cb, res, dest=res)
        else:
            res = vm.gate_nand(ca, res, dest=res)
    return res


def _bench_metric_name(gate, transform, batch):
    """The metric string as ``bench.py:216-222`` builds it (the test reads
    the format and the label from its source)."""
    src = open(os.path.join(ROOT, "bench.py")).read()
    assert '"bootstrapped {}{} ms/bit (batch {})".format(' in src
    assert 'label = "" if transform == "NTT" else " fft-mode"' in src
    label = "" if transform == "NTT" else " fft-mode"
    return "bootstrapped {}{} ms/bit (batch {})".format(
        gate.upper(), label, batch)


@pytest.mark.parametrize("gate,transform", [("nand", "NTT"), ("mux", "FFT")])
def test_chain_matches_jax(gate, transform):
    metric, detail, out = bench_torch.run(
        batch=BATCH, runs=1, inner=2, gate=gate, transform=transform.lower(),
        device="cpu", lwe_size=LWE_SIZE)
    assert detail["correct"] is True
    assert detail["gate_calls"] == 4          # 2 first calls + 1 x 2 timed
    assert 0 <= detail["max_noise_frac"] < detail["noise_margin_frac"]
    ref = _jax_chain(gate, transform, detail["gate_calls"])
    assert np.array_equal(out.a.numpy(), np.asarray(ref.a))
    assert np.array_equal(out.b.numpy(), np.asarray(ref.b))

    assert set(metric) == {"metric", "value", "unit", "vs_baseline"}
    assert metric["metric"] == _bench_metric_name(gate, transform, BATCH)
    assert metric["unit"] == "ms/bit" and metric["value"] > 0
    # a CPU run measures no device figure
    assert detail["device_idle_share"] is None
    assert detail["idle_method"].startswith("not measured")
    assert detail["kernels_per_call"] is None
    assert detail["peak_memory_bytes"] is None and detail["card"] is None
    assert detail["warm_compile_s"] is None and detail["nvcc_s"] == 0
    assert set(detail["key_prep_phases_s"]) == {
        "bk_transform", "bk_rows", "ks_prep", "bk_lanes"}
    assert set(detail["key_load_phases_s"]) == {
        "deserialize", "bk_upload", "bk_rows", "bk_lanes", "ks_prep"}


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


BR = "void (anonymous namespace)::blind_rotate_kernel<2, 2, false, 0, 0>(" \
     "int const*, int*, int const*, long long const*, int, int, int, " \
     "unsigned int, int)"
KS = "void (anonymous namespace)::keyswitch_kernel<true>(int const*, " \
     "signed char const*, int*, int, int, int, int, int, int)"
EW = "void at::native::vectorized_elementwise_kernel<4, " \
     "at::native::FillFunctor<int>, std::array<char*, 1ul> >(int, " \
     "at::native::FillFunctor<int>, std::array<char*, 1ul>)"


def _synthetic_trace():
    """A 100-us chain span with known device intervals: two overlapping
    kernels (one starting before the span), a gap, a memcpy and a memset
    that overlap, a kernel, a kernel cut by the span's end, and events
    that do not count (outside the span, host-side, the device copy of
    the annotation)."""
    span = bench_torch.CHAIN_SPAN
    return [
        _kernel(span, 100.0, 100.0, cat="user_annotation"),
        _kernel(span, 100.0, 100.0, cat="gpu_user_annotation"),
        _kernel(BR, 90.0, 30.0),                        # [100, 120]
        _kernel(BR, 115.0, 20.0),                       # [115, 135]
        _kernel("Memcpy DtoH (Device -> Pinned)", 150.0, 10.0,
                cat="gpu_memcpy"),                      # [150, 160]
        _kernel("Memset (Device)", 158.0, 4.0, cat="gpu_memset"),
        _kernel(KS, 170.0, 10.0),                       # [170, 180]
        _kernel(EW, 195.0, 20.0),                       # [195, 200]
        _kernel(EW, 300.0, 5.0),                        # after the span
        _kernel("cudaLaunchKernel", 101.0, 50.0, cat="cuda_runtime"),
    ]


def test_device_busy_on_a_synthetic_trace():
    busy = bench_torch.device_busy(_synthetic_trace())
    # union: [100, 135] + [150, 162] + [170, 180] + [195, 200] = 62 us
    assert busy["window_us"] == 100.0
    assert busy["busy_us"] == pytest.approx(62.0)
    assert busy["idle_share"] == pytest.approx(0.38)
    assert busy["functions"] == {
        "blind_rotate_kernel": {"launches": 2, "us": 40.0},
        "keyswitch_kernel": {"launches": 1, "us": 10.0},
        "at::native::vectorized_elementwise_kernel":
            {"launches": 1, "us": 5.0}}

    counts = {"blind_rotate_chunk": 2, "cmux_step": 0, "keyswitch": 1}
    kernels = bench_torch.per_kernel(busy, counts, calls=2)
    assert kernels == {
        "blind_rotate_chunk": {"ms": pytest.approx(0.02), "launches": 1.0},
        "keyswitch": {"ms": pytest.approx(0.005), "launches": 0.5},
        "torch": {"ms": pytest.approx(0.0025), "launches": 0.5}}
    # the per-step path runs the same CUDA function under another counter
    kernels = bench_torch.per_kernel(
        busy, {"blind_rotate_chunk": 0, "cmux_step": 2, "keyswitch": 1}, 1)
    assert kernels["cmux_step"]["launches"] == 2


def test_device_busy_rejects_what_it_cannot_read():
    trace = _synthetic_trace()
    busy = bench_torch.device_busy(trace)
    with pytest.raises(AssertionError, match="counter"):
        bench_torch.per_kernel(
            busy, {"blind_rotate_chunk": 3, "cmux_step": 0, "keyswitch": 1}, 1)
    with pytest.raises(ValueError, match="cannot tell"):
        bench_torch.per_kernel(
            busy, {"blind_rotate_chunk": 1, "cmux_step": 1, "keyswitch": 1}, 1)
    no_ks = [e for e in trace if e["name"] != KS]
    with pytest.raises(AssertionError, match="no kernel of"):
        bench_torch.per_kernel(
            bench_torch.device_busy(no_ks),
            {"blind_rotate_chunk": 2, "cmux_step": 0, "keyswitch": 1}, 1)
    with pytest.raises(ValueError, match="spans"):
        bench_torch.device_busy(trace[1:])
    # an empty chain: the card idles the whole span
    idle = bench_torch.device_busy(trace[:2])
    assert idle["busy_us"] == 0.0 and idle["idle_share"] == 1.0


@pytest.mark.parametrize("args", [
    ["bench_torch.py"], ["bench_scaling_torch.py"],
    ["tools/adder_crossover_torch.py", "2", "4", "unused.json"]])
def test_command_line_fails_without_a_card(args, tmp_path):
    """Without CUDA each script exits non-zero and prints no result; it
    does not run on the CPU instead."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, args[0])]
                          + args[1:], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
    assert not (tmp_path / "unused.json").exists()


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [
    "bench_torch.py", "bench_scaling_torch.py",
    "tools/adder_crossover_torch.py", "tools/bench_cells_torch.py",
    "tests/test_torch_bench_scaling.py",
    "tests/test_torch_adder_crossover.py"])
def test_bench_scripts_import_neither_jax_nor_nufhe_tpu(path):
    assert not _imports(os.path.join(ROOT, path)) & {
        "jax", "jaxlib", "nufhe_tpu"}
