"""The port's spans and counters: ``utils/profiling.annotate`` enters
``record_function`` only while a profiler records; under ``torch.profiler``
on the CPU a gate call and an integer circuit record the span tree of the
README's profiling paragraph, nested, a ``nufhe.bootstrap`` span for each
bootstrapped gate call.

Keys are made by the port on the CPU at lwe_size 4 (a short blind-rotation
ladder; full polynomial and transform sizes).
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nufhe_tpu_torch as nft
from nufhe_tpu_torch.models.integer import (
    bitarray_to_uintarray, uintarray_to_bitarray)
from nufhe_tpu_torch.parallel import distributed as pdist
from nufhe_tpu_torch.parallel import mesh as pmesh
from nufhe_tpu_torch.utils import profiling

LWE_SIZE = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def keys():
    """A fresh key pair, so the first gate call prepares the keys."""
    rng = nft.DeterministicRNG(17)
    secret, cloud = nft.make_key_pair(rng, lwe_size=LWE_SIZE, device="cpu")
    return rng, secret, cloud


def _encrypt(rng, secret, bits):
    return nft.encrypt(rng, secret, np.asarray(bits, bool), device="cpu")


def _vm(cloud, **perf):
    return nft.VirtualMachine(
        cloud, perf_params=nft.PerformanceParameters(cloud.params, **perf),
        device="cpu")


@pytest.fixture
def no_record_function(monkeypatch):
    """``torch.profiler.record_function`` replaced by one that fails."""
    def entered(name):
        raise AssertionError("record_function(%r) entered" % name)
    monkeypatch.setattr(torch.profiler, "record_function", entered)


def _span_forest(fn, tmp_path):
    """Run ``fn`` under ``torch.profiler`` on the CPU; the program's spans
    (``nufhe.*``) as a forest of (name, children) nested by their host
    intervals."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in events if e.get("cat") == "user_annotation"
         and e["name"].startswith("nufhe.")),
        key=lambda s: (s[0], -s[1]))
    roots, open_ = [], []
    for t0, t1, name in spans:
        while open_ and open_[-1][0] < t1:
            open_.pop()
        node = (name, [])
        (open_[-1][1][1] if open_ else roots).append(node)
        open_.append((t1, node))
    return roots


def _names(forest):
    return [(name, _names(kids)) for name, kids in forest]


def _bootstrap(keyswitch=True):
    inner = [("nufhe.bootstrap.switch", []), ("nufhe.blind_rotate", []),
             ("nufhe.extract", [])]
    if keyswitch:
        inner.append(("nufhe.keyswitch", []))
    return ("nufhe.bootstrap", inner)


BOOTSTRAPPED = ("nufhe.gate", [("nufhe.gate.linear", []), _bootstrap()])
PREPARE = ("nufhe.keys.prepare", [])


def test_annotate_off_never_enters_record_function(no_record_function):
    assert not torch.autograd._profiler_enabled()
    with profiling.annotate("nufhe.probe"):
        pass
    traced = profiling.spanned("nufhe.probe")(lambda x: x + 1)
    assert traced(1) == 2


def test_annotate_on_enters_record_function(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def recording(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", recording)

    @profiling.spanned("nufhe.outer")
    def outer():
        with profiling.annotate("nufhe.inner"):
            pass
    forest = _span_forest(outer, tmp_path)
    assert entered == ["nufhe.outer", "nufhe.inner"]
    assert _names(forest) == [("nufhe.outer", [("nufhe.inner", [])])]


def test_a_whole_circuit_with_no_profiler_opens_no_span(keys,
                                                        no_record_function):
    """The off path across a gate and a Kogge-Stone adder (K1 a step: the
    per-step loop is on the path) gives the right bits all the same."""
    rng, secret, cloud = keys
    vm = _vm(cloud, chunk_steps=1)
    bits = np.eye(4, dtype=bool)[:3]
    x = _encrypt(rng, secret, bits)
    assert np.array_equal(nft.decrypt(secret, vm.gate_nand(x, x)), ~bits)
    total = vm.uint_add(x, x, parallel=True)
    assert np.array_equal(bitarray_to_uintarray(nft.decrypt(secret, total)),
                          2 * bitarray_to_uintarray(bits) % 16)


@pytest.mark.parametrize("perf", [
    {"chunk_steps": 2},                    # K3, two launches
    {"chunk_steps": 1},                    # K1, a launch a step
    {"single_kernel_bootstrap": False},    # the lanes engine (K4)
], ids=["rows_chunked", "rows_step", "lanes"])
def test_nand_span_tree(keys, tmp_path, perf):
    """The first call prepares the keys inside its gate span; the second
    opens the same spans, one each, and none a CMUX step."""
    rng, secret, cloud = keys
    vm = _vm(cloud, **perf)
    a = _encrypt(rng, secret, [0, 1, 0, 1])
    b = _encrypt(rng, secret, [0, 0, 1, 1])
    first = _span_forest(lambda: vm.gate_nand(a, b), tmp_path)
    name, ((gate, kids),) = first[0]
    assert (name, gate) == ("nufhe.vm.gate_nand", "nufhe.gate")
    assert _names(kids) == [("nufhe.gate.linear", []), PREPARE, PREPARE,
                            _bootstrap()]
    out = []
    again = _span_forest(lambda: out.append(vm.gate_nand(a, b)), tmp_path)
    assert _names(again) == [("nufhe.vm.gate_nand", [BOOTSTRAPPED])]
    assert np.array_equal(nft.decrypt(secret, out[0]), [1, 1, 1, 0])


def test_uint_add_span_tree(keys, tmp_path):
    """A 4-bit Kogge-Stone add: XOR, AND, (MUX, AND), MUX, XOR, six
    bootstrapped gate calls under one ``nufhe.vm.uint_add``."""
    rng, secret, cloud = keys
    vm = _vm(cloud, chunk_steps=2)
    xs, ys = np.array([3, 9, 14]), np.array([5, 7, 15])
    x = _encrypt(rng, secret, uintarray_to_bitarray(xs.astype(np.uint8), 4))
    y = _encrypt(rng, secret, uintarray_to_bitarray(ys.astype(np.uint8), 4))
    vm.gate_and(x, y)       # keys prepared before the traced call
    out = []
    forest = _span_forest(lambda: out.append(vm.uint_add(x, y,
                                                         parallel=True)),
                          tmp_path)
    mux = ("nufhe.gate", [("nufhe.gate.linear", []), _bootstrap(False),
                          ("nufhe.keyswitch", [])])
    assert _names(forest) == [("nufhe.vm.uint_add", [
        BOOTSTRAPPED, BOOTSTRAPPED, mux, BOOTSTRAPPED, mux, BOOTSTRAPPED])]
    got = bitarray_to_uintarray(nft.decrypt(secret, out[0]))
    assert np.array_equal(got, (xs + ys) % 16)


def test_linear_gates_open_a_gate_span_and_no_bootstrap(keys, tmp_path):
    rng, secret, cloud = keys
    vm = _vm(cloud)
    a = _encrypt(rng, secret, [0, 1])
    forest = _span_forest(lambda: (vm.gate_not(a), vm.gate_copy(a),
                                   vm.gate_constant([True, False])), tmp_path)
    assert _names(forest) == [
        ("nufhe.vm.gate_%s" % op, [("nufhe.gate", [])])
        for op in ("not", "copy", "constant")]


def test_mesh_gather_and_replicate_spans(keys, tmp_path):
    rng, secret, cloud = keys
    assert not dist.is_initialized()
    pdist.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        mesh = pmesh.make_mesh(1, 1, device="cpu")
        ct = _encrypt(rng, secret, [1, 0, 1, 1])
        forest = _span_forest(
            lambda: (pmesh.gather_ciphertext(ct, mesh),
                     pmesh.replicate({"x": torch.arange(3)}, mesh)),
            tmp_path)
    finally:
        dist.destroy_process_group()
    assert _names(forest) == [("nufhe.mesh.gather", []),
                              ("nufhe.mesh.replicate", [])]
