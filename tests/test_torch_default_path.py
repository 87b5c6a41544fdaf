"""The JAX package's default gate path, ported: ``PerformanceParameters``,
the chunked rotation, the rounded-key ('FFT') engine, the coarse modulus
switch, and MUX/NOT/COPY/CONSTANT, against the JAX package on the CPU.
Ciphertexts are bit-equal in ``a`` and ``b``, ``cv`` allclose at rtol 1e-6.

The LWE size is reduced (16 blind-rotation steps) as in the JAX package's
own gate tests; the polynomial and transform sizes are full.
"""

import numpy as np
import pytest
import torch

import nufhe_tpu as jnf
from nufhe_tpu.performance import PerformanceParameters as JPerf

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ops import blind_rotate as brc, cmux, keyswitch as tks

LWE_SIZE = 16
SEED = 4242


def _port_keys(jsecret, jcloud, transform_type):
    params = tnf.NuFHEParameters(lwe_size=LWE_SIZE,
                                 transform_type=transform_type)
    bk, ks = jcloud.bootstrap_key, jcloud.keyswitch_key
    tcloud = tnf.cloud_key_from_arrays(
        params, np.asarray(bk.bk_coeff), np.asarray(bk.cv), np.asarray(ks.ks_a),
        np.asarray(ks.ks_b), np.asarray(ks.ks_cv), ks.log2_base)
    return tnf.secret_key_from_array(params, jsecret.lwe_key.key), tcloud


@pytest.fixture(scope="module")
def keys():
    """JAX key pairs in both engine modes (one seed, so the same arrays)
    and the port's keys built from those arrays."""
    out = {}
    for mode in ("NTT", "FFT"):
        jsecret, jcloud = jnf.make_key_pair(
            jnf.DeterministicRNG(SEED), lwe_size=LWE_SIZE, transform_type=mode,
            on_device=False)
        out[mode] = (jsecret, jcloud) + _port_keys(jsecret, jcloud, mode)
    assert np.array_equal(np.asarray(out["NTT"][1].bootstrap_key.bk_coeff),
                          np.asarray(out["FFT"][1].bootstrap_key.bk_coeff))
    return out


def _inputs(jsecret, shapes, seed):
    rng = jnf.DeterministicRNG(seed)
    bits = [np.random.RandomState(seed + i).randint(0, 2, s).astype(bool)
            for i, s in enumerate(shapes)]
    return bits, [jnf.encrypt(rng, jsecret, b) for b in bits]


def _to_port(tcloud, jcts):
    params = tcloud.params.in_out_params
    return [tnf.ciphertext_from_arrays(
        params, np.asarray(c.a), np.asarray(c.b),
        np.asarray(c.current_variances), "cpu") for c in jcts]


def _counts():
    return cmux.launches, tks.launches, brc.launches


def _assert_same(tout, jout):
    assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
    assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
    assert np.allclose(tout.current_variances.numpy(),
                       np.asarray(jout.current_variances), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode,perf", [
    ("FFT", {}),
    ("NTT", {"coarse_phase_bits": 2}),
    ("FFT", {"coarse_phase_bits": 2, "chunk_steps": 4}),
])
def test_nand_matches_jax(keys, mode, perf):
    jsecret, jcloud, tsecret, tcloud = keys[mode]
    (x, y), jcts = _inputs(jsecret, [(8,), (8,)], 9)
    jout = jnf.VirtualMachine(jcloud, JPerf(**perf)).gate_nand(*jcts)
    before = _counts()
    tout = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(**perf),
                              device="cpu").gate_nand(*_to_port(tcloud, jcts))
    assert _counts() == before          # plain versions on the CPU
    _assert_same(tout, jout)
    assert np.array_equal(tnf.decrypt(tsecret, tout), ~(x & y))


def test_chunked_nand_matches_jax_and_per_step(keys, monkeypatch):
    """chunk_steps=4 runs the 16 steps as 4 chunked launches (their plain
    versions on the CPU) and gives the same NAND as one step a launch."""
    jsecret, jcloud, tsecret, tcloud = keys["NTT"]
    (x, y), jcts = _inputs(jsecret, [(8,), (8,)], 17)
    jout = jnf.VirtualMachine(jcloud).gate_nand(*jcts)
    args = _to_port(tcloud, jcts)
    chunks = []
    plain = brc.blind_rotate_chunk_plain

    def counted(*a, **kw):
        chunks.append(a[3])
        return plain(*a, **kw)

    monkeypatch.setattr(brc, "blind_rotate_chunk_plain", counted)
    before = _counts()
    out4 = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(chunk_steps=4),
                              device="cpu").gate_nand(*args)
    assert chunks == [0, 4, 8, 12]
    out1 = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(chunk_steps=1),
                              device="cpu").gate_nand(*args)
    assert len(chunks) == 4              # chunk 1 takes the step path
    assert _counts() == before
    _assert_same(out4, jout)
    _assert_same(out1, jout)
    assert np.array_equal(tnf.decrypt(tsecret, out4), ~(x & y))


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
def test_mux_matches_jax(keys, mode):
    """b if a else c, with a (2, 4), b (4,) and c (1, 4) broadcast."""
    jsecret, jcloud, tsecret, tcloud = keys[mode]
    (a, b, c), jcts = _inputs(jsecret, [(2, 4), (4,), (1, 4)], 23)
    jout = jnf.VirtualMachine(jcloud).gate_mux(*jcts)
    before = _counts()
    tout = tnf.VirtualMachine(tcloud, device="cpu").gate_mux(
        *_to_port(tcloud, jcts))
    assert _counts() == before
    assert tout.shape == (2, 4)
    _assert_same(tout, jout)
    assert np.array_equal(tnf.decrypt(tsecret, tout), np.where(a, b, c))


def test_linear_gates_match_jax(keys):
    jsecret, jcloud, tsecret, tcloud = keys["NTT"]
    (a,), jcts = _inputs(jsecret, [(4,)], 31)
    (ta,) = _to_port(tcloud, jcts)
    jvm = jnf.VirtualMachine(jcloud)
    tvm = tnf.VirtualMachine(tcloud, device="cpu")
    for name, want in (("gate_not", ~a), ("gate_copy", a)):
        jout = getattr(jvm, name)(jcts[0])
        tout = getattr(tvm, name)(ta)
        _assert_same(tout, jout)
        assert np.array_equal(tnf.decrypt(tsecret, tout), want)
    # into a (3, 4) destination: the leading axis replicates
    dest = tvm.empty_ciphertext((3, 4))
    tvm.gate_not(ta, dest=dest)
    jdest = jvm.empty_ciphertext((3, 4))
    jvm.gate_not(jcts[0], dest=jdest)
    _assert_same(dest, jdest)
    assert np.array_equal(tnf.decrypt(tsecret, dest),
                          np.broadcast_to(~a, (3, 4)))
    vals = np.array([[True, False, True, True], [False, False, True, False]])
    tout = tvm.gate_constant(vals)
    _assert_same(tout, jvm.gate_constant(vals))
    assert np.array_equal(tnf.decrypt(tsecret, tout), vals)
    assert tvm.gate_constant([True, False]).shape == (2,)


def test_for_device_resolution(monkeypatch):
    monkeypatch.delenv("NUFHE_TPU_CHUNK_STEPS", raising=False)
    monkeypatch.delenv("NUFHE_TPU_COARSE_PHASE_BITS", raising=False)
    perf = tnf.PerformanceParameters()
    cpu = perf.for_device("cpu")
    assert (cpu.chunk_steps, cpu.coarse_phase_bits) == (1, 0)
    assert cpu.single_kernel_bootstrap       # unset: the rows engine
    # only the device's type is read, so no card is needed
    cuda = perf.for_device(torch.device("cuda", 0))
    assert (cuda.chunk_steps, cuda.coarse_phase_bits) == (50, 0)
    assert cuda.single_kernel_bootstrap
    assert tnf.PerformanceParameters(
        chunk_steps=5, coarse_phase_bits=9).for_device("cuda").coarse_phase_bits \
        == 4
    monkeypatch.setenv("NUFHE_TPU_CHUNK_STEPS", "25")
    monkeypatch.setenv("NUFHE_TPU_COARSE_PHASE_BITS", "1")
    for dev in ("cpu", "cuda"):
        got = perf.for_device(dev)
        assert (got.chunk_steps, got.coarse_phase_bits) == (25, 1)
    assert tnf.PerformanceParameters(chunk_steps=2).for_device(
        "cuda").chunk_steps == 2
    # False selects the lanes engine on every device
    for dev in ("cpu", "cuda"):
        lanes = tnf.PerformanceParameters(
            single_kernel_bootstrap=False).for_device(dev)
        assert not lanes.single_kernel_bootstrap
        assert lanes.chunk_steps == 25
    # the TPU memory knobs are kept and select nothing
    kept = tnf.PerformanceParameters(batch_tile=512, vmem_mb=64).for_device(
        "cpu")
    assert (kept.batch_tile, kept.vmem_mb) == (512, 64)
    assert perf == tnf.PerformanceParameters()
    assert perf.for_device("cpu") == tnf.PerformanceParameters().for_device(
        "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):     # no card and no device named
        perf.for_device()
