"""The TFHE library's default 128-bit gate-bootstrapping parameters on the
port's normal path, against the benchmark's plain reference.

The set is ``new_default_gate_bootstrapping_parameters`` of the TFHE library
(``src/libtfhe/tfhe_gate_bootstrapping.cpp``): N = 1024, k = 1, n = 630,
bootstrap l = 3 at base 2^7, keyswitch 8 digits of 2 bits, the benchmark's
configuration ``tfhe_lib_128_ntt``.  Keys and inputs are the benchmark's own
(``benchmark/lib/data.py``, seeded, on the CPU); the port's gates
(``VirtualMachine.gate_*`` through ``ops/bootstrap.bootstrap_device``)
must equal ``benchmark/reference/tfhe.py`` word for word, the 'NTT' engine
against the exact reference and 'FFT' against its rounded-key mode.  Every
width is the published one except n: 63 steps with ``chunk_steps=50`` run
one full K3 chunk and a tail of 13.

The reference is exact at l = 3.  In ``external_product`` the digits'
forward transform sums 32 digits of at most 2^6 at base 2^7 (2^9 at base
2^10), so |d_hat| <= 2^11 (2^14); each product with a 13-bit limb of the
key (the signed top limb is smaller) sums g R = 6 x 32 = 192 terms, so
every partial sum stays below 192 x 2^14 x 2^13 < 2^34.6 even at base 2^10,
and below 2^31.6 at base 2^7: far inside float64's 2^53 of exact integers.
The inverse sums 2048 terms of a 13-bit limb times at most 2, below 2^25.
The port's plain paths are in int64 and the reference in float64 on exact
integers, so TF32 does not arise.
"""

import os
import sys

import numpy as np
import pytest
import torch

import nufhe_tpu as jnf
import nufhe_tpu_torch as nft
from nufhe_tpu_torch.ops import blind_rotate as brc, bootstrap, cmux

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.lib import data, manifest, program  # noqa: E402
from benchmark.reference import tfhe  # noqa: E402

CELL = "tfhe_ntt.nand_b16384"
LWE_SIZE = 63          # a chunk of 50 and a tail of 13
CHUNK = 50
SEED = 2**33 + 630
BATCH = 6
JAX_SEED = 630         # numpy's generator takes seeds below 2^32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain path at these sizes gains little from more threads; one
    leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    return manifest.Cell(manifest.load(), CELL).cfg


class _RowsByStep:
    """The reference's prepared bootstrap key (``tfhe.Keys.bk``), each
    step's rows prepared when ``tfhe.blind_rotate`` reads them: the
    preparation is row by row, so this is the same key without holding
    all n steps' (G, O, L, R, R) int64 blocks at once."""

    def __init__(self, bk_coeff, exact):
        self.bk_coeff, self.exact = bk_coeff, exact

    def __getitem__(self, i):
        return tfhe.prepare_bootstrap_key(self.bk_coeff[i:i + 1],
                                          self.exact)[0]


@pytest.fixture(scope="module")
def keys():
    """The benchmark's secret and raw cloud key at n = 63, and for each
    engine the port's program (``chunk_steps=50``) and the reference's
    keys."""
    cfg = dict(_config(), lwe_size=LWE_SIZE)
    g = data.generator(SEED, "cpu", 0)
    secret = data.Secret(cfg, g)
    raw = data.make_raw_cloud_key(cfg, secret, g)
    sides = {}
    for mode in ("NTT", "FFT"):
        mcfg = dict(cfg, transform_type=mode,
                    performance={"chunk_steps": CHUNK})
        prog = program.Program(mcfg, raw, "cpu")
        ref = tfhe.Keys(mcfg, raw["bk_coeff"][:1], raw["ks_a"], raw["ks_b"])
        ref.bk = _RowsByStep(raw["bk_coeff"], ref.exact)
        sides[mode] = (prog, ref)
    return secret, sides, data.generator(SEED, "cpu", 1)


def test_the_configuration_holds_the_library_parameters():
    cfg = _config()
    entry = manifest.Cell(manifest.load(), CELL).config_entry
    assert entry["reduced"] == []
    assert entry["source"].startswith(
        "https://github.com/tfhe/tfhe/blob/master/src/libtfhe/"
        "tfhe_gate_bootstrapping.cpp")
    assert "new_default_gate_bootstrapping_parameters" in entry["source"]
    assert cfg["lwe_noise_stdev"] == 2.0**-15
    assert cfg["bootstrap_noise_stdev"] == 2.0**-25
    assert cfg["max_noise_stdev"] == 0.012467
    assert cfg["control"] == {"transform_type": "FFT"}
    assert set(cfg["assumed"]) == {"lwe_noise_stdev",
                                   "bootstrap_noise_stdev", "batch"}
    params = nft.NuFHEParameters(**{k: cfg[k] for k in program.PARAM_KEYS})
    tp = params.tgsw_params
    assert params.transform_type == "NTT"
    assert params.in_out_params.size == 630
    assert (tp.tlwe_params.polynomial_degree, tp.tlwe_params.mask_size) \
        == (1024, 1)
    assert (tp.decomp_length, tp.bs_log2_base) == (3, 7)
    assert (params.ks_decomp_length, params.ks_log2_base) == (8, 2)
    # the gadget offset of l = 3 at base 2^7: 2^6 (2^25 + 2^18 + 2^11)
    assert int(tp.offset) == tfhe.signed32(64 * (2**25 + 2**18 + 2**11))


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
@pytest.mark.parametrize("gate", ["nand", "mux"])
def test_gates_equal_the_reference_word_for_word(keys, mode, gate):
    secret, sides, g = keys
    prog, ref = sides[mode]
    bits = [torch.randint(0, 2, (BATCH,), generator=g).bool()
            for _ in range(3)]
    enc = [data.encrypt(secret, b, g) for b in bits]
    vm = prog.virtual_machine()
    assert vm.perf_params.chunk_steps == CHUNK
    cts = [prog.ciphertext(*e) for e in enc]
    if gate == "mux":
        out = vm.gate_mux(*cts)
        want = tfhe.gate_mux(ref, *enc)
        truth = torch.where(bits[0], bits[1], bits[2])
    else:
        out = vm.gate_nand(cts[0], cts[1])
        want = tfhe.gate2(ref, "nand", enc[0], enc[1])
        truth = ~(bits[0] & bits[1])
    assert out.a.shape == (BATCH, LWE_SIZE)
    assert torch.equal(out.a.long(), want[0])
    assert torch.equal(out.b.long(), want[1])
    assert torch.equal(data.decrypt(secret, *want), truth)


def test_cpu_gate_moves_no_kernel_counter(keys):
    """The NAND on the CPU (a chunk and a tail) runs the plain versions:
    K1's and K3's launches, K3's steps and the launches that ran as pairs
    of blocks (``paired_launches``, which the card's (2, 3) launches move)
    stay where they were."""
    secret, sides, g = keys
    prog, _ = sides["NTT"]
    counters = (cmux.launches, cmux.paired_launches, brc.launches, brc.steps,
                brc.paired_launches)
    bits = [torch.randint(0, 2, (BATCH,), generator=g).bool()
            for _ in range(2)]
    cts = [prog.ciphertext(*data.encrypt(secret, b, g)) for b in bits]
    prog.virtual_machine().gate_nand(*cts)
    assert (cmux.launches, cmux.paired_launches, brc.launches, brc.steps,
            brc.paired_launches) == counters


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
def test_chunk_and_tail_equal_the_per_step_rotation(keys, mode,
                                                    monkeypatch):
    """``chunk_steps=50`` at n = 63 runs K3 on steps [0, 50) and [50, 63)
    and no K1 step, bit-equal to 63 K1 steps (``chunk_steps=1``)."""
    _, sides, g = keys
    prog, _ = sides[mode]
    bk_dev, _ = prog.prepare_keys()
    tp = prog.params.tgsw_params
    acc = torch.randint(-2**31, 2**31, (3, 2, 1024), generator=g,
                        dtype=torch.int64).to(torch.int32)
    bara = torch.randint(0, 2048, (3, LWE_SIZE), generator=g,
                         dtype=torch.int32)
    calls = []

    def recorded(name, fn):
        def call(*args, **kw):
            calls.append((name,) + tuple(args[3:5] if name == "k3" else ()))
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(brc, "blind_rotate_chunk",
                        recorded("k3", brc.blind_rotate_chunk))
    monkeypatch.setattr(cmux, "cmux_step", recorded("k1", cmux.cmux_step))
    exact = mode == "NTT"
    chunked = bootstrap.blind_rotate(acc, bk_dev, bara, tp,
                                     chunk_steps=CHUNK, exact=exact)
    assert calls == [("k3", 0, 50), ("k3", 50, 13)]
    del calls[:]
    per_step = bootstrap.blind_rotate(acc, bk_dev, bara, tp, chunk_steps=1,
                                      exact=exact)
    assert calls == [("k1",)] * LWE_SIZE
    assert torch.equal(chunked, per_step)


@pytest.mark.parametrize("n, chunk, full, tail", [
    (100, 50, 2, 0), (630, 50, 12, 30), (20, 50, 0, 20), (4, 1, 0, 0)])
def test_the_launches_of_a_rotation(n, chunk, full, tail, monkeypatch):
    """``full`` K3 launches of ``chunk`` steps, then one of the ``tail``
    steps left: none where the chunk divides n (n = 100: two launches and
    no tail), one launch of n steps for a chunk above n; K1 a step only at
    ``chunk_steps=1``.  The kernels are stood in for by recorders (n = 63
    is recorded on the plain kernels above)."""
    calls = []

    def k3(acc, bara_t, key, start, steps, **kw):
        calls.append(("k3", start, steps))
        return acc

    def k1(acc, p, key_row, **kw):
        calls.append(("k1",))
        return acc
    monkeypatch.setattr(brc, "blind_rotate_chunk", k3)
    monkeypatch.setattr(cmux, "cmux_step", k1)
    tp = nft.NuFHEParameters(lwe_size=n, bs_decomp_length=3,
                             bs_log2_base=7).tgsw_params
    key = torch.zeros((1, 6, 2, 64, 32), dtype=torch.int64).expand(
        n, 6, 2, 64, 32)
    acc = torch.zeros((2, 2, 1024), dtype=torch.int32)
    bara = torch.zeros((2, n), dtype=torch.int32)
    bootstrap.blind_rotate(acc, key, bara, tp, chunk_steps=chunk)
    if chunk == 1:
        assert calls == [("k1",)] * n
    else:
        assert calls == [("k3", i * chunk, chunk) for i in range(full)] \
            + [("k3", full * chunk, tail)] * (tail > 0)


@pytest.fixture(scope="module")
def jax_keys():
    """A JAX key pair of the library's set at n = 63 (host keygen), and the
    port's cloud key holding the same arrays, for each engine."""
    out = {}
    for mode in ("NTT", "FFT"):
        params = dict(lwe_size=LWE_SIZE, bs_decomp_length=3, bs_log2_base=7,
                      ks_decomp_length=8, ks_log2_base=2, transform_type=mode)
        jsecret, jcloud = jnf.make_key_pair(jnf.DeterministicRNG(JAX_SEED),
                                            on_device=False, **params)
        bk, ks = jcloud.bootstrap_key, jcloud.keyswitch_key
        tcloud = nft.cloud_key_from_arrays(
            nft.NuFHEParameters(**params), np.asarray(bk.bk_coeff),
            np.asarray(bk.cv), np.asarray(ks.ks_a), np.asarray(ks.ks_b),
            np.asarray(ks.ks_cv), ks.log2_base)
        out[mode] = jsecret, jcloud, tcloud
    return out


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
@pytest.mark.parametrize("gate", ["nand", "mux"])
def test_gates_equal_the_jax_package(jax_keys, mode, gate):
    """The JAX package's gate (one step a launch) and the port's with
    ``chunk_steps=50`` (a chunk of 50 and a tail of 13) on the same keys
    and ciphertexts give the same words."""
    jsecret, jcloud, tcloud = jax_keys[mode]
    jrng = jnf.DeterministicRNG(JAX_SEED + 1)
    bits = [np.random.RandomState(JAX_SEED + i).randint(
        0, 2, BATCH).astype(bool) for i in range(3)]
    jcts = [jnf.encrypt(jrng, jsecret, b) for b in bits]
    tcts = [nft.ciphertext_from_arrays(
        tcloud.params.in_out_params, np.asarray(c.a), np.asarray(c.b),
        np.asarray(c.current_variances), "cpu") for c in jcts]
    vm = nft.VirtualMachine(tcloud, nft.PerformanceParameters(
        chunk_steps=CHUNK), device="cpu")
    if gate == "mux":
        jout = jnf.VirtualMachine(jcloud).gate_mux(*jcts)
        tout = vm.gate_mux(*tcts)
        truth = np.where(bits[0], bits[1], bits[2])
    else:
        jout = jnf.VirtualMachine(jcloud).gate_nand(*jcts[:2])
        tout = vm.gate_nand(*tcts[:2])
        truth = ~(bits[0] & bits[1])
    assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
    assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
    assert np.array_equal(jnf.decrypt(jsecret, jout), truth)
