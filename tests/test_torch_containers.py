"""The port's key and ciphertext containers against the JAX package's, on
the CPU: for the same ``DeterministicRNG`` seed the containers are equal
byte for byte; a container of either package loads in the other; a cloud
key loaded from the JAX package's container gives the JAX NAND bit for bit
on the rows and the lanes engine, in both modes; the older bootstrap-key
formats 1-3 and keyswitch format 1 load; the limbs -> rows-key function
equals the transform of the coefficient key.
"""

import io

import numpy as np
import pytest
import torch

import nufhe_tpu as jnf
from nufhe_tpu import serialization as jser

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch import serialization as tser
from nufhe_tpu_torch.keys import BootstrapKey, LweKeyswitchKey
from nufhe_tpu_torch.ops import tgsw, transform as ttf

LWE_SIZE = 16
SEED = 707
MODES = ("NTT", "FFT")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain path at these sizes gains little from more threads;
    one leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    """{mode: (JAX secret, JAX cloud, port secret, port cloud)}, each pair
    from the same seed."""
    out = {}
    for mode in MODES:
        js, jc = jnf.make_key_pair(jnf.DeterministicRNG(SEED), on_device=False,
                                   lwe_size=LWE_SIZE, transform_type=mode)
        ts, tc = tnf.make_key_pair(tnf.DeterministicRNG(SEED), on_device=False,
                                   lwe_size=LWE_SIZE, transform_type=mode)
        out[mode] = js, jc, ts, tc
    return out


def test_containers_are_byte_equal(keys):
    for mode in MODES:
        js, jc, ts, tc = keys[mode]
        assert ts.dumps() == js.dumps(), mode
        assert tc.dumps() == jc.dumps(), mode
        bits = np.random.RandomState(1).randint(0, 2, (2, 5)).astype(bool)
        jct = jnf.encrypt(jnf.DeterministicRNG(3), js, bits)
        tct = tnf.encrypt(tnf.DeterministicRNG(3), ts, bits, device='cpu')
        assert tct.dumps() == jct.dumps(), mode


@pytest.mark.parametrize("mode", MODES)
def test_containers_load_in_the_other_package(keys, mode):
    js, jc, ts, tc = keys[mode]
    assert tnf.NuFHESecretKey.loads(js.dumps()) == ts
    assert jnf.NuFHESecretKey.loads(ts.dumps()) == js
    loaded = tnf.NuFHECloudKey.loads(jc.dumps())
    assert loaded.bootstrap_key.bk_coeff is None         # limbs only
    assert loaded == tc
    assert np.array_equal(loaded.bootstrap_key.limbs(),
                          jc.bootstrap_key.limbs())
    assert jnf.NuFHECloudKey.loads(tc.dumps()) == jc
    # the secret key round trip decrypts the same
    bits = np.array([True, False, True])
    ct = tnf.encrypt(tnf.DeterministicRNG(4), ts, bits, device='cpu')
    again = tnf.NuFHESecretKey.loads(ts.dumps())
    assert np.array_equal(tnf.decrypt(again, ct), bits)
    jct = jnf.LweSampleArray.loads(ct.dumps())
    assert np.array_equal(jnf.decrypt(js, jct), bits)
    assert tnf.LweSampleArray.loads(jct.dumps(), 'cpu') == ct


@pytest.mark.parametrize("lanes", [False, True], ids=["rows", "lanes"])
@pytest.mark.parametrize("mode", MODES)
def test_loaded_cloud_key_nand_matches_jax(keys, mode, lanes):
    js, jc, _, _ = keys[mode]
    rng = np.random.RandomState(5)
    x, y = (rng.randint(0, 2, 6).astype(bool) for _ in range(2))
    crng = jnf.DeterministicRNG(6)
    jx, jy = jnf.encrypt(crng, js, x), jnf.encrypt(crng, js, y)
    jout = jnf.VirtualMachine(jc).gate_nand(jx, jy)

    cloud = tnf.NuFHECloudKey.loads(jc.dumps())
    perf = tnf.PerformanceParameters(single_kernel_bootstrap=not lanes)
    vm = tnf.VirtualMachine(cloud, perf, device='cpu')
    tx, ty = (tnf.LweSampleArray.loads(c.dumps(), 'cpu') for c in (jx, jy))
    tout = vm.gate_nand(tx, ty)
    assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
    assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
    np.testing.assert_allclose(tout.current_variances.numpy(),
                               np.asarray(jout.current_variances), rtol=1e-6)
    assert np.array_equal(jnf.decrypt(js, jout), ~(x & y))


def _load_bk(arrays, fmt, like):
    buf = io.BytesIO()
    jser.dump(buf, {"kind": "BootstrapKey", "format": fmt}, arrays)
    buf.seek(0)
    return BootstrapKey.load(buf, like.in_out_params, like.bk_params)


def test_older_bootstrap_key_formats_load(keys):
    """Formats 1-3 built by hand as the JAX package's own tests build them
    (``tests/test_api.py``)."""
    js, jc, _, tc = keys["NTT"]
    jbk = jc.bootstrap_key
    new = jbk.limbs()
    # format 2: plain balanced radix-2^8 digits of the centred mod-2^38
    # values
    v = new[..., 0, :].astype(np.int64) + (sum(
        new[..., j, :].astype(np.int64) << (8 * (j - 1))
        for j in range(1, 5)) << 6)
    old, w = [], v
    for _ in range(5):
        l0 = ((w + 128) & 255) - 128
        old.append(l0.astype(np.int8))
        w = (w - l0) >> 8
    old = np.stack(old, axis=-2)
    assert np.array_equal(ttf.relimb_from_radix8(old), new)
    for fmt, arrays in (
            (1, {"bk_coeff": np.asarray(jbk.bk_coeff), "cv": jbk.cv}),
            (2, {"limbs": old, "cv": jbk.cv}),
            (3, {"limbs": new, "cv": jbk.cv})):
        loaded = _load_bk(arrays, fmt, tc.bootstrap_key)
        assert np.array_equal(loaded.limbs(), new), fmt
        assert torch.equal(loaded.device('cpu'),
                           tc.bootstrap_key.device('cpu')), fmt


def test_keyswitch_key_format1_loads_and_lossy_dump_raises(keys):
    _, jc, _, tc = keys["NTT"]
    jks = jc.keyswitch_key
    buf = io.BytesIO()
    jser.dump(buf, {"kind": "LweKeyswitchKey", "log2_base": jks.log2_base},
              {"ks_a": np.asarray(jks.ks_a), "ks_b": np.asarray(jks.ks_b),
               "ks_cv": np.asarray(jks.ks_cv)})
    buf.seek(0)
    loaded = LweKeyswitchKey.load(buf)
    assert loaded == tc.keyswitch_key
    assert np.array_equal(loaded.ks_cv, tc.keyswitch_key.ks_cv)
    assert loaded.log2_base == jks.log2_base

    bad = LweKeyswitchKey(loaded.ks_a.copy(), loaded.ks_b.copy(),
                          loaded.ks_cv, loaded.log2_base)
    bad.ks_b[0, 0, 0] = 1
    with pytest.raises(ValueError, match="digit-0"):
        bad.dump(io.BytesIO())
    with pytest.raises(ValueError):
        tser.loads(b"NOTACONTAINER")


@pytest.mark.parametrize("mode", MODES)
def test_rows_key_from_limbs_equals_the_transform(keys, mode):
    """On the JAX package's limbs of the key, and on the port's limbs of
    uniform random coefficients (which reach every residue pattern, the
    rounding ties included)."""
    _, jc, _, tc = keys[mode]
    rand = np.random.RandomState(8).randint(
        -2**31, 2**31, (3, 2, 2, 2, 1024)).astype(np.int32)
    exact = mode == "NTT"
    for bk_coeff, limbs in (
            (tc.bootstrap_key.bk_coeff, jc.bootstrap_key.limbs()),
            (rand, tgsw.bootstrap_key_limbs_host(rand, exact=exact))):
        got = ttf.rows_key_from_limbs(limbs, 'cpu')
        want = ttf.bootstrap_key_transformed(bk_coeff, 'cpu', mode)
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError):
        ttf.rows_key_from_limbs(limbs[..., :3, :], 'cpu')
