"""The port's slice as a whole against the JAX package, on the CPU: seeded
keygen and encryption give equal arrays, the bootstrap without keyswitch and
the NAND gate give equal ciphertexts (cv allclose at rtol 1e-6), and the
port imports neither JAX nor ``nufhe_tpu``.

The LWE size is reduced (16 blind-rotation steps) as in the JAX package's
own bootstrap tests; the polynomial and transform sizes are full.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import nufhe_tpu as jnf
from nufhe_tpu.numeric import phase_to_t32
from nufhe_tpu.ops import bootstrap as jboot

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ops import bootstrap as tboot, cmux, keyswitch as tks

LWE_SIZE = 16
BATCH = 8
SEED = 4242


@pytest.fixture(scope="module")
def key_pairs():
    jrng = jnf.DeterministicRNG(SEED)
    trng = tnf.DeterministicRNG(SEED)
    jsecret, jcloud = jnf.make_key_pair(jrng, lwe_size=LWE_SIZE,
                                        on_device=False)
    tsecret, tcloud = tnf.make_key_pair(trng, on_device=False,
                                        lwe_size=LWE_SIZE)
    return (jrng, jsecret, jcloud), (trng, tsecret, tcloud)


@pytest.fixture(scope="module")
def shared_keys(key_pairs):
    """The port's keys built from the JAX package's arrays."""
    (_, jsecret, jcloud), _ = key_pairs
    params = tnf.NuFHEParameters(lwe_size=LWE_SIZE)
    bk, ks = jcloud.bootstrap_key, jcloud.keyswitch_key
    tcloud = tnf.cloud_key_from_arrays(
        params, np.asarray(bk.bk_coeff), np.asarray(bk.cv), np.asarray(ks.ks_a),
        np.asarray(ks.ks_b), np.asarray(ks.ks_cv), ks.log2_base)
    tsecret = tnf.secret_key_from_array(params, jsecret.lwe_key.key)
    return tsecret, tcloud


def test_seeded_keygen_and_encryption_match(key_pairs):
    (jrng, jsecret, jcloud), (trng, tsecret, tcloud) = key_pairs
    assert np.array_equal(tsecret.lwe_key.key, jsecret.lwe_key.key)
    jbk, tbk = jcloud.bootstrap_key, tcloud.bootstrap_key
    assert np.array_equal(tbk.bk_coeff, np.asarray(jbk.bk_coeff))
    assert np.array_equal(tbk.cv, np.asarray(jbk.cv))
    jks, tks_ = jcloud.keyswitch_key, tcloud.keyswitch_key
    for name in ("ks_a", "ks_b", "ks_cv"):
        assert np.array_equal(getattr(tks_, name),
                              np.asarray(getattr(jks, name))), name

    bits = np.random.RandomState(1).randint(0, 2, BATCH).astype(bool)
    jct = jnf.encrypt(jrng, jsecret, bits)
    tct = tnf.encrypt(trng, tsecret, bits, device="cpu")
    assert np.array_equal(tct.a.numpy(), np.asarray(jct.a))
    assert np.array_equal(tct.b.numpy(), np.asarray(jct.b))
    assert np.array_equal(tct.current_variances.numpy(),
                          np.asarray(jct.current_variances))
    assert np.array_equal(tnf.decrypt(tsecret, tct), bits)


def test_bootstrap_no_keyswitch_matches_jax(key_pairs, shared_keys):
    (_, _, jcloud), _ = key_pairs
    _, tcloud = shared_keys
    rng = np.random.RandomState(7)
    lwe_a = rng.randint(-2**31, 2**31, (BATCH, LWE_SIZE)).astype(np.int32)
    lwe_b = rng.randint(-2**31, 2**31, (BATCH,)).astype(np.int32)
    mu = int(phase_to_t32(1, 8))
    tp = jcloud.params.tgsw_params

    arrays, meta = jcloud.keyswitch_key.device()
    ja, jb, jcv = jboot.bootstrap_device(
        jnp.asarray(lwe_a), jnp.asarray(lwe_b),
        jcloud.bootstrap_key.device(), arrays, meta, mu, tp, no_keyswitch=True)

    t_arrays, t_meta = tcloud.keyswitch_key.device("cpu")
    ta, tb, tcv = tboot.bootstrap_device(
        torch.from_numpy(lwe_a), torch.from_numpy(lwe_b),
        tcloud.bootstrap_key.device("cpu"), t_arrays, t_meta, mu,
        tcloud.params.tgsw_params, no_keyswitch=True)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.allclose(tcv.numpy(), np.asarray(jcv), rtol=1e-6, atol=0)


def test_gate_nand_matches_jax(key_pairs, shared_keys):
    (_, jsecret, jcloud), _ = key_pairs
    tsecret, tcloud = shared_keys
    rng = jnf.DeterministicRNG(9)
    x = np.array([False, False, True, True, False, True, True, False])
    y = np.array([False, True, False, True, True, True, False, False])
    jx, jy = jnf.encrypt(rng, jsecret, x), jnf.encrypt(rng, jsecret, y)
    jout = jnf.VirtualMachine(jcloud).gate_nand(jx, jy)

    params = tcloud.params.in_out_params
    tx, ty = (tnf.ciphertext_from_arrays(
        params, np.asarray(c.a), np.asarray(c.b),
        np.asarray(c.current_variances), "cpu") for c in (jx, jy))
    launches = (cmux.launches, tks.launches)
    tout = tnf.VirtualMachine(tcloud, device="cpu").gate_nand(tx, ty)
    assert (cmux.launches, tks.launches) == launches   # plain versions on CPU

    assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
    assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
    assert np.allclose(tout.current_variances.numpy(),
                       np.asarray(jout.current_variances), rtol=1e-6, atol=0)
    assert np.array_equal(tnf.decrypt(tsecret, tout), ~(x & y))


def test_lwe_ops_match_jax():
    """encrypt / decrypt phase / linear / trivial against ``ops/lwe``."""
    from nufhe_tpu.ops import lwe as jlwe
    from nufhe_tpu_torch.ops import lwe as tlwe
    rng = np.random.RandomState(21)
    shape, n = (3, 5), 32
    key, a, b, mus = (rng.randint(lo, hi, s).astype(np.int32) for lo, hi, s in (
        (0, 2, (n,)), (-2**31, 2**31, shape + (n,)), (-2**31, 2**31, shape),
        (-2**31, 2**31, shape)))
    cv = rng.uniform(0, 1e-3, shape).astype(np.float32)
    t = torch.from_numpy

    def same(tq, jq):
        for x, y in zip(tq, jq):
            assert np.array_equal(x.numpy(), np.asarray(y))

    same(tlwe.lwe_encrypt(t(mus), t(key), t(a), t(b), 1e-5),
         jlwe.lwe_encrypt(jnp.asarray(mus), jnp.asarray(key), jnp.asarray(a),
                          jnp.asarray(b), 1e-5))
    assert np.array_equal(
        tlwe.lwe_decrypt_phase(t(a), t(b), t(key)).numpy(),
        np.asarray(jlwe.lwe_decrypt_phase(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(key))))
    src = (a, b, cv)
    for p, add_to in ((-3, None), (2, (b[..., None] + a, mus, cv * 2))):
        same(tlwe.lwe_linear(tuple(map(t, src)), p,
                             None if add_to is None else tuple(map(t, add_to))),
             jlwe.lwe_linear(tuple(map(jnp.asarray, src)), p,
                             None if add_to is None
                             else tuple(map(jnp.asarray, add_to))))
    same(tlwe.lwe_noiseless_trivial(t(mus), n),
         jlwe.lwe_noiseless_trivial(jnp.asarray(mus), n))


TRUTH = {
    'gate_nand': lambda a, b: ~(a & b),
    'gate_or': lambda a, b: a | b,
    'gate_and': lambda a, b: a & b,
    'gate_xor': lambda a, b: a ^ b,
    'gate_xnor': lambda a, b: ~(a ^ b),
    'gate_nor': lambda a, b: ~(a | b),
    'gate_andny': lambda a, b: ~a & b,
    'gate_andyn': lambda a, b: a & ~b,
    'gate_orny': lambda a, b: ~a | b,
    'gate_oryn': lambda a, b: a | ~b,
}


@pytest.mark.parametrize("name", sorted(TRUTH))
def test_two_input_gates_decrypt(shared_keys, name):
    """Every ported gate, with broadcasting of a (2, 4) and a (4,) input."""
    tsecret, tcloud = shared_keys
    rng = tnf.DeterministicRNG(11)
    x = np.random.RandomState(3).randint(0, 2, (2, 4)).astype(bool)
    y = np.array([False, True, False, True])
    cx = tnf.encrypt(rng, tsecret, x, device="cpu")
    cy = tnf.encrypt(rng, tsecret, y, device="cpu")
    out = getattr(tnf.VirtualMachine(tcloud, device="cpu"), name)(cx, cy)
    assert out.shape == (2, 4)
    assert np.array_equal(tnf.decrypt(tsecret, out), TRUTH[name](x, y))


def test_entry_points_need_a_device_or_cpu(shared_keys, monkeypatch):
    tsecret, tcloud = shared_keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tnf.VirtualMachine(tcloud)
    with pytest.raises(RuntimeError):
        tnf.encrypt(tnf.DeterministicRNG(0), tsecret, [True])


def test_port_imports_neither_jax_nor_nufhe_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "import nufhe_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nufhe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'nufhe_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('nufhe_tpu_torch')]))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20    # every module was imported
