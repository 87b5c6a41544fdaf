"""The port's key generation and key preparation on tensors against the JAX
package's device functions (JAX's CPU backend) and the host oracles, on the
CPU, bit for bit: TLWE encrypt-zero, the bootstrap key's samples, the
keyswitch key, the one-sided limb split (carry edges included), the -v side
rebuilt from it, the lanes key from the compact form, the keyswitch
operand, the rows key from a tensor key, and ``make_key_pair`` in every
placement; then ``utils.profiling``.
"""

import glob
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import nufhe_tpu as jnf
from nufhe_tpu.ops import keygen as jkeygen, lwe as jlwe, tgsw as jtgsw
from nufhe_tpu.ops import transform as jtf

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ops import keygen, lwe as tlwe, tgsw, transform as ttf
from nufhe_tpu_torch.ref import lwe_ref, tgsw_ref, tlwe_ref
from nufhe_tpu_torch.utils import annotate, profile_trace

MODES = ("NTT", "FFT")
SEED = 808


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread leaves the cores to the other workers of a parallel
    test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _noises(rng, shape):
    return rng.randint(-2**31, 2**31, shape).astype(np.int32)


def test_tlwe_encrypt_zero(rng):
    """6 rows, mask size 2 (the JAX package's ``tests/test_keygen.py``)."""
    rows, mask_size = 6, 2
    key = rng.randint(0, 2, (mask_size, 1024)).astype(np.int32)
    noises1 = _noises(rng, (rows, mask_size + 1, 2, mask_size, 1024))
    noises2 = _noises(rng, (rows, mask_size + 1, 2, 1024))
    want, _ = tlwe_ref.tlwe_encrypt_zero(key, noises1, noises2, 1e-9)
    w = keygen.negacyclic_key_matrix(key)
    got = keygen.tlwe_encrypt_zero_device(_t(w), _t(noises1), _t(noises2))
    jax_got = jkeygen.tlwe_encrypt_zero_device(
        jnp.asarray(jkeygen.negacyclic_key_matrix(key)), jnp.asarray(noises1),
        jnp.asarray(noises2))
    assert np.array_equal(w, jkeygen.negacyclic_key_matrix(key))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jax_got))


def test_bootstrap_key_samples(rng):
    """5 rows at the default parameters."""
    bk_params = tnf.NuFHEParameters().tgsw_params
    rows, mask_size = 5, bk_params.tlwe_params.mask_size
    key = rng.randint(0, 2, (mask_size, 1024)).astype(np.int32)
    bits = rng.randint(0, 2, (rows,)).astype(np.int32)
    shape = (rows, mask_size + 1, bk_params.decomp_length)
    noises1 = _noises(rng, shape + (mask_size, 1024))
    noises2 = _noises(rng, shape + (1024,))
    want, _ = tlwe_ref.tlwe_encrypt_zero(key, noises1, noises2, 1e-9)
    want = tgsw_ref.tgsw_add_message(want, bits, bk_params)
    w = keygen.negacyclic_key_matrix(key)
    got = keygen.bootstrap_key_device(_t(w), _t(bits), _t(noises1),
                                      _t(noises2), bk_params.base_powers)
    jax_got = jkeygen.bootstrap_key_device(
        jnp.asarray(w), jnp.asarray(bits), jnp.asarray(noises1),
        jnp.asarray(noises2), bk_params.base_powers)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jax_got))


def test_keyswitch_key(rng):
    """64 x 48, t = 8, base 4."""
    in_size, out_size, decomp, log2_base = 64, 48, 8, 2
    base = 2**log2_base
    in_key = rng.randint(0, 2, (in_size,)).astype(np.int32)
    out_key = rng.randint(0, 2, (out_size,)).astype(np.int32)
    noises_b = _noises(rng, (in_size, decomp, base - 1))
    noises_a = _noises(rng, (in_size, decomp, base - 1, out_size))
    want_a, want_b, _ = lwe_ref.make_keyswitch_key(
        in_key, out_key, noises_a, noises_b, decomp, log2_base, 1e-9)
    got_a, got_b = keygen.make_keyswitch_key_device(
        _t(in_key), _t(out_key), _t(noises_a), _t(noises_b), decomp,
        log2_base)
    jax_a, jax_b = jkeygen.make_keyswitch_key_device(
        in_key, out_key, noises_a, noises_b, decomp, log2_base)
    for got, want, jax_got in ((got_a, want_a, jax_a), (got_b, want_b, jax_b)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), np.asarray(jax_got))


@pytest.mark.parametrize("mode", MODES)
def test_bootstrap_key_limbs_device(rng, mode):
    """The one-sided split of random torus polynomials with the carry edges
    -2^31, 2^31-1, -1 and 0, over several chunks."""
    exact = mode == "NTT"
    bk = _noises(rng, (2, 2, 2, 2, 1024))
    bk.reshape(-1)[:4] = [-2**31, 2**31 - 1, -1, 0]
    bk.reshape(-1)[-1024:] = 2**31 - 1
    want_pos, want_delta = ttf.one_sided_limbs_host(
        tgsw.bootstrap_key_limbs_host(bk, exact=exact))
    pos, delta = keygen.bootstrap_key_limbs_device(_t(bk), exact=exact,
                                                   chunk=5)
    jax_pos, jax_delta = jkeygen.bootstrap_key_limbs_device(
        jnp.asarray(bk), exact=exact, chunk=8)
    assert pos.dtype == torch.int8
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(pos.numpy(), np.asarray(jax_pos))
    if exact:
        assert delta is None and want_delta is None and jax_delta is None
    else:
        assert delta.dtype == torch.uint8 and delta.numpy().any()
        assert np.array_equal(delta.numpy(), want_delta)
        assert np.array_equal(delta.numpy(), np.asarray(jax_delta))


@pytest.mark.parametrize("mode", MODES)
def test_two_sided_limbs_device(rng, mode):
    """The -v side from the +v side, with vlo = -32 entries (exact) and
    delta bits (rounded), against the two-sided host split it came from."""
    exact = mode == "NTT"
    residues = rng.randint(0, 2**62, (3, 2, 64, 32)).astype(np.uint64)
    if exact:
        # residues with vlo = -32: v = 64 * k + 32 mod 2^38
        residues.reshape(-1)[:50] = residues.reshape(-1)[:50] // 64 * 64 + 32
    limbs = ttf.key_limbs_host(residues, exact=exact)
    pos, delta = ttf.one_sided_limbs_host(limbs)
    if exact:
        assert (pos[..., 0] == -32).sum() >= 50
    else:
        assert delta.any() and not delta.all()
    got = ttf.two_sided_limbs_device(
        _t(pos), None if delta is None else _t(delta))
    jax_got = jtf.two_sided_limbs_device(pos, delta)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), limbs)
    assert np.array_equal(got.numpy(), ttf.two_sided_limbs_host(pos, delta))
    assert np.array_equal(got.numpy(), np.asarray(jax_got))


@pytest.mark.parametrize("mode", MODES)
def test_expand_bootstrap_key_device_compact(rng, mode):
    exact = mode == "NTT"
    bk = _noises(rng, (2, 2, 2, 2, 1024))
    pos, delta = keygen.bootstrap_key_limbs_device(_t(bk), exact=exact)
    got = tgsw.expand_bootstrap_key_device_compact(pos, delta, 'cpu', chunk=1)
    jax_got = jtgsw.expand_bootstrap_key_device_compact(
        pos.numpy(), None if delta is None else delta.numpy(), chunk=1)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(jax_got))
    assert torch.equal(got, tgsw.prepare_bootstrap_key_device(bk, 'cpu',
                                                              exact=exact))


@pytest.mark.parametrize("log2_base", (2, 3))
def test_keyswitch_operand_on_device(rng, log2_base):
    """``ab_limbs`` from tensor tables equals the numpy branch's and the JAX
    package's (from its device-resident tables)."""
    in_size, out_size, decomp = 64, 48, 8
    base = 2**log2_base
    ks_a = _noises(rng, (in_size, decomp, base, out_size))
    ks_b = _noises(rng, (in_size, decomp, base))
    ks_a[0, 0, 1, :3] = [-2**31, 2**31 - 1, -1]
    ks_a[:, :, 0] = 0
    ks_b[:, :, 0] = 0
    ks_cv = np.full((in_size, decomp, base), 3e-9, np.float32)
    got, meta = tlwe.prepare_keyswitch_device(_t(ks_a), _t(ks_b), ks_cv,
                                              log2_base, 'cpu')
    host, host_meta = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv,
                                                    log2_base, 'cpu')
    jax_got = jlwe.prepare_keyswitch_device(
        jnp.asarray(ks_a), jnp.asarray(ks_b), jnp.asarray(ks_cv), log2_base)
    assert meta == host_meta and got["cv_scale"] == host["cv_scale"]
    assert torch.equal(got["ab_limbs"], host["ab_limbs"])
    assert np.array_equal(got["ab_limbs"].numpy(),
                          np.asarray(jax_got[0]["ab_limbs"]))


@pytest.mark.parametrize("mode", MODES)
def test_rows_key_from_a_tensor_key(rng, mode):
    """A tensor ``bk_coeff`` is transformed through the device limbs into
    the same int64 tensor as the host transform of the numpy key."""
    bk = _noises(rng, (3, 2, 2, 2, 1024))
    bk.reshape(-1)[:4] = [-2**31, 2**31 - 1, -1, 0]
    want = ttf.bootstrap_key_transformed(bk, 'cpu', mode)
    got = ttf.bootstrap_key_transformed(_t(bk), 'cpu', mode)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    pos, delta = keygen.bootstrap_key_limbs_device(_t(bk), exact=mode == "NTT")
    limbs = ttf.two_sided_limbs_device(pos, delta)
    assert torch.equal(ttf.rows_key_from_limbs(limbs, 'cpu'), want)


@pytest.fixture(scope="module")
def key_pairs():
    """{mode: (host pair, port CPU-tensor pair, JAX device pair)} at
    lwe_size 40, one seed."""
    out = {}
    for mode in MODES:
        kw = dict(lwe_size=40, transform_type=mode)
        out[mode] = (
            tnf.make_key_pair(tnf.DeterministicRNG(SEED), on_device=False,
                              **kw),
            tnf.make_key_pair(tnf.DeterministicRNG(SEED), device='cpu', **kw),
            jnf.make_key_pair(jnf.DeterministicRNG(SEED), on_device=True,
                              **kw))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_make_key_pair_placements_agree(key_pairs, mode):
    (hs, hc), (ts, tc), (js, jc) = key_pairs[mode]
    bk, ks = tc.bootstrap_key, tc.keyswitch_key
    # the CPU-tensor keygen keeps its tables as tensors
    assert torch.is_tensor(bk.bk_coeff) and torch.is_tensor(ks.ks_a)
    assert torch.is_tensor(bk.compact()[0])
    assert np.array_equal(bk.bk_coeff.numpy(), hc.bootstrap_key.bk_coeff)
    assert np.array_equal(bk.bk_coeff.numpy(),
                          np.asarray(jc.bootstrap_key.bk_coeff))
    assert np.array_equal(bk.cv, hc.bootstrap_key.cv)
    for name in ("ks_a", "ks_b"):
        got = getattr(ks, name).numpy()
        assert np.array_equal(got, getattr(hc.keyswitch_key, name)), name
        assert np.array_equal(got, np.asarray(getattr(jc.keyswitch_key,
                                                      name))), name
    assert np.array_equal(ks.ks_cv, hc.keyswitch_key.ks_cv)
    pos, delta = bk.compact()
    jpos, jdelta = jc.bootstrap_key.compact()
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(pos.numpy(), hc.bootstrap_key.compact()[0])
    if mode == "FFT":
        assert np.array_equal(delta.numpy(), np.asarray(jdelta))
    assert ts.dumps() == hs.dumps() == js.dumps()
    assert tc.dumps() == hc.dumps() == jc.dumps()
    assert tc == hc
    # both engines' keys from the compact form equal the host path's
    assert torch.equal(bk.device('cpu'), hc.bootstrap_key.device('cpu'))
    assert torch.equal(bk.mac_rhs('cpu'), hc.bootstrap_key.mac_rhs('cpu'))
    assert torch.equal(ks.device('cpu')[0]["ab_limbs"],
                       hc.keyswitch_key.device('cpu')[0]["ab_limbs"])


def test_keygen_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on_device=False.*device='cpu'"):
        tnf.make_key_pair(tnf.DeterministicRNG(1), lwe_size=4)
    secret = tnf.NuFHESecretKey.from_rng(tnf.NuFHEParameters(lwe_size=4),
                                         tnf.DeterministicRNG(1))
    with pytest.raises(RuntimeError, match="on_device=False"):
        tnf.NuFHECloudKey.from_rng(secret.params, tnf.DeterministicRNG(1),
                                   secret)


def test_cpu_context_uses_the_host_oracle():
    ctx = tnf.Context(rng=tnf.DeterministicRNG(SEED), api='cpu')
    secret, cloud = ctx.make_key_pair(lwe_size=8)
    hs, hc = tnf.make_key_pair(tnf.DeterministicRNG(SEED), on_device=False,
                               lwe_size=8)
    assert isinstance(cloud.bootstrap_key.bk_coeff, np.ndarray)
    assert isinstance(cloud.keyswitch_key.ks_a, np.ndarray)
    assert secret == hs and cloud.dumps() == hc.dumps()


@pytest.mark.parametrize("where", ("unset", "argument", "environment"))
def test_profile_trace(tmp_path, monkeypatch, where):
    monkeypatch.delenv("NUFHE_PROFILE_DIR", raising=False)
    logdir = tmp_path / "trace"
    if where == "environment":
        monkeypatch.setenv("NUFHE_PROFILE_DIR", str(logdir))
    x = torch.arange(2 * 1024, dtype=torch.int32).reshape(2, 1024)
    with profile_trace(str(logdir) if where == "argument" else None):
        with annotate("keygen_probe"):
            y = ttf.forward_i32(x)
    assert y.shape == (2, 64, 32)
    traces = glob.glob(os.path.join(str(logdir), "*.json"))
    if where == "unset":
        assert not logdir.exists()
    else:
        assert len(traces) == 1
        with open(traces[0]) as f:
            assert "keygen_probe" in f.read()
