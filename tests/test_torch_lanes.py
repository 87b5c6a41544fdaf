"""The port's lanes-layout engine against the JAX package, on the CPU: the
int8 key operand (limbs and MAC right-hand side), kernel K4's plain version
against B4 itself (the Pallas step in interpret mode) and
``flat_engine.external_step``, and the lanes gates
(``PerformanceParameters(single_kernel_bootstrap=False)``) against the JAX
package's lanes gates and the port's rows path.  Integers bit-equal,
``cv`` allclose at rtol 1e-6; on the CPU the launch counters do not move.

The LWE size is reduced (16 blind-rotation steps) as in the JAX package's
own gate tests; the polynomial and transform sizes are full.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import nufhe_tpu as jnf
from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.performance import PerformanceParameters as JPerf
from nufhe_tpu.ref import transform_ref as jtr
from nufhe_tpu.ops import flat_engine as jfe
from nufhe_tpu.ops import tgsw as jtgsw
from nufhe_tpu.ops import transform as jtf
from nufhe_tpu.ops.pallas import blind_rotate as pbr

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ops import blind_rotate as brc, cmux, keyswitch as tks
from nufhe_tpu_torch.ops import flat_engine as tfe
from nufhe_tpu_torch.ops import lanes_step as k4
from nufhe_tpu_torch.ops import tgsw as ttgsw
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
KW = dict(offset=int(TP.offset), log2_base=TP.bs_log2_base)
MASK1 = 2
LWE_SIZE = 16
SEED = 4242


def _counts():
    return cmux.launches, tks.launches, brc.launches, k4.launches


def _bk_coeff(seed, rows):
    rng = np.random.RandomState(seed)
    return rng.randint(-2**31, 2**31, (rows, MASK1, TP.decomp_length, MASK1,
                                       1024)).astype(np.int32)


@pytest.mark.parametrize("exact", [True, False])
def test_key_limbs_and_mac_rhs_match_jax(exact):
    bk = _bk_coeff(1, 2)
    hat = jtr.forward(bk)
    limbs = ttf.key_limbs_host(hat, exact)
    assert np.array_equal(limbs, jtf.key_limbs_host(hat, exact))
    host = ttgsw.bootstrap_key_limbs_host(bk, exact=exact)
    assert np.array_equal(host, jtgsw.bootstrap_key_limbs_host(bk, exact=exact))
    # the compact one-sided form and back
    pos, delta = ttf.one_sided_limbs_host(limbs)
    jpos, jdelta = jtf.one_sided_limbs_host(limbs)
    assert np.array_equal(pos, jpos)
    assert (delta is None) == (jdelta is None) == exact
    assert exact or np.array_equal(delta, jdelta)
    assert np.array_equal(ttf.two_sided_limbs_host(pos, delta), limbs)
    assert np.array_equal(ttf.two_sided_limbs_host(pos, delta),
                          jtf.two_sided_limbs_host(pos, delta))
    # the MAC operand, and the whole preparation
    got = ttf.build_mac_rhs(torch.from_numpy(host))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(),
                          np.asarray(jtf.build_mac_rhs(jnp.asarray(host))))
    key = ttgsw.prepare_bootstrap_key_device(bk, "cpu", chunk=1, exact=exact)
    jkey = np.asarray(jtgsw.prepare_bootstrap_key_device(bk, exact=exact))
    assert key.shape == (2, 64, 256, 320 if exact else 256)
    assert np.array_equal(key.numpy(), jkey)
    assert np.array_equal(ttf.BITREV_L, jtf.BITREV_L)


@pytest.mark.parametrize("exact", [True, False])
def test_step_plain_matches_b4_interpret(exact):
    """K4's plain version, fed the JAX package's own prepared key row as a
    numpy array, against B4 (``make_external_step`` in interpret mode) and
    ``flat_engine.external_step``: batch 8, one step."""
    rng = np.random.RandomState(2 if exact else 3)
    acc_q = rng.randint(-2**31, 2**31, (8, MASK1 * 1024)).astype(np.int32)
    p = rng.randint(0, 2048, (8,)).astype(np.int32)
    row = np.asarray(jtgsw.prepare_bootstrap_key_device(
        _bk_coeff(4, 1), exact=exact))[0]
    fkw = dict(mask1=MASK1, decomp_length=TP.decomp_length,
               log2_base=TP.bs_log2_base, offset=int(TP.offset))
    step = pbr.make_external_step(MASK1, TP.decomp_length, TP.bs_log2_base,
                                  int(TP.offset), batch_tile=8,
                                  mac_dtype=jnp.float32, interpret=True)
    want = np.asarray(step(jnp.asarray(acc_q), jnp.asarray(p)[:, None],
                           jnp.asarray(row)))
    assert np.array_equal(np.asarray(jfe.external_step(
        jnp.asarray(acc_q), jnp.asarray(p)[:, None], jnp.asarray(row),
        mac_dtype=jnp.float32, **fkw)), want)
    before = _counts()
    got = k4.lanes_step(torch.from_numpy(acc_q), torch.from_numpy(p),
                        torch.from_numpy(row.copy()), **KW)
    assert _counts() == before           # CPU tensors take the plain version
    assert np.array_equal(got.numpy(), want)


def test_flat_engine_stages_match_jax():
    """Each stage of the plain version against the JAX function."""
    rng = np.random.RandomState(5)
    x = rng.randint(-2**31, 2**31, (4, MASK1 * 1024)).astype(np.int32)
    p = rng.randint(0, 2048, (4,)).astype(np.int32)
    p[:2] = (0, 2047)
    t = torch.from_numpy
    for minus_one in (False, True):
        assert np.array_equal(
            tfe.rotate_q(t(x), t(p), minus_one=minus_one).numpy(),
            np.asarray(jfe.rotate_q(jnp.asarray(x), jnp.asarray(p)[:, None],
                                    minus_one=minus_one)))
    polys = x.reshape(4, MASK1, 1024)
    assert np.array_equal(tfe.q_from_n(t(polys)).numpy(),
                          np.asarray(jfe.q_from_n(jnp.asarray(polys))))
    digits = tfe.gadget_decomp_flat(t(x), MASK1, TP.decomp_length,
                                    TP.bs_log2_base, int(TP.offset))
    assert np.array_equal(digits.numpy(), np.asarray(jfe.gadget_decomp_flat(
        jnp.asarray(x), MASK1, TP.decomp_length, TP.bs_log2_base,
        int(TP.offset))))
    d = digits.numpy()
    assert np.array_equal(tfe.dif_forward_q(digits, 4).numpy(),
                          np.asarray(jfe.dif_forward_q(jnp.asarray(d), 4)))
    y = rng.randint(-2**31, 2**31, (4, MASK1 * 2048)).astype(np.int32)
    inv = tfe.dit_inverse_q(t(y), MASK1)
    assert np.array_equal(inv.numpy(),
                          np.asarray(jfe.dit_inverse_q(jnp.asarray(y), MASK1)))
    hi = (rng.randint(-2**18, 2**18, inv.shape) * 64).astype(np.int32)
    for b_ in (hi, None):
        want = jfe.normalize_dual(jnp.asarray(inv.numpy()),
                                  None if b_ is None else jnp.asarray(b_))
        got = tfe.normalize_dual(inv, None if b_ is None else t(b_))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_lanes_rotation_and_wrapper_checks():
    """n lanes steps equal the rows engine's n steps on the same
    coefficient key (both forms); the wrappers refuse what K4 does not
    take."""
    rng = np.random.RandomState(6)
    bk = _bk_coeff(7, 3)
    acc = torch.from_numpy(
        rng.randint(-2**31, 2**31, (4, MASK1, 1024)).astype(np.int32))
    bara_t = torch.from_numpy(rng.randint(0, 2048, (3, 4)).astype(np.int32))
    for mode in ("NTT", "FFT"):
        lanes_key = ttgsw.prepare_bootstrap_key_device(bk, "cpu",
                                                       exact=mode == "NTT")
        rows_key = ttf.bootstrap_key_transformed(bk, "cpu", mode)
        got = k4.blind_rotate_lanes(
            tfe.q_from_n(acc).reshape(4, -1), lanes_key, bara_t, **KW)
        want = acc
        for i in range(3):
            want = cmux.cmux_step(want, bara_t[i], rows_key[i], **KW)
        assert torch.equal(tfe.n_from_q(got.reshape(acc.shape)), want)
    acc_q = tfe.q_from_n(acc).reshape(4, -1)
    with pytest.raises(TypeError):
        k4.lanes_step(acc_q, bara_t[0], lanes_key[0].to(torch.int32), **KW)
    with pytest.raises(ValueError):      # Q is neither 320 nor 256
        k4.lanes_step(acc_q, bara_t[0], lanes_key[0, :, :, :128], **KW)
    with pytest.raises(TypeError):
        k4.lanes_step(acc_q.to(torch.int64), bara_t[0], lanes_key[0], **KW)
    with pytest.raises(ValueError):      # acc_q is (B, 2048)
        k4.lanes_step(acc, bara_t[0], lanes_key[0], **KW)
    with pytest.raises(ValueError):      # p is (B,)
        k4.lanes_step(acc_q, bara_t[0, :2], lanes_key[0], **KW)
    with pytest.raises(ValueError):      # key rows != steps
        k4.blind_rotate_lanes(acc_q, lanes_key[:2], bara_t, **KW)


@pytest.fixture(scope="module")
def keys():
    """JAX key pairs in both modes, and the port's keys built from their
    arrays; the 'FFT' port key takes the JAX package's prepared lanes key
    as it is (``cloud_key_from_arrays(..., mac_rhs=...)``)."""
    out = {}
    for mode in ("NTT", "FFT"):
        jsecret, jcloud = jnf.make_key_pair(
            jnf.DeterministicRNG(SEED), lwe_size=LWE_SIZE, transform_type=mode,
            on_device=False)
        params = tnf.NuFHEParameters(lwe_size=LWE_SIZE, transform_type=mode)
        bk, ks = jcloud.bootstrap_key, jcloud.keyswitch_key
        mac_rhs = np.asarray(bk.device()) if mode == "FFT" else None
        tcloud = tnf.cloud_key_from_arrays(
            params, np.asarray(bk.bk_coeff), np.asarray(bk.cv),
            np.asarray(ks.ks_a), np.asarray(ks.ks_b), np.asarray(ks.ks_cv),
            ks.log2_base, mac_rhs=mac_rhs)
        tsecret = tnf.secret_key_from_array(params, jsecret.lwe_key.key)
        out[mode] = (jsecret, jcloud, tsecret, tcloud)
    # the port prepares the same lanes key from the coefficients
    ported = ttgsw.prepare_bootstrap_key_device(
        np.asarray(out["FFT"][1].bootstrap_key.bk_coeff), "cpu", exact=False)
    assert torch.equal(ported, out["FFT"][3].bootstrap_key.mac_rhs("cpu"))
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


def _assert_same(tout, jout):
    assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
    assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
    assert np.allclose(tout.current_variances.numpy(),
                       np.asarray(jout.current_variances), rtol=1e-6, atol=0)


def _lanes(**perf):
    return dict(single_kernel_bootstrap=False, **perf)


@pytest.mark.parametrize("mode,perf", [
    ("NTT", {}),
    ("FFT", {}),
    ("NTT", {"coarse_phase_bits": 2}),
])
def test_lanes_nand_matches_jax_and_rows(keys, mode, perf):
    jsecret, jcloud, tsecret, tcloud = keys[mode]
    (x, y), jcts = _inputs(jsecret, [(8,), (8,)], 9)
    jout = jnf.VirtualMachine(jcloud, JPerf(**_lanes(**perf))).gate_nand(*jcts)
    args = _to_port(tcloud, jcts)
    vm = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(**_lanes(**perf)),
                            device="cpu")
    assert not vm.perf_params.single_kernel_bootstrap
    before = _counts()
    tout = vm.gate_nand(*args)
    assert _counts() == before
    _assert_same(tout, jout)
    assert np.array_equal(tnf.decrypt(tsecret, tout), ~(x & y))
    rows = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(**perf),
                              device="cpu").gate_nand(*args)
    assert torch.equal(rows.a, tout.a) and torch.equal(rows.b, tout.b)


@pytest.mark.parametrize("mode", ["NTT", "FFT"])
def test_lanes_mux_matches_jax_and_rows(keys, mode):
    """b if a else c, with a (2, 4), b (4,) and c (1, 4) broadcast."""
    jsecret, jcloud, tsecret, tcloud = keys[mode]
    (a, b, c), jcts = _inputs(jsecret, [(2, 4), (4,), (1, 4)], 23)
    jout = jnf.VirtualMachine(jcloud, JPerf(**_lanes())).gate_mux(*jcts)
    args = _to_port(tcloud, jcts)
    before = _counts()
    tout = tnf.VirtualMachine(tcloud, tnf.PerformanceParameters(**_lanes()),
                              device="cpu").gate_mux(*args)
    assert _counts() == before
    assert tout.shape == (2, 4)
    _assert_same(tout, jout)
    assert np.array_equal(tnf.decrypt(tsecret, tout), np.where(a, b, c))
    rows = tnf.VirtualMachine(tcloud, device="cpu").gate_mux(*args)
    assert torch.equal(rows.a, tout.a) and torch.equal(rows.b, tout.b)


def test_set_mac_rhs_checks_the_form(keys):
    _, jcloud, _, tcloud = keys["NTT"]
    bk = tcloud.bootstrap_key
    rounded = np.asarray(keys["FFT"][1].bootstrap_key.device())
    with pytest.raises(ValueError):       # a rounded key for an 'NTT' cloud
        bk.set_mac_rhs(rounded)
    with pytest.raises(ValueError):       # not int8
        bk.set_mac_rhs(rounded.astype(np.int16))
    exact = np.asarray(jcloud.bootstrap_key.device())
    assert exact.shape[-1] == 320
    bk.set_mac_rhs(exact)
    assert np.array_equal(bk.mac_rhs("cpu").numpy(), exact)
