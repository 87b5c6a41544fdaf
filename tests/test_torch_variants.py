"""The port at the JAX package's one-knob variant parameters, on the CPU:
``tlwe_mask_size=2`` (mask1 = 3), ``bs_decomp_length=3`` and
``ks_log2_base=3`` (keyswitch base 8).  The NAND gate on both of the
port's engines (rows and lanes) equals the JAX package's NAND bit for bit
on carried-across keys and ciphertexts; the plain versions of kernels K1
and K4 at (mask1, l) = (3, 2) and (2, 3) equal the JAX package's
rows-engine and ``flat_engine`` steps, and K2's at base 8 equals the JAX
keyswitch (its Pallas MAC in interpret mode and ``lwe_keyswitch``).  The
kernels' wrappers name the (mask1, l) pairs they are built for.

The LWE size is reduced (4 blind-rotation steps); the polynomial and
transform sizes are full.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nufhe_tpu as jnf
from nufhe_tpu.ops import flat_engine as jfe
from nufhe_tpu.ops import lwe as jlwe
from nufhe_tpu.ops import rows_engine as jre
from nufhe_tpu.ops import tgsw as jtgsw
from nufhe_tpu.ops.pallas import keyswitch as pks
from nufhe_tpu.params import NuFHEParameters

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ops import cmux, flat_engine as tfe
from nufhe_tpu_torch.ops import key_rows as tkr, keyswitch as tks
from nufhe_tpu_torch.ops import lanes_step as k4
from nufhe_tpu_torch.ops import lwe as tlwe, transform as ttf

LWE_SIZE = 4
SEED = 321
VARIANTS = [dict(tlwe_mask_size=2), dict(bs_decomp_length=3),
            dict(ks_log2_base=3)]


def _counts():
    return cmux.launches, tks.launches, k4.launches


@pytest.mark.parametrize("knob", VARIANTS, ids=lambda k: "%s=%d" % next(
    iter(k.items())))
def test_variant_nand_matches_jax_on_both_engines(knob):
    """One JAX NAND a variant; the port's rows and lanes NAND on the JAX
    package's keys and ciphertexts equal it and decrypt to the truth
    table."""
    jrng = jnf.DeterministicRNG(SEED)
    jsecret, jcloud = jnf.make_key_pair(jrng, lwe_size=LWE_SIZE,
                                        on_device=False, **knob)
    a = np.array([False, True, False, True])
    b = np.array([False, False, True, True])
    jcts = [jnf.encrypt(jrng, jsecret, x) for x in (a, b)]
    jout = jnf.VirtualMachine(jcloud).gate_nand(*jcts)
    assert np.array_equal(jnf.decrypt(jsecret, jout), ~(a & b))

    params = tnf.NuFHEParameters(lwe_size=LWE_SIZE, **knob)
    bk, ks = jcloud.bootstrap_key, jcloud.keyswitch_key
    tcloud = tnf.cloud_key_from_arrays(
        params, np.asarray(bk.bk_coeff), np.asarray(bk.cv),
        np.asarray(ks.ks_a), np.asarray(ks.ks_b), np.asarray(ks.ks_cv),
        ks.log2_base)
    tsecret = tnf.secret_key_from_array(params, jsecret.lwe_key.key)
    args = [tnf.ciphertext_from_arrays(
        params.in_out_params, np.asarray(c.a), np.asarray(c.b),
        np.asarray(c.current_variances), "cpu") for c in jcts]
    for perf in (None,
                 tnf.PerformanceParameters(single_kernel_bootstrap=False)):
        before = _counts()
        tout = tnf.VirtualMachine(tcloud, perf, device="cpu").gate_nand(*args)
        assert _counts() == before       # CPU tensors take the plain versions
        assert np.array_equal(tout.a.numpy(), np.asarray(jout.a))
        assert np.array_equal(tout.b.numpy(), np.asarray(jout.b))
        assert np.allclose(tout.current_variances.numpy(),
                           np.asarray(jout.current_variances), rtol=1e-6,
                           atol=0)
        assert np.array_equal(tnf.decrypt(tsecret, tout), ~(a & b))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "rounded"])
@pytest.mark.parametrize("mask1,decomp_length", [(3, 2), (2, 3)])
def test_variant_steps_match_jax_engines(mask1, decomp_length, exact):
    """K1's plain version against the rows engine's ``external_step`` and
    K4's against ``flat_engine.external_step``, on the JAX package's
    prepared key row (K4) and the port's transformed key of the same
    coefficients (K1); batch 4, one step."""
    tp = NuFHEParameters(tlwe_mask_size=mask1 - 1,
                         bs_decomp_length=decomp_length).tgsw_params
    rng = np.random.RandomState(10 * mask1 + decomp_length + exact)
    acc = rng.randint(-2**31, 2**31, (4, mask1, 1024)).astype(np.int32)
    p = rng.randint(0, 2048, (4,)).astype(np.int32)
    p[:2] = (0, 2047)
    bk = rng.randint(-2**31, 2**31, (1, mask1, decomp_length, mask1, 1024)
                     ).astype(np.int32)
    row = np.asarray(jtgsw.prepare_bootstrap_key_device(bk, exact=exact))[0]
    kw = dict(mask1=mask1, decomp_length=decomp_length,
              log2_base=tp.bs_log2_base, offset=int(tp.offset),
              mac_dtype=jnp.float32)
    rows_step = jax.jit(functools.partial(jre.external_step, **kw))
    want_rows = np.asarray(jre.acc_n_from_rows(rows_step(
        jre.acc_rows_from_n(jnp.asarray(acc)), jnp.asarray(p)[None, :],
        jnp.asarray(row)), mask1))
    acc_q = np.asarray(jfe.q_from_n(jnp.asarray(acc))).reshape(4, -1)
    want_flat = np.asarray(jfe.external_step(
        jnp.asarray(acc_q), jnp.asarray(p)[:, None], jnp.asarray(row), **kw))

    tkw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    key = ttf.bootstrap_key_transformed(bk, "cpu", "NTT" if exact else "FFT")
    got = cmux.cmux_step_plain(torch.from_numpy(acc), torch.from_numpy(p),
                               key[0], **tkw)
    assert np.array_equal(got.numpy(), want_rows)
    t_row = torch.from_numpy(row.copy())
    assert k4.key_shape(t_row) == (mask1, decomp_length, not exact)
    got_q = k4.lanes_step_plain(torch.from_numpy(acc_q.copy()),
                                torch.from_numpy(p), t_row, **tkw)
    assert np.array_equal(got_q.numpy(), want_flat)
    assert np.array_equal(
        tfe.n_from_q(got_q.reshape(acc.shape)).numpy(), want_rows)


@pytest.mark.parametrize("in_size,l,out_size,bsz", [(64, 8, 20, 128)])
def test_keyswitch_base8_matches_jax(in_size, l, out_size, bsz):
    """K2's plain version on the base-8 ``ab_limbs`` (7 digit planes)
    against the JAX package's Pallas MAC in interpret mode, and the port's
    ``lwe_keyswitch`` against the JAX package's."""
    rng = np.random.RandomState(8)
    ks_a = rng.randint(-2**31, 2**31, (in_size, l, 8, out_size)
                       ).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (in_size, l, 8)).astype(np.int32)
    ks_a[:, :, 0] = 0
    ks_b[:, :, 0] = 0
    ks_cv = np.full((in_size, l, 8), 3e-9, np.float32)
    ks_cv[:, :, 0] = 0
    j_arrays, j_meta = jlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 3)
    t_arrays, t_meta = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 3,
                                                     "cpu")
    assert tuple(t_meta) == tuple(j_meta)
    assert np.array_equal(t_arrays["ab_limbs"].numpy(),
                          np.asarray(j_arrays["ab_limbs"]))
    assert t_arrays["ab_limbs"].shape[0] == 7
    a2 = rng.randint(-2**31, 2**31, (bsz, in_size)).astype(np.int32)
    want = np.asarray(pks.keyswitch_mac(jnp.asarray(a2), j_arrays["ab_limbs"],
                                        j_meta, lane_tile=bsz,
                                        interpret=True))
    got = tks.keyswitch_totals(torch.from_numpy(a2), t_arrays["ab_limbs"],
                               out_size=out_size, decomp_length=l,
                               log2_base=3).numpy()
    assert np.array_equal(got, want[:, :out_size + 2])

    src_b = rng.randint(-2**31, 2**31, (bsz,)).astype(np.int32)
    src_cv = rng.uniform(0, 1e-4, (bsz,)).astype(np.float32)
    ja, jb, jcv = jlwe.lwe_keyswitch(j_arrays, j_meta, jnp.asarray(a2),
                                     jnp.asarray(src_b),
                                     source_cv=jnp.asarray(src_cv))
    ta, tb, tcv = tlwe.lwe_keyswitch(t_arrays, t_meta, torch.from_numpy(a2),
                                     torch.from_numpy(src_b),
                                     source_cv=torch.from_numpy(src_cv))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.allclose(tcv.numpy(), np.asarray(jcv), rtol=1e-6, atol=0)


def test_wrappers_take_the_variant_shapes_and_name_the_rest():
    """The shape checks read mask1 from the accumulator and G = mask1*l
    from the key; a pair that no kernel instantiates is the plain steps'
    on the CPU, and its rows, a kernel's key, raise, naming it."""
    rng = np.random.RandomState(3)
    bk = rng.randint(-2**31, 2**31, (2, 3, 2, 3, 1024)).astype(np.int32)
    key = ttf.bootstrap_key_transformed(bk, "cpu", "NTT")
    assert key.shape == (2, 6, 3, 64, 32)
    assert tkr.key_form(key, (2,), "x", 3) == (False, 3, 2)
    with pytest.raises(ValueError):            # O = 3, not the acc's mask1
        tkr.key_form(key, (2,), "x", 2)
    wide = torch.zeros((12, 3, 64, 32), dtype=torch.int64)
    assert tkr.key_form(wide, (), "x", 3) == (False, 3, 4)   # plain steps
    with pytest.raises(ValueError, match=r"\(3, 4\)"):    # no kernel
        tkr._read_form(tkr.key_rows_plain(wide, False), (), "x", 3, True)
    with pytest.raises(ValueError):            # G = 5 is not a multiple of 2
        tkr.key_form(torch.zeros((5, 2, 64, 32), dtype=torch.int64), (),
                     "x", 2)
    assert cmux.check_acc(torch.zeros((1, 3, 1024), dtype=torch.int32),
                          "x") == 3
    for q, form in ((480, (3, 2, False)), (384, (3, 2, True))):
        assert k4.key_shape(torch.zeros((64, 384, q), dtype=torch.int8)) \
            == form
    with pytest.raises(ValueError):            # Q fits no form
        k4.key_shape(torch.zeros((64, 384, 100), dtype=torch.int8))
    assert set(ttf.KERNEL_SHAPES) == {(2, 2), (3, 2), (2, 3)}
