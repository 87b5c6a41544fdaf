"""The port's keyswitch (kernel K2's plain version and ``lwe_keyswitch``)
against the JAX package's Pallas keyswitch MAC in interpret mode and its
``lwe_keyswitch``.  Integers bit-exact, cv allclose at rtol 1e-6 (both sides
compute it in float32 from the same formula)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.ops import lwe as jlwe
from nufhe_tpu.ops.pallas import keyswitch as pks
from nufhe_tpu.ref import lwe_ref as jlwe_ref
from nufhe_tpu.utils import errors_allclose

from nufhe_tpu_torch.ops import keyswitch as tks
from nufhe_tpu_torch.ops import lwe as tlwe


def _key(seed, in_size, l, base, out_size):
    rng = np.random.RandomState(seed)
    ks_a = rng.randint(-2**31, 2**31, (in_size, l, base, out_size)
                       ).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (in_size, l, base)).astype(np.int32)
    ks_a[:, :, 0] = 0
    ks_b[:, :, 0] = 0
    ks_cv = np.full((in_size, l, base), 3e-9, np.float32)
    ks_cv[:, :, 0] = 0
    return rng, ks_a, ks_b, ks_cv


# (in_size, l, out_size, batch): the sizes of the JAX package's own Pallas
# keyswitch test, and the full default sizes (1024 -> 500, t=8, base 4)
SIZES = [(64, 8, 20, 256), (1024, 8, 500, 16)]


@pytest.mark.parametrize("in_size,l,out_size,bsz", SIZES)
def test_keyswitch_totals_match_pallas_interpret(in_size, l, out_size, bsz):
    rng, ks_a, ks_b, ks_cv = _key(in_size, in_size, l, 4, out_size)
    j_arrays, j_meta = jlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2)
    t_arrays, t_meta = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2,
                                                     "cpu")
    a2 = rng.randint(-2**31, 2**31, (bsz, in_size)).astype(np.int32)
    want = np.asarray(pks.keyswitch_mac(
        jnp.asarray(a2), j_arrays["ab_limbs"], j_meta,
        lane_tile=min(128, bsz), interpret=True))

    launches = tks.launches
    got = tks.keyswitch_totals(torch.from_numpy(a2), t_arrays["ab_limbs"],
                               out_size=out_size, decomp_length=l,
                               log2_base=2).numpy()
    assert tks.launches == launches     # CPU tensors take the plain version
    assert got.shape == (bsz, out_size + 2)
    assert np.array_equal(got, want[:, :out_size + 2])
    # the last column counts the nonzero digits
    digits = jlwe_ref.keyswitch_digits(a2, l, 2)
    assert np.array_equal(got[:, -1], (digits != 0).sum(axis=(1, 2)))


@pytest.mark.parametrize("in_size,l,out_size,bsz", SIZES)
def test_lwe_keyswitch_matches_jax(in_size, l, out_size, bsz):
    rng, ks_a, ks_b, ks_cv = _key(in_size + 1, in_size, l, 4, out_size)
    j_arrays, j_meta = jlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2)
    t_arrays, t_meta = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2,
                                                     "cpu")
    assert tuple(t_meta) == tuple(j_meta)
    src_a = rng.randint(-2**31, 2**31, (bsz, in_size)).astype(np.int32)
    src_b = rng.randint(-2**31, 2**31, (bsz,)).astype(np.int32)
    src_cv = rng.uniform(0, 1e-4, (bsz,)).astype(np.float32)

    ja, jb, jcv = jlwe.lwe_keyswitch(
        j_arrays, j_meta, jnp.asarray(src_a), jnp.asarray(src_b),
        source_cv=jnp.asarray(src_cv))
    ta, tb, tcv = tlwe.lwe_keyswitch(
        t_arrays, t_meta, torch.from_numpy(src_a), torch.from_numpy(src_b),
        source_cv=torch.from_numpy(src_cv))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.allclose(tcv.numpy(), np.asarray(jcv), rtol=1e-6, atol=0)

    if in_size == 64:
        # and against the numpy oracle's per-entry loop; its cv is a
        # sequential float32 sum of hundreds of entries, so it is held to
        # the JAX package's tolerance for accumulated variances
        oa, ob, ocv = jlwe_ref.lwe_keyswitch(ks_a, ks_b, ks_cv, src_a, src_b,
                                             l, 2)
        assert np.array_equal(ta.numpy(), oa)
        assert np.array_equal(tb.numpy(), ob)
        assert errors_allclose(tcv.numpy(), ocv + src_cv)


def test_prepare_keyswitch_rejects_bad_keys():
    _, ks_a, ks_b, ks_cv = _key(0, 8, 2, 4, 4)
    bad_cv = ks_cv.copy()
    bad_cv[0, 0, 1] = 1e-9
    with pytest.raises(ValueError):
        tlwe.prepare_keyswitch_device(ks_a, ks_b, bad_cv, 2, "cpu")
    with pytest.raises(ValueError):
        tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 3, "cpu")


@pytest.mark.parametrize("in_size,l,out_size,bsz", SIZES)
def test_ab_limbs_match_jax(in_size, l, out_size, bsz):
    """The port's K2 operand is the JAX package's ``ab_limbs`` bit for bit."""
    _, ks_a, ks_b, ks_cv = _key(in_size + 2, in_size, l, 4, out_size)
    j_arrays, _ = jlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2)
    t_arrays, _ = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2, "cpu")
    want = np.asarray(j_arrays["ab_limbs"])
    got = t_arrays["ab_limbs"].numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert got.shape == (3, 4, in_size * l, tlwe.ks_n_pad(out_size))
    assert np.array_equal(got, want)


def _k2_mirror(a, ab_limbs, out_size, l):
    """K2's arithmetic in PyTorch, as the kernel writes it: the digits of
    row j from byte 3 (j < 4) or byte 2 (j >= 4) of a + prec, shifted by
    6 - 2*(j % 4); one-hot bytes lo & ~hi, ~lo & hi, lo & hi for v = 1, 2,
    3; one int32 sum a limb (exact: |sum| <= rows * 128); the limbs
    recombined in uint32."""
    prec = 2 ** (32 - (1 + 2 * l))
    x = (a.to(torch.int64) + prec) & 0xFFFFFFFF
    onehot = [[], [], []]
    for j in range(l):
        byte = (x >> (24 if j < 4 else 16)) & 255
        sh = 6 - 2 * (j % 4)
        lo, hi = (byte >> sh) & 1, (byte >> (sh + 1)) & 1
        for v, oh in enumerate((lo & (1 - hi), (1 - lo) & hi, lo & hi)):
            onehot[v].append(oh)
    onehot = [torch.cat(oh, dim=1).to(torch.float64) for oh in onehot]
    total = torch.zeros((a.shape[0], ab_limbs.shape[-1]), dtype=torch.int64)
    for limb in range(4):
        s = sum(oh @ ab_limbs[v, limb].to(torch.float64)
                for v, oh in enumerate(onehot)).to(torch.int64)
        assert s.abs().max() <= ab_limbs.shape[2] * 128
        total = (total + ((s & 0xFFFFFFFF) << (8 * limb))) & 0xFFFFFFFF
    total = total[:, :out_size + 2]
    return torch.where(total >= 2**31, total - 2**32, total).to(torch.int32)


@pytest.mark.parametrize("in_size,l,out_size,bsz", SIZES)
def test_k2_mirror_matches_plain(in_size, l, out_size, bsz):
    rng, ks_a, ks_b, ks_cv = _key(in_size + 3, in_size, l, 4, out_size)
    t_arrays, _ = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2, "cpu")
    a = torch.from_numpy(
        rng.randint(-2**31, 2**31, (bsz, in_size)).astype(np.int32))
    want = tks.keyswitch_totals_plain(a, t_arrays["ab_limbs"],
                                      out_size=out_size, decomp_length=l,
                                      log2_base=2)
    got = _k2_mirror(a, t_arrays["ab_limbs"], out_size, l)
    assert torch.equal(got, want)
