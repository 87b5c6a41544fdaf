"""Kernel K9's plain version (the rotation-family profile of the CMUX step,
``nufhe_tpu_torch/ops/step_profile.py``) against the JAX package, in both
key forms.

``tools/exp_round4.py::profile`` cannot be imported (its ``make`` has no
``interpret`` flag and times TPU launches), so its bodies are rebuilt here
from the same ``nufhe_tpu`` calls (``tools/exp_round4.py:113-168``), jnp on
the CPU, no Pallas: the rotation families are ``rows_engine.rotate_acc``
on the masked amounts (X^(p & mask) * acc: the TPU's barrel rounds of
those bits), "rotation (full)", "+decomp_pack2" and "FULL step" the rows
engine's ``rotate_acc``, ``gadget_decomp`` and ``external_step``.  The
three folded prefixes end in the card's own fold (its slot order and
q-layout), which no JAX body computes: they are held against that fold
written here over the JAX package's flat-engine stages on the rotation's
digits, its int8 MAC operand and its two-sided key limbs, which share no
code with the port.  Bit-exact; on the CPU the launch count does not
move.  ``tools/exp_round4_torch.py profile`` runs in-process in
``tests/test_torch_step_context.py``."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import flat_engine as jfe
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw
from nufhe_tpu.ops import transform as jtf
from nufhe_tpu.ref import transform_ref as jtr

from nufhe_tpu_torch.ops import step_profile as spf
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 32
MODES = ("NTT", "FFT")
REV = jtf.BITREV_L


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2035)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    powers = rng.randint(0, 2048, (B,)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (1, 2, 2, 2, 1024)).astype(np.int32)
    out = dict(accum=accum, powers=powers, bk=bk)
    for mode in MODES:
        exact = mode == "NTT"
        out[mode] = (
            ttf.bootstrap_key_transformed(bk, "cpu", mode)[0].contiguous(),
            np.asarray(dtgsw.prepare_bootstrap_key_device(bk, exact=exact)[0]))
    return out


def _port(name, inputs, mode):
    before = spf.launches
    out = spf.step_profile(name, torch.from_numpy(inputs["accum"]),
                           torch.from_numpy(inputs["powers"]),
                           inputs[mode][0], **KW)
    assert spf.launches == before
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (B, spf.out_polys(name), 1024)
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["noop (1 pass)", "rot j-rolls b0-4",
                                  "rot Y-rolls 1/2/4", "rot Y-rolls 8/16",
                                  "rotation (full)", "+decomp_pack2",
                                  "FULL step"])
def test_parts_match_rows_engine(inputs, mode, name):
    acc_r = re_.acc_rows_from_n(jnp.asarray(inputs["accum"]))
    p = jnp.asarray(inputs["powers"])[None, :]
    if name == "noop (1 pass)":
        want = re_.acc_n_from_rows((acc_r + 1).astype(jnp.int32), 2)
    elif name in spf.FAMILY_MASKS:
        want = re_.acc_n_from_rows(
            re_.rotate_acc(acc_r, p & spf.FAMILY_MASKS[name], 2), 2)
    elif name == "FULL step":
        want = re_.acc_n_from_rows(re_.external_step(
            acc_r, p, jnp.asarray(inputs[mode][1]), mask1=2, decomp_length=2,
            log2_base=L2B, offset=OFFSET, mac_dtype=jnp.float32), 2)
    else:
        rot = re_.rotate_acc(acc_r, p, 2, minus_one=True)
        if name == "rotation (full)":
            want = re_.acc_n_from_rows(rot, 2)
        else:
            want = re_.acc_n_from_rows(
                re_.gadget_decomp(rot, 2, 2, L2B, OFFSET), 4)
    assert np.array_equal(_port(name, inputs, mode), np.asarray(want))


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _fold(x):
    """(B, P, 2048) slot-order words -> (B, P, 1024) coefficient order:
    slot p' + slot p' + 32 at q-layout p'*32 + lane."""
    q = _wrap(np.asarray(x, np.int64).reshape(B, -1, 2, 1024).sum(2))
    return np.asarray(jfe.n_from_q(jnp.asarray(q)))


def _key_words(bk, exact):
    """The key term of "+lhs": per slot p and lane k, the sum of words
    k & 15 of the slot's limb rows (g, o, limb: vlo, vhi_0..3, 4*vlo exact;
    vhi_0..3 rounded), row byte 31 - r side 0's limb at rotation r, byte
    63 - r side 1's, from the JAX package's two-sided limbs."""
    limbs = jtf.key_limbs_host(jtr.forward(bk[0]), exact=exact)
    n_l = limbs.shape[-2]
    limbs = limbs.reshape(8, 64, 32, n_l, 2).astype(np.int64)
    if exact:
        limbs = np.concatenate([limbs, 4 * limbs[..., :1, :]], axis=-2)
    rows_go = limbs.shape[-2]
    rows = np.zeros((64, 8, rows_go, 64), np.int64)
    r = np.arange(32)
    for p in range(64):
        side = limbs[:, REV[p]].transpose(0, 2, 1, 3) & 255
        rows[p][:, :, 31 - r] = side[..., 0]
        rows[p][:, :, 63 - r] = side[..., 1]
    words = (rows.reshape(64, 8, rows_go, 16, 4) << (8 * np.arange(4))).sum(-1)
    return (words.sum(axis=(1, 2)) & 0xFFFFFFFF)[:, r & 15]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["+forward (fold glue)", "+lhs (sum glue 8x)",
                                  "+mac dot (sum glue)"])
def test_fold_parts_match_jax_flat_stages(inputs, mode, name):
    rhs = inputs[mode][1]
    acc_q = jfe.q_from_n(jnp.asarray(inputs["accum"])).reshape(B, 2048)
    rot = jfe.rotate_q(acc_q, jnp.asarray(inputs["powers"])[:, None],
                       minus_one=True)
    dig = jfe.gadget_decomp_flat(rot, 2, 2, L2B, OFFSET)
    xt = np.asarray(jfe.dif_forward_q(dig, n_poly=4)).reshape(
        B, 4, 64, 32).astype(np.int64)
    a0 = ((xt + 128) & 255) - 128
    a1 = (xt - a0) >> 8
    if name == "+forward (fold glue)":
        words = xt.reshape(B, 2, 2, 2048).sum(2)
    elif name == "+lhs (sum glue 8x)":
        lsum = (a0 + a1).sum(1)
        words = np.broadcast_to((lsum + _key_words(inputs["bk"],
                                                   mode == "NTT")).reshape(
            B, 1, 2048), (B, 2, 2048))
    else:
        lhs = np.stack([a0, a1], axis=2).transpose(0, 3, 1, 2, 4).reshape(
            B, 64, 256)
        groups = rhs.shape[-1] // 64
        ps = np.einsum('btc,tcq->btq', lhs, rhs.astype(np.int64)).reshape(
            B, 64, groups, 2, 32)
        first = groups - 4
        chans = (ps[:, :, first] + (ps[:, :, first + 1] << 8)
                 + (ps[:, :, first + 2] << 16) + (ps[:, :, first + 3] << 24))
        if first:
            chans = chans + ps[:, :, 0]          # the hi channel
        words = chans.transpose(0, 2, 1, 3).reshape(B, 2, 2048)
    assert np.array_equal(_port(name, inputs, mode), _fold(words))


def test_step_profile_rejects_bad_input(inputs):
    acc = torch.from_numpy(inputs["accum"])
    p = torch.from_numpy(inputs["powers"])
    key = inputs["NTT"][0]
    with pytest.raises(ValueError):
        spf.step_profile("rot j-rolls b0-9", acc, p, key, **KW)
    with pytest.raises(ValueError):
        spf.step_profile("FULL step", acc, p[:-1], key, **KW)
    with pytest.raises(ValueError):
        spf.step_profile("FULL step", acc, p, key[:, :1].contiguous(), **KW)
