"""Kernel K6's plain version (the in-loop stage stand-ins of the chunked
rotation, ``nufhe_tpu_torch/ops/step_context.py``) against the JAX
package, and ``tools/exp_round4_torch.py`` run in-process on the CPU.

``tools/exp_round4.py::context`` cannot be imported (its ``make`` has no
``interpret`` flag and times TPU launches), so its bodies are rebuilt here
from the same ``nufhe_tpu`` calls (``tools/exp_round4.py:254-317``), jnp on
the CPU, no Pallas: "FULL" is ``rows_engine.external_step`` chained (its
``full``), "no rotation" the chained ``transformed_mac`` of
``gadget_decomp(acc)`` (``no_rot``), "noop step" acc + steps
(``noop_step``).  The other stand-ins are the card's own (its slot order
and limbs, which no JAX body computes): they are held against the same
stand-in written here over the JAX package's flat-engine stages and its
int8 MAC operand, which share no code with the port.  Both key forms;
bit-exact throughout; on the CPU the launch count does not move."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import flat_engine as jfe
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw

from nufhe_tpu_torch.ops import step_context as sc
from nufhe_tpu_torch.ops import step_parts as sp
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 8
STEPS = 3
MODES = ("NTT", "FFT")


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2032)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    bara = rng.randint(0, 2048, (STEPS, B)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (STEPS, 2, 2, 2, 1024)).astype(np.int32)
    out = dict(accum=accum, bara=bara)
    for mode in MODES:
        exact = mode == "NTT"
        out[mode] = (ttf.bootstrap_key_transformed(bk, "cpu", mode),
                     np.asarray(dtgsw.prepare_bootstrap_key_device(
                         bk, exact=exact)))
    return out


def _port(variant, inputs, mode):
    key = inputs[mode][0]
    before = sc.launches
    out = sc.step_context(variant, torch.from_numpy(inputs["accum"]),
                          torch.from_numpy(inputs["bara"]), key, 0, STEPS,
                          **KW)
    assert sc.launches == before
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, 2, 1024)
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_mac_operand_matches_jax(inputs, mode):
    """The plain versions' int8 operand from the rows key (both forms) is
    the JAX package's ``build_mac_rhs`` of the same coefficient key."""
    key, rhs = inputs[mode]
    for step in range(STEPS):
        assert np.array_equal(sp.mac_operand(key[step]).numpy(), rhs[step])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["FULL", "no rotation", "noop step"])
def test_jax_bodies(inputs, mode, variant):
    _, rhs = inputs[mode]
    mac = jnp.float32
    a = re_.acc_rows_from_n(jnp.asarray(inputs["accum"]))
    for step in range(STEPS):
        p = jnp.asarray(inputs["bara"][step])[None, :]
        r = jnp.asarray(rhs[step])
        if variant == "FULL":
            a = re_.external_step(a, p, r, mask1=2, decomp_length=2,
                                  log2_base=L2B, offset=OFFSET,
                                  mac_dtype=mac)
        elif variant == "no rotation":
            d = re_.gadget_decomp(a, 2, 2, L2B, OFFSET)
            a = (a + re_.transformed_mac(d, r, mask1=2, g_total=4,
                                         mac_dtype=mac)).astype(jnp.int32)
        else:
            a = (a + 1).astype(jnp.int32)
    want = np.asarray(re_.acc_n_from_rows(a, 2))
    assert np.array_equal(_port(variant, inputs, mode), want)


def _int8(x):
    return ((x & 255) ^ 128) - 128


def _jax_stand_in_step(variant, acc_q, p, rhs):
    """One step of a card stand-in over the JAX flat-engine stages and the
    JAX int8 operand (L, 256, Q): acc_q (B, 2048) q-layout."""
    if variant in ("dot only", "no rotation"):
        src = jnp.asarray(acc_q)
    else:
        src = jfe.rotate_q(jnp.asarray(acc_q), jnp.asarray(p)[:, None],
                           minus_one=True)
    src = np.asarray(src)
    if variant == "dot only":
        dig = np.repeat(src.reshape(B, 2, 1, 1024), 2, axis=2)
    elif variant == "no pack":
        dig = np.repeat(((src & 1023) - 512).reshape(B, 2, 1, 1024), 2,
                        axis=2)
    else:
        dig = np.asarray(jfe.gadget_decomp_flat(jnp.asarray(src), 2, 2, L2B,
                                                OFFSET))
    dig = dig.reshape(B, 4 * 1024).astype(np.int32)
    if variant in ("dot only", "no forward"):
        blocks = dig.reshape(B, 4, 32, 32)
        xt = np.concatenate([blocks, blocks], axis=2)          # slots j, j+32
    else:
        xt = np.asarray(jfe.dif_forward_q(jnp.asarray(dig), n_poly=4)
                        ).reshape(B, 4, 64, 32)
    xt = xt.astype(np.int64)
    if variant in ("dot only", "no lhs-split"):
        a0, a1 = _int8(xt), _int8(xt >> 8)
    else:
        a0 = ((xt + 128) & 255) - 128
        a1 = (xt - a0) >> 8
    lhs = np.stack([a0, a1], axis=2).transpose(0, 3, 1, 2, 4).reshape(
        B, 64, 256)
    groups = rhs.shape[-1] // 64
    ps = np.einsum('btc,tcq->btq', lhs, rhs.astype(np.int64)).reshape(
        B, 64, groups, 2, 32)
    first = groups - 4                       # exact: [B, A0..A3]
    lo = (ps[:, :, first] + (ps[:, :, first + 1] << 8)
          + (ps[:, :, first + 2] << 16) + (ps[:, :, first + 3] << 24))
    chans = [lo] + ([ps[:, :, 0]] if first else [])
    chans = [((c + 2**31) % 2**32 - 2**31).transpose(0, 2, 1, 3)
             .reshape(B, 2 * 2048).astype(np.int32) for c in chans]
    acc64 = np.asarray(acc_q, np.int64)
    if variant in ("dot only", "no inverse"):
        folded = sum(c.astype(np.int64).reshape(B, 2, 2, 1024).sum(2)
                     for c in chans)
        out = acc64 + folded.reshape(B, 2048)
    else:
        inv = [jfe.dit_inverse_q(jnp.asarray(c), n_poly=2) for c in chans]
        delta = jfe.normalize_dual(inv[0], inv[1] if len(inv) > 1 else None)
        out = acc64 + np.asarray(delta, np.int64)
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["dot only", "no rotation", "no forward",
                                     "no lhs-split", "no pack", "no inverse",
                                     "no key split"])
def test_card_stand_ins_match_jax_flat_stages(inputs, mode, variant):
    _, rhs = inputs[mode]
    acc_q = np.asarray(jfe.q_from_n(jnp.asarray(inputs["accum"]))).reshape(
        B, 2048)
    key_rhs = rhs[0][np.arange(64) % 16]       # slot p reads slot p % 16
    for step in range(STEPS):
        r = key_rhs if variant == "no key split" else rhs[step]
        acc_q = _jax_stand_in_step(
            "FULL" if variant == "no key split" else variant, acc_q,
            inputs["bara"][step], r)
    want = np.asarray(jfe.n_from_q(jnp.asarray(acc_q.reshape(B, 2, 1024))))
    assert np.array_equal(_port(variant, inputs, mode), want)


def test_step_context_rejects_bad_input(inputs):
    key = inputs["NTT"][0]
    acc = torch.from_numpy(inputs["accum"])
    bara = torch.from_numpy(inputs["bara"])
    with pytest.raises(ValueError):
        sc.step_context("no dot", acc, bara, key, 0, 1, **KW)
    with pytest.raises(ValueError):
        sc.step_context("FULL", acc, bara, key, 2, 2, **KW)
    with pytest.raises(ValueError):
        sc.step_context("FULL", acc[:, :1].contiguous(), bara, key, 0, 1,
                        **KW)


def test_exp_round4_modes_on_cpu(capsys, monkeypatch):
    """``profile``, ``context`` and ``tricks`` in-process on the CPU at batch
    4 (both engines, host times only; ``tricks`` at 2 steps with
    ``NUFHE_TRICKS`` picking t8, each variant equal to K3's plain
    version); an unknown mode exits."""
    import os
    import sys
    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import exp_round4_torch as e4
    from nufhe_tpu_torch.ops import step_profile as spf
    monkeypatch.setenv("NUFHE_TRICKS", "t8")
    for exact in (True, False):
        res = e4.context(4, "cpu", n_steps=2, exact=exact, reps=1)
        assert set(res) == set(sc.VARIANTS)
        res = e4.profile(4, "cpu", exact=exact, reps=1)
        assert set(res) == set(spf.PARTS)
        res = e4.tricks(4, "cpu", n_steps=2, exact=exact, reps=1)
        assert set(res) == {"baseline", "t8+t9", "t8"}
        assert res["t8"]["exact"] and res["t8+t9"]["exact"]
    with pytest.raises(SystemExit, match="unknown mode"):
        e4.main(["trick", "4", "--device", "cpu"])
    assert "host ms (CPU)" in capsys.readouterr().out
