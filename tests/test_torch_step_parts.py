"""Kernel K5's plain version (the stage parts of the exact CMUX step,
``nufhe_tpu_torch/ops/step_parts.py``) against the JAX package, and
``tools/microbench_torch.py`` run in-process on the CPU.

Four parts are functions of the inputs in coefficient order and are held
against the JAX rows engine's bodies (jnp on the CPU, no Pallas), as
``tests/test_rows.py`` runs them.  The other four end in a fold whose
layout is the card's own (its slot order and q-layout), which no JAX
function computes: the TPU's ``bench_parts`` folds its own rows layout.
They are held against that fold written here over the JAX package's
lanes-engine stages (``nufhe_tpu/ops/flat_engine.py``) and its int8 MAC
operand, which share no code with the port.  Bit-exact throughout; on
the CPU the launch count does not move."""

import ast
import os
import sys

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

from nufhe_tpu_torch.ops import step_parts as sp
from nufhe_tpu_torch.ops import transform as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 128
REV = jtf.BITREV_L


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2031)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    powers = rng.randint(0, 2048, (B,)).astype(np.int32)
    bk_coeff = rng.randint(-2**31, 2**31, (1, 2, 2, 2, 1024)).astype(np.int32)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")[0].contiguous()
    rhs = np.asarray(dtgsw.prepare_bootstrap_key_device(bk_coeff,
                                                        exact=True)[0])
    return accum, powers, bk_coeff, key, rhs


def _port(name, inputs):
    accum, powers, _, key, _ = inputs
    before = sp.launches
    out = sp.step_part(name, torch.from_numpy(accum),
                       torch.from_numpy(powers), key, **KW)
    assert sp.launches == before
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (B, sp.out_polys(name), 1024)
    return out.numpy()


@pytest.mark.parametrize("name", ["rotate", "rot+decomp", "dec+fwd+mac+inv",
                                  "FULL step"])
def test_coefficient_parts_match_rows_engine(inputs, name):
    accum, powers, _, _, rhs = inputs
    acc_r = re_.acc_rows_from_n(jnp.asarray(accum))
    p = jnp.asarray(powers)[None, :]
    if name == "rotate":
        want = re_.acc_n_from_rows(re_.rotate_acc(acc_r, p, 2, minus_one=True),
                                   2)
    elif name == "rot+decomp":
        rot = re_.rotate_acc(acc_r, p, 2, minus_one=True)
        want = re_.acc_n_from_rows(re_.gadget_decomp(rot, 2, 2, L2B, OFFSET), 4)
    elif name == "dec+fwd+mac+inv":
        d = re_.gadget_decomp(acc_r, 2, 2, L2B, OFFSET)
        want = re_.acc_n_from_rows(re_.transformed_mac(
            d, jnp.asarray(rhs), mask1=2, g_total=4, mac_dtype=jnp.float32), 2)
    else:
        want = re_.acc_n_from_rows(re_.external_step(
            acc_r, p, jnp.asarray(rhs), mask1=2, decomp_length=2,
            log2_base=L2B, offset=OFFSET, mac_dtype=jnp.float32), 2)
    assert np.array_equal(_port(name, inputs), np.asarray(want))


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _fold(x):
    """(B, P, 2048) slot-order words -> (B, P, 1024) coefficient order:
    slot p' + slot p' + 32 at q-layout p'*32 + lane."""
    q = _wrap(np.asarray(x, np.int64).reshape(B, -1, 2, 1024).sum(2))
    return np.asarray(jfe.n_from_q(jnp.asarray(q)))


def _jax_forward(accum):
    """The JAX lanes engine's digits of acc (no rotation) and their forward
    transforms: (B, 4, 64, 32), slot p holding frequency bitrev_6(p)."""
    acc_q = jfe.q_from_n(jnp.asarray(accum)).reshape(B, 2048)
    dig = jfe.gadget_decomp_flat(acc_q, 2, 2, L2B, OFFSET)
    return np.asarray(jfe.dif_forward_q(dig, n_poly=4)).reshape(B, 4, 64, 32)


def _jax_channels(xt, rhs):
    """The MAC of the JAX int8 operand (L, 256, 320) on the limbs of the
    transforms: lo = A0 + A1<<8 + A2<<16 + A3<<24 and hi = B, (B, 2, 64,
    32) each, mod 2^32."""
    a0 = ((xt + 128) & 255) - 128
    a1 = (xt - a0) >> 8
    lhs = np.stack([a0, a1], axis=2).transpose(0, 3, 1, 2, 4).reshape(
        B, 64, 256).astype(np.int64)
    ps = np.einsum('btc,tcq->btq', lhs, rhs.astype(np.int64)).reshape(
        B, 64, 5, 2, 32)
    lo = ps[:, :, 1] + (ps[:, :, 2] << 8) + (ps[:, :, 3] << 16) \
        + (ps[:, :, 4] << 24)
    return lo.transpose(0, 2, 1, 3), ps[:, :, 0].transpose(0, 2, 1, 3)


def _key_words(bk_coeff):
    """The key term of "dec+fwd+key" from the JAX package's two-sided
    limbs: per slot p and lane k, the sum of words k & 15 of the 48 limb
    rows (g, o, limb 0..5 = vlo, vhi_0..3, 4*vlo), row byte 31 - r side
    0's limb at rotation r, byte 63 - r side 1's."""
    limbs = jtf.key_limbs_host(jtr.forward(bk_coeff[0]), exact=True)
    limbs = limbs.reshape(8, 64, 32, 5, 2).astype(np.int64)   # (go, t, r)
    limbs = np.concatenate([limbs, 4 * limbs[..., :1, :]], axis=-2)
    rows = np.zeros((64, 8, 6, 64), np.int64)
    r = np.arange(32)
    for p in range(64):
        side = limbs[:, REV[p]].transpose(0, 2, 1, 3) & 255   # (go, limb, r, s)
        rows[p][:, :, 31 - r] = side[..., 0]
        rows[p][:, :, 63 - r] = side[..., 1]
    words = (rows.reshape(64, 8, 6, 16, 4) << (8 * np.arange(4))).sum(-1)
    sums = words.sum(axis=(1, 2)) & 0xFFFFFFFF
    return sums[:, r & 15]                                      # (p, k)


@pytest.mark.parametrize("name", ["dec+fwd", "dec+fwd+key", "dec+fwd+mac",
                                  "inverse only"])
def test_fold_parts_match_jax_flat_stages(inputs, name):
    accum, _, bk_coeff, _, rhs = inputs
    if name == "inverse only":
        acc_q = np.asarray(jfe.q_from_n(jnp.asarray(accum))).reshape(B, 2048)
        stand_in = np.concatenate([acc_q[:, :1024], acc_q[:, :1024],
                                   acc_q[:, 1024:], acc_q[:, 1024:]], axis=1)
        inv = jfe.dit_inverse_q(jnp.asarray(stand_in), n_poly=2)
        delta = jfe.normalize_dual(inv, inv)
        want = np.asarray(jfe.n_from_q((jnp.asarray(acc_q) + delta).reshape(
            B, 2, 1024)))
    else:
        xt = _jax_forward(accum)
        if name == "dec+fwd":
            words = xt.reshape(B, 2, 2, 2048).astype(np.int64).sum(2)
        elif name == "dec+fwd+mac":
            lo, hi = _jax_channels(xt, rhs)
            words = (lo + hi).reshape(B, 2, 2048)
        else:
            a0 = ((xt + 128) & 255) - 128
            lsum = (a0 + ((xt - a0) >> 8)).astype(np.int64).sum(1)
            words = np.broadcast_to((lsum + _key_words(bk_coeff)).reshape(
                B, 1, 2048), (B, 2, 2048))
        want = _fold(words)
    assert np.array_equal(_port(name, inputs), want)


def test_step_part_rejects_bad_input(inputs):
    accum, powers, _, key, _ = inputs
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    with pytest.raises(ValueError):
        sp.step_part("fwd only", acc, p, key, **KW)
    with pytest.raises(ValueError):          # the rounded key: exact only
        sp.step_part("rotate", acc, p, torch.stack([key, key]), **KW)
    with pytest.raises(ValueError):
        sp.step_part("rotate", acc, p[:-1], key, **KW)


def test_microbench_modes_on_cpu(capsys):
    """Every mode of the port's microbenchmark in-process on the CPU at
    batch 8: host times only, each rotation variant checked equal."""
    sys.path.append(os.path.join(ROOT, "tools"))
    import microbench_torch as mb
    assert set(mb.bench_step(8, "cpu", reps=1)) == {"ms", "ms_bit"}
    assert set(mb.bench_parts(8, "cpu", reps=1)) == set(sp.PARTS)
    assert mb.bench_keyswitch(8, "cpu", reps=1)["ms"] > 0
    res = mb.bench_rotation(8, "cpu", n_steps=2, chunks=(1, 2, 3), reps=1)
    assert set(res) == {"per-step", 1, 2}
    assert set(mb.bench_intadd(4, 2, "cpu", lwe_size=4, reps=1)) == {
        "ripple", "kogge-stone"}
    assert "host ms (CPU)" in capsys.readouterr().out


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [
    "tools/microbench_torch.py", "tools/exp_round4_torch.py",
    "tools/exp_int8_torch.py", "tools/exp_overlap_torch.py",
    "tools/exp_round3_torch.py", "tools/exp_round5_torch.py",
    "tools/exp_inverse_torch.py", "tools/mac_dot_cuts_torch.py",
    "examples/gate_nand_torch.py",
    "examples/gate_nand_low_level_torch.py", "examples/integer_adder_torch.py",
    "examples/serialization_torch.py", "examples/transform_modes_torch.py"])
def test_port_scripts_import_neither_jax_nor_nufhe_tpu(path):
    names = _imports(os.path.join(ROOT, path))
    assert "nufhe_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "nufhe_tpu"}, names
