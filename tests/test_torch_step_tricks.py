"""Kernel K11's plain version (the step tricks,
``nufhe_tpu_torch/ops/step_tricks.py``) against the JAX package, and the
``tricks`` mode of ``tools/exp_round4_torch.py`` run in-process on the
CPU.

``tools/exp_round4.py::tricks`` cannot be imported (it times TPU launches
as it runs).  It asserts every variant equal to the engine's step chained
over the rotation (``re_.external_step``), t8 and t8+t9 to that step on
the evened powers ``bara & ~1`` (``tools/exp_round4.py:661``), so the
plain versions are held against exactly those, rebuilt from the same
``nufhe_tpu`` calls with jnp on the CPU, no Pallas, in both key forms, bit
for bit; on the CPU the launch count does not move."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw

from nufhe_tpu_torch.ops import step_tricks as st
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 8
STEPS = 3
MODES = ("NTT", "FFT")


def _chained(accum, bara, rhs):
    a = re_.acc_rows_from_n(jnp.asarray(accum))
    for step in range(STEPS):
        a = re_.external_step(a, jnp.asarray(bara[step])[None, :],
                              jnp.asarray(rhs[step]), mask1=2,
                              decomp_length=2, log2_base=L2B, offset=OFFSET,
                              mac_dtype=jnp.float32)
    return np.asarray(re_.acc_n_from_rows(a, 2))


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2045)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    bara = rng.randint(0, 2048, (STEPS, B)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (STEPS, 2, 2, 2, 1024)).astype(np.int32)
    out = dict(accum=accum, bara=bara)
    for mode in MODES:
        rhs = np.asarray(dtgsw.prepare_bootstrap_key_device(
            bk, exact=mode == "NTT"))
        out[mode] = (ttf.bootstrap_key_transformed(bk, "cpu", mode),
                     _chained(accum, bara, rhs),
                     _chained(accum, bara & ~np.int32(1), rhs))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", st.VARIANTS)
def test_tricks_match_chained_external_step(inputs, mode, variant):
    key, want, want_even = inputs[mode]
    before = st.launches
    got = st.step_trick(variant, torch.from_numpy(inputs["accum"]),
                        torch.from_numpy(inputs["bara"]), key, 0, STEPS, **KW)
    assert st.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 2, 1024)
    assert np.array_equal(got.numpy(),
                          want_even if variant in st.EVEN else want)


def test_even_variants_differ_on_odd_powers(inputs):
    """t8's evening is part of its function: on these odd amounts its
    output differs from the baseline's."""
    key, want, _ = inputs["NTT"]
    assert (inputs["bara"] & 1).any()
    got = st.step_trick("t8", torch.from_numpy(inputs["accum"]),
                        torch.from_numpy(inputs["bara"]), key, 0, STEPS, **KW)
    assert not np.array_equal(got.numpy(), want)


def test_step_trick_rejects_bad_input(inputs):
    key = inputs["NTT"][0]
    acc = torch.from_numpy(inputs["accum"])
    bara = torch.from_numpy(inputs["bara"])
    with pytest.raises(ValueError):
        st.step_trick("t4", acc, bara, key, 0, 1, **KW)
    with pytest.raises(ValueError):
        st.step_trick("t9", acc, bara, key, 1, 3, **KW)
    with pytest.raises(ValueError):
        st.step_trick("t9", acc[:, :1].contiguous(), bara, key, 0, 1, **KW)
