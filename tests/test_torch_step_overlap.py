"""Kernel K8's plain version (the exact CMUX step in the split-halves
schedule, ``nufhe_tpu_torch/ops/step_overlap.py``) against the JAX
package, and ``tools/exp_overlap_torch.py`` run in-process on the CPU.

``tools/exp_overlap.py`` cannot be imported (it times TPU launches at
import time).  It asserts its ``mac_split`` equal to ``mac_serial``, which
is ``rows_engine.external_step`` (``:107-110``, ``:137-142``), so the plain
version of the split is held against that function, jnp on the CPU, and
against the port's serial step (K1's plain version).  Bit-exact; on the
CPU the launch count does not move."""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw

from nufhe_tpu_torch.ops import cmux
from nufhe_tpu_torch.ops import step_overlap as so
from nufhe_tpu_torch.ops import transform as ttf

TP = NuFHEParameters().tgsw_params
OFFSET, L2B = int(TP.offset), TP.bs_log2_base
KW = dict(offset=OFFSET, log2_base=L2B)
B = 16


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(1)
    rng = np.random.RandomState(2034)
    accum = rng.randint(-2**31, 2**31, (B, 2, 1024)).astype(np.int32)
    powers = rng.randint(0, 2048, (B,)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (1, 2, 2, 2, 1024)).astype(np.int32)
    key = ttf.bootstrap_key_transformed(bk, "cpu")[0].contiguous()
    rhs = np.asarray(dtgsw.prepare_bootstrap_key_device(bk, exact=True)[0])
    return accum, powers, key, rhs


def test_split_matches_rows_engine_external_step(inputs):
    accum, powers, key, rhs = inputs
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    before = so.launches
    got = so.step_overlap(acc, p, key, **KW)
    assert so.launches == before
    want = re_.acc_n_from_rows(re_.external_step(
        re_.acc_rows_from_n(jnp.asarray(accum)), jnp.asarray(powers)[None, :],
        jnp.asarray(rhs), mask1=2, decomp_length=2, log2_base=L2B,
        offset=OFFSET, mac_dtype=jnp.float32), 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, cmux.cmux_step_plain(acc, p, key, **KW))


def test_step_overlap_rejects_bad_input(inputs):
    accum, powers, key, _ = inputs
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    with pytest.raises(ValueError):          # exact only
        so.step_overlap(acc, p, torch.stack([key, key]), **KW)
    with pytest.raises(ValueError):
        so.step_overlap(acc, p[:-1], key, **KW)


def test_exp_overlap_on_cpu(capsys):
    """The tool in-process on the CPU at batch 4: the split equal to the
    serial step, host times only."""
    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import exp_overlap_torch as eo
    res = eo.run(4, "cpu", reps=1)
    assert res["exact"] and set(res) == {"exact", "serial", "split"}
    assert "host ms (CPU)" in capsys.readouterr().out
