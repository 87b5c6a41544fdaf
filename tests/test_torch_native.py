"""The port's host C++ transform and limb split (``nufhe_tpu_torch/
native.py``) bit for bit against its numpy oracle and the JAX package's
``native``; host keygen through it equal to the JAX package's; a compiler
that fails raises.  The tests that build the library skip where no C++
compiler is on the ``PATH`` (the port then runs the numpy oracle)."""

import shutil

import numpy as np
import pytest
import torch

from nufhe_tpu import keys as jkeys
from nufhe_tpu import native as jnative
from nufhe_tpu.params import NuFHEParameters as JParams
from nufhe_tpu.rng import DeterministicRNG as JRNG

import nufhe_tpu_torch as nft
from nufhe_tpu_torch import native
from nufhe_tpu_torch.ops import transform as tf
from nufhe_tpu_torch.ref import transform_ref as tr

LWE_SIZE = 8


@pytest.fixture
def compiler(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler on the PATH: the port uses numpy")
    assert native.available()


@pytest.fixture(scope="module")
def polys():
    return np.random.RandomState(11).randint(
        -2**31, 2**31, (64, 1024)).astype(np.int32)


def test_forward_u64(compiler, polys):
    got = native.forward_u64(polys.reshape(2, 32, 1024))
    assert got.dtype == np.uint64 and got.shape == (2, 32, 64, 32)
    want = tr.forward(polys).reshape(got.shape)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jnative.forward_u64(polys).reshape(got.shape))


@pytest.mark.parametrize("exact", [True, False])
def test_bootstrap_key_limbs(compiler, polys, exact):
    got = native.bootstrap_key_limbs(polys, exact)
    assert got.dtype == np.int8
    assert got.shape == (64, 64, 32, 5 if exact else 4, 2)
    assert np.array_equal(got, tf.key_limbs_host(tr.forward(polys),
                                                 exact=exact))
    assert np.array_equal(got, jnative.bootstrap_key_limbs(polys, exact))


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_host_keygen_goes_through_native(compiler, monkeypatch,
                                         transform_type):
    """``make_key_pair(on_device=False)``: its limbs and its rows key come
    from the library and equal the JAX package's host key."""
    calls = []
    for name in ("bootstrap_key_limbs", "forward_u64"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    torch.set_num_threads(1)
    _, cloud = nft.make_key_pair(nft.DeterministicRNG(31), on_device=False,
                                 lwe_size=LWE_SIZE,
                                 transform_type=transform_type)
    params = JParams(lwe_size=LWE_SIZE, transform_type=transform_type)
    jrng = JRNG(31)
    jsecret = jkeys.NuFHESecretKey.from_rng(params, jrng)
    jcloud = jkeys.NuFHECloudKey.from_rng(params, jrng, jsecret)
    bk = cloud.bootstrap_key
    assert np.array_equal(bk.bk_coeff, jcloud.bootstrap_key.bk_coeff)
    assert np.array_equal(bk.limbs(), jcloud.bootstrap_key.limbs())
    rows = bk.device("cpu")
    assert calls == ["bootstrap_key_limbs", "forward_u64"]
    assert torch.equal(rows, tf.rows_key_from_limbs(bk.limbs(), "cpu"))


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_failing_compiler_raises(monkeypatch, cxx):
    """A compiler that is named but fails (or is missing) raises with the
    command; nothing falls back to numpy."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=cxx):
        native.available()
    with pytest.raises(RuntimeError, match=cxx):
        native.forward_u64(np.zeros((1, 1024), np.int32))


def test_no_compiler_falls_back_to_numpy(monkeypatch, polys):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not native.available()
    assert np.array_equal(native.bootstrap_key_limbs(polys[:4]),
                          tf.key_limbs_host(tr.forward(polys[:4])))
