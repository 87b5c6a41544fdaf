"""The port's encrypted-integer circuits against the JAX package's, on the
CPU: the bit-array helpers and the ripple / Kogge-Stone rule agree, and at
width 4 on 3 integers every circuit gives the JAX package's ciphertexts
(``a``, ``b`` exact, ``cv`` at rtol 1e-6) through ``VirtualMachine``, and
decrypts to numpy's answer.  The LWE size is reduced (16 blind-rotation
steps) as in the JAX package's own integer tests; the port's keys are the
JAX package's, carried across in its containers.
"""

import numpy as np
import pytest
import torch

import nufhe_tpu as jnf
from nufhe_tpu.models import integer as jint

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.models import integer as tint

LWE_SIZE = 16
WIDTH = 4
SEED = 808


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain path at these sizes gains little from more threads;
    one leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bit_helpers_match_jax():
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (2, 3)).astype(np.uint8)
    u16 = rng.randint(0, 2**16, 5).astype(np.uint16)
    i8 = rng.randint(-128, 128, (4,)).astype(np.int8)
    for xs, width in ((u8, None), (u8, 5), (u16, None), (u16, 12)):
        bits = tint.uintarray_to_bitarray(xs, width)
        assert np.array_equal(bits, jint.uintarray_to_bitarray(xs, width))
        assert np.array_equal(tint.bitarray_to_uintarray(bits),
                              jint.bitarray_to_uintarray(bits))
    for xs, width in ((i8, None), (i8, 4)):
        bits = tint.intarray_to_bitarray(xs, width)
        assert np.array_equal(bits, jint.intarray_to_bitarray(xs, width))
        assert np.array_equal(tint.bitarray_to_intarray(bits),
                              jint.bitarray_to_intarray(bits))
    with pytest.raises(ValueError):
        tint.bitarray_to_uintarray(np.zeros((2, 65), bool))


def test_auto_parallel_matches_jax():
    for batch in (1, 2, 3, 4, 7, 8, 16, 63, 64, 65, 128, 1024):
        for width in (1, 2, 4, 8, 16, 32):
            assert (tint._auto_parallel(batch, width)
                    == jint._auto_parallel(batch, width)), (batch, width)


@pytest.fixture(scope="module")
def machines():
    """{mode: (JAX secret key, JAX machine, port machine on the CPU)}."""
    out = {}
    for mode in ("NTT", "FFT"):
        js, jc = jnf.make_key_pair(jnf.DeterministicRNG(SEED), on_device=False,
                                   lwe_size=LWE_SIZE, transform_type=mode)
        tc = tnf.NuFHECloudKey.loads(jc.dumps())
        out[mode] = (js, jnf.VirtualMachine(jc),
                     tnf.VirtualMachine(tc, device='cpu'))
    return out


# name: (circuit, signed operands, parallel, numpy's answer)
CIRCUITS = {
    'uint_add ripple': ('uint_add', False, False, lambda a, b: a + b),
    'uint_add kogge-stone': ('uint_add', False, True, lambda a, b: a + b),
    'uint_sub ripple': ('uint_sub', False, False, lambda a, b: a - b),
    'uint_sub kogge-stone': ('uint_sub', False, True, lambda a, b: a - b),
    'uint_mul': ('uint_mul', False, None, lambda a, b: a * b),
    'uint_gt': ('uint_gt', False, None, lambda a, b: a > b),
    'uint_lt': ('uint_lt', False, None, lambda a, b: a < b),
    'uint_eq': ('uint_eq', False, None, lambda a, b: a == b),
    'uint_min': ('uint_min', False, None, np.minimum),
    'uint_max': ('uint_max', False, None, np.maximum),
    'int_add': ('int_add', True, None, lambda a, b: a + b),
    'int_gt': ('int_gt', True, None, lambda a, b: a > b),
    'int_neg': ('int_neg', True, None, lambda a, b: -a),
    # ripple, the form the auto rule picks for the card's 256 x 8 divisions
    # (``chip_smoke.py``), and the fewest gate calls on the CPU
    'uint_divmod': ('uint_divmod', False, False, None),
}


def _operands(signed):
    rng = np.random.RandomState(9)
    if signed:
        return (rng.randint(-8, 8, 3).astype(np.int64),
                np.array([-8, 5, 3], np.int64))
    # the divisors include 0: quotient 2^w - 1 and remainder a
    return (rng.randint(0, 16, 3).astype(np.int64),
            np.array([0, 3, 7], np.int64))


def _bits(x, signed):
    return (jint.intarray_to_bitarray(x.astype(np.int8), WIDTH) if signed
            else jint.uintarray_to_bitarray(x.astype(np.uint8), WIDTH))


def _ints(bits, signed):
    return (jint.bitarray_to_intarray(bits) if signed
            else jint.bitarray_to_uintarray(bits)).astype(np.int64)


def _wrap(x, signed):
    x = np.asarray(x, np.int64) % 2**WIDTH
    return np.where(x >= 2**(WIDTH - 1), x - 2**WIDTH, x) if signed else x


def assert_same(jct, tct):
    assert np.array_equal(tct.a.numpy(), np.asarray(jct.a))
    assert np.array_equal(tct.b.numpy(), np.asarray(jct.b))
    np.testing.assert_allclose(tct.current_variances.numpy(),
                               np.asarray(jct.current_variances), rtol=1e-6)


def _run(machines, mode, name, signed, parallel):
    js, jvm, tvm = machines[mode]
    a, b = _operands(signed)
    rng = jnf.DeterministicRNG(10)
    ja, jb = (jnf.encrypt(rng, js, _bits(x, signed)) for x in (a, b))
    ta, tb = (tnf.LweSampleArray.loads(c.dumps(), 'cpu') for c in (ja, jb))
    args = ((ja,), (ta,)) if name == 'int_neg' else ((ja, jb), (ta, tb))
    kw = {} if parallel is None else dict(parallel=parallel)
    jout = getattr(jvm, name)(*args[0], **kw)
    tout = getattr(tvm, name)(*args[1], **kw)
    return js, a, b, jout, tout


@pytest.mark.parametrize("label", sorted(CIRCUITS))
def test_circuit_matches_jax(machines, label):
    name, signed, parallel, answer = CIRCUITS[label]
    js, a, b, jout, tout = _run(machines, "NTT", name, signed, parallel)
    if name == 'uint_divmod':
        for j, t in zip(jout, tout):
            assert_same(j, t)
        q, r = (_ints(jnf.decrypt(js, j), False) for j in jout)
        nz = np.maximum(b, 1)
        assert np.array_equal(q, np.where(b == 0, 2**WIDTH - 1, a // nz))
        assert np.array_equal(r, np.where(b == 0, a, a % nz))
        return
    assert_same(jout, tout)
    got = jnf.decrypt(js, jout)
    if tout.shape[-1] == 1:                   # a comparison: one bit
        assert np.array_equal(got[..., 0], answer(a, b))
    else:
        assert np.array_equal(_ints(got, signed), _wrap(answer(a, b), signed))


def test_uint_min_fft_matches_jax(machines):
    """The rounded-key engine's noise over a chain of bootstraps."""
    js, a, b, jout, tout = _run(machines, "FFT", 'uint_min', False, False)
    assert_same(jout, tout)
    assert np.array_equal(_ints(jnf.decrypt(js, jout), False), np.minimum(a, b))
