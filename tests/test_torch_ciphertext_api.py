"""The port's ciphertext views and user API against the JAX package, on the
CPU: indexing, assignment, ``copy``, ``broadcast_to``, ``roll`` and
``concatenate`` give the JAX package's arrays on the same inputs (``a``,
``b`` exact, ``cv`` at rtol 1e-6); no aliasing between a ciphertext and
its views can be observed; ``find_devices``, ``DeviceID`` and ``Context``
on the CPU, and raising without CUDA; the ``VirtualMachine``'s integer
result shapes; and the JAX package's public names.
"""

import io
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import nufhe_tpu as jnf
from nufhe_tpu.ciphertext import LweSampleArray as JArray

import nufhe_tpu_torch as tnf
from nufhe_tpu_torch.ciphertext import LweSampleArray as TArray

LWE_SIZE = 16
SHAPE = (3, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain path at these sizes gains little from more threads;
    one leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    a = rng.randint(-2**31, 2**31, shape + (LWE_SIZE,)).astype(np.int32)
    b = rng.randint(-2**31, 2**31, shape).astype(np.int32)
    cv = rng.uniform(0, 1e-3, shape).astype(np.float32)
    return a, b, cv


def _pair(seed, shape=SHAPE):
    """The same arrays as a JAX and a port ciphertext."""
    a, b, cv = _arrays(seed, shape)
    jparams = jnf.NuFHEParameters(lwe_size=LWE_SIZE).in_out_params
    tparams = tnf.NuFHEParameters(lwe_size=LWE_SIZE).in_out_params
    return (JArray(jparams, jnp.asarray(a), jnp.asarray(b), jnp.asarray(cv)),
            TArray(tparams, torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(cv)))


def assert_same(j, t, what=""):
    assert t.shape == tuple(j.shape), what
    assert np.array_equal(t.a.numpy(), np.asarray(j.a)), what
    assert np.array_equal(t.b.numpy(), np.asarray(j.b)), what
    np.testing.assert_allclose(t.current_variances.numpy(),
                               np.asarray(j.current_variances), rtol=1e-6,
                               err_msg=what)


INDICES = {
    "int": 1,
    "int pair": (2, 3),
    "ellipsis last": (..., 1),
    "ellipsis slice": (..., slice(1, 3)),
    "ellipsis first": (1, ...),
    "negative step": (slice(None), slice(None, None, -1)),
    "negative step 2": (slice(None, None, -2), ...),
    "broadcast arrays": (np.array([[0], [2]]), np.array([3, 0, 1])),
    "int array": np.array([2, 0, 2]),
    "bool mask": np.array([True, False, True]),
    "new axis": (None, ..., 0),
}


def test_getitem_matches_jax():
    j, t = _pair(1)
    for name, index in INDICES.items():
        assert_same(j[index], t[index], name)


def test_setitem_matches_jax():
    for name in ("int", "ellipsis slice", "negative step", "broadcast arrays",
                 "bool mask"):
        index = INDICES[name]
        j, t = _pair(2)
        target = j[index].shape
        jv, tv = _pair(3, tuple(target))
        j[index] = jv
        t[index] = tv
        assert_same(j, t, name)
        # a value that broadcasts over the selection
        jw, tw = _pair(4, tuple(target[-1:]))
        j[index] = jw
        t[index] = tw
        assert_same(j, t, name + ", broadcast value")


def test_copy_broadcast_roll_match_jax():
    j, t = _pair(5, (1, 4))
    assert_same(j.copy(), t.copy())
    assert_same(j.broadcast_to((3, 4)), t.broadcast_to((3, 4)))
    for shift, axis in ((1, -1), (-2, 1), (1, 0)):
        jb, tb = j.broadcast_to((3, 4)), t.broadcast_to((3, 4))
        jb.roll(shift, axis=axis)
        tb.roll(shift, axis=axis)
        assert_same(jb, tb)
    assert t == t.copy() and not t == t[..., ::-1]


@pytest.mark.parametrize("axis", [0, 1])
def test_concatenate_matches_jax(axis):
    (j1, t1), (j2, t2) = _pair(6), _pair(7)
    assert_same(jnf.concatenate([j1, j2, j1], axis=axis),
                tnf.concatenate([t1, t2, t1], axis=axis))
    jout, tout = _pair(8)
    assert jnf.concatenate([j2, j1], axis=axis, out=jout) is jout
    assert tnf.concatenate([t2, t1], axis=axis, out=tout) is tout
    assert_same(jout, tout)


def test_concatenate_negative_axis_raises():
    _, t = _pair(9)
    with pytest.raises(ValueError, match="axis=-1"):
        tnf.concatenate([t, t], axis=-1)
    with pytest.raises(ValueError):
        tnf.concatenate([], axis=0)


def test_views_do_not_alias():
    _, t = _pair(10)
    b0 = t.b.clone()
    view = t[..., 1:3]
    t[..., 1:3] = t[..., 0:2]             # the source is assigned into
    assert torch.equal(view.b, b0[:, 1:3])
    _, t = _pair(10)
    view = t[1]
    view[...] = t[0]                      # the view is assigned into
    assert torch.equal(t.b, b0)
    assert torch.equal(view.b, b0[0])
    # a broadcast view shares its source's storage; assigning into it
    # copies first, so the source and the other rows stay as they were
    src = t[0:1]
    wide = src.broadcast_to((3, 4))
    wide[1] = t[2]
    assert torch.equal(src.b, b0[0:1])
    assert torch.equal(wide.b[0], b0[0]) and torch.equal(wide.b[2], b0[0])
    assert torch.equal(wide.b[1], b0[2])
    wide.roll(1, axis=0)
    assert torch.equal(src.b, b0[0:1])
    # a copy is independent of its source
    c = t.copy()
    c[0] = t[1]
    assert torch.equal(t.b, b0)


@pytest.fixture(scope="module")
def cpu_context():
    ctx = tnf.Context(rng=tnf.DeterministicRNG(12), api='cpu')
    secret, cloud = ctx.make_key_pair(lwe_size=LWE_SIZE)
    return ctx, secret, cloud


def test_find_devices_and_context_on_the_cpu(cpu_context):
    devices = tnf.find_devices(api='cpu')
    assert [d.platform for d in devices] == ['cpu']
    assert devices[0].get_device() == torch.device('cpu')
    assert devices[0].api_name == 'CPU' and 'cpu' in str(devices[0])
    with pytest.raises(ValueError):
        tnf.find_devices(api='cpu', include_devices=['no such device'])

    ctx, secret, cloud = cpu_context
    assert ctx.device == torch.device('cpu')
    x = np.array([False, False, True, True])
    y = np.array([False, True, False, True])
    cx, cy = ctx.encrypt(secret, x), ctx.encrypt(secret, y)
    assert cx.device == torch.device('cpu')
    vm = ctx.make_virtual_machine(cloud)
    out = vm.gate_nand(cx, cy)
    assert np.array_equal(ctx.decrypt(secret, out), ~(x & y))
    # containers through the context's load methods, onto its device
    data = out.dumps()
    assert ctx.load_ciphertext(data) == out
    assert ctx.load_ciphertext(io.BytesIO(data)) == out
    assert vm.load_ciphertext(io.BytesIO(data)) == out
    assert ctx.load_secret_key(secret.dumps()) == secret
    assert ctx.load_cloud_key(io.BytesIO(cloud.dumps())) == cloud


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError):
        tnf.find_devices()
    with pytest.raises(ValueError):
        tnf.Context()
    with pytest.raises(ValueError):
        tnf.DeviceID('cuda', 0).get_device()
    with pytest.raises(RuntimeError):
        tnf.LweSampleArray.loads(_pair(13)[1].dumps())


def test_vm_integer_result_shapes(cpu_context):
    """Result shapes, with an operand broadcast, and the answers."""
    ctx, secret, cloud = cpu_context
    vm = ctx.make_virtual_machine(cloud)
    av = np.array([[3], [2]], np.uint8)                 # (2, 1) integers
    bv = np.array([1, 2], np.uint8)                      # (2,) integers
    ca = ctx.encrypt(secret, tnf.uintarray_to_bitarray(av, 2))
    cb = ctx.encrypt(secret, tnf.uintarray_to_bitarray(bv, 2))

    def ints(c):
        return tnf.bitarray_to_uintarray(ctx.decrypt(secret, c))

    s = vm.uint_add(ca, cb)
    assert s.shape == (2, 2, 2)
    assert np.array_equal(ints(s), (av + bv) % 4)
    gt = vm.uint_gt(ca, cb)
    assert gt.shape == (2, 2, 1)
    assert np.array_equal(ctx.decrypt(secret, gt)[..., 0], av > bv)
    q, r = vm.uint_divmod(ca, cb, parallel=False)
    assert q.shape == r.shape == (2, 2, 2)
    assert np.array_equal(ints(q), av // bv)
    assert np.array_equal(ints(r), av % bv)
    with pytest.raises(AttributeError):
        vm.uint_nonesuch


def test_public_names_of_the_jax_package_exist():
    def public(m):
        return {n for n in dir(m) if not n.startswith('_')
                and not isinstance(getattr(m, n), types.ModuleType)}
    assert public(jnf) - public(tnf) == set()
    tnf.clear_computation_cache()
