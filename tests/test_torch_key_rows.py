"""The blind rotation's key limb rows (the row kernel's plain version,
``ops/key_rows``): byte for byte the rows that the host limb oracle gives
under K1/K3's layout rule, in every kernel shape and both key forms;
prepared once with the key and cached in place of the int64 key, and only
for a CUDA key; the one form a device that ``key_form`` reads; and the CPU
path of the step and the chunked rotation unchanged by them, for any
(mask1, l)."""

import gc
import weakref

import numpy as np
import pytest
import torch

import nufhe_tpu_torch as nft
from nufhe_tpu_torch.ops import blind_rotate as brc
from nufhe_tpu_torch.ops import cmux, key_rows as kr, transform as ttf
from nufhe_tpu_torch.ref import transform_ref

TP = nft.NuFHEParameters().tgsw_params
KW = dict(offset=int(TP.offset), log2_base=TP.bs_log2_base)
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions at these sizes gain little from more threads;
    one leaves the cores to the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(seed, mask1, decomp_length, transform_type, steps=STEPS):
    """A random coefficient key's transform: the rows engine's key and the
    residues it came from, (steps, mask1, l, mask1, L, R) uint64."""
    rng = np.random.RandomState(seed)
    bk_coeff = rng.randint(-2**31, 2**31, (steps, mask1, decomp_length, mask1,
                                           ttf.N)).astype(np.int32)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    return key, transform_ref.forward(bk_coeff)


def _host_rows(hat, exact):
    """The rows by the host oracle (``ops/transform.key_limbs_host``) under
    K1/K3's layout rule: slot p holds frequency rev6(p); row (g, o, L) has
    limb L of side 0 at rotation r in byte 31 - r and that of side 1 in
    byte 63 - r; the exact rows are [vlo, vhi_0..3, 4*vlo]."""
    steps, mask1, decomp_length = hat.shape[:3]
    limbs = ttf.key_limbs_host(hat, exact=exact)       # (..., L, R, KL, 2)
    limbs = limbs.reshape((steps, mask1 * decomp_length, mask1, ttf.L,
                           ttf.R) + limbs.shape[-2:]).astype(np.int64)
    if exact:
        limbs = np.concatenate([limbs, 4 * limbs[..., :1, :]], axis=-2)
    sides = limbs[..., ::-1, :, :]                     # byte b: r = 31 - b
    rows = np.concatenate([sides[..., 0], sides[..., 1]], axis=-2)
    rows = np.moveaxis(rows, -1, -2)                   # (..., L, rows, 64)
    rows = rows[:, :, :, ttf.BITREV_L]                 # slot p: rev6(p)
    return np.moveaxis(rows, 3, 1).astype(np.int8)     # (n, L, G, O, rows, 64)


@pytest.mark.parametrize("shape", [(2, 2), (3, 2), (2, 3)])
@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_plain_rows_match_host_limbs(shape, transform_type):
    exact = transform_type == "NTT"
    key, hat = _key(31, *shape, transform_type)
    rows = kr.key_rows_plain(key, not exact)
    want = _host_rows(hat, exact)
    assert rows.dtype == torch.int8
    assert tuple(rows.shape) == kr.rows_shape(key, not exact) == want.shape
    assert np.array_equal(rows.numpy(), want)
    # slot-major: one slot's rows are G * O * rows * 64 contiguous bytes
    g_size, o_size = key.shape[-4:-2]
    assert rows[0, 1].numel() == g_size * o_size * (6 if exact else 4) * 64


def _nand_twice(secret, cloud, rng, device):
    """NAND(NAND(x, y), y) through ``VirtualMachine`` on ``device``,
    checked against its truth table."""
    vm = nft.VirtualMachine(cloud, device=device)
    bits = np.array([False, True, True])
    x, y = (nft.encrypt(rng, secret, v, device=device)
            for v in (bits, bits[::-1].copy()))
    out = vm.gate_nand(vm.gate_nand(x, y), y)
    assert np.array_equal(nft.decrypt(secret, out),
                          ~(~(bits & bits[::-1]) & bits[::-1]))


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_device_prepares_rows_once(transform_type, monkeypatch):
    """``BootstrapKey.device`` prepares the key once a device and caches
    the one form the preparation returns; the int64 key it was made from
    is released.  The preparation is a CUDA-free stand-in for the row
    kernel (the plain rows), counted."""
    rounded = transform_type == "FFT"
    calls, released = [], []

    def prepare(key, form):
        calls.append((key.device, form))
        weakref.finalize(key, released.append, key.dim())
        return kr.key_rows_plain(key, form)

    monkeypatch.setattr(kr, "prepare", prepare)
    rng = nft.DeterministicRNG(5)
    _, cloud = nft.make_key_pair(rng, on_device=False, lwe_size=8,
                                 transform_type=transform_type)
    bk = cloud.bootstrap_key
    rows = bk.device("cpu")
    assert bk.device("cpu") is rows and bk.device("cpu") is rows
    assert calls == [(torch.device("cpu"), rounded)]
    gc.collect()
    assert released == [6 if rounded else 5]      # no int64 copy is kept
    key = ttf.bootstrap_key_transformed(bk.bk_coeff, "cpu", transform_type)
    assert torch.equal(rows, kr.key_rows_plain(key, rounded))


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_cpu_key_has_no_rows(transform_type, monkeypatch):
    """On the CPU the key is the int64 key: its preparation returns it as
    it is, the rotation runs the plain steps on it, and neither key
    preparation nor the gates launch the row kernel or prepare again."""
    calls = []
    real = kr.prepare
    monkeypatch.setattr(kr, "prepare", lambda key, form: calls.append(form)
                        or real(key, form))
    rng = nft.DeterministicRNG(6)
    secret, cloud = nft.make_key_pair(rng, on_device=False, lwe_size=8,
                                      transform_type=transform_type)
    kr.rows_prepared = 0
    bk = cloud.bootstrap_key
    key = bk.device("cpu")
    assert torch.equal(key, ttf.bootstrap_key_transformed(
        bk.bk_coeff, "cpu", transform_type))
    assert kr.key_form(key, (8,), "t") == (transform_type == "FFT", 2, 2)
    _nand_twice(secret, cloud, rng, "cpu")
    assert calls == [transform_type == "FFT"] and kr.rows_prepared == 0


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_chunk_cpu_path_unchanged(transform_type):
    """On CPU tensors the chunked rotation is the plain steps on the int64
    key: no launch, no preparation; the rows are not the CPU's form."""
    rounded = transform_type == "FFT"
    key, _ = _key(7, 2, 2, transform_type, steps=3)
    rng = np.random.RandomState(8)
    acc = torch.from_numpy(rng.randint(-2**31, 2**31, (5, 2, ttf.N))
                           .astype(np.int32))
    bara_t = torch.from_numpy(rng.randint(0, 2 * ttf.N, (3, 5))
                              .astype(np.int32))
    want = acc
    for step in range(1, 3):
        want = cmux.cmux_step_plain(want, bara_t[step], key[step], **KW)
    counts = (brc.launches, cmux.launches, kr.rows_prepared)
    assert torch.equal(brc.blind_rotate_chunk(acc, bara_t, key, 1, 2, **KW),
                       want)
    with pytest.raises(TypeError):
        brc.blind_rotate_chunk(acc, bara_t, kr.key_rows_plain(key, rounded),
                               1, 2, **KW)
    assert (brc.launches, cmux.launches, kr.rows_prepared) == counts


def test_key_form():
    """The one reader of the rows engine's key form: the int64 key on the
    CPU, whole or a step's row, of any (mask1, l); and the rows, checked
    here on the CPU by the reader's rows branch.  Every other tensor is
    refused: no rows, rows of another shape, type, layout or key, a lanes
    operand, and rows of a (mask1, l) that no kernel instantiates."""
    key, _ = _key(3, 2, 2, "NTT", steps=4)
    rkey, _ = _key(4, 2, 3, "FFT", steps=4)
    wide = torch.zeros((8, 2, ttf.L, ttf.R), dtype=torch.int64)
    rows = kr.key_rows(key, False)
    lanes = torch.zeros((4, ttf.L, 256, 320), dtype=torch.int8)
    assert kr.key_form(key, (4,), "t", 2) == (False, 2, 2)
    assert kr.key_form(rkey[1], (), "t") == (True, 2, 3)
    assert kr.key_form(wide, (), "t") == (False, 2, 4)
    for bad, error in ((rows, TypeError), (key[1:], ValueError),
                       (key[:, :3], ValueError), (lanes, TypeError)):
        with pytest.raises(error):
            kr.key_form(bad, (4,), "t", 2)
    with pytest.raises(ValueError):
        kr.key_form(key.to("meta"), (4,), "t")

    def read_rows(x, lead, mask1=None):
        return kr._read_form(x, lead, "t", mask1, True)

    assert read_rows(rows, (4,), 2) == (False, 2, 2)
    assert read_rows(rows[2], (), 2) == (False, 2, 2)
    assert read_rows(kr.key_rows(rkey, True)[1], ()) == (True, 2, 3)
    with pytest.raises(ValueError, match=r"\(2, 4\)"):
        read_rows(kr.key_rows(wide, False), ())
    buf = torch.zeros(rows.numel() + 1, dtype=torch.int8)
    for bad, error in ((key, TypeError), (rows.to(torch.int16), TypeError),
                       (rows[1:], ValueError), (rows[..., :4, :], ValueError),
                       (rows[0, :, :2], ValueError), (lanes, ValueError),
                       (kr.key_rows(_key(5, 3, 2, "NTT", steps=4)[0], False),
                        ValueError),
                       (buf[1:].view(rows.shape), ValueError)):
        with pytest.raises(error):
            read_rows(bad, (4,), 2)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_cpu_path_takes_any_pair(transform_type):
    """On the CPU the step and the chunked rotation take a (mask1, l) that
    no kernel instantiates, (2, 4) here, and run the plain steps."""
    key, _ = _key(9, 2, 4, transform_type, steps=3)
    rng = np.random.RandomState(10)
    acc = torch.from_numpy(rng.randint(-2**31, 2**31, (3, 2, ttf.N))
                           .astype(np.int32))
    bara_t = torch.from_numpy(rng.randint(0, 2 * ttf.N, (3, 3))
                              .astype(np.int32))
    want = acc
    for step in range(3):
        want = cmux.cmux_step_plain(want, bara_t[step], key[step], **KW)
    counts = (brc.launches, cmux.launches)
    assert torch.equal(brc.blind_rotate_chunk(acc, bara_t, key, 0, 3, **KW),
                       want)
    assert torch.equal(cmux.cmux_step(acc, bara_t[0], key[0], **KW),
                       cmux.cmux_step_plain(acc, bara_t[0], key[0], **KW))
    assert (brc.launches, cmux.launches) == counts
