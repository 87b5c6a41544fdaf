"""The blind rotation's key limb rows (the row kernel's plain version,
``ops/key_rows``): byte for byte the rows that the host limb oracle gives
under K1/K3's layout rule, in every kernel shape and both key forms;
prepared once with the key and cached, and only for a CUDA key; required
by every launch; and the CPU path of the chunked rotation unchanged by
them."""

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
    """``BootstrapKey.device`` prepares the rows with the key, once a
    device, and caches both; gate calls after it prepare none.  The
    preparation is a CUDA-free stand-in for the row kernel, counted."""
    calls = []

    def prepare(key, rounded):
        calls.append(key.device)
        return kr.key_rows_plain(key, rounded)

    monkeypatch.setattr(kr, "prepare", prepare)
    rng = nft.DeterministicRNG(5)
    secret, cloud = nft.make_key_pair(rng, on_device=False, lwe_size=8,
                                      transform_type=transform_type)
    bk = cloud.bootstrap_key
    key = bk.device("cpu")
    rows = bk.rows("cpu")
    assert bk.device("cpu") is key and bk.rows("cpu") is rows
    assert calls == [torch.device("cpu")]
    assert torch.equal(rows, kr.key_rows_plain(key, transform_type == "FFT"))
    _nand_twice(secret, cloud, rng, "cpu")
    assert len(calls) == 1


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_cpu_key_has_no_rows(transform_type):
    """Off CUDA the key has no rows: the rotation runs the plain steps on
    the int64 key, so neither key preparation nor the gates launch the
    row kernel."""
    rng = nft.DeterministicRNG(6)
    secret, cloud = nft.make_key_pair(rng, on_device=False, lwe_size=8,
                                      transform_type=transform_type)
    kr.rows_prepared = 0
    assert cloud.bootstrap_key.rows("cpu") is None
    assert kr.prepare(cloud.bootstrap_key.device("cpu"),
                      transform_type == "FFT") is None
    _nand_twice(secret, cloud, rng, "cpu")
    assert kr.rows_prepared == 0


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_chunk_cpu_path_unchanged(transform_type):
    """On CPU tensors the chunked rotation is the plain steps, with the
    prepared rows or without: no launch, no preparation."""
    rounded = transform_type == "FFT"
    key, _ = _key(7, 2, 2, transform_type, steps=3)
    rng = np.random.RandomState(8)
    acc = torch.from_numpy(rng.randint(-2**31, 2**31, (5, 2, ttf.N))
                           .astype(np.int32))
    bara_t = torch.from_numpy(rng.randint(0, 2 * ttf.N, (3, 5))
                              .astype(np.int32))
    rows = kr.key_rows_plain(key, rounded)
    want = acc
    for step in range(1, 3):
        want = cmux.cmux_step_plain(want, bara_t[step], key[step], **KW)
    counts = (brc.launches, cmux.launches, kr.rows_prepared)
    assert torch.equal(brc.blind_rotate_chunk(acc, bara_t, key, 1, 2, **KW),
                       want)
    assert torch.equal(brc.blind_rotate_chunk(acc, bara_t, key, 1, 2,
                                              rows=rows, **KW), want)
    assert (brc.launches, cmux.launches, kr.rows_prepared) == counts


def test_launch_rows():
    """A launch reads the prepared rows of its own steps; no rows, or rows
    of another shape, type or key, are refused."""
    key, _ = _key(3, 2, 2, "NTT", steps=4)
    rows = kr.key_rows(key, False)
    assert torch.equal(rows, kr.key_rows_plain(key, False))
    assert torch.equal(kr.launch_rows(key, False, rows, 1, 2, "t"), rows[1:3])
    assert torch.equal(kr.launch_rows(key[2], False, rows[2], None, 1, "t"),
                       rows[2])
    for bad in (None, rows[1:], rows.to(torch.int16), rows[..., :4, :]):
        with pytest.raises(ValueError):
            kr.launch_rows(key, False, bad, 0, 1, "t")
    with pytest.raises(ValueError):
        kr.launch_rows(key[0], False, rows[0, :, :2], None, 1, "t")
