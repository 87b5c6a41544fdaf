"""The plain reference against the port's CPU path and its own oracles.

The port's numpy oracles (``nufhe_tpu_torch/ref``) and its CPU gates are
witnesses here only; the reference itself imports nothing of the program.
"""

import numpy as np
import pytest
import torch

import nufhe_tpu_torch as nft
from nufhe_tpu_torch.ref import tgsw_ref, transform_ref
from benchmark.lib import data, manifest, program
from benchmark.reference import tfhe
from benchmark.tests.conftest import small_cell

MODES = ("NTT", "FFT")
N, L = 1024, 64      # the cells' degree and its transform length


def test_transform_matrices_against_the_nussbaumer_oracle():
    rs = np.random.RandomState(0)
    a = rs.randint(-2**31, 2**31, (3, N)).astype(np.int64)
    got = (torch.from_numpy(a).double() @ tfhe.forward_matrix(N, "cpu"))
    want = transform_ref.forward(a).view(np.int64).reshape(3, -1)
    assert np.array_equal(got.round().long().numpy(), want)
    c = rs.randint(-2**40, 2**40, (2, L, tfhe.R)).astype(np.int64)
    got = torch.from_numpy(c.reshape(2, -1)).double() @ \
        tfhe.inverse_matrix(N, "cpu")
    want = transform_ref.inverse_unscaled(c.astype(np.uint64)).view(np.int64)
    assert np.array_equal(got.round().long().numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_external_product_against_the_oracles(mode):
    rs = np.random.RandomState(1)
    params = nft.NuFHEParameters(transform_type=mode, lwe_size=3).tgsw_params
    bk = rs.randint(-2**31, 2**31, (3, 2, 2, 2, N)).astype(np.int32)
    acc = rs.randint(-2**31, 2**31, (5, 2, N)).astype(np.int32)
    oracle = tgsw_ref.tgsw_external_mul if mode == "NTT" \
        else tgsw_ref.tgsw_external_mul_rounded
    key = tfhe.prepare_bootstrap_key(torch.from_numpy(bk), mode == "NTT")
    digits = tfhe.decompose(torch.from_numpy(acc).long(), int(params.offset),
                            2, 10)
    got = tfhe.external_product(digits, key[1], mode == "NTT")
    assert np.array_equal(got.numpy(), oracle(acc, bk, 1, params))


def test_the_exact_mode_is_the_schoolbook_product():
    """Digit polynomials times key polynomials, summed, against the
    product term by term: the exact engine needs no oracle of the port."""
    g = torch.Generator().manual_seed(2)
    bk = torch.randint(-2**31, 2**31, (1, 1, 1, 2, N), generator=g)
    digits = torch.randint(-512, 512, (3, 1, N), generator=g)
    key = tfhe.prepare_bootstrap_key(bk, exact=True)
    got = tfhe.external_product(digits, key[0], exact=True)
    for s in range(3):
        for o in range(2):
            want = tfhe.schoolbook(digits[s, 0], bk[0, 0, 0, o])
            assert torch.equal(got[s, o], want)


def _both_sides(mode, seed, lwe_size=6):
    cell = small_cell("ntt.nand_b16384", lwe_size=lwe_size)
    cfg = dict(cell.cfg, transform_type=mode)
    g = data.generator(seed, "cpu", 0)
    secret = data.Secret(cfg, g)
    raw = data.make_raw_cloud_key(cfg, secret, g)
    prog = program.Program(cfg, raw, "cpu")
    keys = tfhe.Keys(cfg, raw["bk_coeff"], raw["ks_a"], raw["ks_b"])
    return cfg, secret, prog, keys, g


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gate", ["nand", "xor", "andyn", "mux"])
def test_gates_equal_the_port_word_for_word(mode, gate):
    _, secret, prog, keys, g = _both_sides(mode, 2**32 + 3)
    bits = [torch.randint(0, 2, (12,), generator=g).bool() for _ in range(3)]
    enc = [data.encrypt(secret, b, g) for b in bits]
    vm = prog.virtual_machine()
    cts = [prog.ciphertext(*e) for e in enc]
    if gate == "mux":
        out = vm.gate_mux(*cts)
        ref = tfhe.gate_mux(keys, *enc)
        truth = torch.where(bits[0], bits[1], bits[2])
    else:
        out = getattr(vm, "gate_" + gate)(cts[0], cts[1])
        ref = tfhe.gate2(keys, gate, enc[0], enc[1])
        chain = manifest.load_module("clients", "gate_chain")
        truth = chain.plain_gate(gate, bits[0], None, bits[1])
    assert torch.equal(out.a.long(), ref[0])
    assert torch.equal(out.b.long(), ref[1])
    assert torch.equal(data.decrypt(secret, *ref), truth)


def test_keyswitch_key_digit_zero_and_decryption():
    cfg, secret, _, keys, g = _both_sides("NTT", 11)
    assert not keys.ks[:, :, 0].any()
    # an extracted-key sample keyswitched to s decrypts to its bit
    bits = torch.randint(0, 2, (20,), generator=g).bool()
    z = secret.z.reshape(-1)
    a = torch.randint(-2**31, 2**31, (20, z.shape[0]), generator=g)
    b = tfhe.wrap32(torch.where(bits, tfhe.MU, -tfhe.MU) + (a * z).sum(-1))
    out = tfhe.keyswitch(keys, a, b)
    assert torch.equal(data.decrypt(secret, *out), bits)


def test_integer_add_equals_the_port():
    cfg, secret, prog, keys, g = _both_sides("NTT", 5, lwe_size=4)
    w = 4
    xs = torch.randint(0, 2**w, (2,), generator=g)
    ys = torch.randint(0, 2**w, (2,), generator=g)
    shifts = torch.arange(w - 1, -1, -1)
    x = data.encrypt(secret, ((xs[:, None] >> shifts) & 1).bool(), g)
    y = data.encrypt(secret, ((ys[:, None] >> shifts) & 1).bool(), g)
    out = prog.virtual_machine().uint_add(prog.ciphertext(*x),
                                          prog.ciphertext(*y), parallel=True)
    ref = manifest.load_module("reference/ops",
                               "uint_add_kogge_stone").circuit(keys, x, y)
    assert torch.equal(out.a.long(), ref[0])
    assert torch.equal(out.b.long(), ref[1])
    value = (data.decrypt(secret, *ref).long() << shifts).sum(-1)
    assert torch.equal(value, (xs + ys) % 2**w)


def _forward_1024(device):
    """The forward matrix at N = 1024 as the reference built it before it
    took N from its tensors (M = R = 32, L = 64, root Y): the witness that
    the general construction leaves the cells' transform as it was."""
    i = torch.arange(32).view(32, 1, 1)
    j = torch.arange(32).view(1, 32, 1)
    t = torch.arange(64).view(1, 1, 64)
    e = (i + j * t) % 64
    sign = torch.where(e < 32, 1, -1)
    rows = (i * 32 + j).expand(32, 32, 64).reshape(-1)
    cols = (t * 32 + e % 32).reshape(-1)
    f = torch.zeros(1024, 64 * 32, dtype=torch.float64)
    f[rows, cols] = sign.reshape(-1).double()
    return f.to(device)


def _inverse_1024(device):
    t = torch.arange(64).view(64, 1, 1)
    k = torch.arange(32).view(1, 32, 1)
    j = torch.arange(32).view(1, 1, 32)
    inv = torch.zeros(64 * 32, 1024, dtype=torch.float64)
    for e in ((k - j * t) % 64, (k + 1 - (j + 32) * t) % 64):
        sign = torch.where(e < 32, 1, -1)
        rows = (t * 32 + k).expand(64, 32, 32).reshape(-1)
        cols = ((e % 32) * 32 + j).reshape(-1)
        inv.index_put_((rows, cols), sign.reshape(-1).double(),
                       accumulate=True)
    return inv.to(device)


def test_the_cells_transform_is_the_one_it_was():
    assert torch.equal(tfhe.forward_matrix(1024, "cpu"), _forward_1024("cpu"))
    assert torch.equal(tfhe.inverse_matrix(1024, "cpu"), _inverse_1024("cpu"))
    assert tfhe.transform_shape(1024) == (32, 64, 6)
    assert tfhe.forward_matrix(512, "cpu").shape == (512, 32 * 32)
    assert tfhe.transform_shape(256) == (8, 16, 4)
    for n in (128, 768, 2048):
        with pytest.raises(ValueError, match="N = %d" % n):
            tfhe.transform_shape(n)


@pytest.mark.parametrize("log2_base", [6, 7, 10])
@pytest.mark.parametrize("k, l", [(1, 2), (1, 3), (2, 2), (2, 3)])
@pytest.mark.parametrize("n", [256, 512, 1024])
def test_the_exact_product_is_the_schoolbook_product_at_every_degree(
        n, k, l, log2_base):
    """sum_g digits_g * key[g, o] against the product term by term, with
    one sample of the most negative digits and one of the largest; the
    float64 sums of the limb products stay below 2^53 at every shape
    here (at most (k+1) l R 2^27 < 2^36)."""
    g = torch.Generator().manual_seed(n + 10 * k + l + 1000 * log2_base)
    half = 1 << (log2_base - 1)
    # a transformed digit is at most M half; a key limb is below 2^13
    assert (k + 1) * l * tfhe.R * (n // tfhe.R * half) * 2**13 < 2**53
    bk = torch.randint(-2**31, 2**31, (1, k + 1, l, k + 1, n), generator=g)
    digits = torch.randint(-half, half, (3, (k + 1) * l, n), generator=g)
    digits[1] = -half
    digits[2] = half - 1
    key = tfhe.prepare_bootstrap_key(bk, exact=True)
    got = tfhe.external_product(digits, key[0], exact=True)
    rows = bk[0].reshape((k + 1) * l, k + 1, n)
    for s in range(3):
        for o in range(k + 1):
            want = tfhe.wrap32(sum(tfhe.schoolbook(digits[s, r], rows[r, o])
                                   for r in range((k + 1) * l)))
            assert torch.equal(got[s, o], want), (s, o)


def test_the_rounded_key_is_defined_at_1024_alone():
    g = torch.Generator().manual_seed(3)
    bk = torch.randint(-2**31, 2**31, (1, 3, 3, 3, 512), generator=g)
    with pytest.raises(ValueError, match="N = 512"):
        tfhe.prepare_bootstrap_key(bk, exact=False)
    key = tfhe.prepare_bootstrap_key(bk, exact=True)
    digits = torch.zeros((2, 9, 512), dtype=torch.int64)
    with pytest.raises(ValueError, match="N = 512"):
        tfhe.external_product(digits, key[0], exact=False)
    with pytest.raises(ValueError, match="N = 512"):
        tfhe.Keys({"transform_type": "FFT", "bs_decomp_length": 3,
                   "bs_log2_base": 6}, bk, torch.zeros((1024, 4, 8, 4)),
                  torch.zeros((1024, 4, 8)))


# tfhe-rs's boolean DEFAULT_PARAMETERS (tfhe/src/boolean/parameters/mod.rs):
# N = 512, k = 2, bootstrap l = 3 at base 2^6, keyswitch 4 levels at base
# 2^3, and its two standard deviations; n = 722 there, cut to 16 here so
# that the CPU runs the rotation in seconds.  No configuration file of the
# benchmark holds this set yet: the test shows the reference takes it.
TFHE_RS_DEFAULT = {
    "transform_type": "NTT", "lwe_size": 16, "tlwe_polynomial_degree": 512,
    "tlwe_mask_size": 2, "bs_decomp_length": 3, "bs_log2_base": 6,
    "ks_decomp_length": 4, "ks_log2_base": 3,
    "lwe_noise_stdev": 0.000013071021089943935,
    "bootstrap_noise_stdev": 0.00000004990272175010415,
}


def test_a_nand_at_tfhe_rs_default_shapes():
    cfg = TFHE_RS_DEFAULT
    g = data.generator(2**31 + 5, "cpu", 0)
    secret = data.Secret(cfg, g)
    raw = data.make_raw_cloud_key(cfg, secret, g)
    assert raw["bk_coeff"].shape == (16, 3, 3, 3, 512)
    assert raw["ks_a"].shape == (1024, 4, 8, 16)
    keys = tfhe.Keys(cfg, raw["bk_coeff"], raw["ks_a"], raw["ks_b"])
    x = torch.tensor([False, False, True, True] * 4)
    y = torch.tensor([False, True, False, True] * 4)
    a, b = tfhe.gate2(keys, "nand", data.encrypt(secret, x, g),
                      data.encrypt(secret, y, g))
    assert a.shape == (16, 16)
    assert torch.equal(data.decrypt(secret, a, b), ~(x & y))
