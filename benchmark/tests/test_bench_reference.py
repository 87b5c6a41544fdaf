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


def test_transform_matrices_against_the_nussbaumer_oracle():
    rs = np.random.RandomState(0)
    a = rs.randint(-2**31, 2**31, (3, tfhe.N)).astype(np.int64)
    got = (torch.from_numpy(a).double() @ tfhe.forward_matrix("cpu"))
    want = transform_ref.forward(a).view(np.int64).reshape(3, -1)
    assert np.array_equal(got.round().long().numpy(), want)
    c = rs.randint(-2**40, 2**40, (2, tfhe.L, tfhe.R)).astype(np.int64)
    got = torch.from_numpy(c.reshape(2, -1)).double() @ \
        tfhe.inverse_matrix("cpu")
    want = transform_ref.inverse_unscaled(c.astype(np.uint64)).view(np.int64)
    assert np.array_equal(got.round().long().numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_external_product_against_the_oracles(mode):
    rs = np.random.RandomState(1)
    params = nft.NuFHEParameters(transform_type=mode, lwe_size=3).tgsw_params
    bk = rs.randint(-2**31, 2**31, (3, 2, 2, 2, tfhe.N)).astype(np.int32)
    acc = rs.randint(-2**31, 2**31, (5, 2, tfhe.N)).astype(np.int32)
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
    bk = torch.randint(-2**31, 2**31, (1, 1, 1, 2, tfhe.N), generator=g)
    digits = torch.randint(-512, 512, (3, 1, tfhe.N), generator=g)
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
