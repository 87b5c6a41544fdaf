"""The port's chunked blind rotation (kernel K3's plain version), the
rounded-key ('FFT') form of the CMUX step (kernel K1's plain version) and
their oracles, against the JAX package: the Pallas kernels in interpret
mode and the numpy oracles.  Bit-exact throughout; on the CPU the launch
counters do not move."""

from fractions import Fraction

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.ref import bootstrap_ref, polynomials_ref, tgsw_ref, transform_ref
from nufhe_tpu.ops import bootstrap as jboot
from nufhe_tpu.ops import rows_engine as re_
from nufhe_tpu.ops import tgsw as dtgsw
from nufhe_tpu.ops.pallas import blind_rotate as pbr

from nufhe_tpu_torch.numeric import wrap_i32
from nufhe_tpu_torch.ops import blind_rotate as brc
from nufhe_tpu_torch.ops import bootstrap as tboot, cmux, transform as ttf
from nufhe_tpu_torch.ops import flat_engine as tfe
from nufhe_tpu_torch.ops import key_rows as tkr
from nufhe_tpu_torch.params import NuFHEParameters as TParams
from nufhe_tpu_torch.ref import bootstrap_ref as t_bootstrap_ref
from nufhe_tpu_torch.ref import tgsw_ref as t_tgsw_ref
from nufhe_tpu_torch.ref import transform_ref as t_transform_ref

TP = NuFHEParameters().tgsw_params
KW = dict(offset=int(TP.offset), log2_base=TP.bs_log2_base)
MASK1 = 2


def _inputs(seed, b, rows):
    rng = np.random.RandomState(seed)
    accum = rng.randint(-2**31, 2**31, (b, MASK1, 1024)).astype(np.int32)
    bara = rng.randint(0, 2 * 1024, (b, rows)).astype(np.int32)
    bk_coeff = rng.randint(
        -2**31, 2**31,
        (rows, MASK1, TP.decomp_length, MASK1, 1024)).astype(np.int32)
    return accum, bara, bk_coeff


def _counts():
    return (cmux.launches, cmux.paired_launches, brc.launches, brc.steps,
            brc.paired_launches)


def test_chunk_plain_matches_pallas_chunk_interpret():
    """Two launches of 2 steps (start 0 and 2) against the JAX package's
    chunked kernel on its own key form."""
    b, steps, chunk = 128, 4, 2
    accum, bara, bk_coeff = _inputs(21, b, steps)
    rot = pbr.make_blind_rotate_chunk(
        MASK1, TP.decomp_length, TP.bs_log2_base, int(TP.offset), chunk,
        lane_tile=128, mac_dtype=jnp.float32, interpret=True)
    bk_dev = dtgsw.prepare_bootstrap_key_device(bk_coeff)
    bara3 = jnp.asarray(bara.T).reshape(steps, 1, b)
    rows = re_.acc_rows_from_n(jnp.asarray(accum))
    for start in range(0, steps, chunk):
        rows = rot(rows, bara3, bk_dev, start)
    want = np.asarray(re_.acc_n_from_rows(rows, MASK1))

    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    acc = torch.from_numpy(accum)
    before = _counts()
    for start in range(0, steps, chunk):
        acc = brc.blind_rotate_chunk(acc, bara_t, key, start, chunk, **KW)
    assert _counts() == before          # CPU tensors take the plain version
    assert np.array_equal(acc.numpy(), want)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_chunk_equals_sequential_steps(transform_type):
    """Steps [1, 4) of a 5-step rotation in one launch equal three K1
    steps, in both key forms, and the oracle's rotation of those steps."""
    accum, bara, bk_coeff = _inputs(3, 4, 5)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    acc = torch.from_numpy(accum)
    got = brc.blind_rotate_chunk(acc, bara_t, key, 1, 3, **KW)
    want = acc
    for i in range(1, 4):
        want = cmux.cmux_step(want, bara_t[i], key[i], **KW)
    assert torch.equal(got, want)
    oracle = bootstrap_ref.blind_rotate(
        accum, bk_coeff[1:4], bara[:, 1:4], TP, exact=transform_type == 'NTT')
    assert np.array_equal(got.numpy(), oracle)


def _rounded_row_inputs(seed, b):
    accum, bara, bk_coeff = _inputs(seed, b, 1)
    hat = transform_ref.forward(bk_coeff) & np.uint64(2**38 - 1)
    # about one residue in 64 is a rounding tie, where the two sides of the
    # rounded key differ from plain negation
    assert ((hat & np.uint64(63)) == 32).sum() > 100
    return accum, bara[:, 0], bk_coeff


def test_rounded_step_matches_pallas_step_interpret():
    accum, powers, bk_coeff = _rounded_row_inputs(11, 128)
    step = pbr.make_external_step_rows(
        MASK1, TP.decomp_length, TP.bs_log2_base, int(TP.offset),
        lane_tile=128, mac_dtype=jnp.float32, interpret=True)
    bk_dev = dtgsw.prepare_bootstrap_key_device(bk_coeff, exact=False)
    rows = step(re_.acc_rows_from_n(jnp.asarray(accum)),
                jnp.asarray(powers)[None, :], bk_dev[0])
    want = np.asarray(re_.acc_n_from_rows(rows, MASK1))

    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    before = _counts()
    got = cmux.cmux_step(torch.from_numpy(accum), torch.from_numpy(powers),
                         key[0], **KW)
    assert _counts() == before
    assert np.array_equal(got.numpy(), want)


def test_rounded_step_matches_oracle():
    accum, powers, bk_coeff = _rounded_row_inputs(5, 6)
    shifted = polynomials_ref.shift_polynomial(accum, powers, minus_one=True)
    want = accum + tgsw_ref.tgsw_external_mul_rounded(shifted, bk_coeff, 0, TP)
    assert np.array_equal(
        accum + t_tgsw_ref.tgsw_external_mul_rounded(
            shifted, bk_coeff, 0, TParams().tgsw_params), want)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    assert np.array_equal(cmux.cmux_step(acc, p, key[0], **KW).numpy(), want)
    # negating the rounded +v side at run time is close but not bit-equal
    negated = torch.stack([key[0, 0], -key[0, 0]])
    assert not np.array_equal(cmux.cmux_step(acc, p, negated, **KW).numpy(),
                              want)


def test_rounded_key_matches_jax_sides():
    _, _, bk_coeff = _inputs(8, 1, 3)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT').numpy()
    assert key.shape == (3, 2, MASK1 * TP.decomp_length, MASK1, 64, 32)
    assert np.abs(key).max() <= 2**37
    hat = transform_ref.forward(bk_coeff)
    sides = transform_ref.rounded_key_sides(hat)
    for port_side, jax_side in zip(t_transform_ref.rounded_key_sides(hat), sides):
        assert np.array_equal(port_side, jax_side)
    mask = np.uint64(2**38 - 1)
    for s, q in enumerate(sides):
        want = ((q * np.uint64(64)) & mask).reshape(key[:, s].shape)
        assert np.array_equal(key[:, s].astype(np.uint64) & mask, want)


def test_port_oracles_match_jax():
    """The port's copies of the blind-rotation oracle (both modes), the
    coarse modulus switch and the variance estimate."""
    accum, bara, bk_coeff = _inputs(13, 2, 2)
    for exact in (True, False):
        assert np.array_equal(
            t_bootstrap_ref.blind_rotate(accum, bk_coeff, bara,
                                         TParams().tgsw_params, exact=exact),
            bootstrap_ref.blind_rotate(accum, bk_coeff, bara, TP, exact=exact))
    phases = np.arange(2048, dtype=np.int32)
    for bits in range(5):
        want = np.asarray(jboot.round_phase_coarse(jnp.asarray(phases), bits,
                                                   1024))
        assert np.array_equal(
            t_bootstrap_ref.round_phase_coarse_ref(phases, bits, 1024), want)
        assert np.array_equal(tboot.round_phase_coarse(
            torch.from_numpy(phases), bits, 1024).numpy(), want)
    for exact in (True, False):
        for bits in (0, 1, 3):
            assert t_bootstrap_ref.blind_rotate_variance(
                TParams().tgsw_params, 500, exact=exact,
                coarse_phase_bits=bits) == bootstrap_ref.blind_rotate_variance(
                    TP, 500, exact=exact, coarse_phase_bits=bits)


def test_wrappers_reject_bad_input():
    accum, bara, bk_coeff = _inputs(4, 2, 3)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    rkey = ttf.bootstrap_key_transformed(bk_coeff, "cpu", 'FFT')
    acc = torch.from_numpy(accum)
    bara_t = torch.from_numpy(np.ascontiguousarray(bara.T))
    with pytest.raises(ValueError):      # start + chunk > n
        brc.blind_rotate_chunk(acc, bara_t, key, 1, 3, **KW)
    with pytest.raises(ValueError):      # negative start
        brc.blind_rotate_chunk(acc, bara_t, key, -1, 2, **KW)
    with pytest.raises(ValueError):      # key rows != steps
        brc.blind_rotate_chunk(acc, bara_t, key[:2], 0, 2, **KW)
    with pytest.raises(ValueError):      # not a key form: G = 3, O = 2
        brc.blind_rotate_chunk(acc, bara_t, key[:, :3], 0, 2, **KW)
    with pytest.raises(TypeError):
        brc.blind_rotate_chunk(acc, bara_t, key.to(torch.int32), 0, 2, **KW)
    with pytest.raises(TypeError):
        brc.blind_rotate_chunk(acc, bara_t.to(torch.int64), key, 0, 2, **KW)
    with pytest.raises(ValueError):      # bara_t is (n, B)
        brc.blind_rotate_chunk(acc, bara_t.t(), key, 0, 2, **KW)
    with pytest.raises(ValueError):      # a rounded row with one side
        cmux.cmux_step(acc, bara_t[0], rkey[0, :1], **KW)
    with pytest.raises(TypeError):
        cmux.cmux_step(acc, bara_t[0], rkey[0].to(torch.float64), **KW)
    with pytest.raises(ValueError):      # the key's form is not the engine's
        tboot.blind_rotate(acc, rkey, torch.from_numpy(bara),
                           TParams().tgsw_params, exact=True)
    assert brc.blind_rotate_chunk(acc, bara_t, rkey, 0, 3, **KW).shape \
        == acc.shape


def _k3_group(rounded, row, limb):
    """The output group in which K3's key limb row ``row`` meets digit limb
    ``limb``, -1 where none: ``ops/transform._mac_limb_table`` read by key
    limb, K3's rows being the key limbs in order (exact: vlo, vhi_0..3,
    then 4*vlo, the table's index KEY_LIMBS + 1; rounded: vhi_0..3)."""
    key_limbs = ttf.KEY_LIMBS_APPROX if rounded else ttf.KEY_LIMBS
    meets = ttf._mac_limb_table(not rounded)[limb].tolist()
    index = key_limbs + 1 if row == key_limbs else row
    return meets.index(index) if index in meets else -1


def _k3_rows(key_row):
    """K3's key rows as the port prepares them (``ops/key_rows``, the row
    kernel's plain version) for the int64 key row (G, O, L, R) (or (2, G,
    O, L, R) rounded): per (g, o, slot, limb row) a reversed 64-byte row,
    byte 31 - r the limb of side 0 at rotation r and byte 63 - r that of
    side 1: (G, O, L, rows, 64) int64, natural slot order (slot t is
    frequency t, the prepared rows' slot p being rev6(p)), and whether the
    key is rounded."""
    rounded = key_row.dim() == 5
    rows = tkr.key_rows_plain(key_row, rounded)       # (L, G, O, rows, 64)
    rows = rows[torch.from_numpy(ttf.BITREV_L)]       # slot p -> frequency
    return rows.permute(1, 2, 0, 3, 4).to(torch.int64), rounded


def _toeplitz(rows, row):
    """Limb row ``row`` of K3's key rows as its (G, O, L, k, u) Toeplitz
    operand: entry (k, u) is byte 31 - k + u."""
    k = torch.arange(32)
    return rows[:, :, :, row][..., 31 - k[:, None] + k[None, :]]


def _k3_operand(key_row):
    """K3's key rows (:func:`_k3_rows`) -> the (L, 256, Q) operand whose
    entry (c = g*64 + i*32 + u, q = s*64 + o*32 + k) is the Toeplitz
    operand of the row that digit limb i meets in group s
    (:func:`_k3_group`)."""
    rows, rounded = _k3_rows(key_row)
    g_sz, o_sz, l_sz, n_rows, _ = rows.shape
    n_groups = 4 if rounded else 5
    op = torch.zeros((l_sz, g_sz, 2, 32, n_groups, o_sz, 32),
                     dtype=torch.int64)
    for row in range(n_rows):
        vals = _toeplitz(rows, row).permute(2, 0, 4, 1, 3)  # (L, G, u, O, k)
        for i in range(2):
            s = _k3_group(rounded, row, i)
            if s >= 0:
                op[:, :, i, :, s] = vals
    return op.reshape(l_sz, g_sz * 2 * 32, n_groups * o_sz * 32).to(
        torch.int8)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_k3_operand_rule_matches_build_mac_rhs(transform_type):
    """The rule K3 applies on chip to the int64 key gives the TPU's MAC
    operand (the port's build_mac_rhs of key_limbs_host) bit for bit, slot
    order permuted, on a key with rounding ties."""
    _, _, bk_coeff = _rounded_row_inputs(17, 1)
    exact = transform_type == 'NTT'
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    hat = transform_ref.forward(bk_coeff)[0]
    limbs = ttf.key_limbs_host(hat, exact=exact)
    want = ttf.build_mac_rhs(torch.from_numpy(
        limbs.reshape((MASK1 * TP.decomp_length, MASK1, 64, 32)
                      + limbs.shape[-2:])))
    got = _k3_operand(key[0])
    assert got.shape == want.shape
    assert torch.equal(got[torch.from_numpy(ttf.BITREV_L)], want)


@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
def test_k3_operand_step_equals_cmux_step(transform_type):
    """One step in limb form on K3's operand (the lanes engine's step, with
    the q-layout around it) equals the plain K1 step bit for bit."""
    from nufhe_tpu_torch.ops import flat_engine as fe
    accum, powers, bk_coeff = _rounded_row_inputs(19, 6)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu", transform_type)
    op = _k3_operand(key[0])[torch.from_numpy(ttf.BITREV_L)]
    acc, p = torch.from_numpy(accum), torch.from_numpy(powers)
    acc_q = fe.q_from_n(acc).reshape(acc.shape[0], -1)
    got = fe.external_step(acc_q, p, op, mask1=MASK1,
                           decomp_length=TP.decomp_length, **KW)
    got = fe.n_from_q(got.reshape(acc.shape))
    assert torch.equal(got, cmux.cmux_step_plain(acc, p, key[0], **KW))


def _stacked_mac(key_row, a0, a1, mask1):
    """Every slot's MAC in K3's stacked form, as the kernel issues it: per
    group of the 4 samples on the mma's N (a block of kS = 4 at (2, 2),
    else the cluster's pair of blocks of kS = 2; a ragged last group
    padded with zero samples) the 8 N columns hold limb n & 1 of sample
    n >> 1; each key limb row's Toeplitz operand times those columns is
    an int32 accumulator of its own; sample n's lo is the sum of its (row,
    limb) columns shifted by 8 * (group - first group of lo) mod 2^32 (:func:`_k3_group`; the unused pairs
    dropped), its hi (exact) row 0's limb-0 column alone.

    :param a0, a1: (B, G, L, R) digit limbs, natural slot order.
    :returns: (B, n_ch, mask1, L, R) int32 as ``flat_engine.limb_channels``
        and the largest |accumulator|.
    """
    rows, rounded = _k3_rows(key_row)
    b, g_sz, l_sz, r_sz = a0.shape
    ks = 4          # samples on N: (2, 2)'s block, or a pair of blocks
    nb = -(-b // ks)

    def blocks(a):
        pad = a.new_zeros((nb * ks - b,) + a.shape[1:])
        return torch.cat([a, pad]).reshape(nb, ks, g_sz, l_sz, r_sz)

    cols = torch.zeros((nb, 8, g_sz, l_sz, r_sz), dtype=torch.int64)
    cols[:, 0:2 * ks:2] = blocks(a0)
    cols[:, 1:2 * ks:2] = blocks(a1)
    first = 0 if rounded else 1
    lo = torch.zeros((nb, ks, mask1, l_sz, r_sz), dtype=torch.int64)
    hi = torch.zeros_like(lo)
    largest = 0
    for row in range(rows.shape[3]):
        d = torch.einsum('gotku,bngtu->bnotk', _toeplitz(rows, row), cols)
        largest = max(largest, int(d.abs().max()))
        for i in range(2):
            part = d[:, i:2 * ks:2]
            s = _k3_group(rounded, row, i)
            if s >= first:
                lo += part << (8 * (s - first))
            if not rounded and (row, i) == (0, 0):
                hi = part
    chans = [lo] if rounded else [lo, hi]
    out = torch.stack(chans, dim=2).reshape(nb * ks, len(chans), mask1, l_sz,
                                            r_sz)
    return wrap_i32(out[:b]), largest


@pytest.mark.parametrize("limbs", ["random", "extreme"])
@pytest.mark.parametrize("transform_type", ["NTT", "FFT"])
@pytest.mark.parametrize("shape", ttf.KERNEL_SHAPES)
def test_k3_stacked_mac_matches_per_group(shape, transform_type, limbs):
    """K3's MAC with both digit limbs on the mma's N, one accumulator a key
    limb row and the rows recombined by their groups, equals the per-group
    MAC of the lanes engine (``flat_engine.limb_channels`` on
    ``build_mac_rhs``, ``_mac_limb_table``'s groups) bit for bit, in both
    channels, on 5 samples (a ragged block).  "extreme": digit limb 0 at
    -128 everywhere, limb 1 at -128 or 127, and every key residue 32 mod
    64, so that vlo is -32 on both sides and the exact hi channel sits at
    its bound G * 2^17 in every output."""
    mask1, decomp = shape
    g_sz, b = mask1 * decomp, 5
    exact = transform_type == 'NTT'
    rng = np.random.RandomState(31 + 7 * mask1 + decomp)
    hat = rng.randint(0, 2**38, (g_sz, mask1, 64, 32), dtype=np.int64)
    if limbs == "extreme":
        hat = (hat & ~63) | 32
        a0 = torch.full((b, g_sz, 64, 32), -128, dtype=torch.int64)
        a1 = torch.from_numpy(rng.choice([-128, 127], a0.shape))
    else:
        a0, a1 = (torch.from_numpy(rng.randint(-128, 128, (b, g_sz, 64, 32)))
                  for _ in range(2))
    hat = hat.astype(np.uint64)
    if exact:
        key_row = torch.from_numpy(ttf.centred_residues(hat))
    else:
        key_row = torch.from_numpy(np.stack(
            [ttf.centred_residues(q * np.uint64(64))
             for q in t_transform_ref.rounded_key_sides(hat)]))
    rhs = ttf.build_mac_rhs(torch.from_numpy(ttf.key_limbs_host(hat, exact)))
    bitrev = torch.from_numpy(ttf.BITREV_L)
    want = tfe.limb_channels(a0[:, :, bitrev], a1[:, :, bitrev], rhs,
                             mask1=mask1)
    got, largest = _stacked_mac(key_row, a0, a1, mask1)
    assert largest < 2**31
    assert torch.equal(got[:, :, :, bitrev], want)
    if exact:
        hi = got[:, 1].to(torch.int64).abs()
        assert int(hi.max()) <= g_sz * 2**17
        if limbs == "extreme":
            assert bool((hi == g_sz * 2**17).all())


def test_mac_issue_counts():
    """K3's MAC issues 96 (exact) and 64 (rounded) mma.sync a slot at
    (2, 2), where one digit limb on N took 144 and 112, and 9/12 and 7/8 of
    their N columns carry work; the kS = 2 shapes run as pairs of blocks,
    whose 4 samples fill N as (2, 2)'s block does (``chip_smoke.mac_issue``,
    kS and the pair read from the kernel's source)."""
    import chip_smoke
    assert chip_smoke.block_samples(2, 2) == 4
    assert chip_smoke.block_samples(3, 2) == chip_smoke.block_samples(2, 3) \
        == 2
    assert chip_smoke.pair_blocks(2, 2) == 1
    assert chip_smoke.pair_blocks(3, 2) == chip_smoke.pair_blocks(2, 3) == 2
    mac_issue = chip_smoke.mac_issue
    assert mac_issue(2, 2, rounded=False) == (96, Fraction(9, 12))
    assert mac_issue(2, 2, rounded=True) == (64, Fraction(7, 8))
    assert mac_issue(3, 2, rounded=False) == (216, Fraction(9, 12))
    assert mac_issue(2, 3, rounded=True) == (96, Fraction(7, 8))
    with pytest.raises(ValueError):
        mac_issue(3, 3, rounded=False)


def test_paired_launches_reset_with_the_launch_counters():
    """``paired_launches`` of K1 and K3 (launches that ran as two-block
    clusters) is set to 0 with the launch counters and K3's steps
    (``chip_smoke.reset_counts``), and a CPU rotation leaves it there."""
    import chip_smoke
    cmux.launches = cmux.paired_launches = 3
    brc.launches, brc.steps, brc.paired_launches = 2, 100, 2
    chip_smoke.reset_counts()
    assert _counts() == (0, 0, 0, 0, 0)
    accum, bara, bk_coeff = _inputs(5, 3, 2)
    key = ttf.bootstrap_key_transformed(bk_coeff, "cpu")
    acc = brc.blind_rotate_chunk(
        torch.from_numpy(accum), torch.from_numpy(np.ascontiguousarray(
            bara.T)), key, 0, 2, **KW)
    cmux.cmux_step(acc, torch.from_numpy(bara[:, 0].copy()), key[0], **KW)
    assert _counts() == (0, 0, 0, 0, 0)
