"""The stage parts of one exact CMUX step: kernel K5's wrapper and its
plain PyTorch version.

The function of the TPU kernel ``tools/microbench.py::bench_parts`` (one
``pallas_call`` a part, each a prefix of the fused step's stages, timed
apart): here each part is a stage prefix of the card's own step (K1 and
K3, ``kernels/csrc/blind_rotate_body.cuh``), at the default shape (mask1,
l) = (2, 2) and the exact key only, as ``bench_parts`` is.  The parts keep
the JAX names, plus "dec+fwd+key" for the card's on-chip split of the key
into the MAC's int8 operand, a stage the TPU's step does not have.

In the port's layout: ``acc`` (B, 2, N) int32, ``p`` (B,) int32 in
[0, 2N), ``key_row`` one step of the key in its device's form
(``ops/key_rows.key_form``), for the plain version (4, 2, L, R) int64 (one
row of ``ops/transform.bootstrap_key_transformed``, 'NTT').  Every part returns
(B, P, N) int32 in coefficient order, P = 4 for "rot+decomp" and 2 else:

- "rotate": (X^p - 1) * acc;
- "rot+decomp": its signed gadget digits, g = o*l + d;
- "dec+fwd+mac+inv": the product of acc's digits (no rotation) with the
  key row (``rows_engine.transformed_mac``);
- "FULL step": the CMUX step (``rows_engine.external_step``, K1).

The other four end in a fold in the card's slot order (slot p holds
frequency bitrev_6(p), ``ops/flat_engine``'s order): a transform-domain
polynomial (64 slots x 32 lanes) becomes slot p' plus slot p' + 32 at
q-layout p'*32 + lane, summed over what the part puts there:

- "dec+fwd": the forward transforms of acc's digits, summed over the digit
  levels d of each o;
- "dec+fwd+mac": both MAC channels (lo and hi) before the inverse;
- "dec+fwd+key": the MAC's stand-in: for slot p and lane k, the sum of the
  words k & 15 of the slot's 48 key limb rows (each a reversed 64-byte row
  of the key's two-sided int8 limbs, as the kernel builds them) plus the
  sum of the sample's digit limbs a0 + a1 at (p, k), in both o;
- "inverse only": the inverse, fold and normalisation of a stand-in
  channel pair (acc's q-layout polynomial o in slots 0..31 and again in
  32..63, for lo and for hi), added to acc.
"""

import numpy as np
import torch

from ..numeric import wrap_i32
from . import cmux
from . import flat_engine as fe
from . import transform as tf

# the JAX names (tools/microbench.py:210-213; "dec+fwd(SWAR)" there is the
# TPU's packed form of "dec+fwd"), and "dec+fwd+key"; the index is K5's
# part argument
PARTS = ("rotate", "rot+decomp", "dec+fwd", "dec+fwd+key", "dec+fwd+mac",
         "inverse only", "dec+fwd+mac+inv", "FULL step")
MASK1, DECOMP = 2, 2
G = MASK1 * DECOMP
N, L, R = tf.N, tf.L, tf.R

# launches of the CUDA kernel (not of the plain version)
launches = 0


def out_polys(name):
    """Polynomials a sample of part ``name``'s output."""
    return G if name == "rot+decomp" else MASK1


def _key_limbs(key_row):
    """A key row's two-sided limbs (G, O, L, R, KL, 2) as a numpy array, as
    the kernels split it on chip: exact (G, O, L, R), KL = 5,
    ``ops/transform.key_limbs_host`` of its residues mod 2^38; rounded (2,
    G, O, L, R), KL = 4, the balanced radix-2^8 digits of round(x/64) mod
    2^32 of each side x."""
    k = key_row.cpu().numpy()
    if key_row.dim() == 4:
        return tf.key_limbs_host(k.astype(np.uint64))
    return np.stack([tf._limb_split_38(k[0], exact=False),
                     tf._limb_split_38(k[1], exact=False)], axis=-1)


def mac_operand(key_row):
    """A key row's int8 MAC operand (L, G*2R, KL*O*R), slots in bit-reversed
    order (``ops/transform.build_mac_rhs``): what K1 and K3 build on chip;
    the row's shape selects the form, as for K1."""
    return tf.build_mac_rhs(torch.from_numpy(_key_limbs(key_row))).to(
        key_row.device)


def _key_row_sums(key_row):
    """"dec+fwd+key"'s key term: (L, R) int64, slot p and lane k, the sum
    mod 2^32 of the words k & 15 of the slot's limb rows (g, o, limb: vlo,
    vhi_0..3, 4*vlo exact, 48 rows; vhi_0..3 rounded, 32 rows), each a
    reversed 64-byte row, byte 31 - r the limb of side 0 (+v) at rotation r
    and byte 63 - r that of side 1."""
    limbs = _key_limbs(key_row).astype(np.int64)
    if key_row.dim() == 4:
        limbs = np.concatenate([limbs, 4 * limbs[..., :1, :]], axis=-2)
    limbs &= 255
    rows_go = limbs.shape[-2]
    limbs = limbs.reshape(G * MASK1, L, R, rows_go, 2)[:, tf.BITREV_L]
    rows = np.zeros((L, G * MASK1, rows_go, 64), np.int64)
    lane = np.arange(R)
    rows[..., 31 - lane] = limbs[..., 0].transpose(1, 0, 3, 2)
    rows[..., 63 - lane] = limbs[..., 1].transpose(1, 0, 3, 2)
    words = (rows.reshape(L, G * MASK1, rows_go, 16, 4)
             << (8 * np.arange(4))).sum(-1)
    sums = words.sum(axis=(1, 2)) & 0xFFFFFFFF             # (p, 16)
    return torch.from_numpy(sums[:, lane & 15]).to(key_row.device)


def _fold(x):
    """(B, P, 2048) slot-order words -> (B, P, 1024): slot p' + slot
    p' + 32, mod 2^32."""
    return wrap_i32(x.reshape(x.shape[0], x.shape[1], 2, N).to(
        torch.int64).sum(2))


def step_part_plain(name, acc, p, key_row, *, offset, log2_base,
                    rotate=False):
    """Plain PyTorch version of K5, any device: part ``name`` composed of
    ``ops/flat_engine``'s stage functions.  ``rotate``: "dec+fwd",
    "dec+fwd+key" and "dec+fwd+mac" on the digits of (X^p - 1) * acc (K9's
    rotating forms).  Either key form (K9); the rounded one has no hi
    channel."""
    bsz = acc.shape[0]
    acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
    if name in ("rotate", "rot+decomp", "FULL step") or rotate:
        src = fe.rotate_q(acc_q, p, minus_one=True)
    else:
        src = acc_q
    if name == "rotate":
        out = src
    elif name == "inverse only":
        stand_in = acc_q.reshape(bsz, 1, MASK1, 1, N).expand(
            bsz, 2, MASK1, 2, N).reshape(bsz, 2, MASK1, L, R)
        delta = fe.inverse_channels(stand_in, MASK1)
        out = wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
    elif name == "FULL step":
        out = fe.external_step(acc_q, p, mac_operand(key_row), mask1=MASK1,
                               decomp_length=DECOMP, log2_base=log2_base,
                               offset=offset)
    else:
        dig = fe.gadget_decomp_flat(src, MASK1, DECOMP, log2_base, offset)
        if name == "rot+decomp":
            out = dig
        elif name == "dec+fwd+mac+inv":
            out = fe.transformed_mac_flat(dig, mac_operand(key_row),
                                          mask1=MASK1, g_total=G)
        elif name == "dec+fwd":
            xt = fe.dif_forward_q(dig, n_poly=G).reshape(bsz, MASK1, DECOMP,
                                                          2 * N)
            out = _fold(xt.to(torch.int64).sum(2))
        elif name == "dec+fwd+mac":
            chan = fe.mac_channels(dig, mac_operand(key_row), mask1=MASK1,
                                   g_total=G)              # (B, 2, O, L, R)
            out = _fold(chan.to(torch.int64).sum(1).reshape(bsz, MASK1,
                                                            2 * N))
        elif name == "dec+fwd+key":
            xt = fe.dif_forward_q(dig, n_poly=G).reshape(bsz, G, L, R)
            a0 = ((xt + 128) & 255) - 128
            a1 = (xt - a0) >> 8
            lsum = (a0 + a1).to(torch.int64).sum(1)        # (B, L, R)
            word = lsum + _key_row_sums(key_row)
            out = _fold(word.reshape(bsz, 1, 2 * N).expand(bsz, MASK1, 2 * N))
        else:
            raise ValueError("unknown part %r; the parts are %s"
                             % (name, PARTS))
    out = out.reshape(bsz, out_polys(name), N)
    return fe.n_from_q(out)


def step_part(name, acc, p, key_row, *, offset, log2_base):
    """K5: part ``name`` of the exact CMUX step.  A CUDA tensor runs the
    kernel on the key row's rows; a CPU tensor the plain version on its
    int64 row (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if name not in PARTS:
        raise ValueError("unknown part %r; the parts are %s" % (name, PARTS))
    if cmux.check_step("step_part", acc, p, key_row, (MASK1, DECOMP))[0]:
        raise ValueError("step_part takes the exact key alone")
    if acc.device.type == 'cpu':
        return step_part_plain(name, acc, p, key_row, offset=offset,
                               log2_base=log2_base)
    out = cmux.launch("step_parts", acc, p, key_row, (PARTS.index(name),),
                      offset=offset, log2_base=log2_base,
                      out_polys=out_polys(name))
    launches += 1
    return out
