"""The in-loop stage stand-ins of the chunked rotation: kernel K6's wrapper
and its plain PyTorch version.

The function of the TPU kernel ``tools/exp_round4.py::context`` (a 100-step
rotation in one program, one stage of every step swapped for a cheap
stand-in, so that the full rotation's time minus a variant's is that
stage's cost inside the loop): here each variant is K3's own kernel
(``kernels/csrc/blind_rotate_body.cuh``) with its ``Variant`` template
argument set, at the default shape (mask1, l) = (2, 2), in both key forms.
The variants keep the JAX names, plus "no key split" for the copy of the
key's prepared int8 rows (``ops/key_rows``) into shared memory, a stage
the TPU's step does not have.  A stand-in is wrong on purpose (timing only) but
deterministic, so each variant is a function that the plain version states
in ``ops/flat_engine``'s stage functions:

- "FULL": K3, ``chunk`` CMUX steps;
- "noop step": acc + 1 a step;
- "dot only": the MAC alone: digit polynomial g = o*l + d is acc's own
  polynomial o (raw words), block j in slots j and j + 32 (no forward),
  its limbs the bytes (int8) x and (int8) (x >> 8); the channels folded
  into acc as "no inverse" does;
- "no rotation": the step on the digits of acc itself;
- "no forward": the digit blocks j in slots j and j + 32, no transform;
- "no lhs-split": the limbs (int8) x and (int8) (x >> 8), not the balanced
  a0 + 256 a1;
- "no pack": every digit (v & (base - 1)) - base/2 (the TPU's "pack" is
  its gadget decomposition);
- "no inverse": acc += slot p' + slot p' + 32 of the channels (lo, and hi
  in the exact form), at q-layout p'*32 + lane, mod 2^32;
- "no key split": the MAC of slot p reads the key rows of slot p % 16 of
  step ``start`` (the kernel's 16 warps each copy the prepared rows of
  their first slot into shared memory once, at the launch's first step),
  so FULL less it is the cost of copying every slot's rows a step.

In the port's layout: ``acc`` (B, 2, N) int32, ``bara_t`` (n, B) int32 in
[0, 2N), ``key`` the rows engine's key in its device's form
(``ops/key_rows.key_form``): for the plain version (n, 4, 2, L, R) int64
exact or (n, 2, 4, 2, L, R) rounded
(``ops/transform.bootstrap_key_transformed``).
"""

import torch

from ..numeric import wrap_i32
from . import blind_rotate as brc
from . import cmux
from . import flat_engine as fe
from . import step_parts as sp

VARIANTS = ("FULL", "noop step", "dot only", "no rotation", "no forward",
            "no lhs-split", "no pack", "no inverse", "no key split")
MASK1, DECOMP = 2, 2
G = MASK1 * DECOMP
N, L, R = fe.N, fe.L, fe.R
KEY_WARPS = 16     # the kernel's warps at (2, 2): "no key split"'s slots

# launches of the CUDA kernel (not of the plain version)
launches = 0


def _int8(x):
    """The low byte of an integer tensor as a signed value in [-128, 128)."""
    return ((x & 255) ^ 128) - 128


def _fold_into(acc_q, chan):
    """acc + slot p' + slot p' + 32 of every channel at q-layout p'*32 +
    lane, mod 2^32; chan (B, n_ch, O, L, R)."""
    bsz = acc_q.shape[0]
    c = chan.to(torch.int64).sum(1).reshape(bsz, MASK1, 2, N).sum(2)
    return wrap_i32(acc_q.to(torch.int64) + c.reshape(bsz, MASK1 * N))


def variant_step(variant, acc_q, p, rhs, *, offset, log2_base):
    """One step of ``variant`` in ``ops/flat_engine``'s stages: ``acc_q``
    (B, 2N) q-layout int32, ``p`` (B,), ``rhs`` the step's MAC operand
    (``step_parts.mac_operand``; "no key split": its stand-in)."""
    bsz = acc_q.shape[0]
    if variant == "noop step":
        return wrap_i32(acc_q.to(torch.int64) + 1)
    if variant in ("no rotation", "dot only"):
        src = acc_q
    else:
        src = fe.rotate_q(acc_q, p, minus_one=True)
    if variant == "dot only":
        dig = src.reshape(bsz, MASK1, 1, N).expand(bsz, MASK1, DECOMP, N)
    elif variant == "no pack":
        half = 1 << (log2_base - 1)
        dig = ((src & ((1 << log2_base) - 1)) - half).reshape(
            bsz, MASK1, 1, N).expand(bsz, MASK1, DECOMP, N)
    else:
        dig = fe.gadget_decomp_flat(src, MASK1, DECOMP, log2_base, offset)
    dig = dig.reshape(bsz, G * N)
    if variant in ("no forward", "dot only"):
        blocks = dig.reshape(bsz, G, 1, L // 2, R)
        xt = blocks.expand(bsz, G, 2, L // 2, R).reshape(bsz, G, L, R)
    else:
        xt = fe.dif_forward_q(dig, n_poly=G).reshape(bsz, G, L, R)
    if variant in ("no lhs-split", "dot only"):
        a0, a1 = _int8(xt), _int8(xt >> 8)
    else:
        a0 = ((xt + 128) & 255) - 128
        a1 = (xt - a0) >> 8
    chan = fe.limb_channels(a0, a1, rhs, mask1=MASK1)
    if variant in ("no inverse", "dot only"):
        return _fold_into(acc_q, chan)
    delta = fe.inverse_channels(chan, MASK1)
    return wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))


def key_split_stand_in(rhs):
    """"no key split"'s operand: slot p holds slot p % 16 of ``rhs``."""
    idx = torch.arange(L, device=rhs.device) % KEY_WARPS
    return rhs.index_select(0, idx)


def step_context_plain(variant, acc, bara_t, key, start, chunk, *, offset,
                       log2_base):
    """Plain PyTorch version of K6, any device: ``chunk`` steps of
    ``variant`` from step ``start``, each composed of ``ops/flat_engine``'s
    stage functions."""
    if variant not in VARIANTS:
        raise ValueError("unknown variant %r; the variants are %s"
                         % (variant, VARIANTS))
    bsz = acc.shape[0]
    acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
    first = None
    for step in range(start, start + chunk):
        if variant == "noop step":
            rhs = None
        elif variant == "no key split":
            if first is None:
                first = key_split_stand_in(sp.mac_operand(key[start]))
            rhs = first
        else:
            rhs = sp.mac_operand(key[step])
        if variant == "FULL":
            acc_q = fe.external_step(acc_q, bara_t[step], rhs, mask1=MASK1,
                                     decomp_length=DECOMP,
                                     log2_base=log2_base, offset=offset)
        else:
            acc_q = variant_step(variant, acc_q, bara_t[step], rhs,
                                 offset=offset, log2_base=log2_base)
    return fe.n_from_q(acc_q.reshape(bsz, MASK1, N))


def step_context(variant, acc, bara_t, key, start, chunk, *, offset,
                 log2_base):
    """K6: steps [start, start + chunk) of ``variant``.  A CUDA tensor runs
    the kernel on the key's rows; a CPU tensor the plain version on the
    int64 key (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if variant not in VARIANTS:
        raise ValueError("unknown variant %r; the variants are %s"
                         % (variant, VARIANTS))
    rounded, _, _, start, chunk = brc.check_chunk(
        "step_context", acc, bara_t, key, start, chunk, (MASK1, DECOMP))
    if acc.device.type == 'cpu':
        return step_context_plain(variant, acc, bara_t, key, start, chunk,
                                  offset=offset, log2_base=log2_base)
    out = cmux.launch("step_context", acc, bara_t, key[start:start + chunk],
                      (start, chunk, VARIANTS.index(variant)), offset=offset,
                      log2_base=log2_base, rounded=rounded)
    launches += 1
    return out

