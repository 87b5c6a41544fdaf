"""The rotation-family profile of one CMUX step: kernel K9's wrapper and its
plain PyTorch version.

The function of the TPU kernel ``tools/exp_round4.py::profile`` (one
``pallas_call`` a cumulative prefix of the fused step, the rotation split
into the families of its barrel rounds): here each part is a stage prefix
of the card's own step (K1 and K3, ``kernels/csrc/blind_rotate_body.cuh``),
as K5's are (``ops/step_parts.py``), at the default shape (mask1, l) =
(2, 2) in both key forms, as ``profile`` reads the engine mode.  The parts
keep the JAX names; in the port's layout (``acc`` (B, 2, N) int32, ``p``
(B,) int32 in [0, 2N), ``key_row`` one step of the key in its device's
form (``ops/key_rows.key_form``), for the plain version a row of
``ops/transform.bootstrap_key_transformed``, (4, 2, L, R) exact or (2, 4,
2, L, R) rounded) each returns (B, P, N) int32 in coefficient order, P = 4
for "+decomp_pack2" and 2 else:

- "noop (1 pass)": acc + 1;
- "rot j-rolls b0-4", "rot Y-rolls 1/2/4", "rot Y-rolls 8/16": X^(p & m) *
  acc for m = 0x1F, 0xE0, 0x300 (no -1): the rotation by the bits that
  each family of the TPU's barrel rounds handles;
- "rotation (full)", "+decomp_pack2": K5's "rotate" and "rot+decomp";
- "+forward (fold glue)", "+lhs (sum glue 8x)", "+mac dot (sum glue)":
  K5's "dec+fwd", "dec+fwd+key" (the limb split and the key's on-chip split
  into int8 rows, the card's MAC operands) and "dec+fwd+mac" on the digits
  of the rotation, folded as K5 folds them;
- "FULL step": the CMUX step (K1).
"""

import torch

from ..numeric import wrap_i32
from . import cmux
from . import flat_engine as fe
from . import step_parts as sp

PARTS = ("noop (1 pass)", "rot j-rolls b0-4", "rot Y-rolls 1/2/4",
         "rot Y-rolls 8/16", "rotation (full)", "+decomp_pack2",
         "+forward (fold glue)", "+lhs (sum glue 8x)", "+mac dot (sum glue)",
         "FULL step")
# the rotation families: bits of p
FAMILY_MASKS = {"rot j-rolls b0-4": 0x1F, "rot Y-rolls 1/2/4": 0xE0,
                "rot Y-rolls 8/16": 0x300}
# K5's part for each of the others (rotating: on the rotation's digits)
K5_PART = {"rotation (full)": "rotate", "+decomp_pack2": "rot+decomp",
           "+forward (fold glue)": "dec+fwd",
           "+lhs (sum glue 8x)": "dec+fwd+key",
           "+mac dot (sum glue)": "dec+fwd+mac", "FULL step": "FULL step"}
MASK1, DECOMP = 2, 2
G = MASK1 * DECOMP
N, L, R = fe.N, fe.L, fe.R

# launches of the CUDA kernel (not of the plain version)
launches = 0


def out_polys(name):
    """Polynomials a sample of part ``name``'s output."""
    return G if name == "+decomp_pack2" else MASK1


def step_profile_plain(name, acc, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K9, any device: part ``name`` composed of
    ``ops/flat_engine``'s stage functions (K5's plain parts for the
    prefixes it shares)."""
    if name == "noop (1 pass)":
        return wrap_i32(acc.to(torch.int64) + 1)
    if name in FAMILY_MASKS:
        bsz = acc.shape[0]
        acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
        rot = fe.rotate_q(acc_q, p & FAMILY_MASKS[name])
        return fe.n_from_q(rot.reshape(bsz, MASK1, N))
    if name not in K5_PART:
        raise ValueError("unknown part %r; the parts are %s" % (name, PARTS))
    return sp.step_part_plain(K5_PART[name], acc, p, key_row, offset=offset,
                              log2_base=log2_base, rotate=True)


def step_profile(name, acc, p, key_row, *, offset, log2_base):
    """K9: part ``name`` of the CMUX step, either key form.  A CUDA tensor
    runs the kernel on the key row's rows; a CPU tensor the plain version
    on its int64 row (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if name not in PARTS:
        raise ValueError("unknown part %r; the parts are %s" % (name, PARTS))
    rounded = cmux.check_step("step_profile", acc, p, key_row,
                              (MASK1, DECOMP))[0]
    if acc.device.type == 'cpu':
        return step_profile_plain(name, acc, p, key_row, offset=offset,
                                  log2_base=log2_base)
    out = cmux.launch("step_profile", acc, p, key_row, (PARTS.index(name),),
                      offset=offset, log2_base=log2_base, rounded=rounded,
                      out_polys=out_polys(name))
    launches += 1
    return out
