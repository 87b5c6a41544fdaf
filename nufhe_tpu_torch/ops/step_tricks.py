"""The step tricks of the chunked rotation: kernel K11's wrapper and its
plain PyTorch version.

The function of the TPU kernel ``tools/exp_round4.py::tricks`` (a 100-step
rotation, one program a step, with one micro-optimisation of the step,
each asserted bit-equal to the engine's step; t8 and t8+t9 on the powers
evened as ``bara & ~1``): here each variant is K3's own kernel
(``kernels/csrc/blind_rotate_body.cuh``) with its ``Variant`` template
argument set, at (mask1, l) = (2, 2), in both key forms.  Each is the
card's form of the TPU's trick (``kernels/csrc/step_tricks.cu`` says what
each moves); where K3 already does the trick, the variant is the form
without it.  Every variant computes K3's CMUX steps:

- "t10", "t9", "t6", "t7": the steps (``ops/flat_engine``'s stages);
- "t5": the steps with the deferred-carry barrel as their rotation
  (``rotate_forms.barrel_rotate_q(deferred=True)``);
- "t8", "t8+t9": the steps on the evened powers p & ~1 with the barrel
  from round 1 (``skip_low_bits=1``); the wrapper evens the powers before
  it launches the kernel, as ``tools/exp_round4.py:661`` does.

In the port's layout: ``acc`` (B, 2, N) int32, ``bara_t`` (n, B) int32 in
[0, 2N), ``key`` the rows engine's key in its device's form
(``ops/key_rows.key_form``): for the plain version (n, 4, 2, L, R) int64
exact or (n, 2, 4, 2, L, R) rounded.
"""

import functools

from . import blind_rotate as brc
from . import cmux
from . import flat_engine as fe
from . import rotate_forms as rf

# the JAX script's short names (tools/exp_round4.py:1083-1091, in its
# order); the index is K11's variant argument
VARIANTS = ("t10", "t9", "t8+t9", "t8", "t6", "t7", "t5")
LABELS = {"t10": "t10 static slice-concat rot", "t9": "t9 fused acc add",
          "t8+t9": "t8+t9 (even powers)", "t8": "t8 even-p skip round 0",
          "t6": "t6 slab-hoisted forward", "t7": "t7 slab-hoisted inverse",
          "t5": "t5 deferred j-carry rot"}
EVEN = ("t8+t9", "t8")      # run on the evened powers

# launches of the CUDA kernel (not of the plain version)
launches = 0


def even_powers(bara_t):
    """The coarse modulus switch's amounts of t8: p & ~1."""
    return bara_t & ~1


def _rotation(variant):
    if variant in EVEN:
        return functools.partial(rf.barrel_rotate_q, skip_low_bits=1)
    if variant == "t5":
        return functools.partial(rf.barrel_rotate_q, deferred=True)
    return functools.partial(fe.rotate_q, minus_one=True)


def step_trick_plain(variant, acc, bara_t, key, start, chunk, *, offset,
                     log2_base):
    """Plain PyTorch version of K11, any device: the CMUX steps, with the
    variant's rotation (t8 and t8+t9 on p & ~1)."""
    if variant not in VARIANTS:
        raise ValueError("unknown variant %r; the variants are %s"
                         % (variant, VARIANTS))
    if variant in EVEN:
        bara_t = even_powers(bara_t)
    return rf.rotated_steps(acc, bara_t, key, start, chunk, offset=offset,
                            log2_base=log2_base, rotate=_rotation(variant))


def step_trick(variant, acc, bara_t, key, start, chunk, *, offset,
               log2_base):
    """K11: steps [start, start + chunk) of ``variant``.  A CUDA tensor runs
    the kernel on the key's rows (t8 and t8+t9 on ``even_powers(bara_t)``);
    a CPU tensor the plain version on the int64 key
    (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if variant not in VARIANTS:
        raise ValueError("unknown variant %r; the variants are %s"
                         % (variant, VARIANTS))
    rounded, _, _, start, chunk = brc.check_chunk(
        "step_tricks", acc, bara_t, key, start, chunk, (rf.MASK1, rf.DECOMP))
    if acc.device.type == 'cpu':
        return step_trick_plain(variant, acc, bara_t, key, start, chunk,
                                offset=offset, log2_base=log2_base)
    if variant in EVEN:
        bara_t = even_powers(bara_t)
    out = cmux.launch("step_tricks", acc, bara_t, key[start:start + chunk],
                      (start, chunk, VARIANTS.index(variant)), offset=offset,
                      log2_base=log2_base, rounded=rounded)
    launches += 1
    return out
