"""The rotation forms of the chunked rotation: kernel K12's wrapper and its
plain PyTorch version, and the plain barrel rotation.

The function of the TPU kernel ``tools/exp_round5.py::main`` (a 100-step
rotation, one program a step, with ``rotate_acc`` in another form, each
asserted bit-equal to the baseline): here each form is K3's own kernel
(``kernels/csrc/blind_rotate_body.cuh``) with its ``Variant`` template
argument set, at (mask1, l) = (2, 2), in both key forms.  K3 gathers each
rotated coefficient in one load; the forms run the TPU's barrel
(``rows_engine.rotate_acc``) on a digit warp's registers
(``kernels/csrc/rotate_forms.cu`` says how each moves its data).  Every
form computes the CMUX steps, so the plain version is the steps with
:func:`barrel_rotate_q` as their rotation.

In the port's layout: ``acc`` (B, 2, N) int32, ``bara_t`` (n, B) int32 in
[0, 2N), ``key`` the rows engine's key in its device's form
(``ops/key_rows.key_form``): for the plain version (n, 4, 2, L, R) int64
exact or (n, 2, 4, 2, L, R) rounded.
"""

import torch

from ..numeric import wrap_i32
from . import blind_rotate as brc
from . import cmux
from . import flat_engine as fe
from . import step_context as sc
from . import step_parts as sp

# the JAX script's names (tools/exp_round5.py:198-203); the index is K12's
# form argument
FORMS = ("t11", "t12", "t13", "t14")
LABELS = {"t11": "t11 concat whole-roll", "t12": "t12 sliced j-rounds",
          "t13": "t13 fused i-selects", "t14": "t14 = t12+t13"}
MASK1, DECOMP = sc.MASK1, sc.DECOMP
N, L, R = fe.N, fe.L, fe.R

# launches of the CUDA kernel (not of the plain version)
launches = 0


def _y(v, k=1):
    """Y^k * v over the last axis (the 32 coefficients of S'), k < 32."""
    return torch.cat([-v[..., R - k:], v[..., :R - k]], dim=-1)


def barrel_rotate_q(acc_q, p, *, skip_low_bits=0, deferred=False):
    """(X^p - 1) * acc by the TPU's barrel
    (``rows_engine.rotate_acc``), in q-layout: five j-rounds X^(2^b) with
    the Y-carry of the wrapped blocks, five i-rounds Y^(2^(b-5)), the
    bit-10 negate, each round where its bit of p is set.

    :param acc_q: (B, mask1*N) int32 q-layout.
    :param p: (B,) int32; a multiple of 2^skip_low_bits (rounds below it
        are left out, as ``rotate_acc(skip_low_bits=...)`` does).
    :param deferred: the j-rounds as plain cyclic rolls and one Y-fix of
        the blocks j < p mod 32 (T4's t5); the same function.
    """
    bsz = acc_q.shape[0]
    x = acc_q.to(torch.int64).reshape(bsz, -1, R, R)   # [b, o, j, i]
    p = p.to(torch.int64).reshape(bsz, 1, 1, 1)
    out = x
    for b in range(skip_low_bits, 5):
        k = 1 << b
        if deferred:
            moved = torch.roll(out, k, dims=2)
        else:
            moved = torch.cat([_y(out[:, :, R - k:]), out[:, :, :R - k]],
                              dim=2)
        out = torch.where(((p >> b) & 1) == 1, moved, out)
    if deferred:
        j = torch.arange(R, device=acc_q.device).reshape(1, 1, R, 1)
        out = torch.where(j < (p & (R - 1)), _y(out), out)
    for b in range(5, 10):
        out = torch.where(((p >> b) & 1) == 1, _y(out, 1 << (b - 5)),
                          out)
    out = torch.where(((p >> 10) & 1) == 1, -out, out)
    return wrap_i32(out - x).reshape(acc_q.shape)


def rotated_steps(acc, bara_t, key, start, chunk, *, offset, log2_base,
                  rotate):
    """``chunk`` CMUX steps from step ``start`` in ``ops/flat_engine``'s
    stages with ``rotate(acc_q, p)`` as the rotation (X^p - 1) * acc."""
    bsz = acc.shape[0]
    acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
    for step in range(start, start + chunk):
        rot = rotate(acc_q, bara_t[step])
        delta = fe.external_mul_flat(rot, sp.mac_operand(key[step]),
                                     mask1=MASK1, decomp_length=DECOMP,
                                     log2_base=log2_base, offset=offset)
        acc_q = wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
    return fe.n_from_q(acc_q.reshape(bsz, MASK1, N))


def rotate_form_plain(form, acc, bara_t, key, start, chunk, *, offset,
                      log2_base):
    """Plain PyTorch version of K12, any device: the steps with the barrel
    (every form computes the same function)."""
    if form not in FORMS:
        raise ValueError("unknown form %r; the forms are %s" % (form, FORMS))
    return rotated_steps(acc, bara_t, key, start, chunk, offset=offset,
                         log2_base=log2_base, rotate=barrel_rotate_q)


def rotate_form(form, acc, bara_t, key, start, chunk, *, offset, log2_base):
    """K12: steps [start, start + chunk) with the rotation in ``form``.  A
    CUDA tensor runs the kernel on the key's rows; a CPU tensor the plain
    version on the int64 key (``ops/key_rows.key_form``).  Returns a new
    tensor."""
    global launches
    if form not in FORMS:
        raise ValueError("unknown form %r; the forms are %s" % (form, FORMS))
    rounded, _, _, start, chunk = brc.check_chunk(
        "rotate_forms", acc, bara_t, key, start, chunk, (MASK1, DECOMP))
    if acc.device.type == 'cpu':
        return rotate_form_plain(form, acc, bara_t, key, start, chunk,
                                 offset=offset, log2_base=log2_base)
    out = cmux.launch("rotate_forms", acc, bara_t, key[start:start + chunk],
                      (start, chunk, FORMS.index(form)), offset=offset,
                      log2_base=log2_base, rounded=rounded)
    launches += 1
    return out
