"""The exact CMUX step in the split-halves schedule: kernel K8's wrapper
and its plain PyTorch version.

The function of the TPU kernel ``tools/exp_overlap.py::make`` with its
``mac_split`` body: the forward transform and the MAC of digit half A
(g in {0, 1}), then of half B (g in {2, 3}), the two MACs' channels summed
and inverted once; that tool asserts it bit-equal to ``mac_serial``
(``ops/rows_engine.external_step``), and so is this: K8 equals K1
(``ops/cmux.py``), the card's serial schedule, bit for bit.  On the card
the halves overlap in disjoint warp groups (``kernels/csrc/
step_overlap.cu``).  Exact key, (mask1, l) = (2, 2), as the tool runs.

In the port's layout: ``acc`` (B, 2, N) int32, ``p`` (B,) int32 in
[0, 2N), ``key_row`` one step of the key in its device's form
(``ops/key_rows.key_form``), for the plain version (4, 2, L, R) int64 (one
row of ``ops/transform.bootstrap_key_transformed``, 'NTT').
"""

import torch

from ..numeric import wrap_i32
from . import cmux
from . import flat_engine as fe
from . import step_parts as sp

MASK1, DECOMP = 2, 2
G = MASK1 * DECOMP
N, L, R = fe.N, fe.L, fe.R

# launches of the CUDA kernel (not of the plain version)
launches = 0


def step_overlap_plain(acc, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K8, any device: ``mac_split`` in
    ``ops/flat_engine``'s stages, the channels of each digit half against
    its half of the key operand's C axis, summed (lo mod 2^32, hi exact),
    one inverse."""
    bsz = acc.shape[0]
    acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
    rot = fe.rotate_q(acc_q, p, minus_one=True)
    dig = fe.gadget_decomp_flat(rot, MASK1, DECOMP, log2_base, offset)
    xt = fe.dif_forward_q(dig, n_poly=G).reshape(bsz, G, L, R)
    a0 = ((xt + 128) & 255) - 128
    a1 = (xt - a0) >> 8
    rhs = sp.mac_operand(key_row)
    half = G // 2
    c_half = rhs.shape[1] // 2
    chan = sum(fe.limb_channels(a0[:, h * half:(h + 1) * half],
                                a1[:, h * half:(h + 1) * half],
                                rhs[:, h * c_half:(h + 1) * c_half],
                                mask1=MASK1).to(torch.int64)
               for h in range(2))
    delta = fe.inverse_channels(wrap_i32(chan), MASK1)
    out = wrap_i32(acc_q.to(torch.int64) + delta.to(torch.int64))
    return fe.n_from_q(out.reshape(bsz, MASK1, N))


def step_overlap(acc, p, key_row, *, offset, log2_base):
    """K8: one exact CMUX step in the split schedule.  A CUDA tensor runs
    the kernel on the key row's rows; a CPU tensor the plain version on its
    int64 row (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if cmux.check_step("step_overlap", acc, p, key_row, (MASK1, DECOMP))[0]:
        raise ValueError("step_overlap takes the exact key alone")
    if acc.device.type == 'cpu':
        return step_overlap_plain(acc, p, key_row, offset=offset,
                                  log2_base=log2_base)
    out = cmux.launch("step_overlap", acc, p, key_row, (), offset=offset,
                      log2_base=log2_base)
    launches += 1
    return out
