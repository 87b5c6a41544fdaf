"""The step schedules: kernel K10's wrapper and its plain PyTorch version.

The function of the TPU kernel ``tools/exp_round3.py::run`` (one program of
one CMUX step a variant, v0-v3 and the pipelines p2, p2b and p4, each
asserted bit-equal to the first): here each schedule is K1's own kernel
(``kernels/csrc/blind_rotate_body.cuh``, a chunk of one step) with its
``Variant`` template argument set, at (mask1, l) = (2, 2), in both key
forms (``kernels/csrc/step_schedules.cu`` says what each schedule moves
through shared memory).  Every schedule computes K1's step, which the
plain version states in ``ops/flat_engine``'s stages.

In the port's layout: ``acc`` (B, 2, N) int32, ``p`` (B,) int32 in
[0, 2N), ``key_row`` (4, 2, L, R) int64 exact or (2, 4, 2, L, R) rounded
(one row of ``ops/transform.bootstrap_key_transformed``).
"""

import torch

from . import cmux
from . import flat_engine as fe
from . import key_rows as kr
from . import step_parts as sp

# the JAX script's short names (tools/exp_round3.py:137-143); the index is
# K10's schedule argument
SCHEDULES = ("v0", "v1", "v2", "v3", "p2", "p2b", "p4")
LABELS = {"v0": "v0 r2-baseline", "v1": "v1 +fused pack",
          "v2": "v2 +radix8 2-pass", "v3": "v3 +fused comb/norm",
          "p2": "p2 pipeline halves", "p2b": "p2b dots-early",
          "p4": "p4 pipeline quarters"}
MASK1, DECOMP = 2, 2
G = MASK1 * DECOMP
N = fe.N

# launches of the CUDA kernel (not of the plain version)
launches = 0


def step_schedule_plain(name, acc, p, key_row, *, offset, log2_base):
    """Plain PyTorch version of K10, any device: one CMUX step (every
    schedule's function)."""
    if name not in SCHEDULES:
        raise ValueError("unknown schedule %r; the schedules are %s"
                         % (name, SCHEDULES))
    bsz = acc.shape[0]
    acc_q = fe.q_from_n(acc).reshape(bsz, MASK1 * N)
    out = fe.external_step(acc_q, p, sp.mac_operand(key_row), mask1=MASK1,
                           decomp_length=DECOMP, log2_base=log2_base,
                           offset=offset)
    return fe.n_from_q(out.reshape(bsz, MASK1, N))


def step_schedule(name, acc, p, key_row, *, offset, log2_base, rows=None):
    """K10: one CMUX step in schedule ``name``.  A CUDA tensor runs the
    kernel; a CPU tensor the plain version.  Returns a new tensor.
    ``rows``: the key row's prepared rows (``ops/key_rows``), which the
    kernel reads: required on CUDA."""
    global launches
    if name not in SCHEDULES:
        raise ValueError("unknown schedule %r; the schedules are %s"
                         % (name, SCHEDULES))
    if cmux.check_acc(acc, "step_schedule") != MASK1:
        raise ValueError("step_schedule takes mask1 = %d, got %d"
                         % (MASK1, acc.shape[1]))
    rounded = cmux.check_key(key_row, (), "step_schedule", MASK1)
    if key_row.shape[-4] != G:
        raise ValueError("step_schedule takes l = %d, got a key of G = %d"
                         % (DECOMP, key_row.shape[-4]))
    if p.dtype != torch.int32 or p.shape != (acc.shape[0],):
        raise ValueError("p must be int32 (B,), got %s %s"
                         % (p.dtype, tuple(p.shape)))
    if not (acc.device == p.device == key_row.device):
        raise ValueError("acc, p and key row must be on one device")
    if acc.device.type == 'cpu':
        return step_schedule_plain(name, acc, p, key_row, offset=offset,
                                   log2_base=log2_base)
    if acc.device.type != 'cuda':
        raise ValueError("step_schedule runs on CUDA or CPU, not %s"
                         % acc.device)
    if not (acc.is_contiguous() and p.is_contiguous()
            and key_row.is_contiguous()):
        raise ValueError("step_schedule takes contiguous tensors")
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    rows = kr.launch_rows(key_row, rounded, rows, None, 1, "step_schedule")
    from ..kernels import build
    fn = build.entry("step_schedules")
    out = torch.empty_like(acc)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    code = fn(acc.data_ptr(), out.data_ptr(), p.data_ptr(), rows.data_ptr(),
              acc.shape[0], SCHEDULES.index(name), int(offset) & 0xFFFFFFFF,
              int(log2_base), int(rounded), acc.device.index, stream)
    build.check("step_schedules", code)
    launches += 1
    return out
