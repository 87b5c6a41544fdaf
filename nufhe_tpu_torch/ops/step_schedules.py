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
[0, 2N), ``key_row`` one step of the key in its device's form
(``ops/key_rows.key_form``), for the plain version (4, 2, L, R) int64 exact
or (2, 4, 2, L, R) rounded (one row of
``ops/transform.bootstrap_key_transformed``).
"""

from . import cmux
from . import flat_engine as fe
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


def step_schedule(name, acc, p, key_row, *, offset, log2_base):
    """K10: one CMUX step in schedule ``name``.  A CUDA tensor runs the
    kernel on the key row's rows; a CPU tensor the plain version on its
    int64 row (``ops/key_rows.key_form``).  Returns a new tensor."""
    global launches
    if name not in SCHEDULES:
        raise ValueError("unknown schedule %r; the schedules are %s"
                         % (name, SCHEDULES))
    rounded = cmux.check_step("step_schedule", acc, p, key_row,
                              (MASK1, DECOMP))[0]
    if acc.device.type == 'cpu':
        return step_schedule_plain(name, acc, p, key_row, offset=offset,
                                   log2_base=log2_base)
    out = cmux.launch("step_schedules", acc, p, key_row,
                      (SCHEDULES.index(name),), offset=offset,
                      log2_base=log2_base, rounded=rounded)
    launches += 1
    return out
