"""The MAC dot of ``tools/exp_int8.py`` on the card (``nufhe_tpu_torch``,
kernel K7, ``ops/mac_dot.py``), in its int8 and bf16 forms, unless
``--device cpu`` is given.

Usage:
    python tools/exp_int8_torch.py [batch]             # default 16384
    python tools/exp_int8_torch.py [batch] --device cpu
    python tools/exp_int8_torch.py [batch] --tree OLD_TREE

``--tree`` imports ``nufhe_tpu_torch`` (and so K7's wrapper and CUDA
source) from another checkout of this repository, for example a parent
commit unpacked with ``git archive``, and times it with this script's
code, so that two commits' kernels are compared by one method in one
session.

The data are the JAX script's, drawn in its order from seed 0: ``rhs``
(64, 256, 384) int8 in [-127, 128) (and its bf16 copy) and ``x`` (64, 256,
batch) int32 in [-100, 100).  First each form on the first 512 samples
against its plain version ("exact"), then the chained call timed (the
output feeds the next call, as the JAX script's chain does), with its
rate in tera-operations a second, and beside it on the card the library's
products alone, without the cast, fold and mask: 64 ``torch._int_mm``
for int8, and for bf16 one ``torch.bmm`` with a float32 result where the
installed PyTorch has one (``out_dtype``) and it is exact on these inputs,
else "none".

Timing on the card: CUDA events around ``reps`` calls after ``WARMUP``
untimed ones (``nufhe_tpu_torch.utils.profiling.time_ms``: a few
milliseconds of work first, so that the first form timed does not run
while the card's clocks still rise); the JAX script's sync
subtraction and its 512-sample TPU tile have no counterpart (see
``tools/microbench_torch.py``).  On the CPU the times are host seconds of
the plain versions, no device metric.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--tree" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the tree's package first: microbench_torch puts this checkout's root ahead
from nufhe_tpu_torch.ops import mac_dot as md  # noqa: E402
from microbench_torch import _where, time_ms  # noqa: E402

L, C, Q = 64, md.C, md.Q
CHECK = 512            # samples of the exactness check (the JAX tile)
WARMUP = 5             # untimed chained calls before the timed ones


def inputs(batch, device):
    """rhs int8 and bf16, x: the JAX script's draws from seed 0."""
    rs = np.random.RandomState(0)
    rhs_i8 = torch.from_numpy(rs.randint(-127, 128, (L, C, Q)).astype(
        np.int8)).to(device)
    x0 = torch.from_numpy(rs.randint(-100, 100, (L, C, batch)).astype(
        np.int32)).to(device)
    return {"int8": rhs_i8, "bf16": rhs_i8.to(torch.bfloat16)}, x0


def library_ms(form, rhs, x, reps):
    """The form's products alone by the library (ms), or None where no
    PyTorch call gives them exactly."""
    if form == "int8":
        lhs_t = (((x & 255) ^ 128) - 128).to(torch.int8).transpose(
            1, 2).contiguous()                               # (L, B, C)
        want = torch.bmm(lhs_t[:1].to(torch.float64),
                         rhs[:1].to(torch.float64))
        if not torch.equal(torch._int_mm(lhs_t[0], rhs[0]).to(torch.float64),
                           want[0]):
            raise AssertionError("torch._int_mm disagrees with float64")
        return time_ms(lambda: [torch._int_mm(lhs_t[t], rhs[t])
                                for t in range(L)], reps)
    lhs = x.to(torch.float32).to(torch.bfloat16)
    rhs_t = rhs.transpose(1, 2).contiguous()                 # (L, Q, C)
    try:
        got = torch.bmm(rhs_t, lhs, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as exc:
        print("bf16 library: none (torch.bmm with out_dtype: %s)"
              % str(exc).splitlines()[0][:120])
        return None
    want = torch.bmm(rhs_t.to(torch.float64), lhs.to(torch.float64))
    if not torch.equal(got.to(torch.float64), want):
        print("bf16 library: none (torch.bmm with out_dtype=float32 is not "
              "exact here)")
        return None
    return time_ms(lambda: torch.bmm(rhs_t, lhs, out_dtype=torch.float32),
                   reps)


def run(batch, device="cuda", reps=10):
    """Each form checked on the first samples, then timed chained; returns
    {form: {"exact", "ms", "tops", "library_ms"}}."""
    rhs, x0 = inputs(batch, device)
    small = x0[:, :, :min(CHECK, batch)].contiguous()
    ops = 2 * L * C * Q * batch
    out = {}
    for form in md.FORMS:
        exact = torch.equal(md.mac_dot(small, rhs[form]),
                            md.mac_dot_plain(small, rhs[form]))
        state = [x0]

        def chained():
            state[0] = md.mac_dot(state[0], rhs[form])

        ms = time_ms(chained, reps, device, warmup=WARMUP)
        res = {"exact": exact, "ms": ms, "tops": ops / ms / 1e9,
               "library_ms": None}
        line = "kernel %s: exact %s; %.4f %s  %.1f TOP/s" % (
            form, exact, ms, _where(device), res["tops"])
        if torch.device(device).type == "cuda":
            res["library_ms"] = library_ms(form, rhs[form], x0, reps)
            if res["library_ms"] is not None:
                line += "; library products alone %.4f ms" % res["library_ms"]
        print(line, flush=True)
        out[form] = res
    return out


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if "--tree" in argv:
        i = argv.index("--tree")
        print("K7 from %s" % os.path.dirname(os.path.dirname(
            os.path.abspath(md.__file__))))
        argv = argv[:i] + argv[i + 2:]
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "versions on the CPU")
    run(int(argv[0]) if argv else 16384, device)


if __name__ == "__main__":
    main(sys.argv[1:])
