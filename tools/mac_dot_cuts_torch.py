"""Where kernel K7's time goes on the card: the MAC dot (``ops/mac_dot.py``,
``kernels/csrc/mac_dot.cu``) built with parts of its work cut out, beside
a plain copy of x and the library's bf16 products.

Usage:
    python tools/mac_dot_cuts_torch.py [batch]          # default 16384

Each build is ``mac_dot.cu`` with one set of the measurement macros that
the source defines (each cut gives wrong results, so none is checked):
``full`` (none: the kernel as shipped), ``no store`` (the epilogue runs
but stores nothing), ``TMA stream`` (the consumers only wait for and free
the ring's stages: x streamed into shared memory and nothing else), ``half
wgmma, no store`` (every other k step's wgmma, no store) and ``no bf16
prefetch`` (bf16 without its L2 prefetch).  They are compiled with the
kernels' own ``nvcc`` flags, all at once, into ``kernels/_build/cuts/``.
On the tool's inputs (``tools/exp_int8_torch.py``, seed 0) each runs in
both forms at ``batch``, beside ``out.copy_(x)`` (the same bytes in and
out as K7, the card's practical stream rate) and ``torch.bmm`` with a
float32 result on the bf16 cast (the bf16 products alone).  Two rounds,
the second in the reverse order; CUDA events around 20 calls after 5
(``nufhe_tpu_torch.utils.profiling.time_ms``).  Prints one JSON line of
the rounds' ms, then the card's name and power limit.  Needs a card.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from nufhe_tpu_torch.kernels import build  # noqa: E402
from nufhe_tpu_torch.ops import mac_dot as md  # noqa: E402
from nufhe_tpu_torch.utils.profiling import time_ms  # noqa: E402

CUTS = {"full": [], "no store": ["MAC_DOT_CUT_STORE"],
        "TMA stream": ["MAC_DOT_CUT_CONSUME"],
        "half wgmma, no store": ["MAC_DOT_HALF_MMA", "MAC_DOT_CUT_STORE"],
        "no bf16 prefetch": ["MAC_DOT_NO_PREFETCH"]}
REPS, WARMUP = 20, 5


def build_cuts():
    """{cut: C entry point}, one nvcc a cut, all started at once."""
    out_dir = build.BUILD_DIR / "cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = build.CSRC / build.KERNELS["mac_dot"][0]
    procs = {}
    for cut, macros in CUTS.items():
        lib = out_dir / ("libmac_dot_%s.so" % "_".join(
            cut.replace(",", "").split()))
        cmd = ([build.nvcc_path()] + build.NVCC_FLAGS
               + ["-D%s" % m for m in macros] + ["-o", str(lib), str(source)])
        procs[cut] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    fns = {}
    for cut, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for cut %r:\n%s" % (cut, log))
        _, symbol, argtypes = build.KERNELS["mac_dot"]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[cut] = fn
    return fns


def run(batch):
    import exp_int8_torch as e8
    dev = torch.device("cuda", 0)
    fns = build_cuts()
    rhs, x = e8.inputs(batch, dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lhs = x.to(torch.float32).to(torch.bfloat16)
    rhs_t = rhs["bf16"].transpose(1, 2).contiguous()
    runs = {"copy x -> out": lambda: out.copy_(x),
            "torch.bmm bf16 products": lambda: torch.bmm(
                rhs_t, lhs, out_dtype=torch.float32)}
    for cut, fn in fns.items():
        for form in md.FORMS:
            def call(fn=fn, form=form, cut=cut):
                code = fn(x.data_ptr(), rhs[form].data_ptr(), out.data_ptr(),
                          x.shape[0], batch, int(form == "bf16"), dev.index,
                          stream)
                build.check("mac_dot (%s)" % cut, code)
            runs["%s %s" % (cut, form)] = call
    res = {name: [] for name in runs}
    for order in (list(runs), list(reversed(list(runs)))):
        for name in order:
            res[name].append(time_ms(runs[name], REPS, warmup=WARMUP))
    return res


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("mac_dot_cuts_torch needs a CUDA card")
    from bench_torch import nvidia_smi_line
    batch = int(argv[0]) if argv else 16384
    print(json.dumps({"mac_dot_cuts": run(batch), "batch": batch}))
    print(nvidia_smi_line())


if __name__ == "__main__":
    main(sys.argv[1:])
