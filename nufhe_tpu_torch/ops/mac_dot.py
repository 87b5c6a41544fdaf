"""The MAC dot alone on the tensor cores: kernel K7's wrapper and its plain
PyTorch versions.

The function of the TPU kernel ``tools/exp_int8.py::make_pallas``, in the
tool's own layout (L slots, C = 256 contracted values, Q = 384 outputs, the
TPU's padded width):

    out[l] = rhs[l]^T . lhs[l]                            (Q, B) a slot
    o[l][c] = out[l][c] + out[l][C + c]  for c < Q - C, else out[l][c]
    result = o & 255                                      (L, C, B) int32

so that the call chains (its input's shape is its output's).  Two forms,
chosen by ``rhs``'s dtype:

- int8 (``mac_int8``): lhs = x cast to int8, the XLA convert, which keeps
  the low byte (x mod 2^8 as a signed value); int32 accumulation, exact;
- bf16 (``mac_bf16``): lhs = x cast to bf16 (round to nearest even, here
  through float32, as the kernel casts), float32 accumulation, then int32
  (truncation).  Exact while |x| < 2^8: every sum is then an integer below
  2^24, which float32 holds in any order of summation.  The chained calls
  keep x in [0, 256).

The result is the dot mod 2^8, which is linear in x, so the int8 cast's
wrap (a multiple of 256 off) does not change it: the two forms agree
wherever the bf16 cast is exact, and differ where it rounds (|x| > 2^8).
Each has its own plain version.
"""

import torch

C, Q = 256, 384
FORMS = ("int8", "bf16")

# launches of the CUDA kernel (not of the plain version)
launches = 0


def form_of(rhs):
    if rhs.dtype == torch.int8:
        return "int8"
    if rhs.dtype == torch.bfloat16:
        return "bf16"
    raise TypeError("mac_dot takes an int8 or bfloat16 rhs, not %s"
                    % rhs.dtype)


def lhs_values(x, form):
    """The cast of ``x`` that the form multiplies, as float64 (exact)."""
    if form == "int8":
        return (((x & 255) ^ 128) - 128).to(torch.float64)
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def fold(out):
    """(L, Q, B) -> (L, C, B): row c plus row C + c for c < Q - C, then
    & 255, int32."""
    o = out[:, :C].clone()
    o[:, :Q - C] += out[:, C:]
    return (o & 255).to(torch.int32)


def mac_dot_plain(x, rhs):
    """Plain PyTorch version of K7, any device: the product in float64
    (exact: every product and sum is an integer below 2^53), then the
    form's integer result, the fold and the mask."""
    form = form_of(rhs)
    prod = torch.bmm(rhs.to(torch.float64).transpose(1, 2),
                     lhs_values(x, form))
    if form == "bf16":
        prod = prod.to(torch.float32).to(torch.float64)
    return fold(prod.to(torch.int64))


def mac_dot(x, rhs):
    """K7: the MAC dot of ``x`` (L, C, B) int32 with ``rhs`` (L, C, Q) int8
    or bf16, folded and masked.  A CUDA tensor runs the kernel; a CPU
    tensor the plain version.  Returns a new (L, C, B) int32 tensor."""
    global launches
    form = form_of(rhs)
    if x.dtype != torch.int32:
        raise TypeError("mac_dot takes int32 x, not %s" % x.dtype)
    if x.dim() != 3 or x.shape[1] != C or rhs.shape != (x.shape[0], C, Q):
        raise ValueError("mac_dot takes x (L, %d, B) and rhs (L, %d, %d), got "
                         "%s and %s" % (C, C, Q, tuple(x.shape),
                                        tuple(rhs.shape)))
    if x.device != rhs.device:
        raise ValueError("x and rhs must be on one device")
    if x.device.type == 'cpu':
        return mac_dot_plain(x, rhs)
    if x.device.type != 'cuda':
        raise ValueError("mac_dot runs on CUDA or CPU, not %s" % x.device)
    if not (x.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("mac_dot takes contiguous tensors")
    from ..kernels import build
    fn = build.entry("mac_dot")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), rhs.data_ptr(), out.data_ptr(), x.shape[0],
              x.shape[2], int(form == "bf16"), x.device.index, stream)
    build.check("mac_dot", code)
    launches += 1
    return out
