"""The inverse probes: kernel K13's wrapper and its plain PyTorch version.

The function of the TPU kernel ``tools/exp_inverse.py::make_kernel`` with
its bodies: a sample's 2048 rows ``a`` stacked four times (row r of the
stack is a[r mod 2048]), read as the exact engine's two inverse channels
(row t*128 + ch*64 + o*32 + k: slot t in bit-reversed order, channel ch,
polynomial o, coefficient k), the unscaled DIT inverse over S' =
Z[Y]/(Y^32 + 1), the fold C_j = P_j + Y P_{j+32} and ``normalize_dual``
(c = A + (B >> 6) mod 2^32).  The bodies differ in their twiddles:

- "base": make_inverse('full')'s, one rotation Y^(step * 2^b) a set bit b
  of the butterfly's m (``rows_engine.dit_inverse``'s function);
- "sliced": one rotation a butterfly (``dit_inverse_sliced``, K3's own
  form; the same function);
- "notw": none, and the fold without Y (make_inverse('none'));
- "align": base with each amount e rounded down to a multiple of 8 below
  its sign (make_inverse('align'));
- "noroll": the card's own probe: base with every rotation replaced by its
  sign alone (lane k negated where (k < e mod 32) != (e >= 32)), the
  fold's Y too.  The JAX script's noroll (butterflies without partners: 2x
  or 0 a stage) would fold away in ``nvcc``; on the card the partners are
  registers, and the lane exchanges are what the probe leaves out.

notw, align and noroll are wrong on purpose and used for timing only.

In the port's layout: ``a`` (B, 2048) int32 (the JAX script's (2048, B)
transposed); the output (B, 2048) int32, c of fold row j of polynomial o
at j*64 + o*32 + k (the JAX delta's rows, transposed).
"""

import torch

from ..numeric import wrap_i32

PROBES = ("base", "notw", "align", "noroll", "sliced")
ROWS = 2048
R = 32

# launches of the CUDA kernel (not of the plain version)
launches = 0


def aligned_amount(e):
    """make_inverse('align')'s amount: the part below the sign rounded down
    to a multiple of 8."""
    return 32 + ((e - 32) & ~7) if e >= 32 else e & ~7


def _twiddle(name, stage, m):
    """The twiddle of butterfly m at ``stage`` of the inverse: (amount e of
    Y^e mod 64, None), or for noroll (None, the lane signs)."""
    lanes = torch.arange(R)
    if name == "sliced":
        return (-(m << (5 - stage))) & 63, None
    if name == "notw":
        return 0, None
    total, sign = 0, torch.ones(R, dtype=torch.int64)
    for b in range(stage):
        if not (m >> b) & 1:
            continue
        e = (-((1 << b) << (5 - stage))) & 63
        if name == "align":
            e = aligned_amount(e)
        total += e
        sign = sign * torch.where((lanes < (e & 31)) != (e >= 32), -1, 1)
    return (None, sign) if name == "noroll" else (total & 63, None)


def _rot(v, e):
    """Y^e * v over the last axis, e in [0, 64)."""
    sh = e & 31
    if sh:
        v = torch.cat([-v[..., R - sh:], v[..., :R - sh]], dim=-1)
    return -v if e >= 32 else v


def inverse_probe_plain(name, a):
    """Plain PyTorch version of K13, any device."""
    if name not in PROBES:
        raise ValueError("unknown probe %r; the probes are %s"
                         % (name, PROBES))
    bsz = a.shape[0]
    dev = a.device
    t = torch.arange(64, device=dev).reshape(1, 1, 64, 1)
    o = torch.arange(2, device=dev).reshape(2, 1, 1, 1)
    ch = torch.arange(2, device=dev).reshape(1, 2, 1, 1)
    k = torch.arange(R, device=dev).reshape(1, 1, 1, R)
    idx = (t % 16) * 128 + ch * 64 + o * 32 + k             # (o, ch, t, k)
    x = a.to(torch.int64)[:, idx]                           # (B, o, ch, t, k)
    for stage in range(6):
        mmax = 1 << stage
        new = x.clone()
        for pair in range(32):
            m = pair & (mmax - 1)
            i = ((pair >> stage) << (stage + 1)) + m
            j = i + mmax
            e, sign = _twiddle(name, stage, m)
            xj = x[..., j, :]
            xj = xj * sign.to(dev) if sign is not None else _rot(xj, e)
            new[..., i, :] = x[..., i, :] + xj
            new[..., j, :] = x[..., i, :] - xj
        x = wrap_i32(new).to(torch.int64)
    hi = x[..., 32:, :]
    if name == "notw":
        y = hi
    elif name == "noroll":
        y = torch.cat([-hi[..., :1], hi[..., 1:]], dim=-1)
    else:
        y = _rot(hi, 1)
    c = wrap_i32(x[..., :32, :] + y).to(torch.int64)        # (B, o, ch, j, k)
    out = wrap_i32(c[:, :, 0] + (c[:, :, 1] >> 6))          # (B, o, j, k)
    return out.permute(0, 2, 1, 3).reshape(bsz, ROWS).contiguous()


def inverse_probe(name, a):
    """K13: probe ``name`` on ``a`` (B, 2048) int32.  A CUDA tensor runs the
    kernel; a CPU tensor the plain version.  Returns a new tensor."""
    global launches
    if name not in PROBES:
        raise ValueError("unknown probe %r; the probes are %s"
                         % (name, PROBES))
    if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != ROWS:
        raise ValueError("a must be int32 (B, %d), got %s %s"
                         % (ROWS, a.dtype, tuple(a.shape)))
    if a.device.type == 'cpu':
        return inverse_probe_plain(name, a)
    if a.device.type != 'cuda':
        raise ValueError("inverse_probe runs on CUDA or CPU, not %s"
                         % a.device)
    if not a.is_contiguous():
        raise ValueError("inverse_probe takes a contiguous tensor")
    from ..kernels import build
    fn = build.entry("inverse_probe")
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), out.data_ptr(), a.shape[0], PROBES.index(name),
              a.device.index, stream)
    build.check("inverse_probe", code)
    launches += 1
    return out
