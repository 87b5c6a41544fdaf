"""The LWE keyswitch totals: kernel K2's wrapper and its plain PyTorch
version.

    totals[s] = [ sum_r KS[r, digit(s, r)] | count of nonzero digits ]

over the l-major rows r = j * in_size + i with
digit(s, r) = ((a[s, i] + prec) >> (32 - (j+1)*log2_base)) & (base - 1),
prec = 2^(32 - (1 + log2_base*l)); digit 0 adds nothing; int32 wraparound.
This is the function of the TPU kernel
``nufhe_tpu/ops/pallas/keyswitch.py::keyswitch_mac`` (which carries the same
sums as int8 limb products), on the port's own table:

- ``a``: (B, in_size) int32;
- ``table``: (rows, base - 1, out + 1) int32, the [a | b] key entries for
  digits 1 .. base-1 (``ops/lwe.prepare_keyswitch_device``);
- result: (B, out + 2) int32.
"""

import torch

from ..numeric import wrap_i32

# launches of the CUDA kernel (not of the plain version)
launches = 0


def keyswitch_digits(a, decomp_length, log2_base):
    """(B, in_size) int32 -> (B, rows) int64 digits in l-major row order."""
    prec = 2 ** (32 - (1 + log2_base * decomp_length))
    shifted = (a.to(torch.int64) + prec) & 0xFFFFFFFF
    mask = 2 ** log2_base - 1
    return torch.cat([(shifted >> (32 - (j + 1) * log2_base)) & mask
                      for j in range(decomp_length)], dim=-1)


def keyswitch_totals_plain(a, table, *, decomp_length, log2_base):
    """Plain PyTorch version of K2; any device: a gather of the key rows
    picked by the digits, summed in int64 and wrapped to int32."""
    rows, nv, out1 = table.shape
    digits = keyswitch_digits(a, decomp_length, log2_base)          # (B, rows)
    if digits.shape[1] != rows:
        raise ValueError("table has %d rows, input needs %d"
                         % (rows, digits.shape[1]))
    # a zero row for digit 0, then the table's digit planes
    padded = torch.cat([torch.zeros((rows, 1, out1), dtype=table.dtype,
                                    device=table.device), table], dim=1)
    flat = padded.reshape(rows * (nv + 1), out1).to(torch.int64)
    base_idx = torch.arange(rows, device=a.device) * (nv + 1)
    totals = torch.zeros((a.shape[0], out1), dtype=torch.int64, device=a.device)
    # rows per gather, so that one gathered block stays near 2^25 values
    chunk = max(1, (1 << 25) // max(1, a.shape[0] * out1))
    for r0 in range(0, rows, chunk):
        idx = base_idx[None, r0:r0 + chunk] + digits[:, r0:r0 + chunk]
        totals += flat[idx].sum(dim=1)
    count = (digits != 0).sum(dim=1, keepdim=True)
    return wrap_i32(torch.cat([totals, count], dim=1))


def keyswitch_totals(a, table, *, decomp_length, log2_base):
    """K2.  A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    global launches
    if a.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("keyswitch_totals takes int32 tensors")
    if a.dim() != 2 or table.dim() != 3:
        raise ValueError("a must be (B, in_size), table (rows, base-1, out+1)")
    if table.shape[0] != a.shape[1] * decomp_length:
        raise ValueError("table rows %d != in_size %d * l %d"
                         % (table.shape[0], a.shape[1], decomp_length))
    if a.device != table.device:
        raise ValueError("a and table must be on one device")
    if a.device.type == 'cpu':
        return keyswitch_totals_plain(a, table, decomp_length=decomp_length,
                                      log2_base=log2_base)
    if a.device.type != 'cuda':
        raise ValueError("keyswitch runs on CUDA or CPU, not %s" % a.device)
    if log2_base != 2 or table.shape[1] != 3:
        raise ValueError("the keyswitch kernel takes base 4 digits")
    if not (a.is_contiguous() and table.is_contiguous()):
        raise ValueError("keyswitch_totals takes contiguous tensors")
    from ..kernels import build
    fn = build.entry("keyswitch")
    out_size = table.shape[2] - 1
    out = torch.empty((a.shape[0], out_size + 2), dtype=torch.int32,
                      device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), table.data_ptr(), out.data_ptr(), a.shape[0],
              a.shape[1], decomp_length, out_size, a.device.index, stream)
    build.check("keyswitch", code)
    launches += 1
    return out
