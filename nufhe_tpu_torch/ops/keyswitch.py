"""The LWE keyswitch totals: kernel K2's wrapper and its plain PyTorch
version.

    totals[s] = [ sum_r KS[r, digit(s, r)] | count of nonzero digits ]

over the l-major rows r = j * in_size + i with
digit(s, r) = ((a[s, i] + prec) >> (32 - (j+1)*log2_base)) & (base - 1),
prec = 2^(32 - (1 + log2_base*l)); digit 0 adds nothing; int32 wraparound.
This is the function of the TPU kernel
``nufhe_tpu/ops/pallas/keyswitch.py::keyswitch_mac``, on its operand:

- ``a``: (B, in_size) int32;
- ``ab_limbs``: (base - 1, 4, rows, n_pad) int8, the [a | b] key entries
  for digits 1 .. base-1 as balanced radix-2^8 limbs, with the count
  marker in column out + 1 of limb plane 0
  (``ops/lwe.prepare_keyswitch_device``);
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


def key_table(ab_limbs, out_size):
    """The limbs recombined: (rows, base-1, out+2) int64 entries, [a | b |
    count marker], each equal to its int32 key entry mod 2^32."""
    shifts = torch.arange(ab_limbs.shape[1], device=ab_limbs.device) * 8
    table = (ab_limbs[..., :out_size + 2].to(torch.int64)
             << shifts[None, :, None, None]).sum(dim=1)
    return table.permute(1, 0, 2)


def keyswitch_totals_plain(a, ab_limbs, *, out_size, decomp_length,
                           log2_base):
    """Plain PyTorch version of K2; any device: a gather of the recombined
    key rows picked by the digits, summed in int64 and wrapped to int32."""
    table = key_table(ab_limbs, out_size)
    rows, nv, width = table.shape
    digits = keyswitch_digits(a, decomp_length, log2_base)          # (B, rows)
    if digits.shape[1] != rows:
        raise ValueError("the key has %d rows, input needs %d"
                         % (rows, digits.shape[1]))
    # a zero row for digit 0, then the key's digit planes
    padded = torch.cat([torch.zeros((rows, 1, width), dtype=table.dtype,
                                    device=table.device), table], dim=1)
    flat = padded.reshape(rows * (nv + 1), width)
    base_idx = torch.arange(rows, device=a.device) * (nv + 1)
    totals = torch.zeros((a.shape[0], width), dtype=torch.int64,
                         device=a.device)
    # rows per gather, so that one gathered block stays near 2^25 values
    chunk = max(1, (1 << 25) // max(1, a.shape[0] * width))
    for r0 in range(0, rows, chunk):
        idx = base_idx[None, r0:r0 + chunk] + digits[:, r0:r0 + chunk]
        totals += flat[idx].sum(dim=1)
    return wrap_i32(totals)


def keyswitch_totals(a, ab_limbs, *, out_size, decomp_length, log2_base):
    """K2.  A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    global launches
    if a.dtype != torch.int32 or ab_limbs.dtype != torch.int8:
        raise TypeError("keyswitch_totals takes int32 input and an int8 key")
    if a.dim() != 2 or ab_limbs.dim() != 4 or ab_limbs.shape[1] != 4:
        raise ValueError("a must be (B, in_size), ab_limbs (base-1, 4, rows, "
                         "n_pad)")
    if ab_limbs.shape[2] != a.shape[1] * decomp_length:
        raise ValueError("key rows %d != in_size %d * l %d"
                         % (ab_limbs.shape[2], a.shape[1], decomp_length))
    if ab_limbs.shape[3] < out_size + 2:
        raise ValueError("the key has %d columns, out + 2 = %d"
                         % (ab_limbs.shape[3], out_size + 2))
    if a.device != ab_limbs.device:
        raise ValueError("a and ab_limbs must be on one device")
    if a.device.type == 'cpu':
        return keyswitch_totals_plain(a, ab_limbs, out_size=out_size,
                                      decomp_length=decomp_length,
                                      log2_base=log2_base)
    if a.device.type != 'cuda':
        raise ValueError("keyswitch runs on CUDA or CPU, not %s" % a.device)
    if ab_limbs.shape[0] != (1 << log2_base) - 1 \
            or not 1 <= log2_base * decomp_length <= 31:
        raise ValueError("the keyswitch kernel takes base - 1 = %d digit "
                         "planes and 1 <= log2_base * l <= 31"
                         % ab_limbs.shape[0])
    if a.shape[1] % 64 or ab_limbs.shape[3] % 32:
        raise ValueError("the keyswitch kernel takes in_size % 64 == 0 and "
                         "n_pad % 32 == 0")
    if not (a.is_contiguous() and ab_limbs.is_contiguous()):
        raise ValueError("keyswitch_totals takes contiguous tensors")
    from ..kernels import build
    fn = build.entry("keyswitch")
    out = torch.empty((a.shape[0], out_size + 2), dtype=torch.int32,
                      device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), ab_limbs.data_ptr(), out.data_ptr(), a.shape[0],
              a.shape[1], decomp_length, int(log2_base), ab_limbs.shape[3],
              out_size + 2, a.device.index, stream)
    build.check("keyswitch", code)
    launches += 1
    return out
