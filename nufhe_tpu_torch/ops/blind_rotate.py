"""The chunked blind rotation: kernel K3's wrapper and its plain PyTorch
version.

``chunk`` consecutive CMUX steps, from step ``start``, in one launch — the
function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk``, which
equals ``chunk`` sequential K1 steps (``ops/cmux.py``) bit for bit.  In the
port's layout:

- ``acc``: (B, mask1, N) int32;
- ``bara_t``: (n, B) int32 in [0, 2N), one row of rotation amounts a step;
- ``key``: the whole transformed key of ``ops/transform``, int64:
  (n, G, O, L, R) exact or (n, 2, G, O, L, R) rounded;
- ``rows``: the key's int8 limb rows (``ops/key_rows``), prepared with the
  key, which the kernel copies into shared memory a slot at a time.
"""

import torch

from . import cmux
from . import key_rows as kr

# launches of the CUDA kernel (not of the plain version), and the CMUX
# steps those launches ran
launches = 0
steps = 0


def blind_rotate_chunk_plain(acc, bara_t, key, start, chunk, *, offset,
                             log2_base):
    """Plain PyTorch version of K3; any device: a loop of plain K1 steps
    over ``bara_t[start:start+chunk]``."""
    for step in range(start, start + chunk):
        acc = cmux.cmux_step_plain(acc, bara_t[step], key[step],
                                   offset=offset, log2_base=log2_base)
    return acc


def blind_rotate_chunk(acc, bara_t, key, start, chunk, *, offset, log2_base,
                       rows=None):
    """K3: steps [start, start + chunk) of the blind rotation.  A CUDA
    tensor runs the kernel on ``rows``, the key's prepared rows (required
    there); a CPU tensor the plain version.
    Returns a new tensor (``acc`` is not updated in place)."""
    global launches, steps
    mask1 = cmux.check_acc(acc, "blind_rotate_chunk")
    if bara_t.dtype != torch.int32:
        raise TypeError("blind_rotate_chunk takes int32 rotation amounts")
    if bara_t.dim() != 2 or bara_t.shape[1] != acc.shape[0]:
        raise ValueError("bara_t must be (n, B), got %s for B = %d"
                         % (tuple(bara_t.shape), acc.shape[0]))
    n = bara_t.shape[0]
    rounded = cmux.check_key(key, (n,), "blind_rotate_chunk", mask1)
    start, chunk = int(start), int(chunk)
    if chunk < 1 or start < 0 or start + chunk > n:
        raise ValueError("steps [%d, %d) are not inside the %d-step rotation"
                         % (start, start + chunk, n))
    if not (acc.device == bara_t.device == key.device):
        raise ValueError("acc, bara_t and key must be on one device")
    if acc.device.type == 'cpu':
        return blind_rotate_chunk_plain(acc, bara_t, key, start, chunk,
                                        offset=offset, log2_base=log2_base)
    if acc.device.type != 'cuda':
        raise ValueError("blind_rotate_chunk runs on CUDA or CPU, not %s"
                         % acc.device)
    if not (acc.is_contiguous() and bara_t.is_contiguous()
            and key.is_contiguous()):
        raise ValueError("blind_rotate_chunk takes contiguous tensors")
    if not 1 <= log2_base <= 16:
        raise ValueError("log2_base must be in [1, 16], got %d" % log2_base)
    _, decomp_length = cmux.kernel_shape(key, mask1, "blind_rotate_chunk")
    rows = kr.launch_rows(key, rounded, rows, start, chunk,
                          "blind_rotate_chunk")
    from ..kernels import build
    fn = build.entry("blind_rotate_chunk")
    out = torch.empty_like(acc)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    code = fn(acc.data_ptr(), out.data_ptr(), bara_t.data_ptr(),
              rows.data_ptr(), acc.shape[0], start, chunk, mask1, decomp_length,
              int(offset) & 0xFFFFFFFF, int(log2_base), int(rounded),
              acc.device.index, stream)
    build.check("blind_rotate_chunk", code)
    launches += 1
    steps += chunk
    return out
