"""The chunked blind rotation: kernel K3's wrapper and its plain PyTorch
version.

``chunk`` consecutive CMUX steps, from step ``start``, in one launch — the
function of the TPU kernel
``nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk``, which
equals ``chunk`` sequential K1 steps (``ops/cmux.py``) bit for bit.  In the
port's layout:

- ``acc``: (B, mask1, N) int32;
- ``bara_t``: (n, B) int32 in [0, 2N), one row of rotation amounts a step;
- ``key``: the whole rows-engine key in its device's form
  (``ops/key_rows.key_form``): on the CPU, and for the plain version on
  any device, the transformed key of ``ops/transform``, int64, (n, G, O,
  L, R) exact or (n, 2, G, O, L, R) rounded; on CUDA its int8 limb rows
  (``ops/key_rows``), prepared with the key, which the kernel copies into
  shared memory a slot at a time.
"""

import torch

from . import cmux
from . import key_rows as kr

# launches of the CUDA kernel (not of the plain version), the CMUX steps
# those launches ran, and the launches that ran as clusters of two blocks
# (``cmux.cluster_size``)
launches = 0
steps = 0
paired_launches = 0


def blind_rotate_chunk_plain(acc, bara_t, key, start, chunk, *, offset,
                             log2_base):
    """Plain PyTorch version of K3; any device: a loop of plain K1 steps
    over ``bara_t[start:start+chunk]``."""
    for step in range(start, start + chunk):
        acc = cmux.cmux_step_plain(acc, bara_t[step], key[step],
                                   offset=offset, log2_base=log2_base)
    return acc


def check_chunk(name, acc, bara_t, key, start, chunk, shape=None):
    """The inputs of a chunk-shaped launch (K3, K6, K11, K12): ``acc``
    (``cmux.check_acc``), int32 rotation amounts ``bara_t`` (n, B), the
    whole key in its device's form (``key_rows.key_form``, lead (n,)) with
    O = mask1, steps [start, start + chunk) inside the rotation, one
    device; (mask1, l) = ``shape`` for a kernel built for that one.
    Returns (rounded, mask1, l, start, chunk)."""
    mask1 = cmux.check_acc(acc, name)
    if bara_t.dtype != torch.int32:
        raise TypeError("%s takes int32 rotation amounts" % name)
    if bara_t.dim() != 2 or bara_t.shape[1] != acc.shape[0]:
        raise ValueError("bara_t must be (n, B), got %s for B = %d"
                         % (tuple(bara_t.shape), acc.shape[0]))
    n = bara_t.shape[0]
    start, chunk = int(start), int(chunk)
    if chunk < 1 or start < 0 or start + chunk > n:
        raise ValueError("steps [%d, %d) are not inside the %d-step rotation"
                         % (start, start + chunk, n))
    if not (acc.device == bara_t.device == key.device):
        raise ValueError("acc, bara_t and key must be on one device")
    form = kr.key_form(key, (n,), name, mask1)
    return cmux.check_shape(name, form, shape) + (start, chunk)


def blind_rotate_chunk(acc, bara_t, key, start, chunk, *, offset, log2_base):
    """K3: steps [start, start + chunk) of the blind rotation.  A CUDA
    tensor runs the kernel on the key's int8 rows; a CPU tensor the plain
    version on the int64 key (``key_rows.key_form``).  Returns a new
    tensor (``acc`` is not updated in place)."""
    global launches, steps, paired_launches
    rounded, mask1, decomp_length, start, chunk = check_chunk(
        "blind_rotate_chunk", acc, bara_t, key, start, chunk)
    if acc.device.type == 'cpu':
        return blind_rotate_chunk_plain(acc, bara_t, key, start, chunk,
                                        offset=offset, log2_base=log2_base)
    out = cmux.launch("blind_rotate_chunk", acc, bara_t,
                      key[start:start + chunk],
                      (start, chunk, mask1, decomp_length), offset=offset,
                      log2_base=log2_base, rounded=rounded)
    launches += 1
    steps += chunk
    paired_launches += cmux.cluster_size("blind_rotate_chunk", mask1,
                                         decomp_length) > 1
    return out
