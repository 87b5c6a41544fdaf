"""LWE operations in PyTorch (``nufhe_tpu/ops/lwe.py``'s counterpart).

The elementwise ops are plain tensor code; the keyswitch runs kernel K2
(``ops/keyswitch.py``) on a CUDA tensor, inside the span ``nufhe.keyswitch``
(``utils/profiling.annotate``).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..numeric import wrap_i32
from ..utils import to_device
from ..utils.profiling import spanned
from . import keyswitch as ks


class KeyswitchMeta(NamedTuple):
    """Static keyswitch configuration."""
    base: int
    decomp_length: int
    log2_base: int
    input_size: int
    output_size: int


def lwe_encrypt(messages, key, noises_a, noises_b, noise: float):
    """b = message + noise_b + a.s; a = uniform noise (all int32 tensors).

    Reference kernel: ``nufhe/lwe_gpu.py:186-243``.
    """
    a = noises_a.to(torch.int32)
    dot = (a.to(torch.int64) * key.to(torch.int64)).sum(-1)
    b = wrap_i32(messages.to(torch.int64) + noises_b.to(torch.int64) + dot)
    cv = torch.full(b.shape, noise**2, dtype=torch.float32, device=b.device)
    return a, b, cv


def lwe_decrypt_phase(a, b, key):
    """phase = b - a.s.  Reference kernel: ``nufhe/lwe_gpu.py:246-284``."""
    dot = (a.to(torch.int64) * key.to(torch.int64)).sum(-1)
    return wrap_i32(b.to(torch.int64) - dot)


def lwe_linear(source, p, add_to=None):
    """result (+)= p * source, on (a, b, cv) triples.

    Reference kernel: ``nufhe/lwe_gpu.py:287-316``.
    """
    sa, sb, scv = source
    ra = sa.to(torch.int64) * int(p)
    rb = sb.to(torch.int64) * int(p)
    rcv = torch.tensor(float(p), dtype=torch.float32) ** 2 * scv
    if add_to is not None:
        aa, ab, acv = add_to
        ra, rb, rcv = aa.to(torch.int64) + ra, ab.to(torch.int64) + rb, acv + rcv
    return wrap_i32(ra), wrap_i32(rb), rcv.to(torch.float32)


def lwe_noiseless_trivial(mus, lwe_size: int):
    """(0, mu).  Reference kernel: ``nufhe/lwe_gpu.py:319-344``."""
    mus = mus.to(torch.int32)
    a = torch.zeros(mus.shape + (lwe_size,), dtype=torch.int32, device=mus.device)
    cv = torch.zeros(mus.shape, dtype=torch.float32, device=mus.device)
    return a, mus, cv


def keyswitch_digits(source_a, decomp_length: int, log2_base: int):
    """aijs = ((a + prec_offset) >> (32 - (j+1)*log2_base)) & (base-1):
    (..., in_size) int32 -> (..., in_size, decomp_length) int32, the digits
    of the keyswitch (``nufhe_tpu/ops/lwe.py::keyswitch_digits``; K2 and
    its plain version compute them in their own row order,
    ``ops/keyswitch.keyswitch_digits``).

    Reference: ``nufhe/lwe_gpu.mako:66-93`` semantics (arithmetic shifts).
    """
    prec_offset = 2**(32 - (1 + log2_base * decomp_length))
    shifts = torch.tensor([32 - j * log2_base
                           for j in range(1, decomp_length + 1)],
                          device=source_a.device)
    shifted = wrap_i32(source_a.to(torch.int64)[..., None] + prec_offset)
    return ((shifted.to(torch.int64) >> shifts)
            & (2**log2_base - 1)).to(torch.int32)


KS_LIMB_BITS = 8
KS_LIMBS = 4


def ks_n_pad(output_size):
    """Columns of the packed key: the out 'a' columns, the 'b' column and
    the count marker (column out + 1), rounded up to 128."""
    return -(-(output_size + 2) // 128) * 128


def _ks_limbs(v):
    """The KS_LIMBS balanced radix-2^8 limbs of int64 values (numpy arrays
    or tensors), each in [-128, 127]."""
    limbs = []
    for _ in range(KS_LIMBS):
        l0 = ((v + 128) & 255) - 128
        limbs.append(l0)
        v = (v - l0) >> KS_LIMB_BITS
    return limbs


def _ks_pack_device(ks_a, ks_b, device):
    """The packing of :func:`prepare_keyswitch_device` in torch, on
    ``device`` (the JAX package's ``_ks_pack_device``); digits 0..3 of an
    int32 value depend only on its low 32 bits, so it equals the numpy
    branch bit for bit."""
    ks_a, ks_b = to_device(ks_a, device), to_device(ks_b, device)
    input_size, decomp_length, base, output_size = ks_a.shape
    rows = input_size * decomp_length
    ab = torch.cat([ks_a, ks_b[..., None]], dim=-1)         # (in, l, base, out+1)
    ab = ab.permute(2, 1, 0, 3).reshape(base, rows, output_size + 1)[1:]
    padded = torch.zeros((base - 1, KS_LIMBS, rows, ks_n_pad(output_size)),
                         dtype=torch.int8, device=device)
    padded[..., :output_size + 1] = torch.stack(
        _ks_limbs(ab.to(torch.int64)), dim=1)
    padded[:, 0, :, output_size + 1] = 1
    return padded


def prepare_keyswitch_device(ks_a, ks_b, ks_cv, log2_base: int, device):
    """Pack the keyswitch key into K2's operand, the JAX package's
    ``ab_limbs`` bit for bit (``nufhe_tpu/ops/lwe.py::
    prepare_keyswitch_device``), where it is to live: tensor tables
    (``ops/keygen.make_keyswitch_key_device``) are packed on ``device`` with
    no host round trip; numpy tables for a CUDA device are uploaded as they
    are (the same bytes as the packed int8 form) and packed there; numpy
    tables for the CPU are packed by the numpy oracle.

    :param ks_a: (in_size, l, base, out) int32 numpy or tensor; ``ks_b``:
        (in_size, l, base), the same kind; ``ks_cv``: (in_size, l, base)
        float32 numpy.
    :returns: ``(arrays, meta)``: ``arrays['ab_limbs']`` is the
        (base-1, KS_LIMBS, rows, n_pad) int8 tensor: for each nonzero digit
        value v, the [a | b] entries in l-major row order (r = j * in_size
        + i) split into balanced radix-2^8 limbs, zero-padded to
        :func:`ks_n_pad` columns, with a 1 in column out + 1 of limb plane 0
        (the nonzero-digit count rides the same sums).  Digit 0's entries
        are the trivial zero encryption and are dropped.
        ``arrays['cv_scale']`` is the variance of one nonzero-digit entry.
    """
    ks_cv = np.asarray(ks_cv)
    input_size, decomp_length, base, output_size = ks_a.shape
    if log2_base >= 8:
        raise ValueError("ks_log2_base must be < 8, got %d" % log2_base)
    if base != 2 ** log2_base:
        raise ValueError("key has base %d, log2_base is %d" % (base, log2_base))

    # the count column stands in for the per-entry variance sum, which holds
    # only while every nonzero-digit entry has the same variance
    nz = ks_cv[:, :, 1:]
    cv_scale = float(nz.max())
    if cv_scale > 0 and nz.min() < cv_scale * (1 - 1e-6):
        raise ValueError(
            "keyswitch cv table is not constant on nonzero digits; the "
            "count-based cv does not apply")

    if torch.is_tensor(ks_a) or torch.device(device).type != 'cpu':
        ab_limbs = _ks_pack_device(ks_a, ks_b, device)
    else:
        ks_a, ks_b = np.asarray(ks_a), np.asarray(ks_b)
        rows = input_size * decomp_length
        ab = np.concatenate([ks_a, ks_b[..., None]], axis=-1)
        ab = ab.transpose(2, 1, 0, 3).reshape(base, rows, output_size + 1)[1:]
        padded = np.zeros((base - 1, KS_LIMBS, rows, ks_n_pad(output_size)),
                          np.int8)
        padded[..., :output_size + 1] = np.stack(
            _ks_limbs(ab.astype(np.int64)), axis=1)
        padded[:, 0, :, output_size + 1] = 1
        ab_limbs = torch.from_numpy(padded).to(device)
    arrays = dict(ab_limbs=ab_limbs, cv_scale=cv_scale)
    meta = KeyswitchMeta(base=base, decomp_length=decomp_length,
                         log2_base=log2_base, input_size=input_size,
                         output_size=output_size)
    return arrays, meta


@spanned("nufhe.keyswitch")
def lwe_keyswitch(ks_arrays, ks_meta: KeyswitchMeta, source_a, source_b,
                  source_cv=None):
    """result = (0, b) - sum_{l,j} KS[l, j, digit_{l,j}].

    :param source_a: (batch..., input_size) int32; ``source_b``: (batch...,).
    :param source_cv: optional (batch...,) input variances, added to the
        keyswitch noise (the reference drops them, ``nufhe/lwe.py:319``).
    :returns: (a, b, cv) in the output LWE space.
    """
    out_size = ks_meta.output_size
    batch_shape = source_b.shape
    a2 = source_a.reshape(-1, ks_meta.input_size).contiguous()
    totals = ks.keyswitch_totals(
        a2, ks_arrays["ab_limbs"], out_size=out_size,
        decomp_length=ks_meta.decomp_length, log2_base=ks_meta.log2_base)
    result_a = wrap_i32(-totals[:, :out_size].to(torch.int64))
    result_b = wrap_i32(source_b.reshape(-1).to(torch.int64)
                        - totals[:, out_size].to(torch.int64))
    result_cv = (totals[:, out_size + 1].to(torch.float32)
                 * torch.tensor(ks_arrays["cv_scale"], dtype=torch.float32))
    result_cv = result_cv.reshape(batch_shape)
    if source_cv is not None:
        result_cv = result_cv + source_cv.to(torch.float32)
    return (result_a.reshape(batch_shape + (out_size,)),
            result_b.reshape(batch_shape), result_cv)
