"""TGSW operations in PyTorch (``nufhe_tpu/ops/tgsw.py``'s counterpart):
the gadget decomposition, the bootstrap key in the TPU's MAC-operand form
(the lanes engine's key), and the transformed external product."""

import numpy as np
import torch

from ..utils import to_device
from . import flat_engine as fe
from . import transform as tf


def tgsw_polynomial_decomp(sample, offset, decomp_length: int, log2_base: int):
    """Gadget decomposition into signed digits in [-base/2, base/2).
    Reference: ``nufhe/tgsw_gpu.py:31-54``.

    :param sample: (..., mask_size+1, N) int32.
    :returns: (..., mask_size+1, decomp_length, N) int32.
    """
    shifts = torch.tensor([32 - (d + 1) * log2_base
                           for d in range(decomp_length)],
                          device=sample.device)[:, None]
    shifted = (sample[..., None, :].to(torch.int64) + int(offset)) & 0xFFFFFFFF
    digits = ((shifted >> shifts) & (2**log2_base - 1)) - 2**(log2_base - 1)
    return digits.to(torch.int32)


def bootstrap_key_limbs_host(bk_coeff, exact=True):
    """Host part of the key preparation: the exact forward transform,
    reduced mod 2^38 and split into two-sided int8 limbs
    (``ops/transform.key_limbs_host``), in C++ (``native.py``; the numpy
    oracle where there is no compiler).

    :param bk_coeff: (n, mask1, l, mask1, N) int32 numpy array.
    :param exact: False for the rounded-key ('FFT') form.
    :returns: (n, G, O, L, R, KL, 2) int8 numpy array.
    """
    from .. import native
    bk_coeff = np.asarray(bk_coeff)
    n_rows, mask1, decomp, mask1_o, poly_n = bk_coeff.shape
    limbs = native.bootstrap_key_limbs(bk_coeff.reshape(-1, poly_n), exact)
    return limbs.reshape(n_rows, mask1 * decomp, mask1_o, tf.L, tf.R,
                         limbs.shape[-2], 2)


def expand_bootstrap_key_device(limbs, device, chunk: int = 125):
    """Two-sided limbs -> the MAC operand on ``device``, ``chunk`` rows at a
    time into the preallocated result, so that the intermediates stay about
    the size of one chunk's output.

    :param limbs: (n, G, O, L, R, KL, 2) int8 (numpy or tensor, any device).
    :returns: (n, L, C, Q) int8 tensor, C = G*2R, Q = 5*O*R (exact) or
        4*O*R (rounded).
    """
    limbs = to_device(limbs, device)  # one upload; the chunks slice it there
    n, g, o_sz = limbs.shape[:3]
    groups = limbs.shape[-2]
    out = torch.empty((n, tf.L, g * tf.ACC_LIMBS * tf.R, groups * o_sz * tf.R),
                      dtype=torch.int8, device=device)
    for i in range(0, n, chunk):
        out[i:i + chunk] = tf.build_mac_rhs(limbs[i:i + chunk])
    return out


def expand_bootstrap_key_device_compact(pos, delta, device, chunk: int = 125):
    """The one-sided (compact) form -> the MAC operand on ``device``: one
    upload of half the two-sided form's bytes, the -v side derived there
    (``ops/transform.two_sided_limbs_device``), then
    :func:`expand_bootstrap_key_device`.

    :param pos: (n, G, O, L, R, KL) int8, numpy or tensor.
    :param delta: (n, G, O, L, R) 0/1 bits (rounded form) or None.
    """
    delta = None if delta is None else to_device(delta, device)
    return expand_bootstrap_key_device(
        tf.two_sided_limbs_device(to_device(pos, device), delta), device,
        chunk=chunk)


def prepare_bootstrap_key_device(bk_coeff, device, chunk: int = 50,
                                 exact=True):
    """The coefficient-domain bootstrap key as the lanes engine's key on
    ``device``: host transform and limb split, then the expansion there.

    :param bk_coeff: (n, mask1, l, mask1, N) int32 numpy array.
    :returns: see :func:`expand_bootstrap_key_device`.
    """
    return expand_bootstrap_key_device(
        bootstrap_key_limbs_host(bk_coeff, exact=exact), device, chunk=chunk)


def tgsw_transformed_external_mul(accum_a, bk_dev, bk_row_idx, offset,
                                  decomp_length: int, log2_base: int,
                                  group=None):
    """One external product, BK_row (x) decomp(accum), through the lanes
    engine (``ops/flat_engine.external_mul_flat``).
    Reference: ``nufhe/tgsw_gpu.py:110-169``.

    :param accum_a: (batch..., mask_size+1, N) int32.
    :param bk_dev: output of :func:`prepare_bootstrap_key_device`; under
        ``group``, this rank's C-slice of whole g-blocks of it.
    :param group: a ``torch.distributed`` process group for the
        tensor-parallel external product (the JAX package's ``axis_name``):
        each rank MACs its g-block slice and the channels are summed over
        the group before the inverse transform.
    :returns: (batch..., mask_size+1, N) int32.
    """
    mask1 = accum_a.shape[-2]
    lead = tuple(accum_a.shape[:-2])
    sample_q = fe.q_from_n(accum_a).reshape(-1, mask1 * fe.N)
    out = fe.external_mul_flat(sample_q, bk_dev[int(bk_row_idx)], mask1=mask1,
                               decomp_length=decomp_length,
                               log2_base=log2_base, offset=int(offset),
                               group=group)
    return fe.n_from_q(out.reshape(lead + (mask1, fe.N)))
