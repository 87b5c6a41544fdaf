"""Key generation on the device (``nufhe_tpu/ops/keygen.py``'s
counterpart), as plain PyTorch on CUDA or CPU tensors.

The reference builds both cloud-key halves on the GPU: ``TLweEncryptZero``
(``nufhe/tlwe_gpu.py:111-196``) and ``MakeLweKeyswitchKey``
(``nufhe/lwe_gpu.py:63-124``).  Here:

- the binary-key negacyclic products of TLWE encrypt-zero are ONE int8
  product of the noise's balanced radix-2^8 digit planes with a signed
  circulant matrix of the key, accumulated in int32 (``torch._int_mm``):
  exact, since |products| <= 128 and the K*N-term sums stay below 2^31;
- the keyswitch-key body is a masked int64 sum over the binary key;
- the bootstrap key's forward transform mod 2^38 (the stored limb form)
  runs as five exact digit-plane forwards (``ops/transform.forward_i32``),
  assembled into the one-sided A/B limb split mod 2^32.

Every function is bit-equal to the host oracles and to the JAX package's
device functions.  The RNG stays on the host (``nufhe/random_numbers.py:
18-27``): the caller draws the noise in the reference's order and uploads
it once, so host and device keygen give the same keys.  Sums that could
pass 2^31 are taken in int64 and wrapped with ``numeric.wrap_i32``.
"""

import numpy as np
import torch

from ..numeric import wrap_i32
from . import transform as tf

N = tf.N


# --- binary negacyclic products (TLWE encrypt-zero) ---

def negacyclic_key_matrix(key):
    """Host: binary key polynomials -> the signed circulant product operand.

    W[k, m, c] = key[k, (c - m) % N] * (+1 if m <= c else -1), so that the
    negacyclic product (key_k * x)[c] = sum_m x[m] * W[k, m, c].

    :param key: (mask_size, N) 0/1 int numpy array.
    :returns: (mask_size, N, N) int8 numpy array (1 MB a polynomial).
    """
    key = np.asarray(key, np.int64)
    n = key.shape[1]
    idx = np.arange(n)
    gather = (idx[None, :] - idx[:, None]) % n              # (m, c)
    sign = np.where(idx[:, None] <= idx[None, :], 1, -1)
    return (key[:, gather] * sign[None]).astype(np.int8)


def _digit_planes(x, planes=4, with_rem=False):
    """Balanced radix-2^8 digit planes of int32 values (plus the {-1, 0, 1}
    remainder plane when ``with_rem``): x = sum_d 2^(8d) d_d + 2^32 rem
    exactly over Z for the centred int32 value of x.

    Carry form (d = low byte - 256 * carry; v' = (v >> 8) + carry): the
    naive (v - d) >> 8 overflows int32 at v = 2^31 - 1 (d = -1), which
    corrupts the remainder plane.  Right shifts of negative int32 values
    are arithmetic in torch, as in the JAX package."""
    digs = []
    v = x.to(torch.int32)
    for _ in range(planes):
        low = v & 255
        c = (low >= 128).to(torch.int32)
        digs.append(low - (c << 8))
        v = (v >> 8) + c
    if with_rem:
        digs.append(v)
    return digs


def _int8_matmul(a, b):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32, exact, as ``torch._int_mm``.
    On CUDA it needs more than 16 rows: a shorter ``a`` is padded with
    zero rows and the result cut back."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((24 - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b.contiguous())[:m]


def binary_negacyclic_mul_device(w_dev, x):
    """sum_k key_k * x_k (negacyclic, exact mod 2^32) as one int8 product.

    :param w_dev: (mask_size, N, N) int8 tensor (``negacyclic_key_matrix``).
    :param x: (..., mask_size, N) int32 tensor on ``w_dev``'s device.
    :returns: (..., N) int32.
    """
    mask_size = w_dev.shape[0]
    lead = tuple(x.shape[:-2])
    xf = x.reshape(-1, mask_size, N)
    digs = torch.stack(_digit_planes(xf), dim=1).to(torch.int8)   # (B, 4, K, N)
    out = _int8_matmul(digs.reshape(-1, mask_size * N),
                       w_dev.reshape(mask_size * N, N))
    out = out.reshape(-1, 4, N).to(torch.int64)
    total = (out[:, 0] + (out[:, 1] << 8) + (out[:, 2] << 16)
             + (out[:, 3] << 24))
    return wrap_i32(total).reshape(lead + (N,))


def tlwe_encrypt_zero_device(w_dev, noises1, noises2):
    """Homogeneous TLWE samples: b = noise2 + sum_k key_k * mask_noise_k;
    ``ref/tlwe_ref.tlwe_encrypt_zero`` on tensors (bit-equal).

    :param noises1: (..., mask_size, N) int32 uniform mask noise.
    :param noises2: (..., N) int32 gaussian body noise.
    :returns: (..., mask_size+1, N) int32.
    """
    noises1 = noises1.to(torch.int32)
    body = wrap_i32(noises2.to(torch.int64)
                    + binary_negacyclic_mul_device(w_dev, noises1))
    return torch.cat([noises1, body[..., None, :]], dim=-2)


def tgsw_add_message_device(a, messages, base_powers):
    """result += message * H (the gadget on the diagonal);
    ``ref/tgsw_ref.tgsw_add_message`` on tensors (reference kernel:
    ``nufhe/tgsw_gpu.py:172-205``).

    :param a: (n, mask1, l, mask1, N) int32 TGSW samples.
    :param messages: (n,) int tensor (the LWE key bits).
    :param base_powers: (l,) gadget constants (host values).
    :returns: a new (n, mask1, l, mask1, N) int32 tensor.
    """
    bp = torch.from_numpy(np.asarray(base_powers, np.int64)).to(a.device)
    inc = wrap_i32(messages.to(torch.int64)[:, None] * bp)      # (n, l)
    a = a.clone()
    for o in range(a.shape[1]):
        a[:, o, :, o, 0] = wrap_i32(a[:, o, :, o, 0].to(torch.int64) + inc)
    return a


def bootstrap_key_device(w_dev, lwe_key_dev, noises1, noises2, base_powers):
    """The bootstrap key's coefficient-domain samples on the device: TGSW
    encrypt-zero of every row, then the gadget add.

    :param lwe_key_dev: (n,) int tensor, the LWE key bits.
    :param noises1: (n, mask1, l, mask_size, N) int32 tensor.
    :param noises2: (n, mask1, l, N) int32 tensor.
    :returns: (n, mask1, l, mask1, N) int32 on ``w_dev``'s device.
    """
    a = tlwe_encrypt_zero_device(w_dev, noises1, noises2)
    return tgsw_add_message_device(a, lwe_key_dev, base_powers)


# --- keyswitch key ---

def make_keyswitch_key_device(in_key, out_key, noises_a, noises_b,
                              decomp_length: int, log2_base: int):
    """Keyswitch key on the device: encryptions of
    ``s'_i * h * 2^(32-(j+1)*log2_base)`` under the output key;
    ``ref/lwe_ref.make_keyswitch_key`` on tensors (reference kernel:
    ``nufhe/lwe_gpu.py:63-124``).  The digit-0 slice stays the trivial
    zero encryption.

    :param in_key: (input_size,) 0/1 int tensor; ``out_key``: (output_size,).
    :param noises_a: (input_size, l, base-1, output_size) int32 tensor.
    :param noises_b: (input_size, l, base-1) int32 tensor.
    :returns: (ks_a, ks_b) int32 of shapes (input_size, l, base,
        output_size) and (input_size, l, base), on ``noises_a``'s device.
    """
    dev = noises_a.device
    base = noises_a.shape[2] + 1
    hs = torch.arange(1, base, dtype=torch.int64, device=dev)
    powers = torch.tensor([(1 << (32 - (j + 1) * log2_base)) & 0xFFFFFFFF
                           for j in range(decomp_length)],
                          dtype=torch.int64, device=dev)
    messages = (in_key.to(torch.int64)[:, None, None] * hs[None, None, :]
                * powers[None, :, None])
    # the binary key masks the columns: an int32 product, an int64 sum
    dot = (noises_a * out_key.to(torch.int32)).sum(-1, dtype=torch.int64)
    body = wrap_i32(messages + noises_b.to(torch.int64) + dot)
    ks_a = torch.cat([torch.zeros_like(noises_a[:, :, :1]), noises_a], dim=2)
    ks_b = torch.cat([torch.zeros_like(body[:, :, :1]), body], dim=2)
    return ks_a, ks_b


# --- the bootstrap key's transform, the stored limb form ---

def _vhi_limbs(vhi):
    """Balanced radix-2^8 int8 digits of int32 values (mod-2^32 semantics:
    the top digit wraps, as the host split's digits 0..3 do)."""
    return torch.stack([d.to(torch.int8) for d in _digit_planes(vhi)], dim=-1)


def _split_planes(chunk_flat, exact):
    """(B, N) int32 polynomials -> the one-sided A/B limb split of their
    exact forward transforms mod 2^38 (see :func:`bootstrap_key_limbs_device`).
    The five digit planes go through one batched forward."""
    planes = torch.stack(_digit_planes(chunk_flat, with_rem=True))  # (5, B, N)
    fs = tf.forward_i32(planes).to(torch.int64)                      # (5, B, L, R)
    f0 = fs[0]
    tail = (fs[1] << 2) + (fs[2] << 10) + (fs[3] << 18) + (fs[4] << 26)
    if exact:
        vlo = ((f0 + 32) & 63) - 32
        vhi = wrap_i32(((f0 - vlo) >> 6) + tail)
        pos = torch.cat([vlo[..., None].to(torch.int8), _vhi_limbs(vhi)], -1)
        return pos, None
    q = wrap_i32(((f0 + 32) >> 6) + tail)
    delta = ((f0 & 63) == 32).to(torch.uint8)
    return _vhi_limbs(q), delta


def bootstrap_key_limbs_device(bk_coeff, exact=True, chunk=2048):
    """The exact forward transform mod 2^38 of every bootstrap-key
    polynomial, A/B-limb-split, ONE-SIDED (the +v limbs; the -v side is
    derived at expansion by ``ops/transform.two_sided_limbs_device``), on
    ``bk_coeff``'s device.  Equal to ``ops/transform.one_sided_limbs_host``
    of ``ops/tgsw.bootstrap_key_limbs_host``.

    Each int32 polynomial is split into four balanced radix-2^8 digit
    planes plus the {-1, 0} remainder plane (x = sum 2^(8d) d_d + 2^32 rem
    over Z); each plane's forward transform is exact (|values| <= 2^12);
    then, mod 2^38:
      vlo = balanced(f_0 mod 64)                  (2^8 = 0 mod 64)
      vhi = (f_0 - vlo) >> 6 + sum_{d>=1} f_d 2^(8d-6) + f_rem 2^26 mod 2^32
    Rounded ('FFT') form: q = (f_0 + 32) >> 6 + the same tail (the tail is
    a multiple of 64), delta bit = [f_0 = 32 mod 64].

    :param bk_coeff: (n, mask1, l, mask1, N) int32 tensor.
    :param chunk: polynomials a forward call (bounds the intermediates).
    :returns: (pos, delta): ``pos`` int8 (n, G, O, L, R, KL); ``delta``
        uint8 (n, G, O, L, R) (rounded form) or None (exact).
    """
    n_rows, mask1, decomp, mask1_o, poly_n = bk_coeff.shape
    flat = bk_coeff.reshape(-1, poly_n)
    parts = [_split_planes(flat[i:i + chunk], exact)
             for i in range(0, flat.shape[0], chunk)]
    shape = (n_rows, mask1 * decomp, mask1_o, tf.L, tf.R)
    pos = torch.cat([p for p, _ in parts])
    pos = pos.reshape(shape + (pos.shape[-1],))
    if exact:
        return pos, None
    return pos, torch.cat([d for _, d in parts]).reshape(shape)
