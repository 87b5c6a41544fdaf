"""Host/oracle implementation of the exact negacyclic polynomial product.

Numpy mirror of ``nufhe_tpu/ref/transform_ref.py``: the exact product and
the rounded-key ('FFT' mode) key sides and two-sided S'-multiplication.
Every negacyclic product in TFHE is the exact integer product truncated
mod 2^32.  It is computed with a Nussbaumer polynomial transform over
Z/2^64 (numpy uint64 wraparound):

  N = 1024 = m * r with m = r = 32, L = 2m = 64.
  Strided split  A_j(Y) = sum_i a[i*m + j] Y^i  in  S' = Z[Y]/(Y^r + 1);
  the product lives in S'[X]/(X^m - Y).  Y is a primitive L-th root of unity
  in S', so an L-point DFT over S' (twiddles = negacyclic shifts, *no
  multiplications*) diagonalizes the product; pointwise multiplication in S'
  is a 32-length negacyclic convolution (the only real multiplies); the
  unscaled inverse + fold yields ``L * c``, and ``(>> 6) mod 2^32`` recovers
  the exact product mod 2^32.

Only bits 0..37 of ``L * c`` matter, so every operand may be reduced mod
2^38 first: ``ops/transform.py`` keeps the bootstrap key that way.
"""

import numpy as np

N = 1024
M = 32          # X-direction block size; product ring S'[X]/(X^m - Y)
R = 32          # Y-direction length; S' = Z[Y]/(Y^R + 1)
L = 2 * M       # polynomial transform length (zero-padded from M)
LOG_L = 6
INV_SHIFT = 6   # inverse transform is unscaled by L = 2^6

_U64 = np.uint64


def to_u64(a):
    """Lift a signed integer array to its residue mod 2^64."""
    return np.asarray(a).astype(np.int64).astype(np.uint64)


def u64_to_i32(v):
    """Truncate residues mod 2^64 to Torus32 (mod 2^32, two's complement)."""
    return (v & _U64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def yshift(p, e):
    """Multiply by Y^e in S' = Z[Y]/(Y^R + 1); p: (..., R), any wrapping dtype.

    Pure data movement: rotate right by e with sign flip on wraparound.
    """
    e = e % (2 * R)
    neg, e = e >= R, e % R
    if e == 0:
        out = p if not neg else -p
        return out.copy() if out is p else out
    out = np.concatenate([-p[..., R - e:], p[..., :R - e]], axis=-1)
    return -out if neg else out


def bit_reverse(n_bits):
    """The bit-reversal permutation of ``range(2**n_bits)``."""
    idx = np.arange(1 << n_bits)
    rev = np.zeros(1 << n_bits, np.int64)
    for bit in range(n_bits):
        rev |= ((idx >> bit) & 1) << (n_bits - 1 - bit)
    return rev


def _dft_l(data, inverse):
    """L-point iterative Cooley-Tukey DFT over S' with root Y.

    data: (..., L, R).  Twiddle multiplications are ``yshift``s.  No final
    scaling (caller handles 1/L).
    """
    base = -1 if inverse else 1  # root exponent: Y or Y^-1
    data = data[..., bit_reverse(LOG_L), :]

    for stage in range(LOG_L):
        mmax = 1 << stage
        istep = mmax * 2
        for m in range(mmax):
            tw = base * m * (1 << (LOG_L - stage - 1))
            i = np.arange(m, L, istep)
            j = i + mmax
            temp = yshift(data[..., j, :], tw)
            data[..., j, :] = data[..., i, :] - temp
            data[..., i, :] = data[..., i, :] + temp
    return data


def forward(a):
    """Forward Nussbaumer transform: (..., N) signed ints -> (..., L, R) u64.

    a-hat[t] = sum_{j<m} Y^{j t} A_j,  A_j(Y) = sum_i a[i*m + j] Y^i.
    """
    a = to_u64(a)
    blocks = a.reshape(a.shape[:-1] + (R, M))          # [i, j]
    A = np.swapaxes(blocks, -1, -2)                    # [j, i] -> A_j vectors
    padded = np.concatenate(
        [A, np.zeros(A.shape[:-2] + (L - M, R), _U64)], axis=-2)
    return _dft_l(padded, inverse=False)


def smul(p, q):
    """Multiplication in S': negacyclic convolution of R-vectors (u64 wrap)."""
    out = np.zeros(np.broadcast_shapes(p.shape, q.shape), _U64)
    for k in range(R):
        u = np.arange(k + 1)
        out[..., k] = (p[..., u] * q[..., k - u]).sum(-1)
        u2 = np.arange(k + 1, R)
        if len(u2):
            out[..., k] -= (p[..., u2] * q[..., k + R - u2]).sum(-1)
    return out


def smul_sided(p, qpos, qneg):
    """Two-sided S'-multiplication (the rounded-key engine's semantics):
    the negacyclic wrap uses ``qneg`` (an independent rounding of -q mod
    2^38) instead of negating ``qpos``.

    out[k] = sum_{u<=k} p[u] qpos[k-u] + sum_{u>k} p[u] qneg[k-u+R]
    (u64 wraparound)."""
    out = np.zeros(np.broadcast_shapes(p.shape, qpos.shape), _U64)
    for k in range(R):
        u = np.arange(k + 1)
        out[..., k] = (p[..., u] * qpos[..., k - u]).sum(-1)
        u2 = np.arange(k + 1, R)
        if len(u2):
            out[..., k] += (p[..., u2] * qneg[..., k + R - u2]).sum(-1)
    return out


def rounded_key_sides(bhat_u64):
    """Rounded-key ('FFT') mode key sides: the mod-2^38 residues of +v and
    of -v mod 2^38, each centred and rounded to vhi = round(v/64) =
    (v + 32) >> 6 on its own, as u64 wraparound values.  The two sides
    differ from plain negation exactly where v = 32 mod 64."""
    r = bhat_u64 & np.uint64(2**38 - 1)
    v = r.astype(np.int64)
    v = v - ((v >> 37) << 38)
    w = ((np.uint64(2**38) - r) & np.uint64(2**38 - 1)).astype(np.int64)
    w = w - ((w >> 37) << 38)
    return ((v + 32) >> 6).astype(_U64), ((w + 32) >> 6).astype(_U64)


def inverse_unscaled(chat):
    """Unscaled inverse + fold: (..., L, R) -> (..., N) holding ``L * c``."""
    p = _dft_l(chat.copy(), inverse=True)
    folded = p[..., :M, :] + yshift(p[..., M:, :], 1)   # C_j = P_j + Y P_{j+m}
    # c[i*m + j] = C_j[i]
    return np.swapaxes(folded, -1, -2).reshape(chat.shape[:-2] + (N,))


def transformed_mul_accum(ahat_list, bhat_list):
    """sum_k  ahat_k (*) bhat_k  in the transform domain (u64)."""
    acc = None
    for ah, bh in zip(ahat_list, bhat_list):
        term = smul(ah, bh)
        acc = term if acc is None else acc + term
    return acc


def negacyclic_mul(a, b):
    """Exact negacyclic product of int32 polynomials, truncated mod 2^32."""
    v = inverse_unscaled(smul(forward(a), forward(b)))
    return u64_to_i32(v >> _U64(INV_SHIFT))


def negacyclic_mul_accum(a_polys, b_polys):
    """Exact ``sum_k a_k * b_k mod (X^N+1, 2^32)``; the external-product MAC.

    a_polys/b_polys: sequences of (..., N) int arrays (broadcastable batches).
    """
    acc = transformed_mul_accum(
        [forward(a) for a in a_polys], [forward(b) for b in b_polys])
    return u64_to_i32(inverse_unscaled(acc) >> _U64(INV_SHIFT))


def schoolbook_negacyclic(a, b):
    """O(N^2) oracle: negacyclic product mod 2^32 via u64 wraparound.

    c[k] = sum_{j<=k} a_j b_{k-j} - sum_{j>k} a_j b_{k+N-j}  (mod 2^32).
    """
    a = to_u64(a)
    b = to_u64(b)
    n = a.shape[-1]
    # negacyclic matrix of b: mat[j, k] = +-b[(k - j) mod n]
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    idx = (k - j) % n
    sgn = k >= j
    mat = np.where(sgn, b[..., idx], -b[..., idx])
    c = np.einsum('...j,...jk->...k', a, mat)
    return u64_to_i32(c)
