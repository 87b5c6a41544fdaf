"""Plain PyTorch TFHE gate bootstrapping: the benchmark's reference.

It follows nuFHE's gate (``nufhe/gates.py``, ``nufhe/bootstrap.py``): a
linear combination of the inputs, a modulus switch to [0, 2N), a test
vector, n CMUX steps ACC <- ACC + BK_i (x) [(X^{bara_i} - 1) ACC], sample
extraction and a keyswitch.  It imports torch alone, nothing of the
program, and takes the raw keys: the coefficient-domain bootstrap key and
the keyswitch tables.  Every integer is an int64 holding a Torus32 value.
The polynomial degree N, a power of two from 256 to 1024, and the mask
size k are read from the tensors.

The negacyclic products are those that define the two engine modes:

- 'NTT' is exact: each product is the integer product mod (X^N + 1, 2^32);
- 'FFT' is the rounded-key engine (``transform_type='FFT'``), defined at
  N = 1024 alone: the key is taken to the Nussbaumer domain over Z/2^38
  (N = 32 x 32, a 64-point transform over Z[Y]/(Y^32 + 1) with root Y),
  and each side of each residue, +v and -v, is rounded to round(v / 64)
  on its own; the wrap terms of the pointwise products read the -v side.

Both run through one Nussbaumer transform: N = M x R with R = 32 and
M = N / 32, an L = 2M point transform over Z[Y]/(Y^R + 1) with the root
Y^(R/M) of order L, written as matrices of small integers
(``forward_matrix``, ``inverse_matrix``) and applied with float64 matrix
products on limbs small enough that every sum is an exact integer below
2^53.  The exact mode is also the schoolbook product (``schoolbook``),
which the tests hold it against.
"""

import torch

R = 32            # Z[Y]/(Y^R + 1): a polynomial is N / R blocks of R
ROUNDED_N = 1024  # the one degree at which the 'FFT' rounding is defined
MASK32 = 0xFFFFFFFF
MASK38 = (1 << 38) - 1
LIMB = 13         # bits of a limb in the exact float64 products

# gate: (constant numerator, denominator, coefficient of a, of b)
GATES2 = {
    'nand': (1, 8, -1, -1), 'or': (1, 8, 1, 1), 'and': (-1, 8, 1, 1),
    'xor': (1, 4, 2, 2), 'xnor': (-1, 4, -2, -2), 'nor': (-1, 8, -1, -1),
    'andny': (-1, 8, -1, 1), 'andyn': (-1, 8, 1, -1),
    'orny': (1, 8, -1, 1), 'oryn': (1, 8, 1, -1),
}


def signed32(v):
    """A Python int reduced mod 2^32 into [-2^31, 2^31)."""
    v %= 2**32
    return v - 2**32 if v >= 2**31 else v


def t32(num, den):
    """``num / den`` of the torus as a Torus32 Python int."""
    return signed32((num % den) * (2**32 // den))


MU = t32(1, 8)


def wrap32(x):
    """An int64 tensor reduced mod 2^32 into [-2^31, 2^31)."""
    return ((x + 2**31) & MASK32) - 2**31


def _exact_mm(x, y):
    """x @ y for int64 tensors whose every partial sum is an integer below
    2^53 in magnitude, through float64."""
    return torch.matmul(x.double(), y.double()).round().long()


def _limbs(x, count=3):
    """``x`` as ``count`` limbs of LIMB bits, the last one signed:
    x = sum_i limb_i << (LIMB * i)."""
    out = []
    for _ in range(count - 1):
        out.append(x & ((1 << LIMB) - 1))
        x = x >> LIMB
    out.append(x)
    return out


def _from_limbs(parts):
    total = parts[0]
    for i, p in enumerate(parts[1:], 1):
        total = total + (p << (LIMB * i))
    return total


def transform_shape(n):
    """(M, L, shift) of the transform at degree ``n``: M = n / R blocks, an
    L = 2M point transform, and log2 L, the shift that undoes the scale of
    the unscaled inverse."""
    if n & (n - 1) or not 256 <= n <= 1024:
        raise ValueError("the reference takes N a power of two from 256 to "
                         "1024, not N = %d" % n)
    m = n // R
    return m, 2 * m, (2 * m).bit_length() - 1


def _check_rounded(n):
    if n != ROUNDED_N:
        raise ValueError("the rounded-key ('FFT') product is defined at N = "
                         "%d alone, not at N = %d" % (ROUNDED_N, n))


_MATRICES = {}


def forward_matrix(n, device):
    """(n, L*R) float64 of -1/0/1: the forward transform a -> a_hat,
    a_hat[t] = sum_j w^{jt} A_j with A_j(Y) = sum_i a[i*M + j] Y^i and the
    root w = Y^(R/M), as a_hat.flatten() = a @ F."""
    key = ('F', n, str(device))
    if key not in _MATRICES:
        m, l, _ = transform_shape(n)
        step = R // m
        i = torch.arange(R).view(R, 1, 1)
        j = torch.arange(m).view(1, m, 1)
        t = torch.arange(l).view(1, 1, l)
        e = (i + step * j * t) % (2 * R)          # Y^e, Y^R = -1
        sign = torch.where(e < R, 1, -1)
        rows = (i * m + j).expand(R, m, l).reshape(-1)
        cols = (t * R + e % R).reshape(-1)
        f = torch.zeros(n, l * R, dtype=torch.float64)
        f[rows, cols] = sign.reshape(-1).double()
        _MATRICES[key] = f.to(device)
    return _MATRICES[key]


def inverse_matrix(n, device):
    """(L*R, n) float64 in [-2, 2]: the unscaled inverse and fold, c_hat ->
    L * c: p_j = sum_t w^{-jt} c_hat[t], C_j = p_j + Y p_{j+M},
    c[i*M + j] = C_j[i]."""
    key = ('I', n, str(device))
    if key not in _MATRICES:
        m, l, _ = transform_shape(n)
        step = R // m
        t = torch.arange(l).view(l, 1, 1)
        k = torch.arange(R).view(1, R, 1)
        j = torch.arange(m).view(1, 1, m)
        inv = torch.zeros(l * R, n, dtype=torch.float64)
        for e in ((k - step * j * t) % (2 * R),
                  (k + 1 - step * (j + m) * t) % (2 * R)):
            sign = torch.where(e < R, 1, -1)
            rows = (t * R + k).expand(l, R, m).reshape(-1)
            cols = ((e % R) * m + j).reshape(-1)
            inv.index_put_((rows, cols), sign.reshape(-1).double(),
                           accumulate=True)
        _MATRICES[key] = inv.to(device)
    return _MATRICES[key]


def schoolbook(a, b):
    """Negacyclic product of two (N,) int64 polynomials mod 2^32, term by
    term: the tests' witness for the exact mode."""
    n = a.shape[-1]
    jj = torch.arange(n).view(n, 1)
    kk = torch.arange(n).view(1, n)
    mat = torch.where(kk >= jj, b[(kk - jj) % n], -b[(kk - jj) % n])
    return wrap32((a.view(n, 1) * mat).sum(0))


def _centred38(r):
    """Residues in [0, 2^38) to [-2^37, 2^37)."""
    return r - ((r >> 37) << 38)


def prepare_bootstrap_key(bk_coeff, exact):
    """The key the CMUX steps read, worked out from the raw key.

    :param bk_coeff: (n, k+1, l, k+1, N) int32 or int64: for key bit i and
        decomposition row (in, d), the TLWE sample of k+1 polynomials.
    :returns: (n, G, O, L, R, R) int64, G = (k+1) l rows, O = k+1 output
        polynomials: for each transform point t the R x R matrix T with
        out[k] = sum_u p[u] T[u, k] in Z[Y]/(Y^R + 1), the wrap terms
        (u > k) read the -v side.  Residues mod 2^38 (exact) or the
        rounded sides round(+-v / 64) ('FFT', N = 1024 alone).
    """
    n, k1, ll, o, n_poly = bk_coeff.shape
    _, l, _ = transform_shape(n_poly)
    if not exact:
        _check_rounded(n_poly)
    dev = bk_coeff.device
    v = _exact_mm(bk_coeff.long().reshape(-1, n_poly),
                  forward_matrix(n_poly, dev))
    r = v & MASK38
    pos, neg = _centred38(r), _centred38((-r) & MASK38)
    if not exact:
        pos, neg = (pos + 32) >> 6, (neg + 32) >> 6
    pos = pos.view(n, k1 * ll, o, l, R)
    neg = neg.view(n, k1 * ll, o, l, R)
    u = torch.arange(R, device=dev).view(R, 1)
    kk = torch.arange(R, device=dev).view(1, R)
    idx = ((kk - u) % R).reshape(-1)
    lower = (u <= kk).reshape(-1)
    out = torch.where(lower, pos[..., idx], neg[..., idx])
    return out.view(n, k1 * ll, o, l, R, R)


def decompose(acc, offset, l, log2_base):
    """Signed gadget digits of (B, k+1, N) Torus32 polynomials:
    (B, (k+1) l, N), row in * l + d, each in [-base/2, base/2)."""
    base = 1 << log2_base
    u = (acc + offset) & MASK32
    digits = [((u >> (32 - (d + 1) * log2_base)) & (base - 1)) - base // 2
              for d in range(l)]
    return torch.stack(digits, dim=2).reshape(acc.shape[0], -1,
                                              acc.shape[-1])


def external_product(digits, key_i, exact):
    """sum_g digits_g * key_i[g, o] for each output polynomial o: (B, G, N)
    digits, the step's key (G, O, L, R, R) -> (B, O, N) Torus32."""
    b, g, n = digits.shape
    _, l, shift = transform_shape(n)
    if not exact:
        _check_rounded(n)
    o = key_i.shape[1]
    dev = digits.device
    # |x| <= M base / 2 <= 2^14, so with 13-bit limbs of the key every sum
    # of the pointwise products is below g R 2^27 <= 9 x 2^32 (l <= 3, k <= 2)
    x = _exact_mm(digits.reshape(-1, n), forward_matrix(n, dev))
    x = x.view(b, g, l, R).permute(2, 0, 1, 3).reshape(l, b, g * R)
    t = key_i.permute(2, 0, 3, 1, 4).reshape(l, g * R, o * R)
    acc_hat = _from_limbs([_exact_mm(x, part) for part in _limbs(t)])
    acc_hat = acc_hat.view(l, b, o, R).permute(1, 2, 0, 3).reshape(b * o,
                                                                 l * R)
    c = _from_limbs([_exact_mm(part, inverse_matrix(n, dev))
                     for part in _limbs(acc_hat & MASK38)])
    # L c mod 2^38 over L gives c mod 2^(38 - log2 L), which holds c mod 2^32
    c = ((c & MASK38) >> shift) if exact else c
    return wrap32(c).view(b, o, n)


def rotate(acc, powers):
    """X^p acc mod (X^N + 1) for each row's p in [0, 2N): (B, C, N)."""
    n = acc.shape[-1]
    p = powers.long().view(-1, 1, 1)
    src = (torch.arange(n, device=acc.device).view(1, 1, n) - p) % (2 * n)
    out = torch.gather(acc, 2, (src % n).expand(acc.shape))
    return torch.where(src >= n, -out, out)


def modswitch(x, m):
    """Torus32 to the nearest of m points, as integers in [0, m)."""
    interval = 2**32 // m
    return (((x & MASK32) + interval // 2) & MASK32) // interval


def extract(acc):
    """The LWE sample at coefficient 0 of (B, k+1, N) TLWE samples."""
    mask = acc[:, :-1]
    a = torch.cat([mask[..., :1], -torch.flip(mask[..., 1:], (-1,))], -1)
    return wrap32(a.reshape(acc.shape[0], -1)), acc[:, -1, 0]


class Keys:
    """The raw cloud key with the reference's own preparation of it."""

    def __init__(self, cfg, bk_coeff, ks_a, ks_b, exact=None):
        self.cfg = cfg
        self.exact = (cfg['transform_type'] != 'FFT') if exact is None \
            else exact
        self.bk = prepare_bootstrap_key(bk_coeff, self.exact)
        l, lb = cfg['bs_decomp_length'], cfg['bs_log2_base']
        powers = [2**(32 - (d + 1) * lb) for d in range(l)]
        self.offset = signed32(sum(powers) * (2**lb // 2))
        # (in, t, base, out + 1): [a | b] of every keyswitch entry
        self.ks = torch.cat([ks_a.long(), ks_b.long()[..., None]], -1)


def blind_rotate(keys, acc, bara):
    cfg = keys.cfg
    for i in range(bara.shape[1]):
        shifted = wrap32(rotate(acc, bara[:, i]) - acc)
        digits = decompose(shifted, keys.offset, cfg['bs_decomp_length'],
                           cfg['bs_log2_base'])
        acc = wrap32(acc + external_product(digits, keys.bk[i], keys.exact))
    return acc


def keyswitch(keys, a, b):
    """(0, b) - sum_{i,j} KS[i, j, digit_ij(a)]: (B, kN), (B,) ->
    (B, n), (B,)."""
    cfg = keys.cfg
    t, lb = cfg['ks_decomp_length'], cfg['ks_log2_base']
    base = 1 << lb
    u = (a + 2**(32 - (1 + lb * t))) & MASK32
    digits = torch.stack([(u >> (32 - (j + 1) * lb)) & (base - 1)
                          for j in range(t)], -1).reshape(a.shape[0], -1)
    total = 0
    for v in range(base):
        onehot = (digits == v).long()
        table = keys.ks[:, :, v].reshape(onehot.shape[1], -1)
        lo, hi = table & 0xFFFF, table >> 16
        total = total + _exact_mm(onehot, lo) + (_exact_mm(onehot, hi) << 16)
    out = total.shape[1] - 1
    return wrap32(-total[:, :out]), wrap32(b - total[:, out])


def bootstrap(keys, a, b, do_keyswitch=True):
    """LWE(mu) if the phase of (a, b) is positive, else LWE(-mu)."""
    cfg = keys.cfg
    n_poly = cfg['tlwe_polynomial_degree']
    k = cfg['tlwe_mask_size']
    barb = modswitch(b, 2 * n_poly)
    bara = modswitch(a, 2 * n_poly)
    pos = (torch.arange(n_poly, device=b.device) + barb[:, None]) \
        & (2 * n_poly - 1)
    testvect = torch.where(pos < n_poly, MU, -MU)
    acc = torch.cat([torch.zeros((b.shape[0], k, n_poly), dtype=torch.int64,
                                 device=b.device), testvect[:, None]], 1)
    ex_a, ex_b = extract(blind_rotate(keys, acc, bara))
    if not do_keyswitch:
        return ex_a, ex_b
    return keyswitch(keys, ex_a, ex_b)


def gate2(keys, name, x, y):
    """A bootstrapped two-input gate on (a, b) pairs: (B, n), (B,) each."""
    num, den, cx, cy = GATES2[name]
    a = wrap32(cx * x[0] + cy * y[0])
    b = wrap32(t32(num, den) + cx * x[1] + cy * y[1])
    return bootstrap(keys, a, b)


def gate_mux(keys, s, x, y):
    """x if s else y: two bootstraps without keyswitch, summed, one
    keyswitch (``nufhe/gates.py:600-664``)."""
    and_c = t32(-1, 8)
    a = wrap32(torch.cat([s[0] + x[0], y[0] - s[0]]))
    b = wrap32(torch.cat([and_c + s[1] + x[1], and_c - s[1] + y[1]]))
    ex_a, ex_b = bootstrap(keys, a, b, do_keyswitch=False)
    h = s[1].shape[0]
    return keyswitch(keys, wrap32(ex_a[:h] + ex_a[h:]),
                     wrap32(MU + ex_b[:h] + ex_b[h:]))
