// Pieces of one CMUX step shared by the rows-layout kernels (K1, K3:
// blind_rotate_body.cuh) and the lanes-layout kernel (K4: lanes_step.cu), so
// that their arithmetic cannot drift apart:
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32, through the exact Nussbaumer
// transform over S' = Z[Y]/(Y^32 + 1) (L = 64 slots of R = 32 lanes) with
// the MAC on int8 limbs (ops/transform.py):
//   - the rotation and the gadget digit of one (sample, digit polynomial)
//     straight into a warp's registers, and the forward transform there
//     (forward_digits);
//   - the split of a transformed digit (|x| <= 32 * 2^(log2_base-1) = 2^14)
//     into int8 limbs a0 + 256 a1;
//   - the key residue's two-sided int8 limbs (split_exact, split_rounded);
//   - mma.sync m16n8k32 s8 x s8 -> s32;
//   - the unscaled inverse transform and the fold of one channel polynomial
//     in a warp's registers (inverse_fold).
// The accumulator polynomials lie in q-layout: coefficient i*32 + j at
// j*32 + i.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 1024;
constexpr int kR = 32;
constexpr int kL = 64;

__device__ __forceinline__ int rev6(int s) {
  return (int)(__brev((unsigned)s) >> 26);
}

__host__ __device__ constexpr int rev6c(int j) {
  return ((j & 1) << 5) | ((j & 2) << 3) | ((j & 4) << 1) | ((j & 8) >> 1) |
         ((j & 16) >> 3) | ((j & 32) >> 5);
}

__device__ __forceinline__ int q_of(int n) { return (n & 31) * 32 + (n >> 5); }

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 4 balanced radix-2^8 digits of y mod 2^32 (each in [-128, 128)),
// as the bytes of one word: y + 0x80808080 has the bytes d + 128 and no
// carries.
__device__ __forceinline__ uint32_t radix256(uint32_t y) {
  return (y + 0x80808080u) ^ 0x80808080u;
}

// ops/transform._limb_split_38 of a residue mod 2^38, given as any int64
// representative (the limbs depend on it mod 2^38 only), in the low bytes
// of l: exact [vlo, vhi_0..3, 4*vlo], vlo = balanced(x mod 64) and vhi =
// (x - vlo) / 64 mod 2^32
__device__ __forceinline__ void split_exact(long long x, uint32_t (&l)[6]) {
  const int vlo = (((int)(uint32_t)x + 32) & 63) - 32;
  const uint32_t hi =
      radix256((uint32_t)((unsigned long long)(x - vlo) >> 6));
  l[0] = (uint32_t)vlo;
#pragma unroll
  for (int q = 0; q < 4; ++q) l[1 + q] = hi >> (8 * q);
  l[5] = (uint32_t)(4 * vlo);
}

// rounded: vhi_0..3 of round(x / 64) = (x + 32) >> 6, mod 2^32
__device__ __forceinline__ void split_rounded(long long x, uint32_t (&l)[4]) {
  const uint32_t hi = radix256((uint32_t)((unsigned long long)(x + 32) >> 6));
#pragma unroll
  for (int q = 0; q < 4; ++q) l[q] = hi >> (8 * q);
}

// The int8 limbs of a transformed digit: x = a0 + 256 a1
__device__ __forceinline__ int limb0(int x) { return ((x + 128) & 255) - 128; }
__device__ __forceinline__ int limb1(int x) { return (x - limb0(x)) >> 8; }

// The L-point Cooley-Tukey DIT over S' = Z[Y]/(Y^32 + 1) on one polynomial
// held by a warp: row r in x[r], lane k its coefficient k.  The twiddle
// Y^tw is a rotation across the lanes (a shuffle) with a sign; every index
// is a constant once unrolled.  Input in bit-reversed row order, output
// natural.
template <typename T, bool kInverse>
__device__ __forceinline__ void dft_regs(T (&x)[kL], int lane) {
#pragma unroll
  for (int stage = 0; stage < 6; ++stage) {
    const int mmax = 1 << stage;
#pragma unroll
    for (int pair = 0; pair < kL / 2; ++pair) {
      const int m = pair & (mmax - 1);
      const int i = ((pair >> stage) << (stage + 1)) + m;
      const int j = i + mmax;
      int tw = m << (5 - stage);
      if (kInverse) tw = -tw;
      tw &= 63;
      const bool neg = tw >= 32;
      const int sh = tw & 31;
      T xj = x[j];
      if (sh) xj = __shfl_sync(0xffffffffu, xj, (lane - sh) & 31);
      if ((lane < sh) != neg) xj = (T)0 - xj;
      const T xi = x[i];
      x[i] = xi + xj;
      x[j] = xi - xj;
    }
  }
}

// Coefficient lane*32 + j of (X^p - 1) * a, for one accumulator polynomial
// `a` (q-layout, shared memory); of `a` itself when kRot is false (the
// stage parts of K5 that leave the rotation out, step_parts.cu); of
// X^p * a when kMinusOne is false (K9's rotation families,
// step_profile.cu).
template <bool kRot = true, bool kMinusOne = true>
__device__ __forceinline__ uint32_t rotated_coeff(const uint32_t* a, int p,
                                                  int j, int lane) {
  const uint32_t own = a[j * 32 + lane];
  if constexpr (!kRot) return own;
  const int src = (lane * 32 + j - p) & (2 * kN - 1);
  uint32_t v = a[q_of(src & (kN - 1))];
  if (src >= kN) v = 0u - v;
  if constexpr (!kMinusOne) return v;
  return v - own;
}

// The signed gadget digit of coefficient v at bit `shift`
__device__ __forceinline__ int gadget_digit(uint32_t v, int shift,
                                            uint32_t offset, int base_mask,
                                            int half) {
  return (int)(((v + offset) >> shift) & base_mask) - half;
}

// Rotation (X^p - 1) * a (rotated_coeff) and the gadget digit at bit
// `shift` of one accumulator polynomial into the warp's registers, then the
// forward transform: x[f] holds frequency f (natural order), lane k its
// coefficient k.  Block j of the polynomial goes to row rev6(j); the odd
// rows are the zero padding.
template <bool kRot = true>
__device__ __forceinline__ void forward_digits(const uint32_t* a, int p,
                                               int shift, uint32_t offset,
                                               int base_mask, int half,
                                               int lane, int (&x)[kL]) {
#pragma unroll
  for (int j = 0; j < kL / 2; ++j) {
    x[rev6c(j)] = gadget_digit(rotated_coeff<kRot>(a, p, j, lane), shift,
                               offset, base_mask, half);
    x[rev6c(j) + 1] = 0;
  }
  dft_regs<int, false>(x, lane);
}

// The unscaled inverse transform of one channel polynomial (bit-reversed
// rows in x) and the fold C_j = P_j + Y P_{j+32}: afterwards x[j], j < 32,
// lane i, holds coefficient i*32 + j, which lies at q-layout j*32 + i.
// uint32 wraparound is the lo channel's mod 2^32; the hi channel is exact
// as long as it stays inside int32 (see the callers).
__device__ __forceinline__ void inverse_fold(uint32_t (&x)[kL], int lane) {
  dft_regs<uint32_t, true>(x, lane);
#pragma unroll
  for (int j = 0; j < kL / 2; ++j) {
    uint32_t y = __shfl_sync(0xffffffffu, x[j + 32], (lane + 31) & 31);
    if (lane == 0) y = 0u - y;
    x[j] += y;
  }
}

}  // namespace
