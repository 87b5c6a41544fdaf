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
//   - mma.sync m16n8k32 s8 x s8 -> s32;
//   - the unscaled inverse transform and the fold of one channel polynomial
//     in a warp's registers (inverse_fold).
// Besides K1/K3's forms of the twiddles and of the rotation, the step
// experiments price others (each a template argument whose default is
// K1/K3's): the twiddle forms of dft_regs and inverse_fold (Twiddle: K11's
// t10, K13's inverse probes) and the barrel rotation (barrel_rotate: K12's
// t11-t14, K11's t5 and t8).
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

// The int8 limbs of a transformed digit: x = a0 + 256 a1
__device__ __forceinline__ int limb0(int x) { return ((x + 128) & 255) - 128; }
__device__ __forceinline__ int limb1(int x) { return (x - limb0(x)) >> 8; }

// How a twiddle Y^e (a rotation across the lanes with a sign, e a constant
// of the unrolled loop) is applied:
enum Twiddle : int {
  kTwSliced = 0,     // K1/K3: one rotation a butterfly, one shuffle and a
                     // sign select
  kTwTwoRoll = 1,    // K11's t10: the roll-roll-select form, two shuffles
                     // (shfl_up by e, shfl_down by 32 - e) and a select
  kTwPerBit = 2,     // K13's base: one rotation a set bit b of the
                     // butterfly's m, as tools/exp_inverse.py's
                     // make_inverse('full') composes Y^(step*m)
  kTwNone = 3,       // K13's notw: no twiddles, and the fold without Y
  kTwAligned = 4,    // K13's align: kTwPerBit, each amount rounded down to
                     // a multiple of 8 below its sign (make_inverse('align'))
  kTwSignOnly = 5,   // K13's noroll: kTwPerBit with every shuffle removed,
                     // each sign select kept (the fold's Y too)
};

// Y^e * v across the lanes, e in [0, 64): a rotation by e & 31 with the
// negacyclic sign, and -1 for e >= 32
template <int kTw, typename T>
__device__ __forceinline__ T rot_y(T v, int e, int lane) {
  const bool neg = e >= 32;
  const int sh = e & 31;
  if constexpr (kTw == kTwTwoRoll) {
    if (sh) {
      const T hi = __shfl_up_sync(0xffffffffu, v, sh);
      const T lo = __shfl_down_sync(0xffffffffu, v, 32 - sh);
      v = lane >= sh ? hi : (T)0 - lo;
    }
    if (neg) v = (T)0 - v;
  } else if constexpr (kTw == kTwSignOnly) {
    if ((lane < sh) != neg) v = (T)0 - v;
  } else {
    if (sh) v = __shfl_sync(0xffffffffu, v, (lane - sh) & 31);
    if ((lane < sh) != neg) v = (T)0 - v;
  }
  return v;
}

// make_inverse('align')'s amount: the part below the sign rounded down to
// a multiple of 8
__host__ __device__ constexpr int aligned_amount(int e) {
  return e >= 32 ? 32 + ((e - 32) & ~7) : (e & ~7);
}

// The twiddle of butterfly m at `stage` in the per-bit forms: for each set
// bit b of m one rotation by (2^b * 2^(5 - stage)), negated in the inverse
template <int kTw, bool kInverse, typename T>
__device__ __forceinline__ T twiddle_per_bit(T v, int stage, int m,
                                             int lane) {
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if (b >= stage || !((m >> b) & 1)) continue;
    int e = (1 << b) << (5 - stage);
    if (kInverse) e = -e;
    e &= 63;
    if (kTw == kTwAligned) e = aligned_amount(e);
    v = rot_y<kTw == kTwSignOnly ? kTwSignOnly : kTwSliced>(v, e, lane);
  }
  return v;
}

// The L-point Cooley-Tukey DIT over S' = Z[Y]/(Y^32 + 1) on one polynomial
// held by a warp: row r in x[r], lane k its coefficient k.  The twiddle
// Y^tw is a rotation across the lanes (a shuffle) with a sign; every index
// is a constant once unrolled.  Input in bit-reversed row order, output
// natural.  kTw: the twiddle form (K1/K3's by default).
template <typename T, bool kInverse, int kTw = kTwSliced>
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
      if constexpr (kTw == kTwSliced) {
        if (sh) xj = __shfl_sync(0xffffffffu, xj, (lane - sh) & 31);
        if ((lane < sh) != neg) xj = (T)0 - xj;
      } else if constexpr (kTw == kTwTwoRoll) {
        xj = rot_y<kTwTwoRoll>(xj, tw, lane);
      } else if constexpr (kTw != kTwNone) {
        xj = twiddle_per_bit<kTw, kInverse>(xj, stage, m, lane);
      }
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
// rows are the zero padding.  kTw: the transform's twiddle form.
template <bool kRot = true, int kTw = kTwSliced>
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
  dft_regs<int, false, kTw>(x, lane);
}

// The unscaled inverse transform of one channel polynomial (bit-reversed
// rows in x) and the fold C_j = P_j + Y P_{j+32}: afterwards x[j], j < 32,
// lane i, holds coefficient i*32 + j, which lies at q-layout j*32 + i.
// uint32 wraparound is the lo channel's mod 2^32; the hi channel is exact
// as long as it stays inside int32 (see the callers).  kTw: the twiddle
// form of the transform and of the fold's Y (kTwNone: no Y).
template <int kTw = kTwSliced>
__device__ __forceinline__ void inverse_fold(uint32_t (&x)[kL], int lane) {
  dft_regs<uint32_t, true, kTw>(x, lane);
#pragma unroll
  for (int j = 0; j < kL / 2; ++j) {
    uint32_t y;
    if constexpr (kTw == kTwSliced) {
      y = __shfl_sync(0xffffffffu, x[j + 32], (lane + 31) & 31);
      if (lane == 0) y = 0u - y;
    } else if constexpr (kTw == kTwNone) {
      y = x[j + 32];
    } else {
      y = rot_y<kTw == kTwSignOnly ? kTwSignOnly
                : kTw == kTwTwoRoll ? kTwTwoRoll : kTwSliced>(x[j + 32], 1,
                                                               lane);
    }
    x[j] += y;
  }
}

// The forms of the rotation (X^p - 1) * a of one accumulator polynomial:
// K1/K3 gather each coefficient in one load (rotated_coeff); the others run
// the TPU's barrel (ops/rows_engine.rotate_acc) on the warp's registers,
// coefficient lane*32 + j in register j: five j-rounds X^(2^b), b < 5 (a
// register shift, the wrapped registers multiplied by Y: a shuffle by one
// lane, lane 0 negated), five i-rounds Y^(2^(b-5)) (a lane rotation with
// the negacyclic sign, through the warp's scratch in shared memory), the
// bit-10 negate and the -1; each round applied where its bit of p is set
// (uniform across the warp: the register rounds branch on it, the others
// select).
enum RotForm : int {
  kRotGather = 0,     // K1/K3: rotated_coeff
  kRotWhole = 1,      // t11: every round materialises the whole rotated
                      // copy in the scratch, then selects
  kRotSliced = 2,     // t12: j-rounds in registers, only the wrapped
                      // registers move (shuffles), the rest renamed under a
                      // branch on the bit; i-rounds as t11
  kRotFusedI = 3,     // t13: j-rounds as t11; each i-round's select fused
                      // into the exchange (the scratch load's address)
  kRotBoth = 4,       // t14: t12's j-rounds and t13's i-rounds
  kRotDeferred = 5,   // t5: j-rounds as plain register rolls without the
                      // carry, then one Y-fix of registers j < (p & 31);
                      // i-rounds as t11, the negate fused into the -1
};

// Y * v across the lanes: lane i takes lane i - 1, lane 0 the negated lane 31
__device__ __forceinline__ uint32_t y_shift(uint32_t v, int lane) {
  v = __shfl_sync(0xffffffffu, v, (lane + 31) & 31);
  return lane == 0 ? 0u - v : v;
}

// j-round b (X^(2^b), k = 2^b) of barrel_rotate, a template so that every
// register index is a constant
template <int kForm, int b>
__device__ __forceinline__ void barrel_j_round(uint32_t (&r)[kL / 2], int p,
                                               int lane, uint32_t* scratch) {
  constexpr int k = 1 << b;
  const bool bit = (p >> b) & 1;
  if constexpr (kForm == kRotDeferred || kForm == kRotSliced ||
                kForm == kRotBoth) {
    if (bit) {   // uniform across the warp: one sample's amount
      uint32_t w[k];
#pragma unroll
      for (int j = 0; j < k; ++j)
        w[j] = kForm == kRotDeferred ? r[32 - k + j]
                                     : y_shift(r[32 - k + j], lane);
#pragma unroll
      for (int j = 31; j >= k; --j) r[j] = r[j - k];
#pragma unroll
      for (int j = 0; j < k; ++j) r[j] = w[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) scratch[j * 32 + lane] = r[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      uint32_t v;
      if (j >= k) {
        v = scratch[(j - k) * 32 + lane];
      } else {
        v = scratch[(j - k + 32) * 32 + ((lane + 31) & 31)];
        if (lane == 0) v = 0u - v;
      }
      r[j] = bit ? v : r[j];
    }
    __syncwarp();
  }
}

// r[j] = coefficient lane*32 + j of (X^p - 1) * a by the barrel of form
// kForm (not kRotGather), for `a` in q-layout; rounds b < kSkip are left
// out (p is a multiple of 2^kSkip: K11's t8).  scratch: 1024 words of the
// warp's own in shared memory.
template <int kForm, int kSkip = 0>
__device__ __forceinline__ void barrel_rotate(const uint32_t* a, int p,
                                              int lane, uint32_t* scratch,
                                              uint32_t (&r)[kL / 2]) {
  constexpr bool kIFused = kForm == kRotFusedI || kForm == kRotBoth;
#pragma unroll
  for (int j = 0; j < 32; ++j) r[j] = a[j * 32 + lane];
  if constexpr (kSkip <= 0) barrel_j_round<kForm, 0>(r, p, lane, scratch);
  if constexpr (kSkip <= 1) barrel_j_round<kForm, 1>(r, p, lane, scratch);
  if constexpr (kSkip <= 2) barrel_j_round<kForm, 2>(r, p, lane, scratch);
  if constexpr (kSkip <= 3) barrel_j_round<kForm, 3>(r, p, lane, scratch);
  if constexpr (kSkip <= 4) barrel_j_round<kForm, 4>(r, p, lane, scratch);
  if constexpr (kForm == kRotDeferred) {
    const int wrapped = p & 31;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < wrapped) r[j] = y_shift(r[j], lane);
  }
#pragma unroll
  for (int b = 5; b < 10; ++b) {
    const int k = 1 << (b - 5);
    const bool bit = (p >> b) & 1;
#pragma unroll
    for (int j = 0; j < 32; ++j) scratch[j * 32 + lane] = r[j];
    __syncwarp();
    if constexpr (kIFused) {
      const int src = bit ? (lane - k) & 31 : lane;
      const bool neg = bit && lane < k;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t v = scratch[j * 32 + src];
        r[j] = neg ? 0u - v : v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        uint32_t v = scratch[j * 32 + ((lane - k) & 31)];
        if (lane < k) v = 0u - v;
        r[j] = bit ? v : r[j];
      }
    }
    __syncwarp();
  }
  const bool neg = (p >> 10) & 1;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t v = neg ? 0u - r[j] : r[j];
    r[j] = v - a[j * 32 + lane];
  }
}

}  // namespace
