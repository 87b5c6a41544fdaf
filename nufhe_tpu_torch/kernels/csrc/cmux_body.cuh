// The body of one CMUX step of the blind rotation, shared by the per-step
// kernel (cmux_step.cu, K1) and the chunked rotation (blind_rotate_chunk.cu,
// K3), so that the two cannot drift apart.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32, on one sample whose
// accumulator lies in shared memory; the step updates it in place.
//
// Key row (device memory, int64 Nussbaumer residues mod 2^38, centred;
// ops/transform.py):
//   exact ('NTT')        (G=4, O=2, L=64, R=32): the MAC negates the digit
//                        on the terms that wrap around the negacyclic
//                        convolution;
//   rounded ('FFT')      (2, G, O, L, R): side 0 = 64*round(+v/64), side 1 =
//                        64*round(-v/64), each rounded on its own.  The wrap
//                        terms read side 1 without negation, the others side
//                        0.  (64 X mod 2^38) >> 6 = X mod 2^32, so stages 4
//                        and 5 are the same in both forms.
//
// Stages (one block of 256 threads a sample):
//   1. barrel rotation (X^p - 1) * acc and the l=2 gadget digits, written
//      straight into bit-reversed transform order; the odd (zero padding)
//      slots are cleared first, on every step, because the same bytes held
//      the previous step's output spectra;
//   2. forward Nussbaumer DIT (6 stages, twiddles are signed rotations);
//   3. MAC: per slot t, the 32-term negacyclic convolution of each digit
//      transform against the key residue, summed over g.  A warp owns a
//      slot, a lane owns one output k for both output polynomials; the key
//      value is the same for the whole warp (exact), or one of two values
//      (rounded), a broadcast load from L2/L1;
//   4. unscaled inverse DIT in uint64 (wraparound is defined; only bits
//      6..37 of the result are kept, so any multiple of 2^38 drops out);
//   5. fold, >> 6, add to the accumulator (uint32 wraparound).
// The step ends with a barrier, so the next step may read any element.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 1024;
constexpr int kR = 32;
constexpr int kL = 64;
constexpr int kRP = kR + 1;   // padded row stride in shared memory (banks)
constexpr int kMask1 = 2;
constexpr int kDecomp = 2;
constexpr int kG = kMask1 * kDecomp;
constexpr int kThreads = 256;
constexpr int kSide = kG * kMask1 * kL * kR;   // int64 values in one key side

__device__ __forceinline__ int rev6(int s) {
  return (int)(__brev((unsigned)s) >> 26);
}

// One in-place L-point Cooley-Tukey DIT over S' = Z[Y]/(Y^32 + 1) with root
// Y (forward) or Y^-1 (inverse), on NPOLY polynomials of (L, R) values held
// with row stride kRP.  The input is already in bit-reversed slot order.
template <typename T, int NPOLY>
__device__ __forceinline__ void dft_l(T* data, bool inverse) {
  constexpr int kPer = NPOLY * (kL / 2) * kR / kThreads;
  for (int stage = 0; stage < 6; ++stage) {
    const int mmax = 1 << stage;
    T new_i[kPer], new_j[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e & 31;
      const int pair = (e >> 5) & 31;
      const int poly = e >> 10;
      const int m = pair & (mmax - 1);
      const int i = ((pair >> stage) << (stage + 1)) + m;
      const int j = i + mmax;
      int tw = m << (5 - stage);
      if (inverse) tw = -tw;
      tw &= 63;
      const bool neg = tw >= 32;
      const int sh = tw & 31;
      const int src = r - sh;
      const bool wrap = src < 0;
      const T* base = data + poly * kL * kRP;
      T xj = base[j * kRP + (src & 31)];
      if (wrap != neg) xj = (T)0 - xj;
      const T xi = base[i * kRP + r];
      new_i[q] = xi + xj;
      new_j[q] = xi - xj;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e & 31;
      const int pair = (e >> 5) & 31;
      const int poly = e >> 10;
      const int m = pair & (mmax - 1);
      const int i = ((pair >> stage) << (stage + 1)) + m;
      const int j = i + mmax;
      T* base = data + poly * kL * kRP;
      base[i * kRP + r] = new_i[q];
      base[j * kRP + r] = new_j[q];
    }
    __syncthreads();
  }
}

// One CMUX step on the block's sample.  acc_s: (2, 1024) uint32 in shared
// memory, written by the caller before the call (no barrier needed: the
// step's first barrier precedes its first read).  work: 2*64*33 uint64 of
// shared memory, the digit transforms (int32, G polys) and then the output
// spectra (uint64, 2 polys).  p in [0, 2048).
template <bool kRounded>
__device__ __forceinline__ void cmux_step_body(
    uint32_t* acc_s, unsigned long long* work, int p,
    const unsigned long long* __restrict__ key, uint32_t offset,
    int log2_base) {
  int32_t* dig = reinterpret_cast<int32_t*>(work);
  unsigned long long* spec = work;
  const int tid = threadIdx.x;

  // odd slots of the bit-reversed forward input are the zero padding
  for (int e = tid; e < kG * (kL / 2) * kR; e += kThreads) {
    const int r = e & 31;
    const int s = ((e >> 5) & 31) * 2 + 1;
    const int g = e >> 10;
    dig[(g * kL + s) * kRP + r] = 0;
  }
  __syncthreads();

  // 1. rotation, gadget digits, bit-reversed placement
  const int base_mask = (1 << log2_base) - 1;
  const int half = 1 << (log2_base - 1);
  for (int e = tid; e < kMask1 * kN; e += kThreads) {
    const int o = e >> 10;
    const int c = e & (kN - 1);
    const int src = (c - p) & (2 * kN - 1);
    uint32_t v = acc_s[o * kN + (src & (kN - 1))];
    if (src >= kN) v = 0u - v;
    const uint32_t shifted = v - acc_s[o * kN + c] + offset;
    const int s = rev6(c & 31);   // slot j = c % 32 lands at rev6(j) (even)
    const int r = c >> 5;
#pragma unroll
    for (int d = 0; d < kDecomp; ++d) {
      const int digit =
          (int)((shifted >> (32 - (d + 1) * log2_base)) & base_mask) - half;
      dig[((o * kDecomp + d) * kL + s) * kRP + r] = digit;
    }
  }
  __syncthreads();

  // 2. forward transform of the G digit polynomials
  dft_l<int32_t, kG>(dig, false);

  // 3. MAC: warp w owns slots w, w+8, ..., lane k the output coefficient k
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long res0[kL / 8], res1[kL / 8];
#pragma unroll
  for (int tt = 0; tt < kL / 8; ++tt) {
    const int t = warp + 8 * tt;
    unsigned long long a0 = 0, a1 = 0;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int32_t* dg = dig + (g * kL + t) * kRP;
      const unsigned long long* k0 = key + ((g * kMask1 + 0) * kL + t) * kR;
      const unsigned long long* k1 = key + ((g * kMask1 + 1) * kL + t) * kR;
#pragma unroll 8
      for (int v = 0; v < kR; ++v) {
        int dv = dg[(lane - v) & 31];
        int side = 0;
        if (v > lane) {
          if (kRounded) side = kSide;
          else dv = -dv;
        }
        const unsigned long long d64 = (unsigned long long)(long long)dv;
        a0 += d64 * __ldg(k0 + side + v);
        a1 += d64 * __ldg(k1 + side + v);
      }
    }
    res0[tt] = a0;
    res1[tt] = a1;
  }
  __syncthreads();   // every warp is done reading the digit transforms
#pragma unroll
  for (int tt = 0; tt < kL / 8; ++tt) {
    const int s = rev6(warp + 8 * tt);
    spec[(0 * kL + s) * kRP + lane] = res0[tt];
    spec[(1 * kL + s) * kRP + lane] = res1[tt];
  }
  __syncthreads();

  // 4. unscaled inverse transform of the two output spectra
  dft_l<unsigned long long, kMask1>(spec, true);

  // 5. fold C_j = P_j + Y P_{j+32}, c[i*32 + j] = C_j[i], >> 6, accumulate;
  //    a thread reads and writes only its own elements of acc_s here
  for (int e = tid; e < kMask1 * kN; e += kThreads) {
    const int o = e >> 10;
    const int c = e & (kN - 1);
    const int i = c >> 5;
    const int j = c & 31;
    const unsigned long long* pj = spec + (o * kL + j) * kRP;
    const unsigned long long* pm = spec + (o * kL + j + 32) * kRP;
    const unsigned long long y = (i == 0) ? (0ull - pm[31]) : pm[i - 1];
    const unsigned long long cval = pj[i] + y;
    acc_s[e] += (uint32_t)(cval >> 6);
  }
  // the next step rotates acc_s at other indices and reuses work
  __syncthreads();
}

}  // namespace
