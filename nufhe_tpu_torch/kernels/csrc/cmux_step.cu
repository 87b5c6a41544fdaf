// One CMUX step of the blind rotation, exact ('NTT') engine, for Hopper.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32.  Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step_rows (the per-step
// launch over ops/rows_engine.external_step); the output is the same
// function, bit for bit.
//
// Layout (the port's own, not the TPU rows layout):
//   acc    (B, 2, 1024) int32, batch-major, contiguous
//   p      (B,) int32 in [0, 2048)
//   key    (G=4, O=2, L=64, R=32) int64: the Nussbaumer transform of the
//          bootstrap-key row, each residue mod 2^38 (ops/transform.py)
//   out    (B, 2, 1024) int32
//
// Design: one block of 256 threads per sample.  The accumulator (8 KB), the
// four digit transforms (int32) and, reusing the same buffer, the two output
// spectra (uint64) stay in shared memory (42 KB in all, so several blocks
// share an SM).  Stages:
//   1. barrel rotation (X^p - 1) * acc and the l=2 gadget digits, written
//      straight into bit-reversed transform order;
//   2. forward Nussbaumer DIT (6 stages, twiddles are signed rotations);
//   3. MAC: per slot t, the 32-term negacyclic convolution of each digit
//      transform against the key residue, summed over g.  A warp owns a
//      slot, a lane owns one output k for both output polynomials; the key
//      value is the same for the whole warp (a broadcast load from L2/L1);
//   4. unscaled inverse DIT in uint64 (wraparound is defined; only bits
//      6..37 of the result are kept, so any multiple of 2^38 drops out);
//   5. fold, >> 6, add to the accumulator (uint32 wraparound).
//
// Bound: the MAC does 64 slots * 2 outputs * 32 * 32 * 4 = 524,288 64-bit
// multiply-adds per sample per step (500 steps per gate); the transforms add
// about 60k integer adds.  The key row (131 KB) and the accumulator are the
// only device-memory traffic, so the kernel is bound by integer operations,
// not by bytes.  The 64-bit products run on the 32-bit integer units; moving
// the MAC onto tensor cores (as the TPU kernel does with int8 limbs) is work
// for a later version.

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

__global__ void __launch_bounds__(kThreads)
cmux_step_kernel(const int32_t* __restrict__ acc_in, int32_t* __restrict__ acc_out,
                 const int32_t* __restrict__ powers,
                 const unsigned long long* __restrict__ key,
                 uint32_t offset, int log2_base) {
  __shared__ uint32_t acc_s[kMask1 * kN];
  // digit transforms (int32, G polys) and later the output spectra
  // (uint64, 2 polys): the same bytes, used one after the other
  __shared__ unsigned long long work_u64[kMask1 * kL * kRP];
  int32_t* dig = reinterpret_cast<int32_t*>(work_u64);
  unsigned long long* spec = work_u64;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t* src_acc =
      reinterpret_cast<const uint32_t*>(acc_in) + (size_t)b * kMask1 * kN;
  for (int e = tid; e < kMask1 * kN; e += kThreads) acc_s[e] = src_acc[e];
  const int p = powers[b] & (2 * kN - 1);

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
        if (v > lane) dv = -dv;
        const unsigned long long d64 = (unsigned long long)(long long)dv;
        a0 += d64 * __ldg(k0 + v);
        a1 += d64 * __ldg(k1 + v);
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

  // 5. fold C_j = P_j + Y P_{j+32}, c[i*32 + j] = C_j[i], >> 6, accumulate
  uint32_t* dst = reinterpret_cast<uint32_t*>(acc_out) + (size_t)b * kMask1 * kN;
  for (int e = tid; e < kMask1 * kN; e += kThreads) {
    const int o = e >> 10;
    const int c = e & (kN - 1);
    const int i = c >> 5;
    const int j = c & 31;
    const unsigned long long* pj = spec + (o * kL + j) * kRP;
    const unsigned long long* pm = spec + (o * kL + j + 32) * kRP;
    const unsigned long long y = (i == 0) ? (0ull - pm[31]) : pm[i - 1];
    const unsigned long long cval = pj[i] + y;
    dst[e] = acc_s[e] + (uint32_t)(cval >> 6);
  }
}

}  // namespace

extern "C" int cmux_step_launch(const void* acc_in, void* acc_out,
                                const void* powers, const void* key,
                                int batch, unsigned int offset, int log2_base,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    cmux_step_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)powers,
        (const unsigned long long*)key, (uint32_t)offset, log2_base);
  }
  return (int)cudaGetLastError();
}
