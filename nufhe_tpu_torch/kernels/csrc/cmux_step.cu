// One CMUX step of the blind rotation (K1), for Hopper, in both engine
// modes: the exact ('NTT') key and the two-sided rounded ('FFT') key.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32.  Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step_rows (the per-step
// launch over ops/rows_engine.external_step); the output is the same
// function, bit for bit, for either key form.
//
// Layout (the port's own, not the TPU rows layout):
//   acc    (B, 2, 1024) int32, batch-major, contiguous
//   p      (B,) int32 in [0, 2048)
//   key    one row: (4, 2, 64, 32) int64 exact, (2, 4, 2, 64, 32) rounded
//   out    (B, 2, 1024) int32
//
// Design: one block of 256 threads per sample.  The accumulator (8 KB), the
// four digit transforms (int32) and, reusing the same buffer, the two output
// spectra (uint64) stay in shared memory (42 KB in all, so several blocks
// share an SM).  The step itself is cmux_body.cuh's, shared with K3.
//
// Bound: the MAC does 64 slots * 2 outputs * 32 * 32 * 4 = 524,288 64-bit
// multiply-adds per sample per step (500 steps per gate); the transforms add
// about 60k integer adds.  The key row (131 KB exact, 262 KB rounded) and
// the accumulator are the only device-memory traffic, so the kernel is bound
// by integer operations, not by bytes.  The 64-bit products run on the
// 32-bit integer units; moving the MAC onto tensor cores (as the TPU kernel
// does with int8 limbs) is work for a later version.

#include "cmux_body.cuh"

namespace {

template <bool kRounded>
__global__ void __launch_bounds__(kThreads)
cmux_step_kernel(const int32_t* __restrict__ acc_in, int32_t* __restrict__ acc_out,
                 const int32_t* __restrict__ powers,
                 const unsigned long long* __restrict__ key,
                 uint32_t offset, int log2_base) {
  __shared__ uint32_t acc_s[kMask1 * kN];
  __shared__ unsigned long long work[kMask1 * kL * kRP];

  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(acc_in) + (size_t)b * kMask1 * kN;
  for (int e = threadIdx.x; e < kMask1 * kN; e += kThreads) acc_s[e] = src[e];
  const int p = powers[b] & (2 * kN - 1);

  cmux_step_body<kRounded>(acc_s, work, p, key, offset, log2_base);

  uint32_t* dst = reinterpret_cast<uint32_t*>(acc_out) + (size_t)b * kMask1 * kN;
  for (int e = threadIdx.x; e < kMask1 * kN; e += kThreads) dst[e] = acc_s[e];
}

}  // namespace

extern "C" int cmux_step_launch(const void* acc_in, void* acc_out,
                                const void* powers, const void* key,
                                int batch, unsigned int offset, int log2_base,
                                int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    auto kernel = rounded ? cmux_step_kernel<true> : cmux_step_kernel<false>;
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)powers,
        (const unsigned long long*)key, (uint32_t)offset, log2_base);
  }
  return (int)cudaGetLastError();
}
