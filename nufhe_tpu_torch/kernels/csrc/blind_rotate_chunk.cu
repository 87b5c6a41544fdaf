// The chunked blind rotation (K3), for Hopper: `chunk` consecutive CMUX
// steps, from step `start`, in one launch, in both engine modes.
//
// Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk (the
// chunked launch whose accumulator stays in VMEM across the chunk's steps).
// The output equals `chunk` launches of K1 (cmux_step.cu), bit for bit: both
// run the step of cmux_body.cuh.
//
// Layout (the port's own):
//   acc     (B, 2, 1024) int32, batch-major, contiguous
//   bara_t  (n, B) int32 in [0, 2048): the rotation amounts, one row a step
//   key     the whole transformed key: (n, 4, 2, 64, 32) int64 exact, or
//           (n, 2, 4, 2, 64, 32) rounded (ops/transform.py)
//   out     (B, 2, 1024) int32 (a separate buffer; the wrapper allocates it)
//   start   first step; the wrapper checks 0 <= start, start + chunk <= n
//
// Design: K1's block, one block of 256 threads per sample with the
// accumulator and the work buffer in shared memory (42 KB), looping over the
// chunk's steps inside the block.  The accumulator is read from device
// memory once and written once a launch, which removes K1's per-step round
// trip (2 x 8 KB a sample and step).  Each step reads its rotation amount
// and its key row (131 KB exact, 262 KB rounded) from device memory; a
// chunk's rows (6.55 MB or 13.1 MB at chunk 50) stay in the 50 MB L2, so
// every wave of blocks after the first reads them from L2.  `start` is an
// argument, so one compiled kernel serves every chunk.
//
// The step is a called function, not inlined into the step loop.  Inlined
// there, it took 200 registers (one block an SM); capped at 128 it spilled,
// and a launch took 1.14 x 50 K1 launches on the H100 at batch 2^14.
// Called, it holds 126 registers or fewer, as K1 does, and runs within a few
// percent of 50 K1 launches (PERF.md).
//
// Bound: chunk x K1's operations (524,288 64-bit multiply-adds a sample and
// step plus the transform adds): bound by integer operations.

#include "cmux_body.cuh"

namespace {

template <bool kRounded>
__device__ __noinline__ void chunk_step(
    uint32_t* acc_s, unsigned long long* work, int p,
    const unsigned long long* __restrict__ key_row, uint32_t offset,
    int log2_base) {
  cmux_step_body<kRounded>(acc_s, work, p, key_row, offset, log2_base);
}

template <bool kRounded>
__global__ void __launch_bounds__(kThreads)
blind_rotate_chunk_kernel(const int32_t* __restrict__ acc_in,
                          int32_t* __restrict__ acc_out,
                          const int32_t* __restrict__ bara_t,
                          const unsigned long long* __restrict__ key,
                          int batch, int start, int chunk, uint32_t offset,
                          int log2_base) {
  __shared__ uint32_t acc_s[kMask1 * kN];
  __shared__ unsigned long long work[kMask1 * kL * kRP];

  constexpr int kRow = kRounded ? 2 * kSide : kSide;   // int64 values a row
  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(acc_in) + (size_t)b * kMask1 * kN;
  for (int e = threadIdx.x; e < kMask1 * kN; e += kThreads) acc_s[e] = src[e];

  for (int s = 0; s < chunk; ++s) {
    const size_t step = (size_t)(start + s);
    const int p = bara_t[step * batch + b] & (2 * kN - 1);
    chunk_step<kRounded>(acc_s, work, p, key + step * kRow, offset, log2_base);
  }

  uint32_t* dst = reinterpret_cast<uint32_t*>(acc_out) + (size_t)b * kMask1 * kN;
  for (int e = threadIdx.x; e < kMask1 * kN; e += kThreads) dst[e] = acc_s[e];
}

}  // namespace

extern "C" int blind_rotate_chunk_launch(const void* acc_in, void* acc_out,
                                         const void* bara_t, const void* key,
                                         int batch, int start, int chunk,
                                         unsigned int offset, int log2_base,
                                         int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    auto kernel = rounded ? blind_rotate_chunk_kernel<true>
                          : blind_rotate_chunk_kernel<false>;
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)bara_t,
        (const unsigned long long*)key, batch, start, chunk, (uint32_t)offset,
        log2_base);
  }
  return (int)cudaGetLastError();
}
