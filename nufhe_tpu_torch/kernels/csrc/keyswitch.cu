// LWE keyswitch totals for Hopper (base 4 digits).
//
//   totals[s] = [ sum_r KS[r, digit(s, r)] (a columns and b column) | count ]
//
// over the rows r = j * in_size + i (l-major), digit(s, r) =
// ((a[s, i] + prec) >> (32 - (j+1)*2)) & 3, where digit 0 adds nothing and
// the last column counts the nonzero digits; int32 sums wrap mod 2^32.
// Replaces the TPU kernel nufhe_tpu/ops/pallas/keyswitch.py::keyswitch_mac
// (an int8 one-hot matrix product there); this is the gather-accumulate form
// of the nuFHE GPU keyswitch (nufhe/lwe_gpu.mako).
//
// Layout:
//   a      (B, in_size) int32
//   table  (rows, 3, out + 1) int32: [a | b] of the key for digits 1..3
//   out    (B, out + 2) int32
//
// Design: a block owns 32 samples and 512 output columns (two per thread).
// It first packs the 2-bit digits of its 32 samples into one 64-bit word per
// row in shared memory (rows * 8 bytes, 64 KB at rows = 8192).  Then each
// thread walks the rows: the digit word is the same for the whole block, so
// the branch on a zero digit is uniform and the table reads of a warp are
// 32 neighbouring columns of one key row.
//
// Bound: B * rows * (out + 1) int32 adds for the nonzero digits (3/4 of them
// on random input) plus the table's 49 MB at the default sizes, read once
// from device memory and then from L2 once per block of 32 samples: the adds
// bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 32;             // samples per block: 2 bits each
constexpr int kCols = 2 * kThreads;      // columns per block

__global__ void __launch_bounds__(kThreads)
keyswitch_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ table,
                 int32_t* __restrict__ out, int batch, int in_size,
                 int decomp_length, int out1) {
  extern __shared__ unsigned long long digits[];
  const int rows = in_size * decomp_length;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kSamples;
  const int ns = min(kSamples, batch - s0);
  const uint32_t prec = 1u << (32 - (1 + 2 * decomp_length));

  for (int r = tid; r < rows; r += kThreads) {
    const int j = r / in_size;
    const int i = r - j * in_size;
    const int sh = 32 - (j + 1) * 2;
    unsigned long long w = 0;
    for (int s = 0; s < ns; ++s) {
      const uint32_t x = (uint32_t)a[(size_t)(s0 + s) * in_size + i] + prec;
      w |= (unsigned long long)((x >> sh) & 3u) << (2 * s);
    }
    digits[r] = w;
  }
  __syncthreads();

  // a column below out1 reads the table, column out1 counts, others idle
  const int col0 = blockIdx.y * kCols + tid;
  const int col1 = col0 + kThreads;
  const bool tab0 = col0 < out1, tab1 = col1 < out1;
  const uint32_t one0 = col0 == out1, one1 = col1 == out1;
  uint32_t acc0[kSamples], acc1[kSamples];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) acc0[s] = acc1[s] = 0;

  for (int r = 0; r < rows; ++r) {
    const unsigned long long w = digits[r];
    if (w == 0) continue;
    const int32_t* trow = table + (size_t)r * 3 * out1;
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      const int d = (int)((w >> (2 * s)) & 3u);
      if (d) {
        const int32_t* e = trow + (d - 1) * out1;
        acc0[s] += tab0 ? (uint32_t)__ldg(e + col0) : one0;
        acc1[s] += tab1 ? (uint32_t)__ldg(e + col1) : one1;
      }
    }
  }

  const int width = out1 + 1;
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    if (s < ns) {
      uint32_t* row = reinterpret_cast<uint32_t*>(out) + (size_t)(s0 + s) * width;
      if (col0 < width) row[col0] = acc0[s];
      if (col1 < width) row[col1] = acc1[s];
    }
  }
}

}  // namespace

extern "C" int keyswitch_launch(const void* a, const void* table, void* out,
                                int batch, int in_size, int decomp_length,
                                int out_size, int device, void* stream) {
  const int rows = in_size * decomp_length;
  const int smem = rows * (int)sizeof(unsigned long long);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      keyswitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int out1 = out_size + 1;
  if (batch > 0) {
    dim3 grid((batch + kSamples - 1) / kSamples, (out1 + 1 + kCols - 1) / kCols);
    keyswitch_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)table, (int32_t*)out, batch,
        in_size, decomp_length, out1);
  }
  return (int)cudaGetLastError();
}
