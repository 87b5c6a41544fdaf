// The MAC dot alone (K7), for Hopper: a batched integer GEMM over 64 slots
// on the tensor cores, in two forms.  Replaces the TPU kernel
// tools/exp_int8.py::make_pallas (its `mac_int8` and `mac_bf16` bodies on
// the MXU):
//
//   for each slot l < L:  out[l] = rhs[l]^T . lhs[l]        (Q x B)
//   o[l][c] = out[l][c] + out[l][C + c]  (c < Q - C),  out[l][c] (c >= Q - C)
//   result[l] = o[l] & 255                                  (C x B) int32
//
// with lhs = x cast to int8 (the XLA convert: the low byte, mod 2^8) and
// s32 accumulation, or x cast to bf16 (round to nearest even, through
// float) and f32 accumulation truncated to int32.  C = 256, Q = 384 (the
// TPU's padded width, kept: the port computes the TPU kernel's function).
// The int8 form is exact for every x (|sum| <= 256 * 128 * 128 = 2^22);
// the bf16 form is exact while |x| < 2^8 (|sum| <= 256 * 128 * 255 < 2^24,
// so no sum of f32 rounds, in any order), which the chained calls keep.
//
// Layout: x (L, C, B) int32 (B contiguous), rhs (L, C, Q) int8 or bf16 (Q
// contiguous), out (L, C, B) int32.  Neither operand lies in the order
// that mma.sync wants (K = C contiguous for both), and ldmatrix .trans does
// not move 8-bit elements, so a block transposes both through shared
// memory, casting x on load.
//
// Design: a block a slot l (grid y), 128 samples and one of three row
// groups (grid x, the row group fastest, so the three blocks that read one
// x tile run together and share it in L2): rows q in [0, 64) + [256, 320),
// [64, 128) + [320, 384) or [128, 256), so that each folded output's two
// rows lie in one thread.  K runs in chunks of 128 bytes (128 int8 or 64
// bf16 values): the rhs chunk (128 q x 128 bytes) and the x chunk (128
// samples x 128 bytes) go to shared memory K-contiguous, rows 144 bytes
// apart (the fragment loads are free of bank conflicts).  The loaders read
// whole 32-bit words of rhs (4 int8 or 2 bf16 values of consecutive q) and
// 16-byte vectors of x (4 samples) and transpose them in registers
// (__byte_perm), so a word of shared memory costs one global load or
// less.  8 warps: warp w owns m-tiles w % 4 and w % 4 + 4 (rows
// i and i + 64 of its row group) and samples 64 (w / 4) .. + 63, 16
// mma.sync (m16n8k32 s8 or m16n8k16 bf16; their fragments have the same
// word layout) a 32-byte K step.  The epilogue folds in registers, masks
// and stores; a ragged last sample tile is masked.
//
// Bound: bytes, x in and out (2 * 64 * 256 * B * 4: 2.15 GB at B = 2^14,
// 0.64 ms at 3.35 TB/s) and the rhs once; the int8 operations (2 * 64 * 256
// * 384 * B = 2.06e11 at 2^14) take 0.104 ms at 1979e12/s, the bf16 ones
// 0.208 ms at 989e12/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 256;
constexpr int kQ = 384;
constexpr int kRowsBlk = 128;             // q rows a block
constexpr int kBN = 128;                  // samples a block
constexpr int kThreads = 256;
constexpr int kChunkWords = 32;           // 128 bytes of K a chunk
constexpr int kStride = kChunkWords + 4;  // smem row stride in words

__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k32(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(int32_t x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)x));
}

// Local row i of row group r -> rhs column q
__device__ __forceinline__ int q_of_row(int r, int i) {
  const int lo = r == 2 ? 128 : 64 * r;
  const int hi = r == 2 ? 192 : 256 + 64 * r;
  return (i < 64 ? lo : hi) + (i & 63);
}

// Unit u of a 128-row x 32-word tile in groups of G consecutive rows
// (G = 4 or 2): (row group, word), ordered so that a warp's loads cover 8
// row groups x 4 words (whole 32-byte sectors of the global rows) and its
// shared stores spread over the banks
template <int G>
__device__ __forceinline__ void unit_pos(int u, int& grp, int& word) {
  constexpr int kHiBits = G == 4 ? 2 : 3;       // 32 or 64 row groups
  grp = (u & 7) | (((u >> 5) & ((1 << kHiBits) - 1)) << 3);
  word = ((u >> 3) & 3) | ((u >> (5 + kHiBits)) << 2);
}

// The chunk of rhs^T from K value c0 on: a_s row i holds rhs column
// q_of_row(r, i), its K values contiguous.  A unit is G rows x one word:
// the 32-bit words of its K rows (G consecutive q each) transposed in
// registers.
template <bool kBf16>
__device__ __forceinline__ void load_rhs_chunk(const void* rhs_l, int r,
                                               int c0, uint32_t* a_s,
                                               int tid) {
  constexpr int G = kBf16 ? 2 : 4;
  constexpr int kUnits = kRowsBlk / G * kChunkWords;
#pragma unroll 2
  for (int u = tid; u < kUnits; u += kThreads) {
    int grp, word;
    unit_pos<G>(u, grp, word);
    const int q = q_of_row(r, G * grp);
    uint32_t* dst = a_s + G * grp * kStride + word;
    if constexpr (kBf16) {
      const uint16_t* src =
          (const uint16_t*)rhs_l + (size_t)(c0 + 2 * word) * kQ + q;
      const uint32_t w0 = __ldg((const uint32_t*)src);
      const uint32_t w1 = __ldg((const uint32_t*)(src + kQ));
      dst[0] = __byte_perm(w0, w1, 0x5410);
      dst[kStride] = __byte_perm(w0, w1, 0x7632);
    } else {
      const uint8_t* src =
          (const uint8_t*)rhs_l + (size_t)(c0 + 4 * word) * kQ + q;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = __ldg((const uint32_t*)(src + j * kQ));
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      dst[0] = __byte_perm(t0, t1, 0x5410);
      dst[kStride] = __byte_perm(t0, t1, 0x7632);
      dst[2 * kStride] = __byte_perm(t2, t3, 0x5410);
      dst[3 * kStride] = __byte_perm(t2, t3, 0x7632);
    }
  }
}

// The chunk of x, cast, for samples b0.. from K value c0 on: b_s row s
// holds sample b0 + s, its K values contiguous.  A unit is 4 samples x one
// word: 4 (int8) or 2 (bf16) rows of x, a 16-byte vector each where the
// batch is a multiple of 4 and the 4 samples exist (else one element at a
// time, 0 past the batch), packed by sample.
template <bool kBf16>
__device__ __forceinline__ void load_x_chunk(const int32_t* xl, int batch,
                                             int b0, int c0, uint32_t* b_s,
                                             int tid) {
  constexpr int kRowsIn = kBf16 ? 2 : 4;
  constexpr int kUnits = kBN / 4 * kChunkWords;
  const bool vec = (batch & 3) == 0;
#pragma unroll 2
  for (int u = tid; u < kUnits; u += kThreads) {
    int grp, word;
    unit_pos<4>(u, grp, word);
    const int b = b0 + 4 * grp;
    const int32_t* src = xl + (size_t)(c0 + kRowsIn * word) * batch + b;
    int v[kRowsIn][4];
    if (vec && b + 3 < batch) {
#pragma unroll
      for (int j = 0; j < kRowsIn; ++j) {
        const int4 t = __ldg((const int4*)(src + (size_t)j * batch));
        v[j][0] = t.x;
        v[j][1] = t.y;
        v[j][2] = t.z;
        v[j][3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsIn; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[j][i] = b + i < batch ? __ldg(src + (size_t)j * batch + i) : 0;
    }
    uint32_t* dst = b_s + 4 * grp * kStride + word;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t o;
      if constexpr (kBf16) {
        o = bf16_bits(v[0][i]) | (bf16_bits(v[1][i]) << 16);
      } else {
        o = ((uint32_t)v[0][i] & 255u) | (((uint32_t)v[1][i] & 255u) << 8) |
            (((uint32_t)v[2][i] & 255u) << 16) | ((uint32_t)v[3][i] << 24);
      }
      dst[i * kStride] = o;
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
mac_dot_kernel(const int32_t* __restrict__ x, const void* __restrict__ rhs,
               int32_t* __restrict__ out, int batch) {
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int kPerWord = kBf16 ? 2 : 4;     // K values a word
  constexpr int kChunkK = kChunkWords * kPerWord;
  __shared__ uint32_t a_s[kRowsBlk * kStride];
  __shared__ uint32_t b_s[kBN * kStride];
  const int r = blockIdx.x % 3;
  const int b0 = (blockIdx.x / 3) * kBN;
  const int l = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int mt = warp & 3;                 // m-tiles mt and mt + 4
  const int nb = (warp >> 2) * 64;         // the warp's first sample
  const int32_t* xl = x + (size_t)l * kC * batch;
  const void* rhs_l = (const uint8_t*)rhs +
                      (size_t)l * kC * kQ * (kBf16 ? 2 : 1);

  Acc acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

#pragma unroll 1
  for (int c0 = 0; c0 < kC; c0 += kChunkK) {
    load_rhs_chunk<kBf16>(rhs_l, r, c0, a_s, tid);
    load_x_chunk<kBf16>(xl, batch, b0, c0, b_s, tid);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kChunkWords; ks += 8) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* ar =
            a_s + (16 * (mt + 4 * m) + gid) * kStride + ks + tig;
        af[m][0] = ar[0];
        af[m][1] = ar[8 * kStride];
        af[m][2] = ar[4];
        af[m][3] = ar[8 * kStride + 4];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t* br = b_s + (nb + 8 * n + gid) * kStride + ks + tig;
        const uint32_t bw0 = br[0], bw1 = br[4];
        mma_k32(acc[0][n], af[0], bw0, bw1);
        mma_k32(acc[1][n], af[1], bw0, bw1);
      }
    }
    __syncthreads();
  }

  // rows i = 16 mt + gid (+ 8) and i + 64; samples 2 tig (+ 1) of a tile
  int32_t* ol = out + (size_t)l * kC * batch;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mt + gid + (e >> 1) * 8;
      const int b = b0 + nb + 8 * n + 2 * tig + (e & 1);
      if (b >= batch) continue;
      uint32_t v0, v1;
      if constexpr (kBf16) {
        v0 = (uint32_t)__float2int_rz(acc[0][n][e]);
        v1 = (uint32_t)__float2int_rz(acc[1][n][e]);
      } else {
        v0 = (uint32_t)acc[0][n][e];
        v1 = (uint32_t)acc[1][n][e];
      }
      if (r < 2) {
        ol[(size_t)(64 * r + i) * batch + b] = (int32_t)((v0 + v1) & 255u);
      } else {
        ol[(size_t)(128 + i) * batch + b] = (int32_t)(v0 & 255u);
        ol[(size_t)(192 + i) * batch + b] = (int32_t)(v1 & 255u);
      }
    }
}

}  // namespace

// x (slots, 256, batch) int32, rhs (slots, 256, 384) int8 (bf16 = 0) or
// bf16 (bf16 = 1), out (slots, 256, batch) int32, on the device ordinal
// `device`; returns the CUDA error code.
extern "C" int mac_dot_launch(const void* x, const void* rhs, void* out,
                              int slots, int batch, int bf16, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || slots <= 0) return (int)cudaGetLastError();
  const dim3 grid(3 * ((batch + kBN - 1) / kBN), slots);
  if (bf16)
    mac_dot_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, rhs, (int32_t*)out, batch);
  else
    mac_dot_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, rhs, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
