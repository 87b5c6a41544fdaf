// The MAC dot alone (K7), for Hopper: a batched integer GEMM over 64 slots
// on TMA and wgmma, in two forms.  Replaces the TPU kernel
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
// contiguous), out (L, C, B) int32.
//
// Bound: bytes, x in and out (2 * 64 * 256 * B * 4: 2.15 GB at B = 2^14,
// 0.64 ms at 3.35 TB/s) and the rhs once; the int8 operations (2 * 64 * 256
// * 384 * B = 2.06e11 at 2^14) take 0.104 ms at 1979e12/s, the bf16 ones
// 0.208 ms at 989e12/s.  So the kernel is a stream at the memory's rate
// with the tensor cores off the critical path: x is read from device
// memory once, by TMA, and written once.
//
// Design: one persistent block an SM walks a contiguous run of
// (slot, 64-sample tile) pairs, slot-major, so it transposes one slot's rhs
// into shared memory once for many tiles (at most a few slots a block).
// Warps 0-7 are two consumer warpgroups; warpgroup 2 gives its registers to
// them (setmaxnreg 40 / 232), and its first warp is the producer.
//  - Two rings of x stages in shared memory, one a consumer warpgroup (4
//    stages of 64 c rows x 64 samples, 16 KB, for int8; 2 of 32 rows, 8 KB,
//    for bf16), each stage two TMA boxes of 32 samples (128-byte rows,
//    128-byte swizzle) completed on its `full` mbarrier and freed on its
//    `empty` one.  Tile t of a block goes to ring and warpgroup t % 2, and
//    the producer feeds the two rings independently (mbarrier.test_wait),
//    so one warpgroup's loads run on while the other multiplies and
//    stores.  Each warpgroup waits on every phase of its own stages, so no
//    parity wait can pass a phase early.  bf16 also asks each ring's
//    stage two loads ahead into L2 (cp.async.bulk.prefetch.tensor).
//  - M is the samples (64 a warpgroup), N the q rows, K = c.  A comes from
//    registers: a warpgroup reads its tile's x out of the ring once, casts
//    each element once (int8: the low bytes packed by __byte_perm; bf16:
//    cvt.rn.bf16x2.f32), and keeps the whole K = 256 in registers (32
//    registers int8, 64 bf16), then runs the three q groups on it.
//  - B is rhs[l] in shared memory, K-major (c contiguous) in the 128-byte
//    swizzled layout of the wgmma descriptor, its 384 q rows ordered
//    [0,64) [256,320) | [64,128) [320,384) | [128,256): each group of 128
//    rows is one m64n128 wgmma a k step (k32 s8 or k16 bf16), and the
//    fold's two rows q and q + 256 are columns n and n + 64 of one
//    accumulator, so in one thread.
//  - Two accumulators: group g + 1's wgmmas run while group g is folded,
//    truncated (bf16), masked and stored straight from its accumulator.
//    Rows gid and gid + 8 of a warp are samples 2 gid and 2 gid + 1 (a
//    permutation of M that A and D share), so each thread stores 8 bytes
//    and a warp 4 rows x 64 contiguous bytes.
//
// Where it was hard:
//  1. 8-bit wgmma takes K-major operands only, and x is B-major and rhs
//     Q-major.  A is in registers, so x needs no K-major copy: each thread
//     reads two adjacent samples of one c row (8 bytes) from the ring and
//     the pack puts 4 (int8) or 2 (bf16) c values of one sample in a
//     register.  rhs is transposed once a slot by the consumers (16 rows x
//     4 q of bytes, or 8 x 4 of bf16, through __byte_perm, into 16-byte
//     swizzled chunks) and fenced to the async proxy.
//  2. TMA needs 16-byte global strides and base: a batch B % 4 == 0 with
//     a 16-byte-aligned x takes the TMA path (a box past B is zero-filled,
//     a box wholly past it is not loaded); any other x takes the masked
//     path of the same kernel, where the producer warp loads the stage
//     with plain loads into the same swizzled layout.  The ragged last
//     tile's extra samples are never stored.
//  3. The tensor map comes from cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no -lcuda), encoded per call and passed as
//     a __grid_constant__ parameter.
//  4. Registers: 64 + 64 accumulator registers beside the A fragments (32
//     or 64) fit only in the 232 that setmaxnreg gives the consumers; at
//     the 168 of a 384-thread block they spill.
//  5. Shared memory: rhs takes 96 KB (int8) or 192 KB (bf16) of the 227;
//     the rings take the rest (128 KB or 32 KB).  So bf16 has a quarter of
//     int8's bytes in flight, which the L2 prefetch partly makes up.
//  6. The TMA, mbarrier and wgmma helpers live in this file, not in a
//     shared header, so no other kernel is rebuilt; K3's redesign can lift
//     them into one.
// Bank conflicts: the 128-byte swizzle puts the four tig lanes of an
// 8-byte ring read on two halves of the banks (2 wavefronts, the least
// for 256 bytes); the rhs transpose writes whole 128-byte rows a quarter
// warp.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

// Measurement cuts, off by default (tools/mac_dot_cuts_torch.py builds
// them; each gives wrong results): MAC_DOT_CUT_STORE computes the epilogue
// but stores nothing, MAC_DOT_CUT_CONSUME has the consumers only wait for
// and free the ring's stages (the TMA stream alone), MAC_DOT_HALF_MMA
// skips every other k step's wgmma, MAC_DOT_NO_PREFETCH drops bf16's L2
// prefetch.
#ifdef MAC_DOT_HALF_MMA
constexpr bool kHalfMma = true;
#else
constexpr bool kHalfMma = false;
#endif
#ifdef MAC_DOT_CUT_CONSUME
constexpr bool kCutConsume = true;
#else
constexpr bool kCutConsume = false;
#endif

constexpr int kC = 256;
constexpr int kQ = 384;
constexpr int kBN = 64;                        // samples a tile
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer's

template <bool kBf16>
struct Form {
  static constexpr int kEsize = kBf16 ? 2 : 1;
  static constexpr int kRhsBytes = kC * kQ * kEsize;  // rhs[l]
  static constexpr int kAtomBytes = kQ * 128;         // 128 bytes of K
  static constexpr int kChunkC = kBf16 ? 32 : 64;     // c rows a stage
  static constexpr int kChunks = kC / kChunkC;        // stages a tile
  static constexpr int kSubBytes = 32 * 4 * kChunkC;  // a 32-sample box
  static constexpr int kStageBytes = 2 * kSubBytes;
  static constexpr int kRing = kBf16 ? 2 : 4;         // stages a warpgroup
  static constexpr int kStages = 2 * kRing;
  // bf16: a ring's stages this far ahead are asked into L2 (0: none)
#ifdef MAC_DOT_NO_PREFETCH
  static constexpr int kPrefetch = 0;
#else
  static constexpr int kPrefetch = kBf16 ? 2 : 0;
#endif
  static constexpr int kKStep = kBf16 ? 16 : 32;      // c values a wgmma
  static constexpr int kKSteps = kC / kKStep;
  static constexpr int kSmemBytes =
      1024 + kRhsBytes + kStages * kStageBytes + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1 if the phase of `parity` has completed (without waiting)
__device__ __forceinline__ uint32_t mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int b, int c, int l, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"((uint64_t)map), "r"(b), "r"(c), "r"(l), "r"(bar)
      : "memory");
}

// Ask for a box of x in L2 ahead of its load (no shared memory, no barrier)
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int b,
                                             int c, int l) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global [%0, {%1, %2, %3}];" ::"l"(
          (uint64_t)map),
      "r"(b), "r"(c), "r"(l)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <class T, int N>
__device__ __forceinline__ void reg_fence(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// Descriptor of a K-major operand in the 128-byte swizzled layout: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define MAC_D8(c, i)                                                    \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),          \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define MAC_D64(c)                                                      \
  MAC_D8(c, 0), MAC_D8(c, 8), MAC_D8(c, 16), MAC_D8(c, 24), MAC_D8(c, 32), \
      MAC_D8(c, 40), MAC_D8(c, 48), MAC_D8(c, 56)
#define MAC_D_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (64 samples x 128 q) (+)= A (registers) . B (shared, descriptor)
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " MAC_D_LIST
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : MAC_D64("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAC_D_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : MAC_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// The low bytes of four int32, in order
__device__ __forceinline__ uint32_t pack_s8(uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Two int32 as bf16 (round to nearest even through float), lo first
__device__ __forceinline__ uint32_t pack_bf16(int lo, int hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
      : "=r"(r)
      : "f"((float)hi), "f"((float)lo));
  return r;
}

// The rhs column q of shared-memory row r: rows [0,128) [128,256)
// [256,384) are the groups q in [0,64) + [256,320), [64,128) + [320,384)
// and [128,256)
__device__ __forceinline__ int q_of_row(int r) {
  const int g = r >> 7;
  const int t = r & 127;
  if (g < 2) return (t < 64 ? 64 * g : 192 + 64 * g) + t;
  return 128 + t;
}

// rhs[l] (C x Q, Q contiguous) -> rhs_s, K-major and swizzled: the 16 bytes
// of K chunk ch of row n (c values 16 / esize * (8 ka + ch) ..) lie at
// ka * kAtomBytes + n * 128 + ((ch ^ (n & 7)) << 4).  A unit is 4 rows
// (4 consecutive q) x one chunk; the 8 lanes of a quarter warp write the 8
// chunks of one row.
template <bool kBf16>
__device__ __forceinline__ void load_rhs(const uint8_t* __restrict__ rhs_l,
                                         uint8_t* rhs_s, int tid) {
  using F = Form<kBf16>;
  constexpr int kRowsIn = kBf16 ? 8 : 16;                // c values a chunk
  constexpr int kUnits = (kQ / 4) * (kC / kRowsIn);
#pragma unroll 1
  for (int u = tid; u < kUnits; u += kConsumers) {
    const int ch = u & 7;
    const int rest = u >> 3;
    const int n = 4 * (rest % (kQ / 4));                // rows n .. n + 3
    const int q = q_of_row(n);
    const int ka = rest / (kQ / 4);
    const int c0 = (8 * ka + ch) * kRowsIn;
    uint32_t o[4][4];                                    // o[i]: row of q + i
    if constexpr (kBf16) {
      uint2 w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        w[r] = __ldg((const uint2*)(rhs_l + ((size_t)(c0 + r) * kQ + q) * 2));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        o[0][m] = __byte_perm(w[2 * m].x, w[2 * m + 1].x, 0x5410);
        o[1][m] = __byte_perm(w[2 * m].x, w[2 * m + 1].x, 0x7632);
        o[2][m] = __byte_perm(w[2 * m].y, w[2 * m + 1].y, 0x5410);
        o[3][m] = __byte_perm(w[2 * m].y, w[2 * m + 1].y, 0x7632);
      }
    } else {
      uint32_t w[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        w[r] = __ldg((const uint32_t*)(rhs_l + (size_t)(c0 + r) * kQ + q));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t t0 = __byte_perm(w[4 * m], w[4 * m + 1], 0x5140);
        const uint32_t t1 = __byte_perm(w[4 * m + 2], w[4 * m + 3], 0x5140);
        const uint32_t t2 = __byte_perm(w[4 * m], w[4 * m + 1], 0x7362);
        const uint32_t t3 = __byte_perm(w[4 * m + 2], w[4 * m + 3], 0x7362);
        o[0][m] = __byte_perm(t0, t1, 0x5410);
        o[1][m] = __byte_perm(t0, t1, 0x7632);
        o[2][m] = __byte_perm(t2, t3, 0x5410);
        o[3][m] = __byte_perm(t2, t3, 0x7632);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n + i;
      *(uint4*)(rhs_s + ka * F::kAtomBytes + row * 128 +
                ((ch ^ (row & 7)) << 4)) =
          make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
  }
}

__device__ __forceinline__ void store2(int32_t* p, uint32_t v0, uint32_t v1,
                                       int b, int batch) {
#ifdef MAC_DOT_CUT_STORE
  if ((v0 ^ v1) == 0xdeadbeefu) p[0] = b;  // keeps the epilogue's work
  return;
#endif
  if ((batch & 1) == 0 && b + 1 < batch) {
    *(int2*)p = make_int2((int)(v0 & 255u), (int)(v1 & 255u));
  } else {
    if (b < batch) p[0] = (int)(v0 & 255u);
    if (b + 1 < batch) p[1] = (int)(v1 & 255u);
  }
}

__device__ __forceinline__ uint32_t as_u32(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t as_u32(float v) {
  return (uint32_t)__float2int_rz(v);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
mac_dot_kernel(const __grid_constant__ CUtensorMap map,
               const int32_t* __restrict__ x,
               const uint8_t* __restrict__ rhs, int32_t* __restrict__ out,
               int batch, int tiles, int total, int tma) {
  using F = Form<kBf16>;
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int S = F::kStages;
  constexpr int R = F::kRing;
  constexpr int kChunkC = F::kChunkC;
  constexpr int kChunks = F::kChunks;
  constexpr int kSubBytes = F::kSubBytes;
  constexpr int kStageBytes = F::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms and TMA boxes start on 1024-byte shared addresses
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* rhs_s = smem;
  uint8_t* xs = smem + F::kRhsBytes;
  const uint32_t full0 = smem_addr(xs + S * kStageBytes);
  const uint32_t empty0 = full0 + 8 * S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the block's tiles first .. first + count - 1 of the (slot, tile) pairs,
  // slot major
  const int first = (int)((long long)blockIdx.x * total / gridDim.x);
  const int count =
      (int)((long long)(blockIdx.x + 1) * total / gridDim.x) - first;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, tma ? 1 : 32);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer warpgroup gives its registers to the consumers; one
    // warp of it issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != kConsumers / 32) return;
    // producer: tile t of the block goes to ring t % 2, each ring's stages
    // in order; the two rings are fed independently, so one warpgroup's
    // loads run on while the other multiplies
    int next[2] = {0, 1};                      // each ring's next tile
    int chunk[2] = {0, 0};                     // and its next stage
    while (next[0] < count || next[1] < count) {
      bool issued = false;
#pragma unroll
      for (int ring = 0; ring < 2; ++ring) {
        const int i = next[ring];
        if (i >= count) continue;
        const int j = first + i;
        const int k = chunk[ring];
        const int seq = (i >> 1) * kChunks + k;            // in the ring
        const int s = ring * R + seq % R;
        const uint32_t ph = (uint32_t)(seq / R) & 1;
        const uint32_t free_ = lane == 0 ? mbar_test(empty0 + 8 * s, ph ^ 1)
                                         : 0;
        if (!__shfl_sync(0xffffffffu, free_, 0)) continue;
        const int l = j / tiles;
        const int b0 = (j - l * tiles) * kBN;
        uint8_t* st = xs + s * kStageBytes;
        if (tma) {
          if (lane == 0) {
            const int boxes = b0 + 32 < batch ? 2 : 1;
            mbar_expect_tx(full0 + 8 * s, boxes * kSubBytes);
            for (int h = 0; h < boxes; ++h)
              tma_load(smem_addr(st + h * kSubBytes), &map, b0 + 32 * h,
                       k * kChunkC, l, full0 + 8 * s);
            const int seq2 = seq + F::kPrefetch;
            const int i2 = ring + 2 * (seq2 / kChunks);
            if (F::kPrefetch > 0 && i2 < count) {
              // the stage kPrefetch loads ahead in this ring: x in flight
              // beyond the 32 KB that the bf16 rings hold
              const int l2 = (first + i2) / tiles;
              const int b2 = (first + i2 - l2 * tiles) * kBN;
              for (int h = 0; h < (b2 + 32 < batch ? 2 : 1); ++h)
                tma_prefetch(&map, b2 + 32 * h, (seq2 % kChunks) * kChunkC,
                             l2);
            }
          }
        } else {
          const int32_t* src =
              x + ((size_t)l * kC + (size_t)k * kChunkC) * batch;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = b0 + 32 * h + lane;
            uint8_t* dst = st + h * kSubBytes + (lane & 3) * 4;
#pragma unroll 8
            for (int r = 0; r < kChunkC; ++r)
              *(int*)(dst + r * 128 + (((lane >> 2) ^ (r & 7)) << 4)) =
                  b < batch ? __ldg(src + (size_t)r * batch + b) : 0;
          }
          mbar_arrive(full0 + 8 * s);
        }
        issued = true;
        if (++chunk[ring] == kChunks) {
          chunk[ring] = 0;
          next[ring] += 2;
        }
      }
      if (!issued) __nanosleep(32);
    }
    return;
  }

  // consumers: warpgroup wg takes the block's tiles first + wg, + 2, ...
  // from ring wg, every phase of its stages in order
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp >> 2;
  const int w = warp & 3;                  // warp in the warpgroup
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // ring reads: samples 16 w + 2 gid, + 1 (8 bytes) of one c row
  const int ring_off = (w >> 1) * kSubBytes + 8 * (gid & 1);
  const int chunk16 = 4 * (w & 1) + (gid >> 1);
  const uint64_t desc0 = sw128_desc(smem_addr(rhs_s));
  uint32_t a[F::kKSteps][4];

  int i0 = 0;
  while (i0 < count) {                     // a slot's run of the tiles
    const int l = (first + i0) / tiles;
    int i1 = i0;
    while (i1 < count && (first + i1) / tiles == l) ++i1;
    consumers_sync();                      // the last slot's wgmmas are done
    load_rhs<kBf16>(rhs + (size_t)l * F::kRhsBytes, rhs_s, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    for (int i = i0 + ((i0 & 1) != wg ? 1 : 0); i < i1; i += 2) {
      const int b0 = (first + i - l * tiles) * kBN;
      const int seq0 = (i >> 1) * kChunks;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int s = wg * R + (seq0 + k) % R;
        mbar_wait(full0 + 8 * s, (uint32_t)((seq0 + k) / R) & 1);
        if (kCutConsume) {
          mbar_arrive(empty0 + 8 * s);
          continue;
        }
        const uint8_t* st = xs + s * kStageBytes + ring_off;
        auto ld = [&](int r) {
          return *(const uint2*)(st + r * 128 + ((chunk16 ^ (r & 7)) << 4));
        };
        constexpr int kPer = kChunkC / F::kKStep;      // k-steps a stage
#pragma unroll
        for (int kk = 0; kk < kPer; ++kk) {
          const int ks = k * kPer + kk;
          const int rb = kk * F::kKStep;
          if constexpr (kBf16) {
            const uint2 v0 = ld(rb + 2 * tig), v1 = ld(rb + 2 * tig + 1);
            const uint2 u0 = ld(rb + 8 + 2 * tig), u1 = ld(rb + 9 + 2 * tig);
            a[ks][0] = pack_bf16((int)v0.x, (int)v1.x);
            a[ks][1] = pack_bf16((int)v0.y, (int)v1.y);
            a[ks][2] = pack_bf16((int)u0.x, (int)u1.x);
            a[ks][3] = pack_bf16((int)u0.y, (int)u1.y);
          } else {
            uint2 v[4], u[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              v[m] = ld(rb + 4 * tig + m);
              u[m] = ld(rb + 16 + 4 * tig + m);
            }
            a[ks][0] = pack_s8(v[0].x, v[1].x, v[2].x, v[3].x);
            a[ks][1] = pack_s8(v[0].y, v[1].y, v[2].y, v[3].y);
            a[ks][2] = pack_s8(u[0].x, u[1].x, u[2].x, u[3].x);
            a[ks][3] = pack_s8(u[0].y, u[1].y, u[2].y, u[3].y);
          }
        }
        mbar_arrive(empty0 + 8 * s);
      }

      if (kCutConsume) continue;
      // the q groups on two accumulators: a group's wgmmas run while the
      // group before it is folded and stored
      const int bs = b0 + 16 * w + 2 * gid;  // the thread's samples bs, bs+1
      int32_t* ol = out + (size_t)l * kC * batch + bs;
      auto issue = [&](Acc(&acc)[64], int row0) {  // B: rows row0 .. of rhs_s
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < F::kKSteps; ++ks)
          if (!kHalfMma || !(ks & 1))
          wgmma(acc, a[ks],
                desc0 + ((uint32_t)((ks >> 2) * F::kAtomBytes + row0 * 128 +
                                    (ks & 3) * 32) >> 4),
                ks);
        wgmma_commit();
      };
      // columns 8 jn + 2 tig + e (rows gid, gid + 8: samples bs, bs + 1)
      auto store_folded = [&](Acc(&acc)[64], int g) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            store2(ol + (size_t)(64 * g + 8 * jn + 2 * tig + e) * batch,
                   as_u32(acc[4 * jn + e]) + as_u32(acc[4 * jn + 32 + e]),
                   as_u32(acc[4 * jn + 2 + e]) + as_u32(acc[4 * jn + 34 + e]),
                   bs, batch);
      };
      auto store_plain = [&](Acc(&acc)[64], int q0) {
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            store2(ol + (size_t)(q0 + 8 * jn + 2 * tig + e) * batch,
                   as_u32(acc[4 * jn + e]), as_u32(acc[4 * jn + 2 + e]), bs,
                   batch);
      };
      Acc acc0[64], acc1[64];
      issue(acc0, 0);
      issue(acc1, 128);
      wgmma_wait<1>();
      reg_fence(acc0);
      store_folded(acc0, 0);
      issue(acc0, 256);
      wgmma_wait<1>();
      reg_fence(acc1);
      store_folded(acc1, 1);
      wgmma_wait<0>();
      reg_fence(acc0);
      store_plain(acc0, 128);
#pragma unroll
      for (int ks = 0; ks < F::kKSteps; ++ks)
#pragma unroll
        for (int m = 0; m < 4; ++m) reg_fence(a[ks][m]);
    }
    i0 = i1;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int kNoEncoder = 10001;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 10100;  // + its CUresult
constexpr int kMisalignedRhs = 10002;

template <bool kBf16>
int launch(const void* x, const void* rhs, void* out, int slots, int batch,
           int device, cudaStream_t stream) {
  if ((uintptr_t)rhs % 8 != 0) return kMisalignedRhs;  // 8-byte rhs loads
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (batch + kBN - 1) / kBN;
  const int total = slots * tiles;
  const int grid = total < sms ? total : sms;  // at most one block an SM
  alignas(64) CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const int tma = batch % 4 == 0 && (uintptr_t)x % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return kNoEncoder;
    const cuuint64_t dims[3] = {(cuuint64_t)batch, (cuuint64_t)kC,
                                (cuuint64_t)slots};
    const cuuint64_t strides[2] = {(cuuint64_t)batch * 4,
                                   (cuuint64_t)kC * batch * 4};
    const cuuint32_t box[3] = {32, (cuuint32_t)Form<kBf16>::kChunkC, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(x), dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  }
  err = cudaFuncSetAttribute(mac_dot_kernel<kBf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Form<kBf16>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  mac_dot_kernel<kBf16><<<grid, kThreads, Form<kBf16>::kSmemBytes, stream>>>(
      map, (const int32_t*)x, (const uint8_t*)rhs, (int32_t*)out, batch,
      tiles, total, tma);
  return (int)cudaGetLastError();
}

}  // namespace

// x (slots, 256, batch) int32, rhs (slots, 256, 384) int8 (bf16 = 0) or
// bf16 (bf16 = 1), 8-byte aligned, out (slots, 256, batch) int32, on the
// device ordinal `device`; returns the CUDA error code, or 10001 (no
// cuTensorMapEncodeTiled), 10002 (rhs not 8-byte aligned), 10100 + the
// CUresult of a failed tensor-map encode.
extern "C" int mac_dot_launch(const void* x, const void* rhs, void* out,
                              int slots, int batch, int bf16, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || slots <= 0) return (int)cudaGetLastError();
  return bf16 ? launch<true>(x, rhs, out, slots, batch, device,
                             (cudaStream_t)stream)
              : launch<false>(x, rhs, out, slots, batch, device,
                              (cudaStream_t)stream);
}
