// LWE keyswitch totals for Hopper (K2): a one-hot product on the int8
// tensor cores, for any digit base 2^log2_base.
//
//   totals[s, c] = sum_{v=1..nv} sum_{limb<4} sum_r
//                    [digit(s, r) == v] * ab_limbs[v-1, limb, r, c] << 8*limb
//
// over the rows r = j * in_size + i (l-major), digit(s, r) =
// ((a[s, i] + prec) >> (32 - (j+1)*log2_base)) & (base - 1), nv = base - 1;
// sums wrap mod 2^32.  Column out + 1 of limb plane 0 holds a 1, so it
// counts the nonzero digits.  Replaces the TPU kernel
// nufhe_tpu/ops/pallas/keyswitch.py::keyswitch_mac (which loops its
// one-hot over v = 1..nv) and reads its operand, the JAX package's
// ab_limbs, bit for bit.
//
// Layout:
//   a         (B, in_size) int32, in_size % 64 == 0
//   ab_limbs  (nv, 4, rows, n_pad) int8, n_pad % 32 == 0
//   out       (B, out_w) int32, out_w = out + 2 <= n_pad: [a | b | count]
//
// The product: M = samples, N = 4 limbs x columns, K = nv digit values x
// rows, by mma.sync m16n8k32 s8 x s8 -> s32.  Two forms of one kernel:
//   - base 4 (the default parameters; kPacked): a stage holds all 3 digit
//     values, and the one-hot is built from 2-bit digit fields, below;
//   - any other base: a stage holds one digit value (a stage is (i-tile,
//     j, v)), the digits of all l rows of an i-tile lie in shared memory as
//     bytes (4 consecutive i a word, 128 samples x 24 words a plane, l
//     planes), and a one-hot register is one byte compare (__vcmpeq4)
//     against v.  Base 8 at l = 8 has 7/3 of base 4's K.
// Each limb's sum is at most rows * 128 = 2^20 in absolute value (2^21 at
// in_size 2048), so the int32 sums are exact; the
// epilogue recombines lo = sum_limb acc_limb << 8*limb in uint32 (wrapping
// on purpose) and writes each output once.
//
// Design: a block owns 128 samples and 32 columns (all 4 limbs of each, so
// the recombination happens in registers); 8 warps, 2 (samples) x 4
// (columns), a warp 64 samples x 8 columns x 4 limbs = 4 x 4 mma tiles.
// The block walks the rows in stages of 64 rows at one j (16 i-tiles x l
// stages):
//   - A, the one-hot matrix, never touches device memory.  For each i-tile
//     the block copies a (128 x 64) tile of a into shared memory
//     (cp.async, one i-tile ahead) and packs it into digit bytes: for 4
//     consecutive i of a sample, byte 3 of each (a + prec) word gives the
//     digits j = 0..3 and byte 2 the digits j = 4..7 (two words, P and Q).
//     A thread's A fragment (4 rows of one sample) is one such word,
//     shifted: lo = bit 0 and hi = bit 1 of the digit in each byte, and
//     the one-hot bytes of v = 1, 2, 3 are lo & ~hi, ~lo & hi and lo & hi
//     (masked to bit 0): 2 shifts and 3 logic ops give 3 A registers.
//   - B, the key, is column-major for the mma (4 consecutive rows of one
//     column in a register).  ab_limbs is row-major, so each stage's tile
//     (3 x 4 x 64 rows x 32 columns, 24 KB) is copied one stage ahead into
//     shared memory as it lies (cp.async, 16 bytes a copy), then
//     transposed in 4-row x 4-column byte blocks (8 byte permutes each)
//     into a double buffer whose row slots and words are swizzled so that
//     the stores and the 8-byte fragment loads are free of bank conflicts.
//     (A first version loaded the blocks with 4-byte loads straight into
//     registers: 16 L1 sectors a warp load, 6.5 ms a launch.)
//
// Shared memory, base 4: 2 x 24 KB key stages, 30 KB of raw key tile, 2 x
// 24 KB digit-byte planes (128 samples x 48 words, 32 used, padded against
// bank conflicts), 32 KB of a: 158 KB, one block an SM.  Other bases: 2 x
// 8 KB key stages, 10 KB of raw key tile, l x 12 KB digit planes, 32 KB of
// a: 154 KB at l = 8.
//
// Bound (default sizes, B = 2^14): the function is B * rows * (out + 1)
// int32 adds for the nonzero digits (3/4 of them on random input), 0.75 ms
// at the 67e12/s the data sheet gives for non-tensor units; the tensor-core
// form does 2 * B * 3*rows * 4*n_pad = 1.65e12 int8 operations, 0.83 ms at
// the dense int8 rate of 1979e12/s.  L2 traffic: the 50 MB operand once per
// block row of 128 samples, 2^14 / 128 x 50 MB = 6.4 GB, plus a tile of a
// per column tile, 16 x 64 MB = 1 GB; device memory: the operand once (a
// wave of blocks shares one column slice), a and the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // samples a block
constexpr int kBC = 32;        // output columns a block (x 4 limbs = N 128)
constexpr int kTI = 64;        // i values a stage: two K-chunks of 32 rows
constexpr int kLimbs = 4;
constexpr int kPQStride = 48;  // words a sample in a base-4 digit-byte plane
constexpr int kDigStride = 24; // words a sample in a digit plane (16 used)
constexpr int kChunkWords = kBC * 8;                          // 32 cols x 32 rows
constexpr int kPQWords = kBM * kPQStride;                     // 24 KB
constexpr int kDigWords = kBM * kDigStride;                   // 12 KB
constexpr int kRawAWords = kBM * kTI;                         // 32 KB
constexpr int kAUnits = kBM * (kTI / 4) / kThreads;                      // 8
constexpr uint32_t kOnes = 0x01010101u;

// kNV digit values a stage: 3 (all of base 4, packed 2-bit digits) or 1
// (any base, a stage per value)
template <bool kPacked>
struct Form {
  static constexpr int kNV = kPacked ? 3 : 1;
  static constexpr int kTransWords = kNV * kLimbs * 2 * kChunkWords;
  static constexpr int kRawBRows = kNV * kLimbs * kTI;
  static constexpr int kRawBWords = kRawBRows / 4 * 5 * (kBC / 4);
  static constexpr int kBUnits = kRawBRows / 4 * (kBC / 4) / kThreads;
  static constexpr int kBCopies = kRawBRows * kBC / 16 / kThreads;
  static int smem_bytes(int decomp_length) {
    const int planes = kPacked ? 2 * kPQWords : decomp_length * kDigWords;
    return (2 * kTransWords + planes + kRawAWords + kRawBWords) *
           (int)sizeof(uint32_t);
  }
};

// Row slot of column n in a (v, limb, chunk) block of the key stage: a
// permutation inside each group of 4, so that the 4 columns of a fragment
// load and 4 column groups of a store fall in different 8-bank groups.
__device__ __forceinline__ int slot(int n, int c) {
  return (n & ~3) | ((n + (n >> 2) + c) & 3);
}

// and the word order inside a slot: columns 16..31 swap the halves, so
// that a store's 8 column groups and 4 row quads hit 32 different banks
// (even, so an 8-byte fragment load stays in order)
__device__ __forceinline__ int swz(int n) { return ((n >> 4) & 1) << 2; }

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
keyswitch_kernel(const int32_t* __restrict__ a, const int8_t* __restrict__ key,
                 int32_t* __restrict__ out, int batch, int in_size,
                 int decomp_length, int log2_base, int n_pad, int out_w) {
  using F = Form<kPacked>;
  constexpr int kNV = F::kNV;
  constexpr int kTransWords = F::kTransWords;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* trans = smem;                     // [2][kTransWords]
  // base 4: [2][kPQWords] packed planes; else [l][kDigWords] digit planes
  uint32_t* pq = smem + 2 * kTransWords;
  uint32_t* raw_a =
      pq + (kPacked ? 2 * kPQWords : decomp_length * kDigWords);   // [kBM][kTI]
  uint32_t* raw_b = raw_a + kRawAWords;       // [kRawBWords]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int s0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBC;
  const int rows = in_size * decomp_length;
  const int n_tiles = in_size / kTI;
  // a stage is (i-tile t, j, digit-value chunk vc); base 4 has one chunk
  const int n_vc = kPacked ? 1 : (1 << log2_base) - 1;
  const int per_tile = decomp_length * n_vc;
  const int n_stages = n_tiles * per_tile;
  const uint32_t prec = 1u << (32 - (1 + log2_base * decomp_length));

  // the a tile of i-tile t -> raw_a (zeros past the batch)
  auto load_a = [&](int t) {
#pragma unroll
    for (int q = 0; q < kAUnits; ++q) {
      const int k = tid + kThreads * q;
      const int s = k >> 4;
      const int grp = k & 15;
      const bool ok = s0 + s < batch;
      const int32_t* src =
          ok ? a + (size_t)(s0 + s) * in_size + t * kTI + 4 * grp : a;
      cp_async16(raw_a + s * kTI + 4 * grp, src, ok);
    }
  };

  // raw_a -> digit bytes: P (digits j = 0..3, byte 3) and Q (j = 4..7,
  // byte 2) of 4 consecutive i, byte b from i = 4*grp + b
  auto build_pq = [&](uint32_t* dst) {
#pragma unroll
    for (int q = 0; q < kAUnits; ++q) {
      const int k = tid + kThreads * q;
      const int s = k >> 4;
      const int grp = k & 15;
      const uint4 x =
          *reinterpret_cast<const uint4*>(raw_a + s * kTI + 4 * grp);
      const uint32_t u01 = __byte_perm(x.x + prec, x.y + prec, 0x7362);
      const uint32_t u23 = __byte_perm(x.z + prec, x.w + prec, 0x7362);
      uint2 w;
      w.x = __byte_perm(u01, u23, 0x7632);
      w.y = __byte_perm(u01, u23, 0x5410);
      *reinterpret_cast<uint2*>(dst + s * kPQStride + 2 * grp) = w;
    }
  };

  // raw_a -> digit bytes of every j (any base): plane j, sample s, word
  // grp holds the digits of i = 4*grp .. 4*grp + 3, byte b from 4*grp + b
  auto build_digits = [&]() {
    const uint32_t dmask = (1u << log2_base) - 1;
#pragma unroll
    for (int q = 0; q < kAUnits; ++q) {
      const int k = tid + kThreads * q;
      const int s = k >> 4;
      const int grp = k & 15;
      const uint4 x =
          *reinterpret_cast<const uint4*>(raw_a + s * kTI + 4 * grp);
      const uint32_t y0 = x.x + prec, y1 = x.y + prec, y2 = x.z + prec,
                     y3 = x.w + prec;
      for (int j = 0; j < decomp_length; ++j) {
        const int sh = 32 - (j + 1) * log2_base;
        pq[j * kDigWords + s * kDigStride + grp] =
            ((y0 >> sh) & dmask) | (((y1 >> sh) & dmask) << 8) |
            (((y2 >> sh) & dmask) << 16) | (((y3 >> sh) & dmask) << 24);
      }
    }
  };
  auto build_a = [&](int t) {
    if constexpr (kPacked) build_pq(pq + (t & 1) * kPQWords);
    else build_digits();
  };

  // stage st's key tile -> raw_b, row-major, 16 bytes a copy: row k
  // (k = vl*64 + r, plane vl = (v-1)*4 + limb, r < 64) at word
  // (k + k/4) * 8, an empty row after every 4 against bank conflicts
  auto load_b = [&](int st) {
    const int t = st / per_tile;
    const int jv = st - t * per_tile;
    const int j = jv / n_vc;
    const int plane0 = (jv - j * n_vc) * kNV * kLimbs;   // (v-1)*4 + limb
    const int r0 = j * in_size + t * kTI;
#pragma unroll
    for (int q = 0; q < F::kBCopies; ++q) {
      const int u = tid + kThreads * q;
      const int k = u >> 1;
      const int h = u & 1;
      const int vl = k >> 6;
      const int8_t* src =
          key + ((size_t)(plane0 + vl) * rows + r0 + (k & 63)) * n_pad +
          col0 + 16 * h;
      cp_async16(raw_b + (k + (k >> 2)) * 8 + 4 * h, src, true);
    }
  };

  // raw_b -> key stage st % 2 in shared memory, column-major: block
  // (vl, c) holds rows 32c .. 32c+31; the word at slot(n, c)*8 + (pw ^ swz(n))
  // holds rows 32c + 4pw .. +3 of column n, byte k from row 32c + 4pw + k.
  // Unit (vl, rq, cq): rows 4rq..4rq+3, columns 4cq..4cq+3, transposed
  // with 8 byte permutes.
  auto store_b = [&](int st) {
    uint32_t* dst = trans + (st & 1) * kTransWords;
#pragma unroll
    for (int q = 0; q < F::kBUnits; ++q) {
      const int u = tid + kThreads * q;
      const int cq = u & 7;
      const int rq = (u >> 3) & 15;
      const int vl = u >> 7;
      const int k0 = vl * 64 + 4 * rq;
      const uint32_t* src = raw_b + (k0 + (k0 >> 2)) * 8 + cq;
      const uint32_t r0 = src[0], r1 = src[8], r2 = src[16], r3 = src[24];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const int c = rq >> 3;
      const int pw = (rq & 7) ^ swz(4 * cq);
      uint32_t* base = dst + (vl * 2 + c) * kChunkWords + pw;
      base[slot(4 * cq + 0, c) * 8] = __byte_perm(t0, t2, 0x5410);
      base[slot(4 * cq + 1, c) * 8] = __byte_perm(t0, t2, 0x7632);
      base[slot(4 * cq + 2, c) * 8] = __byte_perm(t1, t3, 0x5410);
      base[slot(4 * cq + 3, c) * 8] = __byte_perm(t1, t3, 0x7632);
    }
  };

  int acc[4][kLimbs][4];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int f = 0; f < kLimbs; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][f][e] = 0;

  load_a(0);
  load_b(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  build_a(0);
  store_b(0);
  __syncthreads();

  for (int st = 0; st < n_stages; ++st) {
    const int t = st / per_tile;
    const int jv = st - t * per_tile;
    const int j = jv / n_vc;
    const int v0 = jv - j * n_vc + 1;     // the stage's digit value (any base)
    // the copies for the next stage (and, at a tile's first stage, the
    // next tile's a) run while this stage computes
    if (st + 1 < n_stages) load_b(st + 1);
    if (jv == 0 && t + 1 < n_tiles) load_a(t + 1);
    cp_async_commit();

    const uint32_t* tb = trans + (st & 1) * kTransWords;
    const uint32_t* pqb = pq + (t & 1) * kPQWords;
    const uint32_t* dgb = pq + j * kDigWords;
    const int sh = 6 - 2 * (j & 3);
    const bool use_q = j >= 4;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // B fragments of this warp's 8 columns, every digit value and limb:
      // rows 8tig..8tig+3 (logical k tig*4..) and 8tig+4..+7 (k 16+tig*4..)
      const int n = 8 * wn + g;
      const int bslot = slot(n, c) * 8 + ((2 * tig) ^ swz(n));
      uint2 bf[kNV][kLimbs];
#pragma unroll
      for (int v = 0; v < kNV; ++v)
#pragma unroll
        for (int f = 0; f < kLimbs; ++f)
          bf[v][f] = *reinterpret_cast<const uint2*>(
              tb + ((v * kLimbs + f) * 2 + c) * kChunkWords + bslot);
#pragma unroll
      for (int mf = 0; mf < 4; ++mf) {
        const int sl = 64 * wm + 16 * mf + g;
        uint32_t af[kNV][4];
        if constexpr (kPacked) {
          const uint4 plo = *reinterpret_cast<const uint4*>(
              pqb + sl * kPQStride + 16 * c + 4 * tig);
          const uint4 phi = *reinterpret_cast<const uint4*>(
              pqb + (sl + 8) * kPQStride + 16 * c + 4 * tig);
          // a0: sample g rows 8tig..+3, a1: sample g+8, a2/a3: rows +4..+7
          const uint32_t w[4] = {use_q ? plo.y : plo.x, use_q ? phi.y : phi.x,
                                 use_q ? plo.w : plo.z, use_q ? phi.w : phi.z};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t lo = w[r] >> sh;
            const uint32_t hi = w[r] >> (sh + 1);
            af[0][r] = lo & ~hi & kOnes;      // digit 1
            af[1][r] = ~lo & hi & kOnes;      // digit 2
            af[kNV - 1][r] = lo & hi & kOnes; // digit 3
          }
        } else {
          // the same rows from the digit bytes: one compare a register
          const uint2 dlo = *reinterpret_cast<const uint2*>(
              dgb + sl * kDigStride + 8 * c + 2 * tig);
          const uint2 dhi = *reinterpret_cast<const uint2*>(
              dgb + (sl + 8) * kDigStride + 8 * c + 2 * tig);
          const uint32_t w[4] = {dlo.x, dhi.x, dlo.y, dhi.y};
          const uint32_t vv = (uint32_t)v0 * kOnes;
#pragma unroll
          for (int r = 0; r < 4; ++r) af[0][r] = __vcmpeq4(w[r], vv) & kOnes;
        }
#pragma unroll
        for (int v = 0; v < kNV; ++v)
#pragma unroll
          for (int f = 0; f < kLimbs; ++f)
            mma_s8(acc[mf][f], af[v], bf[v][f].x, bf[v][f].y);
      }
    }

    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) store_b(st + 1);
    if (jv == per_tile - 1 && t + 1 < n_tiles) build_a(t + 1);
    __syncthreads();
  }

  // epilogue: thread holds columns 8wn + 2tig, +1 of samples g and g+8 of
  // each m tile, every limb
#pragma unroll
  for (int mf = 0; mf < 4; ++mf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + 64 * wm + 16 * mf + g + 8 * h;
      if (s >= batch) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * wn + 2 * tig + e;
        if (col >= out_w) continue;
        uint32_t v = 0;
#pragma unroll
        for (int f = 0; f < kLimbs; ++f)
          v += (uint32_t)acc[mf][f][2 * h + e] << (8 * f);
        out[(size_t)s * out_w + col] = (int32_t)v;
      }
    }
  }
}

template <bool kPacked>
cudaError_t launch(const int32_t* a, const int8_t* ab_limbs, int32_t* out,
                   int batch, int in_size, int decomp_length, int log2_base,
                   int n_pad, int out_w, cudaStream_t stream) {
  const int smem = Form<kPacked>::smem_bytes(decomp_length);
  cudaError_t err = cudaFuncSetAttribute(
      keyswitch_kernel<kPacked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kBM - 1) / kBM, n_pad / kBC);
  keyswitch_kernel<kPacked><<<grid, kThreads, smem, stream>>>(
      a, ab_limbs, out, batch, in_size, decomp_length, log2_base, n_pad,
      out_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int keyswitch_launch(const void* a, const void* ab_limbs, void* out,
                                int batch, int in_size, int decomp_length,
                                int log2_base, int n_pad, int out_w,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  const auto* x = (const int32_t*)a;
  const auto* k = (const int8_t*)ab_limbs;
  auto* o = (int32_t*)out;
  const auto s = (cudaStream_t)stream;
  // base 4 with its 2-bit digits in bytes 3 and 2 of a + prec (l <= 8)
  if (log2_base == 2 && decomp_length <= 8)
    err = launch<true>(x, k, o, batch, in_size, decomp_length, log2_base,
                       n_pad, out_w, s);
  else
    err = launch<false>(x, k, o, batch, in_size, decomp_length, log2_base,
                        n_pad, out_w, s);
  return (int)err;
}
