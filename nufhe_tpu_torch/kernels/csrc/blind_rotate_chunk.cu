// The chunked blind rotation (K3), for Hopper: `chunk` consecutive CMUX
// steps, from step `start`, in one launch, in both engine modes, with the
// MAC on the int8 tensor cores.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32.  Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk (the
// chunked launch whose accumulator stays in VMEM across the chunk's steps,
// with the MAC as int8 products on the MXU, ops/rows_engine.py
// transformed_mac -> _mac_dot_raw).  The output equals `chunk` launches of
// K1 (cmux_step.cu) and of K4 (lanes_step.cu) bit for bit.
//
// Layout (the port's own):
//   acc     (B, 2, 1024) int32, batch-major, contiguous
//   bara_t  (n, B) int32 in [0, 2048): the rotation amounts, one row a step
//   key     the whole transformed key: (n, 4, 2, 64, 32) int64 exact, or
//           (n, 2, 4, 2, 64, 32) rounded (ops/transform.py), residues mod
//           2^38, centred
//   out     (B, 2, 1024) int32 (a separate buffer; the wrapper allocates it)
//   start   first step; the wrapper checks 0 <= start, start + chunk <= n
//
// Design: a block of 512 threads holds kS = 4 samples, their accumulators
// in shared memory (q-layout: coefficient i*32 + j at j*32 + i) for the
// whole chunk.  A step is K4's arithmetic (lanes_step.cu) on those samples:
//   1-3. a warp a (sample, digit polynomial): the rotation (X^p - 1) * acc
//      and the l=2 gadget digit straight into registers (row r of the
//      transform in x[r], lane k its coefficient k), the exact forward
//      Nussbaumer DIT there (the twiddles are lane rotations, shuffles),
//      and the split into int8 limbs a0, a1 (value = a0 + 256 a1), stored
//      by MAC slot p (frequency rev6(p)): per slot, [g][limb][sample][32];
//   4. the MAC: per slot, the (Q x 256) . (256 x kS) product, Q = 320 exact
//      (groups B, A0..A3) or 256 rounded (A0..A3), by mma.sync m16n8k32
//      s8 x s8 -> s32, the samples on the mma's N (4 of its 8 columns);
//      a warp owns a slot.  The A operand is the key, built on chip: the
//      warp loads the slot's int64 residues (256 exact, 512 rounded) from
//      device memory, splits each into the two-sided int8 limbs of
//      ops/transform.key_limbs_host (side 0 from +v, side 1 from -v mod
//      2^38 exact; each stored side rounded, 64*round(.)/64, in the rounded
//      form), and writes per (g, o, limb) one 64-byte row, side 0 then side
//      1, reversed: the Toeplitz operand's entry (k, u) is byte 31 - k + u
//      of it, so a fragment's 4 consecutive K bytes are one unaligned word
//      of the row.  The two 16-row M tiles of an output polynomial take the
//      odd and the even outputs k, so the 8 fragment registers a thread
//      needs from a row all come from the same 4 words (4 shared loads, 6
//      funnel shifts).  The limbs are split with 32-bit arithmetic on any
//      representative mod 2^38 (no centring), the 4 balanced radix-2^8
//      digits of a word at once.  A limb row meets the digits' limb 0 in
//      its own group and limb 1 in the next (the table of
//      ops/transform._mac_limb_table), so 6 row fragments feed 9 mma (4
//      and 7 rounded).  The groups of an output lie in one thread, so they
//      are recombined in registers (lo = A0 + A1<<8 + A2<<16 + A3<<24 in
//      uint32, hi = B); lo goes to the lo channel, hi over the slot's
//      consumed limbs;
//   5-6. a warp a channel polynomial: the unscaled inverse DIT in uint32
//      registers (wraparound is the A channel's mod 2^32; the B channel
//      stays below 2^24 and is exact), the fold, and c = lo + (hi >> 6)
//      (or lo) added to the accumulator.
// Three block barriers a step.  (A first version ran the transforms in
// shared memory, a warp a butterfly row pair and a barrier a stage: 94 ms
// a launch exact, of which the transforms took 40%.)
// The 5.24 MB expanded operand that K4 reads never exists here: the key
// read is 131 KB (262 KB rounded) a block and step, shared by 4 samples.
//
// Shared memory a block: 4 x 8 KB accumulators, 4 x 16 KB lo channel,
// 4 x 16 KB limbs / hi channel, 16 warps x 3 KB of key rows (2 KB
// rounded): 208 KB exact, 192 KB rounded, one block an SM.
//
// Bound: the MAC is 64 * 256 * Q int8 multiply-adds a sample and step
// (5.24 M exact, 4.19 M rounded); at batch 2^14 and chunk 50, 8.6e12
// operations exact, 4.34 ms at the H100's dense int8 rate of 1979e12/s
// (3.47 ms rounded).  Bytes: the accumulator in and out, the rotation
// amounts and 50 key rows (6.6 MB exact).  L2 traffic: one key row a
// block and step, 2^14 / 4 x 131 KB = 0.54 GB a step exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 1024;
constexpr int kR = 32;
constexpr int kL = 64;
constexpr int kMask1 = 2;
constexpr int kDecomp = 2;
constexpr int kG = kMask1 * kDecomp;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kS = 4;                           // samples a block
constexpr int kSide = kG * kMask1 * kL * kR;    // int64 values in one key side
constexpr int kAccWords = kMask1 * kN;          // a sample's accumulator
constexpr int kWorkWords = kMask1 * kL * kR;    // a sample's lo channel
constexpr int kRegionWords = kS * 64;           // a slot's limbs, or hi
constexpr int kRowWords = 16;                   // one 64-byte key limb row
static_assert(kS * kG == kWarps, "a warp a (sample, digit polynomial)");
static_assert(2 * kS * kMask1 == kWarps, "a warp a channel polynomial");

__device__ __forceinline__ int rev6(int s) {
  return (int)(__brev((unsigned)s) >> 26);
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

__host__ __device__ constexpr int rev6c(int j) {
  return ((j & 1) << 5) | ((j & 2) << 3) | ((j & 4) << 1) | ((j & 8) >> 1) |
         ((j & 16) >> 3) | ((j & 32) >> 5);
}

// The L-point Cooley-Tukey DIT over S' = Z[Y]/(Y^32 + 1) (as cmux_body.cuh's
// dft_l) on one polynomial held by a warp: row r in x[r], lane k its
// coefficient k.  The twiddle Y^tw is a rotation across the lanes (a
// shuffle) with a sign; every index is a constant once unrolled.  Input in
// bit-reversed row order, output natural.
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

// The MAC of one slot p (frequency rev6(p)) for the block's samples; the
// calling warp owns the slot.
template <bool kRounded>
__device__ __forceinline__ void mac_slot(
    int p, const long long* __restrict__ key_row, uint32_t* arow,
    uint32_t* work, uint32_t* limbs) {
  constexpr int kRows = kRounded ? 4 : 6;    // limb rows a (g, o)
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // the slot's key residues -> limb rows: row (g, o, L) byte 31 - r is
  // limb L of side 0 at rotation r, byte 63 - r that of side 1
  const int t = rev6(p);
  uint8_t* rb = reinterpret_cast<uint8_t*>(arow);
#pragma unroll
  for (int go = 0; go < kG * kMask1; ++go) {
    const size_t idx = ((size_t)go * kL + t) * kR + lane;
    uint32_t l0[kRows], l1[kRows];
    if constexpr (kRounded) {
      split_rounded(__ldg(key_row + idx), l0);
      split_rounded(__ldg(key_row + kSide + idx), l1);
    } else {
      const long long v = __ldg(key_row + idx);
      split_exact(v, l0);
      split_exact(-v, l1);      // side 1: -v mod 2^38
    }
#pragma unroll
    for (int L = 0; L < kRows; ++L) {
      uint8_t* row = rb + (go * kRows + L) * 64;
      row[31 - lane] = (uint8_t)l0[L];
      row[63 - lane] = (uint8_t)l1[L];
    }
  }

  // B fragments: sample gid's limbs i of digit polynomial g, bytes
  // 4tig..4tig+3 and 16+4tig..+3 (samples past kS are zero columns)
  const uint32_t* reg = limbs + p * kRegionWords;
  uint32_t bf[kG][2][2];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t* w = reg + ((g * 2 + i) * kS + gid) * 8;
      bf[g][i][0] = gid < kS ? w[tig] : 0u;
      bf[g][i][1] = gid < kS ? w[tig + 4] : 0u;
    }
  __syncwarp();   // the rows are written; the limbs are read (hi goes there)

  // M tiles: the odd outputs k (tile 0: row gid is k = 4gid + 3, row
  // gid + 8 is k = 4gid + 1) and the even ones (tile 1: 4gid + 2, 4gid).
  // With that order every fragment of a row comes from the same 4 words
  // w, w+1, w+4, w+5 (w = 7 - gid + tig), at byte shifts 0/2 (tile 0) and
  // 1/3 (tile 1): entry (k, u) is byte 31 - k + u, and u = 4tig (+16).
  const int w = 7 - gid + tig;
#pragma unroll 1
  for (int o = 0; o < kMask1; ++o) {
    int d[2][5][4];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[tile][s][e] = 0;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int L = 0; L < kRows; ++L) {
        const uint32_t* row =
            arow + ((g * kMask1 + o) * kRows + L) * kRowWords + w;
        const uint32_t w0 = row[0], w1 = row[1], w4 = row[4], w5 = row[5];
        const uint32_t f[2][4] = {
            {w0, __funnelshift_r(w0, w1, 16), w4, __funnelshift_r(w4, w5, 16)},
            {__funnelshift_r(w0, w1, 8), __funnelshift_r(w0, w1, 24),
             __funnelshift_r(w4, w5, 8), __funnelshift_r(w4, w5, 24)}};
        // (group, digit limb) pairs that read limb row L
        // (ops/transform._mac_limb_table)
        int s0, s1;
        if (kRounded) {
          s0 = L;
          s1 = L + 1 < 4 ? L + 1 : -1;
        } else {
          s0 = L < 5 ? L : -1;
          s1 = L == 5 ? 1 : (L >= 1 && L <= 3 ? L + 1 : -1);
        }
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          const uint32_t(&a)[4] = f[tile];
          if (s0 >= 0)
            mma_s8(d[tile][s0], a[0], a[1], a[2], a[3], bf[g][0][0],
                   bf[g][0][1]);
          if (s1 >= 0)
            mma_s8(d[tile][s1], a[0], a[1], a[2], a[3], bf[g][1][0],
                   bf[g][1][1]);
        }
      }
    }
    // recombine the groups; lo to the lo channel, hi over the slot's limbs
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * gid + (e < 2 ? 3 : 1) - tile;
        const int n = 2 * tig + (e & 1);
        if (n >= kS) continue;
        const int a = kRounded ? 0 : 1;
        const uint32_t lo = (uint32_t)d[tile][a][e] +
                            ((uint32_t)d[tile][a + 1][e] << 8) +
                            ((uint32_t)d[tile][a + 2][e] << 16) +
                            ((uint32_t)d[tile][a + 3][e] << 24);
        work[n * kWorkWords + (o * kL + p) * kR + k] = lo;
        if (!kRounded)
          limbs[p * kRegionWords + (n * kMask1 + o) * kR + k] =
              (uint32_t)d[tile][0][e];
      }
  }
  __syncwarp();   // the next slot rewrites the key rows
}

template <bool kRounded>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_chunk_kernel(const int32_t* __restrict__ acc_in,
                          int32_t* __restrict__ acc_out,
                          const int32_t* __restrict__ bara_t,
                          const long long* __restrict__ key, int batch,
                          int start, int chunk, uint32_t offset,
                          int log2_base) {
  constexpr int kRows = kRounded ? 4 : 6;
  constexpr int kKeyRow = kRounded ? 2 * kSide : kSide;   // int64 a step
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc_s = smem;                        // [kS][2][1024] q-layout
  uint32_t* work = acc_s + kS * kAccWords;       // [kS][4096]
  uint32_t* limbs = work + kS * kWorkWords;      // [64 slots][kRegionWords]
  uint32_t* arows = limbs + kL * kRegionWords;   // [warps][8][kRows][16]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kS;
  const int ns = min(kS, batch - b0);
  uint32_t* arow = arows + warp * (kG * kMask1 * kRows * kRowWords);

  for (int e = tid; e < kS * kAccWords; e += kThreads) {
    const int s = e >> 11;
    const int on = e & (kAccWords - 1);
    const uint32_t v =
        s < ns ? (uint32_t)acc_in[(size_t)(b0 + s) * kAccWords + on] : 0u;
    acc_s[s * kAccWords + (on & ~(kN - 1)) + q_of(on & (kN - 1))] = v;
  }
  __syncthreads();

  const int base_mask = (1 << log2_base) - 1;
  const int half = 1 << (log2_base - 1);
  const int lane = tid & 31;
  for (int st = 0; st < chunk; ++st) {
    const size_t step = (size_t)(start + st);
    const long long* key_row = key + step * kKeyRow;

    // 1-3. a warp a (sample, digit polynomial g = o*2 + d): rotation and
    // digits into registers (block j of the polynomial in row rev6(j), odd
    // rows zero), the forward transform, the split into int8 limbs a0, a1
    // by MAC slot p = rev6(frequency)
    {
      const int s = warp / kG;
      const int g = warp % kG;
      const int p = s < ns
          ? (__ldg(bara_t + step * batch + b0 + s) & (2 * kN - 1)) : 0;
      const uint32_t* a = acc_s + s * kAccWords + (g / kDecomp) * kN;
      const int shift = 32 - (g % kDecomp + 1) * log2_base;
      int x[kL];
#pragma unroll
      for (int j = 0; j < kL / 2; ++j) {
        const int src = (lane * 32 + j - p) & (2 * kN - 1);
        uint32_t v = a[q_of(src & (kN - 1))];
        if (src >= kN) v = 0u - v;
        const uint32_t shifted = v - a[j * 32 + lane] + offset;
        x[rev6c(j)] = (int)((shifted >> shift) & base_mask) - half;
        x[rev6c(j) + 1] = 0;
      }
      dft_regs<int, false>(x, lane);
      uint8_t* lb = reinterpret_cast<uint8_t*>(limbs);
#pragma unroll
      for (int f = 0; f < kL; ++f) {
        const int a0 = ((x[f] + 128) & 255) - 128;
        const int a1 = (x[f] - a0) >> 8;
        uint8_t* reg = lb + rev6c(f) * kRegionWords * 4 + (g * 2 * kS + s) * 32;
        reg[lane] = (uint8_t)a0;
        reg[kS * 32 + lane] = (uint8_t)a1;
      }
    }
    __syncthreads();

    // 4. the MAC, a warp a slot
    for (int p = warp; p < kL; p += kWarps)
      mac_slot<kRounded>(p, key_row, arow, work, limbs);
    __syncthreads();

    // 5-6. a warp a channel polynomial (lo of (s, o), and hi in the exact
    // form): the inverse transform (bit-reversed rows in, natural out), the
    // fold C_j = P_j + Y P_{j+32}, coefficient i*32 + j = C_j[i] at q-layout
    // j*32 + i; hi >> 6 waits in its rows 0..31, lo + (hi >> 6) (or lo) is
    // added to the accumulator
    if (!kRounded || warp < kS * kMask1) {
      const bool hi_warp = warp >= kS * kMask1;
      const int so = warp % (kS * kMask1);       // s * 2 + o
      uint32_t* src = hi_warp ? limbs + so * kR : work + so * kL * kR;
      const int stride = hi_warp ? kRegionWords : kR;
      uint32_t x[kL];
#pragma unroll
      for (int r = 0; r < kL; ++r) x[r] = src[r * stride + lane];
      dft_regs<uint32_t, true>(x, lane);
#pragma unroll
      for (int j = 0; j < kL / 2; ++j) {
        uint32_t y = __shfl_sync(0xffffffffu, x[j + 32], (lane + 31) & 31);
        if (lane == 0) y = 0u - y;
        x[j] += y;
      }
      if (hi_warp) {
#pragma unroll
        for (int j = 0; j < kL / 2; ++j)
          src[j * stride + lane] = (uint32_t)((int32_t)x[j] >> 6);
      }
      if constexpr (!kRounded) __syncthreads();   // every warp is here
      if (!hi_warp) {
        uint32_t* acc = acc_s + so * kN + lane;
#pragma unroll
        for (int j = 0; j < kL / 2; ++j) {
          uint32_t delta = x[j];
          if constexpr (!kRounded) delta += limbs[j * kRegionWords + so * kR + lane];
          acc[j * 32] += delta;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < kS * kAccWords; e += kThreads) {
    const int s = e >> 11;
    const int on = e & (kAccWords - 1);
    if (s < ns)
      acc_out[(size_t)(b0 + s) * kAccWords + on] = (int32_t)
          acc_s[s * kAccWords + (on & ~(kN - 1)) + q_of(on & (kN - 1))];
  }
}

template <bool kRounded>
cudaError_t launch(const int32_t* acc_in, int32_t* acc_out,
                   const int32_t* bara_t, const long long* key, int batch,
                   int start, int chunk, uint32_t offset, int log2_base,
                   cudaStream_t stream) {
  constexpr int kRows = kRounded ? 4 : 6;
  const int smem = (kS * (kAccWords + kWorkWords) + kL * kRegionWords +
                    kWarps * kG * kMask1 * kRows * kRowWords) *
                   (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_chunk_kernel<kRounded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  blind_rotate_chunk_kernel<kRounded>
      <<<(batch + kS - 1) / kS, kThreads, smem, stream>>>(
          acc_in, acc_out, bara_t, key, batch, start, chunk, offset,
          log2_base);
  return cudaGetLastError();
}

}  // namespace

extern "C" int blind_rotate_chunk_launch(const void* acc_in, void* acc_out,
                                         const void* bara_t, const void* key,
                                         int batch, int start, int chunk,
                                         unsigned int offset, int log2_base,
                                         int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  const auto* in = (const int32_t*)acc_in;
  auto* out = (int32_t*)acc_out;
  const auto* bt = (const int32_t*)bara_t;
  const auto* k = (const long long*)key;
  err = rounded ? launch<true>(in, out, bt, k, batch, start, chunk,
                               (uint32_t)offset, log2_base, (cudaStream_t)stream)
                : launch<false>(in, out, bt, k, batch, start, chunk,
                                (uint32_t)offset, log2_base,
                                (cudaStream_t)stream);
  return (int)err;
}
