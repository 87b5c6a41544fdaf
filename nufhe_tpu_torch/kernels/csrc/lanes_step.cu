// One CMUX step of the blind rotation in the lanes layout (K4), for Hopper,
// reading the TPU's int8 key operand in both engine modes, with the MAC on
// the int8 tensor cores.
//
//   acc_q' = acc_q + sum_g decomp_g((X^p - 1) * acc_q) (*) BK_row   mod 2^32
//
// Replaces the TPU kernel nufhe_tpu/ops/pallas/blind_rotate.py::
// make_external_step (whose body is ops/flat_engine.external_step; n
// launches of it are blind_rotate_pallas); the output equals
// ops/flat_engine.external_step bit for bit.
//
// Templated on the TLWE mask size + 1 (M), the gadget length (D) and the
// key form; the launcher instantiates (M, D) = (2, 2), (3, 2) and (2, 3)
// (ops/transform.KERNEL_SHAPES) and refuses any other.  G = M * D.
//
// Layout (the JAX package's lanes layout and key operand):
//   acc_q   (B, M*1024) int32, q-layout: coefficient i*32 + j at lane j*32 + i
//   p       (B,) int32 in [0, 2048)
//   key     one row (L=64, C = 64G, Q) int8, ops/transform.build_mac_rhs:
//           c = g*64 + i*32 + u (digit polynomial g, accumulator limb i,
//           lane u), q = s*32M + o*32 + k (group s, output polynomial o,
//           lane k), slot axis in bit-reversed order, negacyclic signs
//           built in; Q = 5*32M exact (groups B, A0..A3), 4*32M rounded
//           (A0..A3)
//   out     (B, M*1024) int32
//
// Three grids on the launcher's stream, one "launch" of K4:
//   1. forward (a block a sample, a warp a digit polynomial): the rotation,
//      the gadget digit and the exact forward Nussbaumer transform in the
//      warp's registers (rotate_common.cuh, as K3 does), split into int8
//      limbs a0, a1, to scratch limbs[t][b][c] (64G bytes a sample and
//      slot);
//   2. MAC (a block per slot t, looping over tiles of 64 samples): the
//      (Q x C) . (C x 64) int8 product by mma.sync m16n8k32 s8 x s8 -> s32.
//      The A operand is the key slot, transposed once a block into shared
//      memory ([q][c], its K = c contiguous; 4 rows x 16 columns a thread,
//      byte permutes, conflict-free stores); the B operand is the tile's
//      limbs as they lie ([sample][c], 64 samples = the mma's whole N).
//      Both read K in the same permuted order (logical k 4tig..+3 and
//      16+4tig..+3 are c = 8tig..+3 and 8tig+4..+7 of a 32-byte chunk), so
//      a thread's A and B fragments are one 8-byte shared load each, and the
//      row strides (C/4 + 8 words) keep those loads free of bank conflicts.
//      A warp owns 16 output positions (o, k) in every group and 32
//      samples, so it holds all the groups of its outputs and recombines
//      them in registers (exact: lo = A0 + A1<<8 + A2<<16 + A3<<24 and
//      hi = B; rounded: lo alone), writing the channels to scratch
//      chan[b][ch][o][t][k];
//   3. inverse (a block a sample, a warp a channel polynomial): the
//      unscaled inverse transform and the fold in registers, c = lo +
//      (hi >> 6) (or lo), added to the accumulator.  uint32 wraparound is
//      the lo channel's mod 2^32; the hi channel stays below G * 2^24 in
//      absolute value (blind_rotate_body.cuh) and is exact in int32.
//
// Tensor parallelism (the JAX package's axis_name / slot_axis_name branches,
// ops/flat_engine.py:215-306 and ops/rows_engine.py:869-954, which run in
// XLA there): the step splits around a collective (torch.distributed, in
// ops/lanes_step.py) between grid 2 and grid 3.  Grid 1 stays whole on every
// shard (each decomposes the whole, replicated accumulator).  Grid 2 takes
// shard s of a key row:
//   limbs: the row's C-slice of GL whole g-blocks, (64, 64GL, Q), from
//          g-block s*GL; it reads those bytes of each limbs row and writes
//          partial channels, which the collective sums (lo wraps mod 2^32);
//   slots: of S slot shards, the row's slots s*64/S .. + 64/S, (64/S, C, Q);
//          it writes the channels of those slots, chan[b][ch][o][64/S][k],
//          which the collective gathers shard-major.
// Grid 3 reads the channels as slot_chunks shard-major chunks
// [s][b][ch][o][64 / slot_chunks][k] (1 for an unsplit or limbs step: the
// layout above), which is what an all_gather of the shards leaves: so the
// slots collective moves (S-1)/S of the channels a rank and needs no
// permute, where an all_reduce of zero-filled full buffers would move twice
// that.  The split is a template argument of both grids (GL = G, G/2, G/4
// where they divide G; S and slot_chunks 1, 2, 4, 8) so that the unsplit
// step's indexing stays compile-time: with the slot count a run-time
// argument, the unsplit MAC grid ran 3% ('NTT') to 13% ('FFT') slower.
//
// Bound: the MAC is 64 * C * Q int8 multiply-adds a sample (5.24 M exact at
// (2, 2)), 1.72e11 operations at batch 2^14, 0.087 ms at the H100's dense
// int8 tensor rate; the bytes (accumulator in and out, one key row) take
// 0.082 ms.  This design writes the limbs (64C bytes a sample) and the
// channels (2 or 1 x 256M words a sample) to device memory and reads them
// back in the next grid: with the accumulator read twice and written once,
// 2.0 GB a launch at batch 2^14 and (2, 2) exact (1.5 GB rounded), 0.60 ms
// at 3.35 TB/s.  With the MAC on the tensor cores it is bound by those
// bytes, not by the multiply-adds.  Keeping the intermediates on chip
// (fusing the grids) is later work.

#include "rotate_common.cuh"

namespace {

constexpr int kTM = 64;             // samples a MAC tile

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// the MAC grid's shapes for GL g-blocks of the key
template <int M, int GL, bool kRounded>
struct Lanes {
  static constexpr int kC = GL * 64;                       // MAC inputs
  static constexpr int kGroups = kRounded ? 4 : 5;
  static constexpr int kQ = kGroups * M * kR;              // MAC outputs
  static constexpr int kNCh = kRounded ? 1 : 2;            // channels
  static constexpr int kCW = kC / 4;                       // words a c-row
  static constexpr int kStride = kCW + 8;                  // padded row
  static constexpr int kMacWarps = 4 * M;   // 2M position tiles x 2 halves
  static constexpr int kMacThreads = 32 * kMacWarps;
  static constexpr int kMacSmem = (kQ + kTM) * kStride * 4;
};

// Grid 1: rotation, digits, forward transform, int8 limbs.
template <int M, int D>
__global__ void __launch_bounds__(32 * M * D)
lanes_forward_kernel(const uint32_t* __restrict__ acc_q,
                     const int32_t* __restrict__ powers,
                     int8_t* __restrict__ limbs, int batch, uint32_t offset,
                     int log2_base) {
  constexpr int kG = M * D;
  constexpr int kC = kG * 64;
  __shared__ uint32_t acc_s[M * kN];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const uint32_t* src = acc_q + (size_t)b * M * kN;
  for (int e = tid; e < M * kN; e += 32 * kG) acc_s[e] = src[e];
  const int p = powers[b] & (2 * kN - 1);
  __syncthreads();

  int x[kL];
  forward_digits(acc_s + (g / D) * kN, p, 32 - (g % D + 1) * log2_base,
                 offset, (1 << log2_base) - 1, 1 << (log2_base - 1), lane, x);
  // MAC slot rev6(f) holds frequency f, as the key's slot axis does
#pragma unroll
  for (int f = 0; f < kL; ++f) {
    int8_t* dst = limbs + ((size_t)rev6c(f) * batch + b) * kC + g * 2 * kR;
    dst[lane] = (int8_t)limb0(x[f]);
    dst[kR + lane] = (int8_t)limb1(x[f]);
  }
}

// Grid 2: per slot, (Q x C) . (C x samples) int8 on the tensor cores, the
// groups recombined into the channels.  A block per slot of the key shard
// (kLs = 64 / kSlotShards slots from shard * kLs); C is the shard's GL
// g-blocks, from g-block shard * GL of each limbs row.
template <int M, int D, int GL, int kSlotShards, bool kRounded>
__global__ void __launch_bounds__(Lanes<M, GL, kRounded>::kMacThreads)
lanes_mac_kernel(const int8_t* __restrict__ limbs,
                 const int8_t* __restrict__ key, uint32_t* __restrict__ chan,
                 int batch, int shard) {
  using S = Lanes<M, GL, kRounded>;
  constexpr int kCF = M * D * 64;          // a limbs row: every g-block
  constexpr int kLs = kL / kSlotShards;    // slots of the key shard
  constexpr int kC = S::kC;
  constexpr int kQ = S::kQ;
  constexpr int kCW = S::kCW;
  constexpr int kStride = S::kStride;
  constexpr int kThreads = S::kMacThreads;
  constexpr int kGroups = S::kGroups;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* key_t = smem;                  // [q][kStride]: bytes c of row q
  uint32_t* lhs = smem + kQ * kStride;     // [sample][kStride]
  // both 0 in an unsplit step, at compile time
  const int c_first = GL == M * D ? 0 : shard * GL * 64;
  const int slot_first = kSlotShards == 1 ? 0 : shard * kLs;
  const int tl = blockIdx.y;               // slot of the key shard
  const int t = slot_first + tl;           // slot of the limbs
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // the key slot, transposed: a thread takes rows 4cq..4cq+3 and columns
  // 16qb..16qb+15 (4 loads of 16 bytes), 4 x 4 byte blocks transposed with
  // 8 byte permutes each; consecutive lanes take consecutive cq, so the 16
  // stores of a thread hit 32 banks across the warp
  const int8_t* key_slot = key + (size_t)tl * kC * kQ;
  for (int task = tid; task < kCW * (kQ / 16); task += kThreads) {
    const int cq = task % kCW;
    const int qb = task / kCW;
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint4*>(key_slot + (size_t)(4 * cq + i) * kQ
                                             + 16 * qb);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t r0 = word_of(r[0], w), r1 = word_of(r[1], w);
      const uint32_t r2 = word_of(r[2], w), r3 = word_of(r[3], w);
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      uint32_t* dst = key_t + (16 * qb + 4 * w) * kStride + cq;
      dst[0] = __byte_perm(t0, t2, 0x5410);
      dst[kStride] = __byte_perm(t0, t2, 0x7632);
      dst[2 * kStride] = __byte_perm(t1, t3, 0x5410);
      dst[3 * kStride] = __byte_perm(t1, t3, 0x7632);
    }
  }

  // warp roles: 16 output positions pt*16.. of every group, 32 samples
  const int pt = warp % (2 * M);
  const int nh = warp / (2 * M);
  const int n_tiles = (batch + kTM - 1) / kTM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * kTM;
    __syncthreads();   // the key is written; the last tile's lhs is read
    for (int e = tid; e < kTM * (kCW / 4); e += kThreads) {
      const int m = e / (kCW / 4);
      const int c4 = e % (kCW / 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < batch)
        v = *reinterpret_cast<const uint4*>(
            limbs + ((size_t)t * batch + m0 + m) * kCF + c_first + 16 * c4);
      *reinterpret_cast<uint4*>(lhs + m * kStride + 4 * c4) = v;
    }
    __syncthreads();

    int d[kGroups][4][4];
#pragma unroll
    for (int s = 0; s < kGroups; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[s][nt][e] = 0;
#pragma unroll 2
    for (int kc = 0; kc < kC / 32; ++kc) {
      uint2 bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt] = *reinterpret_cast<const uint2*>(
            lhs + (nh * 32 + nt * 8 + gid) * kStride + kc * 8 + 2 * tig);
#pragma unroll
      for (int s = 0; s < kGroups; ++s) {
        const int q = s * M * kR + pt * 16 + gid;
        const uint2 alo = *reinterpret_cast<const uint2*>(
            key_t + q * kStride + kc * 8 + 2 * tig);
        const uint2 ahi = *reinterpret_cast<const uint2*>(
            key_t + (q + 8) * kStride + kc * 8 + 2 * tig);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(d[s][nt], alo.x, ahi.x, alo.y, ahi.y, bf[nt].x, bf[nt].y);
      }
    }

    // recombine the groups of output (o, k) for sample m
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + nh * 32 + nt * 8 + 2 * tig + (e & 1);
        if (m >= batch) continue;
        const int pos = pt * 16 + gid + (e >= 2 ? 8 : 0);
        const int o = pos >> 5;
        const int k = pos & 31;
        const int a = kRounded ? 0 : 1;
        const uint32_t lo = (uint32_t)d[a][nt][e] +
                            ((uint32_t)d[a + 1][nt][e] << 8) +
                            ((uint32_t)d[a + 2][nt][e] << 16) +
                            ((uint32_t)d[a + 3][nt][e] << 24);
        uint32_t* dst = chan + (size_t)m * S::kNCh * M * kLs * kR +
                        ((size_t)o * kLs + tl) * kR + k;
        dst[0] = lo;
        if (!kRounded) dst[M * kLs * kR] = (uint32_t)d[0][nt][e];
      }
  }
}

// Grid 3: inverse transform of the channels, fold, normalise, accumulate.
// The channels lie as kChunks shard-major chunks of kL / kChunks slots.
template <int M, bool kExact, int kChunks>
__global__ void __launch_bounds__(32 * M * (kExact ? 2 : 1))
lanes_inverse_kernel(const uint32_t* __restrict__ acc_in,
                     uint32_t* __restrict__ acc_out,
                     const uint32_t* __restrict__ chan, int batch) {
  constexpr int kNCh = kExact ? 2 : 1;
  constexpr int kLs = kL / kChunks;
  __shared__ uint32_t hi_s[kExact ? M * kN : 1];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;          // ch * M + o
  const int o = warp % M;
  const bool hi_warp = warp >= M;
  uint32_t x[kL];
#pragma unroll
  for (int r = 0; r < kL; ++r)
    x[r] = chan[(((size_t)(r / kLs) * batch + b) * kNCh * M + warp) * kLs * kR
                + (r % kLs) * kR + lane];
  inverse_fold(x, lane);   // bit-reversed slots in; x[j] at q-layout j*32+i
  if (kExact) {
    if (hi_warp) {
#pragma unroll
      for (int j = 0; j < kL / 2; ++j)
        hi_s[o * kN + j * 32 + lane] = (uint32_t)((int32_t)x[j] >> 6);
    }
    __syncthreads();
  }
  if (!hi_warp) {
    const size_t row = (size_t)b * M * kN + o * kN;
#pragma unroll
    for (int j = 0; j < kL / 2; ++j) {
      uint32_t delta = x[j];
      if (kExact) delta += hi_s[o * kN + j * 32 + lane];
      acc_out[row + j * 32 + lane] = acc_in[row + j * 32 + lane] + delta;
    }
  }
}

template <int M, int D, int GL, int kSlotShards, bool kRounded>
cudaError_t launch_mac(const int8_t* limbs, const int8_t* key, uint32_t* chan,
                       int batch, int shard, cudaStream_t stream) {
  using S = Lanes<M, GL, kRounded>;
  constexpr int kLs = kL / kSlotShards;
  auto kernel = lanes_mac_kernel<M, D, GL, kSlotShards, kRounded>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kMacSmem);
  if (err != cudaSuccess) return err;
  // as many sample-tile columns a slot as fill the card in one wave: each
  // block transposes its key slot once and walks tiles with that stride
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, S::kMacThreads, S::kMacSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (batch + kTM - 1) / kTM;
  int cols = sms * (per_sm > 0 ? per_sm : 1) / kLs;
  cols = cols < 1 ? 1 : (cols < n_tiles ? cols : n_tiles);
  kernel<<<dim3(cols, kLs), S::kMacThreads, S::kMacSmem, stream>>>(
      limbs, key, chan, batch, shard);
  return cudaGetLastError();
}

// the MAC grid on shard `shard` of a split in GL = g_local of the G g-blocks
// (G, G/2, G/4 where they divide G) or in slot_shards slot ranges (1, 2, 4,
// 8); not both
template <int M, int D, bool kRounded>
cudaError_t mac_shard(const int8_t* limbs, const int8_t* key, uint32_t* chan,
                      int batch, int g_local, int slot_shards, int shard,
                      cudaStream_t stream) {
  constexpr int kG = M * D;
  if (slot_shards == 1) {
    switch (g_local) {
      case kG:
        return launch_mac<M, D, kG, 1, kRounded>(limbs, key, chan, batch,
                                                 shard, stream);
      case kG / 2:
        if constexpr (kG % 2 == 0)
          return launch_mac<M, D, kG / 2, 1, kRounded>(limbs, key, chan,
                                                       batch, shard, stream);
        break;
      case kG / 4:
        if constexpr (kG % 4 == 0)
          return launch_mac<M, D, kG / 4, 1, kRounded>(limbs, key, chan,
                                                       batch, shard, stream);
        break;
    }
  } else if (g_local == kG) {
    switch (slot_shards) {
      case 2:
        return launch_mac<M, D, kG, 2, kRounded>(limbs, key, chan, batch,
                                                 shard, stream);
      case 4:
        return launch_mac<M, D, kG, 4, kRounded>(limbs, key, chan, batch,
                                                 shard, stream);
      case 8:
        return launch_mac<M, D, kG, 8, kRounded>(limbs, key, chan, batch,
                                                 shard, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <int M, bool kExact>
cudaError_t inverse_chunks(const uint32_t* acc_in, uint32_t* acc_out,
                           const uint32_t* chan, int batch, int slot_chunks,
                           cudaStream_t stream) {
  constexpr int kThreads = 32 * M * (kExact ? 2 : 1);
  switch (slot_chunks) {
    case 1:
      lanes_inverse_kernel<M, kExact, 1><<<batch, kThreads, 0, stream>>>(
          acc_in, acc_out, chan, batch);
      break;
    case 2:
      lanes_inverse_kernel<M, kExact, 2><<<batch, kThreads, 0, stream>>>(
          acc_in, acc_out, chan, batch);
      break;
    case 4:
      lanes_inverse_kernel<M, kExact, 4><<<batch, kThreads, 0, stream>>>(
          acc_in, acc_out, chan, batch);
      break;
    case 8:
      lanes_inverse_kernel<M, kExact, 8><<<batch, kThreads, 0, stream>>>(
          acc_in, acc_out, chan, batch);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int M, int D>
cudaError_t launch(const uint32_t* acc_in, uint32_t* acc_out,
                   const int32_t* powers, const int8_t* key, int8_t* limbs,
                   uint32_t* chan, int batch, uint32_t offset, int log2_base,
                   int rounded, int grids, int g_local, int slot_shards,
                   int shard, cudaStream_t stream) {
  cudaError_t err;
  if (grids & 1) {
    lanes_forward_kernel<M, D><<<batch, 32 * M * D, 0, stream>>>(
        acc_in, powers, limbs, batch, offset, log2_base);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (grids & 2) {
    err = rounded ? mac_shard<M, D, true>(limbs, key, chan, batch, g_local,
                                          slot_shards, shard, stream)
                  : mac_shard<M, D, false>(limbs, key, chan, batch, g_local,
                                           slot_shards, shard, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// limbs: 64 * batch * 64G int8 of scratch; chan: batch * (2 or 1) * M *
// (64 / slot_shards) * 32 int32 of scratch, or (grid 3 alone) slot_chunks
// such chunks of 64 / slot_chunks slots.  grids: a bit mask of the grids to
// run (1 forward, 2 MAC, 4 inverse; 7 is the step), so that they can be
// timed apart and a tensor-parallel step can run a collective between grid 2
// and grid 3.  The MAC grid runs shard `shard` of a split of the key row in
// g_local g-blocks (the key is (64, 64 g_local, Q)) or in slot_shards slot
// ranges (the key is (64 / slot_shards, 64G, Q)); an unsplit step is
// g_local = G, slot_shards = 1, shard = 0, slot_chunks = 1.  Grid 3 alone
// needs only mask1 and rounded (decomp may be 0).
extern "C" int lanes_step_launch(const void* acc_in, void* acc_out,
                                 const void* powers, const void* key,
                                 void* limbs, void* chan, int batch,
                                 int mask1, int decomp, unsigned int offset,
                                 int log2_base, int rounded, int grids,
                                 int g_local, int slot_shards, int shard,
                                 int slot_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if ((grids & 2) && (shard < 0 || g_local <= 0 || slot_shards <= 0 ||
                      (mask1 * decomp) % g_local ||
                      shard >= mask1 * decomp / g_local * slot_shards))
    return (int)cudaErrorInvalidValue;
  const auto* in = (const uint32_t*)acc_in;
  auto* out = (uint32_t*)acc_out;
  const auto* pw = (const int32_t*)powers;
  const auto* k = (const int8_t*)key;
  auto* lb = (int8_t*)limbs;
  auto* ch = (uint32_t*)chan;
  const auto s = (cudaStream_t)stream;
  if (grids & 3) {
    if (mask1 == 2 && decomp == 2)
      err = launch<2, 2>(in, out, pw, k, lb, ch, batch, offset, log2_base,
                         rounded, grids, g_local, slot_shards, shard,
                         s);
    else if (mask1 == 3 && decomp == 2)
      err = launch<3, 2>(in, out, pw, k, lb, ch, batch, offset, log2_base,
                         rounded, grids, g_local, slot_shards, shard,
                         s);
    else if (mask1 == 2 && decomp == 3)
      err = launch<2, 3>(in, out, pw, k, lb, ch, batch, offset, log2_base,
                         rounded, grids, g_local, slot_shards, shard,
                         s);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  if (grids & 4) {
    if (mask1 == 2)
      err = rounded ? inverse_chunks<2, false>(in, out, ch, batch, slot_chunks, s)
                    : inverse_chunks<2, true>(in, out, ch, batch, slot_chunks, s);
    else if (mask1 == 3)
      err = rounded ? inverse_chunks<3, false>(in, out, ch, batch, slot_chunks, s)
                    : inverse_chunks<3, true>(in, out, ch, batch, slot_chunks, s);
    else
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
