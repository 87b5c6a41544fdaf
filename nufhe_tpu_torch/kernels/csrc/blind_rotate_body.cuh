// The rows-layout blind rotation for Hopper, with the MAC on the int8
// tensor cores: `chunk` consecutive CMUX steps, from step `start`, in one
// launch, in both engine modes.  The chunked rotation (K3,
// blind_rotate_chunk.cu) and the per-step kernel (K1, cmux_step.cu: a chunk
// of 1 on one key row) are both this template, so the two cannot drift
// apart; so are the stage parts (K5, step_parts.cu, and the rotation-family
// profile K9, step_profile.cu: K1 cut after a stage, the Part argument),
// the in-loop stage stand-ins (K6, step_context.cu: K3 with one stage
// swapped, the Variant argument) and the split-halves step (K8,
// step_overlap.cu: K1 in another schedule, also the Variant argument); so
// are the step schedules (K10, step_schedules.cu: K1 in seven schedules),
// the step tricks (K11, step_tricks.cu) and the rotation forms (K12,
// rotate_forms.cu: K3 with another form of a stage) and the inverse
// probes (K13, inverse_probe.cu: the kInvProbe part).  Both arguments'
// defaults are K1 and K3.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// negacyclic in Z[X]/(X^1024 + 1), mod 2^32.  K3 replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk, K1
// ::make_external_step_rows (both over ops/rows_engine.py, with the MAC as
// int8 products on the MXU: transformed_mac -> _mac_dot_raw).  The output
// equals `chunk` plain steps (ops/cmux.cmux_step_plain) and `chunk` launches
// of K4 (lanes_step.cu) bit for bit.
//
// Templated on the TLWE mask size + 1 (Mask1), the gadget length (Decomp)
// and the key form; the launcher instantiates (Mask1, Decomp) = (2, 2),
// (3, 2) and (2, 3) (ops/transform.KERNEL_SHAPES) and refuses any other.
// G = Mask1 * Decomp digit polynomials.
//
// Layout (the port's own):
//   acc     (B, Mask1, 1024) int32, batch-major, contiguous
//   bara_t  (n, B) int32 in [0, 2048): the rotation amounts, one row a step
//           (K1: the (B,) powers, as one row)
//   rows    the key's int8 limb rows of steps [start, start + chunk)
//           (ops/key_rows.py): (chunk, 64, G, Mask1, 6, 64) exact, (chunk,
//           64, G, Mask1, 4, 64) rounded (K1: one step's)
//   out     (B, Mask1, 1024) int32 (a separate buffer; the wrapper allocates
//           it)
//   start   first step; the wrapper checks 0 <= start, start + chunk <= n
//
// Design: a block holds kS samples, their accumulators in shared memory
// (q-layout) for the whole chunk.  A step:
//   1-3. a warp a (sample, digit polynomial g = o*Decomp + d): the rotation
//      (X^p - 1) * acc and the gadget digit straight into registers, the
//      exact forward Nussbaumer DIT there (rotate_common.cuh), and the split
//      into int8 limbs a0, a1, stored by MAC slot p (frequency rev6(p)):
//      per slot, [g][limb][sample][32] (the pair: pair_limb_word);
//   4. the MAC: per slot, the (Q x 64G) . (64G x kS) product, Q = 5*32*Mask1
//      exact (groups B, A0..A3) or 4*32*Mask1 rounded (A0..A3), by mma.sync
//      m16n8k32 s8 x s8 -> s32 with both int8 limbs of the kS samples'
//      digits on the mma's N (2kS of its 8 columns: all of them at (2, 2);
//      at kS = 2 the pair's 4 samples, below); a warp owns a slot.  The A
//      operand is the key: per (g, o, limb) one 64-byte row of the
//      two-sided int8 limbs of
//      ops/transform.key_limbs_host, side 0 then side 1, reversed: the
//      Toeplitz operand's entry (k, u) is byte 31 - k + u of it, so a
//      fragment's 4 consecutive K bytes are one unaligned word of the row.
//      The rows are prepared once with the key (key_rows.cu) and stored
//      slot-major, so the warp copies its slot's G*Mask1*6 rows (4 rounded)
//      from device memory into shared memory, 16 bytes a lane a cp.async;
//      the copy of its first slot is issued before phases 1-3 and lands
//      while they run.  The two 16-row M tiles of
//      an output polynomial take the odd and the even outputs k, so the 8
//      fragment registers a thread needs from a row all come from the same 4
//      words (4 shared loads, 6 funnel shifts).  A limb row meets the
//      digits' limb 0 in its own group and limb 1 in the next (the table of
//      ops/transform._mac_limb_table, mac_group), so with both digit limbs
//      on N each of the 6 row fragments (4 rounded) feeds one mma a tile
//      into an accumulator of its own: 6 mma a (g, o, tile), 9 of whose 12
//      (row, limb) column halves carry work (4 and 7 of 8 rounded; with
//      one digit limb on N it took 9 and 7).  Both limbs of a
//      sample lie in one thread (column 2n + i is limb i of sample n), so
//      the rows are recombined in registers, each (row, limb) shifted by
//      its group (lo = A0 + A1<<8 + A2<<16 + A3<<24 in uint32, hi = B =
//      row 0 x limb 0 alone); lo goes to the lo channel, hi over the slot's
//      consumed limbs;
//   5-6. a warp a channel polynomial: the unscaled inverse DIT in uint32
//      registers, the fold, and c = lo + (hi >> 6) (or lo) added to the
//      accumulator.  Wraparound is the lo channel's mod 2^32.  The hi
//      channel is exact: before the inverse |hi| <= 32G * 128 * 32 = G*2^17
//      (limb a0 times vlo over the slot's 32G digit coefficients), the
//      inverse and the fold multiply by at most 128, so |hi| <= G * 2^24
//      (2^26.6 at G = 6), inside int32, and the arithmetic >> 6 is exact.
// Three block barriers a step.  The warp roles of phases 1-3 (kS * G) and
// 5-6 (2 * kS * Mask1 exact, half of it rounded) are at most the block's
// warps; a warp without a role waits at the barriers.
//
// The pair (Shape::kPair = 2: the kS = 2 shapes, (3, 2) and (2, 3), K1 and
// K3 alone): the launch runs clusters of two blocks on neighbouring SMs
// (cudaLaunchKernelEx, the grid rounded up to an even count; a block past
// the batch holds zeros and joins every barrier), and the two share the MAC
// over distributed shared memory.  Block rank r runs the MAC of slots
// [32r, 32r + 32) (12 warps: 3 slots for 8 of them, 2 for the rest, where
// unpaired each ran 5 or 6 of 64) and copies only those slots' key rows.
// Its warp builds a key row's A fragments as above (4 loads, 6 shifts, 2
// mma) and feeds them to both blocks' samples: mma column 2n + i is limb i
// of pair sample n, sample n % 2 of block n / 2, whose B fragments come from
// that block's limbs of the slot (mapa, ld.shared::cluster), so N is full.
// The limbs lie in the pair's own order in a slot's region
// (pair_limb_word: a thread's 2G B-fragment words together, three 16-byte
// loads at G = 6, where the [g][limb][sample][32] order took 2G 4-byte
// loads), and the thread of pair sample n stores its 4 lo and 4 hi channel
// words (k = 4gid..4gid+3) as one 16-byte store each into that block's
// shared memory (st.shared::cluster), hi still over the slot's consumed
// limbs, which only the slot's owner warp, in either block, reads.
// The barriers after phases 1-3 and after the MAC are cluster barriers
// (barrier.cluster arrive.release / wait.acquire: the peer's limbs are
// written before the MAC reads them, and every channel word, local or
// remote, before the inverse reads it); the one inside the inverse and the
// one that ends the step stay block barriers, and a last cluster barrier
// keeps each block's shared memory until its peer is done.
//
// Shared memory a sample: the accumulator (4 KB a polynomial: 4*Mask1 KB),
// the lo channel (8*Mask1 KB) and the limbs / hi channel (64 slots x
// max(64G, 128*Mask1) bytes); a warp's key rows take G*Mask1*6*64 bytes
// (4 limb rows rounded).  kS and the block's warps per shape:
//   (2, 2): 40 KB a sample, kS = 4, 16 warps x 3 KB of key rows: 208 KB
//           exact, 192 KB rounded (as before the shapes were templated);
//   (3, 2): 60 KB a sample, kS = 2, 12 warps x 6.75 KB: 201 KB exact (kS = 3
//           would need 180 KB + 18 warps x 6.75 KB);
//   (2, 3): 48 KB a sample, kS = 2, 12 warps x 4.5 KB: 150 KB exact (kS = 3
//           would fit in 225 KB, but with 18 warps and at most 112 registers
//           a thread, below the 128 the (2, 2) kernel takes).
// One block an SM.  Registers (ptxas, sm_90a): 128 a thread at (2, 2), the
// ceiling of a 512-thread block, and 168 at the other shapes, none spilled
// in either form; the MAC holds 8 accumulators a key limb row (48 exact,
// 32 rounded) and 2G B-fragment registers.
//
// Bound: the MAC is 64 * 64G * Q int8 multiply-adds a sample and step
// (5.24 M exact at (2, 2), 4.19 M rounded); at batch 2^14 and chunk 50,
// 8.6e12 operations exact, 4.34 ms at the H100's dense int8 rate of
// 1979e12/s (3.47 ms rounded).  Bytes: the accumulator in and out, the
// rotation amounts and the chunk's key rows (196,608 B a step exact at (2,
// 2), 131,072 rounded, 294,912 at (2, 3) exact; 1.5x, 0.5x and 1.5x the
// int64 key they are prepared from).  L2 traffic: one step's key rows a
// block and step, 2^14 / 4 x 196,608 B = 0.81 GB a step exact at (2, 2)
// (0.54 GB rounded); at (2, 3) half a step's rows a block, 2^14 / 2 x
// 147,456 B = 1.2 GB (2.4 GB unpaired).  Issued: 2 * Mask1 * G * 6
// mma.sync a slot (4 rows rounded), 96 exact and 64 rounded at (2, 2),
// 6144 and 4096 a block and step, 1536 and 1024 a sample (one digit limb
// on N: 144 and 112 a slot); at (2, 3) 144 exact a slot, 4608 a block and
// step and 2304 a sample in the pair (1.5x (2, 2)'s: G = 6), where
// unpaired a block of 2 issued 9216, 4608 a sample.  An mma takes its time
// whatever share of its columns carries work (chip_smoke.py's mac_issue
// counts both).  Every instantiation runs this one MAC form, the split
// halves (K8) and the sample pipelines (K10) included.

#pragma once

#include <type_traits>
#include <utility>

#include "rotate_common.cuh"

namespace {

constexpr int kRowWords = 16;                   // one 64-byte key limb row

template <int M, int D>
struct Shape {
  static constexpr int kG = M * D;
  static constexpr int kS = (M == 2 && D == 2) ? 4 : 2;    // samples a block
  static constexpr int kDigitRoles = kS * kG;
  static constexpr int kWarps =
      kDigitRoles > 2 * kS * M ? kDigitRoles : 2 * kS * M;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kAccWords = M * kN;        // a sample's accumulator
  static constexpr int kWorkWords = M * kL * kR;  // a sample's lo channel
  // a slot's limbs ([g][limb][sample][32 bytes]), or its hi channel
  static constexpr int kRegionWords =
      kS * (16 * kG > 32 * M ? 16 * kG : 32 * M);
  // blocks a cluster: two where a block holds two samples, so that the
  // pair's MAC puts 2kS = 4 samples on the mma's N (the head of this file)
  static constexpr int kPair = kS == 2 ? 2 : 1;
};

// The key rows of one step (ops/key_rows.py, key_rows.cu): slot-major, MAC
// slot p (frequency rev6(p)) at p * kSlotBytes, its row (g, o, L) at ((g *
// M + o) * kRows + L) * 64; byte 31 - r is limb L of side 0 at rotation r,
// byte 63 - r that of side 1.
template <int M, int D, bool kRounded>
struct KeyRows {
  static constexpr int kRows = kRounded ? 4 : 6;   // limb rows a (g, o)
  static constexpr int kSlotBytes = M * D * M * kRows * 64;
  static constexpr int kStepBytes = kL * kSlotBytes;
};

// One 16-byte cp.async of a lane, kOff bytes past its addresses (an
// immediate of the instruction, so that a copy takes no registers of its
// own)
template <int kOff>
__device__ __forceinline__ void copy16(uint32_t dst, const int8_t* src) {
  asm volatile("cp.async.cg.shared.global [%0+%2], [%1+%2], 16;\n" ::"r"(
                   dst),
               "l"(src), "n"(kOff)
               : "memory");
}

template <int... kI>
__device__ __forceinline__ void copy16s(uint32_t dst, const int8_t* src,
                                        std::integer_sequence<int, kI...>) {
  (copy16<kI * 512>(dst, src), ...);
}

// The calling warp starts the copy of slot p's key rows of digit
// polynomials [kG0, kG0 + kGn) (all of them but in K8's halves) from the
// step's rows into arow, 16 bytes a lane a cp.async, lane i the pieces i,
// i + 32, ..., as one commit group; wait_rows ends it.
template <int M, int D, bool kRounded, int kG0 = 0, int kGn = M * D>
__device__ __forceinline__ void fetch_rows(int p,
                                           const int8_t* __restrict__ rows,
                                           uint32_t* arow) {
  using K = KeyRows<M, D, kRounded>;
  constexpr int kPieces = kGn * M * K::kRows * 4;   // 16 bytes each
  const int lane = threadIdx.x & 31;
  const int8_t* src = rows + (size_t)p * K::kSlotBytes +
                      kG0 * M * K::kRows * 64 + 16 * lane;
  const uint32_t dst =
      (uint32_t)__cvta_generic_to_shared(arow) + 16 * lane;
  copy16s(dst, src, std::make_integer_sequence<int, kPieces / 32>());
  if (kPieces % 32 && lane < kPieces % 32)
    copy16<kPieces / 32 * 512>(dst, src);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The warp's copies have landed in shared memory, for every lane
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// The pair of a cluster: this block's rank in it, the address of a word of
// this block's shared memory in the shared memory of block `rank`
// (shared::cluster, a 32-bit address), a 16-byte load and store there
// (16-byte aligned), and the
// barrier of both blocks' threads (release, then acquire, so that every
// access before it, local or remote, is seen after it)
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ uint32_t cluster_addr(const uint32_t* p,
                                                 int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return d;
}

__device__ __forceinline__ void ld_cluster4(uint32_t a, uint32_t& v0,
                                            uint32_t& v1, uint32_t& v2,
                                            uint32_t& v3) {
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t a,
                                            const uint32_t (&v)[4]) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// The pair's layout of a slot's digit limbs: word (tig, half) of the row
// of digit polynomial g, limb i, sample s (its K bytes 4tig..4tig+3, 16
// more for half 1) at this word of the slot's region, so that the 2G words
// a thread of the MAC reads as its B fragments (limb i of sample s at its
// tig, every g) lie together: 2G/4 16-byte loads
template <int kG, int kS>
__host__ __device__ constexpr int pair_limb_word(int i, int s, int tig, int g,
                                                 int half) {
  return ((i * kS + s) * 4 + tig) * 2 * kG + 2 * g + half;
}

// The barrier of the step's phases: the block's, or the pair's
template <int kPair>
__device__ __forceinline__ void pair_sync() {
  if constexpr (kPair == 1)
    __syncthreads();
  else
    cluster_sync();
}

// The output group in which key limb row L meets digit limb i (the table
// of ops/transform._mac_limb_table: exact, B then A0..A3, row 5 = 4*vlo;
// rounded, A0..A3), -1 where the pair is not used
__host__ __device__ constexpr int mac_group(bool rounded, int L, int i) {
  return rounded ? (i == 0 ? L : (L + 1 < 4 ? L + 1 : -1))
                 : i == 0 ? (L < 5 ? L : -1)
                 : L == 5 ? 1 : (L >= 1 && L <= 3 ? L + 1 : -1);
}

// The MAC of one slot p (frequency rev6(p)) for the block's samples; the
// calling warp owns the slot.  The mma's N holds both digit limbs of the
// block's samples (column n is limb n & 1 of sample n >> 1, zero past
// 2kS), one accumulator a key limb row, so each row fragment feeds one mma;
// the thread of sample tig adds its own (row, limb) columns, each shifted
// by its group (mac_group).  kHalf < 0: over every digit
// polynomial (K1, K3), the channels written.  K8's split schedule (exact
// form) runs it twice, over the digit polynomials g of half kHalf = 0 then
// 1 (kHalf * G/2 <= g < (kHalf + 1) * G/2): half 0 writes the lo channel
// and the hi channel of (sample, o) pairs s*M + o < kS*M/2 over its
// consumed limbs, the other pairs to hi_x (the second half of the slot's
// limbs is still being written); half 1 adds into both and leaves the hi
// channel where K1 leaves it.  fetch false: the copy of the slot's key
// rows into arow is already issued (fetch_rows), or the rows are there
// (K6's "no key split").  kQ > 1 (K10's pipelines): the
// limbs lie sample-major ([sample][g][limb][32 bytes], so that a sample's
// hi channel lies over its own limbs) and the MAC is that of sub-batch q,
// the samples [q*kS/kQ, (q+1)*kS/kQ), the other columns zero and not
// stored.  kPartial (K10's v2): the groups are left partly combined, A0 +
// A1<<8 + A2<<16 in the lo channel and A3<<24 + B (exact; A3 rounded) in
// the hi channel's place, for combine_pass.  kPair = 2 (K1 and K3 at kS =
// 2): the MAC of both blocks of the cluster, the calling warp (of either)
// owning the slot for both: the mma's N holds the pair's 2kS samples
// (sample n is sample n % kS of block n / kS, read from that block's limbs
// of the slot and stored into its channels, local or remote).
template <int M, int D, bool kRounded, int kHalf = -1, int kQ = 1,
          bool kPartial = false, int kPair = 1>
__device__ __forceinline__ void mac_slot(
    int p, const int8_t* __restrict__ rows, uint32_t* arow, uint32_t* work,
    uint32_t* limbs, bool fetch = true, uint32_t* hi_x = nullptr, int q = 0) {
  using S = Shape<M, D>;
  constexpr int kGn = kHalf < 0 ? S::kG : S::kG / 2;
  constexpr int kG0 = kHalf < 0 ? 0 : kHalf * kGn;
  constexpr int kS = S::kS;
  constexpr int kRows = kRounded ? 4 : 6;    // limb rows a (g, o)
  constexpr int kHalfPairs = kS * M / 2;
  constexpr int kSub = kS / kQ;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = q * kSub;

  if (fetch) fetch_rows<M, D, kRounded, kG0, kGn>(p, rows, arow);

  // B fragments: column gid, limb gid & 1 of sample gid >> 1 of digit
  // polynomial kG0 + g, bytes 4tig..4tig+3 and 16+4tig..+3
  const uint32_t* reg = limbs + p * S::kRegionWords;
  const int bn = gid >> 1, bi = gid & 1;
  const bool mine = bn >= n0 && bn < n0 + kSub;    // kQ = 1: bn < kS
  uint32_t bf[kGn][2];
  if constexpr (kPair > 1) {
    static_assert(kHalf < 0 && kQ == 1 && !kPartial && 2 * kS * kPair == 8 &&
                      kGn % 2 == 0,
                  "the pair runs K1's and K3's MAC with N full");
    // from sample bn's block, in the pair's layout (pair_limb_word)
    const uint32_t b0 = cluster_addr(
        reg + pair_limb_word<S::kG, kS>(bi, bn % kS, tig, 0, 0), bn / kS);
#pragma unroll
    for (int g = 0; g < kGn; g += 2)
      ld_cluster4(b0 + 8 * g, bf[g][0], bf[g][1], bf[g + 1][0],
                  bf[g + 1][1]);
  } else {
#pragma unroll
    for (int g = 0; g < kGn; ++g) {
      const uint32_t* wb =
          kQ == 1 ? reg + (((kG0 + g) * 2 + bi) * kS + bn) * 8
                  : reg + ((bn * S::kG + kG0 + g) * 2 + bi) * 8;
      bf[g][0] = mine ? wb[tig] : 0u;
      bf[g][1] = mine ? wb[tig + 4] : 0u;
    }
  }
  wait_rows();    // the rows are in arow; the limbs are read (hi goes there)

  // M tiles: the odd outputs k (tile 0: row gid is k = 4gid + 3, row
  // gid + 8 is k = 4gid + 1) and the even ones (tile 1: 4gid + 2, 4gid).
  // With that order every fragment of a row comes from the same 4 words
  // w, w+1, w+4, w+5 (w = 7 - gid + tig), at byte shifts 0/2 (tile 0) and
  // 1/3 (tile 1): entry (k, u) is byte 31 - k + u, and u = 4tig (+16).
  const int w = 7 - gid + tig;
  const int n = tig;                              // this thread's sample
  const bool store = kPair > 1 || (n < kS && n >= n0 && n < n0 + kSub);
#pragma unroll 1
  for (int o = 0; o < M; ++o) {
    int d[2][kRows][4];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int L = 0; L < kRows; ++L)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[tile][L][e] = 0;
#pragma unroll
    for (int g = 0; g < kGn; ++g) {
#pragma unroll
      for (int L = 0; L < kRows; ++L) {
        const uint32_t* row =
            arow + ((g * M + o) * kRows + L) * kRowWords + w;
        const uint32_t w0 = row[0], w1 = row[1], w4 = row[4], w5 = row[5];
        mma_s8(d[0][L], w0, __funnelshift_r(w0, w1, 16), w4,
               __funnelshift_r(w4, w5, 16), bf[g][0], bf[g][1]);
        mma_s8(d[1][L], __funnelshift_r(w0, w1, 8),
               __funnelshift_r(w0, w1, 24), __funnelshift_r(w4, w5, 8),
               __funnelshift_r(w4, w5, 24), bf[g][0], bf[g][1]);
      }
    }
    if (!store) continue;
    // sample n's columns: limb i of row gid in d[.][.][i], of row gid + 8
    // in d[.][.][2 + i], each (row, limb) shifted by its group (mac_group):
    // lo = A0 + A1<<8 + A2<<16 + A3<<24 in uint32 to the lo channel, hi =
    // B (row 0 x limb 0) over the slot's consumed limbs (the pair: the 4
    // words k = 4gid + j of each, stored as one 16-byte vector)
    uint32_t lo4[4], hi4[4];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 4 * gid + (r == 0 ? 3 : 1) - tile;
        constexpr int a = kRounded ? 0 : 1;
        uint32_t lo = 0, a3 = 0;          // a3: group A3 apart (kPartial)
#pragma unroll
        for (int L = 0; L < kRows; ++L)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = mac_group(kRounded, L, i);
            const uint32_t v = (uint32_t)d[tile][L][2 * r + i];
            if (kPartial && s == a + 3) a3 += v;
            else if (s >= a) lo += v << (8 * (s - a));
          }
        const uint32_t hi = (uint32_t)d[tile][0][2 * r];
        uint32_t* wl = work + n * S::kWorkWords + (o * kL + p) * kR + k;
        uint32_t* hl = limbs + p * S::kRegionWords + (n * M + o) * kR + k;
        if constexpr (kPair > 1) {
          lo4[(r == 0 ? 3 : 1) - tile] = lo;     // k - 4gid
          hi4[(r == 0 ? 3 : 1) - tile] = hi;
        } else if constexpr (kHalf < 0 && kPartial) {
          *wl = lo;
          *hl = kRounded ? a3 : (a3 << 24) + hi;
        } else if constexpr (kHalf < 0) {
          *wl = lo;
          if (!kRounded) *hl = hi;
        } else {
          const int pair = n * M + o;
          uint32_t* hx = hi_x + (p * kHalfPairs + pair - kHalfPairs) * kR + k;
          if constexpr (kHalf == 0) {
            *wl = lo;
            if (pair < kHalfPairs) *hl = hi;
            else *hx = hi;
          } else {
            *wl += lo;
            *hl = (pair < kHalfPairs ? *hl : *hx) + hi;
          }
        }
      }
    if constexpr (kPair > 1) {
      // into sample n's block: sample n % kS there
      st_cluster4(cluster_addr(work + (n % kS) * S::kWorkWords +
                                   (o * kL + p) * kR + 4 * gid,
                               n / kS),
                  lo4);
      if (!kRounded)
        st_cluster4(cluster_addr(limbs + p * S::kRegionWords +
                                     ((n % kS) * M + o) * kR + 4 * gid,
                                 n / kS),
                    hi4);
    }
  }
  __syncwarp();   // the next slot rewrites the key rows
}

// Where a launch stops the step.  K1 and K3 run it whole (kFull, the
// default); K5 (step_parts.cu, exact) and K9 (step_profile.cu, both forms)
// cut it after a stage, at (2, 2), to time the stages apart, so each part
// is a prefix of this kernel's own code.  A part writes an output that
// depends on all the work it does (step_parts.cu and step_profile.cu list
// them):
enum Part : int {
  kRotate = 0,         // (X^p - 1) * acc                        (B, M, N)
  kRotDecomp = 1,      // its signed gadget digits, g = o*D + d   (B, G, N)
  kDecFwd = 2,         // acc's digits (no rotation), forward, folded
  kDecFwdKey = 3,      // 2, the limb split, the key rows, folded
  kDecFwdMac = 4,      // 2, the limb split, the MAC: both channels, folded
  kInvOnly = 5,        // inverse and fold of a stand-in channel, into acc
  kDecFwdMacInv = 6,   // acc's digits (no rotation) times the key row
  kFull = 7,           // the CMUX step
  kNoop = 8,           // acc + 1                                 (B, M, N)
  kRotBits0 = 9,       // X^(p & 0x1F) * acc (no -1)              (B, M, N)
  kRotBits1 = 10,      // X^(p & 0xE0) * acc
  kRotBits2 = 11,      // X^(p & 0x300) * acc
  kRotDecFwd = 12,     // 2 on the rotation's digits
  kRotDecFwdKey = 13,  // 3 on the rotation's digits
  kRotDecFwdMac = 14,  // 4 on the rotation's digits
  kInvProbe = 15,      // K13: the exact inverse, fold and normalisation
                       // alone, on tools/exp_inverse.py's stacked input
                       // (inverse_probe.cu), the twiddle form by Variant
};

// The stage a part stops after (its rotating forms are K5's parts)
__host__ __device__ constexpr int stage_of(int p) {
  return p == kRotDecFwd ? kDecFwd
         : p == kRotDecFwdKey ? kDecFwdKey
         : p == kRotDecFwdMac ? kDecFwdMac : p;
}

__host__ __device__ constexpr bool rot_bits(int p) {
  return p == kRotBits0 || p == kRotBits1 || p == kRotBits2;
}

template <int P, int M, int D>
struct PartOut {
  static constexpr bool kRotates = P == kRotate || P == kRotDecomp ||
                                   P == kFull || P == kRotDecFwd ||
                                   P == kRotDecFwdKey || P == kRotDecFwdMac;
  // the accumulator is the output (else a folded buffer in `work`)
  static constexpr bool kFromAcc = P == kInvOnly || P == kDecFwdMacInv ||
                                   P == kFull || P == kNoop || P == kInvProbe;
  // output polynomials a sample, and the work polynomials summed into one
  static constexpr int kPolys = P == kRotDecomp ? M * D : M;
  static constexpr int kSum =
      stage_of(P) == kDecFwd ? D
      : (stage_of(P) == kDecFwdKey || stage_of(P) == kDecFwdMac) ? 2 : 1;
};

// How the whole step (kFull) runs inside the chunk loop.  kAsIs is K1 and
// K3.  K6 (step_context.cu) swaps one stage for a cheap, shape-correct,
// deterministic stand-in, so that the full step minus the variant is that
// stage's cost inside the loop; K8 (step_overlap.cu) runs the exact step
// in the split-halves schedule (split_halves), bit-equal to K1:
enum Variant : int {
  kAsIs = 0,           // the step
  kNoopStep = 1,       // acc + 1 (the loop's own cost)
  kDotOnly = 2,        // the MAC alone: its limbs the bytes of acc's words
                       // (kNoForward's slot layout, kNoLimbSplit's split),
                       // its channels folded into acc (kNoInverse)
  kNoRotation = 3,     // the digits of acc itself (forward_digits<false>)
  kNoForward = 4,      // digit block j in slots j and j + 32, no DIT
  kNoLimbSplit = 5,    // limbs a0 = (int8) x, a1 = (int8) (x >> 8)
  kNoDecomp = 6,       // every digit (v & base_mask) - half
  kNoInverse = 7,      // the channels folded into acc: slot p' + slot
                       // p' + 32 (lo, and hi exact) at q-layout p'*32 + k
  kNoKeySplit = 8,     // the key rows copied once, the warp's first slot's
                       // at the launch's first step; every slot p then
                       // reads the rows of slot p % warps
  kSplitHalves = 9,    // K8: forward g < G/2; its MAC beside the forward of
                       // g >= G/2; their MAC; the inverse
  // K10 (step_schedules.cu, K1 at (2, 2)), each bit-equal to K1:
  kDigitsStaged = 10,  // v0: the digits stored as int32 (in the limbs'
                       // place), a pass into the padded rows, the forward
                       // as staged passes (staged_forward)
  kStagedForward = 11, // v1 (and K11's t6): the fused digits stored as
                       // padded int16 rows, the forward as one pass a
                       // stage over every polynomial of the block, a limb
                       // split pass
  kUnfusedCombine = 12,  // v2: the MAC's groups partly combined, a combine
                       // pass before the inverse, the channels' sum and
                       // the accumulator add a pass after it
  kPipe2 = 13,         // p2: a software pipeline over two sub-batches of
                       // the block's samples (sample_pipeline)
  kPipe2Dots = 14,     // p2b: the same with both MACs before either back
  kPipe4 = 15,         // p4: over four sub-batches
  // K11 (step_tricks.cu, K3 at (2, 2)), each bit-equal to K3 (t8: on even
  // rotation amounts):
  kTwoRollTwiddle = 16,  // t10: the twiddles' roll-roll-select form
  kSeparateAdd = 17,   // t9: the inverse's output through shared memory, the
                       // accumulator add a pass of its own (add_pass)
  kEvenBarrelSepAdd = 18,  // t8+t9: kEvenBarrel and kSeparateAdd
  kEvenBarrel = 19,    // t8: t14's barrel without round 0 (p even)
  kStagedInverse = 20, // t7: the inverse as one pass a stage over every
                       // channel polynomial (staged_inverse)
  kDeferredCarry = 21, // t5: the deferred-carry barrel (kRotDeferred)
  // K12 (rotate_forms.cu, K3 at (2, 2)): the barrel's forms, bit-equal to K3
  kBarrelWhole = 22,   // t11
  kBarrelSliced = 23,  // t12
  kBarrelFusedI = 24,  // t13
  kBarrelBoth = 25,    // t14
  // K13 (inverse_probe.cu, part kInvProbe): the twiddle forms (kAsIs:
  // "sliced", K3's)
  kProbeBase = 26,     // kTwPerBit
  kProbeNotw = 27,     // kTwNone
  kProbeAlign = 28,    // kTwAligned
  kProbeNoroll = 29,   // kTwSignOnly
};

// What a variant changes (each default is K1/K3's)
__host__ __device__ constexpr int rot_form(int v) {
  return v == kBarrelWhole ? kRotWhole
         : v == kBarrelSliced ? kRotSliced
         : v == kBarrelFusedI ? kRotFusedI
         : (v == kBarrelBoth || v == kEvenBarrel || v == kEvenBarrelSepAdd)
             ? kRotBoth
         : v == kDeferredCarry ? kRotDeferred : kRotGather;
}

__host__ __device__ constexpr int rot_skip(int v) {
  return v == kEvenBarrel || v == kEvenBarrelSepAdd ? 1 : 0;
}

__host__ __device__ constexpr int twiddle_of(int v) {
  return v == kTwoRollTwiddle ? kTwTwoRoll
         : v == kProbeBase ? kTwPerBit
         : v == kProbeNotw ? kTwNone
         : v == kProbeAlign ? kTwAligned
         : v == kProbeNoroll ? kTwSignOnly : kTwSliced;
}

__host__ __device__ constexpr bool staged_fwd(int v) {
  return v == kDigitsStaged || v == kStagedForward;
}

__host__ __device__ constexpr bool separate_add(int v) {
  return v == kUnfusedCombine || v == kSeparateAdd || v == kEvenBarrelSepAdd;
}

// sub-batches of K10's pipelines (1: none)
__host__ __device__ constexpr int pipe_parts(int v) {
  return v == kPipe4 ? 4 : (v == kPipe2 || v == kPipe2Dots) ? 2 : 1;
}

// variants whose digits and forward are K3's own (forward_digits)
__host__ __device__ constexpr bool plain_forward(int v) {
  return v == kAsIs || v == kNoLimbSplit || v == kNoInverse ||
         v == kNoKeySplit || v == kUnfusedCombine || v == kTwoRollTwiddle ||
         v == kSeparateAdd || v == kStagedInverse;
}

// kDecFwdKey's stand-in for the MAC of slot p: the copy of the slot's
// key rows (fetch_rows), then one read of each row word and of the slot's
// digit limbs; the lo channel of every (sample, o) gets the sum.
template <int M, int D, bool kRounded = false>
__device__ __forceinline__ void key_slot(int p,
                                         const int8_t* __restrict__ rows,
                                         uint32_t* arow, uint32_t* work,
                                         const uint32_t* limbs) {
  using S = Shape<M, D>;
  const int lane = threadIdx.x & 31;
  fetch_rows<M, D, kRounded>(p, rows, arow);
  wait_rows();
  uint32_t ksum = 0;
#pragma unroll
  for (int r = 0; r < S::kG * M * (kRounded ? 4 : 6); ++r)
    ksum += arow[r * kRowWords + (lane & 15)];
  const int8_t* lb =
      reinterpret_cast<const int8_t*>(limbs + p * S::kRegionWords);
#pragma unroll
  for (int n = 0; n < S::kS; ++n) {
    int lsum = 0;
#pragma unroll
    for (int gi = 0; gi < 2 * S::kG; ++gi)
      lsum += lb[(gi * S::kS + n) * 32 + lane];
#pragma unroll
    for (int o = 0; o < M; ++o)
      work[n * S::kWorkWords + (o * kL + p) * kR + lane] =
          ksum + (uint32_t)lsum;
  }
  __syncwarp();   // the next slot rewrites the key rows
}

// K6's stand-ins for the stages up to the forward transform, in place of
// forward_digits: x[f] as the forward would leave it (stored to slot
// rev6(f)); see Variant.
template <int V>
__device__ __forceinline__ void forward_stand_in(const uint32_t* a, int p,
                                                 int shift, uint32_t offset,
                                                 int base_mask, int half,
                                                 int lane, int (&x)[kL]) {
  if constexpr (V == kNoRotation) {
    forward_digits<false>(a, p, shift, offset, base_mask, half, lane, x);
  } else if constexpr (V == kNoDecomp) {
#pragma unroll
    for (int j = 0; j < kL / 2; ++j) {
      x[rev6c(j)] =
          (int)(rotated_coeff(a, p, j, lane) & (uint32_t)base_mask) - half;
      x[rev6c(j) + 1] = 0;
    }
    dft_regs<int, false>(x, lane);
  } else {
    // block j to slots j and j + 32: frequencies rev6(j) and rev6(j) + 1
#pragma unroll
    for (int j = 0; j < kL / 2; ++j) {
      int v;
      if constexpr (V == kDotOnly)
        v = (int)rotated_coeff<false>(a, p, j, lane);
      else
        v = gadget_digit(rotated_coeff(a, p, j, lane), shift, offset,
                         base_mask, half);
      x[rev6c(j)] = v;
      x[rev6c(j) + 1] = v;
    }
  }
}

// A warp's key rows in words: K8's halves hold G/2 digit polynomials
template <int M, int D, bool kRounded, int V>
__host__ __device__ constexpr int arow_words() {
  return (V == kSplitHalves ? M * D / 2 : M * D) * M * (kRounded ? 4 : 6) *
         kRowWords;
}

// K8's hi channel of the pairs s*M + o >= kS*M/2 between its two MACs
template <int M, int D, int V>
__host__ __device__ constexpr int hi_x_words() {
  return V == kSplitHalves ? kL * Shape<M, D>::kS * M / 2 * kR : 0;
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// K8's phases 1-4 (exact form): the first kS*G/2 warps run the rotation,
// digits, forward and limb split of the digit polynomials g < G/2 of
// their sample, arrive at named barrier 1 and go on to those of g >= G/2;
// the other warps wait at barrier 1 and meanwhile run the MAC of the
// first half (mac_slot half 0); then every warp runs the MAC of the second
// half (half 1), which adds into the channels.  Afterwards the channels
// are K1's, so the inverse follows unchanged.  p_row: the step's rotation
// amounts of the block's samples.
template <int M, int D>
__device__ __forceinline__ void split_halves(
    const uint32_t* acc_s, const int32_t* __restrict__ p_row, int ns,
    const int8_t* __restrict__ rows, uint32_t* arow, uint32_t* work,
    uint32_t* limbs, uint32_t* hi_x, uint32_t offset, int log2_base,
    int base_mask, int half) {
  using S = Shape<M, D>;
  constexpr int kHalfG = S::kG / 2;
  constexpr int kFwd = S::kS * kHalfG;
  static_assert(2 * kFwd == S::kWarps, "half the warps run the forward");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < kFwd) {
    const int s = warp / kHalfG;
    const int p = s < ns ? (__ldg(p_row + s) & (2 * kN - 1)) : 0;
    uint8_t* lb = reinterpret_cast<uint8_t*>(limbs);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int g = h * kHalfG + warp % kHalfG;
      const uint32_t* a = acc_s + s * S::kAccWords + (g / D) * kN;
      const int shift = 32 - (g % D + 1) * log2_base;
      int x[kL];
      forward_digits<true>(a, p, shift, offset, base_mask, half, lane, x);
#pragma unroll
      for (int f = 0; f < kL; ++f) {
        uint8_t* reg =
            lb + rev6c(f) * S::kRegionWords * 4 + (g * 2 * S::kS + s) * 32;
        reg[lane] = (uint8_t)limb0(x[f]);
        reg[S::kS * 32 + lane] = (uint8_t)limb1(x[f]);
      }
      if (h == 0) bar_arrive(1, S::kThreads);
    }
  } else {
    bar_sync(1, S::kThreads);
    for (int p = warp - kFwd; p < kL; p += kFwd)
      mac_slot<M, D, false, 0>(p, rows, arow, work, limbs, true, hi_x);
  }
  __syncthreads();
  for (int p = warp; p < kL; p += S::kWarps)
    mac_slot<M, D, false, 1>(p, rows, arow, work, limbs, true, hi_x);
  __syncthreads();
}

// Rows of a set of polynomials in shared memory: polynomial i < n0 at
// a + i*ps_a, row r at + r*rs_a; the others at b + (i - n0)*ps_b, row r at
// + r*rs_b (the lo channels and the hi channels of the inverse)
template <typename T>
struct PolyRows {
  T* a;
  int ps_a, rs_a, n0;
  T* b;
  int ps_b, rs_b;
  __device__ __forceinline__ T* operator()(int poly, int r) const {
    return poly < n0 ? a + poly * ps_a + r * rs_a
                     : b + (poly - n0) * ps_b + r * rs_b;
  }
};

// dft_regs's transform as one pass a stage over every polynomial of the
// block in shared memory (K10's v0/v1, K11's t6 and t7): a warp takes a
// butterfly pair (i, j) of a polynomial at a time, its 32 lanes the
// coefficients, and reads x_j at the twiddle's rotated lane; a block
// barrier ends each stage.  Input in bit-reversed row order, output
// natural; int16 rows hold the forward's values (|x| <= 2^14) as int.
template <bool kInverse, typename T, typename Rows>
__device__ __forceinline__ void staged_dft(const Rows& rows, int n_polys) {
  using W = typename std::conditional<kInverse, uint32_t, int>::type;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
#pragma unroll 1
  for (int stage = 0; stage < 6; ++stage) {
    const int mmax = 1 << stage;
#pragma unroll 1
    for (int u = warp; u < n_polys * 32; u += n_warps) {
      const int poly = u >> 5;
      const int pair = u & 31;
      const int m = pair & (mmax - 1);
      const int i = ((pair >> stage) << (stage + 1)) + m;
      int tw = m << (5 - stage);
      if (kInverse) tw = -tw;
      tw &= 63;
      const int sh = tw & 31;
      T* ri = rows(poly, i);
      T* rj = rows(poly, i + mmax);
      const W xi = (W)ri[lane];
      W xj = (W)rj[(lane - sh) & 31];
      if ((lane < sh) != (tw >= 32)) xj = (W)0 - xj;
      __syncwarp();
      ri[lane] = (T)(xi + xj);
      rj[lane] = (T)(xi - xj);
    }
    __syncthreads();
  }
}

// K10's v0 and v1 and K11's t6, phases 1-3 after the digit warps: v0's pass
// from the int32 digits (in the limbs' place, polynomial pi = s*G + g,
// block j lane i at pi*1024 + j*32 + i) into the padded int16 rows (in the
// lo channel's place, pi*2048 + row*32 + lane; v1 and t6's warps store
// those rows themselves), the forward's staged passes, and the limb split
// into K3's slot layout, ended by a block barrier: the MAC reads every
// sample's limbs and writes the lo channel over the rows.
template <int M, int D, int V>
__device__ __forceinline__ void staged_forward(uint32_t* work,
                                               uint32_t* limbs) {
  using S = Shape<M, D>;
  constexpr int kPolys = S::kS * S::kG;
  static_assert(kPolys * kL * kR * 2 <= S::kS * S::kWorkWords * 4,
                "the int16 rows fit the lo channel's place");
  static_assert(kPolys * kN <= kL * S::kRegionWords,
                "the int32 digits fit the limbs' place");
  int16_t* rows = reinterpret_cast<int16_t*>(work);
  if constexpr (V == kDigitsStaged) {
    for (int e = threadIdx.x; e < kPolys * kN; e += S::kThreads) {
      int16_t* r = rows + (e >> 10) * kL * kR + rev6((e >> 5) & 31) * kR +
                   (e & 31);
      r[0] = (int16_t)limbs[e];
      r[kR] = 0;
    }
    __syncthreads();
  }
  staged_dft<false, int16_t>(
      PolyRows<int16_t>{rows, kL * kR, kR, kPolys, rows, 0, 0}, kPolys);
  uint8_t* lb = reinterpret_cast<uint8_t*>(limbs);
  for (int e = threadIdx.x; e < kPolys * kL * kR; e += S::kThreads) {
    const int pi = e >> 11;
    const int x = rows[e];
    uint8_t* reg = lb + rev6((e >> 5) & 63) * S::kRegionWords * 4 +
                   ((pi % S::kG) * 2 * S::kS + pi / S::kG) * 32 + (e & 31);
    reg[0] = (uint8_t)limb0(x);
    reg[S::kS * 32] = (uint8_t)limb1(x);
  }
  __syncthreads();   // every limb written and every row read before a MAC
}

// v0 and v1/t6's digit warp (sample s, digit polynomial g; pi = s*G + g):
// the rotation and the digits, stored for staged_forward
template <int V>
__device__ __forceinline__ void stage_digits(const uint32_t* a, int p,
                                             int shift, uint32_t offset,
                                             int base_mask, int half,
                                             int lane, int pi,
                                             uint32_t* work,
                                             uint32_t* limbs) {
  int16_t* rows = reinterpret_cast<int16_t*>(work) + pi * kL * kR;
#pragma unroll
  for (int j = 0; j < kL / 2; ++j) {
    const int d = gadget_digit(rotated_coeff(a, p, j, lane), shift, offset,
                               base_mask, half);
    if constexpr (V == kDigitsStaged) {
      limbs[pi * kN + j * 32 + lane] = (uint32_t)d;
    } else {
      rows[rev6c(j) * kR + lane] = (int16_t)d;
      rows[(rev6c(j) + 1) * kR + lane] = 0;
    }
  }
}

// The barrel's rotation (rot_form), the digits and the forward transform
// of one digit warp, into its registers as forward_digits leaves them
template <int kForm, int kSkip>
__device__ __forceinline__ void forward_barrel(const uint32_t* a, int p,
                                               int shift, uint32_t offset,
                                               int base_mask, int half,
                                               int lane, uint32_t* scratch,
                                               int (&x)[kL]) {
  uint32_t r[kL / 2];
  barrel_rotate<kForm, kSkip>(a, p, lane, scratch, r);
#pragma unroll
  for (int j = 0; j < kL / 2; ++j) {
    x[rev6c(j)] = gadget_digit(r[j], shift, offset, base_mask, half);
    x[rev6c(j) + 1] = 0;
  }
  dft_regs<int, false>(x, lane);
}

// The accumulator add as a pass of its own (t9, t8+t9, v2 and t7): the
// folded lo channel of (s, o) in its rows 0..31, hi >> 6 where K3 leaves
// it (exact form), both added into the accumulator
template <int M, int D, bool kRounded>
__device__ __forceinline__ void add_pass(uint32_t* acc_s, const uint32_t* work,
                                         const uint32_t* limbs) {
  using S = Shape<M, D>;
  for (int e = threadIdx.x; e < S::kS * S::kAccWords; e += S::kThreads) {
    const int so = e >> 10;
    const int q = e & (kN - 1);
    uint32_t d = work[so * kL * kR + q];
    if constexpr (!kRounded)
      d += limbs[so * kR + (q >> 5) * S::kRegionWords + (q & 31)];
    acc_s[e] += d;
  }
}

// v2's combine pass after the MAC (mac_slot kPartial): lo += A3<<24 and,
// exact, hi = B (the low 24 bits of A3<<24 + B, sign-extended: |B| <=
// G*2^17)
template <int M, int D, bool kRounded>
__device__ __forceinline__ void combine_pass(uint32_t* work, uint32_t* limbs) {
  using S = Shape<M, D>;
  for (int e = threadIdx.x; e < S::kS * S::kWorkWords; e += S::kThreads) {
    const int n = e / S::kWorkWords;
    const int o = (e % S::kWorkWords) / (kL * kR);
    const int p = (e / kR) % kL;
    uint32_t* hl = limbs + p * S::kRegionWords + (n * M + o) * kR + (e & 31);
    const uint32_t w2 = *hl;
    if constexpr (kRounded) {
      work[e] += w2 << 24;
    } else {
      const uint32_t b = (uint32_t)((int32_t)(w2 << 8) >> 8);
      work[e] += w2 - b;
      *hl = b;
    }
  }
}

// t7: the inverse of every channel polynomial (lo of (s, o) in the lo
// channel, hi over the slots' limbs) by staged_dft, the fold (hi >> 6) a
// pass, and add_pass
template <int M, int D, bool kRounded>
__device__ __forceinline__ void staged_inverse(uint32_t* acc_s,
                                               uint32_t* work,
                                               uint32_t* limbs) {
  using S = Shape<M, D>;
  constexpr int kPairs = S::kS * M;
  constexpr int kPolys = (kRounded ? 1 : 2) * kPairs;
  const PolyRows<uint32_t> rows{work, kL * kR, kR, kPairs,
                                limbs, kR, S::kRegionWords};
  staged_dft<true, uint32_t>(rows, kPolys);
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < kPolys * 32; u += S::kWarps) {
    const int poly = u >> 5;
    const int j = u & 31;
    uint32_t y = rows(poly, j + 32)[(lane + 31) & 31];
    if (lane == 0) y = 0u - y;
    uint32_t* rj = rows(poly, j);
    const uint32_t c = rj[lane] + y;
    rj[lane] = poly >= kPairs ? (uint32_t)((int32_t)c >> 6) : c;
  }
  __syncthreads();
  add_pass<M, D, kRounded>(acc_s, work, limbs);
}

// The inverse ("back") of sub-batch q of K10's p2/p4, by the pipeline's
// first warps: K1's inverse restricted to the pairs (s, o) of samples
// [q*kSub, (q+1)*kSub); the hi warps reach the lo warps through named
// barrier `bar` (kWarpsIn warps)
template <int M, int D, bool kRounded, int kSub, int kWarpsIn>
__device__ __forceinline__ void back_samples(int q, uint32_t* acc_s,
                                             uint32_t* work, uint32_t* limbs,
                                             int bar) {
  using S = Shape<M, D>;
  constexpr int kPairs = kSub * M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool role = warp < (kRounded ? 1 : 2) * kPairs;
  const bool hi_warp = warp >= kPairs;
  const int so = q * kPairs + warp % kPairs;
  uint32_t* src = hi_warp ? limbs + so * kR : work + so * kL * kR;
  const int stride = hi_warp ? S::kRegionWords : kR;
  uint32_t x[kL];
  if (role) {
#pragma unroll
    for (int r = 0; r < kL; ++r) x[r] = src[r * stride + lane];
    inverse_fold(x, lane);
    if (hi_warp) {
#pragma unroll
      for (int j = 0; j < kL / 2; ++j)
        src[j * stride + lane] = (uint32_t)((int32_t)x[j] >> 6);
    }
  }
  if constexpr (!kRounded) bar_sync(bar, kWarpsIn * 32);
  if (role && !hi_warp) {
    uint32_t* acc = acc_s + so * kN + lane;
#pragma unroll
    for (int j = 0; j < kL / 2; ++j) {
      uint32_t delta = x[j];
      if constexpr (!kRounded) delta += limbs[j * S::kRegionWords + so * kR + lane];
      acc[j * 32] += delta;
    }
  }
}

// K10's p2, p4 and p2b: a software pipeline over kQ sub-batches of the
// block's samples.  The first kSub*G warps run the rotation, digits,
// forward and limb split ("front") of sub-batch q, q = 0, 1, ..., each
// followed by bar.arrive on barrier 1 + q; the other warps wait there and
// run sub-batch q's MAC over the 64 slots (mac_slot kQ: the limbs
// sample-major, each sample's hi channel over its own limbs), so that
// front(q + 1) overlaps MAC(q).  Without kDotsEarly the first warps then
// wait on barrier 1 + kQ + q (the MAC warps arrive there) and run the back
// of sub-batch q, overlapping MAC(q + 1); with it (p2b) every warp runs
// K1's inverse after both MACs.  Bit-equal to K1: every sample's
// arithmetic is K1's.
template <int M, int D, bool kRounded, int kQ, bool kDotsEarly>
__device__ __forceinline__ void sample_pipeline(
    uint32_t* acc_s, const int32_t* __restrict__ p_row, int ns,
    const int8_t* __restrict__ rows, uint32_t* arow, uint32_t* work,
    uint32_t* limbs, uint32_t offset, int log2_base, int base_mask,
    int half) {
  using S = Shape<M, D>;
  constexpr int kSub = S::kS / kQ;
  constexpr int kFront = kSub * S::kG;
  constexpr int kMac = S::kWarps - kFront;
  static_assert(S::kS % kQ == 0 && kMac > 0, "the pipeline's warps");
  static_assert((kRounded ? 1 : 2) * kSub * M <= kFront, "the back's roles");
  static_assert(2 * kQ + 1 < 16, "named barriers");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < kFront) {
    const int g = warp % S::kG;
    uint8_t* lb = reinterpret_cast<uint8_t*>(limbs);
#pragma unroll 1
    for (int q = 0; q < kQ; ++q) {
      const int s = q * kSub + warp / S::kG;
      const int p = s < ns ? (__ldg(p_row + s) & (2 * kN - 1)) : 0;
      const uint32_t* a = acc_s + s * S::kAccWords + (g / D) * kN;
      int x[kL];
      forward_digits<true>(a, p, 32 - (g % D + 1) * log2_base, offset,
                           base_mask, half, lane, x);
#pragma unroll
      for (int f = 0; f < kL; ++f) {
        uint8_t* reg = lb + rev6c(f) * S::kRegionWords * 4 +
                       ((s * S::kG + g) * 2) * 32;
        reg[lane] = (uint8_t)limb0(x[f]);
        reg[32 + lane] = (uint8_t)limb1(x[f]);
      }
      bar_arrive(1 + q, S::kThreads);
    }
    if constexpr (!kDotsEarly) {
#pragma unroll 1
      for (int q = 0; q < kQ; ++q) {
        bar_sync(1 + kQ + q, S::kThreads);
        back_samples<M, D, kRounded, kSub, kFront>(q, acc_s, work, limbs,
                                                   1 + 2 * kQ);
      }
    }
  } else {
#pragma unroll 1
    for (int q = 0; q < kQ; ++q) {
      bar_sync(1 + q, S::kThreads);
      for (int p = warp - kFront; p < kL; p += kMac)
        mac_slot<M, D, kRounded, -1, kQ>(p, rows, arow, work, limbs, true,
                                         nullptr, q);
      if constexpr (!kDotsEarly) bar_arrive(1 + kQ + q, S::kThreads);
    }
  }
  __syncthreads();
}

template <int M, int D, bool kRounded, int kPart = kFull, int kVariant = kAsIs>
__global__ void __launch_bounds__(Shape<M, D>::kThreads, 1)
blind_rotate_kernel(const int32_t* __restrict__ acc_in,
                    int32_t* __restrict__ acc_out,
                    const int32_t* __restrict__ bara_t,
                    const int8_t* __restrict__ rows, int batch, int start,
                    int chunk, uint32_t offset, int log2_base) {
  using S = Shape<M, D>;
  using O = PartOut<kPart, M, D>;
  constexpr int kStage = stage_of(kPart);
  constexpr bool kStandInLimbs =
      kVariant == kNoLimbSplit || kVariant == kDotOnly;
  constexpr bool kStandInInverse =
      kVariant == kNoInverse || kVariant == kDotOnly;
  constexpr int kG = S::kG;
  constexpr int kS = S::kS;
  constexpr int kWarps = S::kWarps;
  constexpr int kThreads = S::kThreads;
  constexpr int kAccWords = S::kAccWords;
  // the MAC loop of phase 4 (K1, K3 and the variants that keep it)
  constexpr bool kMacLoop =
      kVariant != kSplitHalves && pipe_parts(kVariant) == 1 &&
      (kStage == kDecFwdMac || kPart == kDecFwdMacInv || kPart == kFull);
  constexpr int kChanRoles = (kRounded ? 1 : 2) * kS * M;
  // the pair (Shape::kPair = 2): block rank r of the cluster runs the MAC
  // of slots [r * 32, r * 32 + 32) for both blocks' samples
  constexpr int kPair = S::kPair;
  static_assert(kPair == 1 || (kPart == kFull && kVariant == kAsIs),
                "only K1 and K3 run as pairs");
  constexpr int kSlots = kL / kPair;             // MAC slots a block
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc_s = smem;                        // [kS][M][1024] q-layout
  uint32_t* work = acc_s + kS * kAccWords;       // [kS][M][64][32]
  uint32_t* limbs = work + kS * S::kWorkWords;   // [64 slots][kRegionWords]
  uint32_t* arows = limbs + kL * S::kRegionWords;   // [warps][G*M][rows][16]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kS;
  const int ns = min(kS, batch - b0);
  uint32_t* arow = arows + warp * arow_words<M, D, kRounded, kVariant>();
  uint32_t* hi_x = arows + kWarps * arow_words<M, D, kRounded, kVariant>();
  const int slot0 = kPair > 1 ? cluster_rank() * kSlots : 0;

  for (int e = tid; e < kS * kAccWords; e += kThreads) {
    const int s = e / kAccWords;
    const int on = e % kAccWords;
    const uint32_t v =
        s < ns ? (uint32_t)acc_in[(size_t)(b0 + s) * kAccWords + on] : 0u;
    if constexpr (kPart == kInvProbe)
      acc_s[e] = v;   // the probe's rows as they are
    else
      acc_s[s * kAccWords + (on & ~(kN - 1)) + q_of(on & (kN - 1))] = v;
  }
  __syncthreads();

  const int base_mask = (1 << log2_base) - 1;
  const int half = 1 << (log2_base - 1);
  const int lane = tid & 31;
  for (int st = 0; st < chunk; ++st) {
    const size_t step = (size_t)(start + st);
    const int8_t* step_rows =
        rows + (size_t)st * KeyRows<M, D, kRounded>::kStepBytes;

    if constexpr (kPart == kNoop || kVariant == kNoopStep) {
      for (int e = tid; e < kS * kAccWords; e += kThreads) acc_s[e] += 1u;
      __syncthreads();
      continue;
    }

    // the key rows of the warp's first slot come in while phases 1-3 run
    // (arow is the MAC's alone)
    if constexpr (kMacLoop)
      if (kVariant != kNoKeySplit || st == 0)
        fetch_rows<M, D, kRounded>(slot0 + warp, step_rows, arow);

    // 1-3. a warp a (sample, digit polynomial g = o*D + d): rotation,
    // digit and forward transform in registers, the split into int8 limbs
    // a0, a1 by MAC slot p = rev6(frequency)
    if constexpr (kPart != kInvOnly && kPart != kInvProbe &&
                  kVariant != kSplitHalves && pipe_parts(kVariant) == 1) {
      if (S::kDigitRoles == kWarps || warp < S::kDigitRoles) {
        const int s = warp / kG;
        const int g = warp % kG;
        const int p = s < ns
            ? (__ldg(bara_t + step * batch + b0 + s) & (2 * kN - 1)) : 0;
        const uint32_t* a = acc_s + s * kAccWords + (g / D) * kN;
        const int shift = 32 - (g % D + 1) * log2_base;
        if constexpr (kPart == kRotate || kPart == kRotDecomp ||
                      rot_bits(kPart)) {
          // coefficient lane*32 + j at q-layout j*32 + lane
#pragma unroll
          for (int j = 0; j < kL / 2; ++j) {
            uint32_t v;
            if constexpr (rot_bits(kPart))
              v = rotated_coeff<true, false>(
                  a, p & (kPart == kRotBits0   ? 0x1F
                          : kPart == kRotBits1 ? 0xE0 : 0x300), j, lane);
            else
              v = rotated_coeff(a, p, j, lane);
            if constexpr (kPart != kRotDecomp)
              work[(s * M + g / D) * kN + j * 32 + lane] = v;
            else
              work[(s * kG + g) * kN + j * 32 + lane] =
                  (uint32_t)gadget_digit(v, shift, offset, base_mask, half);
          }
        } else if constexpr (staged_fwd(kVariant)) {
          stage_digits<kVariant>(a, p, shift, offset, base_mask, half, lane,
                                 warp, work, limbs);
        } else {
          int x[kL];
          if constexpr (rot_form(kVariant) != kRotGather) {
            static_assert(S::kDigitRoles == kWarps &&
                          kWarps * kN <= kS * S::kWorkWords,
                          "a digit warp's barrel scratch in the lo channel");
            forward_barrel<rot_form(kVariant), rot_skip(kVariant)>(
                a, p, shift, offset, base_mask, half, lane, work + warp * kN,
                x);
          } else if constexpr (plain_forward(kVariant))
            forward_digits<O::kRotates, twiddle_of(kVariant)>(
                a, p, shift, offset, base_mask, half, lane, x);
          else
            forward_stand_in<kVariant>(a, p, shift, offset, base_mask, half,
                                       lane, x);
          if constexpr (kStage == kDecFwd) {
            // frequencies 2m and 2m + 1 lie in slots rev6(2m) and + 32
#pragma unroll
            for (int m = 0; m < kL / 2; ++m)
              work[(s * kG + g) * kN + rev6c(2 * m) * 32 + lane] =
                  (uint32_t)(x[2 * m] + x[2 * m + 1]);
          } else if constexpr (kPair > 1) {
            // byte lane of the row: word (lane >> 2) & 3, half lane >> 4
            uint8_t* lb = reinterpret_cast<uint8_t*>(limbs) + (lane & 3) +
                          4 * pair_limb_word<kG, kS>(0, s, (lane >> 2) & 3, g,
                                                     lane >> 4);
            constexpr int kLimb1 = 4 * pair_limb_word<kG, kS>(1, 0, 0, 0, 0);
#pragma unroll
            for (int f = 0; f < kL; ++f) {
              uint8_t* reg = lb + rev6c(f) * S::kRegionWords * 4;
              reg[0] = (uint8_t)limb0(x[f]);
              reg[kLimb1] = (uint8_t)limb1(x[f]);
            }
          } else {
            uint8_t* lb = reinterpret_cast<uint8_t*>(limbs);
#pragma unroll
            for (int f = 0; f < kL; ++f) {
              uint8_t* reg =
                  lb + rev6c(f) * S::kRegionWords * 4 + (g * 2 * kS + s) * 32;
              if constexpr (kStandInLimbs) {
                reg[lane] = (uint8_t)x[f];
                reg[kS * 32 + lane] = (uint8_t)(x[f] >> 8);
              } else {
                reg[lane] = (uint8_t)limb0(x[f]);
                reg[kS * 32 + lane] = (uint8_t)limb1(x[f]);
              }
            }
          }
        }
      }
      pair_sync<kPair>();   // the pair: the peer's MAC reads these limbs
      if constexpr (staged_fwd(kVariant)) staged_forward<M, D, kVariant>(
          work, limbs);
    }

    // 4. the MAC, a warp a slot (kDecFwdKey: its stand-in; K8: phases 1-4
    // in the split schedule; K10's pipelines: phases 1-4, and 5-6 but in
    // p2b)
    if constexpr (kVariant == kSplitHalves) {
      split_halves<M, D>(acc_s, bara_t + step * batch + b0, ns, step_rows,
                         arow, work, limbs, hi_x, offset, log2_base,
                         base_mask, half);
    } else if constexpr (pipe_parts(kVariant) > 1) {
      sample_pipeline<M, D, kRounded, pipe_parts(kVariant),
                      kVariant == kPipe2Dots>(
          acc_s, bara_t + step * batch + b0, ns, step_rows, arow, work, limbs,
          offset, log2_base, base_mask, half);
    } else if constexpr (kStage == kDecFwdKey) {
      for (int p = warp; p < kL; p += kWarps)
        key_slot<M, D, kRounded>(p, step_rows, arow, work, limbs);
      __syncthreads();
    } else if constexpr (kMacLoop) {
      for (int j = warp; j < kSlots; j += kWarps)
        mac_slot<M, D, kRounded, -1, 1, kVariant == kUnfusedCombine, kPair>(
            slot0 + j, step_rows, arow, work, limbs,
            kVariant != kNoKeySplit && j != warp);
      pair_sync<kPair>();   // the pair: every channel, local or remote
      if constexpr (kVariant == kUnfusedCombine) {
        combine_pass<M, D, kRounded>(work, limbs);
        __syncthreads();
      }
    }
    if constexpr (kStage == kDecFwdMac && !kRounded) {
      // the hi channel (over the slots' limbs) onto the lo channel
      for (int e = tid; e < kS * S::kWorkWords; e += kThreads)
        work[e] += limbs[((e >> 5) & (kL - 1)) * S::kRegionWords +
                         (e >> 11) * kR + (e & 31)];
      __syncthreads();
    }

    // 5-6. a warp a channel polynomial (lo of (s, o), and hi in the exact
    // form): the inverse transform and the fold, coefficient i*32 + j at
    // q-layout j*32 + i; hi >> 6 waits in its rows 0..31, lo + (hi >> 6)
    // (or lo) is added to the accumulator (kDecFwdMacInv: in its place;
    // kInvOnly: the stand-in channel is acc's q-layout polynomial, twice;
    // K6's inverse stand-in: the channels' fold, into acc)
    if constexpr (kStandInInverse) {
      for (int e = tid; e < kS * kAccWords; e += kThreads) {
        const uint32_t* w = work + (e >> 10) * kL * kR + (e & (kN - 1));
        uint32_t v = w[0] + w[kN];
        if constexpr (!kRounded) {
          const uint32_t* h = limbs + (e >> 10) * kR + (e & 31) +
                              ((e >> 5) & 31) * S::kRegionWords;
          v += h[0] + h[32 * S::kRegionWords];
        }
        acc_s[e] += v;
      }
    } else if constexpr (kVariant == kStagedInverse) {
      staged_inverse<M, D, kRounded>(acc_s, work, limbs);
    } else if constexpr (O::kFromAcc && (pipe_parts(kVariant) == 1 ||
                                         kVariant == kPipe2Dots)) {
      const bool role = kChanRoles == kWarps || warp < kChanRoles;
      // the rounded form has no hi channel: its loads' stride is a
      // constant, so no address of them is held across the steps
      const bool hi_warp = !kRounded && warp >= kS * M;
      const int so = warp % (kS * M);            // s * M + o
      uint32_t* src = hi_warp ? limbs + so * kR : work + so * kL * kR;
      const int stride = hi_warp ? S::kRegionWords : kR;
      uint32_t x[kL];
      if (role) {
        if constexpr (kPart == kInvProbe) {
          // K13: channel (hi_warp) of polynomial o of sample s, slot r from
          // row (r mod 16)*128 + ch*64 + o*32 of the sample's 2048 rows
          static_assert(M == 2 && !kRounded, "the probe's stacked rows");
          const uint32_t* in = acc_s + (so / M) * kAccWords +
                               (hi_warp ? 64 : 0) + (so % M) * 32 + lane;
#pragma unroll
          for (int r = 0; r < kL; ++r) x[r] = in[(r & 15) * 128];
        } else {
#pragma unroll
          for (int r = 0; r < kL; ++r)
            x[r] = kPart == kInvOnly ? acc_s[so * kN + (r & 31) * 32 + lane]
                                     : src[r * stride + lane];
        }
        inverse_fold<twiddle_of(kVariant)>(x, lane);
        if (hi_warp) {
#pragma unroll
          for (int j = 0; j < kL / 2; ++j)
            src[j * stride + lane] = (uint32_t)((int32_t)x[j] >> 6);
        }
      }
      if constexpr (!kRounded) __syncthreads();   // every warp is here
      if (role && !hi_warp) {
        if constexpr (kPart == kInvProbe) {
          // c = A + (B >> 6) at row j*64 + o*32 of the sample's output
          uint32_t* out = acc_s + (so / M) * kAccWords + (so % M) * 32 + lane;
#pragma unroll
          for (int j = 0; j < kL / 2; ++j)
            out[j * 64] = x[j] + limbs[j * S::kRegionWords + so * kR + lane];
        } else if constexpr (separate_add(kVariant)) {
#pragma unroll
          for (int j = 0; j < kL / 2; ++j) src[j * kR + lane] = x[j];
        } else {
        uint32_t* acc = acc_s + so * kN + lane;
#pragma unroll
        for (int j = 0; j < kL / 2; ++j) {
          uint32_t delta = x[j];
          if constexpr (!kRounded)
            delta += limbs[j * S::kRegionWords + so * kR + lane];
          if constexpr (kPart == kDecFwdMacInv)
            acc[j * 32] = delta;
          else
            acc[j * 32] += delta;
        }
        }
      }
      if constexpr (separate_add(kVariant)) {
        __syncthreads();
        add_pass<M, D, kRounded>(acc_s, work, limbs);
      }
    }
    __syncthreads();
  }

  if constexpr (O::kFromAcc) {
    for (int e = tid; e < kS * kAccWords; e += kThreads) {
      const int s = e / kAccWords;
      const int on = e % kAccWords;
      if (s < ns) {
        if constexpr (kPart == kInvProbe)
          acc_out[(size_t)(b0 + s) * kAccWords + on] = (int32_t)acc_s[e];
        else
          acc_out[(size_t)(b0 + s) * kAccWords + on] = (int32_t)
              acc_s[s * kAccWords + (on & ~(kN - 1)) + q_of(on & (kN - 1))];
      }
    }
  } else {
    // a part's work buffer: output polynomial i of sample s is the sum of
    // work polynomials (s * kPolys + i) * kSum + d, in coefficient order
    constexpr int kOutWords = O::kPolys * kN;
    for (int e = tid; e < kS * kOutWords; e += kThreads) {
      const int s = e / kOutWords;
      const int on = e % kOutWords;
      if (s >= ns) continue;
      const uint32_t* w = work + (s * O::kPolys + on / kN) * O::kSum * kN +
                          q_of(on & (kN - 1));
      uint32_t v = 0;
#pragma unroll
      for (int d = 0; d < O::kSum; ++d) v += w[d * kN];
      acc_out[(size_t)(b0 + s) * kOutWords + on] = (int32_t)v;
    }
  }
  // the pair: neither block leaves while its peer may reach its shared
  // memory (the last remote access precedes the last MAC barrier)
  if constexpr (kPair > 1) cluster_sync();
}

// A block's shared memory in bytes, set as the kernel's dynamic maximum
template <int M, int D, bool kRounded, int kPart, int kVariant>
cudaError_t set_smem(int* smem) {
  using S = Shape<M, D>;
  *smem = (S::kS * (S::kAccWords + S::kWorkWords) + kL * S::kRegionWords +
           S::kWarps * arow_words<M, D, kRounded, kVariant>() +
           hi_x_words<M, D, kVariant>()) *
          (int)sizeof(uint32_t);
  return cudaFuncSetAttribute(
      blind_rotate_kernel<M, D, kRounded, kPart, kVariant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// The launch of a pair kernel: clusters of Shape::kPair blocks, the grid
// rounded up to whole clusters (a block past the batch holds no sample and
// joins every barrier); the caller sets the grid
template <int M, int D>
cudaLaunchConfig_t pair_config(int smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = Shape<M, D>::kPair;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Shape<M, D>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int M, int D, bool kRounded, int kPart = kFull, int kVariant = kAsIs>
cudaError_t launch(const int32_t* acc_in, int32_t* acc_out,
                   const int32_t* bara_t, const int8_t* rows, int batch,
                   int start, int chunk, uint32_t offset, int log2_base,
                   cudaStream_t stream) {
  using S = Shape<M, D>;
  int smem;
  cudaError_t err = set_smem<M, D, kRounded, kPart, kVariant>(&smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + S::kS - 1) / S::kS;
  if constexpr (S::kPair == 1) {
    blind_rotate_kernel<M, D, kRounded, kPart, kVariant>
        <<<blocks, S::kThreads, smem, stream>>>(
            acc_in, acc_out, bara_t, rows, batch, start, chunk, offset,
            log2_base);
  } else {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = pair_config<M, D>(smem, stream, &attr);
    cfg.gridDim = dim3((blocks + S::kPair - 1) / S::kPair * S::kPair);
    err = cudaLaunchKernelEx(
        &cfg, blind_rotate_kernel<M, D, kRounded, kPart, kVariant>, acc_in,
        acc_out, bara_t, rows, batch, start, chunk, offset, log2_base);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int M, int D>
cudaError_t launch_form(const int32_t* acc_in, int32_t* acc_out,
                        const int32_t* bara_t, const int8_t* rows,
                        int batch, int start, int chunk, uint32_t offset,
                        int log2_base, int rounded, cudaStream_t stream) {
  return rounded ? launch<M, D, true>(acc_in, acc_out, bara_t, rows, batch,
                                      start, chunk, offset, log2_base, stream)
                 : launch<M, D, false>(acc_in, acc_out, bara_t, rows, batch,
                                       start, chunk, offset, log2_base,
                                       stream);
}

// Steps [start, start + chunk) on the device ordinal `device`, `rows` the
// key rows of those steps; returns the CUDA error code
// (cudaErrorInvalidValue for a (mask1, decomp) pair that is not
// instantiated).
inline int blind_rotate_launch_any(const void* acc_in, void* acc_out,
                                   const void* bara_t, const void* rows,
                                   int batch, int start, int chunk, int mask1,
                                   int decomp, unsigned int offset,
                                   int log2_base, int rounded, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  const auto* in = (const int32_t*)acc_in;
  auto* out = (int32_t*)acc_out;
  const auto* bt = (const int32_t*)bara_t;
  const auto* k = (const int8_t*)rows;
  const auto s = (cudaStream_t)stream;
  if (mask1 == 2 && decomp == 2)
    err = launch_form<2, 2>(in, out, bt, k, batch, start, chunk, offset,
                            log2_base, rounded, s);
  else if (mask1 == 3 && decomp == 2)
    err = launch_form<3, 2>(in, out, bt, k, batch, start, chunk, offset,
                            log2_base, rounded, s);
  else if (mask1 == 2 && decomp == 3)
    err = launch_form<2, 3>(in, out, bt, k, batch, start, chunk, offset,
                            log2_base, rounded, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Blocks a cluster of K1 and K3 at (mask1, decomp): Shape::kPair, 0 for a
// pair that is not instantiated
inline int blind_rotate_pair_any(int mask1, int decomp) {
  return mask1 == 2 && decomp == 2   ? Shape<2, 2>::kPair
         : mask1 == 3 && decomp == 2 ? Shape<3, 2>::kPair
         : mask1 == 2 && decomp == 3 ? Shape<2, 3>::kPair
                                     : 0;
}

template <int M, int D, bool kRounded>
int active_clusters(int* out) {
  int smem;
  cudaError_t err = set_smem<M, D, kRounded, kFull, kAsIs>(&smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = pair_config<M, D>(smem, nullptr, &attr);
  cfg.gridDim = dim3(2 * 132 * Shape<M, D>::kPair);
  return (int)cudaOccupancyMaxActiveClusters(
      out, blind_rotate_kernel<M, D, kRounded>, &cfg);
}

// The clusters of K3 at (mask1, decomp) that the device `device` holds at
// once (cudaOccupancyMaxActiveClusters, one cluster a block where the
// shape is not paired) into *out; returns the CUDA error code
inline int blind_rotate_clusters_any(int mask1, int decomp, int rounded,
                                     int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mask1 == 2 && decomp == 2)
    return rounded ? active_clusters<2, 2, true>(out)
                   : active_clusters<2, 2, false>(out);
  if (mask1 == 3 && decomp == 2)
    return rounded ? active_clusters<3, 2, true>(out)
                   : active_clusters<3, 2, false>(out);
  if (mask1 == 2 && decomp == 3)
    return rounded ? active_clusters<2, 3, true>(out)
                   : active_clusters<2, 3, false>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
