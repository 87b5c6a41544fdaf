// One CMUX step of the blind rotation in the lanes layout (K4), for Hopper,
// reading the TPU's int8 key operand in both engine modes.
//
//   acc_q' = acc_q + sum_g decomp_g((X^p - 1) * acc_q) (*) BK_row   mod 2^32
//
// Replaces the TPU kernel nufhe_tpu/ops/pallas/blind_rotate.py::
// make_external_step (whose body is ops/flat_engine.external_step); the
// output equals ops/flat_engine.external_step bit for bit.
//
// Layout (the JAX package's lanes layout and key operand):
//   acc_q   (B, 2*1024) int32, q-layout: coefficient i*32 + j at lane j*32 + i
//   p       (B,) int32 in [0, 2048)
//   key     one row (L=64, C=256, Q) int8, ops/transform.build_mac_rhs:
//           c = g*64 + i*32 + u (digit polynomial g, accumulator limb i,
//           lane u), q = s*64 + o*32 + k (group s, output polynomial o,
//           lane k), slot axis in bit-reversed order, negacyclic signs
//           built in; Q = 320 exact (groups B, A0..A3), 256 rounded (A0..A3)
//   out     (B, 2*1024) int32
//
// Three grids on the launcher's stream, one "launch" of K4:
//   1. forward (a block of 256 threads a sample): rotation, the l=2 gadget
//      digits, the exact int32 forward Nussbaumer transform of the 4 digit
//      polynomials (|values| <= 2^14), split into int8 limbs a0 and a1, to
//      scratch limbs[t][b][c] (16 KB a sample);
//   2. MAC (a block per 64 samples and slot t): the key slot (256 x Q int8,
//      80 KB) transposed into shared memory, the samples' limbs beside it,
//      and the (64 x 256) . (256 x Q) product with int32 accumulation by
//      __dp4a; each thread holds every group of its outputs, so it
//      recombines them in registers (exact: lo = A0 + A1<<8 + A2<<16 +
//      A3<<24 and hi = B; rounded: lo alone) and writes the channels to
//      scratch chan[b][ch][o][t][k] (32 KB a sample exact, 16 KB rounded);
//   3. inverse (a block a sample): the unscaled inverse transform of each
//      channel (uint32 wraparound is the A channel's mod 2^32; the B channel
//      stays below 2^24 and is exact), the fold, c = lo + (hi >> 6) (or lo),
//      added to the accumulator.
//
// Bound: the MAC is 64 * 256 * Q int8 multiply-adds a sample (5.24 M
// exact), 1.72e11 operations at batch 2^14, 0.087 ms at the H100's dense
// int8 tensor rate; the bytes (accumulator in and out, one key row) take
// 0.082 ms.  This first design runs the MAC on the CUDA cores (__dp4a, a
// quarter of a warp instruction per multiply-add) and passes the limbs and
// the channels through device memory (about 0.8 GB at batch 2^14), so it is
// far from that bound; the tensor-core MAC (mma.sync / wgmma on s8) and
// keeping the intermediates on chip are later work.

#include "cmux_body.cuh"

namespace {

constexpr int kC = kG * 2 * kR;     // 256 MAC inputs a slot
constexpr int kTM = 64;             // samples a MAC block
constexpr int kKW = kC / 4 + 1;     // words a row in shared memory (padded)
constexpr int kQExact = 5 * kMask1 * kR;
constexpr int kQRounded = 4 * kMask1 * kR;

__device__ __forceinline__ int q_of(int n) { return (n & 31) * 32 + (n >> 5); }

// Phase 1: rotation, digits, forward transform, int8 limbs.
__global__ void __launch_bounds__(kThreads)
lanes_forward_kernel(const uint32_t* __restrict__ acc_q,
                     const int32_t* __restrict__ powers,
                     int8_t* __restrict__ limbs, int batch, uint32_t offset,
                     int log2_base) {
  __shared__ uint32_t acc_s[kMask1 * kN];
  __shared__ int32_t dig[kG * kL * kRP];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t* src_acc = acc_q + (size_t)b * kMask1 * kN;
  for (int e = tid; e < kMask1 * kN; e += kThreads) acc_s[e] = src_acc[e];
  // odd slots of the bit-reversed forward input are the zero padding
  for (int e = tid; e < kG * (kL / 2) * kR; e += kThreads) {
    const int r = e & 31;
    const int s = ((e >> 5) & 31) * 2 + 1;
    const int g = e >> 10;
    dig[(g * kL + s) * kRP + r] = 0;
  }
  const int p = powers[b] & (2 * kN - 1);
  __syncthreads();

  const int base_mask = (1 << log2_base) - 1;
  const int half = 1 << (log2_base - 1);
  for (int e = tid; e < kMask1 * kN; e += kThreads) {
    const int o = e >> 10;
    const int q = e & (kN - 1);
    const int j = q >> 5;             // slot
    const int i = q & 31;             // lane of S'
    const int c = i * 32 + j;         // coefficient index
    const int src = (c - p) & (2 * kN - 1);
    uint32_t v = acc_s[o * kN + q_of(src & (kN - 1))];
    if (src >= kN) v = 0u - v;
    const uint32_t shifted = v - acc_s[o * kN + q] + offset;
    const int s = rev6(j);
#pragma unroll
    for (int d = 0; d < kDecomp; ++d) {
      const int digit =
          (int)((shifted >> (32 - (d + 1) * log2_base)) & base_mask) - half;
      dig[((o * kDecomp + d) * kL + s) * kRP + i] = digit;
    }
  }
  __syncthreads();

  dft_l<int32_t, kG>(dig, false);     // natural frequency order

  // MAC slot p holds frequency rev6(p), as the key's slot axis does
  for (int e = tid; e < kG * kL * kR; e += kThreads) {
    const int u = e & 31;
    const int t = (e >> 5) & 63;
    const int g = e >> 11;
    const int v = dig[(g * kL + rev6(t)) * kRP + u];
    const int a0 = ((v + 128) & 255) - 128;
    const int a1 = (v - a0) >> 8;
    int8_t* dst = limbs + ((size_t)t * batch + b) * kC + g * 2 * kR;
    dst[u] = (int8_t)a0;
    dst[kR + u] = (int8_t)a1;
  }
}

// Phase 2: per slot, (samples x 256) . (256 x Q) int8, int32 sums, groups
// recombined into the channels.  Thread (qg = tid % 16, mg = tid / 16) owns
// samples mg + 16*a (a < 4) and columns qg + 16*j, j < Q/16; column
// qg + 16*(jj + 4*s) is group s of output position pos = qg + 16*jj.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
lanes_mac_kernel(const int8_t* __restrict__ limbs,
                 const int8_t* __restrict__ key,
                 uint32_t* __restrict__ chan, int batch) {
  constexpr int kNB = kQ / 16;
  constexpr bool kExact = kQ == kQExact;
  constexpr int kNCh = kExact ? 2 : 1;
  extern __shared__ uint32_t smem[];
  uint32_t* key_t = smem;                 // [q][c/4], kKW words a row
  uint32_t* lhs = smem + kQ * kKW;        // [m][c/4]
  const int t = blockIdx.y;
  const int m0 = blockIdx.x * kTM;
  const int tid = threadIdx.x;

  const int8_t* key_slot = key + (size_t)t * kC * kQ;
  for (int e = tid; e < kQ * (kC / 4); e += kThreads) {
    const int q = e % kQ;
    const int cw = e / kQ;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      word |= (uint32_t)(uint8_t)key_slot[(4 * cw + r) * kQ + q] << (8 * r);
    key_t[q * kKW + cw] = word;
  }
  for (int e = tid; e < kTM * (kC / 4); e += kThreads) {
    const int m = e / (kC / 4);
    const int cw = e % (kC / 4);
    uint32_t word = 0;
    if (m0 + m < batch)
      word = reinterpret_cast<const uint32_t*>(
          limbs + ((size_t)t * batch + m0 + m) * kC)[cw];
    lhs[m * kKW + cw] = word;
  }
  __syncthreads();

  const int qg = tid & 15;
  const int mg = tid >> 4;
  int sum[4][kNB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < kNB; ++j) sum[a][j] = 0;
#pragma unroll 2
  for (int cw = 0; cw < kC / 4; ++cw) {
    int x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = (int)lhs[(mg + 16 * a) * kKW + cw];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const int w = (int)key_t[(qg + 16 * j) * kKW + cw];
#pragma unroll
      for (int a = 0; a < 4; ++a) sum[a][j] = __dp4a(x[a], w, sum[a][j]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + mg + 16 * a;
    if (m >= batch) continue;
    uint32_t* dst = chan + (size_t)m * kNCh * kMask1 * kL * kR;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int pos = qg + 16 * jj;
      const int o = pos >> 5;
      const int k = pos & 31;
      const size_t at = ((size_t)o * kL + t) * kR + k;
      uint32_t lo;
      if (kExact) {
        lo = (uint32_t)sum[a][jj + 4] + ((uint32_t)sum[a][jj + 8] << 8) +
             ((uint32_t)sum[a][jj + 12] << 16) +
             ((uint32_t)sum[a][jj + 16] << 24);
        dst[kMask1 * kL * kR + at] = (uint32_t)sum[a][jj];
      } else {
        lo = (uint32_t)sum[a][jj] + ((uint32_t)sum[a][jj + 4] << 8) +
             ((uint32_t)sum[a][jj + 8] << 16) +
             ((uint32_t)sum[a][jj + 12] << 24);
      }
      dst[at] = lo;
    }
  }
}

// Phase 3: inverse transform of the channels, fold, normalise, accumulate.
template <bool kExact>
__global__ void __launch_bounds__(kThreads)
lanes_inverse_kernel(const uint32_t* __restrict__ acc_in,
                     uint32_t* __restrict__ acc_out,
                     const uint32_t* __restrict__ chan) {
  constexpr int kNCh = kExact ? 2 : 1;
  constexpr int kPolys = kNCh * kMask1;
  __shared__ uint32_t data[kPolys * kL * kRP];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t* src = chan + (size_t)b * kPolys * kL * kR;
  for (int e = tid; e < kPolys * kL * kR; e += kThreads)
    data[(e >> 5) * kRP + (e & 31)] = src[e];   // row (poly, slot), lane
  __syncthreads();

  dft_l<uint32_t, kPolys>(data, true);          // bit-reversed in, natural out

  const size_t row = (size_t)b * kMask1 * kN;
  for (int e = tid; e < kMask1 * kN; e += kThreads) {
    const int o = e >> 10;
    const int c = e & (kN - 1);
    const int i = c >> 5;
    const int j = c & 31;
    // C_j = P_j + Y P_{j+32}; c[i*32 + j] = C_j[i]
    const uint32_t* pj = data + (o * kL + j) * kRP;
    const uint32_t* pm = data + (o * kL + j + 32) * kRP;
    uint32_t delta = pj[i] + ((i == 0) ? (0u - pm[31]) : pm[i - 1]);
    if (kExact) {
      const uint32_t* hj = data + ((kMask1 + o) * kL + j) * kRP;
      const uint32_t* hm = data + ((kMask1 + o) * kL + j + 32) * kRP;
      const uint32_t hi = hj[i] + ((i == 0) ? (0u - hm[31]) : hm[i - 1]);
      delta += (uint32_t)((int32_t)hi >> 6);   // exact: hi is a multiple of 64
    }
    const size_t at = row + o * kN + j * 32 + i;
    acc_out[at] = acc_in[at] + delta;
  }
}

template <int kQ>
cudaError_t launch_mac(const int8_t* limbs, const int8_t* key, uint32_t* chan,
                       int batch, cudaStream_t stream) {
  const int smem = (kQ + kTM) * kKW * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      lanes_mac_kernel<kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTM - 1) / kTM, kL);
  lanes_mac_kernel<kQ><<<grid, kThreads, smem, stream>>>(limbs, key, chan,
                                                         batch);
  return cudaGetLastError();
}

}  // namespace

// limbs: kL * batch * 256 int8 of scratch; chan: batch * 2 * 2 * 64 * 32
// int32 of scratch (half of it in the rounded form).
extern "C" int lanes_step_launch(const void* acc_in, void* acc_out,
                                 const void* powers, const void* key,
                                 void* limbs, void* chan, int batch,
                                 unsigned int offset, int log2_base,
                                 int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  lanes_forward_kernel<<<batch, kThreads, 0, s>>>(
      (const uint32_t*)acc_in, (const int32_t*)powers, (int8_t*)limbs, batch,
      (uint32_t)offset, log2_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = rounded ? launch_mac<kQRounded>((const int8_t*)limbs,
                                        (const int8_t*)key, (uint32_t*)chan,
                                        batch, s)
                : launch_mac<kQExact>((const int8_t*)limbs, (const int8_t*)key,
                                      (uint32_t*)chan, batch, s);
  if (err != cudaSuccess) return (int)err;
  if (rounded)
    lanes_inverse_kernel<false><<<batch, kThreads, 0, s>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint32_t*)chan);
  else
    lanes_inverse_kernel<true><<<batch, kThreads, 0, s>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint32_t*)chan);
  return (int)cudaGetLastError();
}
