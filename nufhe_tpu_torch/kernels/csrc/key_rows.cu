// The key limb rows of the blind rotation (the row kernel): every step's
// int8 Toeplitz rows of the MAC's A operand, prepared once with the key
// (keys.BootstrapKey.device), which K1 and K3 (blind_rotate_body.cuh) copy
// into shared memory instead of splitting the int64 key again in every
// block and step.  Replaces no TPU kernel: the TPU's MAC reads the int8
// operand that ops/transform.build_mac_rhs prepares with the key.
//
// Layout:
//   key   the transformed key (ops/transform.py): (n, G, Mask1, 64, 32)
//         int64 exact, (n, 2, G, Mask1, 64, 32) rounded; residues mod
//         2^38, any representative
//   rows  (n, 64, G, Mask1, kRows, 64) int8, kRows = 6 exact, 4 rounded:
//         per step and MAC slot p (frequency rev6(p)) the rows (g, o, L),
//         slot-major; byte 31 - r of a row is limb L of side 0 at rotation
//         r, byte 63 - r that of side 1 (the two-sided limbs of
//         ops/transform.key_limbs_host: side 1 from -v mod 2^38 exact, the
//         stored side 1 rounded)
//
// Design: a warp a (step, slot, g * Mask1 + o); lane r loads the residue
// at rotation r (both stored sides rounded) and splits it with 32-bit
// arithmetic on any representative mod 2^38 (split_exact, split_rounded:
// no centring, the 4 balanced radix-2^8 digits of a word at once); each
// limb row is 32 bytes a side from the warp's lanes, one coalesced store
// a side.
//
// Bound: the bytes, once a key: 8 read and 12 written a residue exact (16
// read and 8 written rounded); at n = 500 and (Mask1, l) = (2, 2) 65.5 MB
// read and 98.3 MB written exact, 0.049 ms at 3.35 TB/s.

#include "rotate_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <bool kRounded>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
key_rows_kernel(const long long* __restrict__ key, int8_t* __restrict__ rows,
                int steps, int gm) {
  constexpr int kRows = kRounded ? 4 : 6;
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)steps * kL * gm) return;
  const int go = (int)(w % gm);
  const int p = (int)((w / gm) % kL);
  const long long s = w / ((long long)gm * kL);
  const int side = gm * kL * kR;          // values in one stored side
  const size_t idx = ((size_t)(s * (kRounded ? 2 : 1)) * gm + go) * kL * kR +
                     (size_t)rev6(p) * kR + lane;
  uint32_t l0[kRows], l1[kRows];
  if constexpr (kRounded) {
    split_rounded(__ldg(key + idx), l0);
    split_rounded(__ldg(key + idx + side), l1);
  } else {
    const long long v = __ldg(key + idx);
    split_exact(v, l0);
    split_exact(-v, l1);      // side 1: -v mod 2^38
  }
  int8_t* row = rows + ((size_t)(s * kL + p) * gm + go) * kRows * 64;
#pragma unroll
  for (int L = 0; L < kRows; ++L) {
    row[L * 64 + 31 - lane] = (int8_t)l0[L];
    row[L * 64 + 63 - lane] = (int8_t)l1[L];
  }
}

template <bool kRounded>
cudaError_t launch(const long long* key, int8_t* rows, int steps, int gm,
                   cudaStream_t stream) {
  const long long warps = (long long)steps * kL * gm;
  const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  key_rows_kernel<kRounded><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      key, rows, steps, gm);
  return cudaGetLastError();
}

}  // namespace

// The rows of `steps` key steps of gm = G * Mask1 (g, o) pairs each, on the
// device ordinal `device`; returns the CUDA error code.
extern "C" int key_rows_launch(const void* key, void* rows, int steps, int gm,
                               int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (steps <= 0) return (int)cudaGetLastError();
  const auto* k = (const long long*)key;
  auto* r = (int8_t*)rows;
  const auto s = (cudaStream_t)stream;
  err = rounded ? launch<true>(k, r, steps, gm, s)
                : launch<false>(k, r, steps, gm, s);
  return (int)err;
}
