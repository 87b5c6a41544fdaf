// The inverse probes (K13): the exact dual-channel inverse alone, with its
// twiddles in five forms.  Replaces the TPU kernel
// tools/exp_inverse.py::make_kernel (one pallas_call a body: the sample's
// 2048 rows stacked four times into 8192, the DIT inverse at a t-group of
// 128 rows, the fold, normalize_dual).  The probe is the kInvProbe part of
// blind_rotate_kernel (K5's kInvOnly path: K3's inverse_fold and its hi >>
// 6 exchange, the input read from the stacked rows and the output written
// as rows), its twiddle form the Variant:
//
//   0 "base"    one rotation a set bit of each butterfly's m, as
//               make_inverse('full') composes them (kTwPerBit)
//   1 "notw"    no twiddles, the fold without Y (make_inverse('none'):
//               C_j = 2 P_j after five stages)
//   2 "align"   base with each amount rounded down to a multiple of 8
//               below its sign (make_inverse('align'))
//   3 "noroll"  the card's own probe: base with every shuffle removed and
//               each sign select kept, the fold's Y too (the TPU's noroll,
//               butterflies without partners, is 2x or 0 a stage, which
//               nvcc would fold away; here the butterflies' partners are
//               registers and cost no move, so the lane exchanges are what
//               is left out)
//   4 "sliced"  K3's own DIT: one rotation a butterfly (dit_inverse_sliced)
//
// base and sliced equal rows_engine.dit_inverse + normalize_dual bit for
// bit; notw and align are the JAX probes' functions; noroll is stated by
// ops/inverse_probe.inverse_probe_plain.
//
// Layout (the port's): in (B, 2048) int32, sample b's rows (row r = t*128 +
// ch*64 + o*32 + k of the stacked input is in[b][r mod 2048]); out (B,
// 2048) int32, c = A + (B >> 6) of fold row j of polynomial o at j*64 +
// o*32 + k.  A warp a (sample, o, channel), 4 samples and 16 warps a block
// (K3's shape).
//
// Bound: bytes, 2048 words a sample in and out: 0.080 ms at batch 2^14.

#include "blind_rotate_body.cuh"

namespace {

template <int V>
int launch_probe(const void* in, void* out, int batch, void* stream) {
  return (int)launch<2, 2, false, kInvProbe, V>(
      (const int32_t*)in, (int32_t*)out, nullptr, nullptr, batch, 0, 1, 0u,
      10, (cudaStream_t)stream);
}

}  // namespace

// Probe `probe` (0..4, the order above) on the device ordinal `device`;
// returns the CUDA error code (cudaErrorInvalidValue for another probe).
extern "C" int inverse_probe_launch(const void* in, void* out, int batch,
                                    int probe, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  int (*const fns[])(const void*, void*, int, void*) = {
      launch_probe<kProbeBase>, launch_probe<kProbeNotw>,
      launch_probe<kProbeAlign>, launch_probe<kProbeNoroll>,
      launch_probe<kAsIs>};
  if (probe < 0 || probe > 4) return (int)cudaErrorInvalidValue;
  return fns[probe](in, out, batch, stream);
}
