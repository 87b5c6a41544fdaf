// The step schedules (K10): one CMUX step (K1, the chunked rotation's
// kernel at a chunk of one step, blind_rotate_body.cuh) in seven
// schedules.  Replaces the TPU kernel tools/exp_round3.py::run (its `make`,
// one pallas_call of one step a variant, each asserted bit-equal to the
// first).  The schedule is the last template argument of
// blind_rotate_kernel (Variant), at (mask1, l) = (2, 2), both key forms;
// every schedule is bit-equal to K1:
//
//   0 "v0"   the digits stored as int32 in the limbs' place, a pass into
//            padded int16 rows, the forward transform as one pass a stage
//            over the block's 16 digit polynomials (staged_forward), a limb
//            split pass (the TPU's v0: digits materialised, staged
//            transforms)
//   1 "v1"   K1's fused rotation and digits stored straight into the
//            padded rows, then v0's staged forward (the TPU's v1: fused
//            decomposition, staged transforms)
//   2 "v2"   K1's forward; the MAC leaves its groups partly combined, a
//            pass combines them before the inverse, and after it a pass
//            sums the channels into the accumulator (the TPU's v2: combine
//            and normalisation unfused)
//   3 "v3"   K1 itself
//   4 "p2"   a software pipeline over two sub-batches of the block's four
//            samples: warps 0-7 run front(0), front(1), then back(0) and
//            back(1); warps 8-15 MAC(0) beside front(1) and MAC(1) beside
//            back(0), on named barriers (sample_pipeline)
//   5 "p2b"  p2 with both MACs before either back: every warp runs K1's
//            inverse after MAC(1)
//   6 "p4"   p2 over four sub-batches of one sample (warps 0-3 front and
//            back, warps 4-15 the MAC)
//
// The pipelines split the samples, not the digit polynomials (K8's split
// of the digit halves was 23% slower than K1): a sub-batch's MAC fills
// 2kS/kQ of the mma's 8 columns (both digit limbs of its samples) and
// copies every slot's key rows again, which is what their reading prices.
//
// Layout: K1's (acc (B, 2, 1024) int32, p (B,) int32, key_row the int8
// limb rows of one step, (64, 4, 2, 6, 64) exact or (64, 4, 2, 4, 64)
// rounded (ops/key_rows.py), out (B, 2, 1024) int32).
// Shared memory and block shape are K1's (208 KB exact, 192 KB rounded,
// 512 threads, one block an SM): the staged passes use the lo channel's
// and the limbs' places, the pipelines keep each sample's hi channel over
// its own limbs.
//
// Bound: as K1, the MAC's int8 multiply-adds, 0.0868 ms at batch 2^14
// exact (0.0217 ms at the JAX script's 4096).

#include "blind_rotate_body.cuh"

namespace {

template <bool kRounded, int V>
int launch_schedule(const void* acc_in, void* acc_out, const void* powers,
                    const void* key_row, int batch, unsigned int offset,
                    int log2_base, void* stream) {
  return (int)launch<2, 2, kRounded, kFull, V>(
      (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)powers,
      (const int8_t*)key_row, batch, 0, 1, offset, log2_base,
      (cudaStream_t)stream);
}

template <bool kRounded>
int launch_form(const void* acc_in, void* acc_out, const void* powers,
                const void* key_row, int batch, int schedule,
                unsigned int offset, int log2_base, void* stream) {
  int (*const fns[])(const void*, void*, const void*, const void*, int,
                     unsigned int, int, void*) = {
      launch_schedule<kRounded, kDigitsStaged>,
      launch_schedule<kRounded, kStagedForward>,
      launch_schedule<kRounded, kUnfusedCombine>,
      launch_schedule<kRounded, kAsIs>,
      launch_schedule<kRounded, kPipe2>,
      launch_schedule<kRounded, kPipe2Dots>,
      launch_schedule<kRounded, kPipe4>};
  return fns[schedule](acc_in, acc_out, powers, key_row, batch, offset,
                       log2_base, stream);
}

}  // namespace

// Schedule `schedule` (0..6, the order above) on the device ordinal
// `device`; returns the CUDA error code (cudaErrorInvalidValue for another
// schedule).
extern "C" int step_schedules_launch(const void* acc_in, void* acc_out,
                                     const void* powers, const void* key_row,
                                     int batch, int schedule,
                                     unsigned int offset, int log2_base,
                                     int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if (schedule < 0 || schedule > 6) return (int)cudaErrorInvalidValue;
  return rounded ? launch_form<true>(acc_in, acc_out, powers, key_row, batch,
                                     schedule, offset, log2_base, stream)
                 : launch_form<false>(acc_in, acc_out, powers, key_row, batch,
                                      schedule, offset, log2_base, stream);
}
