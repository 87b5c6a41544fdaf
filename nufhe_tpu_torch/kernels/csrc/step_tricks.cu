// The step tricks (K11): the chunked rotation (K3, blind_rotate_body.cuh)
// with one stage of every step in another form, `chunk` steps a launch
// (100 in tools/exp_round4_torch.py tricks).  Replaces the TPU kernel
// tools/exp_round4.py::tricks (its `make_with_bara`, a 100-step fori_loop
// of one pallas_call a step, each variant asserted bit-equal to the
// engine's step).  The variant is the last template argument of
// blind_rotate_kernel (Variant), at (mask1, l) = (2, 2), both key forms.
// Each is the card's form of the TPU's trick; where K3 already does the
// trick, the variant is the form without it, so that the reading prices
// it.  Every variant is bit-equal to K3 (t8 and t8+t9 on even rotation
// amounts, which the wrapper makes):
//
//   0 "t10"    K3's twiddles are already one shuffle by a constant amount
//              and a sign select (the TPU's t10 turned its roll-roll-select
//              into one slice-concat); t10 here is the form without it:
//              every twiddle and the fold's Y as two shuffles (shfl_up,
//              shfl_down) and a select (rot_y kTwTwoRoll)
//   1 "t9"     K3 adds the inverse's output into the accumulator as it
//              emits it (the TPU's t9); t9 here is the form without it:
//              the folded channels go back to shared memory and a pass of
//              its own adds them (add_pass)
//   2 "t8+t9"  t8's rotation and t9's add pass
//   3 "t8"     the barrel of K12's t14 without round 0 (p even: the coarse
//              modulus switch's amounts)
//   4 "t6"     the forward transform as one pass a stage over every digit
//              polynomial of the block in shared memory, against K3's
//              per-warp register DIT (staged_forward, K10's v1)
//   5 "t7"     the inverse as one pass a stage over every channel
//              polynomial, the fold a pass, the add a pass (staged_inverse)
//   6 "t5"     the deferred-carry barrel: the j-rounds as plain register
//              rolls (t12's branch, without the carry), one Y-fix of the
//              registers j < p mod 32, i-rounds as K12's t11, the bit-10
//              sign folded into the -1 (barrel_rotate kRotDeferred)
//
// Layout: K3's (acc (B, 2, 1024) int32, bara_t (n, B) int32, key the int8
// limb rows of the launch's steps, (chunk, 64, 4, 2, 6, 64) exact or
// (chunk, 64, 4, 2, 4, 64) rounded, ops/key_rows.py).  Shared memory,
// block shape and occupancy are K3's: the barrels' scratch (1 KB a digit
// warp) and the staged passes use the lo channel's and the limbs' places.
//
// Bound: as K3, the MAC's int8 multiply-adds, 0.0868 ms a step at batch
// 2^14 exact (100 steps: 8.68 ms).

#include "blind_rotate_body.cuh"

namespace {

template <bool kRounded, int V>
int launch_variant(const void* acc_in, void* acc_out, const void* bara_t,
                   const void* key, int batch, int start, int chunk,
                   unsigned int offset, int log2_base, void* stream) {
  return (int)launch<2, 2, kRounded, kFull, V>(
      (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)bara_t,
      (const int8_t*)key, batch, start, chunk, offset, log2_base,
      (cudaStream_t)stream);
}

template <bool kRounded>
int launch_form(const void* acc_in, void* acc_out, const void* bara_t,
                const void* key, int batch, int start, int chunk, int variant,
                unsigned int offset, int log2_base, void* stream) {
  int (*const fns[])(const void*, void*, const void*, const void*, int, int,
                     int, unsigned int, int, void*) = {
      launch_variant<kRounded, kTwoRollTwiddle>,
      launch_variant<kRounded, kSeparateAdd>,
      launch_variant<kRounded, kEvenBarrelSepAdd>,
      launch_variant<kRounded, kEvenBarrel>,
      launch_variant<kRounded, kStagedForward>,
      launch_variant<kRounded, kStagedInverse>,
      launch_variant<kRounded, kDeferredCarry>};
  return fns[variant](acc_in, acc_out, bara_t, key, batch, start, chunk,
                      offset, log2_base, stream);
}

}  // namespace

// Steps [start, start + chunk) of variant `variant` (0..6, the order above)
// on the device ordinal `device`; returns the CUDA error code
// (cudaErrorInvalidValue for another variant).
extern "C" int step_tricks_launch(const void* acc_in, void* acc_out,
                                  const void* bara_t, const void* key,
                                  int batch, int start, int chunk,
                                  int variant, unsigned int offset,
                                  int log2_base, int rounded, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if (variant < 0 || variant > 6) return (int)cudaErrorInvalidValue;
  return rounded ? launch_form<true>(acc_in, acc_out, bara_t, key, batch,
                                     start, chunk, variant, offset, log2_base,
                                     stream)
                 : launch_form<false>(acc_in, acc_out, bara_t, key, batch,
                                      start, chunk, variant, offset,
                                      log2_base, stream);
}
