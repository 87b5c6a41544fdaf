// The in-loop stage stand-ins of the chunked rotation (K6): K3 (the chunked
// rotation, blind_rotate_body.cuh) with one stage of every step swapped
// for a cheap, shape-correct, deterministic stand-in, so that the full
// rotation's time minus a variant's is that stage's cost inside the chunk
// loop, where the stages overlap as they do on the main path.  Replaces the
// TPU kernel tools/exp_round4.py::context (its `make`, a 100-step
// fori_loop of one pallas_call a step, each variant swapping one stage of
// ops/rows_engine's step for a stand-in).
//
// The variant is the last template argument of blind_rotate_kernel
// (Variant in blind_rotate_body.cuh), whose default is K3: so variant 0,
// "FULL", is K3's own instantiation, and a stand-in compiles to K3's code
// with one stage replaced.  At (mask1, l) = (2, 2), both key forms:
//
//   0 "FULL"          the CMUX steps (K3)
//   1 "noop step"     acc + 1 a step
//   2 "dot only"      the MAC alone: its limbs the low two bytes of acc's
//                     words (block j of polynomial o of digit g = o*l + d
//                     in slots j and j + 32), its channels folded into acc
//   3 "no rotation"   the digits of acc itself (no (X^p - 1))
//   4 "no forward"    digit block j in slots j and j + 32, no DIT
//   5 "no lhs-split"  the limbs (int8) x and (int8) (x >> 8), not balanced
//   6 "no pack"       every digit (v & (base - 1)) - base/2 (no gadget
//                     decomposition; "pack" is the TPU's name for it)
//   7 "no inverse"    the channels folded into acc (slot p' + slot p' + 32
//                     of lo, and of hi exact, at q-layout p'*32 + k)
//   8 "no key split"  the copy of the key's int8 rows into shared memory,
//                     done once: each warp's rows of its first slot at the
//                     launch's first step serve every slot p (the rows of
//                     slot p % 16) and step; FULL less it is the copy's
//                     cost in the loop
//
// Layout: K3's (acc (B, 2, 1024) int32, bara_t (n, B) int32, key the int8
// limb rows of the launch's steps, (chunk, 64, 4, 2, 6, 64) exact or
// (chunk, 64, 4, 2, 4, 64) rounded, ops/key_rows.py); ops/step_context's
// step_context_plain states every variant in ops/flat_engine's stages.
// Shared memory, block shape and occupancy are K3's.
//
// Bound: as K3, the MAC's int8 multiply-adds, 0.0868 ms a step at batch
// 2^14 exact (100 steps: 8.68 ms); the stand-ins that drop the MAC's work
// are bound by the accumulator's bytes and the key rows.

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
      launch_variant<kRounded, kAsIs>, launch_variant<kRounded, kNoopStep>,
      launch_variant<kRounded, kDotOnly>,
      launch_variant<kRounded, kNoRotation>,
      launch_variant<kRounded, kNoForward>,
      launch_variant<kRounded, kNoLimbSplit>,
      launch_variant<kRounded, kNoDecomp>,
      launch_variant<kRounded, kNoInverse>,
      launch_variant<kRounded, kNoKeySplit>};
  return fns[variant](acc_in, acc_out, bara_t, key, batch, start, chunk,
                      offset, log2_base, stream);
}

}  // namespace

// Steps [start, start + chunk) of variant `variant` (0..8, the order above)
// on the device ordinal `device`; returns the CUDA error code
// (cudaErrorInvalidValue for another variant).
extern "C" int step_context_launch(const void* acc_in, void* acc_out,
                                   const void* bara_t, const void* key,
                                   int batch, int start, int chunk,
                                   int variant, unsigned int offset,
                                   int log2_base, int rounded, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if (variant < 0 || variant > kNoKeySplit) return (int)cudaErrorInvalidValue;
  return rounded ? launch_form<true>(acc_in, acc_out, bara_t, key, batch,
                                     start, chunk, variant, offset, log2_base,
                                     stream)
                 : launch_form<false>(acc_in, acc_out, bara_t, key, batch,
                                      start, chunk, variant, offset,
                                      log2_base, stream);
}
