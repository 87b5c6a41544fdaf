// The rotation forms (K12): the chunked rotation (K3, blind_rotate_body.cuh)
// with its rotation (X^p - 1) * acc in another form, `chunk` steps a launch
// (100 in tools/exp_round5_torch.py).  Replaces the TPU kernel
// tools/exp_round5.py::main (its `make`, a 100-step fori_loop of one
// pallas_call a step, each rotate_acc variant asserted bit-equal to the
// baseline).  K3 gathers each rotated coefficient in one load from shared
// memory (rotated_coeff); these run the TPU's barrel
// (ops/rows_engine.rotate_acc: five j-rounds with the Y-carry, five
// i-rounds, the bit-10 negate, each round selected by its bit) on a digit
// warp's registers (barrel_rotate, rotate_common.cuh), so the reading
// prices the barrel against the gather.  The form is the last template
// argument of blind_rotate_kernel (Variant), at (mask1, l) = (2, 2), both
// key forms; each is bit-equal to K3:
//
//   0 "t11"  every round stores the registers to the warp's scratch and
//            loads the whole rotated copy back, then selects
//   1 "t12"  j-rounds in registers: only the k wrapped registers move (one
//            shuffle each, the Y-carry), the others are renamed, under a
//            branch on the round's bit (uniform across the warp; each
//            round a template instance, so every register index is a
//            constant); i-rounds as t11
//   2 "t13"  j-rounds as t11; each i-round's select fused into the
//            exchange: one load from the scratch at the lane the bit picks
//   3 "t14"  t12's j-rounds and t13's i-rounds
//
// Layout: K3's.  Shared memory, block shape and occupancy are K3's: a
// digit warp's scratch is 1 KB of the lo channel's place, free while the
// digits are made.
//
// Bound: as K3, 0.0868 ms a step at batch 2^14 exact (100 steps: 8.68 ms).

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
                const void* key, int batch, int start, int chunk, int form,
                unsigned int offset, int log2_base, void* stream) {
  int (*const fns[])(const void*, void*, const void*, const void*, int, int,
                     int, unsigned int, int, void*) = {
      launch_variant<kRounded, kBarrelWhole>,
      launch_variant<kRounded, kBarrelSliced>,
      launch_variant<kRounded, kBarrelFusedI>,
      launch_variant<kRounded, kBarrelBoth>};
  return fns[form](acc_in, acc_out, bara_t, key, batch, start, chunk, offset,
                   log2_base, stream);
}

}  // namespace

// Steps [start, start + chunk) with rotation form `form` (0..3, the order
// above) on the device ordinal `device`; returns the CUDA error code
// (cudaErrorInvalidValue for another form).
extern "C" int rotate_forms_launch(const void* acc_in, void* acc_out,
                                   const void* bara_t, const void* key,
                                   int batch, int start, int chunk, int form,
                                   unsigned int offset, int log2_base,
                                   int rounded, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if (form < 0 || form > 3) return (int)cudaErrorInvalidValue;
  return rounded ? launch_form<true>(acc_in, acc_out, bara_t, key, batch,
                                     start, chunk, form, offset, log2_base,
                                     stream)
                 : launch_form<false>(acc_in, acc_out, bara_t, key, batch,
                                      start, chunk, form, offset, log2_base,
                                      stream);
}
