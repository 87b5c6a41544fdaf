// The rotation-family profile of one CMUX step (K9): the rows-layout step of
// K1 and K3 (blind_rotate_body.cuh), at a chunk of one step, cut after a
// stage, the rotation split by the bits of its amount.  Replaces the TPU
// kernel tools/exp_round4.py::profile (its `make`, one pallas_call a
// cumulative prefix of ops/rows_engine's step, the rotation's barrel
// rounds split into families).
//
// The part is the last-but-one template argument of blind_rotate_kernel
// (Part in blind_rotate_body.cuh), as for K5 (step_parts.cu), at (mask1,
// l) = (2, 2) in both key forms, as `profile` reads the engine mode.  The
// ten prefixes keep the JAX names; each writes an output that depends on
// all the work it does:
//
//   0 "noop (1 pass)"        acc + 1                            (B, 2, 1024)
//   1 "rot j-rolls b0-4"     X^(p & 0x1F) * acc (no -1)         (B, 2, 1024)
//   2 "rot Y-rolls 1/2/4"    X^(p & 0xE0) * acc
//   3 "rot Y-rolls 8/16"     X^(p & 0x300) * acc
//   4 "rotation (full)"      (X^p - 1) * acc (K5 "rotate")
//   5 "+decomp_pack2"        its signed gadget digits (K5 "rot+decomp")
//                                                               (B, 4, 1024)
//   6 "+forward (fold glue)" K5's "dec+fwd" on the rotation's digits
//   7 "+lhs (sum glue 8x)"   K5's "dec+fwd+key" on them: the limb split and
//                            the copy of the key's int8 rows (the card's
//                            MAC operands)
//   8 "+mac dot (sum glue)"  K5's "dec+fwd+mac" on them (rounded key: the lo
//                            channel only)
//   9 "FULL step"            the CMUX step (K1)
//
// Parts 1-3 cost the same on the card: rotated_coeff reads any rotation in
// one gather, where the TPU's barrel runs a round a bit.  The folds are
// K5's (step_parts.cu).  Layout: K1's, both forms; shared memory, block
// shape and occupancy are K1's.
//
// Bound: a part's bytes (acc in, its output out, the powers where it
// rotates, the key rows where it reads them) and, for 8 and 9, the MAC's int8
// operations (0.0868 ms exact, 0.0694 rounded, at batch 2^14).

#include "blind_rotate_body.cuh"

namespace {

template <bool kRounded, int P>
int launch_part(const void* acc_in, void* out, const void* powers,
                const void* key_row, int batch, unsigned int offset,
                int log2_base, void* stream) {
  return (int)launch<2, 2, kRounded, P>(
      (const int32_t*)acc_in, (int32_t*)out, (const int32_t*)powers,
      (const int8_t*)key_row, batch, 0, 1, offset, log2_base,
      (cudaStream_t)stream);
}

template <bool kRounded>
int launch_form(const void* acc_in, void* out, const void* powers,
                const void* key_row, int batch, int part, unsigned int offset,
                int log2_base, void* stream) {
  int (*const fns[])(const void*, void*, const void*, const void*, int,
                     unsigned int, int, void*) = {
      launch_part<kRounded, kNoop>, launch_part<kRounded, kRotBits0>,
      launch_part<kRounded, kRotBits1>, launch_part<kRounded, kRotBits2>,
      launch_part<kRounded, kRotate>, launch_part<kRounded, kRotDecomp>,
      launch_part<kRounded, kRotDecFwd>,
      launch_part<kRounded, kRotDecFwdKey>,
      launch_part<kRounded, kRotDecFwdMac>, launch_part<kRounded, kFull>};
  return fns[part](acc_in, out, powers, key_row, batch, offset, log2_base,
                   stream);
}

}  // namespace

// Part `part` (0..9, the order above) on the device ordinal `device`;
// returns the CUDA error code (cudaErrorInvalidValue for another part).
extern "C" int step_profile_launch(const void* acc_in, void* out,
                                   const void* powers, const void* key_row,
                                   int batch, int part, unsigned int offset,
                                   int log2_base, int rounded, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  if (part < 0 || part > 9) return (int)cudaErrorInvalidValue;
  return rounded ? launch_form<true>(acc_in, out, powers, key_row, batch,
                                     part, offset, log2_base, stream)
                 : launch_form<false>(acc_in, out, powers, key_row, batch,
                                      part, offset, log2_base, stream);
}
