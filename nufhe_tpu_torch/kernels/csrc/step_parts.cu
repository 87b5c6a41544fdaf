// The stage parts of one exact CMUX step (K5): the rows-layout step of K1
// and K3 (blind_rotate_body.cuh), at a chunk of one step, cut after a
// stage, so that each stage of the card's step can be timed on its own.
// Replaces the TPU kernel tools/microbench.py::bench_parts (its `make`,
// one pallas_call a part over ops/rows_engine's stage functions).
//
// The part is the last template argument of blind_rotate_kernel
// (blind_rotate_body.cuh), whose default, the whole step, is K1 and K3: so
// a part compiles to the kernel's own code up to its stage and nothing
// else, and K5's "FULL step" is K1.  Exact engine at the default shape
// (mask1, l) = (2, 2) only, as bench_parts is.  Each part writes an output
// that depends on all the work it does:
//
//   0 "rotate"           (X^p - 1) * acc                    (B, 2, 1024)
//   1 "rot+decomp"       its signed gadget digits, g = o*l+d (B, 4, 1024)
//   2 "dec+fwd"          the digits of acc (no rotation), the forward
//                        transform, folded                  (B, 2, 1024)
//   3 "dec+fwd+key"      2 with the limb split, then each slot's key
//                        rows copied in (the MAC's A operand) and read
//                        once instead of the MAC, folded
//   4 "dec+fwd+mac"      2 with the limb split and the MAC: both channels
//                        before the inverse, folded
//   5 "inverse only"     the inverse, fold and normalisation of a stand-in
//                        channel (acc, twice over the slots) added to acc
//   6 "dec+fwd+mac+inv"  the product of acc's digits with the key row
//                        (ops/rows_engine.transformed_mac), no rotation
//   7 "FULL step"        acc + key row (x) decomp((X^p - 1) acc): K1
//
// The folds keep the card's slot order (slot p holds frequency rev6(p),
// ops/flat_engine's order): a transform-domain polynomial of 64 slots x 32
// lanes is folded to 1024 words, slot p' < 32 plus slot p' + 32, at
// q-layout p'*32 + lane, and summed over what lands there (the digit
// levels d in part 2, the two channels in part 4); part 3's slot word is
// the sum of its key rows' words (lane & 15) plus the sum of the slot's
// digit limbs of the sample.  ops/step_parts.step_part_plain states every
// part in ops/flat_engine's stage functions.
//
// Layout: acc (B, 2, 1024) int32, p (B,) int32 in [0, 2048), key_row
// the int8 limb rows (64, 4, 2, 6, 64) of one step of ops/transform's
// exact key (ops/key_rows.py), out as above, coefficient order.  Shared
// memory, block shape and occupancy are K1's (208 KB, 4 samples and 16
// warps a block, one block an SM), so a part's time is the time of its
// stages inside the real step.
//
// Bound: as K1 for the full step (the MAC's int8 multiply-adds, 0.087 ms
// at batch 2^14); a part's own bound is its bytes (acc in, its output out,
// the key rows) and, from part 4 on, the MAC's operations.

#include "blind_rotate_body.cuh"

namespace {

template <int P>
int launch_part(const void* acc_in, void* out, const void* powers,
                const void* key_row, int batch, unsigned int offset,
                int log2_base, void* stream) {
  return (int)launch<2, 2, false, P>(
      (const int32_t*)acc_in, (int32_t*)out, (const int32_t*)powers,
      (const int8_t*)key_row, batch, 0, 1, offset, log2_base,
      (cudaStream_t)stream);
}

}  // namespace

// Part `part` (0..7, the order above) on the device ordinal `device`;
// returns the CUDA error code (cudaErrorInvalidValue for another part).
extern "C" int step_parts_launch(const void* acc_in, void* out,
                                 const void* powers, const void* key_row,
                                 int batch, int part, unsigned int offset,
                                 int log2_base, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  int (*const fns[])(const void*, void*, const void*, const void*, int,
                     unsigned int, int, void*) = {
      launch_part<kRotate>, launch_part<kRotDecomp>, launch_part<kDecFwd>,
      launch_part<kDecFwdKey>, launch_part<kDecFwdMac>,
      launch_part<kInvOnly>, launch_part<kDecFwdMacInv>, launch_part<kFull>};
  if (part < 0 || part > kFull) return (int)cudaErrorInvalidValue;
  return fns[part](acc_in, out, powers, key_row, batch, offset, log2_base,
                   stream);
}
