// The exact CMUX step in the split-halves schedule (K8), for Hopper: the
// forward transform of one half of the digit polynomials overlapped with
// the MAC of the other, in disjoint warp groups on a named barrier.
// Replaces the TPU kernel tools/exp_overlap.py::make (its `mac_split`
// body: forward of digit half A -> its dot; forward of half B -> its dot;
// the inverse of A + B), which that tool asserts bit-equal to the serial
// step (`mac_serial`, ops/rows_engine.external_step); the serial schedule
// on the card is K1 itself (cmux_step.cu).
//
// The schedule is the last template argument of blind_rotate_kernel
// (Variant kSplitHalves, split_halves in blind_rotate_body.cuh), K1's
// kernel at a chunk of one step, (mask1, l) = (2, 2), exact key: warps 0-7
// run the rotation, digits, forward and limb split of g in {0, 1} of their
// sample, arrive at barrier 1 and go on to g in {2, 3}; warps 8-15 wait at
// barrier 1, then run the MAC of g in {0, 1} meanwhile; then all 16 warps
// the MAC of g in {2, 3}, adding into the lo channel (mod 2^32) and the hi
// channel (an exact int32 sum of the same terms, so the bound of
// blind_rotate_body.cuh holds); then K1's inverse.  The output equals K1's
// bit for bit.  Between the two MACs the hi channel of half the (sample,
// o) pairs waits in 32 KB of its own, and a warp keeps the key rows of two
// digit polynomials (24 KB for the block): 216 KB a block, 4 samples, 16
// warps, one block an SM.
//
// Layout: K1's exact form (acc (B, 2, 1024) int32, p (B,) int32, key_row
// the int8 limb rows (64, 4, 2, 6, 64) of one step, ops/key_rows.py, out
// (B, 2, 1024) int32).
//
// Bound: as K1, the MAC's int8 multiply-adds, 0.0868 ms at batch 2^14.

#include "blind_rotate_body.cuh"

extern "C" int step_overlap_launch(const void* acc_in, void* acc_out,
                                   const void* powers, const void* key_row,
                                   int batch, unsigned int offset,
                                   int log2_base, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  return (int)launch<2, 2, false, kFull, kSplitHalves>(
      (const int32_t*)acc_in, (int32_t*)acc_out, (const int32_t*)powers,
      (const int8_t*)key_row, batch, 0, 1, offset, log2_base,
      (cudaStream_t)stream);
}
