// One CMUX step of the blind rotation (K1), for Hopper, in both engine
// modes: the exact ('NTT') key and the two-sided rounded ('FFT') key.
//
//   acc' = acc + sum_{g=(o_in,d)} decomp_d((X^p - 1) * acc[o_in]) (*) BK[g, o_out]
//
// Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_external_step_rows (the
// per-step launch over ops/rows_engine.external_step); the output is the
// same function, bit for bit, for either key form.
//
// Layout:
//   acc    (B, Mask1, 1024) int32, batch-major, contiguous
//   p      (B,) int32 in [0, 2048)
//   key    the int8 limb rows of one step (ops/key_rows.py): (64, G, Mask1,
//          6, 64) exact, (64, G, Mask1, 4, 64) rounded
//   out    (B, Mask1, 1024) int32
//
// Design: the chunked rotation's kernel (blind_rotate_body.cuh) with a
// chunk of one step that reads one step's key rows: the powers are its one
// row of rotation amounts.  So K1 runs K3's step, with its MAC on the int8
// tensor cores, and the two cannot drift apart; the accumulator goes
// through device memory once a step.
//
// Bound: the MAC's int8 multiply-adds, 64 * 64G * Q a sample (5.24 M exact
// at (2, 2)), 0.087 ms at batch 2^14 at the dense int8 rate of 1979e12/s;
// the bytes (accumulator in and out, the powers and the key rows, 196 KB
// exact) take 0.040 ms.

#include "blind_rotate_body.cuh"

extern "C" int cmux_step_launch(const void* acc_in, void* acc_out,
                                const void* powers, const void* key,
                                int batch, int mask1, int decomp,
                                unsigned int offset, int log2_base,
                                int rounded, int device, void* stream) {
  return blind_rotate_launch_any(acc_in, acc_out, powers, key, batch, 0, 1,
                                 mask1, decomp, offset, log2_base, rounded,
                                 device, stream);
}

// Blocks a cluster of this kernel at (mask1, decomp) (2: the pair of
// blind_rotate_body.cuh; 0: not instantiated)
extern "C" int cmux_step_cluster(int mask1, int decomp) {
  return blind_rotate_pair_any(mask1, decomp);
}
