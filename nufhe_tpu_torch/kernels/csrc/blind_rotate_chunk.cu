// The chunked blind rotation (K3): `chunk` CMUX steps in one launch, the
// accumulator in shared memory across them.  Replaces the TPU kernel
// nufhe_tpu/ops/pallas/blind_rotate.py::make_blind_rotate_chunk.  The
// kernel, its design, its shared-memory budget and its bound are
// blind_rotate_body.cuh's.

#include "blind_rotate_body.cuh"

extern "C" int blind_rotate_chunk_launch(const void* acc_in, void* acc_out,
                                         const void* bara_t, const void* key,
                                         int batch, int start, int chunk,
                                         int mask1, int decomp,
                                         unsigned int offset, int log2_base,
                                         int rounded, int device, void* stream) {
  return blind_rotate_launch_any(acc_in, acc_out, bara_t, key, batch, start,
                                 chunk, mask1, decomp, offset, log2_base,
                                 rounded, device, stream);
}

// Blocks a cluster of this kernel at (mask1, decomp) (2: the pair of
// blind_rotate_body.cuh; 0: not instantiated)
extern "C" int blind_rotate_chunk_cluster(int mask1, int decomp) {
  return blind_rotate_pair_any(mask1, decomp);
}

// The clusters of this kernel that the device holds at once, into *out
// (cudaOccupancyMaxActiveClusters); returns the CUDA error code
extern "C" int blind_rotate_chunk_clusters(int mask1, int decomp,
                                           int rounded, int device,
                                           int* out) {
  return blind_rotate_clusters_any(mask1, decomp, rounded, device, out);
}
