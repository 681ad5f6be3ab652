// Cholesky factor of 64x64 SPD tiles, for Hopper (sm_90a): the factor-only
// form of chol_inv_tile.cu.
//
// Replaces the Pallas TPU kernel cmpc_tpu/ops/batched_chol.py:
// _chol_tile_pallas.  For each tile A:
//   L = chol(A)  — 64-step right-looking elimination, pivot
//                  sqrt(max(a_jj, 1e-30)), NaN passed on, exactly as the
//                  Pallas kernel.
// L is written whole, with exact zeros above the diagonal, at the row and
// tile strides the caller gives.  The elimination is the one function of
// chol_tile_common.cuh that chol_inv_tile.cu runs too, so both kernels
// give the same L bit for bit by construction; chip_smoke.py holds that
// with torch.equal.
//
// What bounds it: the dependent chain of one tile — per elimination step
// a division, a multiply-add, a square root, one pass through shared
// memory and a barrier, 64 times over (~200 cycles a step) — not the
// 32 KB a tile moves nor its ~0.09 MFLOP; from about a thousand tiles on,
// the SMs' instruction throughput.  The design (chol_tile_common.cuh, which
// holds the kernel) keeps the tile in registers, one row per thread and
// two warps per tile, in a moving register window so that the step loop
// stays rolled, and passes one column per step through shared memory
// behind a single barrier of the two warps (of one warp, __syncwarp(),
// once rows 0..31 are complete).  wgmma and the tensor cores are not used
// (rank-1 updates in full f32; see the header).
//
// One CTA of 64 threads per tile, 16,640 bytes of dynamic shared memory in
// f32 (33,280 in f64; no opt-in needed).  nvcc -Xptxas -v (CUDA 12.9,
// sm_90a): f32 141 registers, f64 244 registers, 0 bytes stack, 0 bytes
// spilled in both.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() of its launch.

#include "chol_tile_common.cuh"

extern "C" int chol_tile_f32(const void* A, long long lda, long long sa,
                             void* L, long long ldl, long long sl,
                             int tiles, void* stream) {
  return chol_tile::launch<float, false>(A, lda, sa, L, ldl, sl, nullptr, 0,
                                         0, tiles, stream);
}

extern "C" int chol_tile_f64(const void* A, long long lda, long long sa,
                             void* L, long long ldl, long long sl,
                             int tiles, void* stream) {
  return chol_tile::launch<double, false>(A, lda, sa, L, ldl, sl, nullptr,
                                          0, 0, tiles, stream);
}
