// Cholesky factor of 64x64 SPD tiles, for Hopper (sm_90a): the factor-only
// form of chol_inv_tile.cu.
//
// Replaces the Pallas TPU kernel cmpc_tpu/ops/batched_chol.py:
// _chol_tile_pallas.  For each tile A (row-major, contiguous):
//   L = chol(A)  — 64-step right-looking elimination, pivot
//                  sqrt(max(a_jj, 1e-30)), NaN passed on, exactly as the
//                  Pallas kernel.
// L is written whole, with exact zeros above the diagonal (the caller
// allocates it with torch.empty).  The elimination loop is, statement for
// statement, the one of chol_inv_tile.cu, so both kernels give the same L
// bit for bit; chip_smoke.py holds that with torch.equal.
//
// What bounds it: a tile moves 32 KB to or from device memory (A in, L
// out, f32) and does ~0.09 MFLOP, spread over 64 dependent elimination
// steps with two block barriers each — it is latency-bound, not bandwidth-
// or FLOP-bound.  The tile stays in shared memory (rows padded to 65
// elements, so column walks hit distinct banks).  Without the inverse the
// CTA needs one padded tile plus the pivots, 16.9 KB in f32 and 33.8 KB in
// f64 — half of the fused kernel's, and under the 48 KB default in both
// types — so twice as many CTAs share an SM.  One CTA of 256 threads per
// tile; wgmma/TMA are not used.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 64;
constexpr int LD = NB + 1;        // padded row stride in shared memory
constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T dsqrt(T x);
template <>
__device__ __forceinline__ float dsqrt<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double dsqrt<double>(double x) { return sqrt(x); }

// max(x, lo) that propagates NaN like jnp.maximum / torch.clamp_min
// (fmax would drop it)
template <typename T>
__device__ __forceinline__ T nan_max(T x, T lo) {
  return (x != x) ? x : (x > lo ? x : lo);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chol_tile_kernel(const T* __restrict__ A, T* __restrict__ Lout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);   // factor, in place (NB x LD)
  T* diag = S + NB * LD;                   // pivots d_j (NB)

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * NB * NB;
  const T* a = A + base;

  // coalesced load of the tile
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    S[r * LD + c] = a[e];
  }
  __syncthreads();

  // column j of S becomes L's column j (below the diagonal); the pivot
  // goes to diag[j] so S[j][j] is never rewritten while other threads may
  // still read it in the same step.
  const int col = tid % NB;          // trailing-update column of this thread
  const int rgrp = tid / NB;         // row group 0..3
  for (int j = 0; j < NB; ++j) {
    const T d = dsqrt<T>(nan_max(S[j * LD + j], T(1e-30)));
    if (tid == 0) diag[j] = d;
    for (int i = j + 1 + tid; i < NB; i += THREADS) S[i * LD + j] /= d;
    __syncthreads();
    // rank-1 update of the trailing lower triangle: S[i][k] -= l_i l_k
    const int k = col;
    if (k > j) {
      const T lk = S[k * LD + j];
      for (int i = j + 1 + rgrp; i < NB; i += THREADS / NB) {
        if (k <= i) S[i * LD + k] -= S[i * LD + j] * lk;
      }
    }
    __syncthreads();
  }

  // write the tile whole, exact zeros above the diagonal
  T* lo = Lout + base;
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    lo[e] = (c < r) ? S[r * LD + c] : ((c == r) ? diag[r] : T(0));
  }
}

template <typename T>
int launch(const void* A, void* L, int tiles, void* stream) {
  if (tiles <= 0) return 0;
  const size_t smem = (NB * LD + NB) * sizeof(T);
  chol_tile_kernel<T><<<tiles, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chol_tile_f32(const void* A, void* L, int tiles,
                             void* stream) {
  return launch<float>(A, L, tiles, stream);
}

extern "C" int chol_tile_f64(const void* A, void* L, int tiles,
                             void* stream) {
  return launch<double>(A, L, tiles, stream);
}
