// Fused Cholesky factor AND inverse of 64x64 SPD tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cmpc_tpu/ops/batched_chol.py:
// _chol_inv_tile_pallas.  For each tile A (row-major, contiguous):
//   L = chol(A)  — 64-step right-looking elimination, pivot
//                  sqrt(max(a_jj, 1e-30)), exactly as the Pallas kernel;
//   X = L^-1     — forward substitution on L X = I.
// Both outputs are written whole, with exact zeros above the diagonal
// (the caller allocates them with torch.empty and reads whole tiles).
//
// What bounds it: a tile moves only 48 KB to or from device memory (A in,
// L and X out, f32), and its arithmetic (~0.2 MFLOP) is spread over 64
// dependent elimination steps with two block barriers each plus a 64-step
// substitution with warp barriers — it is latency-bound, not bandwidth- or
// FLOP-bound.  The design therefore keeps the whole tile in shared memory
// (rows padded to 65 elements, so column walks hit distinct banks) and
// relies on occupancy across the B*K independent tiles of a batched Newton
// inverse: one CTA of 256 threads per tile, ~33 KB of shared memory in
// f32, so several CTAs share an SM.  wgmma/TMA are not used.
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
chol_inv_tile_kernel(const T* __restrict__ A, T* __restrict__ Lout,
                     T* __restrict__ Xout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);   // factor, in place (NB x LD)
  T* X = S + NB * LD;                      // inverse (NB x LD)
  T* diag = X + NB * LD;                   // pivots d_j (NB)

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * NB * NB;
  const T* a = A + base;

  // coalesced load of the tile; X starts as the identity
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    S[r * LD + c] = a[e];
    X[r * LD + c] = (r == c) ? T(1) : T(0);
  }
  __syncthreads();

  // ---- factor: column j of S becomes L's column j (below the diagonal);
  // the pivot goes to diag[j] so S[j][j] is never rewritten while other
  // threads may still read it in the same step.
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

  // ---- inverse: column c of X solves L x = e_c.  Columns are independent,
  // so each column lives in one warp (8 columns x 4 row groups per warp)
  // and only warp-level barriers are needed.
  {
    const int lane = tid % 32, warp = tid / 32;
    const int c = warp * 8 + lane / 4;
    const int p = lane % 4;
    for (int k = 0; k < NB; ++k) {
      const T xk = X[k * LD + c] / diag[k];
      __syncwarp();
      for (int i = k + 1 + p; i < NB; i += 4) X[i * LD + c] -= S[i * LD + k] * xk;
      if (p == 0) X[k * LD + c] = xk;
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- write both tiles whole, exact zeros above the diagonal
  T* lo = Lout + base;
  T* xo = Xout + base;
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    lo[e] = (c < r) ? S[r * LD + c] : ((c == r) ? diag[r] : T(0));
    xo[e] = (c <= r) ? X[r * LD + c] : T(0);
  }
}

template <typename T>
int launch(const void* A, void* L, void* X, int tiles, void* stream) {
  if (tiles <= 0) return 0;
  const size_t smem = (2 * NB * LD + NB) * sizeof(T);
  // the f64 tile needs ~66 KB, above the 48 KB default: opt in (per
  // device, so on every call)
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_tile_kernel<T><<<tiles, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(X));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chol_inv_tile_f32(const void* A, void* L, void* X, int tiles,
                                 void* stream) {
  return launch<float>(A, L, X, tiles, stream);
}

extern "C" int chol_inv_tile_f64(const void* A, void* L, void* X, int tiles,
                                 void* stream) {
  return launch<double>(A, L, X, tiles, stream);
}
