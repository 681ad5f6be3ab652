// Shared body of the two tile kernels for Hopper (sm_90a): the Cholesky
// factor of 64x64 SPD tiles (chol_tile.cu) and the factor fused with its
// inverse (chol_inv_tile.cu).
//
// Replaces the Pallas TPU kernels of cmpc_tpu/ops/batched_chol.py:
// _chol_tile_pallas (factor) and _chol_inv_tile_pallas (factor + inverse).
// For each tile A:
//   L = chol(A)  — 64-step right-looking elimination, pivot
//                  sqrt(max(a_jj, 1e-30)), NaN passed on;
//   X = L^-1     — forward substitution on L X = I (fused kernel only).
// Outputs are written whole, with exact zeros above the diagonal; only the
// lower triangle of A is read.  Input and outputs are addressed by a row
// stride and a tile stride (in elements), so a caller can hand over a
// diagonal block of a larger matrix where it lies and have the results
// written into place.
//
// What bounds it on this card: one tile moves 32-48 KB and does 0.1-0.2
// MFLOP, but the elimination is 64 steps that each depend on the last:
// pivot d_j -> division l_{j+1,j} -> multiply-add -> square root d_{j+1},
// plus one pass through shared memory and one barrier to hand the column
// on.  Up to a few hundred tiles the time is the latency of ONE tile's
// chain, not bytes or arithmetic; from about a thousand tiles on it is the
// SMs' instruction throughput, still not the bytes.
//
// What the design does about it:
//   * The tile lives in registers.  Two warps factor a tile; thread i
//     holds row i of A, later of L.  A multiply-add costs no shared-memory
//     traffic of its own: the multipliers l_kj come by broadcast 16-byte
//     loads, four at a time.
//   * Register indices are constants, yet the loop over the steps stays
//     rolled: a thread keeps a WINDOW of its row that starts at the current
//     column, and after every four steps the window moves on by four
//     registers.  The code of four steps is then the same for all steps.
//     (Unrolling all 64 steps, the other way to constant indices, ran at
//     one instruction per ~7 cycles: 180 KB of straight-line code is
//     fetched from beyond the instruction cache every time.)  The window
//     reaches past column 63 and past finished rows; what it computes
//     there is garbage that is never stored.  It narrows every 16 steps
//     (64, 48, 32, 16 columns) to bound that waste.
//   * Shared memory only passes columns along.  At step j thread i divides
//     its a_ij by the pivot and writes l_ij into column j of an array that
//     is stored column by column (Lt[j][i] = L[i][j]); every address is
//     written once, so no buffer is reused and ONE barrier per step is
//     enough.  The owner of row j+1 needs only its own l_{j+1,j} to finish
//     its diagonal element, so it computes the next pivot d_{j+1} before
//     that barrier and passes it along with the column.  Of the rank-1
//     update only the two elements the next barrier waits for come first;
//     the rest of step j is done after the next barrier, in the shadow of
//     step j+1's division and square root.
//   * The inverse runs beside the factor, not after it: in the fused
//     kernel two more warps own the columns of X.  Thread c solves
//     L x = e_c with x in its registers (the same moving window), and takes
//     substitution step j as soon as column j of L has been passed along,
//     reading it by broadcast; it joins the factor's barrier and adds
//     nothing to the chain.
//   * The barrier spans one tile's warps only, and only those that still
//     have work: rows 0..31 are complete after step 31, and their warp
//     leaves.  In the factor-only kernel the upper warp then runs on
//     __syncwarp().
//   * A CTA is one tile (64 or 128 threads, 16.3 KB of shared memory in
//     f32), so independent tiles spread over all SMs and an SM takes as
//     many as its registers allow.
//
// Every element is the result of one fixed sequence of operations,
// whatever the thread layout: a_ik minus l_ij*l_kj in order of j, each one
// fused multiply-add; a true division by d_j; x_k = x_k / d_k.
//
// The tensor cores (wgmma, mma.sync) are not used: the only products
// inside a tile are rank-1 updates, and the solver pins this path to full
// f32 (its stationarity residual sits at 0.110 against a bound of 0.15),
// while TF32 keeps 10 bits of mantissa.  No bulk asynchronous copy either:
// the tile goes from device memory straight into registers.
//
// Registers and spills as `nvcc -Xptxas -v` reports them are in the note
// of each .cu file.

#pragma once

#include <cuda_runtime.h>

namespace chol_tile {

constexpr int NB = 64;                   // tile size
constexpr int HALF = NB / 2;             // rows per warp
constexpr int QUARTER = NB / 4;          // steps between two window widths
constexpr int WARP = 32;

// Elements of shared memory per tile: L column by column, and a tail that
// the last columns' windows read past the end of the array.
constexpr int LT_ELEMS = NB * NB + NB;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// fused a*b + c, one rounding
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// max(x, lo) that propagates NaN like jnp.maximum / torch.clamp_min
// (fmax would drop it)
template <typename T>
__device__ __forceinline__ T nan_max(T x, T lo) {
  return (x != x) ? x : (x > lo ? x : lo);
}

// The value of x, hidden from the compiler's algebra.
__device__ __forceinline__ float opaque(float x) {
  asm("" : "+f"(x));
  return x;
}
__device__ __forceinline__ double opaque(double x) {
  asm("" : "+d"(x));
  return x;
}

// x / d for a pivot d (positive, +inf or NaN; never zero or negative).
// The hardware's division leaves its short path for a zero numerator (a
// call into a subroutine of some thirty operations, for the whole warp:
// ~250 cycles a step when measured), and here zeros are the rule: every
// finished row in the elimination and every x_k above the diagonal in the
// substitution, in some lane at every step.  A zero therefore bypasses the
// divider: 0 / d is the same zero, or NaN for a NaN pivot, and the divider
// is fed a 1 in its place — through opaque(), or the compiler puts the
// zero back.  Any other numerator takes the true division.
template <typename T>
__device__ __forceinline__ T div_by_pivot(T x, T d) {
  const bool zero = (x == T(0));
  const T q = opaque(zero ? T(1) : x) / d;
  return zero ? ((d != d) ? d : x) : q;
}

// four consecutive elements through 16-byte accesses (p is 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Barrier over COUNT threads of the tile: the warp's own when COUNT is one
// warp, else the named barrier ID (each count keeps to its own ID).
template <int ID, int COUNT>
__device__ __forceinline__ void tile_barrier() {
  if (COUNT == WARP) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
  }
}

// Columns 0 .. NC-1 of row i into the window: the lower triangle only,
// zeros for the rest.
template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int i,
                                         T (&w)[NB]) {
#pragma unroll
  for (int q = 0; q < NC / 4; ++q) {
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (4 * q <= i) load4(row + 4 * q, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * q + e] = v[e];
  }
}

// The window moves on by four columns: w[t] <- w[t+4], zeros come in.
template <typename T, int N>
__device__ __forceinline__ void shift4(T (&w)[NB]) {
#pragma unroll
  for (int t = 0; t < N - 4; ++t) w[t] = w[t + 4];
#pragma unroll
  for (int t = N - 4; t < N; ++t) w[t] = T(0);
}

// Four elimination steps j0 .. j0+3 as seen by thread i, whose window
// w[0..N-1] holds columns j0 .. j0+N-1 of row i.  The code is the same for
// every j0, so the caller's loop over j0 stays rolled.  The barrier after
// each step's column is tile_barrier<ID, COUNT>.
//
// Per step j: l_ij = a_ij / d_j goes to column j of Lt; the owner of row
// j+1 computes the next pivot from its own multiplier and passes it along
// with the column; barrier; then the rest of step j-1's rank-1 update
// (columns j+2 on, multipliers from column j-1, which stays in Lt) and the
// two elements of step j's that the next barrier waits for: column j+1
// (the next division) and j+2 (the pivot after the next).  Each a_ik still
// takes its products in order of j.
template <typename T, int N, int ID, int COUNT>
__device__ __forceinline__ void factor_steps4(T (&w)[NB], T& l_prev, T& diag,
                                              T* Lt, T* __restrict__ lrow,
                                              int i, int j0) {
  T out[4];                               // L[i][j0 .. j0+3]
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = j0 + s;
    T* col = Lt + j * NB;                 // column j of L
    const bool below = i > j;
    const T l = div_by_pivot(below ? w[s] : T(0), col[j]);
    if (below) col[i] = l;
    out[s] = below ? l : (i == j ? diag : T(0));
    if (i == j + 1) {
      diag = dsqrt(nan_max(fmadd(-l, l, w[s + 1]), T(1e-30)));
      col[NB + j + 1] = diag;             // Lt[j+1][j+1]
    }
    tile_barrier<ID, COUNT>();
    if (s > 0 || j0 > 0) {                // the rest of step j-1
      const T* pcol = col - NB + j0;
#pragma unroll
      for (int q = (s + 2) / 4; q < N / 4; ++q) {
        T lk[4];
        load4(pcol + 4 * q, lk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * q + e;
          if (t >= s + 2) w[t] = fmadd(-l_prev, lk[e], w[t]);
        }
      }
    }
    w[s + 1] = fmadd(-l, col[j + 1], w[s + 1]);
    w[s + 2] = fmadd(-l, col[j + 2], w[s + 2]);
    l_prev = l;
  }
  store4(lrow + j0, out);
  shift4<T, N>(w);
}

// Steps J0 .. J0+15 on a window of N columns.
template <typename T, int N, int J0, int ID, int COUNT>
__device__ __forceinline__ void factor_steps16(T (&w)[NB], T& l_prev,
                                               T& diag, T* Lt,
                                               T* __restrict__ lrow, int i) {
#pragma unroll 1
  for (int j0 = J0; j0 < J0 + QUARTER; j0 += 4)
    factor_steps4<T, N, ID, COUNT>(w, l_prev, diag, Lt, lrow, i, j0);
}

// The elimination of rows W*32 .. W*32+31 (warp W of the tile's two factor
// warps).  Writes row i of L to lrow and leaves Lt[j*NB + i] = L[i][j] for
// i >= j.  TT is the number of threads that meet at the tile's barrier.
template <typename T, int W, int TT>
__device__ __forceinline__ void factor_rows(const T* __restrict__ arow,
                                            T* __restrict__ lrow, T* Lt,
                                            int i) {
  constexpr int N = W ? NB : HALF;        // columns the warp's rows reach
  T w[NB];
  load_row<T, N>(arow, i, w);
  T diag = T(0), l_prev = T(0);
  if (W == 0 && i == 0) {
    diag = dsqrt(nan_max(w[0], T(1e-30)));
    Lt[0] = diag;
  }
  tile_barrier<1, TT>();
  // steps 0 .. 31: every warp of the tile
  factor_steps16<T, N, 0, 1, TT>(w, l_prev, diag, Lt, lrow, i);
  factor_steps16<T, N - QUARTER, QUARTER, 1, TT>(w, l_prev, diag, Lt, lrow,
                                                 i);
  if (W == 0) {
    // rows 0 .. 31 are complete; their columns 32 .. 63 are zeros
    const T zeros[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int q = HALF / 4; q < NB / 4; ++q) store4(lrow + 4 * q, zeros);
  } else {
    // steps 32 .. 63: without the lower warp, on columns 32 .. 63
    factor_steps16<T, HALF, HALF, 2, TT - WARP>(w, l_prev, diag, Lt, lrow,
                                                i);
    factor_steps16<T, QUARTER, HALF + QUARTER, 2, TT - WARP>(
        w, l_prev, diag, Lt, lrow, i);
  }
}

// Substitution steps K0 .. K0+15 of column c of X = L^-1 on a window
// v[0..N-1] = x[k0 .. k0+N-1], four steps to a window move.  Step k waits
// at the factor's barrier for column k of L, then x_k = x_k / d_k is final
// and stored (threads c, c+1, ... write neighbouring addresses of row k),
// and x_i -= L[i][k] x_k for the rows below, L's column read from Lt by
// broadcast.
template <typename T, int N, int K0, int ID, int COUNT>
__device__ __forceinline__ void inverse_steps16(T (&v)[NB], const T* Lt,
                                                T* __restrict__ xcol,
                                                long long ldx, int c) {
#pragma unroll 1
  for (int k0 = K0; k0 < K0 + QUARTER; k0 += 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = k0 + s;
      const T* col = Lt + k * NB;
      tile_barrier<ID, COUNT>();
      const T xk = div_by_pivot(v[s], col[k]);
      xcol[k * ldx] = (c <= k) ? xk : T(0);
#pragma unroll
      for (int q = (s + 1) / 4; q < N / 4; ++q) {
        T l[4];
        load4(col + k0 + 4 * q, l);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * q + e;
          if (t > s) v[t] = fmadd(-l[e], xk, v[t]);
        }
      }
    }
    shift4<T, N>(v);
  }
}

// Column c of X = L^-1: forward substitution on L x = e_c with x in the
// thread's registers, every thread through all 64 steps (the zeros above
// the diagonal take the same operations), in step with the factor.
template <typename T, int TT>
__device__ __forceinline__ void inverse_column(const T* Lt,
                                               T* __restrict__ xcol,
                                               long long ldx, int c) {
  T v[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t) v[t] = (t == c) ? T(1) : T(0);
  tile_barrier<1, TT>();                  // the first pivot is there
  inverse_steps16<T, NB, 0, 1, TT>(v, Lt, xcol, ldx, c);
  inverse_steps16<T, NB - QUARTER, QUARTER, 1, TT>(v, Lt, xcol, ldx, c);
  inverse_steps16<T, HALF, HALF, 2, TT - WARP>(v, Lt, xcol, ldx, c);
  inverse_steps16<T, QUARTER, HALF + QUARTER, 2, TT - WARP>(v, Lt, xcol, ldx,
                                                            c);
}

// Threads per tile, which is a CTA: two warps factor, and in the fused
// kernel two more invert.
template <bool INVERSE>
constexpr int TILE_THREADS = INVERSE ? 2 * NB : NB;

// lda/ldl/ldx are row strides and sa/sl/sx tile strides, in elements; rows
// are contiguous.  X is not touched unless INVERSE.
template <typename T, bool INVERSE>
__global__ void __launch_bounds__(TILE_THREADS<INVERSE>)
tile_kernel(const T* __restrict__ A, long long lda, long long sa,
            T* __restrict__ L, long long ldl, long long sl,
            T* __restrict__ X, long long ldx, long long sx) {
  constexpr int TT = TILE_THREADS<INVERSE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Lt = reinterpret_cast<T*>(smem_raw);
  const long long tile = blockIdx.x;
  const int i = threadIdx.x % NB;         // row of L, or column of X
  if (threadIdx.x < HALF) {
    factor_rows<T, 0, TT>(A + tile * sa + i * lda, L + tile * sl + i * ldl,
                          Lt, i);
  } else if (threadIdx.x < NB) {
    factor_rows<T, 1, TT>(A + tile * sa + i * lda, L + tile * sl + i * ldl,
                          Lt, i);
  } else {
    inverse_column<T, TT>(Lt, X + tile * sx + i, ldx, i);
  }
}

// Launch on `stream`; returns the launch's cudaGetLastError().
template <typename T, bool INVERSE>
int launch(const void* A, long long lda, long long sa, void* L,
           long long ldl, long long sl, void* X, long long ldx,
           long long sx, int tiles, void* stream) {
  if (tiles <= 0) return 0;
  constexpr size_t smem = LT_ELEMS * sizeof(T);
  static_assert(smem <= 48 * 1024, "fits the default dynamic shared memory");
  tile_kernel<T, INVERSE><<<tiles, TILE_THREADS<INVERSE>, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, sa, static_cast<T*>(L), ldl, sl,
      static_cast<T*>(X), ldx, sx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chol_tile
