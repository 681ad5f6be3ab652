// Block forward and back substitution with a blocked Cholesky factor, for
// Hopper (sm_90a): x = (L L^T)^-1 b for a batch of SPD systems at once,
// one right-hand side each.
//
// Replaces no TPU kernel.  The JAX package's interior point forms the
// Newton inverse M^-1 = L^-T L^-1 (cmpc_tpu/ops/pdip.py, explicit_inv) and
// applies it as a matrix, because on the TPU the blocked products of the
// inverse beat XLA's lowering of a substitution.  On the H100 that trade
// reverses: the inverse costs 3.2x the operations of the factor, and its
// product with a vector reads as many bytes as a substitution with the
// factor.  So on the card the interior point applies the factor that
// blocked_cholesky already computes — L, and the inverses Dinv_i of its
// 64 x 64 diagonal blocks from the tile kernel — by two sweeps over the
// K = n / 64 block rows:
//   forward  y_i = Dinv_i (b_i - sum_{k<i} L_ik y_k),      i = 0 .. K-1
//   back     x_i = Dinv_i^T (y_i - sum_{k>i} L_ki^T x_k),  i = K-1 .. 0
// The diagonal blocks of L are never read: Dinv_i stands for them, so each
// step is a product of 64-row blocks with a vector and nothing inside a
// block runs in sequence; only the K steps of each sweep do.
//
// What bounds it: bytes.  A call reads every block of L below the diagonal
// and every Dinv_i once per sweep and does 2 operations per element read;
// the vectors are 2 n elements.  With each block read once from device
// memory the least traffic is K (K + 1) / 2 blocks: 15 at n = 320, 245,760
// bytes per scenario in f32 (0.150 ms at B = 2048 and 3.35 TB/s).  The
// second sweep reads the same blocks again, from L2 where they are still
// there, else from device memory.
//
// What the design does about it:
//   * One CTA of 256 threads per scenario; the vector (b, then y, then x)
//     stays in shared memory.  Thread (g, q) owns rows 4g .. 4g+3 and
//     columns 4q .. 4q+3 of every block it reads, as 16-byte loads: a
//     half-warp reads 256 contiguous bytes of a row in f32.
//   * A step's loads do not depend on the vector, and the loop over a
//     step's blocks is unrolled four times (K - 1 = 4 blocks at most at
//     n = 320), so all of a step's loads are in flight before its first
//     product.  The registers this takes (128 a thread) leave room for two
//     CTAs an SM, which is also fewer scenarios between a block's two
//     reads: measured at (2048, 320) f32, four CTAs an SM with two blocks
//     in flight took 0.344 ms, two with four 0.273 ms.
//   * The back sweep's loads are the last use of their blocks, so they are
//     marked to leave L2 first (__ldcs): the blocks the forward sweep
//     brought in and the back sweep has yet to read stay longer (0.273 ->
//     0.251 ms).
//   * Forward steps are rows times a vector: the 16 lanes that share rows
//     sum by shuffles.  Back steps are a block's transpose times a vector:
//     the 16 row groups sum through shared memory.
//   * Every product is taken, zeros included: a NaN anywhere in a block
//     that a sweep reads reaches every element of x, as it reaches every
//     element of an explicit inverse's product, so the interior point's
//     guard freezes the same scenarios.
//
// Dynamic shared memory (n + 17 * 64) elements: 5,632 bytes in f32 at
// n = 320 (11,264 in f64); n <= 4096 keeps it under 48 KB.  nvcc -Xptxas
// -v (sm_90a): f32 128 registers, f64 128 registers, 0 bytes stack, 0
// bytes spilled in both.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace chol_solve {

constexpr int NB = 64;                   // block size (the tile kernel's)
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / 16;     // row groups of 4 rows

constexpr int MIN_BLOCKS = 2;            // resident CTAs an SM

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

// fused a*b + c, one rounding
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// the same through loads marked as the data's last use (evict first)
__device__ __forceinline__ void load4_last(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4_last(const double* p, double (&v)[4]) {
  const double2 q0 = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldcs(reinterpret_cast<const double2*>(p + 2));
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// rows r0 .. r0+3, columns c0 .. c0+3 of the block at `p` (row stride ld);
// LAST: the back sweep's read, the block's last use
template <bool LAST, typename T>
__device__ __forceinline__ void load_quad(const T* __restrict__ p,
                                          long long ld, T (&a)[4][4]) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    if (LAST) {
      load4_last(p + rr * ld, a[rr]);
    } else {
      load4(p + rr * ld, a[rr]);
    }
  }
}

// v[rr] summed over the 16 lanes of the half-warp
template <typename T>
__device__ __forceinline__ void sum16(T (&v)[4]) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      v[rr] += __shfl_xor_sync(0xffffffffu, v[rr], off);
  }
}

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// Strides in elements; rows are contiguous.  L (per scenario): row stride
// ldl, scenario stride sl.  Dinv: row stride ldd, block stride td,
// scenario stride sd.  b and x: scenario stride sb / sx.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
solve_kernel(const T* __restrict__ L, long long ldl, long long sl,
             const T* __restrict__ D, long long ldd, long long td,
             long long sd, const T* __restrict__ b, long long sb,
             T* __restrict__ x, long long sx, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);   // n: b, then y, then x
  T* red = v + K * NB;                      // GROUPS x NB partial sums
  T* r = red + GROUPS * NB;                 // NB: one step's right side
  const long long s = blockIdx.x;
  L += s * sl;
  D += s * sd;
  b += s * sb;
  x += s * sx;
  const int n = K * NB;
  const int t = threadIdx.x;
  const int q = t & 15, g = t >> 4;
  const int c0 = 4 * q, r0 = 4 * g;
  for (int e = t; e < n; e += THREADS) v[e] = b[e];
  __syncthreads();

  // forward: rows r0.. of block row i times y, block by block
  for (int i = 0; i < K; ++i) {
    T d[4][4];
    load_quad<false>(D + i * td + r0 * ldd + c0, ldd, d);
    const T* row = L + (static_cast<long long>(i) * NB + r0) * ldl + c0;
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
    for (int k = 0; k < i; ++k) {
      T a[4][4], yk[4];
      load_quad<false>(row + k * NB, ldl, a);
      load4(v + k * NB + c0, yk);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[rr] = fmadd(a[rr][cc], yk[cc], acc[rr]);
    }
    sum16(acc);
    if (q < 4) r[r0 + q] = v[i * NB + r0 + q] - pick(acc, q);
    __syncthreads();
    T rhs[4], y[4] = {T(0), T(0), T(0), T(0)};
    load4(r + c0, rhs);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        y[rr] = fmadd(d[rr][cc], rhs[cc], y[rr]);
    sum16(y);
    if (q < 4) v[i * NB + r0 + q] = pick(y, q);
    __syncthreads();
  }

  // back: block column i of L below the diagonal, transposed, times x
  for (int i = K - 1; i >= 0; --i) {
    T d[4][4];
    load_quad<false>(D + i * td + r0 * ldd + c0, ldd, d);
    const T* col = L + static_cast<long long>(r0) * ldl + i * NB + c0;
    T part[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
    for (int k = i + 1; k < K; ++k) {
      T a[4][4], xk[4];
      load_quad<true>(col + static_cast<long long>(k) * NB * ldl, ldl, a);
      load4(v + k * NB + r0, xk);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          part[cc] = fmadd(a[rr][cc], xk[rr], part[cc]);
    }
    store4(red + g * NB + c0, part);
    __syncthreads();
    if (t < NB) {
      T sum = T(0);
#pragma unroll
      for (int gg = 0; gg < GROUPS; ++gg) sum += red[gg * NB + t];
      r[t] = v[i * NB + t] - sum;
    }
    __syncthreads();
    T rhs[4];
    load4(r + r0, rhs);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) part[cc] = T(0);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        part[cc] = fmadd(d[rr][cc], rhs[rr], part[cc]);
    store4(red + g * NB + c0, part);
    __syncthreads();
    if (t < NB) {
      T sum = T(0);
#pragma unroll
      for (int gg = 0; gg < GROUPS; ++gg) sum += red[gg * NB + t];
      v[i * NB + t] = sum;
    }
    __syncthreads();
  }

  for (int e = t; e < n; e += THREADS) x[e] = v[e];
}

// Launch on `stream`; returns the launch's cudaGetLastError().
template <typename T>
int launch(const void* L, long long ldl, long long sl, const void* D,
           long long ldd, long long td, long long sd, const void* b,
           long long sb, void* x, long long sx, int K, int batch,
           void* stream) {
  if (batch <= 0 || K <= 0) return 0;
  const size_t smem = (static_cast<size_t>(K) + GROUPS + 1) * NB * sizeof(T);
  solve_kernel<T><<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), ldl, sl, static_cast<const T*>(D), ldd, td,
      sd, static_cast<const T*>(b), sb, static_cast<T*>(x), sx, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chol_solve

extern "C" int chol_solve_f32(const void* L, long long ldl, long long sl,
                              const void* D, long long ldd, long long td,
                              long long sd, const void* b, long long sb,
                              void* x, long long sx, int K, int batch,
                              void* stream) {
  return chol_solve::launch<float>(L, ldl, sl, D, ldd, td, sd, b, sb, x, sx,
                                   K, batch, stream);
}

extern "C" int chol_solve_f64(const void* L, long long ldl, long long sl,
                              const void* D, long long ldd, long long td,
                              long long sd, const void* b, long long sb,
                              void* x, long long sx, int K, int batch,
                              void* stream) {
  return chol_solve::launch<double>(L, ldl, sl, D, ldd, td, sd, b, sb, x, sx,
                                    K, batch, stream);
}
