// The interior point's Newton matrix in one pass, for Hopper (sm_90a): for
// each scenario b of a batch
//
//   M_b = H_b + sum_r dd_{b,r} c_{b,r} c_{b,r}^T + reg I
//             + sum_i sum_r db_{b,i,r} w_{b,i,r} w_{b,i,r}^T
//
// where c_{b,r} are the m_d dense rows of C_b (n wide), w_{b,i,r} the rb
// rows of stage block i of C_blk (cb <= 32 wide, at columns
// [32 i, 32 i + cb)), and dd, db the complementarity scaling of those rows.
//
// Replaces no TPU kernel.  It takes the place of the plain expression
// (ops/pdip.py, newton_matrix_ref): a scaled copy of C, a library GEMM of
// C^T (dd C), a dense pass adding H, another adding reg I, and a gather,
// add and scatter of the stage blocks -- five passes over (B, n, n) or
// (B, m_d, n) operands, where one touch of each operand is needed.
//
// What bounds it: bytes.  At n = 320, m_d = 141 the least traffic (H's
// lower triangle, C, C_blk and the scaling read, M's lower triangle
// written) is 632 KB a scenario in f32, 0.386 ms at B = 2048 and
// 3.35 TB/s.  The kernel reads H and writes M whole, 1,025 KB a scenario:
// the interior point's refinement reads both triangles of M, and each
// triangle is rounded as the plain expression rounds it (below).
//
// What the design does about it:
//   * One CTA of 64 threads per (scenario, 64 x 64 tile of M),
//     scenario-major, so a scenario's C stays in L2 while its tiles run.
//     Each thread sums an 8 x 8 block of the tile (rows 4 ty + a + 32 p,
//     columns 4 tx + c + 32 q) in registers, in the stated precision (fmaf /
//     fma, no tensor cores): 16 shared-memory words feed 64 FMAs, so shared
//     memory keeps pace with the FMA pipe.
//   * Rows of C are staged 4 at a time through a 6-deep pipe in shared
//     memory by cp.async (no registers in between), dd folded into the
//     I-side copy once it lands: (dd_r c_ri) c_rj, as the plain expression
//     rounds each product.  H's part of the tile is copied first and lands
//     while the rows are summed.
//   * Rows that are zero by structure are not read: the caller may pass,
//     for each block row L of M, the rows of C that reach column 64 L
//     (their nonzero widths: ocp/condense.py, CondensedQP.C_width), in C's
//     order.  A tile (I, J) sums those of L = max(I, J) only, which is the
//     dense sum: every row it leaves out is 0 on the tile's columns, and
//     would add an exact 0 to each sum.  At n = 320 the 25 tiles sum 1,516
//     row-tiles in place of 25 x 141 = 3,525.
//   * Each element is rounded as the plain expression rounds it: its sum
//     row by row in C's order, one fused multiply-add a row (the library
//     product's order), then + H, + reg on the diagonal, + the stage blocks
//     (summed the same way).  So M is the plain expression's bit for bit
//     where the library sums in order (the solve's shapes on the H100), and
//     M_ij and M_ji are each their own sum, as there.  An exactly symmetric
//     M (one sum a pair) moved the f32 interior point's refinement enough
//     to lose the sweep cell's accuracy check: its warm chain sits where
//     f32 rounding decides the answer (PERF.md, section 6).
//   * The epilogue adds H and reg; on a diagonal tile the copies of the
//     stage blocks that fall in it are in flight meanwhile, and their sums
//     are added next.  The tile then goes out row by row.
//   * Where H, C and M allow 16-byte accesses (f32, n and every stride a
//     multiple of 4) the copies and stores move 16 bytes each; elsewhere one
//     element each, with tile edges masked, so any n and m_d work.
//   * The tile in shared memory is swizzled so that its rows and the
//     threads' 8 x 8 blocks each meet distinct banks.
//
// Dynamic shared memory (64 x 64 + 6 x 2 x 4 x 64) elements, and m_d more
// elements and ints for the rows' scaling and order: 29,800 bytes in f32
// at m_d = 141.  The stage blocks (66 rb elements) use the pipe once the
// rows are summed; a larger rb makes the pipe larger.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() of its launch, or the error of raising the kernel's
// shared-memory limit where m_d and rb need more than the card has (the
// layout is this file's alone: smem_bytes).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace newton_matrix {

constexpr int NB = 64;                  // tile of M
constexpr int THREADS = 64;             // 8 x 8 threads, 8 x 8 sums each
constexpr int KC = 4;                   // rows of C staged per step
constexpr int STAGES = 6;               // steps in flight
constexpr int STEP = 2 * KC * NB;       // one step: I side, then J side
constexpr int TILE_ELEMS = NB * NB;     // H's part of the tile, then M's
constexpr int PIPE_ELEMS = STAGES * STEP;
constexpr int SW = 32;                  // row stride of a staged stage block

// fused a*b + c, one rounding
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// four consecutive elements of shared memory (p is 16-byte aligned)
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// copies global -> shared without passing through registers; where !ok
// nothing is read and the destination is 0
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(ok ? static_cast<int>(sizeof(T)) : 0));
}
__device__ __forceinline__ void copy16_async(float* dst, const float* src,
                                             bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where element (i, j) of the tile lies in shared memory.  One element at a
// time: columns XORed with a permutation of i mod 32, so that a row and the
// threads' 8 x 8 blocks each meet 32 banks.  16 bytes at a time: 4-column
// groups XORed with (i / 4) mod 8, so that each group stays whole and eight
// threads reading eight groups of a row meet 32 banks.
template <bool VEC>
__device__ __forceinline__ int at(int i, int j) {
  if constexpr (VEC) {
    return i * NB + (j ^ (((i >> 2) & 7) << 2));
  } else {
    const int r = i & 31;
    return i * NB + (j ^ (r ^ ((r >> 2) & 3)));
  }
}

// elements of the pipe: the staged rows, then the stage blocks and their
// scaling ([2][rb][SW] and [2][rb])
__host__ __device__ constexpr int pipe_elems(int rb) {
  return PIPE_ELEMS > 2 * rb * (SW + 1) ? PIPE_ELEMS : 2 * rb * (SW + 1);
}

// Strides in elements; rows are contiguous.  H, C, M: scenario stride and
// row stride.  D (the scaling, m_d dense entries then Nb x rb stage
// entries): scenario stride.  W (the stage blocks, may be null when
// Nb == 0): scenario, stage and row strides.  rows[level[I] ..
// level[I + 1]): the rows tile row I sums, in the order they are summed.
// VEC: 16-byte copies and stores (T = float, n and the strides of H, C, M
// multiples of 4, the pointers 16-byte aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
newton_kernel(const T* __restrict__ H, long long sh, long long ldh,
              const T* __restrict__ C, long long sc, long long ldc,
              const T* __restrict__ D, long long sd,
              const T* __restrict__ W, long long sw, long long tw,
              long long ldw, const int* __restrict__ rows,
              const int* __restrict__ level, T* __restrict__ M,
              long long sm, long long ldm, T reg, int n, int m_d, int Nb,
              int rb, int cb, int tiles) {
  static_assert(!VEC || std::is_same<T, float>::value, "16-byte path: f32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);     // H, then M (at(i, j))
  T* pipe = tile + TILE_ELEMS;                  // [STAGES][2][KC][NB]
  T* sdd = pipe + pipe_elems(rb);               // dd of the rows, in order
  int* srow = reinterpret_cast<int*>(sdd + m_d);
  const long long b = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - b * tiles);
  const int K = (n + NB - 1) / NB;
  const int I = t / K, J = t - I * K;      // tile (I, J) of K x K
  const int i0 = NB * I, j0 = NB * J;
  const bool diag = I == J;
  H += b * sh;
  C += b * sc;
  D += b * sd;
  M += b * sm;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;    // the thread's 8 x 8 block
  const int vr = tid >> 4, vc = 4 * (tid & 15);   // 16-byte: rows vr + 4 u
  const bool in_i = i0 + tid < n, in_j = j0 + tid < n;

  // the rows this tile sums, and their dd (copy group 0)
  const int L = I > J ? I : J;
  const int r0 = level[L], nr = level[L + 1] - r0;
  for (int k = tid; k < nr; k += THREADS) {
    const int r = __ldg(rows + r0 + k);
    srow[k] = r;
    copy_async(sdd + k, D + r, true);
  }
  copy_commit();

  // H's part of the tile (copy group 1): it lands while the rows are
  // summed
  if constexpr (VEC) {
#pragma unroll 4
    for (int u = 0; u < NB / 4; ++u) {
      const int i = vr + 4 * u;
      const bool ok = i0 + i < n && j0 + vc < n;
      copy16_async(tile + at<VEC>(i, vc),
                   ok ? H + static_cast<long long>(i0 + i) * ldh + j0 + vc
                      : H, ok);
    }
  } else {
    for (int i = 0; i < NB; ++i) {
      const bool ok = i0 + i < n && in_j;
      copy_async(tile + at<VEC>(i, tid),
                 ok ? H + static_cast<long long>(i0 + i) * ldh + j0 + tid
                    : H, ok);
    }
  }
  copy_commit();
  __syncthreads();                         // srow

  // ---- the dense rows: acc = sum_r (dd_r c_ri) c_rj over the tile ----
  // Step s stages rows KC s .. KC s + KC - 1 into pipe[s % STAGES], both
  // sides; each thread scales its own I-side copies by dd once they have
  // landed.  16 bytes at a time, thread tid copies I-side group vc of row
  // vr and the same J-side group; else column tid of every row.
  const int steps = (nr + KC - 1) / KC;
  auto issue = [&](int s) {
    T* si = pipe + (s % STAGES) * STEP;
    if constexpr (VEC) {
      static_assert(KC * NB / 4 == THREADS, "one 16-byte group a side");
      const int k = s * KC + vr;
      const bool ok = k < nr;
      const T* row = ok ? C + static_cast<long long>(srow[k]) * ldc : C;
      copy16_async(si + vr * NB + vc, row + i0 + vc, ok && i0 + vc < n);
      copy16_async(si + KC * NB + vr * NB + vc, row + j0 + vc,
                   ok && j0 + vc < n);
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        const int k = s * KC + q;
        const bool ok = k < nr;
        const T* row = ok ? C + static_cast<long long>(srow[k]) * ldc : C;
        copy_async(si + q * NB + tid, row + i0 + tid, ok && in_i);
        copy_async(si + KC * NB + q * NB + tid, row + j0 + tid, ok && in_j);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    copy_commit();
  }
  copy_wait<STAGES>();                     // group 0: dd
  __syncthreads();
  T acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = T(0);
  for (int s = 0; s < steps; ++s) {
    copy_wait<STAGES - 2>();               // step s has landed (this thread's)
    T* si = pipe + (s % STAGES) * STEP;
    if constexpr (VEC) {
      const int k = s * KC + vr;
      if (k < nr) {
        float4* p = reinterpret_cast<float4*>(si + vr * NB + vc);
        const float d = sdd[k];
        float4 v = *p;
        v.x *= d; v.y *= d; v.z *= d; v.w *= d;
        *p = v;
      }
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        const int k = s * KC + q;
        if (k < nr) si[q * NB + tid] *= sdd[k];
      }
    }
    __syncthreads();                       // step s whole; step s - 1 done
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    copy_commit();
    const T* sj = si + KC * NB;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T a0[4], a1[4], b0[4], b1[4];
      lds4(si + k * NB + 4 * ty, a0);
      lds4(si + k * NB + 32 + 4 * ty, a1);
      lds4(sj + k * NB + 4 * tx, b0);
      lds4(sj + k * NB + 32 + 4 * tx, b1);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[a][c] = fmadd(a < 4 ? a0[a & 3] : a1[a & 3],
                            c < 4 ? b0[c & 3] : b1[c & 3], acc[a][c]);
    }
  }
  copy_wait<0>();
  __syncthreads();                         // the pipe is free; H has landed

  // ---- the stage blocks on a diagonal tile (stages 2I and 2I + 1): their
  // copies in flight while H and the sums are added ----
  const bool stages = diag && 2 * I < Nb;
  T* sw_ = pipe;                           // [2][rb][SW], zero past cb
  T* sdb = pipe + 2 * rb * SW;             // [2][rb]
  if (stages) {
    const T* Wb = W + b * sw;
    for (int e = tid; e < 2 * rb * SW; e += THREADS) {
      const int hr = e / SW, c = e - hr * SW;   // hr = h rb + r
      const int h = hr >= rb, r = hr - h * rb, st = 2 * I + h;
      const bool ok = st < Nb && c < cb;
      copy_async(sw_ + e,
                 ok ? Wb + st * tw + static_cast<long long>(r) * ldw + c : Wb,
                 ok);
    }
    for (int e = tid; e < 2 * rb; e += THREADS) {
      const int h = e >= rb, r = e - h * rb, st = 2 * I + h;
      copy_async(sdb + e, st < Nb ? D + m_d + st * rb + r : D, st < Nb);
    }
    copy_commit();
  }

  // ---- epilogue: + H, + reg I (+ the stage blocks) ----
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = 4 * ty + (a & 3) + 32 * (a >> 2);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 4 * tx + 32 * q;
      if constexpr (VEC) {
        float4* p = reinterpret_cast<float4*>(tile + at<VEC>(i, j));
        float4 v = *p;
        v.x += acc[a][4 * q];
        v.y += acc[a][4 * q + 1];
        v.z += acc[a][4 * q + 2];
        v.w += acc[a][4 * q + 3];
        if (diag && i == j) v.x += reg;
        if (diag && i == j + 1) v.y += reg;
        if (diag && i == j + 2) v.z += reg;
        if (diag && i == j + 3) v.w += reg;
        *p = v;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          T v = tile[at<VEC>(i, j + c)] + acc[a][4 * q + c];
          if (diag && i == j + c) v += reg;
          tile[at<VEC>(i, j + c)] = v;
        }
      }
    }
  }
  if (stages) {
    copy_wait<0>();
    __syncthreads();
    // quadrant (p, p) of a thread's block lies in stage 2I + p's slab
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (2 * I + p < Nb) {
        T st[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[a][c] = T(0);
        const T* w = sw_ + p * rb * SW;
        for (int r = 0; r < rb; ++r) {
          T wi[4], wj[4];
          lds4(w + r * SW + 4 * ty, wi);
          lds4(w + r * SW + 4 * tx, wj);
          const T d = sdb[p * rb + r];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const T x = wi[a] * d;
#pragma unroll
            for (int c = 0; c < 4; ++c) st[a][c] = fmadd(x, wj[c], st[a][c]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * ty + a < cb && 4 * tx + c < cb)
              tile[at<VEC>(4 * ty + a + 32 * p, 4 * tx + c + 32 * p)] +=
                  st[a][c];
      }
    }
  }
  __syncthreads();

  // the tile out, row by row
  if constexpr (VEC) {
#pragma unroll 4
    for (int u = 0; u < NB / 4; ++u) {
      const int i = vr + 4 * u;
      if (i0 + i < n && j0 + vc < n)
        __stcs(reinterpret_cast<float4*>(
                   M + static_cast<long long>(i0 + i) * ldm + j0 + vc),
               *reinterpret_cast<const float4*>(tile + at<VEC>(i, vc)));
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < NB; ++i) {
      if (i0 + i < n && in_j)
        __stcs(M + static_cast<long long>(i0 + i) * ldm + j0 + tid,
               tile[at<VEC>(i, tid)]);
    }
  }
}

// dynamic shared memory of a launch, in bytes
template <typename T>
size_t smem_bytes(int m_d, int rb) {
  return static_cast<size_t>(TILE_ELEMS + pipe_elems(rb)) * sizeof(T)
      + static_cast<size_t>(m_d) * (sizeof(T) + sizeof(int));
}

template <typename T, bool VEC>
int start(const T* H, long long sh, long long ldh, const T* C, long long sc,
          long long ldc, const T* D, long long sd, const T* W, long long sw,
          long long tw, long long ldw, const int* rows, const int* level,
          T* M, long long sm, long long ldm, double reg, int n, int m_d,
          int Nb, int rb, int cb, int tiles, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(m_d, rb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(batch) * tiles);
  newton_kernel<T, VEC><<<blocks, THREADS, smem, stream>>>(
      H, sh, ldh, C, sc, ldc, D, sd, W, sw, tw, ldw, rows, level, M, sm, ldm,
      static_cast<T>(reg), n, m_d, Nb, rb, cb, tiles);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Launch on `stream`; returns the launch's cudaGetLastError().
template <typename T>
int launch(const void* H, long long sh, long long ldh, const void* C,
           long long sc, long long ldc, const void* D, long long sd,
           const void* W, long long sw, long long tw, long long ldw,
           const void* rows, const void* level, void* M, long long sm,
           long long ldm, double reg, int n, int m_d, int Nb, int rb, int cb,
           int batch, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int K = (n + NB - 1) / NB;
  const int tiles = K * K;
  const auto* h = static_cast<const T*>(H);
  const auto* c = static_cast<const T*>(C);
  const auto* d = static_cast<const T*>(D);
  const auto* w = static_cast<const T*>(W);
  const auto* r = static_cast<const int*>(rows);
  const auto* l = static_cast<const int*>(level);
  auto* m = static_cast<T*>(M);
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    if (aligned16(H) && aligned16(C) && aligned16(M) && n % 4 == 0
        && sh % 4 == 0 && ldh % 4 == 0 && sc % 4 == 0 && ldc % 4 == 0
        && sm % 4 == 0 && ldm % 4 == 0)
      return start<T, true>(h, sh, ldh, c, sc, ldc, d, sd, w, sw, tw, ldw, r,
                            l, m, sm, ldm, reg, n, m_d, Nb, rb, cb, tiles,
                            batch, s);
  }
  return start<T, false>(h, sh, ldh, c, sc, ldc, d, sd, w, sw, tw, ldw, r, l,
                         m, sm, ldm, reg, n, m_d, Nb, rb, cb, tiles, batch, s);
}

}  // namespace newton_matrix

extern "C" int newton_matrix_f32(
    const void* H, long long sh, long long ldh, const void* C, long long sc,
    long long ldc, const void* D, long long sd, const void* W, long long sw,
    long long tw, long long ldw, const void* rows, const void* level,
    void* M, long long sm, long long ldm, double reg, int n, int m_d, int Nb,
    int rb, int cb, int batch, void* stream) {
  return newton_matrix::launch<float>(H, sh, ldh, C, sc, ldc, D, sd, W, sw,
                                      tw, ldw, rows, level, M, sm, ldm, reg,
                                      n, m_d, Nb, rb, cb, batch, stream);
}

extern "C" int newton_matrix_f64(
    const void* H, long long sh, long long ldh, const void* C, long long sc,
    long long ldc, const void* D, long long sd, const void* W, long long sw,
    long long tw, long long ldw, const void* rows, const void* level,
    void* M, long long sm, long long ldm, double reg, int n, int m_d, int Nb,
    int rb, int cb, int batch, void* stream) {
  return newton_matrix::launch<double>(H, sh, ldh, C, sc, ldc, D, sd, W, sw,
                                       tw, ldw, rows, level, M, sm, ldm, reg,
                                       n, m_d, Nb, rb, cb, batch, stream);
}
