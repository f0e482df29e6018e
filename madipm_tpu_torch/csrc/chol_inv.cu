// Cholesky factors of a stack of SPD matrices, hand-written for Hopper
// (sm_90a).  Two entry points share one blocked sweep:
//
//   madipm_chol_inv_*  (L, L^-1).  Replaces
//     madipm_tpu/ops/pallas_chol.py::pallas_chol_inv (kernel body
//     _chol_inv_kernel + _factor_sweep): the factor of the Jacobi-scaled
//     normal (NORMAL) or condensed (CONDENSED) matrix that the CHOLESKY_INV
//     path computes on every IPM iteration (ops/kkt.py factorize).
//   madipm_cholesky_*  L only.  Replaces
//     madipm_tpu/ops/pallas_chol.py::pallas_cholesky (kernel body
//     _chol_kernel + _factor_sweep): the factor the CHOLESKY path takes
//     with use_pallas=True.  It runs the sweep and zeroes the upper
//     triangle; the blocked inversion is skipped, and no L^-1 buffer
//     exists: the one NB x NB inverse tile the panel product needs lives in
//     a (B, NB, NB) scratch that every panel step overwrites.
//
// Output semantics are the TPU kernels': L lower (and Linv = L^-1 lower),
// upper triangle zeroed; a pivot <= 0 (S not SPD) turns into NaN, which
// propagates and trips the x100 regularization retry
// (ops/linalg.cholesky_is_ok).
//
// What bounds them on this card.  Per instance the factor costs N^3/3
// flops and the triangular inverse another N^3/3; at B=8, N=1024 that is
// ~2.9 GFLOP (factor) or ~5.7 GFLOP (both) per call against 2 (or 3)
// B*N^2 words that must move: compute-bound on paper, well under a
// millisecond at the fp32 or fp64 FMA rate.  In fact the sweep is
// sequential over N/NB panels, and each panel step reads and rewrites the
// trailing lower triangle (~3*B*N^2 words per panel at the start,
// shrinking to zero), so what bounds a simple design is that traffic
// through L2/HBM plus the launch chain (3 launches per panel, and for the
// inverse one more per block row), not the arithmetic.  The factor-only
// entry drops the inverse rows, the largest share of the launch chain.
//
// The design keeps it simple and correct first:
//   - the host loops over panels of width NB=32, one launch per step;
//     gridDim.z spans the batch, so one call factors the whole stack;
//   - diag_kernel: one CTA per instance factors the NB x NB diagonal tile
//     in shared memory (unblocked right-looking Cholesky) and inverts it
//     by column substitution (8 KB fp64 per tile, no dynamic smem opt-in);
//   - panel_kernel:    L21 = S21 * Wkk^T            (64-row tiles);
//   - trailing_kernel: S22 -= L21 * L21^T, lower 64x64 tiles only;
//   - inverse_kernel (chol_inv only), block row by block row:
//       Linv[i,k] = -Wii * sum_{k<=j<i} L[i,j] * Linv[j,k]   (all k < i at once);
//   - every product goes through tile_gemm, a shared-memory tiled GEMM.
// wgmma, TMA and a single persistent kernel are later work.
//
// Plain C interface for ctypes: pointers to contiguous (B, N, N) device
// buffers (the factor-only entry's third buffer is its (B, NB, NB)
// scratch), N a multiple of NB; the call enqueues on `stream`, does not
// synchronize, and returns the first cudaGetLastError() that is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NB = 32;        // panel width
constexpr int TILE = 64;      // output tile of the panel and trailing products
constexpr int THREADS = 256;  // 16 x 16 threads; each owns (TM/16) x (TN/16) outputs

// acc[a][b] += sum_k A(r, k) * B(c, k) with r = ty + 16a, c = tx + 16b.
// A(r, k) = A[r*sar + k*sak] for r < M, B(c, k) = Bm[c*sbc + k*sbk] for
// c < Nc, k < K; out-of-range entries read as 0.  K is walked in chunks
// of NB through the shared tiles sa (TM x NB) and sb (TN x NB).
template <typename T, int TM, int TN>
__device__ __forceinline__ void tile_gemm(T (&acc)[TM / 16][TN / 16],
                                          const T* __restrict__ A, long sar, long sak,
                                          const T* __restrict__ Bm, long sbc, long sbk,
                                          int M, int Nc, int K,
                                          T (*sa)[NB + 1], T (*sb)[NB + 1]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += NB) {
    for (int idx = tid; idx < TM * NB; idx += THREADS) {
      const int r = idx / NB, kk = idx % NB;
      sa[r][kk] = (r < M && k0 + kk < K) ? A[r * sar + (long)(k0 + kk) * sak] : T(0);
    }
    for (int idx = tid; idx < TN * NB; idx += THREADS) {
      const int c = idx / NB, kk = idx % NB;
      sb[c][kk] = (c < Nc && k0 + kk < K) ? Bm[c * sbc + (long)(k0 + kk) * sbk] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < NB; ++kk) {
      T a[TM / 16], b[TN / 16];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) a[i] = sa[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) b[j] = sb[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
#pragma unroll
        for (int j = 0; j < TN / 16; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
}

// Where the inverse of the current diagonal tile is kept: instance z's tile
// starts at W + z*batch + j0*(ld + 1) and has row stride ld.  For (L, L^-1)
// that is the tile's own place in the N x N inverse (batch = N*N, ld = N);
// for the factor alone a scratch tile (batch = NB*NB, ld = NB, j0 = 0).
template <typename T>
struct TileW {
  T* W;
  size_t batch;
  int ld;
  int j0;
  __device__ T* tile(int z) const { return W + z * batch + (size_t)j0 * (ld + 1); }
};

// Factor and invert the diagonal tile at (j0, j0); Lkk -> L, Wkk -> tw.
template <typename T>
__global__ void __launch_bounds__(THREADS) diag_kernel(T* L, TileW<T> tw, int N, int j0) {
  __shared__ T s[NB][NB + 1];
  __shared__ T w[NB][NB + 1];
  T* Lb = L + (size_t)blockIdx.z * N * N;
  T* Wt = tw.tile(blockIdx.z);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < NB * NB; idx += THREADS) {
    const int r = idx / NB, c = idx % NB;
    s[r][c] = Lb[(size_t)(j0 + r) * N + j0 + c];
  }
  __syncthreads();
  for (int j = 0; j < NB; ++j) {
    if (tid == 0) {
      const T d = s[j][j];
      s[j][j] = d > T(0) ? sqrt(d) : T(NAN);  // not SPD -> NaN
    }
    __syncthreads();
    const T d = s[j][j];
    for (int r = j + 1 + tid; r < NB; r += THREADS) s[r][j] /= d;
    __syncthreads();
    for (int idx = tid; idx < NB * NB; idx += THREADS) {
      const int r = idx / NB, c = idx % NB;
      if (c > j && r >= c) s[r][c] -= s[r][j] * s[c][j];
    }
    __syncthreads();
  }
  if (tid < NB) {  // column c of Wkk = Lkk^-1 by forward substitution
    const int c = tid;
    for (int r = 0; r < c; ++r) w[r][c] = T(0);
    w[c][c] = T(1) / s[c][c];
    for (int r = c + 1; r < NB; ++r) {
      T acc = T(0);
      for (int q = c; q < r; ++q) acc += s[r][q] * w[q][c];
      w[r][c] = -acc / s[r][r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NB * NB; idx += THREADS) {
    const int r = idx / NB, c = idx % NB;
    Lb[(size_t)(j0 + r) * N + j0 + c] = c <= r ? s[r][c] : T(0);
    Wt[(size_t)r * tw.ld + c] = w[r][c];
  }
}

// L21 = S21 * Wkk^T for the rows below panel j0, in place.  Each CTA reads
// its whole 64 x NB input tile (a single K chunk) before it writes.
template <typename T>
__global__ void __launch_bounds__(THREADS) panel_kernel(T* L, TileW<T> tw, int N, int j0) {
  __shared__ T sa[TILE][NB + 1];
  __shared__ T sb[NB][NB + 1];
  T* Lb = L + (size_t)blockIdx.z * N * N;
  const int r0 = j0 + NB + blockIdx.x * TILE;
  const int M = min(TILE, N - r0);
  T acc[TILE / 16][NB / 16] = {};
  tile_gemm<T, TILE, NB>(acc, Lb + (size_t)r0 * N + j0, N, 1, tw.tile(blockIdx.z), tw.ld, 1,
                         M, NB, NB, sa, sb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TILE / 16; ++i)
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < M) Lb[(size_t)(r0 + r) * N + j0 + c] = acc[i][j];
    }
}

// S22 -= L21 * L21^T on the lower 64 x 64 tiles of the trailing matrix.
template <typename T>
__global__ void __launch_bounds__(THREADS) trailing_kernel(T* L, int N, int j0) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tj > ti) return;
  __shared__ T sa[TILE][NB + 1];
  __shared__ T sb[TILE][NB + 1];
  T* Lb = L + (size_t)blockIdx.z * N * N;
  const int j1 = j0 + NB;
  const int r0 = j1 + ti * TILE, c0 = j1 + tj * TILE;
  const int M = min(TILE, N - r0), Nc = min(TILE, N - c0);
  T acc[TILE / 16][TILE / 16] = {};
  tile_gemm<T, TILE, TILE>(acc, Lb + (size_t)r0 * N + j0, N, 1, Lb + (size_t)c0 * N + j0, N, 1,
                           M, Nc, NB, sa, sb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TILE / 16; ++i)
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < M && c < Nc) Lb[(size_t)(r0 + r) * N + c0 + c] -= acc[i][j];
    }
}

// Block row i of the inverse: CTA k (< i) writes
//   Linv[i,k] = -Wii * sum_{k<=j<i} L[i,j] * Linv[j,k].
// Reads only block rows < i of Linv (written by earlier launches) and the
// diagonal block Wii (written by diag_kernel).
template <typename T>
__global__ void __launch_bounds__(THREADS) inverse_kernel(const T* L, T* W, int N, int i) {
  __shared__ T sa[NB][NB + 1];
  __shared__ T sb[NB][NB + 1];
  const size_t base = (size_t)blockIdx.z * N * N;
  const T* Lb = L + base;
  T* Wb = W + base;
  const int k = blockIdx.x;
  T acc[NB / 16][NB / 16] = {};
  tile_gemm<T, NB, NB>(acc, Lb + (size_t)i * NB * N + k * NB, N, 1,
                       Wb + (size_t)k * NB * N + k * NB, 1, N, NB, NB, (i - k) * NB, sa, sb);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int a = 0; a < NB / 16; ++a)
#pragma unroll
    for (int b = 0; b < NB / 16; ++b) sa[ty + 16 * a][tx + 16 * b] = acc[a][b];
  for (int idx = tid; idx < NB * NB; idx += THREADS) {
    const int r = idx / NB, c = idx % NB;
    sb[r][c] = Wb[(size_t)(i * NB + r) * N + i * NB + c];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NB / 16; ++a)
#pragma unroll
    for (int b = 0; b < NB / 16; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b;
      T s = T(0);
      for (int q = 0; q < NB; ++q) s += sb[r][q] * sa[q][c];
      Wb[(size_t)(i * NB + r) * N + k * NB + c] = -s;
    }
}

// Zero the upper triangle of L and, where there is one, of W.
template <typename T>
__global__ void __launch_bounds__(THREADS) zero_upper_kernel(T* L, T* W, int N) {
  const size_t base = (size_t)blockIdx.z * N * N;
  const size_t nn = (size_t)N * N;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < nn;
       idx += (size_t)gridDim.x * THREADS) {
    if (idx % N > idx / N) {
      L[base + idx] = T(0);
      if (W != nullptr) W[base + idx] = T(0);
    }
  }
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Copy S into L and run the right-looking blocked sweep in place: per panel
// the diagonal tile is factored and inverted, the panel below it becomes
// panel * Wkk^T and the trailing lower triangle is updated.  With
// ``full_inverse`` W is the (B, N, N) inverse and each Wkk lands on its
// diagonal; otherwise W is a (B, NB, NB) scratch tile.
template <typename T>
int factor_sweep(const T* S, T* L, T* W, bool full_inverse, int B, int N, cudaStream_t st) {
  if (B <= 0 || N <= 0 || N % NB != 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemcpyAsync(L, S, (size_t)B * N * N * sizeof(T),
                                        cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  for (int j0 = 0; j0 < N; j0 += NB) {
    const int rows = N - j0 - NB;
    const TileW<T> tw = full_inverse ? TileW<T>{W, (size_t)N * N, N, j0}
                                     : TileW<T>{W, (size_t)NB * NB, NB, 0};
    diag_kernel<T><<<dim3(1, 1, B), THREADS, 0, st>>>(L, tw, N, j0);
    RETURN_IF_ERROR();
    if (rows > 0) {
      const int nt = (rows + TILE - 1) / TILE;
      panel_kernel<T><<<dim3(nt, 1, B), THREADS, 0, st>>>(L, tw, N, j0);
      RETURN_IF_ERROR();
      trailing_kernel<T><<<dim3(nt, nt, B), THREADS, 0, st>>>(L, N, j0);
      RETURN_IF_ERROR();
    }
  }
  return 0;
}

template <typename T>
int zero_upper(T* L, T* W, int B, int N, cudaStream_t st) {
  const size_t nn = (size_t)N * N;
  const int gx = (int)((nn + THREADS - 1) / THREADS < 1024 ? (nn + THREADS - 1) / THREADS : 1024);
  zero_upper_kernel<T><<<dim3(gx, 1, B), THREADS, 0, st>>>(L, W, N);
  RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int chol_inv(const T* S, T* L, T* W, int B, int N, cudaStream_t st) {
  const int rc = factor_sweep<T>(S, L, W, true, B, N, st);
  if (rc != 0) return rc;
  for (int i = 1; i < N / NB; ++i) {
    inverse_kernel<T><<<dim3(i, 1, B), THREADS, 0, st>>>(L, W, N, i);
    RETURN_IF_ERROR();
  }
  return zero_upper<T>(L, W, B, N, st);
}

// L only: the sweep and the zeroed upper triangle.  ``Wtile`` is a
// (B, NB, NB) scratch; no inverse row is computed.
template <typename T>
int cholesky(const T* S, T* L, T* Wtile, int B, int N, cudaStream_t st) {
  const int rc = factor_sweep<T>(S, L, Wtile, false, B, N, st);
  if (rc != 0) return rc;
  return zero_upper<T>(L, static_cast<T*>(nullptr), B, N, st);
}

}  // namespace

extern "C" int madipm_chol_inv_f32(const float* S, float* L, float* W, int B, int N,
                                   void* stream) {
  return chol_inv<float>(S, L, W, B, N, static_cast<cudaStream_t>(stream));
}

extern "C" int madipm_chol_inv_f64(const double* S, double* L, double* W, int B, int N,
                                   void* stream) {
  return chol_inv<double>(S, L, W, B, N, static_cast<cudaStream_t>(stream));
}

extern "C" int madipm_cholesky_f32(const float* S, float* L, float* Wtile, int B, int N,
                                   void* stream) {
  return cholesky<float>(S, L, Wtile, B, N, static_cast<cudaStream_t>(stream));
}

extern "C" int madipm_cholesky_f64(const double* S, double* L, double* Wtile, int B, int N,
                                   void* stream) {
  return cholesky<double>(S, L, Wtile, B, N, static_cast<cudaStream_t>(stream));
}
