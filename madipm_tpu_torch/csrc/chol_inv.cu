// Cholesky factors of a stack of SPD matrices, hand-written for Hopper
// (sm_90a).  Two entry points, one persistent kernel:
//
//   madipm_chol_inv_*  (L, L^-1).  Replaces
//     madipm_tpu/ops/pallas_chol.py::pallas_chol_inv (kernel body
//     _chol_inv_kernel + _factor_sweep): the factor of the Jacobi-scaled
//     normal (NORMAL) or condensed (CONDENSED) matrix that the CHOLESKY_INV
//     path computes on every IPM iteration (ops/kkt.py factorize).
//   madipm_cholesky_*  L only.  Replaces
//     madipm_tpu/ops/pallas_chol.py::pallas_cholesky (kernel body
//     _chol_kernel + _factor_sweep): the factor the CHOLESKY path takes
//     with use_pallas=True.  The same kernel without its inverse phase; the
//     inverted diagonal tiles that the panel products need go to a
//     (B, N/32, 32, 32) scratch instead of the diagonal of L^-1.
//
// Output semantics are the TPU kernels': L lower (and Linv = L^-1 lower),
// upper triangle zero; a pivot <= 0 (S not SPD) turns into NaN, which
// propagates through that instance alone and trips the x100
// regularization retry (ops/linalg.cholesky_is_ok).  The L of the two
// entry points is the same code on the same sums: bit-identical.
//
// What bounds them on this card.  Per instance the factor costs N^3/3
// flops and the triangular inverse another N^3/3, against 2 (or 3) N^2
// words that must move: compute-bound on paper.  In fact the factor is a
// dependency chain of N/32 diagonal tiles, and what a design loses is the
// time between two links of that chain.  A host loop of launches (three
// per panel, one per block row of the inverse) pays a dispatch at every
// link and leaves 124 of 132 SMs idle while one CTA per instance factors a
// diagonal tile.  The TPU kernel had no dispatch between panel steps; this
// one has none either.
//
// The design.
//   - One cooperative launch per call (after a memset of the counters).  A
//     group of G CTAs of 4 warps works on one instance; the grid holds as
//     many groups as fit on the card at two CTAs per SM (264 CTAs on an
//     H100: a block row each for 8 instances of N = 1024), and each group
//     walks over its instances b = group, group + groups, ... (waves inside
//     the kernel).  G, the number of groups and the shared-memory size are
//     decided by ops/chol_inv.plan and passed in.
//   - Left-looking by 32 x 32 tiles, each tile of L written once.  CTA g of
//     a group owns block rows g, g + G, ... and takes them in increasing
//     order.  For tile (i, j) it forms acc = S_ij - sum_{k<j} L_ik L_jk^T,
//     then L_ij = acc W_jj^T, or on the diagonal factors acc and inverts it
//     to W_ii.  S is read once, L written once, the upper triangle of block
//     row i is written as zeros by the row's owner before anything else: no
//     copy of S, no trailing matrix rewritten, no zeroing pass.
//   - A written tile never changes, so the only dependency is "block row j
//     is complete up to column c": one monotone int32 counter per
//     (instance, block row).  Producer: write, barrier, then one thread's
//     __threadfence and st.release.  Consumer: ld.acquire, then cp.async.cg
//     (L2, never L1).  A row waits only on lower rows, rows are taken in
//     increasing order and every CTA is resident (cooperative launch), so
//     no wait can deadlock.  NaN is data: no loop waits on a value.
//   - Nothing of depth ~N on the chain.  Tile (i, j) cannot be finished
//     before W_jj exists, and W_jj ends step j of the chain of diagonal
//     tiles.  While a CTA would wait for W_jj it forms the NEXT tile's sum
//     but for its last term (every operand of it exists already), and adds
//     that last term from shared memory once L_ij is written.  From one
//     diagonal tile to the next the chain is: W load, one 32-deep product,
//     one 32-deep update, the factor in registers.
//   - The products: the depth of a tile's sum is split over the CTA's 4
//     warps in units of 128 bytes; each warp brings its units into its own
//     two-stage shared-memory ring with cp.async (loads overlap arithmetic,
//     only __syncwarp inside the loop) and holds the whole 32 x 32 tile in
//     32 accumulators per lane.  fp32: register-tiled FMA, 16-byte shared
//     loads, 12 loads per 128 FMAs (wgmma takes no fp32, and TF32 stays off
//     in the factor path).  fp64: the tensor cores' mma.sync m16n8k16.  The 4
//     partial tiles are summed in a fixed order through shared memory.  The
//     unit-to-warp map depends on nothing but the tile, so the result does
//     not depend on the geometry.
//   - The diagonal tile by one warp in registers: lane r holds row r of the
//     tile and column r of its inverse; a column step is one shuffle (the
//     pivot), rsqrt, a multiply, and the column broadcast back through 64
//     elements of shared memory; the same entries drive the inverse's
//     forward substitution.  No __syncthreads, no --use_fast_math.
//   - The inverse inside the same kernel: Linv[i,k] = -W_ii sum_{k<=j<i}
//     L[i,j] Linv[j,k] has no dependency between block columns, so CTA g
//     owns block columns g, g + G, ... and walks each down the block rows as
//     their counters complete.  Heavy columns (small k) fall to the CTAs
//     with the light rows (small i), which balances the two phases.
//
// Plain C interface for ctypes: pointers to contiguous (B, N, N) device
// buffers, an int32 scratch of B * N/32 counters (and for the factor-only
// entry its (B, N/32, 32, 32) tile scratch), N a multiple of 32, the
// geometry from ops/chol_inv.plan.  The call enqueues a memset and one
// kernel on `stream`, allocates nothing, does not synchronize, and returns
// the first CUDA error that is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NB = 32;             // tile edge
constexpr int WARPS = 4;           // warps of a CTA; the depth of a sum is split over them
constexpr int THREADS = 32 * WARPS;
constexpr int CTAS_PER_SM = 2;     // what the registers and the shared memory are sized for
constexpr int LDT = NB + 4;        // row stride of the small shared tiles (rows 16-byte aligned)
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory geometry by element type.  ops/chol_inv.smem_bytes repeats
// SMEM; the entry points refuse a call that passes less.
template <typename T>
struct Geo {
  static constexpr int V = 16 / (int)sizeof(T);    // elements of a 16-byte load
  static constexpr int KC = 128 / (int)sizeof(T);  // depth of one unit of a sum
  static constexpr int LDA = KC + 4;   // row stride of A [NB][KC] and of B^T [NB][KC]
  static constexpr int LDB = NB + 4;   // row stride of B [KC][NB] (inverse phase)
  static constexpr int LDR = NB + 4;   // row stride of a warp's partial tile
  static constexpr int STAGE = 2 * NB * LDA;  // one stage of a warp's ring: A, then B
  static constexpr int WARP_ELEMS = 2 * STAGE;
  static constexpr size_t SMEM = (size_t)(WARPS * WARP_ELEMS + 3 * NB * LDT) * sizeof(T);
  static_assert(KC * LDB <= NB * LDA, "B [KC][NB] must fit the stage's second half");
  static_assert(NB * LDR <= WARP_ELEMS, "a partial tile must fit its warp's ring");
  static_assert(NB * LDT <= WARP_ELEMS && WARPS >= 2, "two small tiles must fit the ring");
};

template <typename T>
struct alignas(16) Vec {
  T e[16 / sizeof(T)];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One thread waits until the counter has reached `need`.
__device__ __forceinline__ void spin_until(const int* p, int need) {
  while (ld_acquire(p) < need) __nanosleep(40);
}

// D(16x8) += A(16x16) B(16x8) in fp64 on the tensor cores (sm_90's largest
// fp64 shape).  Lane (ry, cx) = (lane / 4, lane % 4) gives a[v0 + 2 v1] =
// A[ry + 8 v0][cx + 4 v1] and b[v] = B[cx + 4 v][ry], and holds
// d[v0 + 2 v1] = D[ry + 8 v1][2 cx + v0].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double& d2, double& d3,
                                        const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Column of the tile that accumulator b of lane column-group cx holds:
// fp64 as the tensor cores lay D out (two adjacent columns of every eight);
// fp32 so that the lane's 16-byte loads of B fall on distinct banks.
template <typename T, bool TRANSB>
__device__ __forceinline__ int acc_col(int cx, int b) {
  if (sizeof(T) == 8) return 2 * cx + 8 * (b / 2) + b % 2;
  return TRANSB ? cx + 4 * b : 4 * cx + 16 * (b / 4) + b % 4;
}

// Start the copies of one unit into a stage: A is NB rows of KC elements;
// B is NB rows of KC (TRANSB: the factor's L_jk, used as its transpose) or
// KC rows of NB (the inverse's Linv rows).  `ld` is the row stride of both.
template <typename T, bool TRANSB>
__device__ __forceinline__ void load_unit(T* buf, const T* A, const T* Bm, size_t ld, int lane) {
  using G = Geo<T>;
  T* sA = buf;
  T* sB = buf + NB * G::LDA;
  constexpr int SEGA = G::KC / G::V;
  for (int idx = lane; idx < NB * SEGA; idx += 32) {
    const int r = idx / SEGA, s = idx % SEGA;
    cp_async16(sA + r * G::LDA + s * G::V, A + r * ld + s * G::V);
  }
  if (TRANSB) {
    for (int idx = lane; idx < NB * SEGA; idx += 32) {
      const int r = idx / SEGA, s = idx % SEGA;
      cp_async16(sB + r * G::LDA + s * G::V, Bm + r * ld + s * G::V);
    }
  } else {
    constexpr int SEGB = NB / G::V;
    for (int idx = lane; idx < G::KC * SEGB; idx += 32) {
      const int r = idx / SEGB, s = idx % SEGB;
      cp_async16(sB + r * G::LDB + s * G::V, Bm + r * ld + s * G::V);
    }
  }
  cp_async_commit();
}

// acc += A_u * B_u^T (TRANSB) or A_u * B_u for one unit in shared memory.
// Lane (ry, cx) holds rows ry + 8a and the columns acc_col(cx, b).
// fp32: register-tiled FMA, 12 16-byte loads for 128 FMAs.
template <bool TRANSB>
__device__ __forceinline__ void compute_unit(float (&acc)[4][8], const float* buf, int ry, int cx) {
  using G = Geo<float>;
  const float* sA = buf;
  const float* sB = buf + NB * G::LDA;
#pragma unroll
  for (int k = 0; k < G::KC; k += 4) {
    Vec<float> av[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = *reinterpret_cast<const Vec<float>*>(sA + (ry + 8 * a) * G::LDA + k);
    if (TRANSB) {
      Vec<float> bv[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) bv[b] = *reinterpret_cast<const Vec<float>*>(sB + (cx + 4 * b) * G::LDA + k);
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a].e[v], bv[b].e[v], acc[a][b]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        Vec<float> bv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bv[h] = *reinterpret_cast<const Vec<float>*>(sB + (k + v) * G::LDB + 4 * cx + 16 * h);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a].e[v], bv[b / 4].e[b % 4], acc[a][b]);
      }
    }
  }
}

// fp64: one unit is one step of mma.sync m16n8k16 for each of the tile's
// 2 x 4 subtiles, the fragments straight from shared memory.
template <bool TRANSB>
__device__ __forceinline__ void compute_unit(double (&acc)[4][8], const double* buf, int ry, int cx) {
  using G = Geo<double>;
  static_assert(G::KC == 16, "one m16n8k16 step per unit");
  const double* sA = buf;
  const double* sB = buf + NB * G::LDA;
  double fa[2][8], fb[4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int v = 0; v < 8; ++v) fa[mt][v] = sA[(16 * mt + ry + 8 * (v & 1)) * G::LDA + cx + 4 * (v >> 1)];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      fb[nt][v] = TRANSB ? sB[(8 * nt + ry) * G::LDA + cx + 4 * v] : sB[(cx + 4 * v) * G::LDB + 8 * nt + ry];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_f64(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1], acc[2 * mt + 1][2 * nt],
              acc[2 * mt + 1][2 * nt + 1], fa[mt], fb[nt]);
}

// This warp's share of a 32 x 32 product of depth nunits * KC: units
// u = warp, warp + WARPS, ... through the warp's own two-stage ring, then
// the partial tile into the ring's place for the CTA to sum.  A points at
// the tile row's first column of the sum, Bm at the other operand's (rows
// of L for TRANSB, rows of Linv otherwise).  With `flag`, unit u of B may be
// read only once *flag > (u * KC) / NB (block row complete up to that tile).
template <typename T, bool TRANSB>
__device__ __forceinline__ void warp_product(const T* A, const T* Bm, size_t ld, int nunits,
                                             const int* flag, T* wbuf, int warp, int lane) {
  using G = Geo<T>;
  if (warp >= nunits) return;
  const int ry = lane >> 2, cx = lane & 3;
  T acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = T(0);
  int seen = flag ? 0 : (1 << 30);  // the counter's last value read (uniform over the warp)
  auto unit_b = [&](int u) {
    return TRANSB ? Bm + (size_t)u * G::KC : Bm + (size_t)u * G::KC * ld;
  };
  auto refresh = [&]() {
    int v = 0;
    if (lane == 0) v = ld_acquire(flag);
    seen = __shfl_sync(FULL, v, 0);
    __syncwarp();
  };
  auto wait_for = [&](int u) {
    const int need = (u * G::KC) / NB + 1;
    if (seen >= need) return;
    if (lane == 0) spin_until(flag, need);
    __syncwarp();
    refresh();
  };
  int u = warp, stage = 0;
  wait_for(u);
  load_unit<T, TRANSB>(wbuf, A + (size_t)u * G::KC, unit_b(u), ld, lane);
  for (; u < nunits; u += WARPS, stage ^= 1) {
    const int un = u + WARPS;
    bool ahead = false;
    if (un < nunits) {
      const int need = (un * G::KC) / NB + 1;
      if (seen < need) refresh();
      if (seen >= need) {
        load_unit<T, TRANSB>(wbuf + (stage ^ 1) * G::STAGE, A + (size_t)un * G::KC, unit_b(un), ld, lane);
        ahead = true;
      }
    }
    if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();
    compute_unit<TRANSB>(acc, wbuf + stage * G::STAGE, ry, cx);
    __syncwarp();
    if (un < nunits && !ahead) {
      wait_for(un);
      load_unit<T, TRANSB>(wbuf + (stage ^ 1) * G::STAGE, A + (size_t)un * G::KC, unit_b(un), ld, lane);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) wbuf[(ry + 8 * a) * G::LDR + acc_col<T, TRANSB>(cx, b)] = acc[a][b];
}

constexpr int PER_THREAD = NB * NB / THREADS;  // elements of a tile each thread handles

// Start the copy of the 32 x 32 tile at `src` (row stride ld) into a small
// shared tile, through L2 (the tile may be another CTA's, written during
// this kernel).  The caller commits the group.
template <typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, size_t ld, int tid) {
  constexpr int V = Geo<T>::V, SEGS = NB / V;
  for (int idx = tid; idx < NB * SEGS; idx += THREADS) {
    const int r = idx / SEGS, sg = idx % SEGS;
    cp_async16(dst + r * LDT + sg * V, src + r * ld + sg * V);
  }
}

// dst = (FROM_DST ? dst : 0) - sum of the warps' partial tiles, in a fixed
// order; each thread its own elements.
template <typename T, bool FROM_DST>
__device__ __forceinline__ void reduce_partials(T* dst, const T* ring, int nunits, int tid) {
  using G = Geo<T>;
  const int nw = nunits < WARPS ? nunits : WARPS;
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    const int e = tid + m * THREADS;
    const int r = e / NB, c = e % NB;
    T s = FROM_DST ? dst[r * LDT + c] : T(0);
    for (int w = 0; w < nw; ++w) s -= ring[w * G::WARP_ELEMS + r * G::LDR + c];
    dst[r * LDT + c] = s;
  }
}

// One warp, in registers: sD (the updated diagonal tile) becomes L_ii, lower
// with zeros above, and sW its inverse W_ii.  Lane r holds row r of the
// factor and column r of the inverse.  Column step c: the pivot by one
// shuffle, rs = 1/sqrt(pivot) by rsqrt() (the library's full-precision
// function, as the TPU kernel's rsqrt: the chain of a step is shuffle,
// rsqrt, multiply, not shuffle, sqrt, divide), column c through `col`
// (2 x NB elements of shared memory, broadcast back by 16-byte loads), and
// the same entries drive both the trailing update and the forward
// substitution of W (axpy form), so the two dependency chains interleave
// in one instruction stream.  A pivot <= 0 gives NaN.
template <typename T>
__device__ __forceinline__ void diag_tile(T* sD, T* sW, T* col, int lane) {
  constexpr int V = Geo<T>::V;
  T a[NB], w[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    a[c] = sD[lane * LDT + c];
    w[c] = c == lane ? T(1) : T(0);
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const T d = __shfl_sync(FULL, a[c], c);
    const T rs = d > T(0) ? rsqrt(d) : T(NAN);
    a[c] *= rs;  // lane c: sqrt(d); lanes below: L[lane][c]
    w[c] *= rs;
    if (c + 1 < NB) {
      T* cb = col + (c & 1) * NB;
      cb[lane] = a[c];
      __syncwarp();
      T l[NB];
#pragma unroll
      for (int h = (c + 1) / V; h < NB / V; ++h) {
        const Vec<T> v = *reinterpret_cast<const Vec<T>*>(cb + h * V);
#pragma unroll
        for (int e = 0; e < V; ++e) l[h * V + e] = v.e[e];
      }
#pragma unroll
      for (int c2 = c + 1; c2 < NB; ++c2) {  // l[c2] = L[c2][c]
        a[c2] = fma(-a[c], l[c2], a[c2]);
        w[c2] = fma(-l[c2], w[c], w[c2]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    sD[lane * LDT + c] = c <= lane ? a[c] : T(0);
    sW[c * LDT + lane] = lane <= c ? w[c] : T(0);
  }
}

// out = X * Y^T (YT) or X * Y for two 32 x 32 shared tiles, each thread
// eight outputs of one row, to global memory at `out` (row stride ld) and,
// where `keep` is given, to that shared tile as well.
template <typename T, bool YT>
__device__ __forceinline__ void small_product(T* out, size_t ld, T* keep, const T* X, const T* Y, int tid) {
  constexpr int PER_ROW = THREADS / NB, OUTS = NB / PER_ROW;
  const int r = tid / PER_ROW, c0 = tid % PER_ROW;
  T s[OUTS];
#pragma unroll
  for (int m = 0; m < OUTS; ++m) s[m] = T(0);
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const T x = X[r * LDT + q];
#pragma unroll
    for (int m = 0; m < OUTS; ++m) {
      const int c = c0 + PER_ROW * m;
      s[m] = fma(x, YT ? Y[c * LDT + q] : Y[q * LDT + c], s[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < OUTS; ++m) {
    out[r * ld + c0 + PER_ROW * m] = s[m];
    if (keep) keep[r * LDT + c0 + PER_ROW * m] = s[m];
  }
}

// D -= X * Y^T for 32 x 32 shared tiles: the last term of a tile's sum,
// from the tile of this row just written (X) and its counterpart in the
// other operand's row (Y; X itself for the diagonal tile).
template <typename T>
__device__ __forceinline__ void small_update(T* D, const T* X, const T* Y, int tid) {
  constexpr int PER_ROW = THREADS / NB, OUTS = NB / PER_ROW;
  const int r = tid / PER_ROW, c0 = tid % PER_ROW;
  T s[OUTS];
#pragma unroll
  for (int m = 0; m < OUTS; ++m) s[m] = D[r * LDT + c0 + PER_ROW * m];
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const T x = X[r * LDT + q];
#pragma unroll
    for (int m = 0; m < OUTS; ++m) s[m] = fma(-x, Y[(c0 + PER_ROW * m) * LDT + q], s[m]);
  }
#pragma unroll
  for (int m = 0; m < OUTS; ++m) D[r * LDT + c0 + PER_ROW * m] = s[m];
}

template <typename T>
__device__ __forceinline__ void store_tile(T* dst, size_t ld, const T* src, int tid) {
  for (int e = tid; e < NB * NB; e += THREADS) dst[(e / NB) * ld + e % NB] = src[(e / NB) * LDT + e % NB];
}

// A warp learns whether the counter has reached `need` (one L2 read).
__device__ __forceinline__ bool warp_sees(const int* p, int need, int lane) {
  int ok = 0;
  if (lane == 0) ok = ld_acquire(p) >= need;
  ok = __shfl_sync(FULL, ok, 0);
  __syncwarp();
  return ok != 0;
}

// A warp waits until the counter has reached `need`.
__device__ __forceinline__ void warp_waits(const int* p, int need, int lane) {
  if (lane == 0) spin_until(p, need);
  __syncwarp();
}

// After a barrier that follows the CTA's global writes: publish them.
__device__ __forceinline__ void publish(int* p, int v, int tid) {
  if (tid == 0) {
    __threadfence();
    st_release(p, v);
  }
}

// Where the inverse of diagonal tile i lives: on the diagonal of Linv
// (INV), or in the (N/32, 32, 32) scratch of this instance.
template <typename T, bool INV>
__device__ __forceinline__ T* wtile(T* Wb, int N, int i, size_t* ld) {
  if (INV) {
    *ld = N;
    return Wb + (size_t)i * NB * N + (size_t)i * NB;
  }
  *ld = NB;
  return Wb + (size_t)i * NB * NB;
}

// The small shared tiles of a CTA.  `last` and `other` lie in the ring,
// which is idle between a tile's sum and the next tile's.
template <typename T>
struct Tiles {
  T* acc;    // the tile in work: S_ij minus its sum, before the product with W_jj^T
  T* next;   // the tile after it, its sum under way
  T* w;      // an inverted diagonal tile
  T* last;   // L_ij just written, for the next tile's last term
  T* other;  // L_{j+1,j}, the other factor of that term
};

// Block row i of L: tiles (i, 0..i-1) left to right, then the diagonal
// tile and the zeros right of it (in Linv too, for INV).  Tile (i, j)
// cannot be finished before W_jj exists, and W_jj is the end of the
// chain's step j.  So while the CTA would wait for W_jj it forms the next
// tile's sum but for its last term, S_{i,j+1} - sum_{k<j} L_ik L_{j+1,k}^T
// (block row j+1 is ahead of block row i, or is block row i itself), and
// that last term, which needs the L_ij in work, comes from shared memory
// once L_ij is written.  From one diagonal tile to the next the chain is
// then: W load, one 32-deep product, one 32-deep update, the factor in
// registers; every sum of depth ~N runs beside it.
template <typename T, bool INV>
__device__ void factor_row(const T* Sb, T* Lb, T* Wb, int* cnt, int N, int i, T* ring, Tiles<T> t) {
  using G = Geo<T>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ld = N;
  constexpr int UPT = NB / G::KC;  // units per tile of depth
  T* rowL = Lb + (size_t)i * NB * ld;
  const T* rowS = Sb + (size_t)i * NB * ld;
  T* wring = ring + warp * G::WARP_ELEMS;
  size_t ldw;
  T* acc = t.acc;
  T* next = t.next;
  tile_async<T>(acc, rowS, ld, tid);  // S_i0; waited for with the first group below
  cp_async_commit();
  {  // the zeros of block row i right of the diagonal tile: off the chain, so first
    const int segs = (N - (i + 1) * NB) / G::V;
    Vec<T> z;
#pragma unroll
    for (int v = 0; v < G::V; ++v) z.e[v] = T(0);
    for (int idx = tid; idx < NB * segs; idx += THREADS) {
      const size_t off = (size_t)(i * NB + idx / segs) * ld + (size_t)(i + 1) * NB + (idx % segs) * G::V;
      *reinterpret_cast<Vec<T>*>(Lb + off) = z;
      if (INV) *reinterpret_cast<Vec<T>*>(Wb + off) = z;
    }
  }
  for (int j = 0; j < i; ++j) {
    const bool diag_next = j + 1 == i;
    const T* rowB = Lb + (size_t)(j + 1) * NB * ld;  // block row j+1
    // S_{i,j+1}, and W_jj if it is there already, arrive while the sum runs
    tile_async<T>(next, rowS + (size_t)(j + 1) * NB, ld, tid);
    const T* wt = wtile<T, INV>(Wb, N, j, &ldw);
    const bool have_w = warp_sees(cnt + j, j + 1, lane);
    if (have_w) tile_async<T>(t.w, wt, ldw, tid);
    cp_async_commit();
    warp_product<T, true>(rowL, rowB, ld, j * UPT, diag_next ? nullptr : cnt + j + 1, wring, warp, lane);
    cp_async_wait<0>();
    __syncthreads();
    reduce_partials<T, true>(next, ring, j * UPT, tid);
    if (!have_w) {
      warp_waits(cnt + j, j + 1, lane);
      tile_async<T>(t.w, wt, ldw, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    small_product<T, true>(rowL + (size_t)j * NB, ld, t.last, acc, t.w, tid);  // L_ij = acc W_jj^T
    __syncthreads();
    publish(cnt + i, j + 1, tid);
    const T* other = t.last;
    if (!diag_next) {
      warp_waits(cnt + j + 1, j + 1, lane);  // L_{j+1,j} is written
      tile_async<T>(t.other, rowB + (size_t)j * NB, ld, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      other = t.other;
    }
    small_update<T>(next, t.last, other, tid);
    __syncthreads();
    T* swap = acc;
    acc = next;
    next = swap;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) diag_tile<T>(acc, t.w, next, lane);
  __syncthreads();
  store_tile<T>(rowL + (size_t)i * NB, ld, acc, tid);
  T* wt = wtile<T, INV>(Wb, N, i, &ldw);
  store_tile<T>(wt, ldw, t.w, tid);
  __syncthreads();
  publish(cnt + i, i + 1, tid);
}

// Block column k of Linv below its diagonal tile, block row by block row:
// Linv[i,k] = -W_ii * sum_{k<=j<i} L[i,j] Linv[j,k].  Every Linv tile it
// reads is this CTA's own, but for tile (k, k).
template <typename T>
__device__ void inverse_column(const T* Lb, T* Wb, const int* cnt, int N, int k, T* ring, Tiles<T> t) {
  using G = Geo<T>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ld = N;
  const int nb = N / NB;
  constexpr int UPT = NB / G::KC;
  T* colW = Wb + (size_t)k * NB * ld + (size_t)k * NB;  // tile (k, k) of Linv
  T* wring = ring + warp * G::WARP_ELEMS;
  warp_waits(cnt + k, k + 1, lane);
  for (int i = k + 1; i < nb; ++i) {
    warp_waits(cnt + i, i + 1, lane);  // block row i of L and W_ii are written
    tile_async<T>(t.w, Wb + (size_t)i * NB * ld + (size_t)i * NB, ld, tid);
    cp_async_commit();
    warp_product<T, false>(Lb + (size_t)i * NB * ld + (size_t)k * NB, colW, ld, (i - k) * UPT, nullptr,
                           wring, warp, lane);
    cp_async_wait<0>();
    __syncthreads();
    reduce_partials<T, false>(t.acc, ring, (i - k) * UPT, tid);  // minus the sum
    __syncthreads();
    small_product<T, false>(colW + (size_t)(i - k) * NB * ld, ld, nullptr, t.w, t.acc, tid);
    __syncthreads();  // the next block row reads this tile
  }
}

template <typename T, bool INV>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
chol_kernel(const T* S, T* L, T* W, int* counters, int B, int N, int G, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* tiles = ring + WARPS * Geo<T>::WARP_ELEMS;
  const Tiles<T> t = {tiles, tiles + NB * LDT, tiles + 2 * NB * LDT, ring, ring + Geo<T>::WARP_ELEMS};
  const int nb = N / NB;
  const int group = blockIdx.x / G, g = blockIdx.x % G;
  const size_t nn = (size_t)N * N;
  for (int b = group; b < B; b += groups) {
    const T* Sb = S + b * nn;
    T* Lb = L + b * nn;
    T* Wb = INV ? W + b * nn : W + (size_t)b * nb * NB * NB;
    int* cnt = counters + (size_t)b * nb;
    for (int i = g; i < nb; i += G) factor_row<T, INV>(Sb, Lb, Wb, cnt, N, i, ring, t);
    if (INV)
      for (int k = g; k < nb - 1; k += G) inverse_column<T>(Lb, Wb, cnt, N, k, ring, t);
  }
}

// What a device allows one instantiation: set and read once per device.
struct Limits {
  bool known;
  int resident;  // CTAs of this kernel the device holds at once
  int smem;      // dynamic shared memory the attribute was set to
};

template <typename T, bool INV>
int run(const T* S, T* L, T* W, int* counters, int B, int N, int G, int groups, int smem,
        cudaStream_t st) {
  if (B <= 0 || N <= 0 || N % NB != 0 || G <= 0 || G > N / NB || groups <= 0 || groups > B ||
      (size_t)smem < Geo<T>::SMEM)
    return (int)cudaErrorInvalidValue;
  static Limits limits[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  auto kern = chol_kernel<T, INV>;
  Limits& lim = limits[dev];
  if (!lim.known || lim.smem != smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    lim.known = true;
    lim.resident = per_sm * sms;
    lim.smem = smem;
  }
  // a CTA spins on counters that other CTAs set: all of them must be resident
  if ((long)G * groups > lim.resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(counters, 0, (size_t)B * (N / NB) * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&S, (void*)&L, (void*)&W, (void*)&counters,
                  (void*)&B, (void*)&N, (void*)&G, (void*)&groups};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(G * groups), dim3(THREADS), args, (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#define MADIPM_ENTRY(name, T, INV)                                                          \
  extern "C" int name(const T* S, T* L, T* W, int* counters, int B, int N, int G,           \
                      int groups, int smem, void* stream) {                                 \
    return run<T, INV>(S, L, W, counters, B, N, G, groups, smem,                            \
                       static_cast<cudaStream_t>(stream));                                  \
  }

// (L, L^-1): W is the (B, N, N) inverse.
MADIPM_ENTRY(madipm_chol_inv_f32, float, true)
MADIPM_ENTRY(madipm_chol_inv_f64, double, true)
// L only: W is the (B, N/32, 32, 32) scratch of inverted diagonal tiles.
MADIPM_ENTRY(madipm_cholesky_f32, float, false)
MADIPM_ENTRY(madipm_cholesky_f64, double, false)
