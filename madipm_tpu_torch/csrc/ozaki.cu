// The Ozaki fp64 operator's slice-pair contraction, hand-written for
// Hopper (sm_90a).  One templated kernel, four entry points:
//
//   madipm_ozaki_bf16_fwd  y = A x   from bf16 slices.  Replaces the XLA
//     dot_general of madipm_tpu/ops/ozaki.py:153 (_pair_block, matvec).
//   madipm_ozaki_bf16_t    y = A' v  from the same forward slices.
//     Replaces madipm_tpu/ops/ozaki.py:312 (matvec_t).
//   madipm_ozaki_i8_fwd    y = A x   from int8 slices.  Replaces
//     madipm_tpu/ops/ozaki.py:279 (matvec_i8).
//   madipm_ozaki_i8_t      y = A' v  from the forward int8 slices.
//     Replaces madipm_tpu/ops/ozaki.py:336 (matvec_t_i8).
// None of them had a Pallas ancestor: on the TPU they were XLA dots.
//
// What it computes.  A (B, m, n) is stored as S slices (B, S, m, n), bf16
// values on the fixed-point grids 2^-8(s+1) or int8 integers of weight
// 2^-7(s+1); the vector comes as its own slices (B, 8, K), K = n forward
// and m transposed, zero past the T = S slices it has.  Each slice pair
// (s, t) is contracted exactly: a bf16 product is an integer below 2^16
// on the pair's grid, so 128 of them (one CHUNK) sum below 2^23 in the
// fp32 accumulator; an int8 product is below 2^12, so the int32 sum stays
// exact for K < 2^19.  Every (s, t) keeps its own accumulator: the slice
// index s is a register array, and t is the n8 column of an mma.sync
// fragment.  The bf16 accumulators are flushed into fp64 registers after
// every 128-deep chunk; the int8 ones once, with the weight 2^-7(s+t+2).
// All rounding is in that fp64 sum.  The epilogue applies the vector's
// scale and, forward, the row scale: out = rs[i] * (vscale * y).  The
// (C, S, m, T) partials of the TPU version never reach device memory.
//
// What bounds it on this card: bytes.  Each call reads the slices once,
// S m n bytes (int8) or 2 S m n (bf16) per instance, and does 2 S 8 m n
// tensor-core operations: about 16 (int8) or 8 (bf16) per byte, far below
// the H100's ~590 int8 and ~295 bf16 operations per byte of device
// memory.  So the design's one job is to stream the slices at full
// bandwidth:
//   - Every slice element is loaded once, straight from device memory
//     into the registers that feed mma.sync (no shared-memory stage): a
//     contraction does not care in which order its terms come, so the
//     k-positions of a fragment are mapped to the bytes a lane loads
//     contiguously, and the vector's fragment uses the same map.
//     Forward, a lane loads 16 bytes of two rows (the rows' 4 lanes read
//     64 contiguous bytes).  Transposed (the contraction runs down the
//     rows of a row-major slice, and int8 mma.sync takes only row.col), a
//     lane loads 4 columns of 4 rows (int8) or 2 rows (bf16) and
//     transposes them in registers with byte permutes (prmt); 8 lanes read
//     32 or 64 contiguous bytes of each row.
//   - A CTA of 4 warps owns 16 output rows (forward) or 32 columns
//     (transposed) of one instance; its warps take the 128-deep chunks of
//     the contraction in turn and add their fp64 partials through shared
//     memory in a fixed order.  At (8, 1024, 2048) that is 512 CTAs, 2048
//     warps over 132 SMs, each warp with S loads of 1 KB per step in
//     flight.
//   - The vector's slices (8 K elements per instance) are read by every
//     CTA of the instance and stay in L1/L2.
// The result does not depend on the launch: the chunk-to-warp map and
// every sum's order are fixed.
//
// Plain C interface for ctypes: contiguous device buffers, slices
// (B, S, m, n), row_scale (B, m) fp64 (forward only; NULL transposed),
// the vector's slices (B, 8, K), its scale (B,) fp64, out (B, m) or
// (B, n) fp64; m and n multiples of 128, 1 <= S <= 8.  The call enqueues
// one kernel on `stream`, allocates nothing, does not synchronize, and
// returns the CUDA error of the launch (0 when it was accepted).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;   // contraction depth between fp64 flushes (bf16 exactness)
constexpr int VSLICES = 8;   // rows of the vector's slices: the n8 of a fragment
constexpr int MAX_S = 8;

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T ld(const uint8_t* p) {
  return __ldg(reinterpret_cast<const T*>(p));
}

__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t sel) {
  return __byte_perm(x, y, sel);
}

// Element c (0..3) of two rows' 4-element words, packed as (row a, row b):
// bf16 pairs along the contraction for m16n8k16's A fragment.
__device__ __forceinline__ uint32_t pair16(uint2 a, uint2 b, int c) {
  const uint32_t x = c < 2 ? a.x : a.y, y = c < 2 ? b.x : b.y;
  return prmt(x, y, (c & 1) ? 0x7632 : 0x5410);
}

// 4 x 4 byte transpose: out[c] holds byte c of r0..r3, in that order.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t lo01 = prmt(r[0], r[1], 0x5140), hi01 = prmt(r[0], r[1], 0x7362);
  const uint32_t lo23 = prmt(r[2], r[3], 0x5140), hi23 = prmt(r[2], r[3], 0x7362);
  out[0] = prmt(lo01, lo23, 0x5410);
  out[1] = prmt(lo01, lo23, 0x7632);
  out[2] = prmt(hi01, hi23, 0x5410);
  out[3] = prmt(hi01, hi23, 0x7632);
}

template <bool I8, bool TRANS, int S>
struct Shape {
  static constexpr int ESZ = I8 ? 1 : 2;          // bytes of one element
  static constexpr int TILE = TRANS ? 32 : 16;    // outputs of a CTA
  static constexpr int NT = TRANS ? 2 : 1;        // m16n8 tiles of a warp
  static constexpr int R = TRANS ? 4 : 2;         // outputs of a lane
  // contraction depth of one step: forward two k-steps of 16-byte row
  // loads, transposed one k-step
  static constexpr int STEP = TRANS ? (I8 ? 32 : 16) : (I8 ? 64 : 32);
  static_assert(S >= 1 && S <= MAX_S, "1 <= S <= 8");
  static_assert(CHUNK % STEP == 0, "a chunk is whole steps");
};

// Add the lane's exact partials into its fp64 outputs and clear them.
// Register i of tile u holds output r = 2u + i/2 of the lane (forward:
// rows g, g + 8; transposed: columns 4g .. 4g + 3) and vector slice
// t = 2q + i%2; int8 partials carry the weight 2^-7(s+t+2).
template <bool I8, int S, int NT, int R, typename Acc>
__device__ __forceinline__ void flush(Acc (&acc)[S][NT][4], double (&acc64)[R], int q) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double v = (double)acc[s][u][i];
        if constexpr (I8) v = ldexp(v, -7 * (s + 2 * q + (i & 1) + 2));
        acc64[2 * u + (i >> 1)] += v;
        acc[s][u][i] = 0;
      }
}

template <bool I8, bool TRANS, int S>
__global__ void __launch_bounds__(THREADS)
ozaki_kernel(const uint8_t* __restrict__ A, const double* __restrict__ rs,
             const uint8_t* __restrict__ V, const double* __restrict__ vscale,
             double* __restrict__ out, int m, int n) {
  using Sh = Shape<I8, TRANS, S>;
  using Acc = std::conditional_t<I8, int, float>;
  constexpr int ESZ = Sh::ESZ, NT = Sh::NT, R = Sh::R, TILE = Sh::TILE, STEP = Sh::STEP;
  __shared__ double red[WARPS][TILE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  const int K = TRANS ? m : n;
  const size_t slice_bytes = (size_t)m * n * ESZ;
  const uint8_t* Ab = A + (size_t)b * S * slice_bytes;
  const uint8_t* Vg = V + ((size_t)b * VSLICES + g) * K * ESZ;  // the vector's slice t = g
  const int o0 = blockIdx.x * TILE;

  Acc acc[S][NT][4];
  double acc64[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc64[r] = 0.0;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][u][i] = 0;

  for (int c = warp; c < K / CHUNK; c += WARPS) {
#pragma unroll 1
    for (int k0 = c * CHUNK; k0 < (c + 1) * CHUNK; k0 += STEP) {
      if constexpr (!TRANS) {
        // rows o0 + g and o0 + g + 8, 16 bytes each at depth k0 + 16q/ESZ
        const int kk = k0 + q * (16 / ESZ);
        const uint4 x = ld<uint4>(Vg + (size_t)kk * ESZ);
        const size_t lo = ((size_t)(o0 + g) * n + kk) * ESZ, hi = lo + (size_t)8 * n * ESZ;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint8_t* As = Ab + s * slice_bytes;
          const uint4 a = ld<uint4>(As + lo), a8 = ld<uint4>(As + hi);
          mma(acc[s][0], a.x, a8.x, a.y, a8.y, x.x, x.y);
          mma(acc[s][0], a.z, a8.z, a.w, a8.w, x.z, x.w);
        }
      } else if constexpr (!I8) {
        // rows k0 + 2q, +1, +8, +9; columns o0 + 4g .. + 3
        const uint32_t b0 = ld<uint32_t>(Vg + (size_t)(k0 + 2 * q) * 2);
        const uint32_t b1 = ld<uint32_t>(Vg + (size_t)(k0 + 2 * q + 8) * 2);
        const size_t base = ((size_t)(k0 + 2 * q) * n + o0 + 4 * g) * 2, row = (size_t)n * 2;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint8_t* As = Ab + s * slice_bytes + base;
          const uint2 r0 = ld<uint2>(As), r1 = ld<uint2>(As + row);
          const uint2 r8 = ld<uint2>(As + 8 * row), r9 = ld<uint2>(As + 9 * row);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma(acc[s][u], pair16(r0, r1, 2 * u), pair16(r0, r1, 2 * u + 1),
                pair16(r8, r9, 2 * u), pair16(r8, r9, 2 * u + 1), b0, b1);
        }
      } else {
        // rows k0 + 4q .. + 3 and k0 + 16 + 4q .. + 3; columns o0 + 4g .. + 3
        const uint32_t b0 = ld<uint32_t>(Vg + (size_t)(k0 + 4 * q));
        const uint32_t b1 = ld<uint32_t>(Vg + (size_t)(k0 + 16 + 4 * q));
        const size_t base = (size_t)(k0 + 4 * q) * n + o0 + 4 * g, row = (size_t)n;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint8_t* As = Ab + s * slice_bytes + base;
          uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = ld<uint32_t>(As + i * row);
            hi[i] = ld<uint32_t>(As + (16 + i) * row);
          }
          transpose4(lo, tl);
          transpose4(hi, th);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma(acc[s][u], tl[2 * u], tl[2 * u + 1], th[2 * u], th[2 * u + 1], b0, b1);
        }
      }
    }
    if constexpr (!I8) flush<I8>(acc, acc64, q);
  }
  if constexpr (I8) flush<I8>(acc, acc64, q);

  // the quad's four vector-slice pairs, then the warps in order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 1);
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 2);
  }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) red[warp][TRANS ? 4 * g + r : g + 8 * r] = acc64[r];
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    double y = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += red[w][threadIdx.x];
    const int o = o0 + threadIdx.x;
    y = vscale[b] * y;
    if (rs != nullptr) y = rs[(size_t)b * m + o] * y;
    out[(size_t)b * (TRANS ? n : m) + o] = y;
  }
}

template <bool I8, bool TRANS, int S>
void launch_s(dim3 grid, cudaStream_t st, const void* A, const void* rs, const void* V,
              const void* vscale, void* out, int m, int n) {
  ozaki_kernel<I8, TRANS, S><<<grid, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(A), static_cast<const double*>(rs),
      static_cast<const uint8_t*>(V), static_cast<const double*>(vscale),
      static_cast<double*>(out), m, n);
}

template <bool I8, bool TRANS>
int launch(const void* A, const void* rs, const void* V, const void* vscale, void* out,
           int B, int S, int m, int n, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > MAX_S || m < CHUNK || n < CHUNK || m % CHUNK ||
      n % CHUNK || (TRANS && rs != nullptr) || (!TRANS && rs == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int TILE = Shape<I8, TRANS, 1>::TILE;
  const dim3 grid((TRANS ? n : m) / TILE, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: launch_s<I8, TRANS, 1>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 2: launch_s<I8, TRANS, 2>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 3: launch_s<I8, TRANS, 3>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 4: launch_s<I8, TRANS, 4>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 5: launch_s<I8, TRANS, 5>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 6: launch_s<I8, TRANS, 6>(grid, st, A, rs, V, vscale, out, m, n); break;
    case 7: launch_s<I8, TRANS, 7>(grid, st, A, rs, V, vscale, out, m, n); break;
    default: launch_s<I8, TRANS, 8>(grid, st, A, rs, V, vscale, out, m, n); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int madipm_ozaki_bf16_fwd(const void* A, const void* rs, const void* V, const void* vscale,
                          void* out, int B, int S, int m, int n, void* stream) {
  return launch<false, false>(A, rs, V, vscale, out, B, S, m, n, stream);
}

int madipm_ozaki_bf16_t(const void* A, const void* rs, const void* V, const void* vscale,
                        void* out, int B, int S, int m, int n, void* stream) {
  return launch<false, true>(A, rs, V, vscale, out, B, S, m, n, stream);
}

int madipm_ozaki_i8_fwd(const void* A, const void* rs, const void* V, const void* vscale,
                        void* out, int B, int S, int m, int n, void* stream) {
  return launch<true, false>(A, rs, V, vscale, out, B, S, m, n, stream);
}

int madipm_ozaki_i8_t(const void* A, const void* rs, const void* V, const void* vscale,
                      void* out, int B, int S, int m, int n, void* stream) {
  return launch<true, true>(A, rs, V, vscale, out, B, S, m, n, stream);
}

}  // extern "C"
