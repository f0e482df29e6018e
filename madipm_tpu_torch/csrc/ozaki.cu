// The Ozaki fp64 operator's slice-pair contraction, hand-written for
// Hopper (sm_90a).  Four entry points:
//
//   madipm_ozaki_bf16_fwd  y = A x   from bf16 slices and the fp64 x.
//     Replaces the XLA dot_general of madipm_tpu/ops/ozaki.py:153
//     (_pair_block, matvec).
//   madipm_ozaki_bf16_t    y = A' v  from the same forward slices and the
//     fp64 v.  Replaces madipm_tpu/ops/ozaki.py:312 (matvec_t).
//   madipm_ozaki_i8_fwd    y = A x   from int8 slices and the vector's
//     int8 slices.  Replaces madipm_tpu/ops/ozaki.py:279 (matvec_i8).
//   madipm_ozaki_i8_t      y = A' v  likewise.  Replaces
//     madipm_tpu/ops/ozaki.py:336 (matvec_t_i8).
// None of them had a Pallas ancestor: on the TPU they were XLA dots.
//
// What they compute.  A (B, m, n) is stored as S slices (B, S, m, n),
// bf16 values on the fixed-point grids 2^-8(s+1) or int8 integers of
// weight 2^-7(s+1).  The vector is sliced the same way into T = S slices
// against one power-of-two scale.  Each slice pair (s, t) is contracted
// exactly: a bf16 product is an integer below 2^16 on the pair's grid, so
// 128 of them (one CHUNK) sum below 2^23 in the fp32 accumulator; an int8
// product is below 2^12, so the int32 sum stays exact for K < 2^19.  Every
// (s, t) keeps its own accumulator: s indexes a register array, t is the
// n8 column of an mma.sync fragment (columns past T are zero registers).
// bf16 accumulators are flushed into fp64 registers after every 128-deep
// chunk, int8 ones once with the weight 2^-7(s+t+2); all rounding is in
// that fp64 sum.  out = rs[i] * (vscale * y) forward, vscale * y
// transposed.
//
// What bounds them on this card: bytes.  A call reads the slices once,
// 2 S m n (bf16) or S m n (int8) bytes per instance, and does 2 S 8 m n
// tensor-core operations: 8 (bf16) or 16 (int8) per byte, far below the
// H100's ~295 bf16 and ~590 int8 operations per byte of device memory.
// The job is to keep enough slice bytes in flight on every SM.
//
// The bf16 kernel (bf16_kernel) does three things for that:
//   1. It slices the vector itself.  Every CTA reduces max|w| over its
//      instance's whole vector (w = x forward, w = rs v transposed; 16 KB
//      at K = 2048, from L2), builds the power-of-two scale by the fp32
//      exponent-bit recipe of ops/ozaki._pow2_scale, and cuts the part of
//      the vector its own contraction span needs into S bf16 rows in
//      shared memory: S rounds of w = rint(v 2^8), v = v 2^8 - w in fp64
//      (rint: round half to even, as torch.round).  The slices are
//      bit-equal to ops/ozaki.vector_operands'; an optional output
//      (vs_out, vscale_out; NULL on the solver path) hands them back.  The
//      first ring loads are issued before this, so they overlap it.
//   2. The grid fills the card at B = 1.  A CTA owns TW outputs (32 rows
//      forward; 64 columns transposed where the grid still fills the
//      card, else 32) and a span of whole 128-deep chunks; ops/ozaki.plan
//      splits the contraction over `split` CTAs until the grid has at
//      least two CTAs per SM.  With split > 1 each CTA writes its fp64
//      partial to `work` (B, split, OUT), and a second kernel (combine)
//      adds them in split order: the result does not depend on the
//      launch, since every sum's order is fixed.  The combine is a
//      programmatic dependent launch: it is scheduled while the
//      contraction runs and waits for it (griddepcontrol), so that its
//      launch overlaps the contraction's tail.
//   3. The slices stream through a shared-memory ring of STAGES blocks,
//      each one slice's TW outputs x 128 deep (8 or 16 KB), filled by
//      cp.async 16-byte copies STAGES - 1 blocks ahead of the warps.
//      Three blocks: a CTA keeps two in flight while it computes on the
//      third, and the small ring lets about four CTAs share an SM at the
//      path's shapes, which keeps more bytes in flight than a deeper ring
//      on fewer CTAs.
//      Warps read A fragments by ldmatrix (forward) or ldmatrix.trans
//      (transposed: the block is 128 rows of TW columns and the fragment
//      runs down its rows); the 16-byte units of a row are XOR-swizzled
//      so that the 8 rows an ldmatrix phase reads fall in 8 bank groups.
//      The 4 warps split a block into 16-output groups and, where TW = 32,
//      two 64-deep halves; their fp64 sums meet in shared memory in a
//      fixed order.  A transposed row of 64 columns is 128 contiguous
//      bytes of a slice row, where 32 columns give only 64.
//   The tensor-core instruction stays mma.sync m16n8k16 bf16 -> fp32: at
//   8 operations per byte wgmma would buy nothing.
//
// The int8 kernel (i8_kernel) keeps the first design: the vector comes as
// 8 pre-made int8 rows (B, 8, K), each slice element is loaded once
// straight from device memory into mma registers (the transposed product
// transposes bytes in registers with prmt), and a CTA of 4 warps owns 16
// rows (forward) or 32 columns (transposed) of one instance.
//
// Plain C interface for ctypes: contiguous device buffers, m and n
// multiples of 128, 1 <= S <= 8.  Each call enqueues its kernels on
// `stream` (bf16: one, or two with split > 1; int8: one), allocates
// nothing, does not synchronize, and returns the CUDA error of the launch
// or of the shared-memory attribute (0 when all was accepted).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;   // contraction depth between fp64 flushes (bf16 exactness)
constexpr int MAX_S = 8;     // slices: the vector's are the n8 of a fragment

// ---------------------------------------------------------------------------
// bf16: geometry (ops/ozaki.plan and ops/ozaki.smem_bytes repeat it)
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;     // blocks of the ring
constexpr int MAX_SPAN = 16;  // chunks of a CTA's span, at most
constexpr int VPAD = 8;       // bf16 padding of a vector-slice row
constexpr int MAX_DEVICES = 64;

// dynamic shared memory of a CTA that owns TW outputs: the ring of
// one-slice TW x CHUNK blocks, then the vector's S slices of the span
__host__ __device__ constexpr size_t smem_bytes(int S, int span_chunks, int TW) {
  return (size_t)STAGES * TW * CHUNK * 2 + (size_t)S * (span_chunks * CHUNK + VPAD) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                     uint32_t& a3) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3) : "r"(addr) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A CTA owns TW outputs (32, or 64 transposed where the grid still fills
// the card) of one instance.  A ring block is one slice's TW outputs x 128
// deep: forward TW rows of 256 bytes, transposed 128 rows of 2 TW bytes.
// Warp w takes outputs 16 (w % OH) .. + 15 and the deep quarter, half or
// whole (w / OH) of every block.
template <bool TRANS, int TW>
struct Geo {
  static_assert(TW == 32 || (TRANS && TW == 64), "forward CTAs own 32 rows, transposed 32 or 64 columns");
  static constexpr int OH = TW / 16;           // 16-output groups
  static constexpr int KH = WARPS / OH;        // deep groups
  static constexpr int KDEEP = CHUNK / KH;     // deep of a warp in a block
  static constexpr int KSTEPS = KDEEP / 16;    // its m16n8k16 steps
  static constexpr int BLOCK_BYTES = TW * CHUNK * 2;
  static constexpr int ROW_BYTES = TRANS ? 2 * TW : 2 * CHUNK;
  static constexpr int UNITS = ROW_BYTES / 16;  // 16-byte units of a row
  static constexpr int COPIES = BLOCK_BYTES / 16 / THREADS;  // cp.async of a thread per block
  // where unit c of row r lies: an ldmatrix phase reads one unit of 8
  // consecutive rows, which must fall in 8 distinct 16-byte bank groups
  __device__ static __forceinline__ int unit(int r, int c) {
    return UNITS >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  }
};

// Power of two in (mx, 2 mx], 1.0 where mx == 0: ops/ozaki._pow2_scale's
// recipe, bit for bit.
__device__ __forceinline__ double pow2_scale(double mx) {
  float m32 = __double2float_rn(mx * (1.0 + 0x1p-20));
  m32 = fmaxf(m32, 0x1p-120f);
  int expo = (__float_as_int(m32) >> 23) & 0xFF;
  expo = min(max(expo + 1, 1), 254);
  return mx > 0.0 ? (double)__int_as_float(expo << 23) : 1.0;
}

template <bool TRANS, int TW, int S>
__global__ void __launch_bounds__(THREADS)
bf16_kernel(const uint8_t* __restrict__ A, const double* __restrict__ rs,
            const double* __restrict__ vec, double* __restrict__ out, double* __restrict__ work,
            uint16_t* __restrict__ vs_out, double* __restrict__ vscale_out, int m, int n,
            int split) {
  using G = Geo<TRANS, TW>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ double red[G::KH][TW];
  __shared__ double wmax[WARPS];
  uint16_t* vsl = reinterpret_cast<uint16_t*>(smem + STAGES * G::BLOCK_BYTES);
  const uint32_t ring = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int oh = warp % G::OH, kh = warp / G::OH;
  const int b = blockIdx.y, B = gridDim.y;
  const int K = TRANS ? m : n, OUT = TRANS ? n : m;
  const int tiles = OUT / TW, chunks = K / CHUNK;
  const int tile = blockIdx.x % tiles, sp = blockIdx.x / tiles;
  const int c0 = sp * chunks / split, nch = (sp + 1) * chunks / split - c0;
  const int o0 = tile * TW;
  const int ld = nch * CHUNK + VPAD;  // row stride of the vector's slices, elements
  const int nblocks = nch * S;        // ring blocks: (chunk, slice), slice fastest
  const size_t slice_bytes = (size_t)m * n * 2;
  const uint8_t* Ab = A + (size_t)b * S * slice_bytes;

  auto load = [&](int j) {
    if (j < nblocks) {
      const int k0 = (c0 + j / S) * CHUNK;
      const uint8_t* As = Ab + (j % S) * slice_bytes;
      const uint32_t dst = ring + (j % STAGES) * G::BLOCK_BYTES;
#pragma unroll
      for (int i = 0; i < G::COPIES; ++i) {
        const int u = tid + i * THREADS, r = u / G::UNITS, c = u % G::UNITS;
        const size_t src = TRANS ? ((size_t)(k0 + r) * n + o0 + 8 * c) * 2
                                 : ((size_t)(o0 + r) * n + k0 + 8 * c) * 2;
        cp_async16(dst + r * G::ROW_BYTES + G::unit(r, c) * 16, As + src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) load(j);
  // the combine (split > 1) may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // 1. the vector's scale and slices
  const double* vb = vec + (size_t)b * K;
  const double* rb = rs + (size_t)b * m;
  double mx = 0.0;
#pragma unroll 4
  for (int k = tid; k < K; k += THREADS) mx = fmax(mx, fabs(TRANS ? rb[k] * vb[k] : vb[k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmax(mx, wmax[w]);
  const double f = pow2_scale(mx);
  const bool keep = vs_out != nullptr && tile == 0;
  for (int k = tid; k < nch * CHUNK; k += THREADS) {
    const int kg = c0 * CHUNK + k;
    double v = (TRANS ? rb[kg] * vb[kg] : vb[kg]) / f;
    double scale = 1.0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const double w = rint(v * 256.0);
      v = v * 256.0 - w;
      scale *= 0x1p-8;
      // an integer of at most 8 bits times a power of two: exact in bf16
      const uint16_t bits = (uint16_t)(__float_as_uint((float)(w * scale)) >> 16);
      vsl[s * ld + k] = bits;
      if (keep) vs_out[((size_t)b * S + s) * K + kg] = bits;
    }
  }
  if (vscale_out != nullptr && tile == 0 && sp == 0 && tid == 0) vscale_out[b] = f;
  __syncthreads();

  // 3. the ring
  float acc[S][4];
  double acc64[2] = {0.0, 0.0};
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.f;

  for (int c = 0; c < nch; ++c) {
    // B fragments of the vector's slice t = g for this warp's deep part
    uint32_t bf[G::KSTEPS][2];
#pragma unroll
    for (int ks = 0; ks < G::KSTEPS; ++ks) {
      const int kl = c * CHUNK + kh * G::KDEEP + ks * 16 + 2 * q;
      bf[ks][0] = g < S ? *reinterpret_cast<const uint32_t*>(vsl + g * ld + kl) : 0u;
      bf[ks][1] = g < S ? *reinterpret_cast<const uint32_t*>(vsl + g * ld + kl + 8) : 0u;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = c * S + s;
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const uint32_t blk = ring + (j % STAGES) * G::BLOCK_BYTES;
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        int r, u;
        if constexpr (TRANS) {
          // matrices (deep 0-7 | 8-15) x (outputs 0-7 | 8-15), read down the rows
          const int mi = lane >> 3;
          r = kh * G::KDEEP + ks * 16 + (lane & 7) + 8 * (mi >> 1);
          u = 2 * oh + (mi & 1);
        } else {
          r = 16 * oh + (lane & 15);
          u = (kh * G::KDEEP + ks * 16) / 8 + (lane >> 4);
        }
        uint32_t a0, a1, a2, a3;
        ldsm<TRANS>(blk + r * G::ROW_BYTES + G::unit(r, u) * 16, a0, a1, a2, a3);
        mma(acc[s], a0, a1, a2, a3, bf[ks][0], bf[ks][1]);
      }
      load(j + STAGES - 1);
    }
    // the chunk's exact partials into fp64: outputs g and g + 8 of the group
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc64[i >> 1] += (double)acc[s][i];
        acc[s][i] = 0.f;
      }
  }
  cp_async_wait<0>();

  // the quad's vector slices, then the deep groups in order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 1);
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 2);
  }
  if (q == 0) {
    red[kh][16 * oh + g] = acc64[0];
    red[kh][16 * oh + g + 8] = acc64[1];
  }
  __syncthreads();
  if (tid < TW) {
    double y = red[0][tid];
#pragma unroll
    for (int k = 1; k < G::KH; ++k) y += red[k][tid];
    const int o = o0 + tid;
    if (split == 1) {
      y = f * y;
      if constexpr (!TRANS) y = rs[(size_t)b * m + o] * y;
      out[(size_t)b * OUT + o] = y;
    } else {
      work[((size_t)b * split + sp) * OUT + o] = y;
      if (tile == 0 && sp == 0 && tid == 0) work[(size_t)B * split * OUT + b] = f;
    }
  }
}

// The split partials of each output in split order, then the scales.
template <bool TRANS>
__global__ void combine(const double* __restrict__ work, const double* __restrict__ rs,
                        double* __restrict__ out, int B, int m, int n, int split) {
  // launched early (programmatic dependent launch): wait for the
  // contraction's grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int OUT = TRANS ? n : m;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * OUT) return;
  const int b = (int)(i / OUT), o = (int)(i % OUT);
  const double* p = work + (size_t)b * split * OUT + o;
  double y = 0.0;
  for (int s = 0; s < split; ++s) y += p[(size_t)s * OUT];
  y = work[(size_t)B * split * OUT + b] * y;
  if constexpr (!TRANS) y = rs[(size_t)b * m + o] * y;
  out[i] = y;
}

// Opt the kernel in to the most shared memory it may take, once per device.
template <bool TRANS, int TW, int S>
cudaError_t allow_smem() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(bf16_kernel<TRANS, TW, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(S, MAX_SPAN, TW));
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <bool TRANS, int TW, int S>
int launch_bf16_s(dim3 grid, size_t smem, cudaStream_t st, const void* A, const void* rs,
                  const void* vec, void* out, void* work, void* vs_out, void* vscale_out, int m,
                  int n, int split) {
  const cudaError_t e = allow_smem<TRANS, TW, S>();
  if (e != cudaSuccess) return (int)e;
  bf16_kernel<TRANS, TW, S><<<grid, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(A), static_cast<const double*>(rs),
      static_cast<const double*>(vec), static_cast<double*>(out), static_cast<double*>(work),
      static_cast<uint16_t*>(vs_out), static_cast<double*>(vscale_out), m, n, split);
  return 0;
}

template <bool TRANS, int TW>
int launch_bf16_tw(dim3 grid, size_t smem, cudaStream_t st, const void* A, const void* rs,
                   const void* vec, void* out, void* work, void* vs_out, void* vscale_out, int S,
                   int m, int n, int split) {
  switch (S) {
#define MADIPM_OZAKI_S(s_)                                                                   \
  case s_:                                                                                   \
    return launch_bf16_s<TRANS, TW, s_>(grid, smem, st, A, rs, vec, out, work, vs_out,        \
                                        vscale_out, m, n, split);
    MADIPM_OZAKI_S(1) MADIPM_OZAKI_S(2) MADIPM_OZAKI_S(3) MADIPM_OZAKI_S(4)
    MADIPM_OZAKI_S(5) MADIPM_OZAKI_S(6) MADIPM_OZAKI_S(7) MADIPM_OZAKI_S(8)
#undef MADIPM_OZAKI_S
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRANS>
int launch_bf16(const void* A, const void* rs, const void* vec, void* out, void* work,
                void* vs_out, void* vscale_out, int B, int S, int m, int n, int tw, int split,
                void* stream) {
  const int K = TRANS ? m : n, OUT = TRANS ? n : m;
  const int chunks = K / CHUNK;
  if (B < 1 || B > 65535 || S < 1 || S > MAX_S || m < CHUNK || n < CHUNK || m % CHUNK ||
      n % CHUNK || !(tw == 32 || (TRANS && tw == 64)) || split < 1 || split > chunks ||
      (chunks + split - 1) / split > MAX_SPAN || A == nullptr || rs == nullptr ||
      vec == nullptr || out == nullptr || (split > 1 && work == nullptr) ||
      (vs_out == nullptr) != (vscale_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((OUT / tw) * split, B);
  const size_t smem = smem_bytes(S, (chunks + split - 1) / split, tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      tw == 64 ? launch_bf16_tw<TRANS, TRANS ? 64 : 32>(grid, smem, st, A, rs, vec, out, work,
                                                        vs_out, vscale_out, S, m, n, split)
               : launch_bf16_tw<TRANS, 32>(grid, smem, st, A, rs, vec, out, work, vs_out,
                                           vscale_out, S, m, n, split);
  if (rc != 0) return rc;
  if (split > 1) {
    // the combine's launch overlaps the contraction's tail
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    const unsigned threads = 256;
    cfg.gridDim = dim3((unsigned)(((size_t)B * OUT + threads - 1) / threads));
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, combine<TRANS>, static_cast<const double*>(work),
                                             static_cast<const double*>(rs),
                                             static_cast<double*>(out), B, m, n, split);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8: the first design (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int VSLICES = 8;  // rows of the vector's int8 slices

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

// 4 x 4 byte transpose: out[c] holds byte c of r0..r3, in that order.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <bool TRANS>
struct I8Shape {
  static constexpr int TILE = TRANS ? 32 : 16;  // outputs of a CTA
  static constexpr int NT = TRANS ? 2 : 1;      // m16n8 tiles of a warp
  static constexpr int R = TRANS ? 4 : 2;       // outputs of a lane
  // contraction depth of one step: forward two k-steps of 16-byte row
  // loads, transposed one k-step
  static constexpr int STEP = TRANS ? 32 : 64;
};

template <bool TRANS, int S>
__global__ void __launch_bounds__(THREADS)
i8_kernel(const uint8_t* __restrict__ A, const double* __restrict__ rs,
          const uint8_t* __restrict__ V, const double* __restrict__ vscale,
          double* __restrict__ out, int m, int n) {
  using Sh = I8Shape<TRANS>;
  constexpr int NT = Sh::NT, R = Sh::R, TL = Sh::TILE, STEP = Sh::STEP;
  __shared__ double red[WARPS][TL];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  const int K = TRANS ? m : n;
  const size_t slice_bytes = (size_t)m * n;
  const uint8_t* Ab = A + (size_t)b * S * slice_bytes;
  const uint8_t* Vg = V + ((size_t)b * VSLICES + g) * K;  // the vector's slice t = g
  const int o0 = blockIdx.x * TL;

  int acc[S][NT][4];
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
        // rows o0 + g and o0 + g + 8, 16 bytes each at depth k0 + 16q
        const int kk = k0 + q * 16;
        const uint4 x = ld<uint4>(Vg + kk);
        const size_t lo = (size_t)(o0 + g) * n + kk, hi = lo + (size_t)8 * n;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint8_t* As = Ab + s * slice_bytes;
          const uint4 a = ld<uint4>(As + lo), a8 = ld<uint4>(As + hi);
          mma(acc[s][0], a.x, a8.x, a.y, a8.y, x.x, x.y);
          mma(acc[s][0], a.z, a8.z, a.w, a8.w, x.z, x.w);
        }
      } else {
        // rows k0 + 4q .. + 3 and k0 + 16 + 4q .. + 3; columns o0 + 4g .. + 3
        const uint32_t b0 = ld<uint32_t>(Vg + k0 + 4 * q);
        const uint32_t b1 = ld<uint32_t>(Vg + k0 + 16 + 4 * q);
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
  }
  // register i of tile u holds output 2u + i/2 of the lane and vector slice
  // t = 2q + i%2, weight 2^-7(s+t+2)
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc64[2 * u + (i >> 1)] += ldexp((double)acc[s][u][i], -7 * (s + 2 * q + (i & 1) + 2));

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
  if (threadIdx.x < TL) {
    double y = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += red[w][threadIdx.x];
    const int o = o0 + threadIdx.x;
    y = vscale[b] * y;
    if (rs != nullptr) y = rs[(size_t)b * m + o] * y;
    out[(size_t)b * (TRANS ? n : m) + o] = y;
  }
}

template <bool TRANS>
int launch_i8(const void* A, const void* rs, const void* V, const void* vscale, void* out, int B,
              int S, int m, int n, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > MAX_S || m < CHUNK || n < CHUNK || m % CHUNK ||
      n % CHUNK || (TRANS && rs != nullptr) || (!TRANS && rs == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((TRANS ? n : m) / I8Shape<TRANS>::TILE, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint8_t*>(A);
  const auto* r = static_cast<const double*>(rs);
  const auto* v = static_cast<const uint8_t*>(V);
  const auto* vs = static_cast<const double*>(vscale);
  auto* o = static_cast<double*>(out);
  switch (S) {
#define MADIPM_OZAKI_S(s_) \
  case s_: i8_kernel<TRANS, s_><<<grid, THREADS, 0, st>>>(a, r, v, vs, o, m, n); break;
    MADIPM_OZAKI_S(1) MADIPM_OZAKI_S(2) MADIPM_OZAKI_S(3) MADIPM_OZAKI_S(4)
    MADIPM_OZAKI_S(5) MADIPM_OZAKI_S(6) MADIPM_OZAKI_S(7) MADIPM_OZAKI_S(8)
#undef MADIPM_OZAKI_S
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16: A (B, S, m, n) bf16 slices; rs (B, m) fp64 row scales; vec the
// fp64 vector, (B, n) forward, (B, m) transposed; out (B, m) or (B, n)
// fp64; work (B split OUT + B) fp64 when split > 1, else unused; vs_out
// (B, S, K) bf16 and vscale_out (B,) fp64 receive the vector's slices and
// scale, or both are NULL.  tw (outputs of a CTA) and split as
// ops/ozaki.plan gives them.
int madipm_ozaki_bf16_fwd(const void* A, const void* rs, const void* vec, void* out, void* work,
                          void* vs_out, void* vscale_out, int B, int S, int m, int n, int tw,
                          int split, void* stream) {
  return launch_bf16<false>(A, rs, vec, out, work, vs_out, vscale_out, B, S, m, n, tw, split,
                            stream);
}

int madipm_ozaki_bf16_t(const void* A, const void* rs, const void* vec, void* out, void* work,
                        void* vs_out, void* vscale_out, int B, int S, int m, int n, int tw,
                        int split, void* stream) {
  return launch_bf16<true>(A, rs, vec, out, work, vs_out, vscale_out, B, S, m, n, tw, split,
                           stream);
}

// int8: A (B, S, m, n) int8 slices; rs (B, m) fp64 forward, NULL
// transposed; V (B, 8, K) int8, the vector's slices, zero after the S;
// vscale (B,) fp64; out (B, m) or (B, n) fp64.
int madipm_ozaki_i8_fwd(const void* A, const void* rs, const void* V, const void* vscale,
                        void* out, int B, int S, int m, int n, void* stream) {
  return launch_i8<false>(A, rs, V, vscale, out, B, S, m, n, stream);
}

int madipm_ozaki_i8_t(const void* A, const void* rs, const void* V, const void* vscale,
                      void* out, int B, int S, int m, int n, void* stream) {
  return launch_i8<true>(A, rs, V, vscale, out, B, S, m, n, stream);
}

}  // extern "C"
