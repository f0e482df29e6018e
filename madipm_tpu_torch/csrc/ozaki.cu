// The Ozaki fp64 operator's slice-pair contraction, hand-written for
// Hopper (sm_90a).  Four entry points:
//
//   madipm_ozaki_bf16_fwd  y = A x   from bf16 slices and the fp64 x.
//     Replaces the XLA dot_general of madipm_tpu/ops/ozaki.py:153
//     (_pair_block, matvec).
//   madipm_ozaki_bf16_t    y = A' v  from the same forward slices and the
//     fp64 v.  Replaces madipm_tpu/ops/ozaki.py:312 (matvec_t).
//   madipm_ozaki_i8_fwd    y = A x   from int8 slices and the fp64 x.
//     Replaces the XLA s8 dot of madipm_tpu/ops/ozaki.py:279 (matvec_i8).
//   madipm_ozaki_i8_t      y = A' v  from the same forward int8 slices and
//     the fp64 v.  Replaces madipm_tpu/ops/ozaki.py:336 (matvec_t_i8).
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
// chunk, int8 ones once per slice s of a CTA's span with the weight
// 2^-7(s+t+2); all rounding is in that fp64 sum.  out = rs[i] * (vscale * y) forward, vscale * y
// transposed.
//
// What bounds them on this card: bytes.  A call reads the slices once,
// 2 S m n (bf16) or S m n (int8) bytes per instance, and does 2 S 8 m n
// tensor-core operations: 8 (bf16) or 16 (int8) per byte, far below the
// H100's ~295 bf16 and ~590 int8 operations per byte of device memory.
// At S = 8 the int8 slices are 8 bytes per element, what fp64 A is, so
// the int8 pair can at best tie a native fp64 product.  The job is to keep
// enough slice bytes in flight on every SM.
//
// Both kernels (bf16_kernel, i8_kernel) do three things for that:
//   1. They slice the vector themselves.  Every CTA reduces max|w| over
//      its instance's whole vector (w = x forward, w = rs v transposed;
//      16 KB at K = 2048, from L2), builds the power-of-two scale f by the
//      fp32 exponent-bit recipe of ops/ozaki._pow2_scale, and cuts the
//      part of the vector its own contraction span needs into S rows in
//      shared memory, in fp64 (rint: round half to even, as torch.round):
//      bf16 S rounds of w = rint(v 2^8), v = v 2^8 - w on v = w / f;
//      int8 the same with 2^7 on v = w / (2 f), the scale being 2 f.  The
//      slices are bit-equal to ops/ozaki.vector_operands'; an optional
//      output (vs_out, vscale_out; NULL on the solver path) hands them and
//      the scale back.  The first ring loads are issued before this, so
//      they overlap it.
//   2. The grid fills the card at B = 1.  A CTA owns TW outputs and a span
//      of whole 128-deep chunks.  ops/ozaki.plan takes the widest tile
//      whose grid can still give two CTAs per SM (bf16: 32 rows forward,
//      64 or 32 columns transposed; int8: 64 or 32 rows, 128, 64 or 32
//      columns), then splits the contraction over `split` CTAs until it
//      does.  Where the chunks run out first (int8 at B = 1), the S slices
//      are also cut into `groups` of equal size (at most 2), each a CTA
//      of its own.  With P = split groups > 1 each CTA writes its fp64
//      partial to `work` (B, P, OUT), and a second kernel (combine) adds
//      them: lanes of a warp take strided partials of one output and meet
//      in a butterfly, so that all of an output's loads are in flight at
//      once.  The result does not depend on the launch: every sum's order
//      is fixed by the plan.  The combine is a programmatic dependent
//      launch: it is scheduled while the contraction runs and waits for it
//      (griddepcontrol), so that its launch overlaps the contraction's
//      tail.
//   3. The slices stream through a shared-memory ring of one-slice blocks,
//      TW outputs x 128 deep (bf16: STAGES blocks of 8 or 16 KB; int8:
//      I8_STAGES blocks of 4 to 16 KB), filled by cp.async 16-byte copies
//      STAGES - 1 blocks ahead of the warps.  A small ring lets about four
//      CTAs share an SM at the path's shapes, which keeps more bytes in
//      flight than a deeper ring on fewer CTAs (tools/tune_ozaki.py
//      measured 2, 3, 4 and 6 int8 blocks; an L2 prefetch hint on the
//      copies changed nothing, and thread-block clusters that share the
//      vector's max cost more than the max).  The 16-byte units of a block row are
//      XOR-swizzled so that the 8 rows an ldmatrix phase reads fall in 8
//      bank groups.  A block row is 128 (int8 forward) or 256 (bf16
//      forward) bytes of a slice row, or, transposed, TW outputs of one
//      slice row: both variants take 128 contiguous bytes (bf16 64
//      columns, int8 128) wherever the grid still fills the card.  bf16
//      takes the blocks chunk by chunk, each chunk's S slices in turn, and
//      flushes its fp32 sums every chunk; int8 takes them slice by slice,
//      all of the span's chunks of one slice in turn (a row's bytes in
//      order), and keeps one int32 tile per output group, flushed once per
//      slice with the pair weights 2^-7(s+t+2).
//   Fragments.  bf16: ldmatrix (forward) and ldmatrix.trans (transposed:
//   the block is 128 rows of TW columns and the fragment runs down its
//   rows).  int8 forward: ldmatrix .b16 x4 of row-major bytes is the
//   m16n8k32 s8 A fragment as it stands.  int8 transposed: sm_90 has no
//   byte-granular ldmatrix.trans and mma.sync s8 reads row.col only, so
//   ldmatrix.trans moves 2-byte units (two adjacent outputs at one depth)
//   and two prmt per register pair separate the outputs.  A lane's
//   register then holds output 2g (fragment row g; row g + 8 is output
//   2g + 1) at depths 2q, 2q + 1, 8 + 2q, 9 + 2q of the step, and the
//   vector's B fragment is read from shared memory in that same order: a
//   contraction does not care which depth a lane holds, as long as A and B
//   agree.  The 4 warps split a block into 16-output groups (two a warp
//   at TW = 128) and, where TW = 32, two 64-deep halves; their fp64 sums
//   meet in shared memory in a fixed order.
//   The tensor-core instructions stay mma.sync m16n8k16 bf16 -> fp32 and
//   m16n8k32 s8 -> s32: at 8 and 16 operations per byte wgmma would buy
//   nothing (and its s8 form wants both operands K-major, which the
//   transposed product's slices are not).
//
// Plain C interface for ctypes: contiguous device buffers, m and n
// multiples of 128, 1 <= S <= 8.  Each call enqueues its kernels on
// `stream` (one, or two with more than one partial), allocates nothing,
// does not synchronize, and returns the CUDA error of the launch or of the
// shared-memory attribute (0 when all was accepted).

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

// lanes of the combine that share one output: the least power of two >=
// the partials, at most a warp
inline __host__ __device__ int combine_lanes(int parts) {
  int L = 1;
  while (L < parts && L < 32) L <<= 1;
  return L;
}

// The partials of each output, then the scales.  L = combine_lanes(parts)
// lanes share an output: lane l sums partials l, l + L, ... in order, then
// the lanes meet in a butterfly; every order is fixed by `parts` alone,
// and all of an output's loads are in flight at once.
template <bool TRANS>
__global__ void combine(const double* __restrict__ work, const double* __restrict__ rs,
                        double* __restrict__ out, int B, int m, int n, int parts) {
  // launched early (programmatic dependent launch): wait for the
  // contraction's grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int OUT = TRANS ? n : m, L = combine_lanes(parts);
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x, i = t / L;
  const int l = (int)(t % L);
  const bool live = i < (size_t)B * OUT;
  const int b = live ? (int)(i / OUT) : 0, o = live ? (int)(i % OUT) : 0;
  double y = 0.0;
  if (live) {
    const double* p = work + (size_t)b * parts * OUT + o;
    for (int s = l; s < parts; s += L) y += p[(size_t)s * OUT];
  }
  for (int d = L / 2; d > 0; d >>= 1) y += __shfl_xor_sync(0xffffffffu, y, d);
  if (live && l == 0) {
    y = work[(size_t)B * parts * OUT + b] * y;
    if constexpr (!TRANS) y = rs[(size_t)b * m + o] * y;
    out[i] = y;
  }
}

// ---------------------------------------------------------------------------
// int8: geometry (ops/ozaki.plan and ops/ozaki.smem_bytes with variant "i8"
// repeat it)
// ---------------------------------------------------------------------------

constexpr int I8_STAGES = 3;  // blocks of the int8 ring
constexpr int I8_VPAD = 16;   // byte padding of a vector-slice row

// dynamic shared memory of an int8 CTA that owns TW outputs: the ring of
// one-slice TW x CHUNK blocks, then the vector's S slices of the span
__host__ __device__ constexpr size_t smem_bytes_i8(int S, int span_chunks, int TW) {
  return (size_t)I8_STAGES * TW * CHUNK + (size_t)S * (span_chunks * CHUNK + I8_VPAD);
}

__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An int8 CTA owns TW outputs of one instance.  A ring block is one
// slice's TW outputs x 128 deep: forward TW rows of 128 bytes, transposed
// 128 rows of TW bytes.  Warp w takes NG 16-output groups from group
// (w % (OH / NG)) NG on, and the deep half (w / (OH / NG)) of every block
// where TW = 32, else all of it.
template <bool TRANS, int TW>
struct Geo8 {
  static_assert(TW == 32 || TW == 64 || (TRANS && TW == 128),
                "int8 CTAs own 32 or 64 rows forward, 32, 64 or 128 columns transposed");
  static constexpr int OH = TW / 16;                      // 16-output groups
  static constexpr int NG = OH > WARPS ? OH / WARPS : 1;  // groups of a warp
  static constexpr int KH = OH < WARPS ? WARPS / OH : 1;  // deep groups
  static constexpr int KDEEP = CHUNK / KH;                // deep of a warp in a block
  static constexpr int KSTEPS = KDEEP / 32;               // its m16n8k32 steps
  static constexpr int BLOCK_BYTES = TW * CHUNK;
  static constexpr int ROW_BYTES = TRANS ? TW : CHUNK;
  static constexpr int UNITS = ROW_BYTES / 16;            // 16-byte units of a row: 2, 4 or 8
  static constexpr int COPIES = BLOCK_BYTES / 16 / THREADS;
  // where unit c of row r lies: an ldmatrix phase reads one unit of 8
  // consecutive rows (8 / UNITS rows to a 128-byte bank line), which must
  // fall in 8 distinct 16-byte bank groups
  __device__ static __forceinline__ int unit(int r, int c) { return c ^ ((r / (8 / UNITS)) % UNITS); }
};

// The CTA's slices (its group s0 .. s1 - 1 of the S) go through the ring
// slice by slice: all of the span's chunks of slice s0, then of s0 + 1,
// ...  A warp keeps one int32 tile per
// output group (the S vector slices are its n8 columns), which holds the
// exact sums of slice s with every vector slice over the whole span, and
// flushes it into fp64 with the pair weights before slice s + 1.  Each
// output row's bytes are read in order within a slice.
template <bool TRANS, int TW>
__global__ void __launch_bounds__(THREADS)
i8_kernel(const uint8_t* __restrict__ A, const double* __restrict__ rs,
          const double* __restrict__ vec, double* __restrict__ out, double* __restrict__ work,
          int8_t* __restrict__ vs_out, double* __restrict__ vscale_out, int S, int m, int n,
          int split, int groups) {
  using G = Geo8<TRANS, TW>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ double red[G::KH][TW];
  __shared__ double wmax[WARPS];
  int8_t* vsl = reinterpret_cast<int8_t*>(smem + I8_STAGES * G::BLOCK_BYTES);
  const uint32_t ring = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int grp0 = (warp % (G::OH / G::NG)) * G::NG, kh = warp / (G::OH / G::NG);
  const int b = blockIdx.y, B = gridDim.y;
  const int K = TRANS ? m : n, OUT = TRANS ? n : m;
  const int tiles = OUT / TW, chunks = K / CHUNK;
  // partial pi of a tile: span sp of the contraction, slice group sg
  const int tile = blockIdx.x % tiles, pi = blockIdx.x / tiles, parts = split * groups;
  const int sp = pi % split, sg = pi / split;
  const int c0 = sp * chunks / split, nch = (sp + 1) * chunks / split - c0;
  const int s0 = sg * S / groups, s1 = (sg + 1) * S / groups;
  const int o0 = tile * TW;
  const int ld = nch * CHUNK + I8_VPAD;  // row stride of the vector's slices, bytes
  const int nblocks = (s1 - s0) * nch;   // ring blocks: (slice, chunk), chunk fastest
  const size_t slice_bytes = (size_t)m * n;
  const uint8_t* Ab = A + (size_t)b * S * slice_bytes;

  auto load = [&](int j) {
    if (j < nblocks) {
      const int k0 = (c0 + j % nch) * CHUNK;
      const uint8_t* As = Ab + (s0 + j / nch) * slice_bytes;
      const uint32_t dst = ring + (j % I8_STAGES) * G::BLOCK_BYTES;
#pragma unroll
      for (int i = 0; i < G::COPIES; ++i) {
        const int u = tid + i * THREADS, r = u / G::UNITS, c = u % G::UNITS;
        const size_t src = TRANS ? (size_t)(k0 + r) * n + o0 + 16 * c : (size_t)(o0 + r) * n + k0 + 16 * c;
        cp_async16(dst + r * G::ROW_BYTES + G::unit(r, c) * 16, As + src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int j = 0; j < I8_STAGES - 1; ++j) load(j);
  // the combine (more than one partial) may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // 1. the vector's scale and slices; the max's loads all in flight at
  // K <= 2048
  const double* vb = vec + (size_t)b * K;
  const double* rb = rs + (size_t)b * m;
  double mx = 0.0;
#pragma unroll 16
  for (int k = tid; k < K; k += THREADS) mx = fmax(mx, fabs(TRANS ? rb[k] * vb[k] : vb[k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmax(mx, wmax[w]);
  const double f2 = 2.0 * pow2_scale(mx);
  const bool keep = vs_out != nullptr && tile == 0 && sg == 0;
  for (int k = tid; k < nch * CHUNK; k += THREADS) {
    const int kg = c0 * CHUNK + k;
    double v = (TRANS ? rb[kg] * vb[kg] : vb[kg]) / f2;
    for (int s = 0; s < S; ++s) {
      const double w = rint(v * 128.0);
      v = v * 128.0 - w;
      const int8_t w8 = (int8_t)(int)w;  // |w| <= 64
      vsl[s * ld + k] = w8;
      if (keep) vs_out[((size_t)b * S + s) * K + kg] = w8;
    }
  }
  if (vscale_out != nullptr && tile == 0 && pi == 0 && tid == 0) vscale_out[b] = f2;
  __syncthreads();

  // 3. the ring
  double acc64[G::NG][2];
#pragma unroll
  for (int u = 0; u < G::NG; ++u) acc64[u][0] = acc64[u][1] = 0.0;
  for (int s = s0; s < s1; ++s) {
    int acc[G::NG][4];
#pragma unroll
    for (int u = 0; u < G::NG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] = 0;
    for (int c = 0; c < nch; ++c) {
      const int j = (s - s0) * nch + c;
      cp_async_wait<I8_STAGES - 2>();
      __syncthreads();
      const uint32_t blk = ring + (j % I8_STAGES) * G::BLOCK_BYTES;
      // the block this load overwrites was read before the barrier
      load(j + I8_STAGES - 1);
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        const int kb = kh * G::KDEEP + ks * 32;  // the step's depth in the block
        // B fragment: the vector's slice t = g (zero past S), in the depth
        // order of the A fragment
        uint32_t b0 = 0u, b1 = 0u;
        if (g < S) {
          const int8_t* row = vsl + g * ld + c * CHUNK + kb;
          if constexpr (TRANS) {
            // depths 2q, 2q + 1, 8 + 2q, 9 + 2q, and 16 more
            const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
            b0 = r16[q] | (uint32_t)r16[4 + q] << 16;
            b1 = r16[8 + q] | (uint32_t)r16[12 + q] << 16;
          } else {
            // depths 4q .. 4q + 3, and 16 more
            const uint32_t* r32 = reinterpret_cast<const uint32_t*>(row);
            b0 = r32[q];
            b1 = r32[4 + q];
          }
        }
#pragma unroll
        for (int u = 0; u < G::NG; ++u) {
          const int grp = grp0 + u;
          uint32_t a0, a1, a2, a3;
          if constexpr (TRANS) {
            // four 8-deep matrices of the group's 16 outputs as 2-byte
            // units, read down the rows: t_i holds depths 8i + 2q and
            // 8i + 2q + 1 of outputs 2g and 2g + 1
            const int r = kb + lane;
            uint32_t t0, t1, t2, t3;
            ldsm<true>(blk + r * G::ROW_BYTES + G::unit(r, grp) * 16, t0, t1, t2, t3);
            a0 = __byte_perm(t0, t1, 0x6420);  // output 2g, depths 2q, 2q + 1, 8 + 2q, 9 + 2q
            a1 = __byte_perm(t0, t1, 0x7531);  // output 2g + 1
            a2 = __byte_perm(t2, t3, 0x6420);  // output 2g, 16 deeper
            a3 = __byte_perm(t2, t3, 0x7531);
          } else {
            // (rows 0-7 | 8-15) x (depths 0-15 | 16-31) of the group
            const int r = 16 * grp + (lane & 15);
            ldsm<false>(blk + r * G::ROW_BYTES + G::unit(r, kb / 16 + (lane >> 4)) * 16, a0, a1, a2, a3);
          }
          mma(acc[u], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    // register i holds fragment row g (i < 2) or g + 8 and vector slice
    // t = 2q + i % 2: the pair's exact sum over the span, of weight
    // 2^-7(s+t+2)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 2^-7(s+t+2) from its exponent bits: the product with the int32 sum is exact
      const double w = __longlong_as_double((long long)(1023 - 7 * (s + 2 * q + (i & 1) + 2)) << 52);
#pragma unroll
      for (int u = 0; u < G::NG; ++u) acc64[u][i >> 1] += (double)acc[u][i] * w;
    }
  }
  cp_async_wait<0>();

  // the quad's vector slices, then the deep groups in order
#pragma unroll
  for (int u = 0; u < G::NG; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc64[u][h] += __shfl_xor_sync(0xffffffffu, acc64[u][h], 1);
      acc64[u][h] += __shfl_xor_sync(0xffffffffu, acc64[u][h], 2);
      // fragment row g (h = 0) or g + 8: output 2g + h transposed, g + 8h forward
      if (q == 0) red[kh][16 * (grp0 + u) + (TRANS ? 2 * g + h : g + 8 * h)] = acc64[u][h];
    }
  __syncthreads();
  if (tid < TW) {
    double y = red[0][tid];
#pragma unroll
    for (int k = 1; k < G::KH; ++k) y += red[k][tid];
    const int o = o0 + tid;
    if (parts == 1) {
      y = f2 * y;
      if constexpr (!TRANS) y = rs[(size_t)b * m + o] * y;
      out[(size_t)b * OUT + o] = y;
    } else {
      work[((size_t)b * parts + pi) * OUT + o] = y;
      if (tile == 0 && pi == 0 && tid == 0) work[(size_t)B * parts * OUT + b] = f2;
    }
  }
}

// ---------------------------------------------------------------------------
// The launch, for both kernels
// ---------------------------------------------------------------------------

struct Call {
  const void* A;
  const void* rs;
  const void* vec;
  void* out;
  void* work;
  void* vs_out;
  void* vscale_out;
  int B, S, m, n, tw, split, groups;
};

// Opt the kernel in to the most shared memory it may take, once per device.
template <auto kernel>
cudaError_t allow_smem(size_t most) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <bool TRANS, int TW, int S>
int launch_bf16_s(const Call& c, dim3 grid, int span, cudaStream_t st) {
  const cudaError_t e = allow_smem<bf16_kernel<TRANS, TW, S>>(smem_bytes(S, MAX_SPAN, TW));
  if (e != cudaSuccess) return (int)e;
  bf16_kernel<TRANS, TW, S><<<grid, THREADS, smem_bytes(S, span, TW), st>>>(
      static_cast<const uint8_t*>(c.A), static_cast<const double*>(c.rs),
      static_cast<const double*>(c.vec), static_cast<double*>(c.out), static_cast<double*>(c.work),
      static_cast<uint16_t*>(c.vs_out), static_cast<double*>(c.vscale_out), c.m, c.n, c.split);
  return 0;
}

// bf16 takes S as a template argument (its accumulators are an S-array);
// int8 as an argument
template <bool I8, bool TRANS, int TW>
int launch_tw(const Call& c, dim3 grid, cudaStream_t st) {
  const int span = ((TRANS ? c.m : c.n) / CHUNK + c.split - 1) / c.split;
  if constexpr (I8) {
    const cudaError_t e = allow_smem<i8_kernel<TRANS, TW>>(smem_bytes_i8(MAX_S, MAX_SPAN, TW));
    if (e != cudaSuccess) return (int)e;
    i8_kernel<TRANS, TW><<<grid, THREADS, smem_bytes_i8(c.S, span, TW), st>>>(
        static_cast<const uint8_t*>(c.A), static_cast<const double*>(c.rs),
        static_cast<const double*>(c.vec), static_cast<double*>(c.out), static_cast<double*>(c.work),
        static_cast<int8_t*>(c.vs_out), static_cast<double*>(c.vscale_out), c.S, c.m, c.n, c.split,
        c.groups);
    return 0;
  } else {
    switch (c.S) {
#define MADIPM_OZAKI_S(s_) \
  case s_: return launch_bf16_s<TRANS, TW, s_>(c, grid, span, st);
      MADIPM_OZAKI_S(1) MADIPM_OZAKI_S(2) MADIPM_OZAKI_S(3) MADIPM_OZAKI_S(4)
      MADIPM_OZAKI_S(5) MADIPM_OZAKI_S(6) MADIPM_OZAKI_S(7) MADIPM_OZAKI_S(8)
#undef MADIPM_OZAKI_S
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// the tiles a kernel takes: bf16 32 outputs, or 64 transposed; int8 32 or
// 64, or 128 transposed
template <bool I8, bool TRANS>
int launch_tile(const Call& c, dim3 grid, cudaStream_t st) {
  switch (c.tw) {
    case 32: return launch_tw<I8, TRANS, 32>(c, grid, st);
    case 64:
      if constexpr (I8 || TRANS) return launch_tw<I8, TRANS, 64>(c, grid, st);
      break;
    case 128:
      if constexpr (I8 && TRANS) return launch_tw<I8, TRANS, 128>(c, grid, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <bool I8, bool TRANS>
int launch(const Call& c, void* stream) {
  const int K = TRANS ? c.m : c.n, OUT = TRANS ? c.n : c.m;
  const int chunks = K / CHUNK, parts = c.split * c.groups;
  if (c.B < 1 || c.B > 65535 || c.S < 1 || c.S > MAX_S || c.m < CHUNK || c.n < CHUNK ||
      c.m % CHUNK || c.n % CHUNK || (I8 && K >= (1 << 19)) || c.tw < 32 || OUT % c.tw ||
      c.split < 1 || c.split > chunks || (chunks + c.split - 1) / c.split > MAX_SPAN ||
      c.groups < 1 || c.groups > (I8 ? c.S : 1) || c.A == nullptr || c.rs == nullptr ||
      c.vec == nullptr || c.out == nullptr || (parts > 1 && c.work == nullptr) ||
      (c.vs_out == nullptr) != (c.vscale_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((OUT / c.tw) * parts, c.B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_tile<I8, TRANS>(c, grid, st);
  if (rc != 0) return rc;
  if (parts > 1) {
    // the combine's launch overlaps the contraction's tail
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    const unsigned threads = 256;
    cfg.gridDim = dim3((unsigned)(((size_t)c.B * OUT * combine_lanes(parts) + threads - 1) / threads));
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, combine<TRANS>, static_cast<const double*>(c.work),
                                             static_cast<const double*>(c.rs),
                                             static_cast<double*>(c.out), c.B, c.m, c.n, parts);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All four: A (B, S, m, n) slices (bf16, or int8); rs (B, m) fp64 row
// scales (int8: 2 e); vec the fp64 vector, (B, n) forward, (B, m)
// transposed; out (B, m) or (B, n) fp64; work (B P OUT + B) fp64 when
// P = split groups > 1, else unused; vs_out (B, S, K) (bf16, or int8) and
// vscale_out (B,) fp64 receive the vector's slices and scale, or both are
// NULL.  tw (outputs of a CTA), split (spans of the contraction) and
// groups (of the S slices; 1 for bf16) as ops/ozaki.plan gives them.
#define MADIPM_OZAKI_ENTRY(name_, i8_, trans_)                                                   \
  int name_(const void* A, const void* rs, const void* vec, void* out, void* work, void* vs_out, \
            void* vscale_out, int B, int S, int m, int n, int tw, int split, int groups,         \
            void* stream) {                                                                      \
    return launch<i8_, trans_>(Call{A, rs, vec, out, work, vs_out, vscale_out, B, S, m, n, tw,   \
                                    split, groups},                                              \
                               stream);                                                          \
  }
MADIPM_OZAKI_ENTRY(madipm_ozaki_bf16_fwd, false, false)
MADIPM_OZAKI_ENTRY(madipm_ozaki_bf16_t, false, true)
MADIPM_OZAKI_ENTRY(madipm_ozaki_i8_fwd, true, false)
MADIPM_OZAKI_ENTRY(madipm_ozaki_i8_t, true, true)
#undef MADIPM_OZAKI_ENTRY

}  // extern "C"
