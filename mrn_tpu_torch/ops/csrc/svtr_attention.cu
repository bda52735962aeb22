// SVTR training attention forwards for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the two Pallas TPU kernels of mrn_tpu/ops/svtr_attention.py:
//   - _make_kernel (via _mha_forward): full attention over all N keys, with
//     an optional additive [N, N] mask (Global Blocks, and Local Blocks that
//     have no band plan);
//   - _make_banded_kernel (via _banded_forward): banded Local attention over
//     column-major tokens, where query block a of qb rows attends to the keys
//     [starts[a], starts[a] + width) with the [N, width] band mask.
// Both take q, k, v [BH, N, D] in the working type T (float or bfloat16), q
// pre-scaled, and compute exactly what the Pallas kernels compute:
//   s = q k^T in float32 (+ mask), p = exp(s - rowmax(s)), p = p / rowsum(p),
//   p rounded to T, o = p v accumulated in float32, o rounded to T.
// This is the training softmax (max-subtract, normalise before PV).  The
// backward is not a kernel: as in the JAX package, it recomputes the plain
// math and takes its vjp.
//
// Bound on an H100: at the SVTR training shapes (N 128..512, D 32, batch
// 256) every call moves q, k, v and out once (67 MB in bfloat16) and does
// 4*BH*N*width*D operations of QK^T and PV: 77..256 operations per element,
// under the bf16 ridge of ~295, so bfloat16 is bound by the bytes (~20 us a
// call); float32 is bound by its 67 TFLOP/s CUDA-core rate.  Each score also
// costs an exp and a division, work of the same order as the memory time,
// so the softmax runs in registers and never touches shared memory.
//
// Design.  One block of 4 warps per (image*head, span of up to 128 query
// rows); a span never straddles two band query blocks (it is the block's qb
// rows, or 128 rows of a full head), so all its rows share one key window.
// The block stages its queries and the key window's K and V once into
// shared memory with 16-byte cp.async copies, zero-filling the padding, so
// each byte comes from device memory about once (K and V again from L2 for
// the other spans of a head); V's copies land while the first row tiles
// compute their scores and softmax.  Each warp owns 16-row tiles of the span and
// keeps a tile's scores for up to 8*NT keys (NT = 16 or 32 key tiles of 8)
// in registers, in the m16n8 accumulator layout: lane (g, t) = (lane/4,
// lane%4) holds rows g and g+8, keys 8j+2t and 8j+2t+1 of key tile j.
//   - bfloat16: QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16
//     in, float32 accumulate; operands from shared memory by ldmatrix, V
//     transposed on the fly).  The products are exact and the sums float32,
//     so the kernel differs from the plain version only in summation order.
//     Two neighbouring score tiles, divided by the row sum and rounded to
//     bf16 in registers, are exactly PV's A fragment of 16 keys.  D = 8 is
//     zero-padded to the mma depth of 16 (exact).
//   - float32 stays on the CUDA cores (TF32 would move the results away from
//     the plain version), register-tiled in the same layout: per 4 head dims
//     a lane loads its two query rows and two keys per tile as float4 and
//     does 16 FMAs per key tile, 8 FMAs per shared load; PV accumulates a
//     lane's own keys for 8 head dims at a time (float4 loads of V) and
//     reduce-scatters the 4 partial sums of a row across the quad by
//     shuffles, landing in the accumulator layout of the bf16 path.
//   - The row max and row sum are taken over a lane's scores and then across
//     its quad by shuffles; the mask is added in registers.  exp is expf (no
//     fast math).  The normalisation is one true division per row (1/sum)
//     and, per score, a multiply corrected by two FMAs (Markstein), which
//     returns the correctly rounded quotient, the plain version's p / sum,
//     for every p >= 2^-100 (see normalise).
//   - Two kernels.  A window of exactly 128 or 256 keys (every attention of
//     the SVTR configurations, imgW 256) runs attention_tc_kernel, one pass
//     with constant bounds on every key loop: runtime bounds, or a runtime
//     end of the window, had cost 1.3-2.7x the time at those shapes (more
//     registers and spills, or a longer schedule).  Any other window (full
//     attention over N = 512, int8 calibration's stage-1 Local Blocks; any
//     ragged N) runs attention_tc_segments_kernel: 256-key segments (K and V
//     rows past the window staged as zeros, their scores -inf), three passes
//     (row max; row sum; normalised PV) recomputing the scores, so p is
//     rounded where the one-pass kernel rounds it; no online-softmax rescale.
// The shared-memory rows are padded (16 bytes in bf16) so ldmatrix and the
// float4 loads are free of bank conflicts.  There are no atomics, so two
// launches on the same inputs are bitwise equal.  Left for later: TMA, a
// producer warp overlapping one span's loads with another's compute, wgmma,
// and the kClampExp / kMaxSubLate forms of svtr_common.cuh's SIMT attention
// (rows 3-5 of the kernel table), which can adopt this kernel's tiles.

#include <type_traits>

#include "svtr_common.cuh"

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxSpan = 128;                            // query rows per block
constexpr int kRounds = kMaxSpan / 16 / kWarps;          // 16-row tiles per warp
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int DP = kBf16 && D < 16 ? 16 : D;   // head dim padded to the mma depth
  static constexpr int P = DP + (kBf16 ? 8 : 4);         // shared row pitch (elements)
  static constexpr int E = 16 / (int)sizeof(T);          // elements per 16-byte copy
};

// The launch plan (exported as svtr_attention_plan): query rows per block,
// key tiles of 8 held in registers, key segments, passes over the keys (1:
// attention_tc_kernel, 3: attention_tc_segments_kernel), dynamic
// shared-memory bytes.
struct Plan {
  int span, key_tiles, segments, passes, smem;
};

Plan make_plan(int dtype, int N, int D, int qb, int width) {
  Plan p;
  p.span = qb < kMaxSpan ? qb : kMaxSpan;   // full attention: qb == N
  p.key_tiles = width == 128 ? 16 : 32;
  const int seg = 8 * p.key_tiles;   // K and V rows staged per segment
  p.segments = (width + seg - 1) / seg;
  p.passes = width == seg ? 1 : 3;
  const int elt = dtype == 1 ? 2 : 4;
  const int pitch = dtype == 1 ? (D < 16 ? 16 : D) + 8 : D + 4;
  p.smem = elt * pitch * (round_up(p.span, 16) + 2 * seg);
  return p;
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// --------------------------------------------------------------- staging
// rows [0, valid) of the [*, D] global matrix at src into shared rows [0,
// alloc) of pitch P; padding rows and columns are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, int valid, int alloc) {
  using L = Layout<T, D>;
  constexpr int kChunks = L::DP / L::E;
  for (int i = threadIdx.x; i < alloc * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid && c * L::E < D;
    cp_async16(dst + r * L::P + c * L::E, ok ? src + (size_t)r * D + c * L::E : src, ok);
  }
}

// ---------------------------------------------------------------- scores
// s = Q[r0 .. r0+16) K[0 .. 8 NT)^T of the staged tiles, float32, in the
// accumulator layout
template <int D, int NT>
__device__ __forceinline__ void tile_scores(float (&s)[NT][4], const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks, int r0) {
  using L = Layout<__nv_bfloat16, D>;
  constexpr int KC = L::DP / 16;
  const int lane = threadIdx.x % 32;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qa[kc], Qs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::P + kc * 16 +
                        8 * (lane >> 4));
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * jp][e] = s[2 * jp + 1][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[4];   // key tiles 2jp and 2jp+1, head dims kc*16 .. +16
      ldsm_x4(b, Ks + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * L::P + kc * 16 +
                     8 * ((lane >> 3) & 1));
      mma_bf16(s[2 * jp], qa[kc], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kc], b[2], b[3]);
    }
  }
}

// c + a.x b.x + a.y b.y + a.z b.z + a.w b.w, one FMA after another
__device__ __forceinline__ float fma4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

template <int D, int NT>
__device__ __forceinline__ void tile_scores(float (&s)[NT][4], const float* Qs, const float* Ks,
                                            int r0) {
  constexpr int P = Layout<float, D>::P;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const float* qg = Qs + (r0 + g) * P;   // rows g and g + 8
  const float* kt = Ks + 2 * t * P;      // keys 8j + 2t and 8j + 2t + 1
#pragma unroll 2
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 a = lds4(qg + 4 * d4), b = lds4(qg + 8 * P + 4 * d4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 k0 = lds4(kt + 8 * j * P + 4 * d4), k1 = lds4(kt + (8 * j + 1) * P + 4 * d4);
      s[j][0] = fma4(a, k0, s[j][0]);
      s[j][1] = fma4(a, k1, s[j][1]);
      s[j][2] = fma4(b, k0, s[j][2]);
      s[j][3] = fma4(b, k1, s[j][3]);
    }
  }
}

// keys at or beyond kn (the window's end; their K and V rows are zero) ->
// -inf; else + mask[row][k0 + key] for the span's valid rows (mrow: the
// mask row of the span's first query, pitch width)
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], int r0, int rows, int kn, int k0,
                                            const float* mrow, int width) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = 8 * j + 2 * t, row = r0 + g + 8 * h;
      float2 add = make_float2(0.f, 0.f);
      if (mrow != nullptr && row < rows) {
        const float* m = mrow + (size_t)row * width + k0 + key;
        if ((width & 1) == 0 && key < kn) {
          add = __ldg(reinterpret_cast<const float2*>(m));
        } else {
          if (key < kn) add.x = __ldg(m);
          if (key + 1 < kn) add.y = __ldg(m + 1);
        }
      }
      s[j][2 * h] = key < kn ? s[j][2 * h] + add.x : -INFINITY;
      s[j][2 * h + 1] = key + 1 < kn ? s[j][2 * h + 1] + add.y : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- softmax
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// m[h] = max(m[h], this lane's scores of row g + 8h)
template <int NT>
__device__ __forceinline__ void lane_max(const float (&s)[NT][4], float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
}

// s = exp(s - m) and l[h] += this lane's sum of row g + 8h
template <int NT>
__device__ __forceinline__ void exp_sum(float (&s)[NT][4], const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
}

// p = s / l.  One division per row gives r =
// RN(1/l); each quotient is then q = RN(s r) corrected by q + (s - q l) r,
// two FMAs (Markstein): the correctly rounded s / l, the IEEE division's
// result, for every p >= 2^-100 (s in [0, 1], l >= 1); below that the
// residual underflows and p may be one ulp off, too small to move o.  An
// inlined IEEE division per score would carry a slow-path call each.
template <int NT>
__device__ __forceinline__ void normalise(float (&s)[NT][4], const float (&l)[2]) {
  const float r[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e], rr = r[e >> 1], q = x * rr;
      s[j][e] = fmaf(fmaf(-q, l[e >> 1], x), rr, q);
    }
}

// ---------------------------------------------------------------------- PV
// o += round_T(p) V[0 .. 8 NT) in the accumulator layout (o[dn]: head dims
// 8dn .. 8dn+8)
template <int D, int NT>
__device__ __forceinline__ void tile_pv(float (&o)[Layout<__nv_bfloat16, D>::DP / 8][4],
                                        const float (&p)[NT][4], const __nv_bfloat16* Vs) {
  using L = Layout<__nv_bfloat16, D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    const uint32_t a[4] = {pack_bf16(p[2 * c][0], p[2 * c][1]),
                           pack_bf16(p[2 * c][2], p[2 * c][3]),
                           pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]),
                           pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3])};
#pragma unroll
    for (int dp = 0; dp < L::DP / 16; ++dp) {
      uint32_t b[4];   // keys 16c .. +16, head dims 16dp .. +8 and +8 .. +16
      ldsm_x4_trans(b, Vs + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::P + 16 * dp +
                           8 * (lane >> 4));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int D, int NT>
__device__ __forceinline__ void tile_pv(float (&o)[D / 8][4], const float (&p)[NT][4],
                                        const float* Vs) {
  constexpr int P = Layout<float, D>::P;
  const int lane = threadIdx.x % 32, t = lane & 3;
  const bool hi2 = t & 2, hi1 = t & 1;
#pragma unroll
  for (int dc = 0; dc < D / 8; ++dc) {
    float acc[2][8] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* vr = Vs + (8 * j + 2 * t + e) * P + 8 * dc;
        const float4 v0 = lds4(vr), v1 = lds4(vr + 4);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[h][i] = fmaf(p[j][2 * h + e], vv[i], acc[h][i]);
      }
    }
    // reduce-scatter the quad's partial sums: lane t keeps head dims 2t, 2t+1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mine = hi2 ? acc[h][4 + i] : acc[h][i];
        const float other = hi2 ? acc[h][i] : acc[h][4 + i];
        r[i] = mine + __shfl_xor_sync(kFull, other, 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mine = hi1 ? r[2 + i] : r[i];
        const float other = hi1 ? r[i] : r[2 + i];
        o[dc][2 * h + i] += mine + __shfl_xor_sync(kFull, other, 1);
      }
    }
  }
}

// out rows r0 + g, r0 + g + 8 (of the span's valid rows), head dims 8dn + 2t
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* op, const float (&o)[Layout<T, D>::DP / 8][4],
                                           int r0, int rows) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < Layout<T, D>::DP / 8; ++dn) {
    const int d = 8 * dn + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row >= rows) continue;
      T* dst = op + (size_t)row * D + d;
      if constexpr (Layout<T, D>::kBf16)
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[dn][2 * h], o[dn][2 * h + 1]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(o[dn][2 * h], o[dn][2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------- kernels
// The block's span of query rows and its key window (both kernels): grid
// BH * ceil(N / span), spans fastest; q, k, v, out [BH, N, D].  Stages the
// span's queries (zero-padded to 16-row tiles) without waiting for them.
template <typename T, int D>
struct Span {
  int rows;          // valid query rows
  const T* kp;       // the window's first key and value rows
  const T* vp;
  const float* mrow; // the mask row of the span's first query, or NULL
  T* op;             // the span's first output row

  __device__ __forceinline__ Span(const T* q, const T* k, const T* v, T* out,
                                  const float* mask, const int* starts, int N, int qb,
                                  int width, int span, T* Qs) {
    const int spans = (N + span - 1) / span;
    const int bh = blockIdx.x / spans, q0 = (blockIdx.x % spans) * span;
    rows = min(span, N - q0);
    const int kbase = starts != nullptr ? starts[q0 / qb] : 0;
    const size_t head = (size_t)bh * N * D;
    kp = k + head + (size_t)kbase * D;
    vp = v + head + (size_t)kbase * D;
    mrow = mask != nullptr ? mask + (size_t)q0 * width : nullptr;
    op = out + head + (size_t)q0 * D;
    stage<T, D>(Qs, q + head + (size_t)q0 * D, rows, round_up(rows, 16));
  }
};

// A window of exactly 8*NT keys (width == 8*NT), whose scores a warp holds
// in registers: K and V staged once, every key loop bound a constant.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(kThreads)
attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, const float* __restrict__ mask,
                    const int* __restrict__ starts, int N, int qb, int width, int span) {
  using L = Layout<T, D>;
  constexpr int kKeys = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + round_up(span, 16) * L::P;
  T* Vs = Ks + kKeys * L::P;
  const Span<T, D> sp(q, k, v, out, mask, starts, N, qb, width, span, Qs);
  const int warp = threadIdx.x / 32;

  // V arrives while the first row tiles' scores and softmax run
  stage<T, D>(Ks, sp.kp, kKeys, kKeys);
  cp_async_commit();
  stage<T, D>(Vs, sp.vp, kKeys, kKeys);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int round = 0; round < kRounds; ++round) {   // uniform: the barrier below
    const int r0 = 16 * (warp + kWarps * round);
    float s[NT][4];
    if (r0 < sp.rows) {
      tile_scores<D, NT>(s, Qs, Ks, r0);
      mask_scores<NT>(s, r0, sp.rows, kKeys, 0, sp.mrow, kKeys);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      lane_max<NT>(s, m);
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
      exp_sum<NT>(s, m, l);
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      normalise<NT>(s, l);
    }
    if (round == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (r0 < sp.rows) {
      float o[L::DP / 8][4] = {};
      tile_pv<D, NT>(o, s, Vs);
      store_tile<T, D>(sp.op, o, r0, sp.rows);
    }
  }
}

// Any other window: per round of row tiles, three passes over 256-key
// segments (row max; row sum; normalised PV), recomputing the scores.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_tc_segments_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         const float* __restrict__ mask, const int* __restrict__ starts, int N,
                         int qb, int width, int span) {
  using L = Layout<T, D>;
  constexpr int NT = 32, kKeys = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + round_up(span, 16) * L::P;
  T* Vs = Ks + kKeys * L::P;
  const Span<T, D> sp(q, k, v, out, mask, starts, N, qb, width, span, Qs);
  const int warp = threadIdx.x / 32;
  const int segments = (width + kKeys - 1) / kKeys;

  for (int round = 0; round < kRounds && 16 * kWarps * round < sp.rows; ++round) {
    const int r0 = 16 * (warp + kWarps * round);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[L::DP / 8][4] = {};
    for (int pass = 0; pass < 3; ++pass) {
      for (int sg = 0; sg < segments; ++sg) {
        const int k0 = sg * kKeys, kn = min(kKeys, width - k0);
        __syncthreads();   // the previous segment's readers are done
        stage<T, D>(Ks, sp.kp + (size_t)k0 * D, kn, kKeys);
        if (pass == 2) stage<T, D>(Vs, sp.vp + (size_t)k0 * D, kn, kKeys);
        cp_async_wait_all();
        __syncthreads();
        if (r0 >= sp.rows) continue;
        float s[NT][4];
        tile_scores<D, NT>(s, Qs, Ks, r0);
        mask_scores<NT>(s, r0, sp.rows, kn, k0, sp.mrow, width);
        if (pass == 0) {
          lane_max<NT>(s, m);
        } else if (pass == 1) {
          exp_sum<NT>(s, m, l);
        } else {
          float unused[2] = {0.f, 0.f};
          exp_sum<NT>(s, m, unused);
          normalise<NT>(s, l);
          tile_pv<D, NT>(o, s, Vs);
        }
      }
      if (pass == 0) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      } else if (pass == 1) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
    }
    if (r0 < sp.rows) store_tile<T, D>(sp.op, o, r0, sp.rows);
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, const float*, const int*, int, int,
                        int, int);

template <typename T>
cudaError_t launch(Kernel<T> kernel, const void* q, const void* k, const void* v, void* out,
                   const float* mask, const int* starts, int BH, int N, int qb, int width,
                   const Plan& plan, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)BH * ((N + plan.span - 1) / plan.span);
  kernel<<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), mask, starts, N, qb, width, plan.span);
  return cudaGetLastError();
}

template <typename T, int D>
Kernel<T> pick(const Plan& plan) {
  if (plan.passes == 3) return &attention_tc_segments_kernel<T, D>;
  return plan.key_tiles == 16 ? &attention_tc_kernel<T, D, 16> : &attention_tc_kernel<T, D, 32>;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, const float* mask,
                     const int* starts, int BH, int N, int D, int qb, int width,
                     const Plan& plan, cudaStream_t s) {
  Kernel<T> kernel;
  switch (D) {
    case 8: kernel = pick<T, 8>(plan); break;
    case 16: kernel = pick<T, 16>(plan); break;
    case 32: kernel = pick<T, 32>(plan); break;
    case 64: kernel = pick<T, 64>(plan); break;
    default: return cudaErrorInvalidValue;
  }
  return launch<T>(kernel, q, k, v, out, mask, starts, BH, N, qb, width, plan, s);
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q, k, v, out: [BH, N, D] contiguous in the
// working type, 16-byte aligned.  Full attention: starts NULL, width == N,
// qb == N, mask [N, N] or NULL.  Banded: starts int32 [N / qb] on the
// device, qb a multiple of 32, mask [N, width].  Returns 0 or the CUDA error
// code of the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
int svtr_attention_forward(int dtype, const void* q, const void* k, const void* v,
                           const float* mask, const int* starts, void* out, int BH,
                           int N, int D, int qb, int width, void* stream) {
  if (BH <= 0 || N <= 0 || width <= 0 || qb <= 0) return (int)cudaErrorInvalidValue;
  if (starts == nullptr && (width != N || qb != N)) return (int)cudaErrorInvalidValue;
  if (starts != nullptr && (qb % QT != 0 || N % qb != 0 || width > N))
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(mask)))
    return (int)cudaErrorMisalignedAddress;
  const Plan plan = make_plan(dtype, N, D, qb, width);
  if ((size_t)plan.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, mask, starts, BH, N, D, qb, width, plan, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, mask, starts, BH, N, D, qb, width, plan, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of svtr_attention_forward for these arguments: out[0..4]
// = query rows per block, key tiles held in registers, key segments, passes
// over the keys, dynamic shared-memory bytes.
int svtr_attention_plan(int dtype, int N, int D, int qb, int width, int* out) {
  const Plan p = make_plan(dtype, N, D, qb, width);
  out[0] = p.span;
  out[1] = p.key_tiles;
  out[2] = p.segments;
  out[3] = p.passes;
  out[4] = p.smem;
  return 0;
}

const char* svtr_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
