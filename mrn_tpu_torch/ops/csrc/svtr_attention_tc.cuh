// Tile attention for Hopper (sm_90a), shared by the four sources whose
// Pallas kernels attend: svtr_attention.cu (the composed training path's
// full and banded forwards, rows 1-2 of the kernel table), svtr_block_int8.cu
// (the w8a8 inference Block's float attention, row 3), svtr_block.cu (the
// inference Block, row 4) and svtr_train_block.cu (the training Block
// forward, row 5).  The softmax form is a template parameter, with the names
// of svtr_common.cuh:
//   kMaxSubEarly (rows 1-3): p = exp(s - max) / sum, correctly rounded
//     (Markstein, see normalise), rounded to T before PV;
//   kClampExp (row 4): p = round_T(exp(min(s, 60))), no row max; the row sum
//     over the rounded p; o * 1 / (sum + 1e-30) after PV;
//   kMaxSubLate (row 5): p = round_T(exp(s - max)); the row sum over the
//     rounded p; o * 1 / (sum + 1e-30) after PV.
// The two late forms need one reciprocal per row and one multiply per
// output, no per-score division.
//
// Rows are strided: image b, head h, token r reads q at q[(b N + r) q_ld +
// h D], k and v at [(b N + r) kv_ld + h D] and writes out[(b N + r) out_ld +
// h D] (rows 3-4: q, k, v inside qkv [B, N, 3C]; row 5: q from q_scaled [B,
// N, C]; out [B, N, C]).  Rows 1-2 read packed [BH, N, D] (heads 1, every
// stride D), a layout they take at compile time (PACKED): runtime strides
// there had cost 6-10% in bf16 (PERF.md, section 6).  The output is in T,
// or float32 for row 3 (O).  Every row starts 16-byte aligned (the C side
// refuses otherwise).
//
// Design.  One block of 4 warps per (image, head, span of up to 128 query
// rows); a span never straddles two band query blocks (it is the block's qb
// rows, or 128 rows of a full head), so all its rows share one key window.
// The block stages its queries and the key window's K and V once into
// shared memory with 16-byte cp.async copies, zero-filling the padding; V's
// copies land while the first row tiles compute their scores and softmax.
// Each warp owns 16-row tiles of the span and keeps a tile's scores for 8*NT
// keys (NT = 16 or 32 key tiles of 8) in registers, in the m16n8
// accumulator layout: lane (g, t) = (lane/4, lane%4) holds rows g and g+8,
// keys 8j+2t and 8j+2t+1 of key tile j.
//   - bfloat16: QK^T and PV on the tensor cores (mma.sync m16n8k16, bf16 in,
//     float32 accumulate; operands by ldmatrix, V transposed on the fly).
//     The products are exact and the sums float32.  Two neighbouring score
//     tiles rounded to bf16 are exactly PV's A fragment of 16 keys.  D = 8
//     is zero-padded to the mma depth of 16 (exact).
//   - float32 stays on the CUDA cores (TF32 would move the results away from
//     the plain versions), register-tiled in the same layout: float4 loads of
//     Q and K, 16 FMAs per key tile; PV accumulates a lane's own keys for 8
//     head dims at a time and reduce-scatters the quad's partial sums by
//     shuffles into the accumulator layout of the bf16 path.
//   - The row max and row sum are taken over a lane's scores and then across
//     its quad by shuffles; the mask is added in registers; exp is expf.
//   - Two kernels.  A window of exactly 128 or 256 keys (every attention of
//     the SVTR configurations, imgW 256) runs attention_tc_kernel, one pass
//     with constant bounds on every key loop: runtime bounds, or a runtime
//     end of the window, cost 1.3-2.7x the time at those shapes (PERF.md,
//     section 6).  Any other window runs attention_tc_segments_kernel over
//     256-key segments (K and V rows past the window staged as zeros, their
//     scores -inf), recomputing the scores in as many passes as its form needs:
//     kMaxSubEarly three (max; sum; normalised PV), kMaxSubLate two (max;
//     sum and PV), kClampExp one (sum and PV).  No online-softmax rescale,
//     so p is rounded where the one-pass kernel rounds it.
// The shared-memory rows are padded (16 bytes in bf16) so ldmatrix and the
// float4 loads are free of bank conflicts.  There are no atomics, so two
// launches on the same inputs are bitwise equal.  The plan (rows per block,
// key tiles, segments, passes, shared bytes) lives here only; each library
// exports it for its form.

#pragma once

#include <type_traits>

#include "svtr_common.cuh"
#include "svtr_mma.cuh"

namespace {

constexpr int kTcWarps = 4, kTcThreads = 32 * kTcWarps;
constexpr int kMaxSpan = 128;                             // query rows per block
constexpr int kRounds = kMaxSpan / 16 / kTcWarps;         // 16-row tiles per warp
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int DP = kBf16 && D < 16 ? 16 : D;   // head dim padded to the mma depth
  static constexpr int P = DP + (kBf16 ? 8 : 4);         // shared row pitch (elements)
  static constexpr int E = 16 / (int)sizeof(T);          // elements per 16-byte copy
};

// passes over the keys of attention_tc_segments_kernel in each form
__host__ __device__ constexpr int segment_passes(int softmax) {
  return softmax == kMaxSubEarly ? 3 : softmax == kMaxSubLate ? 2 : 1;
}

// The launch plan: query rows per block, key tiles of 8 held in registers,
// key segments, passes over the keys, dynamic shared-memory bytes.  A window
// of exactly 8 * key_tiles keys runs attention_tc_kernel, any other
// attention_tc_segments_kernel (in kClampExp also in one pass).
struct Plan {
  int span, key_tiles, segments, passes, smem;
  bool one_pass_kernel(int width) const { return width == 8 * key_tiles; }
};

Plan make_plan(int softmax, int dtype, int N, int D, int qb, int width) {
  Plan p;
  p.span = qb < kMaxSpan ? qb : kMaxSpan;   // full attention: qb == N
  p.key_tiles = width == 128 ? 16 : 32;
  const int seg = 8 * p.key_tiles;   // K and V rows staged per segment
  p.segments = (width + seg - 1) / seg;
  p.passes = width == seg ? 1 : segment_passes(softmax);
  const int elt = dtype == 1 ? 2 : 4;
  const int pitch = dtype == 1 ? (D < 16 ? 16 : D) + 8 : D + 4;
  p.smem = elt * pitch * (round_up(p.span, 16) + 2 * seg);
  return p;
}

void export_plan(const Plan& p, int* out) {
  out[0] = p.span;
  out[1] = p.key_tiles;
  out[2] = p.segments;
  out[3] = p.passes;
  out[4] = p.smem;
}

// The kernels' arguments: row r of image b, head h as in the header note;
// out in O (T, or float32 for row 3); mask [N, width] float32 or NULL;
// starts int32 [N / qb] or NULL (one window [0, width) for every query);
// span from the plan.
template <typename T, typename O = T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  O* out;
  const float* mask;
  const int* starts;
  int heads, N, qb, width, span;
  int q_ld, kv_ld, out_ld;
};

// --------------------------------------------------------------- staging
// rows [0, valid) of the global matrix at src (row stride ld, D columns)
// into shared rows [0, alloc) of pitch P; padding rows and columns are
// zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, int ld, int valid, int alloc) {
  using L = Layout<T, D>;
  constexpr int kChunks = L::DP / L::E;
  for (int i = threadIdx.x; i < alloc * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid && c * L::E < D;
    cp_async16(dst + r * L::P + c * L::E, ok ? src + (size_t)r * ld + c * L::E : src, ok);
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

// The late forms: p = round_T(exp(min(s, 60))) (kClampExp, m unused) or
// round_T(exp(s - m)) (kMaxSubLate), and l[h] += this lane's sum of the
// rounded p of row g + 8h
template <typename T, int SOFTMAX, int NT>
__device__ __forceinline__ void exp_round_sum(float (&s)[NT][4], const float (&m)[2],
                                              float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = SOFTMAX == kClampExp ? fminf(s[j][e], kScoreClamp) : s[j][e] - m[e >> 1];
      s[j][e] = round_to<T>(expf(x));
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

// The whole softmax of a tile held in registers (the one-pass kernel):
// kMaxSubEarly leaves the normalised p and r = 1; the late forms leave the
// rounded p and r[h] = 1 / (row sum + 1e-30), applied after PV.
template <typename T, int SOFTMAX, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&r)[2]) {
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (SOFTMAX != kClampExp) {
    lane_max<NT>(s, m);
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
  }
  if constexpr (SOFTMAX == kMaxSubEarly) {
    exp_sum<NT>(s, m, l);
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    normalise<NT>(s, l);
  } else {
    exp_round_sum<T, SOFTMAX, NT>(s, m, l);
    r[0] = 1.0f / (quad_sum(l[0]) + 1e-30f);
    r[1] = 1.0f / (quad_sum(l[1]) + 1e-30f);
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

// out rows r0 + g, r0 + g + 8 (of the span's valid rows; row stride ld),
// head dims 8dn + 2t, times the row's r[h] when SCALE (the late forms), in
// the output type O
template <typename T, typename O, int D, bool SCALE>
__device__ __forceinline__ void store_tile(O* op, int ld,
                                           const float (&o)[Layout<T, D>::DP / 8][4],
                                           const float (&r)[2], int r0, int rows) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < Layout<T, D>::DP / 8; ++dn) {
    const int d = 8 * dn + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row >= rows) continue;
      float v0 = o[dn][2 * h], v1 = o[dn][2 * h + 1];
      if constexpr (SCALE) {
        v0 *= r[h];
        v1 *= r[h];
      }
      O* dst = op + (size_t)row * ld + d;
      if constexpr (std::is_same<O, __nv_bfloat16>::value)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    }
  }
}

// ----------------------------------------------------------------- kernels
// PACKED: row strides known at compile time.  Rows 1-2 read packed [BH, N,
// D] rows (heads 1, every stride D), which keeps their address arithmetic
// constant; rows 3-5 read strided rows of qkv.

// The block's span of query rows and its key window (both kernels): grid
// batch * heads * ceil(N / span), spans fastest.  Stages the span's queries
// (zero-padded to 16-row tiles) without waiting for them.
template <typename T, typename O, int D, bool PACKED>
struct Span {
  int rows;          // valid query rows
  const T* kp;       // the window's first key and value rows
  const T* vp;
  const float* mrow; // the mask row of the span's first query, or NULL
  O* op;             // the span's first output row

  __host__ __device__ static constexpr int ld(int runtime) { return PACKED ? D : runtime; }

  __device__ __forceinline__ Span(const AttnArgs<T, O>& a, T* Qs) {
    const int spans = (a.N + a.span - 1) / a.span;
    const int bh = blockIdx.x / spans, q0 = (blockIdx.x % spans) * a.span;
    const int b = PACKED ? bh : bh / a.heads, h = PACKED ? 0 : bh % a.heads;
    rows = min(a.span, a.N - q0);
    const int kbase = a.starts != nullptr ? a.starts[q0 / a.qb] : 0;
    const size_t row0 = (size_t)b * a.N;
    kp = a.k + (row0 + kbase) * ld(a.kv_ld) + h * D;
    vp = a.v + (row0 + kbase) * ld(a.kv_ld) + h * D;
    mrow = a.mask != nullptr ? a.mask + (size_t)q0 * a.width : nullptr;
    op = a.out + (row0 + q0) * ld(a.out_ld) + h * D;
    stage<T, D>(Qs, a.q + (row0 + q0) * ld(a.q_ld) + h * D, ld(a.q_ld), rows,
                round_up(rows, 16));
  }
};

// A window of exactly 8*NT keys (width == 8*NT), whose scores a warp holds
// in registers: K and V staged once, every key loop bound a constant.
template <typename T, int D, int NT, int SOFTMAX, bool PACKED, typename O>
__global__ void __launch_bounds__(kTcThreads) attention_tc_kernel(const AttnArgs<T, O> a) {
  using L = Layout<T, D>;
  constexpr int kKeys = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + round_up(a.span, 16) * L::P;
  T* Vs = Ks + kKeys * L::P;
  using S = Span<T, O, D, PACKED>;
  const S sp(a, Qs);
  const int warp = threadIdx.x / 32;

  // V arrives while the first row tiles' scores and softmax run
  stage<T, D>(Ks, sp.kp, S::ld(a.kv_ld), kKeys, kKeys);
  cp_async_commit();
  stage<T, D>(Vs, sp.vp, S::ld(a.kv_ld), kKeys, kKeys);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int round = 0; round < kRounds; ++round) {   // uniform: the barrier below
    const int r0 = 16 * (warp + kTcWarps * round);
    float s[NT][4];
    float r[2] = {1.f, 1.f};
    if (r0 < sp.rows) {
      tile_scores<D, NT>(s, Qs, Ks, r0);
      mask_scores<NT>(s, r0, sp.rows, kKeys, 0, sp.mrow, kKeys);
      softmax_tile<T, SOFTMAX, NT>(s, r);
    }
    if (round == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (r0 < sp.rows) {
      float o[L::DP / 8][4] = {};
      tile_pv<D, NT>(o, s, Vs);
      store_tile<T, O, D, SOFTMAX != kMaxSubEarly>(sp.op, S::ld(a.out_ld), o, r, r0, sp.rows);
    }
  }
}

// Any other window: per round of row tiles, segment_passes(SOFTMAX) passes
// over 256-key segments, recomputing the scores.  Pass roles: 0 the row
// max, 1 the row sum (kMaxSubEarly), 2 PV (with the row sum of the rounded
// p in the late forms).
template <typename T, int D, int SOFTMAX, bool PACKED, typename O>
__global__ void __launch_bounds__(kTcThreads)
attention_tc_segments_kernel(const AttnArgs<T, O> a) {
  using L = Layout<T, D>;
  constexpr int NT = 32, kKeys = 8 * NT;
  constexpr int kPasses = segment_passes(SOFTMAX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + round_up(a.span, 16) * L::P;
  T* Vs = Ks + kKeys * L::P;
  using S = Span<T, O, D, PACKED>;
  const S sp(a, Qs);
  const int warp = threadIdx.x / 32;
  const int segments = (a.width + kKeys - 1) / kKeys;

  for (int round = 0; round < kRounds && 16 * kTcWarps * round < sp.rows; ++round) {
    const int r0 = 16 * (warp + kTcWarps * round);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[L::DP / 8][4] = {};
    for (int pass = 0; pass < kPasses; ++pass) {
      const int role = kPasses == 3 ? pass : kPasses == 2 ? 2 * pass : 2;
      for (int sg = 0; sg < segments; ++sg) {
        const int k0 = sg * kKeys, kn = min(kKeys, a.width - k0);
        __syncthreads();   // the previous segment's readers are done
        const int kv_ld = S::ld(a.kv_ld);
        stage<T, D>(Ks, sp.kp + (size_t)k0 * kv_ld, kv_ld, kn, kKeys);
        if (role == 2) stage<T, D>(Vs, sp.vp + (size_t)k0 * kv_ld, kv_ld, kn, kKeys);
        cp_async_wait_all();
        __syncthreads();
        if (r0 >= sp.rows) continue;
        float s[NT][4];
        tile_scores<D, NT>(s, Qs, Ks, r0);
        mask_scores<NT>(s, r0, sp.rows, kn, k0, sp.mrow, a.width);
        if (role == 0) {
          lane_max<NT>(s, m);
        } else if (role == 1) {
          exp_sum<NT>(s, m, l);
        } else if constexpr (SOFTMAX == kMaxSubEarly) {
          float unused[2] = {0.f, 0.f};
          exp_sum<NT>(s, m, unused);
          normalise<NT>(s, l);
          tile_pv<D, NT>(o, s, Vs);
        } else {
          exp_round_sum<T, SOFTMAX, NT>(s, m, l);
          tile_pv<D, NT>(o, s, Vs);
        }
      }
      if (role == 0) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      } else if (role == 1) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
    }
    float r[2] = {1.f, 1.f};
    if constexpr (SOFTMAX != kMaxSubEarly) {
      r[0] = 1.0f / (quad_sum(l[0]) + 1e-30f);
      r[1] = 1.0f / (quad_sum(l[1]) + 1e-30f);
    }
    if (r0 < sp.rows)
      store_tile<T, O, D, SOFTMAX != kMaxSubEarly>(sp.op, S::ld(a.out_ld), o, r, r0, sp.rows);
  }
}

template <typename T, typename O>
using AttnKernel = void (*)(AttnArgs<T, O>);

template <typename T, int D, int SOFTMAX, bool PACKED, typename O>
AttnKernel<T, O> pick_attention(const Plan& plan, int width) {
  if (!plan.one_pass_kernel(width))
    return &attention_tc_segments_kernel<T, D, SOFTMAX, PACKED, O>;
  return plan.key_tiles == 16 ? &attention_tc_kernel<T, D, 16, SOFTMAX, PACKED, O>
                              : &attention_tc_kernel<T, D, 32, SOFTMAX, PACKED, O>;
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tile attention over `batch` images of `heads` heads (head dim D in {8,
// 16, 32, 64}): full (starts NULL, qb == width == N, mask [N, N] or NULL)
// or banded (starts int32 [N / qb] on the device, qb a multiple of QT, N a
// multiple of qb, mask [N, width]).  PACKED: heads 1 and every row stride
// D.  The output in O (T, or float).  Every pointer and row stride 16-byte
// aligned.  Returns the launch's CUDA error, or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for arguments it does not take.
template <typename T, int SOFTMAX, bool PACKED, typename O = T>
cudaError_t attention_tc(const T* q, int q_ld, const T* k, const T* v, int kv_ld, O* out,
                         int out_ld, const float* mask, const int* starts, int batch,
                         int heads, int N, int D, int qb, int width, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || N <= 0 || width <= 0 || qb <= 0) return cudaErrorInvalidValue;
  if (starts == nullptr && (width != N || qb != N)) return cudaErrorInvalidValue;
  if (starts != nullptr && (qb % QT != 0 || N % qb != 0 || width > N))
    return cudaErrorInvalidValue;
  const int row_bytes = (int)sizeof(T);
  if (PACKED && (heads != 1 || q_ld != D || kv_ld != D || out_ld != D))
    return cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(mask)) ||
      (q_ld * row_bytes) % 16 || (kv_ld * row_bytes) % 16 || (out_ld * (int)sizeof(O)) % 16)
    return cudaErrorMisalignedAddress;
  const Plan plan = make_plan(SOFTMAX, std::is_same<T, float>::value ? 0 : 1, N, D, qb, width);
  if ((size_t)plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  AttnKernel<T, O> kernel;
  switch (D) {
    case 8: kernel = pick_attention<T, 8, SOFTMAX, PACKED, O>(plan, width); break;
    case 16: kernel = pick_attention<T, 16, SOFTMAX, PACKED, O>(plan, width); break;
    case 32: kernel = pick_attention<T, 32, SOFTMAX, PACKED, O>(plan, width); break;
    case 64: kernel = pick_attention<T, 64, SOFTMAX, PACKED, O>(plan, width); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const AttnArgs<T, O> a{q, k, v, out, mask, starts, heads, N, qb, width, plan.span,
                         q_ld, kv_ld, out_ld};
  const unsigned grid = (unsigned)batch * heads * ((N + plan.span - 1) / plan.span);
  kernel<<<grid, kTcThreads, plan.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
