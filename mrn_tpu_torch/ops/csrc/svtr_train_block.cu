// Fused SVTR training Block for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three Pallas TPU kernels of mrn_tpu/ops/svtr_train_block.py:
//   - _make_train_kernel (via _forward), entry svtr_train_forward:
//       y   = x + dm_a * proj(attention(LN1(x) @ Wqkv + bqkv))
//       out = y + dm_b * fc2(gelu15(LN2(y) @ W1 + b1))
//     writing out and the residuals qkv [B,N,3C], attn [B,N,C], y [B,N,C],
//     h1 [B,N,4C] in the working type T (float or bfloat16);
//   - _make_bwd_tail_kernel (via _bwd_pallas), entry svtr_train_bwd_tail:
//     MLP + LN2 + proj backward, g, y, h1, attn -> dy, dattn (T) and dW2,
//     db2, dW1, db1, dn2s, dn2b, dWp, dbp (float32, summed over all B*N rows);
//   - _make_bwd_head_kernel (via _bwd_pallas), entry svtr_train_bwd_head:
//     qkv projection + LN1 backward, x, dy, dqkv -> dx (T) and dWqkv, dbqkv,
//     dn1s, dn1b.
// The attention backward between tail and head is not a kernel, in the JAX
// package as here: the caller takes the vjp of the plain formulation.
//
// Numerics are the Pallas bodies': single-pass LayerNorm (E[x^2] - mean^2,
// eps 1e-6) with the affine applied in float32; every product takes both
// operands rounded to T with float32 accumulation; softmax with max-subtract,
// exp(s - m) rounded to T before PV, the row sum over those rounded values
// and the normalise after PV with +1e-30; q scaled from the float32 qkv
// accumulator before it is rounded; y and h1 kept in float32 for LN2, the
// final residual and the GELU (degree-15 erf polynomial); the backward
// recomputes LN statistics from the rounded residuals and reads the norm
// scales as float32.  Per-image droppath scales dm_a, dm_b [B] are float32.
//
// Bound on an H100: per Block and image the forward's four projections are
// 24*N*C^2 operations and the backward's eight 48*N*C^2, against ~(11 C +
// 8 C) * N elements moved: in bf16 the bytes hold each entry point (about
// 100-300 operations a byte, at or below the tensor cores' ridge), in
// float32 the 67 TFLOP/s of the CUDA cores.  What the Pallas bodies keep out
// of device memory (the score tile, the GELU chain) stays in shared memory
// or registers here too.
//
// Design: several launches per entry point.
//   - The forward's four projections run the main loops of svtr_gemm_tc.cuh
//     (proj_kernel): bf16 on the tensor cores (mma.sync m16n8k16), float32
//     register-tiled on the CUDA cores; LayerNorm with its affine on the A
//     loads (LayerNormRows, the statistics of a block's rows computed in the
//     kernel), bias, q-scale, residual, GELU and droppath in the epilogues.
//   - Its attention is the tile attention of svtr_attention_tc.cuh in its
//     kMaxSubLate form, q from q_scaled [B, N, C], k and v inside qkv.
//   - The backward's four data gradients (dh1, dz2, dattn, dz1: row-parallel
//     products with the weight transposed) run the same proj main loops,
//     each weight first transposed into the work buffer to proj's [K, Nout]
//     (one small launch per entry point); the droppath scale of g rides on
//     the A loads (ScaledRows), gelu15'(h1) and db1's column sums on the
//     epilogue (Dh1Epi).
//   - dh1 and da, which the Pallas bodies keep in float32, are stored in T:
//     every product that reads them rounds them to T first, and their sums
//     (db1, dbp) are taken from the float32 values before the rounding.  In
//     bf16 that halves the largest intermediate's traffic.
//   - Its four weight gradients (dW2, dW1, dWp, dWqkv: products over all B*N
//     rows) run weight_grad of svtr_wgrad_tc.cuh: both operands m-major
//     through a cp.async ring, each side's map (GELU of h1, LN2 of y or LN1
//     of x from the row statistics of row_stats, droppath-scaled g) on the
//     landed tile, bf16 mma.sync or float32 register tiles; the rows split
//     into a fixed number of chunks whose partial tiles are summed in chunk
//     order, with the bias sums (db2, dbqkv) of the unrounded float32 B
//     folded into the same pass.  No float atomics, so the same inputs give
//     bitwise-identical outputs and grads.
//   - The LayerNorm backward is a row kernel: C / 8 lanes (up to 32) a row,
//     16-byte chunks, several rows a warp, column partials for dn_s, dn_b
//     (and dbp) in shared memory per lane group, combined in group order,
//     then per block in order.
// Left for later: wgmma and TMA, fusing the LayerNorm backward into the dz
// epilogues, and keeping the Block's intermediates on chip across the
// launches.

#include <algorithm>

#include "svtr_attention_tc.cuh"
#include "svtr_gemm_tc.cuh"
#include "svtr_wgrad_tc.cuh"

namespace {

constexpr float kFourOverZ0Sq = (float)(4.0 / (3.7 * 3.7));

// d/dx gelu15 with the same polynomial and clip (ops/svtr_train_block.py
// _gelu15_grad)
__device__ __forceinline__ float gelu15_grad(float x) {
  const float z = x * kRsqrt2;
  const float zsq = z * z;
  const float u = kTwoOverZ0Sq * fminf(zsq, kErfZ0Sq) - 1.0f;
  float p = kErf15[15], dp = 0.f;
#pragma unroll
  for (int i = 14; i >= 0; --i) {
    dp = dp * u + p;
    p = p * u + kErf15[i];
  }
  const float e_raw = z * p;
  const float du_dz = zsq < kErfZ0Sq ? kFourOverZ0Sq * z : 0.f;
  float de = p + z * dp * du_dz;
  if (!(fabsf(e_raw) < 1.0f)) de = 0.f;
  const float e = fminf(fmaxf(e_raw, -1.0f), 1.0f);
  return 0.5f * (1.0f + e) + 0.5f * x * de * kRsqrt2;
}

// ------------------------------------------------------------------ loaders
// Row-major sources for the backward's main loops, besides Mat of
// svtr_common.cuh.  weight_grad (svtr_wgrad_tc.cuh) takes each on either
// side: row_state(m) fetches what the map reads for row m (a k-tile ahead,
// off the map's path), map8(state, k, v) maps the float32 values of
// columns k .. k + 8 in place.  ScaledRows is also proj's A
// (svtr_gemm_tc.cuh), which maps through map8(m, k, v).

template <typename S>
struct ScaledRows {   // x[m, k] * dm[m / n] (droppath-scaled cotangent)
  using Src = S;
  using Row = float;
  static constexpr bool kMap = true, kWholeRows = false;
  const S* x;
  const float* dm;
  int ld, n;
  __device__ __forceinline__ const S* row(int m) const { return x + (size_t)m * ld; }
  __device__ __forceinline__ float row_state(int m) const { return dm[m / n]; }
  __device__ __forceinline__ void map8(float d, int, float (&v)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= d;
  }
  __device__ __forceinline__ void map8(int m, int k, float (&v)[8]) const {
    map8(row_state(m), k, v);
  }
  __device__ void prepare(int) {}
};

template <typename S>
struct GeluRows {   // gelu15(h[m, k])
  using Src = S;
  using Row = NoRow;
  static constexpr bool kMap = true;
  const S* h;
  int ld;
  __device__ __forceinline__ const S* row(int m) const { return h + (size_t)m * ld; }
  __device__ __forceinline__ NoRow row_state(int) const { return {}; }
  __device__ __forceinline__ void map8(NoRow, int, float (&v)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu15(v[e]);
  }
};

template <typename S>
struct LnRows {   // ((x[m, k] - mean_m) * rstd_m) * s[k] + b[k]
  using Src = S;
  using Row = float2;   // mean, rstd
  static constexpr bool kMap = true;
  const S* x;
  const float* stats;   // [rows, 2]: mean, rstd (row_stats)
  const float* s;
  const float* b;
  int ld;
  __device__ __forceinline__ const S* row(int m) const { return x + (size_t)m * ld; }
  __device__ __forceinline__ float2 row_state(int m) const {
    return __ldg(reinterpret_cast<const float2*>(stats) + m);
  }
  __device__ __forceinline__ void map8(float2 st, int k, float (&v)[8]) const {
    float sc[8], sh[8];
    load8(s + k, sc);
    load8(b + k, sh);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ((v[e] - st.x) * st.y) * sc[e] + sh[e];
  }
};

// ---------------------------------------------------------------- epilogues
// The forward's epilogues take columns j .. j + 8 of row i of the float32
// accumulator v (svtr_gemm_tc.cuh); prefetch loads the residual, if any.

template <typename T>
struct QkvEpi {  // qkv = acc + b (T); the q columns also as round(qkv_f32 * scale)
  const float* bias;
  T* qkv;
  T* q_scaled;
  int c;
  float scale;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += b[e];
    store8(qkv + (size_t)i * 3 * c + j, v);
    if (j < c) {   // c is a multiple of 8: a chunk is all q or none
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
      store8(q_scaled + (size_t)i * c + j, v);
    }
  }
};

template <typename T>
struct ProjEpi {  // y = x + (acc + b) * dm_a: rounded residual and float32 copy
  const float* bias;
  const T* x;
  const float* dm;
  T* y;
  float* y32;
  int c, n;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(x + (size_t)i * c + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    float b[8];
    load8(bias + j, b);
    const float d = dm[i / n];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r[e] + (v[e] + b[e]) * d;
    store8(y + (size_t)i * c + j, v);
    store8(y32 + (size_t)i * c + j, v);
  }
};

template <typename T>
struct Fc1Epi {  // h1 = acc + b (T) and gelu15 of the float32 h1 (T)
  const float* bias;
  T* h1;
  T* gact;
  int hidden;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += b[e];
    store8(h1 + (size_t)i * hidden + j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu15(v[e]);
    store8(gact + (size_t)i * hidden + j, v);
  }
};

template <typename T>
struct Fc2Epi {  // out = y32 + (acc + b) * dm_b
  const float* bias;
  const float* y32;
  const float* dm;
  T* out;
  int c, n;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(y32 + (size_t)i * c + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    float b[8];
    load8(bias + j, b);
    const float d = dm[i / n];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r[e] + (v[e] + b[e]) * d;
    store8(out + (size_t)i * c + j, v);
  }
};

// The backward's data-gradient epilogues, in the same 8-column form.

// dh1 = dgv * gelu15'(h1): rounded to T for the products that take it, and
// its float32 column sums (db1) per 128-row block into part [row blocks,
// hidden].  Two chunks a round: gelu15' is long, and four spilled.
template <typename T>
struct Dh1Epi {
  static constexpr int kRound = 2;
  static constexpr bool kColumnSums = true;
  const T* h1;
  T* dh1;
  float* part;
  int hidden;
  __device__ void prefetch(int i, int j, float (&r)[8]) const {
    load8(h1 + (size_t)i * hidden + j, r);
  }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8],
                             float (&sums)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] *= gelu15_grad(r[e]);
      sums[e] += v[e];
    }
    store8(dh1 + (size_t)i * hidden + j, v);
  }
  __device__ void columns(int rb, int j, float s) const { part[(size_t)rb * hidden + j] = s; }
};

template <typename S>
struct StoreEpi {  // out = acc, rounded to S
  S* out;
  int ld;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    store8(out + (size_t)i * ld + j, v);
  }
};

// ------------------------------------------------------------------- kernels
// dst [cols, rows] = the transpose of src [rows, cols], for up to three
// matrices at once (blockIdx.z): the backward's data gradients take each
// weight as proj's [K, Nout] operand.
template <typename T>
struct TransposeJobs {
  const T* src[3];
  T* dst[3];
  int rows[3], cols[3];
};

template <typename T>
__global__ void transpose_kernel(TransposeJobs<T> jobs) {
  __shared__ T tile[32][33];
  const int z = blockIdx.z, rows = jobs.rows[z], cols = jobs.cols[z];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  if (r0 >= rows || c0 >= cols) return;
  const T* src = jobs.src[z];
  T* dst = jobs.dst[z];
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) dst[(size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

template <typename T>
cudaError_t transpose(const TransposeJobs<T>& jobs, int count, cudaStream_t stream) {
  int rows = 0, cols = 0;
  for (int z = 0; z < count; ++z) {
    rows = std::max(rows, jobs.rows[z]);
    cols = std::max(cols, jobs.cols[z]);
  }
  transpose_kernel<T><<<dim3((cols + 31) / 32, (rows + 31) / 32, count), dim3(32, 8), 0,
                        stream>>>(jobs);
  return cudaGetLastError();
}

// T elements as a count of floats, rounded up to 16 bytes
inline long long floats_of(long long elements) { return (elements + 3) / 4 * 4; }

// LayerNorm backward rows: with tn = (t - mean) * rstd and d = dz * s, v =
// res + rstd * (d - mean(d) - tn * mean(d tn)) -> out_t (T).  TAIL: res =
// g, v is dy, and da = dy * dm_a -> out_f (T, the operand of the products).
// Column partials per block: sum dz*tn, sum dz (and the unrounded sum da).
// G lanes take a row (G the largest power of two up to 32 that divides C /
// 8), each 16-byte chunks of 8 columns, so a warp holds 32 / G rows at once.
// Each lane group keeps its column partials in shared memory, element e of
// chunk ch at e * C / 8 + ch and the groups G floats apart, so the lanes of
// a warp add into 32 different banks; the groups are combined in order.
constexpr int kRowThreads = 256, kRowWarps = kRowThreads / 32;

inline int row_lanes(int C) {
  int g = 32;
  while (g > 1 && (C / 8) % g) g /= 2;
  return g;
}

// rows per block: a multiple of the block's row groups, about four blocks
// per SM of the card's 132
inline int rows_per_block(int M, int C) {
  const int groups = kRowWarps * (32 / row_lanes(C));
  const int r = (M + 4 * 132 - 1) / (4 * 132);
  return std::max(groups, (r + groups - 1) / groups * groups);
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics per row, mean and rsqrt(E[x^2] - mean^2 + 1e-6),
// G lanes a row as in the row kernel below
template <typename S, int G>
__global__ void __launch_bounds__(kRowThreads)
row_stats_kernel(const S* __restrict__ x, float* __restrict__ stats, int M, int C) {
  const int m = (blockIdx.x * kRowThreads + threadIdx.x) / G, gl = threadIdx.x % G;
  float s = 0.f, ss = 0.f;
  if (m < M)
    for (int ch = gl; ch < C / 8; ch += G) {
      float v[8];
      load8(x + (size_t)m * C + 8 * ch, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
  s = group_sum<G>(s);
  ss = group_sum<G>(ss);
  if (m < M && gl == 0) {
    const float mean = s / C;
    const float var = ss / C - mean * mean;
    stats[2 * m] = mean;
    stats[2 * m + 1] = rsqrtf(var + 1e-6f);
  }
}

template <typename S>
cudaError_t row_stats(const S* x, float* stats, int M, int C, cudaStream_t stream) {
  if (C % 8) return cudaErrorInvalidValue;
#define ROW_STATS(G)                                                                     \
  case G:                                                                                \
    row_stats_kernel<S, G><<<(int)(((long long)M * G + kRowThreads - 1) / kRowThreads), \
                             kRowThreads, 0, stream>>>(x, stats, M, C);                  \
    break
  switch (row_lanes(C)) {
    ROW_STATS(1);
    ROW_STATS(2);
    ROW_STATS(4);
    ROW_STATS(8);
    ROW_STATS(16);
    ROW_STATS(32);
    default: return cudaErrorInvalidValue;
  }
#undef ROW_STATS
  return cudaGetLastError();
}

template <typename T, bool TAIL, int G>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_kernel(const T* __restrict__ t, const float* __restrict__ stats,
                   const float* __restrict__ dz, const float* __restrict__ nscale,
                   const T* __restrict__ res, const float* __restrict__ dm,
                   T* __restrict__ out_t, T* __restrict__ out_f, float* __restrict__ part,
                   int M, int N, int C, int rpb) {
  constexpr int NP = TAIL ? 3 : 2, R = 32 / G, kGroups = kRowWarps * R;
  extern __shared__ __align__(16) float cp[];  // [kGroups][NP * C + G]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gl = lane % G;
  const int stride = NP * C + G, nch = C / 8;
  for (int i = tid; i < kGroups * stride; i += kRowThreads) cp[i] = 0.f;
  __syncthreads();
  float* mine = cp + (warp * R + lane / G) * stride;
  const int r0 = blockIdx.x * rpb, r1 = min(M, r0 + rpb);
  for (int base = r0 + warp * R; base < r1; base += kGroups) {
    const int m = base + lane / G;
    const bool ok = m < r1;
    const float mean = ok ? stats[2 * m] : 0.f, rstd = ok ? stats[2 * m + 1] : 0.f;
    const size_t row = (size_t)m * C;
    float sd = 0.f, sdn = 0.f;
    if (ok)
      for (int ch = gl; ch < nch; ch += G) {
        float tv[8], dv[8], sc[8];
        load8(t + row + 8 * ch, tv);
        load8(dz + row + 8 * ch, dv);
        load8(nscale + 8 * ch, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = dv[e] * sc[e];
          sd += d;
          sdn += d * ((tv[e] - mean) * rstd);
        }
      }
    sd = group_sum<G>(sd) / C;
    sdn = group_sum<G>(sdn) / C;
    if (!ok) continue;
    const float scale = TAIL ? dm[m / N] : 0.f;
    for (int ch = gl; ch < nch; ch += G) {
      const int k = 8 * ch;
      float tv[8], dv[8], sc[8], rv[8], v[8];
      load8(t + row + k, tv);
      load8(dz + row + k, dv);
      load8(nscale + k, sc);
      load8(res + row + k, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float tn = (tv[e] - mean) * rstd;
        v[e] = rv[e] + rstd * (dv[e] * sc[e] - sd - tn * sdn);
        mine[e * nch + ch] += dv[e] * tn;
        mine[C + e * nch + ch] += dv[e];
      }
      store8(out_t + row + k, v);
      if (TAIL) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] *= scale;
          mine[2 * C + e * nch + ch] += v[e];
        }
        store8(out_f + row + k, v);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < NP * C; i += kRowThreads) {
    const int np = i / C, col = i % C, at = np * C + (col % 8) * nch + col / 8;
    float s = 0.f;
    for (int g = 0; g < kGroups; ++g) s += cp[g * stride + at];
    part[(size_t)blockIdx.x * NP * C + i] = s;
  }
}

template <typename T, bool TAIL, int G>
cudaError_t launch_ln_bwd_rows(const T* t, const float* stats, const float* dz,
                               const float* nscale, const T* res, const float* dm, T* out_t,
                               T* out_f, float* part, float* out_vec, int M, int N, int C,
                               cudaStream_t stream) {
  constexpr int NP = TAIL ? 3 : 2;
  const size_t smem = sizeof(float) * kRowWarps * (32 / G) * (NP * C + G);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_rows_kernel<T, TAIL, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rpb = rows_per_block(M, C);
  const int blocks = (M + rpb - 1) / rpb;
  ln_bwd_rows_kernel<T, TAIL, G><<<blocks, kRowThreads, smem, stream>>>(
      t, stats, dz, nscale, res, dm, out_t, out_f, part, M, N, C, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(part, out_vec, NP * C, nullptr, nullptr, 0, blocks, stream);
}

template <typename T, bool TAIL>
cudaError_t ln_bwd_rows(const T* t, const float* stats, const float* dz, const float* nscale,
                        const T* res, const float* dm, T* out_t, T* out_f, float* part,
                        float* out_vec, int M, int N, int C, cudaStream_t stream) {
  if (C % 8) return cudaErrorInvalidValue;
#define LN_ROWS(G)                                                                        \
  case G:                                                                                 \
    return launch_ln_bwd_rows<T, TAIL, G>(t, stats, dz, nscale, res, dm, out_t, out_f, part, \
                                          out_vec, M, N, C, stream)
  switch (row_lanes(C)) {
    LN_ROWS(1);
    LN_ROWS(2);
    LN_ROWS(4);
    LN_ROWS(8);
    LN_ROWS(16);
    LN_ROWS(32);
    default: return cudaErrorInvalidValue;
  }
#undef LN_ROWS
}

#define TRY(call)                              \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// ------------------------------------------------------------------- forward
template <typename T>
int train_forward(const T* x, const float* n1s, const float* n1b, const T* wqkv,
                  const float* bqkv, const T* wp, const float* bp, const float* n2s,
                  const float* n2b, const T* w1, const float* b1, const T* w2,
                  const float* b2, const float* mask, const int* starts, const float* dma,
                  const float* dmb, T* out, T* qkv, T* attn, T* y, T* h1, T* q_scaled,
                  float* y32, T* gact, int B, int N, int C, int heads,
                  int hidden, int qb, int width, float scale, cudaStream_t s) {
  const int M = B * N;
  TRY(proj(LayerNormRows<T>{x, C, M, n1s, n1b}, wqkv, QkvEpi<T>{bqkv, qkv, q_scaled, C, scale}, M,
           3 * C, C, s));
  TRY((attention_tc<T, kMaxSubLate, false>(q_scaled, C, qkv + C, qkv + 2 * C, 3 * C, attn, C, mask,
                                    starts, B, heads, N, C / heads, qb, width, s)));
  TRY(proj(Mat<T>{attn, C}, wp, ProjEpi<T>{bp, x, dma, y, y32, C, N}, M, C, C, s));
  TRY(proj(LayerNormRows<float>{y32, C, M, n2s, n2b}, w1, Fc1Epi<T>{b1, h1, gact, hidden}, M,
           hidden, C, s));
  TRY(proj(Mat<T>{gact, hidden}, w2, Fc2Epi<T>{b2, y32, dmb, out, C, N}, M, C, hidden, s));
  return 0;
}

// ------------------------------------------------------------- backward tail
// The floats of work ahead of the partial sums: the transposed weights,
// counted as float32 whatever T is
long long tail_weight_floats(int C, int hidden) {
  return 2 * floats_of((long long)C * hidden) + floats_of((long long)C * C);
}

long long head_weight_floats(int C) { return floats_of(3LL * C * C); }

template <typename T>
int train_bwd_tail(const T* g, const T* y, const T* h1, const T* attn, const float* n2s,
                   const float* n2b, const T* w1, const T* w2, const T* wp,
                   const float* dma, const float* dmb, T* dy, T* dattn, float* dw2,
                   float* db2, float* dw1, float* db1, float* dwp, float* vec3,
                   float* stats, float* dh1_buf, float* dz2, float* da_buf, float* work, int B,
                   int N, int C, int hidden, cudaStream_t s) {
  const int M = B * N;
  // W2^T [C, hidden], W1^T [hidden, C], Wp^T [C, C]: proj's [K, Nout]
  T* w2t = reinterpret_cast<T*>(work);
  T* w1t = reinterpret_cast<T*>(work + floats_of((long long)C * hidden));
  T* wpt = reinterpret_cast<T*>(work + 2 * floats_of((long long)C * hidden));
  float* part = work + tail_weight_floats(C, hidden);
  // dh1 and da in T: the products round them to T, and their sums (db1,
  // dbp) are taken from the float32 values before the rounding
  T* dh1 = reinterpret_cast<T*>(dh1_buf);
  T* da = reinterpret_cast<T*>(da_buf);
  const ScaledRows<T> dh2{g, dmb, C, N};   // g * dm_b
  TRY(row_stats(y, stats, M, C, s));
  TRY(transpose(TransposeJobs<T>{{w2, w1, wp}, {w2t, w1t, wpt}, {hidden, C, C}, {C, hidden, C}},
                3, s));
  // dW2 = gelu(h1)^T dh2, db2 = colsum(dh2)
  TRY((weight_grad<T, true>(GeluRows<T>{h1, hidden}, dh2, dw2, db2, part, M, hidden, C, s)));
  // dh1 = (dh2 W2^T) * gelu15'(h1), db1 = colsum(dh1)
  TRY(proj(dh2, w2t, Dh1Epi<T>{h1, dh1, part, hidden}, M, hidden, C, s));
  TRY(reduce_parts(part, db1, hidden, nullptr, nullptr, 0, (M + kTileM - 1) / kTileM, s));
  // dW1 = z2^T dh1 with z2 = LN2(y) recomputed from the rounded y
  TRY((weight_grad<T, false>(LnRows<T>{y, stats, n2s, n2b, C}, Mat<T>{dh1, hidden}, dw1,
                             nullptr, part, M, C, hidden, s)));
  // dz2 = dh1 W1^T
  TRY(proj(Mat<T>{dh1, hidden}, w1t, StoreEpi<float>{dz2, C}, M, C, hidden, s));
  // LN2 backward: dy, da = dy * dm_a, and dn2s, dn2b, dbp
  TRY((ln_bwd_rows<T, true>(y, stats, dz2, n2s, g, dma, dy, da, part, vec3, M, N, C, s)));
  // dWp = attn^T da, dattn = da Wp^T
  TRY((weight_grad<T, false>(Mat<T>{attn, C}, Mat<T>{da, C}, dwp, nullptr, part, M, C, C, s)));
  TRY(proj(Mat<T>{da, C}, wpt, StoreEpi<T>{dattn, C}, M, C, C, s));
  return 0;
}

// ------------------------------------------------------------- backward head
template <typename T>
int train_bwd_head(const T* x, const T* dy, const T* dqkv, const float* n1s,
                   const float* n1b, const T* wqkv, T* dx, float* dwqkv, float* dbqkv,
                   float* vec2, float* stats, float* dz1, float* work, int B, int N, int C,
                   cudaStream_t s) {
  const int M = B * N;
  T* wqkvt = reinterpret_cast<T*>(work);   // Wqkv^T [3C, C]
  float* part = work + head_weight_floats(C);
  TRY(row_stats(x, stats, M, C, s));
  TRY(transpose(TransposeJobs<T>{{wqkv}, {wqkvt}, {C}, {3 * C}}, 1, s));
  // dWqkv = z1^T dqkv with z1 = LN1(x), dbqkv = colsum(dqkv)
  TRY((weight_grad<T, true>(LnRows<T>{x, stats, n1s, n1b, C}, Mat<T>{dqkv, 3 * C}, dwqkv, dbqkv,
                            part, M, C, 3 * C, s)));
  // dz1 = dqkv Wqkv^T
  TRY(proj(Mat<T>{dqkv, 3 * C}, wqkvt, StoreEpi<float>{dz1, C}, M, C, 3 * C, s));
  // LN1 backward: dx = dy + ..., and dn1s, dn1b
  TRY((ln_bwd_rows<T, false>(x, stats, dz1, n1s, dy, nullptr, dx, (T*)nullptr, part, vec2, M,
                             N, C, s)));
  return 0;
}

long long rows_floats(int M, int np, int C) {
  const int rpb = rows_per_block(M, C);
  return (long long)((M + rpb - 1) / rpb) * np * C;
}

}  // namespace

extern "C" {

// Floats of the `work` buffer the tail (kind 0) or head (kind 1) needs for
// its transposed weights and partial sums, for M = B*N rows, width C and
// MLP width hidden.
long long svtr_train_workspace(int kind, int M, int C, int hidden) {
  if (kind == 0)
    return tail_weight_floats(C, hidden) +
           std::max({wgrad_floats(M, hidden, C), wgrad_floats(M, C, hidden),
                     wgrad_floats(M, C, C), rows_floats(M, 3, C),
                     (long long)(M + kTileM - 1) / kTileM * hidden});
  return head_weight_floats(C) + std::max(wgrad_floats(M, C, 3 * C), rows_floats(M, 2, C));
}

// dtype: 0 float32, 1 bfloat16.  Matrices [in, out] and activations in the
// working type, vectors (norm scales/shifts, biases, dm_a, dm_b) float32.
// mask [N, width] float32 or NULL; starts int32 [N / qb] on the device or NULL
// (full attention: qb == width == N).  Outputs out, qkv, attn, y, h1; scratch
// q_scaled [B,N,C] (T), y32 [B,N,C] float32, gact [B,N,hidden] (T); stats
// [B*N, 2] float32 is no longer written (the projections compute their
// LayerNorm statistics in the kernel) and stays for the callers' interface.
// Returns 0 or the CUDA error of the first failed launch.
int svtr_train_forward(int dtype, const void* x, const float* n1s, const float* n1b,
                       const void* wqkv, const float* bqkv, const void* wp, const float* bp,
                       const float* n2s, const float* n2b, const void* w1, const float* b1,
                       const void* w2, const float* b2, const float* mask, const int* starts,
                       const float* dma, const float* dmb, void* out, void* qkv, void* attn,
                       void* y, void* h1, void* q_scaled, float* y32, void* gact,
                       float* stats, int B, int N, int C, int heads, int hidden, int qb,
                       int width, float scale, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || heads <= 0 || C % heads || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_ARGS(T)                                                                        \
  static_cast<const T*>(x), n1s, n1b, static_cast<const T*>(wqkv), bqkv,                  \
      static_cast<const T*>(wp), bp, n2s, n2b, static_cast<const T*>(w1), b1,             \
      static_cast<const T*>(w2), b2, mask, starts, dma, dmb, static_cast<T*>(out),        \
      static_cast<T*>(qkv), static_cast<T*>(attn), static_cast<T*>(y), static_cast<T*>(h1), \
      static_cast<T*>(q_scaled), y32, static_cast<T*>(gact), B, N, C, heads, hidden,        \
      qb, width, scale, s
  if (dtype == 0) return train_forward<float>(FWD_ARGS(float));
  if (dtype == 1) return train_forward<__nv_bfloat16>(FWD_ARGS(__nv_bfloat16));
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// Tail: g, y, h1, attn (T); n2s, n2b, dm_a, dm_b float32; w1 [C, hidden], w2
// [hidden, C], wp [C, C] (T).  Outputs dy, dattn (T); dw2 [hidden, C], db2
// [C], dw1 [C, hidden], db1 [hidden], dwp [C, C], vec3 [3, C] = dn2s, dn2b,
// dbp (float32).  Scratch, float32 buffers: stats [M, 2], dh1 [M, hidden]
// and da [M, C] (both holding T values), dz2 [M, C], work
// (svtr_train_workspace(0, ...) floats).
int svtr_train_bwd_tail(int dtype, const void* g, const void* y, const void* h1,
                        const void* attn, const float* n2s, const float* n2b, const void* w1,
                        const void* w2, const void* wp, const float* dma, const float* dmb,
                        void* dy, void* dattn, float* dw2, float* db2, float* dw1, float* db1,
                        float* dwp, float* vec3, float* stats, float* dh1, float* dz2,
                        float* da, float* work, int B, int N, int C, int hidden, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TAIL_ARGS(T)                                                                        \
  static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(h1),           \
      static_cast<const T*>(attn), n2s, n2b, static_cast<const T*>(w1),                     \
      static_cast<const T*>(w2), static_cast<const T*>(wp), dma, dmb, static_cast<T*>(dy), \
      static_cast<T*>(dattn), dw2, db2, dw1, db1, dwp, vec3, stats, dh1, dz2, da, work, B,  \
      N, C, hidden, s
  if (dtype == 0) return train_bwd_tail<float>(TAIL_ARGS(float));
  if (dtype == 1) return train_bwd_tail<__nv_bfloat16>(TAIL_ARGS(__nv_bfloat16));
#undef TAIL_ARGS
  return (int)cudaErrorInvalidValue;
}

// Head: x, dy, dqkv [B, N, 3C] (T); n1s, n1b float32; wqkv [C, 3C] (T).
// Outputs dx (T); dwqkv [C, 3C], dbqkv [3C], vec2 [2, C] = dn1s, dn1b
// (float32).  Scratch float32: stats [M, 2], dz1 [M, C], work
// (svtr_train_workspace(1, ...) floats).
int svtr_train_bwd_head(int dtype, const void* x, const void* dy, const void* dqkv,
                        const float* n1s, const float* n1b, const void* wqkv, void* dx,
                        float* dwqkv, float* dbqkv, float* vec2, float* stats, float* dz1,
                        float* work, int B, int N, int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEAD_ARGS(T)                                                                       \
  static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(dqkv), n1s,  \
      n1b, static_cast<const T*>(wqkv), static_cast<T*>(dx), dwqkv, dbqkv, vec2, stats,    \
      dz1, work, B, N, C, s
  if (dtype == 0) return train_bwd_head<float>(HEAD_ARGS(float));
  if (dtype == 1) return train_bwd_head<__nv_bfloat16>(HEAD_ARGS(__nv_bfloat16));
#undef HEAD_ARGS
  return (int)cudaErrorInvalidValue;
}

// The launch plan of svtr_train_forward: out[0..4] the attention's (query
// rows per block, key tiles held in registers, key segments, passes over the
// keys, dynamic shared-memory bytes), out[5..8] the output columns per block
// of the qkv, proj, fc1 and fc2 projections (128 rows each).
int svtr_train_plan(int dtype, int N, int C, int heads, int hidden, int qb, int width,
                    int* out) {
  export_plan(make_plan(kMaxSubLate, dtype, N, C / heads, qb, width), out);
  const int widths[4] = {3 * C, C, hidden, C}, depths[4] = {C, C, C, hidden};
  for (int i = 0; i < 4; ++i) out[5 + i] = tile_n(dtype, widths[i], depths[i]);
  return 0;
}

// The launch plan of the backward for M = B*N rows: out[4 p .. 4 p + 4] the
// weight gradient p's (k1 tile, k2 tile, row chunks, rows a chunk) for p =
// dW2, dW1, dWp, dWqkv; out[16 .. 20] the output columns per 128-row block
// of the dh1, dz2, dattn and dz1 projections.
int svtr_train_bwd_plan(int dtype, int M, int C, int hidden, int* out) {
  const int k1[4] = {hidden, C, C, C}, k2[4] = {C, hidden, C, 3 * C};
  for (int p = 0; p < 4; ++p) {
    const Split sp = wg_split(M, k1[p], k2[p]);
    out[4 * p] = wg_tile(k1[p]);
    out[4 * p + 1] = wg_tile(k2[p]);
    out[4 * p + 2] = sp.count;
    out[4 * p + 3] = sp.chunk;
  }
  const int widths[4] = {hidden, C, C, C}, depths[4] = {C, hidden, C, 3 * C};
  for (int i = 0; i < 4; ++i) out[16 + i] = tile_n(dtype, widths[i], depths[i]);
  return 0;
}

const char* svtr_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
