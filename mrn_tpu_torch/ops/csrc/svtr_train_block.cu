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
// 8 C) * N elements moved, so at batch 256 the work sits above the bf16
// ridge (operations-bound) and far above the float32 one.  What the Pallas
// bodies keep out of device memory (the score tile, the GELU chain) stays
// in shared memory or registers here too.
//
// Design: several launches per entry point.
//   - The forward's four projections run the main loops of svtr_gemm_tc.cuh
//     (proj_kernel): bf16 on the tensor cores (mma.sync m16n8k16), float32
//     register-tiled on the CUDA cores; LayerNorm with its affine on the A
//     loads (LayerNormRows, the statistics of a block's rows computed in the
//     kernel), bias, q-scale, residual, GELU and droppath in the epilogues.
//   - Its attention is the tile attention of svtr_attention_tc.cuh in its
//     kMaxSubLate form, q from q_scaled [B, N, C], k and v inside qkv.
//   - The backward's products: gemm_kernel, the SIMT main loop of
//     svtr_common.cuh (one 64x64 output tile per block of 256 threads).
//     Operands come through small loader functors (plain, transposed,
//     LayerNorm on the fly, droppath-scaled, GELU of h1) and results leave
//     through epilogue functors (bias, residual, rounding, GELU, droppath),
//     so each product of the Pallas bodies is one launch with its
//     elementwise neighbours fused in.
//   - Weight gradients are products over all B*N rows: blockIdx.z splits the
//     rows into a fixed number of contiguous chunks, each block writes its
//     partial tile, and reduce_splits_kernel sums the partials in chunk
//     order.  Bias and norm gradients use the same two passes.  No float
//     atomics, so the same inputs give bitwise-identical outputs and grads.
//   - The LayerNorm backward is a row kernel (one warp per row) that also
//     keeps per-warp column partials in shared memory for dn_s, dn_b (and
//     dbp), combined per block in warp order.
// Left for later: the backward's products on the tensor cores, TMA, and
// keeping the Block's intermediates on chip across the launches.

#include <algorithm>

#include "svtr_attention_tc.cuh"
#include "svtr_gemm_tc.cuh"

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
// Each gives the float32 value of element (r, c) of a logical matrix (and
// Mat, the plain row-major one, from svtr_common.cuh).

template <typename S>
struct MatT {  // element (r, c) of the transpose of a row-major [., ld]
  const S* p;
  int ld;
  __device__ float operator()(int r, int c) const { return to_f(p[(size_t)c * ld + r]); }
};

template <typename S>
struct LnRows {  // ((x[r, c] - mean_r) * rstd_r) * s[c] + b[c]
  const S* x;
  const float* stats;  // [rows, 2]: mean, rstd
  const float* s;
  const float* b;
  int ld;
  __device__ float operator()(int r, int c) const {
    const float v = to_f(x[(size_t)r * ld + c]);
    return ((v - stats[2 * r]) * stats[2 * r + 1]) * s[c] + b[c];
  }
};

template <typename S>
struct ScaledRows {  // x[r, c] * dm[r / n] (droppath-scaled cotangent)
  const S* x;
  const float* dm;
  int ld, n;
  __device__ float operator()(int r, int c) const {
    return to_f(x[(size_t)r * ld + c]) * dm[r / n];
  }
};

template <typename S>
struct GeluRows {  // gelu15(h[r, c])
  const S* h;
  int ld;
  __device__ float operator()(int r, int c) const {
    return gelu15(to_f(h[(size_t)r * ld + c]));
  }
};

template <class L>
struct Transposed {  // element (r, c) = l(c, r)
  L l;
  __device__ float operator()(int r, int c) const { return l(c, r); }
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

// The backward's epilogues take (row, col, split, float32 accumulator).

template <typename T>
struct Dh1Epi {  // dh1 = dgv * gelu15'(h1), float32
  const T* h1;
  float* dh1;
  int hidden;
  __device__ void operator()(int i, int j, int, float acc) const {
    const size_t o = (size_t)i * hidden + j;
    dh1[o] = acc * gelu15_grad(to_f(h1[o]));
  }
};

template <typename S>
struct StoreEpi {
  S* out;
  int ld;
  __device__ void operator()(int i, int j, int, float acc) const {
    out[(size_t)i * ld + j] = from_f<S>(acc);
  }
};

struct PartialEpi {  // part[split][i][j]
  float* part;
  int ld;
  size_t stride;
  __device__ void operator()(int i, int j, int z, float acc) const {
    part[(size_t)z * stride + (size_t)i * ld + j] = acc;
  }
};

// ------------------------------------------------------------------- kernels
// C[i, j] = sum over k in split z's chunk of round_T(A(i, k)) * round_T(B(k, j)),
// handed to E(i, j, z, acc) (the main loop of svtr_common.cuh).
template <typename T, class A, class B, class E, bool A_KFAST, bool B_JFAST>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(A a, B b, E e, int M, int Nn, int K, int kchunk) {
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  float acc[4][4] = {};
  gemm_mainloop<T, A_KFAST, B_JFAST>(a, b, M, Nn, kbeg, kend, acc);
  gemm_store(acc, M, Nn, [&](int m, int n, float v) { e(m, n, blockIdx.z, v); });
}

// Split of a reduction over K rows: enough blocks for two waves of the
// card's 132 SMs, chunks of at least 256 rows.  Fixed by the shapes alone.
struct Split {
  int count, chunk;
};

Split split_rows(int K, int tiles) {
  int s = (2 * 132 + tiles - 1) / tiles;
  s = std::max(1, std::min(s, K / 256));
  int chunk = (K + s - 1) / s;
  chunk = (chunk + BK - 1) / BK * BK;
  return {(K + chunk - 1) / chunk, chunk};
}

int gemm_tiles(int M, int Nn) { return ((M + BM - 1) / BM) * ((Nn + BN - 1) / BN); }

template <typename T, bool A_KFAST, bool B_JFAST, class A, class B, class E>
cudaError_t gemm(A a, B b, E e, int M, int Nn, int K, Split sp, cudaStream_t stream) {
  dim3 grid((Nn + BN - 1) / BN, (M + BM - 1) / BM, sp.count);
  gemm_kernel<T, A, B, E, A_KFAST, B_JFAST><<<grid, kGemmThreads, 0, stream>>>(
      a, b, e, M, Nn, K, sp.chunk);
  return cudaGetLastError();
}

// out[e] = sum over z = 0 .. S-1, in order, of part[z][e]
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[(size_t)z * E + e];
  out[e] = s;
}

cudaError_t reduce_splits(const float* part, float* out, int S, int E, cudaStream_t stream) {
  reduce_splits_kernel<<<(E + 255) / 256, 256, 0, stream>>>(part, out, S, E);
  return cudaGetLastError();
}

// Weight gradient out[K1, K2] = sum_m round(A(i, m)) * round(B(m, j)) over
// all M rows: partial products per row chunk, then the ordered sum.
template <typename T, class A, class B>
cudaError_t weight_grad(A a, B b, float* out, float* work, int K1, int K2, int M,
                        cudaStream_t stream) {
  const Split sp = split_rows(M, gemm_tiles(K1, K2));
  cudaError_t err = gemm<T, false, true>(a, b, PartialEpi{work, K2, (size_t)K1 * K2},
                                         K1, K2, M, sp, stream);
  if (err != cudaSuccess) return err;
  return reduce_splits(work, out, sp.count, K1 * K2, stream);
}

// column sums out[j] = sum_m l(m, j), float32, over row chunks in order
constexpr int kColChunk = 512;

template <class L>
__global__ void colsum_kernel(L l, float* __restrict__ part, int M, int ncol) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncol) return;
  const int r0 = blockIdx.y * kColChunk, r1 = min(M, r0 + kColChunk);
  float s = 0.f;
  for (int m = r0; m < r1; ++m) s += l(m, j);
  part[(size_t)blockIdx.y * ncol + j] = s;
}

template <class L>
cudaError_t colsum(L l, float* out, float* work, int M, int ncol, cudaStream_t stream) {
  const int S = (M + kColChunk - 1) / kColChunk;
  colsum_kernel<<<dim3((ncol + 255) / 256, S), 256, 0, stream>>>(l, work, M, ncol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(work, out, S, ncol, stream);
}

// LayerNorm statistics per row: mean, rsqrt(E[x^2] - mean^2 + 1e-6)
template <typename S>
__global__ void row_stats_kernel(const S* __restrict__ x, float* __restrict__ stats, int M,
                                 int C) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (warp >= M) return;
  const S* row = x + (size_t)warp * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(row[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mean = s / C;
    const float var = ss / C - mean * mean;
    stats[2 * warp] = mean;
    stats[2 * warp + 1] = rsqrtf(var + 1e-6f);
  }
}

template <typename S>
cudaError_t row_stats(const S* x, float* stats, int M, int C, cudaStream_t stream) {
  row_stats_kernel<S><<<(M + 7) / 8, 256, 0, stream>>>(x, stats, M, C);
  return cudaGetLastError();
}

// LayerNorm backward rows, one warp per row: with tn = (t - mean) * rstd and
// d = dz * s, v = res + rstd * (d - mean(d) - tn * mean(d tn)) -> out_t (T).
// TAIL: res = g, v is dy, and da = dy * dm_a -> out_f.  Column partials per
// block: sum dz*tn, sum dz (and sum da), warps combined in order.
constexpr int kRowThreads = 256, kRowWarps = kRowThreads / 32;

int rows_per_block(int M) {
  int r = (M + 255) / 256;
  r = (r + kRowWarps - 1) / kRowWarps * kRowWarps;
  return std::max(64, r);
}

template <typename T, bool TAIL>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_kernel(const T* __restrict__ t, const float* __restrict__ stats,
                   const float* __restrict__ dz, const float* __restrict__ nscale,
                   const T* __restrict__ res, const float* __restrict__ dm,
                   T* __restrict__ out_t, float* __restrict__ out_f,
                   float* __restrict__ part, int M, int N, int C, int rpb) {
  constexpr int NP = TAIL ? 3 : 2;
  extern __shared__ float cp[];  // [kRowWarps][NP][C]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kRowWarps * NP * C; i += kRowThreads) cp[i] = 0.f;
  __syncthreads();
  float* mine = cp + warp * NP * C;
  const int r0 = blockIdx.x * rpb, r1 = min(M, r0 + rpb);
  for (int m = r0 + warp; m < r1; m += kRowWarps) {
    const float mean = stats[2 * m], rstd = stats[2 * m + 1];
    const size_t base = (size_t)m * C;
    float sd = 0.f, sdn = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float tn = (to_f(t[base + c]) - mean) * rstd;
      const float d = dz[base + c] * nscale[c];
      sd += d;
      sdn += d * tn;
    }
    sd = warp_sum(sd) / C;
    sdn = warp_sum(sdn) / C;
    const float scale = TAIL ? dm[m / N] : 0.f;
    for (int c = lane; c < C; c += 32) {
      const float tn = (to_f(t[base + c]) - mean) * rstd;
      const float dzv = dz[base + c];
      const float d = dzv * nscale[c];
      const float v = to_f(res[base + c]) + rstd * (d - sd - tn * sdn);
      out_t[base + c] = from_f<T>(v);
      mine[c] += dzv * tn;
      mine[C + c] += dzv;
      if (TAIL) {
        const float da = v * scale;
        out_f[base + c] = da;
        mine[2 * C + c] += da;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < NP * C; i += kRowThreads) {
    float s = 0.f;
    for (int w = 0; w < kRowWarps; ++w) s += cp[w * NP * C + i];
    part[(size_t)blockIdx.x * NP * C + i] = s;
  }
}

template <typename T, bool TAIL>
cudaError_t ln_bwd_rows(const T* t, const float* stats, const float* dz, const float* nscale,
                        const T* res, const float* dm, T* out_t, float* out_f, float* part,
                        float* out_vec, int M, int N, int C, cudaStream_t stream) {
  constexpr int NP = TAIL ? 3 : 2;
  const size_t smem = sizeof(float) * kRowWarps * NP * C;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_rows_kernel<T, TAIL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rpb = rows_per_block(M);
  const int blocks = (M + rpb - 1) / rpb;
  ln_bwd_rows_kernel<T, TAIL><<<blocks, kRowThreads, smem, stream>>>(
      t, stats, dz, nscale, res, dm, out_t, out_f, part, M, N, C, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(part, out_vec, blocks, NP * C, stream);
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
  TRY((attention_tc<T, kMaxSubLate>(q_scaled, C, qkv + C, qkv + 2 * C, 3 * C, attn, C, mask,
                                    starts, B, heads, N, C / heads, qb, width, s)));
  TRY(proj(Mat<T>{attn, C}, wp, ProjEpi<T>{bp, x, dma, y, y32, C, N}, M, C, C, s));
  TRY(proj(LayerNormRows<float>{y32, C, M, n2s, n2b}, w1, Fc1Epi<T>{b1, h1, gact, hidden}, M,
           hidden, C, s));
  TRY(proj(Mat<T>{gact, hidden}, w2, Fc2Epi<T>{b2, y32, dmb, out, C, N}, M, C, hidden, s));
  return 0;
}

// ------------------------------------------------------------- backward tail
template <typename T>
int train_bwd_tail(const T* g, const T* y, const T* h1, const T* attn, const float* n2s,
                   const float* n2b, const T* w1, const T* w2, const T* wp,
                   const float* dma, const float* dmb, T* dy, T* dattn, float* dw2,
                   float* db2, float* dw1, float* db1, float* dwp, float* vec3,
                   float* stats, float* dh1, float* dz2, float* da, float* work, int B,
                   int N, int C, int hidden, cudaStream_t s) {
  const int M = B * N;
  const Split one{1, 1 << 30};
  const ScaledRows<T> dh2{g, dmb, C, N};  // g * dm_b
  TRY(row_stats(y, stats, M, C, s));
  // dW2 = gelu(h1)^T dh2, db2 = colsum(dh2)
  TRY((weight_grad<T>(Transposed<GeluRows<T>>{{h1, hidden}}, dh2, dw2, work, hidden, C, M, s)));
  TRY(colsum(dh2, db2, work, M, C, s));
  // dh1 = (dh2 W2^T) * gelu15'(h1), db1 = colsum(dh1)
  TRY((gemm<T, true, false>(dh2, MatT<T>{w2, C}, Dh1Epi<T>{h1, dh1, hidden}, M, hidden, C,
                            one, s)));
  TRY(colsum(Mat<float>{dh1, hidden}, db1, work, M, hidden, s));
  // dW1 = z2^T dh1 with z2 = LN2(y) recomputed from the rounded y
  TRY((weight_grad<T>(Transposed<LnRows<T>>{{y, stats, n2s, n2b, C}}, Mat<float>{dh1, hidden},
                      dw1, work, C, hidden, M, s)));
  // dz2 = dh1 W1^T
  TRY((gemm<T, true, false>(Mat<float>{dh1, hidden}, MatT<T>{w1, hidden},
                            StoreEpi<float>{dz2, C}, M, C, hidden, one, s)));
  // LN2 backward: dy, da = dy * dm_a, and dn2s, dn2b, dbp
  TRY((ln_bwd_rows<T, true>(y, stats, dz2, n2s, g, dma, dy, da, work, vec3, M, N, C, s)));
  // dWp = attn^T da, dattn = da Wp^T
  TRY((weight_grad<T>(Transposed<Mat<T>>{{attn, C}}, Mat<float>{da, C}, dwp, work, C, C, M, s)));
  TRY((gemm<T, true, false>(Mat<float>{da, C}, MatT<T>{wp, C}, StoreEpi<T>{dattn, C}, M, C,
                            C, one, s)));
  return 0;
}

// ------------------------------------------------------------- backward head
template <typename T>
int train_bwd_head(const T* x, const T* dy, const T* dqkv, const float* n1s,
                   const float* n1b, const T* wqkv, T* dx, float* dwqkv, float* dbqkv,
                   float* vec2, float* stats, float* dz1, float* work, int B, int N, int C,
                   cudaStream_t s) {
  const int M = B * N;
  const Split one{1, 1 << 30};
  TRY(row_stats(x, stats, M, C, s));
  // dWqkv = z1^T dqkv with z1 = LN1(x), dbqkv = colsum(dqkv)
  TRY((weight_grad<T>(Transposed<LnRows<T>>{{x, stats, n1s, n1b, C}}, Mat<T>{dqkv, 3 * C},
                      dwqkv, work, C, 3 * C, M, s)));
  TRY(colsum(Mat<T>{dqkv, 3 * C}, dbqkv, work, M, 3 * C, s));
  // dz1 = dqkv Wqkv^T
  TRY((gemm<T, true, false>(Mat<T>{dqkv, 3 * C}, MatT<T>{wqkv, 3 * C},
                            StoreEpi<float>{dz1, C}, M, C, 3 * C, one, s)));
  // LN1 backward: dx = dy + ..., and dn1s, dn1b
  TRY((ln_bwd_rows<T, false>(x, stats, dz1, n1s, dy, nullptr, dx, nullptr, work, vec2, M, N,
                             C, s)));
  return 0;
}

long long max3(long long a, long long b, long long c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

long long wgrad_floats(int K1, int K2, int M) {
  return (long long)split_rows(M, gemm_tiles(K1, K2)).count * K1 * K2;
}

long long colsum_floats(int M, int ncol) {
  return (long long)((M + kColChunk - 1) / kColChunk) * ncol;
}

long long rows_floats(int M, int np, int C) {
  const int rpb = rows_per_block(M);
  return (long long)((M + rpb - 1) / rpb) * np * C;
}

}  // namespace

extern "C" {

// Floats of the `work` buffer the tail (kind 0) or head (kind 1) needs for
// its partial sums, for M = B*N rows, width C and MLP width hidden.
long long svtr_train_workspace(int kind, int M, int C, int hidden) {
  if (kind == 0)
    return max3(max3(wgrad_floats(hidden, C, M), wgrad_floats(C, hidden, M),
                     wgrad_floats(C, C, M)),
                max3(colsum_floats(M, C), colsum_floats(M, hidden), 0),
                rows_floats(M, 3, C));
  return max3(wgrad_floats(C, 3 * C, M), colsum_floats(M, 3 * C), rows_floats(M, 2, C));
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
// dbp (float32).  Scratch float32: stats [M, 2], dh1 [M, hidden], dz2 [M, C],
// da [M, C], work (svtr_train_workspace(0, ...) floats).
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

const char* svtr_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
