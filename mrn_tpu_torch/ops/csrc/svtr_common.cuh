// Device code shared by the port's CUDA sources (svtr_block.cu,
// svtr_block_int8.cu, svtr_attention.cu, svtr_train_block.cu).  Each source is its own shared
// library, so everything here sits in an anonymous namespace.
//
//   - float <-> working type T (float or bfloat16) and rounding to T;
//   - warp reductions;
//   - the minimax erf polynomials of the GELU, degree 15 (the JAX package's
//     _ERF_COEFS; |erf error| < 1.9e-7) and degree 9 (_ERF9_COEFS, the
//     inference Blocks' default; |erf error| < 1.4e-4);
//   - Mat, a row-major matrix as the loader of the projection and
//     weight-gradient main loops (svtr_gemm_tc.cuh, svtr_wgrad_tc.cuh);
//   - the names of the three softmax forms of the Pallas kernels (the tile
//     attention of svtr_attention_tc.cuh takes each);
//   - the w8a8 Block's float attention (row 3 of the kernel table): one
//     (image, head, 32-query tile) per block with the [32, N] float32 score
//     tile in shared memory and 64-key K/V chunks, max-subtract softmax
//     normalised before PV, float32 output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into
constexpr float kErfZ0Sq = (float)(3.7 * 3.7);
constexpr float kTwoOverZ0Sq = (float)(2.0 / (3.7 * 3.7));
constexpr float kRsqrt2 = 0.70710678118654752f;

__constant__ float kErf15[16] = {
    0.3821374773979187f, -0.1904679834842682f, 0.14079536497592926f,
    -0.11263926327228546f, 0.09052307158708572f, -0.07047279179096222f,
    0.0521380715072155f, -0.03618001565337181f, 0.023104503750801086f,
    -0.013829714618623257f, 0.008435077033936977f, -0.004555193707346916f,
    0.0014333085855469108f, -0.0005751904682256281f, 0.0007578228251077235f,
    -0.0003343276330269873f};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// value rounded to T and back (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 0.5 x (1 + erf(x / sqrt 2)) with erf(z) = clip(z P(u), -1, 1), u = (2/Z0)
// min(z^2, Z0) - 1 and P the NC coefficients c (Horner from the top)
template <int NC>
__device__ __forceinline__ float gelu_erf(float x, const float* c) {
  const float z = x * kRsqrt2;
  const float u = kTwoOverZ0Sq * fminf(z * z, kErfZ0Sq) - 1.0f;
  float p = c[NC - 1];
#pragma unroll
  for (int i = NC - 2; i >= 0; --i) p = p * u + c[i];
  const float e = fminf(fmaxf(z * p, -1.0f), 1.0f);
  return 0.5f * x * (1.0f + e);
}

__device__ __forceinline__ float gelu15(float x) { return gelu_erf<16>(x, kErf15); }

__constant__ float kErf9[10] = {
    0.3821687211819126f, -0.1906354404948208f, 0.13926991905032793f,
    -0.10986806700502608f, 0.102285918252448f, -0.08351699887774686f,
    0.021168399249059538f, -0.011215921240360423f, 0.05439620276621701f,
    -0.03381804338264774f};

// the inference Blocks' GELU: degree 9 (default) or 15
__device__ __forceinline__ float gelu_poly(float x, int degree) {
  return degree == 15 ? gelu15(x) : gelu_erf<10>(x, kErf9);
}

// ---------------------------------------------------------------- matrices
struct NoRow {};   // the row state of a map that reads nothing per row

template <typename S>
struct Mat {  // row-major [rows, ld]: a loader of svtr_gemm_tc.cuh and svtr_wgrad_tc.cuh
  using Src = S;
  using Row = NoRow;
  static constexpr bool kMap = false, kWholeRows = false;
  const S* p;
  int ld;
  __device__ const S* row(int r) const { return p + (size_t)r * ld; }
  __device__ NoRow row_state(int) const { return {}; }
  __device__ void map8(int, int, float (&)[8]) const {}
  __device__ void map8(NoRow, int, float (&)[8]) const {}
  __device__ void prepare(int) {}
};

// ----------------------------------------------------------------- attention
constexpr int QT = 32;   // query rows per block (wrappers: _QUERY_TILE)
constexpr int KC = 64;   // keys per shared-memory chunk
constexpr int kAttnThreads = 256;

// The softmax forms of the Pallas kernels (svtr_attention_tc.cuh):
//   kClampExp:   p = round_T(exp(min(s, 60))), no max (inference Block),
//                normalised after PV by the row sum of the rounded p;
//   kMaxSubLate: p = round_T(exp(s - max)) (training Block), normalised
//                after PV by the row sum of the rounded p;
//   kMaxSubEarly: p = round_T(exp(s - max) / sum) before PV (the training
//                attention forwards of the composed path).
enum Softmax { kClampExp = 0, kMaxSubLate = 1, kMaxSubEarly = 2 };
constexpr float kScoreClamp = 60.0f;

// The w8a8 Block's float attention (kMaxSubEarly, float32 output).
size_t attention_smem_bytes(int d, int n) {
  return sizeof(float) * ((size_t)QT * d + (size_t)KC * (d + 1) + (size_t)QT * n);
}

// grid B * heads * ceil(N / QT), query tiles fastest (the tiles of one head
// share its keys in L2).  Row r of image b, head h: q at q[(b N +
// r) q_ld + h D], k / v at k / v[(b N + r) kv_ld + h D], out at out[(b N +
// r) out_ld + h D] in float32; q pre-scaled.  mask [N, N] float32 or NULL.
template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const T* __restrict__ q, int q_ld, const T* __restrict__ k,
                 const T* __restrict__ v, int kv_ld, float* __restrict__ out, int out_ld,
                 const float* __restrict__ mask, int heads, int N) {
  const int width = N;
  static_assert(kAttnThreads % D == 0 && QT * D % kAttnThreads == 0, "tile");
  constexpr int kRowsPerPass = kAttnThreads / D;
  constexpr int kPasses = QT / kRowsPerPass;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [QT][D]
  float* KVs = Qs + QT * D;              // [KC][D + 1]
  float* Ps = KVs + KC * (D + 1);        // [QT][width]

  const int tiles = (N + QT - 1) / QT, bh = blockIdx.x / tiles;
  const int b = bh / heads, h = bh % heads, q0 = (blockIdx.x % tiles) * QT;
  const int rows = min(QT, N - q0);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  const T* kp = k + row0 * kv_ld + h * D;
  const T* vp = v + row0 * kv_ld + h * D;

  for (int i = tid; i < QT * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    Qs[i] = r < rows ? to_f(q[(row0 + q0 + r) * q_ld + h * D + d]) : 0.f;
  }

  // scores for all N keys, float32 (+ mask)
  for (int kc = 0; kc < width; kc += KC) {
    const int kn = min(KC, width - kc);
    __syncthreads();
    for (int i = tid; i < KC * D; i += kAttnThreads) {
      const int j = i / D, d = i % D;
      KVs[j * (D + 1) + d] = j < kn ? to_f(kp[(size_t)(kc + j) * kv_ld + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < QT * KC; i += kAttnThreads) {
      const int r = i / KC, j = i % KC;
      if (r >= rows || j >= kn) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += Qs[r * D + d] * KVs[j * (D + 1) + d];
      if (mask) s += mask[(size_t)(q0 + r) * width + kc + j];
      Ps[r * width + kc + j] = s;
    }
  }
  __syncthreads();

  // one warp per row: max-subtract, exp, row sum, p / sum rounded to T
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kAttnThreads / 32) {
      float* prow = Ps + r * width;
      float m = -INFINITY;
      for (int j = lane; j < width; j += 32) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < width; j += 32) {
        const float p = expf(prow[j] - m);
        prow[j] = p;
        s += p;
      }
      s = warp_sum(s);
      for (int j = lane; j < width; j += 32) prow[j] = round_to<T>(prow[j] / s);
    }
  }

  // PV, float32 accumulation
  const int d = tid % D, r0 = tid / D;
  float acc[kPasses] = {};
  for (int kc = 0; kc < width; kc += KC) {
    const int kn = min(KC, width - kc);
    __syncthreads();
    for (int i = tid; i < KC * D; i += kAttnThreads) {
      const int j = i / D, dd = i % D;
      KVs[j * (D + 1) + dd] = j < kn ? to_f(vp[(size_t)(kc + j) * kv_ld + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = r0 + p * kRowsPerPass;
      if (r >= rows) continue;
      const float* prow = Ps + r * width + kc;
      for (int j = 0; j < kn; ++j) acc[p] += prow[j] * KVs[j * (D + 1) + d];
    }
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int r = r0 + p * kRowsPerPass;
    if (r >= rows) continue;
    out[(row0 + q0 + r) * out_ld + h * D + d] = acc[p];
  }
}

template <typename T, int D>
cudaError_t launch_attention(const T* q, int q_ld, const T* k, const T* v, int kv_ld,
                             float* out, int out_ld, const float* mask, int B, int heads, int N,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D, N);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)B * heads * ((N + QT - 1) / QT);
  attention_kernel<T, D><<<grid, kAttnThreads, smem, stream>>>(q, q_ld, k, v, kv_ld, out,
                                                               out_ld, mask, heads, N);
  return cudaGetLastError();
}

// attention_kernel for head dim D in {8, 16, 32, 64}
template <typename T>
cudaError_t attention(const T* q, int q_ld, const T* k, const T* v, int kv_ld, float* out,
                      int out_ld, const float* mask, int B, int heads, int N, int D,
                      cudaStream_t s) {
#define ATTN_CASE(DD)                                                                   \
  case DD:                                                                              \
    return launch_attention<T, DD>(q, q_ld, k, v, kv_ld, out, out_ld, mask, B, heads, N, s)
  switch (D) {
    ATTN_CASE(8);
    ATTN_CASE(16);
    ATTN_CASE(32);
    ATTN_CASE(64);
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_CASE
}

}  // namespace
