// Device code shared by the port's CUDA sources (svtr_block.cu,
// svtr_block_int8.cu, svtr_attention.cu, svtr_train_block.cu).  Each source
// is its own shared library, so everything here sits in an anonymous
// namespace.
//
//   - float <-> working type T (float or bfloat16) and rounding to T;
//   - warp reductions;
//   - the minimax erf polynomials of the GELU, degree 15 (the JAX package's
//     _ERF_COEFS; |erf error| < 1.9e-7) and degree 9 (_ERF9_COEFS, the
//     inference Blocks' default; |erf error| < 1.4e-4);
//   - Mat, a row-major matrix as the loader of the projection and
//     weight-gradient main loops (svtr_gemm_tc.cuh, svtr_wgrad_tc.cuh);
//   - the names of the three softmax forms of the Pallas kernels (the tile
//     attention of svtr_attention_tc.cuh takes each) and the granule of a
//     band's query blocks.

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
constexpr int QT = 32;   // band query blocks are a multiple of it (wrappers: _QUERY_TILE)

// The softmax forms of the Pallas kernels (svtr_attention_tc.cuh):
//   kClampExp:   p = round_T(exp(min(s, 60))), no max (inference Block),
//                normalised after PV by the row sum of the rounded p;
//   kMaxSubLate: p = round_T(exp(s - max)) (training Block), normalised
//                after PV by the row sum of the rounded p;
//   kMaxSubEarly: p = round_T(exp(s - max) / sum) before PV (the training
//                attention forwards of the composed path, and the w8a8
//                Block's float attention).
enum Softmax { kClampExp = 0, kMaxSubLate = 1, kMaxSubEarly = 2 };
constexpr float kScoreClamp = 60.0f;

}  // namespace
