// Fused SVTR inference Block for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mrn_tpu/ops/svtr_block.py::_make_kernel
// (reached through fused_block's pallas_call, float32/bfloat16 branch).  For
// x[B, N, C] in the working type T (float or bfloat16) it computes
//
//   x1  = x + proj( softmax*( LN(x) @ Wqkv_f ) )
//   out = x1 + fc2( gelu( LN(x1) @ Wfc1_f ) )
//
// with the JAX kernel's numerics: bare single-pass LayerNorm (E[x^2]-mean^2,
// eps 1e-6, float32), the LN affine and q-scale pre-folded into Wqkv_f/Wfc1_f
// by the caller, matmul operands rounded to T with float32 accumulation,
// softmax as exp(min(s, 60)) without max-subtract, P rounded to T, the row-sum
// over the rounded P and the normalise after PV with +1e-30, GELU through the
// degree-9 (or 15) minimax erf polynomial, and banded windows for Local
// blocks (query block a of qb rows attends to keys [starts[a], starts[a] +
// width) with the [N, width] band mask).
//
// Bound on an H100: about 1.66 GFLOP per image per expert for the 12 Blocks
// of SVTR (the four projections carry most of it), ~0.40 ms at the bf16
// tensor-core rate at batch 256, against ~5 GB of activations moved by the
// five launches per expert (~1.5 ms at 3.35 TB/s): in bfloat16 the Block is
// held by its bytes, in float32 (67 TFLOP/s on the CUDA cores) by its
// operations.
//
// Design: five launches per Block.
//   1. proj<qkv>: LN(x) @ Wqkv_f + b -> qkv in T (every consumer rounds q, k,
//      v to T, so this loses nothing); the block computes its 128 rows'
//      LayerNorm statistics up front and normalises A as it loads it;
//   2. attention: the tile attention of svtr_attention_tc.cuh in its
//      kClampExp form, reading q, k, v inside qkv [B, N, 3C] and writing
//      attn [B, N, C];
//   3. proj<proj>: attn @ Wproj + b + x -> x1 (float32: the residual stream
//      stays float32 as in the Pallas kernel);
//   4. proj<fc1>: LN(x1) @ Wfc1_f + b, GELU -> g in T;
//   5. proj<fc2>: g @ Wfc2 + b + x1 -> out in T.
// The projections run the main loops of svtr_gemm_tc.cuh: bf16 on the tensor
// cores (mma.sync), float32 register-tiled on the CUDA cores.  What it
// leaves on the table: wgmma and TMA, and keeping qkv, attn, x1 and g on
// chip across the Block.

#include "svtr_attention_tc.cuh"
#include "svtr_gemm_tc.cuh"

namespace {

#define TRY(call)                              \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// ---------------------------------------------------------------- epilogues
// Each takes columns j .. j + 8 of row i of the float32 accumulator v
// (svtr_gemm_tc.cuh); prefetch loads the residual, if any, into r.

template <typename T>
struct QkvOut {  // qkv = acc + b (T)
  const float* bias;
  T* qkv;
  int ld;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += b[e];
    store8(qkv + (size_t)i * ld + j, v);
  }
};

template <typename T>
struct ProjOut {  // x1 = x + (acc + b), float32
  const float* bias;
  const T* x;
  float* x1;
  int ld;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(x + (size_t)i * ld + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r[e] + (v[e] + b[e]);
    store8(x1 + (size_t)i * ld + j, v);
  }
};

template <typename T>
struct Fc1Out {  // g = gelu(acc + b) (T)
  const float* bias;
  T* g;
  int ld, degree;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu_poly(v[e] + b[e], degree);
    store8(g + (size_t)i * ld + j, v);
  }
};

template <typename T>
struct Fc2Out {  // out = x1 + (acc + b) (T)
  const float* bias;
  const float* x1;
  T* out;
  int ld;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(x1 + (size_t)i * ld + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    float b[8];
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r[e] + (v[e] + b[e]);
    store8(out + (size_t)i * ld + j, v);
  }
};

template <typename T>
int block_forward(const T* x, const T* qkv_w, const float* qkv_b, const T* proj_w,
                  const float* proj_b, const T* fc1_w, const float* fc1_b, const T* fc2_w,
                  const float* fc2_b, const float* mask, const int* starts, T* qkv, T* attn,
                  float* x1, T* g, T* out, int B, int N, int C, int heads, int hidden, int qb,
                  int width, int gelu_degree, cudaStream_t s) {
  const int M = B * N;
  TRY(proj(LayerNormRows<T>{x, C, M}, qkv_w, QkvOut<T>{qkv_b, qkv, 3 * C}, M, 3 * C, C, s));
  TRY((attention_tc<T, kClampExp, false>(qkv, 3 * C, qkv + C, qkv + 2 * C, 3 * C, attn, C, mask,
                                  starts, B, heads, N, C / heads, qb, width, s)));
  TRY(proj(Mat<T>{attn, C}, proj_w, ProjOut<T>{proj_b, x, x1, C}, M, C, C, s));
  TRY(proj(LayerNormRows<float>{x1, C, M}, fc1_w, Fc1Out<T>{fc1_b, g, hidden, gelu_degree}, M,
           hidden, C, s));
  TRY(proj(Mat<T>{g, hidden}, fc2_w, Fc2Out<T>{fc2_b, x1, out, C}, M, C, hidden, s));
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Weights are [in, out] in the working type,
// biases float32.  mask: [N, width] float32 or NULL; starts: int32 [N / qb]
// device array or NULL (single window at key 0).  qkv/attn/g are scratch in
// the working type, x1 float32 scratch; out [B, N, C].  Returns the CUDA
// error code of the first failed launch, 0 on success.
int svtr_block_forward(int dtype, const void* x, const void* qkv_w,
                       const float* qkv_b, const void* proj_w, const float* proj_b,
                       const void* fc1_w, const float* fc1_b, const void* fc2_w,
                       const float* fc2_b, const float* mask, const int* starts,
                       void* qkv, void* attn, float* x1, void* g, void* out, int B,
                       int N, int C, int heads, int hidden, int qb, int width,
                       int gelu_degree, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || heads <= 0 || C % heads || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  if (gelu_degree != 9 && gelu_degree != 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_ARGS(T)                                                                       \
  static_cast<const T*>(x), static_cast<const T*>(qkv_w), qkv_b,                           \
      static_cast<const T*>(proj_w), proj_b, static_cast<const T*>(fc1_w), fc1_b,          \
      static_cast<const T*>(fc2_w), fc2_b, mask, starts, static_cast<T*>(qkv),             \
      static_cast<T*>(attn), x1, static_cast<T*>(g), static_cast<T*>(out), B, N, C, heads, \
      hidden, qb, width, gelu_degree, s
  if (dtype == 0) return block_forward<float>(BLOCK_ARGS(float));
  if (dtype == 1) return block_forward<__nv_bfloat16>(BLOCK_ARGS(__nv_bfloat16));
#undef BLOCK_ARGS
  return (int)cudaErrorInvalidValue;
}

// The launch plan of svtr_block_forward: out[0..4] the attention's (query
// rows per block, key tiles held in registers, key segments, passes over the
// keys, dynamic shared-memory bytes), out[5..8] the output columns per block
// of the qkv, proj, fc1 and fc2 projections (128 rows each).
int svtr_block_plan(int dtype, int N, int C, int heads, int hidden, int qb, int width,
                    int* out) {
  export_plan(make_plan(kClampExp, dtype, N, C / heads, qb, width), out);
  const int widths[4] = {3 * C, C, hidden, C}, depths[4] = {C, C, C, hidden};
  for (int i = 0; i < 4; ++i) out[5 + i] = tile_n(dtype, widths[i], depths[i]);
  return 0;
}

const char* svtr_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
