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
// of SVTR (the four projections carry most of it), so at batch 256 the work
// is compute-bound: ~2.6 TFLOP for a 6-expert batch, a ~2.6 ms floor at the
// bf16 tensor-core rate, against ~0.1 GB of activations moved per Block.
//
// Design (simple first): five launches per Block, on the GEMM main loop and
// the attention kernel of svtr_common.cuh.
//   1. gemm<kQkv>:  per 64x64 output tile, the block recomputes its rows'
//      LayerNorm statistics, normalises A tiles on the fly, and stores qkv
//      in T (every consumer rounds q/k/v to T, so this loses nothing);
//   2. attention (kClampExp): per (image, head, 32-query tile), scores
//      against the tile's key window chunk by chunk into a [32, width]
//      shared-memory P tile, then row-sums and PV;
//   3. gemm<kProj>: attn @ Wproj + b + x -> x1 (float32, the residual stream
//      stays float32 as in the Pallas kernel);
//   4. gemm<kFc1>:  LN(x1) @ Wfc1_f + b, GELU -> g in T;
//   5. gemm<kFc2>:  g @ Wfc2 + b + x1 -> out in T.
// What it leaves on the table: every product runs on the CUDA cores in
// float32 FMAs (no wgmma/mma.sync tensor-core path, no TMA or cp.async
// pipelining), and qkv, attn, x1 and g round-trip through device memory
// instead of staying on chip across the Block.  Those are later work.

#include "svtr_common.cuh"

namespace {

// ---------------------------------------------------------------- projections
enum Mode { kQkv = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };

// out[M, Nout] = A[M, K] @ W[K, Nout] + bias (+ epilogue by MODE).
// A is T except for kFc1 (float32 x1); kQkv/kFc1 normalise A's rows first,
// with the statistics of the block's 64 rows computed up front.
template <typename T, int MODE>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const void* __restrict__ a_ptr, const T* __restrict__ w,
            const float* __restrict__ bias, const void* __restrict__ res_ptr,
            void* __restrict__ out_ptr, int M, int K, int Nout, int gelu_degree) {
  constexpr bool kLN = MODE == kQkv || MODE == kFc1;
  __shared__ float s_mean[BM], s_rstd[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;

  auto load_a = [&](int m, int k) -> float {
    if (MODE == kFc1) return static_cast<const float*>(a_ptr)[(size_t)m * K + k];
    return to_f(static_cast<const T*>(a_ptr)[(size_t)m * K + k]);
  };

  if (kLN) {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float s = 0.f, ss = 0.f;
      if (m < M) {
        for (int k = lane; k < K; k += 32) {
          const float v = load_a(m, k);
          s += v;
          ss += v * v;
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mean = s / K;
        const float var = ss / K - mean * mean;
        s_mean[r] = mean;
        s_rstd[r] = rsqrtf(var + 1e-6f);
      }
    }
    __syncthreads();
  }

  auto a = [&](int m, int k) -> float {
    const float v = load_a(m, k);
    return kLN ? (v - s_mean[m - m0]) * s_rstd[m - m0] : v;
  };
  float acc[4][4] = {};
  gemm_mainloop<T, true, true>(a, Mat<T>{w, Nout}, M, Nout, 0, K, acc);
  gemm_store(acc, M, Nout, [&](int m, int n, float v0) {
    const size_t o = (size_t)m * Nout + n;
    const float v = v0 + bias[n];
    if (MODE == kQkv) {
      static_cast<T*>(out_ptr)[o] = from_f<T>(v);
    } else if (MODE == kProj) {
      static_cast<float*>(out_ptr)[o] = to_f(static_cast<const T*>(res_ptr)[o]) + v;
    } else if (MODE == kFc1) {
      static_cast<T*>(out_ptr)[o] = from_f<T>(gelu_poly(v, gelu_degree));
    } else {
      static_cast<T*>(out_ptr)[o] = from_f<T>(static_cast<const float*>(res_ptr)[o] + v);
    }
  });
}

template <typename T, int MODE>
cudaError_t launch_gemm(const void* a, const void* w, const float* bias,
                        const void* res, void* out, int M, int K, int Nout,
                        int gelu_degree, cudaStream_t stream) {
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, MODE><<<grid, kGemmThreads, 0, stream>>>(
      a, static_cast<const T*>(w), bias, res, out, M, K, Nout, gelu_degree);
  return cudaGetLastError();
}

template <typename T>
int block_forward(const void* x, const void* qkv_w, const float* qkv_b,
                  const void* proj_w, const float* proj_b, const void* fc1_w,
                  const float* fc1_b, const void* fc2_w, const float* fc2_b,
                  const float* mask, const int* starts, void* qkv, void* attn,
                  float* x1, void* g, void* out, int B, int N, int C, int heads,
                  int hidden, int qb, int width, int gelu_degree,
                  cudaStream_t stream) {
  const int M = B * N, D = C / heads;
  cudaError_t err = launch_gemm<T, kQkv>(x, qkv_w, qkv_b, nullptr, qkv, M, C, 3 * C,
                                         gelu_degree, stream);
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(qkv);
  err = attention<T, kClampExp>(q, 3 * C, q + C, q + 2 * C, 3 * C, static_cast<T*>(attn), C,
                                mask, starts, B, heads, N, D, qb, width, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<T, kProj>(attn, proj_w, proj_b, x, x1, M, C, C, gelu_degree, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<T, kFc1>(x1, fc1_w, fc1_b, nullptr, g, M, C, hidden, gelu_degree,
                             stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<T, kFc2>(g, fc2_w, fc2_b, x1, out, M, hidden, C, gelu_degree, stream);
  return (int)err;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return block_forward<float>(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                                fc2_b, mask, starts, qkv, attn, x1, g, out, B, N, C,
                                heads, hidden, qb, width, gelu_degree, s);
  if (dtype == 1)
    return block_forward<__nv_bfloat16>(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                                        fc2_w, fc2_b, mask, starts, qkv, attn, x1, g,
                                        out, B, N, C, heads, hidden, qb, width,
                                        gelu_degree, s);
  return (int)cudaErrorInvalidValue;
}

const char* svtr_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
