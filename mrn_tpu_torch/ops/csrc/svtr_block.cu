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
// Design (simple first): five launches per Block.
//   1. gemm<kQkv>:  per 64x64 output tile, the block recomputes its rows'
//      LayerNorm statistics, normalises A tiles on the fly, and stores qkv
//      in T (every consumer rounds q/k/v to T, so this loses nothing);
//   2. attention:   per (image, head, 32-query tile), scores against the
//      tile's key window chunk by chunk into a [32, width] shared-memory P
//      tile, then row-sums and PV;
//   3. gemm<kProj>: attn @ Wproj + b + x -> x1 (float32, the residual stream
//      stays float32 as in the Pallas kernel);
//   4. gemm<kFc1>:  LN(x1) @ Wfc1_f + b, GELU -> g in T;
//   5. gemm<kFc2>:  g @ Wfc2 + b + x1 -> out in T.
// What it leaves on the table: every product runs on the CUDA cores in
// float32 FMAs (no wgmma/mma.sync tensor-core path, no TMA or cp.async
// pipelining), and qkv, attn, x1 and g round-trip through device memory
// instead of staying on chip across the Block.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kScoreClamp = 60.0f;
constexpr float kErfZ0Sq = (float)(3.7 * 3.7);
constexpr float kTwoOverZ0Sq = (float)(2.0 / (3.7 * 3.7));
constexpr float kRsqrt2 = 0.70710678118654752f;

__constant__ float kErf9[10] = {
    0.3821687211819126f, -0.1906354404948208f, 0.13926991905032793f,
    -0.10986806700502608f, 0.102285918252448f, -0.08351699887774686f,
    0.021168399249059538f, -0.011215921240360423f, 0.05439620276621701f,
    -0.03381804338264774f};
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

__device__ __forceinline__ float gelu_poly(float x, int degree) {
  const float* c = degree == 15 ? kErf15 : kErf9;
  const int n = degree == 15 ? 16 : 10;
  const float z = x * kRsqrt2;
  const float u = kTwoOverZ0Sq * fminf(z * z, kErfZ0Sq) - 1.0f;
  float p = c[n - 1];
  for (int i = n - 2; i >= 0; --i) p = p * u + c[i];
  const float erf = fminf(fmaxf(z * p, -1.0f), 1.0f);
  return 0.5f * x * (1.0f + erf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- projections
enum Mode { kQkv = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };
constexpr int BM = 64, BN = 64, BK = 16, kGemmThreads = 256;

// out[M, Nout] = A[M, K] @ W[K, Nout] + bias (+ epilogue by MODE).
// A is T except for kFc1 (float32 x1); kQkv/kFc1 normalise A's rows first.
template <typename T, int MODE>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const void* __restrict__ a_ptr, const T* __restrict__ w,
            const float* __restrict__ bias, const void* __restrict__ res_ptr,
            void* __restrict__ out_ptr, int M, int K, int Nout, int gelu_degree) {
  constexpr bool kLN = MODE == kQkv || MODE == kFc1;
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN];
  __shared__ float s_mean[BM], s_rstd[BM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

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

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kGemmThreads) {
      const int r = i / BK, kk = i % BK, m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = load_a(m, k);
        if (kLN) v = (v - s_mean[r]) * s_rstd[r];
        v = round_to<T>(v);
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += kGemmThreads) {
      const int kk = i / BN, cc = i % BN, k = k0 + kk, n = n0 + cc;
      Ws[kk][cc] = (k < K && n < Nout) ? to_f(w[(size_t)k * Nout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Nout) continue;
      const size_t o = (size_t)m * Nout + n;
      const float v = acc[i][j] + bias[n];
      if (MODE == kQkv) {
        static_cast<T*>(out_ptr)[o] = from_f<T>(v);
      } else if (MODE == kProj) {
        static_cast<float*>(out_ptr)[o] = to_f(static_cast<const T*>(res_ptr)[o]) + v;
      } else if (MODE == kFc1) {
        static_cast<T*>(out_ptr)[o] = from_f<T>(gelu_poly(v, gelu_degree));
      } else {
        static_cast<T*>(out_ptr)[o] =
            from_f<T>(static_cast<const float*>(res_ptr)[o] + v);
      }
    }
  }
}

// ------------------------------------------------------------------ attention
constexpr int QT = 32;   // query rows per block (wrapper: _QUERY_TILE)
constexpr int KC = 64;   // keys per shared-memory chunk
constexpr int kAttnThreads = 256;

size_t attention_smem_bytes(int d, int width) {
  return sizeof(float) * ((size_t)QT * d + (size_t)KC * (d + 1) + (size_t)QT * width);
}

// grid (ceil(N / QT), heads, B).  qkv [B, N, 3C] in T, out attn [B, N, C] in T.
template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                 const float* __restrict__ mask, const int* __restrict__ starts,
                 int N, int C, int qb, int width) {
  static_assert(kAttnThreads % D == 0 && QT * D % kAttnThreads == 0, "tile");
  constexpr int kRowsPerPass = kAttnThreads / D;
  constexpr int kPasses = QT / kRowsPerPass;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [QT][D]
  float* KVs = Qs + QT * D;              // [KC][D + 1]
  float* Ps = KVs + KC * (D + 1);        // [QT][width]
  __shared__ float s_inv[QT];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int rows = min(QT, N - q0);
  const int kbase = starts ? starts[q0 / qb] : 0;
  const int tid = threadIdx.x;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * N * ld;

  for (int i = tid; i < QT * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    Qs[i] = r < rows ? to_f(base[(q0 + r) * ld + h * D + d]) : 0.f;
  }

  // scores -> exp -> P (rounded to T) for the whole key window
  for (int kc = 0; kc < width; kc += KC) {
    const int kn = min(KC, width - kc);
    __syncthreads();
    for (int i = tid; i < KC * D; i += kAttnThreads) {
      const int j = i / D, d = i % D;
      KVs[j * (D + 1) + d] =
          j < kn ? to_f(base[(kbase + kc + j) * ld + C + h * D + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < QT * KC; i += kAttnThreads) {
      const int r = i / KC, j = i % KC;
      if (r >= rows || j >= kn) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += Qs[r * D + d] * KVs[j * (D + 1) + d];
      if (mask) s += mask[(size_t)(q0 + r) * width + kc + j];
      Ps[r * width + kc + j] = round_to<T>(expf(fminf(s, kScoreClamp)));
    }
  }
  __syncthreads();

  // row-sums over the rounded P (the Pallas kernel's ones-column)
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kAttnThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < width; j += 32) s += Ps[r * width + j];
      s = warp_sum(s);
      if (lane == 0) s_inv[r] = 1.0f / (s + 1e-30f);
    }
  }

  // PV
  const int d = tid % D, r0 = tid / D;
  float acc[kPasses] = {};
  for (int kc = 0; kc < width; kc += KC) {
    const int kn = min(KC, width - kc);
    __syncthreads();
    for (int i = tid; i < KC * D; i += kAttnThreads) {
      const int j = i / D, dd = i % D;
      KVs[j * (D + 1) + dd] =
          j < kn ? to_f(base[(kbase + kc + j) * ld + 2 * C + h * D + dd]) : 0.f;
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
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int r = r0 + p * kRowsPerPass;
    if (r >= rows) continue;
    out[((size_t)b * N + q0 + r) * C + h * D + d] = from_f<T>(acc[p] * s_inv[r]);
  }
}

template <typename T, int D>
cudaError_t launch_attention(const T* qkv, T* out, const float* mask,
                             const int* starts, int B, int N, int C, int heads,
                             int qb, int width, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D, width);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QT - 1) / QT, heads, B);
  attention_kernel<T, D><<<grid, kAttnThreads, smem, stream>>>(qkv, out, mask, starts,
                                                               N, C, qb, width);
  return cudaGetLastError();
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
  T* a = static_cast<T*>(attn);
  switch (D) {
    case 8:
      err = launch_attention<T, 8>(q, a, mask, starts, B, N, C, heads, qb, width, stream);
      break;
    case 16:
      err = launch_attention<T, 16>(q, a, mask, starts, B, N, C, heads, qb, width, stream);
      break;
    case 32:
      err = launch_attention<T, 32>(q, a, mask, starts, B, N, C, heads, qb, width, stream);
      break;
    case 64:
      err = launch_attention<T, 64>(q, a, mask, starts, B, N, C, heads, qb, width, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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
