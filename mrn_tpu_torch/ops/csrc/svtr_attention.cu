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
// This is the training softmax (max-subtract, normalise before PV); the
// serving kernel's clamp-exp and ones-column row-sum (svtr_block.cu) are a
// different contract and are not used here.  The backward is not a kernel:
// as in the JAX package, it recomputes the plain math and takes its vjp.
//
// Bound on an H100: at the SVTR training shapes (N 128..512, D 32, batch
// 256) the scores and PV are 4*BH*pairs*D operations against 4*BH*N*D
// elements of q/k/v/out, pairs/N operations per element (77 for the 7x11
// Local window, N for Global): under the bf16 ridge of ~295 operations per
// byte, so bf16 is bound by the bytes, float32 by its 67 TFLOP/s CUDA-core
// rate.  The [N, width] f32 score tile of one query tile lives in shared
// memory and never reaches device memory, which is the point of the Pallas
// kernels too.
//
// Design (simple first): one block of 256 threads per (image*head, 32-query
// tile).  It keeps the tile's queries in shared memory, streams 64-key K
// chunks through shared memory to fill the [32, width] score tile, does the
// row max / exp / sum / normalise with one warp per row, then streams 64-key
// V chunks for PV.  A query tile never straddles two band query blocks (qb
// is a multiple of 32), so all its rows share one key window.  All products
// run as float32 FMAs on the CUDA cores; tensor cores (mma.sync/wgmma),
// cp.async/TMA pipelining and fusing with the qkv/proj projections are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;  // query rows per block (wrapper: _QUERY_TILE)
constexpr int KC = 64;  // keys per shared-memory chunk
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

size_t smem_bytes(int d, int width) {
  return sizeof(float) * ((size_t)QT * d + (size_t)KC * (d + 1) + (size_t)QT * width);
}

// grid (BH, ceil(N / QT)).  mask: [N, width] float32 or NULL; starts: int32
// [N / qb] window starts or NULL (one window [0, width) for every query).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const int* __restrict__ starts, T* __restrict__ out, int N,
                     int qb, int width) {
  static_assert(kThreads % D == 0 && (QT * D) % kThreads == 0, "tile");
  constexpr int kRowsPerPass = kThreads / D;
  constexpr int kPasses = QT / kRowsPerPass;
  extern __shared__ float smem[];
  float* Qs = smem;                // [QT][D]
  float* KVs = Qs + QT * D;        // [KC][D + 1]
  float* Ps = KVs + KC * (D + 1);  // [QT][width]

  const int q0 = blockIdx.y * QT;
  const int rows = min(QT, N - q0);
  const int kbase = starts ? starts[q0 / qb] : 0;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * N * D;
  const T* qp = q + base;
  const T* kp = k + base + (size_t)kbase * D;
  const T* vp = v + base + (size_t)kbase * D;

  for (int i = tid; i < QT * D; i += kThreads) {
    const int r = i / D;
    Qs[i] = r < rows ? to_f(qp[(size_t)q0 * D + i]) : 0.f;
  }

  // scores for the whole key window, float32
  for (int kc = 0; kc < width; kc += KC) {
    const int kn = min(KC, width - kc);
    __syncthreads();
    for (int i = tid; i < KC * D; i += kThreads) {
      const int j = i / D, d = i % D;
      KVs[j * (D + 1) + d] = j < kn ? to_f(kp[(size_t)(kc + j) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < QT * KC; i += kThreads) {
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

  // max-subtract softmax, one warp per row; P normalised, then rounded to T
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* prow = Ps + r * width;
      float m = -INFINITY;
      for (int j = lane; j < width; j += 32) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < width; j += 32) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        s += e;
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
    for (int i = tid; i < KC * D; i += kThreads) {
      const int j = i / D, dd = i % D;
      KVs[j * (D + 1) + dd] = j < kn ? to_f(vp[(size_t)(kc + j) * D + dd]) : 0.f;
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
    out[base + (size_t)(q0 + r) * D + d] = from_f<T>(acc[p]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                   const int* starts, void* out, int BH, int N, int qb, int width,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D, width);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (N + QT - 1) / QT);
  attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, starts, static_cast<T*>(out), N, qb, width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* mask,
                     const int* starts, void* out, int BH, int N, int D, int qb,
                     int width, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, mask, starts, out, BH, N, qb, width, stream);
    case 16: return launch<T, 16>(q, k, v, mask, starts, out, BH, N, qb, width, stream);
    case 32: return launch<T, 32>(q, k, v, mask, starts, out, BH, N, qb, width, stream);
    case 64: return launch<T, 64>(q, k, v, mask, starts, out, BH, N, qb, width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q, k, v, out: [BH, N, D] contiguous in the
// working type.  Full attention: starts NULL, width == N, qb == N, mask
// [N, N] or NULL.  Banded: starts int32 [N / qb] on the device, qb a
// multiple of 32, mask [N, width].  Returns 0 or the CUDA error code of the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
int svtr_attention_forward(int dtype, const void* q, const void* k, const void* v,
                           const float* mask, const int* starts, void* out, int BH,
                           int N, int D, int qb, int width, void* stream) {
  if (BH <= 0 || N <= 0 || width <= 0 || qb <= 0) return (int)cudaErrorInvalidValue;
  if (starts == nullptr && (width != N || qb != N)) return (int)cudaErrorInvalidValue;
  if (starts != nullptr && (qb % QT != 0 || N % qb != 0 || width > N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, mask, starts, out, BH, N, D, qb, width, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, starts, out, BH, N, D, qb, width, s);
  return (int)cudaErrorInvalidValue;
}

const char* svtr_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
