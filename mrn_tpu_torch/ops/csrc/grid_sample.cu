// TPS bilinear warp for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mrn_tpu/ops/grid_sample.py::grid_sample_pallas:
// torch grid_sample semantics with padding_mode="border" and
// align_corners=True on NHWC images.  image [B, H, W, C] in the working type
// T (float or bfloat16); grid [B, Ho, Wo, 2] (x, y) in [-1, 1], always float32
// (bf16 coordinates would move the taps by up to half a pixel at W = 256);
// out [B, Ho, Wo, C] in T.  Per output pixel, exactly as the Pallas kernel and
// the JAX package's _unnormalize/_corners compute it, in float32:
//   ix = clamp((gx + 1) * 0.5 * (W - 1), 0, W - 1)    (iy likewise with H)
//   x0 = floor(ix), fx = ix - x0, x1 = min(x0 + 1, W - 1)
//   top = v00 (1 - fx) + v01 fx,  bot = v10 (1 - fx) + v11 fx
//   out = top (1 - fy) + bot fy,  rounded to T once.
// Every product and sum is a rounded __fmul_rn/__fadd_rn, so nvcc cannot
// contract them into FMAs: the kernel and its plain PyTorch version
// (ops/grid_sample.py::grid_sample_reference) then agree bit for bit.
//
// Not a copy of the Pallas body: its one-hot rows contracted on the MXU were
// a way round slow TPU gathers.  On Hopper the natural form is a direct
// 4-tap gather, one thread per output pixel.  With C = 4 one tap is one
// 16-byte (float) or 8-byte (bfloat16) vector load, and the thread writes its
// pixel with one vector store; other C take a channel loop.
//
// Bound on an H100: at the TRBA shape (batch 256, 32x256x4 -> 32x256) the
// image is read once, the grid read once and the output written once: 83.9
// MB in float32 (25.0 us at 3.35 TB/s), 50.3 MB with a bfloat16 image (15.0
// us); about 6 operations per output value, so it is bound by the bytes.
// Neighbouring threads take neighbouring output pixels, so the grid loads
// and the output stores coalesce; the taps of a TPS grid move slowly across
// a row, so neighbouring threads mostly read neighbouring image pixels too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

// (coord + 1) * 0.5 * (size - 1), clamped to [0, size - 1]
__device__ __forceinline__ float unnormalize(float coord, int size) {
  float ix = __fmul_rn(__fmul_rn(__fadd_rn(coord, 1.0f), 0.5f), (float)(size - 1));
  return fminf(fmaxf(ix, 0.0f), (float)(size - 1));
}

struct Taps {
  int x0, x1;
  float f;
};

__device__ __forceinline__ Taps corners(float ix, int size) {
  float x0 = floorf(ix);
  Taps t;
  t.f = __fsub_rn(ix, x0);
  t.x0 = min(max((int)x0, 0), size - 1);
  t.x1 = min(t.x0 + 1, size - 1);
  return t;
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10, float v11,
                                       const Taps& tx, const Taps& ty) {
  float gx = __fsub_rn(1.0f, tx.f), gy = __fsub_rn(1.0f, ty.f);
  float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, tx.f));
  float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, tx.f));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, ty.f));
}

// VEC4: C == 4 with 4-element-aligned pixels, one vector load per tap.
template <typename T, bool VEC4>
__global__ void __launch_bounds__(kThreads)
    grid_sample_kernel(const T* __restrict__ img, const float2* __restrict__ grid,
                       T* __restrict__ out, int H, int W, int C, long long hw_out,
                       long long total) {
  long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const float2 g = grid[p];
  const Taps tx = corners(unnormalize(g.x, W), W);
  const Taps ty = corners(unnormalize(g.y, H), H);
  const T* base = img + (p / hw_out) * H * W * C;
  const T* r0 = base + (long long)ty.x0 * W * C;
  const T* r1 = base + (long long)ty.x1 * W * C;
  if constexpr (VEC4) {
    const Vec4<T> a = *reinterpret_cast<const Vec4<T>*>(r0 + tx.x0 * 4);
    const Vec4<T> b = *reinterpret_cast<const Vec4<T>*>(r0 + tx.x1 * 4);
    const Vec4<T> c = *reinterpret_cast<const Vec4<T>*>(r1 + tx.x0 * 4);
    const Vec4<T> d = *reinterpret_cast<const Vec4<T>*>(r1 + tx.x1 * 4);
    Vec4<T> o;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o.v[k] = from_f<T>(lerp2(to_f(a.v[k]), to_f(b.v[k]), to_f(c.v[k]), to_f(d.v[k]), tx, ty));
    *reinterpret_cast<Vec4<T>*>(out + p * 4) = o;
  } else {
    for (int k = 0; k < C; ++k)
      out[p * C + k] = from_f<T>(lerp2(to_f(r0[tx.x0 * C + k]), to_f(r0[tx.x1 * C + k]),
                                       to_f(r1[tx.x0 * C + k]), to_f(r1[tx.x1 * C + k]),
                                       tx, ty));
  }
}

template <typename T>
cudaError_t launch(const void* image, const float* grid, void* out, int B, int H, int W,
                   int C, int Ho, int Wo, cudaStream_t s) {
  const long long hw_out = (long long)Ho * Wo, total = (long long)B * hw_out;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* img = static_cast<const T*>(image);
  T* o = static_cast<T*>(out);
  const float2* g = reinterpret_cast<const float2*>(grid);
  const bool vec4 = C == 4 && reinterpret_cast<uintptr_t>(image) % sizeof(Vec4<T>) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % sizeof(Vec4<T>) == 0;
  if (vec4)
    grid_sample_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(img, g, o, H, W, C,
                                                                       hw_out, total);
  else
    grid_sample_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(img, g, o, H, W, C,
                                                                        hw_out, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (the image's and the output's).  image
// [B, H, W, C], grid float32 [B, Ho, Wo, 2] (8-byte aligned), out
// [B, Ho, Wo, C], all contiguous on the device.  Returns 0 or the CUDA error
// code of the launch (cudaErrorInvalidValue for arguments it does not take).
int grid_sample_forward(int dtype, const void* image, const float* grid, void* out, int B,
                        int H, int W, int C, int Ho, int Wo, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 ||
      reinterpret_cast<uintptr_t>(grid) % sizeof(float2) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(image, grid, out, B, H, W, C, Ho, Wo, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(image, grid, out, B, H, W, C, Ho, Wo, s);
  return (int)cudaErrorInvalidValue;
}

const char* grid_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
