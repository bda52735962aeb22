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
// Design (simple first): the attention kernel of svtr_common.cuh in its
// kMaxSubEarly form, one block of 256 threads per (image*head, 32-query
// tile).  It keeps the tile's queries in shared memory, streams 64-key K
// chunks through shared memory to fill the [32, width] score tile, does the
// row max / exp / sum / normalise with one warp per row, then streams 64-key
// V chunks for PV.  A query tile never straddles two band query blocks (qb
// is a multiple of 32), so all its rows share one key window.  All products
// run as float32 FMAs on the CUDA cores; tensor cores (mma.sync/wgmma),
// cp.async/TMA pipelining and fusing with the qkv/proj projections are
// later work.

#include "svtr_common.cuh"

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
  // [BH, N, D] is the shared kernel's layout with one head per image and
  // row strides D
#define ATTN_ARGS(T)                                                                       \
  static_cast<const T*>(q), D, static_cast<const T*>(k), static_cast<const T*>(v), D,     \
      static_cast<T*>(out), D, mask, starts, BH, 1, N, D, qb, width, s
  if (dtype == 0) return (int)attention<float, kMaxSubEarly>(ATTN_ARGS(float));
  if (dtype == 1) return (int)attention<__nv_bfloat16, kMaxSubEarly>(ATTN_ARGS(__nv_bfloat16));
#undef ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* svtr_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
