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
// This is the training softmax (max-subtract, normalise before PV).  The
// backward is not a kernel: as in the JAX package, it recomputes the plain
// math and takes its vjp.
//
// Bound on an H100: at the SVTR training shapes (N 128..512, D 32, batch
// 256) every call moves q, k, v and out once (67 MB in bfloat16) and does
// 4*BH*N*width*D operations of QK^T and PV: 77..256 operations per element,
// under the bf16 ridge of ~295, so bfloat16 is bound by the bytes (~20 us a
// call); float32 is bound by its 67 TFLOP/s CUDA-core rate.  Each score also
// costs an exp and a division, work of the same order as the memory time,
// so the softmax runs in registers and never touches shared memory.
//
// Design: the tile attention of svtr_attention_tc.cuh in its kMaxSubEarly
// form, over [BH, N, D] rows (heads 1, every row stride D): one block of 4
// warps per (image*head, span of up to 128 query rows), scores of a 16-row
// tile in registers, bf16 QK^T and PV on the tensor cores (mma.sync
// m16n8k16), float32 register-tiled on the CUDA cores, one pass over a
// window of exactly 128 or 256 keys and three passes over 256-key segments
// for any other.  Left for later: TMA, a producer warp overlapping one
// span's loads with another's compute, and wgmma.

#include "svtr_attention_tc.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q, k, v, out: [BH, N, D] contiguous in the
// working type, 16-byte aligned.  Full attention: starts NULL, width == N,
// qb == N, mask [N, N] or NULL.  Banded: starts int32 [N / qb] on the
// device, qb a multiple of 32, mask [N, width].  Returns 0 or the CUDA error
// code of the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
int svtr_attention_forward(int dtype, const void* q, const void* k, const void* v,
                           const float* mask, const int* starts, void* out, int BH,
                           int N, int D, int qb, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_ARGS(T)                                                                        \
  static_cast<const T*>(q), D, static_cast<const T*>(k), static_cast<const T*>(v), D,      \
      static_cast<T*>(out), D, mask, starts, BH, 1, N, D, qb, width, s
  if (dtype == 0) return (int)attention_tc<float, kMaxSubEarly, true>(ATTN_ARGS(float));
  if (dtype == 1)
    return (int)attention_tc<__nv_bfloat16, kMaxSubEarly, true>(ATTN_ARGS(__nv_bfloat16));
#undef ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}

// The launch plan of svtr_attention_forward for these arguments: out[0..4]
// = query rows per block, key tiles held in registers, key segments, passes
// over the keys, dynamic shared-memory bytes.
int svtr_attention_plan(int dtype, int N, int D, int qb, int width, int* out) {
  export_plan(make_plan(kMaxSubEarly, dtype, N, D, qb, width), out);
  return 0;
}

const char* svtr_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
