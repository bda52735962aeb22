// w8a8 SVTR inference Block for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mrn_tpu/ops/svtr_block.py::_make_kernel_int8
// (reached through fused_block(..., quant=...)).  For x[B, N, C] in the
// working type T (float or bfloat16) it computes
//
//   x1  = x + proj8( attention( qkv8( LN1(x) ) ) )
//   out = x1 + fc2_8( gelu( fc1_8( LN2(x1) ) ) )
//
// with the Pallas kernel's numerics:
//   - LayerNorm keeps its affine (single-pass E[x^2] - mean^2, eps 1e-6,
//     float32; nothing is folded into the weights);
//   - each projection quantizes its input per tensor, q8(h) = clip(rint(h *
//     inv), -127, 127) (a multiply by the calibrated reciprocal scale,
//     rounding half to even), multiplies int8 x int8 -> int32 against the
//     per-output-channel int8 kernel and dequantizes acc * deq[n] + bias[n]
//     in float32 (a rounded multiply, then a rounded add, as the plain
//     version does: the intrinsics keep nvcc from contracting them to FMAs);
//   - attention over the full [N, N] mask (the int8 path does not band),
//     max-subtract softmax normalised before PV, float32 output:
//       ATTN_INT8 false: q*scale, k and v rounded to T, float32 scores and PV
//       (the shared attention kernel in its kMaxSubEarly form);
//       ATTN_INT8 true: q8(q*scale), q8(k), q8(v) with their calibrated
//       scales, int32 QK^T times 1 / (inv_q inv_k), P quantized as
//       rint(p * 127), int32 PV times 1 / (inv_v 127);
//   - GELU through the degree-9 (or 15) erf polynomial, residual stream in
//     float32, output rounded to T.
//
// Bound on an H100: the four projections are 2 N C (4C + 2H) = 24 N C^2 int8
// operations per image and Block (H = 4C), ~1.36 GOP for SVTR's 12 Blocks,
// so at batch 256 ~0.18 ms at the 1,979 TOP/s int8 tensor-core peak; the
// bytes of one Block call (x, out, int8 weights, mask) take ~0.05 ms at
// 3.35 TB/s.  The Block is compute-bound.
//
// Design (simple first): five launches per Block.
//   1. gemm<kQkv>: per 64x64 output tile, the block computes its 64 rows' LN
//      statistics, then quantizes LN1(x) as it loads A; A and B tiles of 32
//      along K sit in shared memory packed four int8 to a 32-bit word, and
//      __dp4a accumulates in int32.  The epilogue writes q*scale, k, v in T,
//      or already quantized to int8 with ATTN_INT8;
//   2. attention: per (image, head, 32-query tile) with a [32, N] float32
//      score tile in shared memory (64 KB at N = 512);
//   3. gemm<kProj>: q8(attn) @ Wp, + x -> x1 (float32);
//   4. gemm<kFc1>: q8(LN2(x1)) @ W1, GELU, quantized with fc2's scale into
//      int8 g (the value fc2 would compute from the float GELU);
//   5. gemm<kFc2>: g @ W2, + x1 -> out in T.
// What it leaves on the table: the int8 tensor cores (mma.sync s8 or wgmma;
// the products here are SIMT __dp4a), TMA or cp.async pipelining, banding the
// Local mask, and keeping qkv, attn, x1 and g on chip across the Block.

#include <stdint.h>

#include "svtr_common.cuh"

namespace {

#define TRY(call)                              \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

enum Mode { kQkv = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };
constexpr int BM = 64, BN = 64, kGemmThreads = 256;   // output tile, threads a block
constexpr int IBK = 32;           // K of an int8 tile
constexpr int kWords = IBK / 4;   // packed 32-bit words per tile row

struct BlockArgs {
  const void* x;          // [M, C] in T
  const float* norm[4];   // LN1 scale, LN1 bias, LN2 scale, LN2 bias
  const int8_t* w[4];     // projection kernels [K, Nout], Mode order
  const float* bias[4];   // float32 biases
  const float* deq[4];    // float32 dequant rows s_act * w_scale[out]
  const float* inv;       // [8]: slots 0-3 the projections, 4-6 q, k, v
  const float* mask;      // [N, N] float32 or NULL
  void* qkv;              // [M, 3C]: T, or int8 with ATTN_INT8
  float* attn;            // [M, C]
  float* x1;              // [M, C]
  int8_t* g;              // [M, hidden]: q8(gelu(fc1)) with fc2's scale
  void* out;              // [M, C] in T
  int N, C, heads, hidden, gelu_degree;
  float scale;
};

__device__ __forceinline__ int q8(float v, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(v, inv))));
}

__device__ __forceinline__ uint32_t byte_at(int v, int e) {
  return (uint32_t)(uint8_t)(int8_t)v << (8 * e);
}

// ------------------------------------------------------------- projections
// out[M, Nout] = q8(A)[M, K] @ W[K, Nout] (int32), then the MODE epilogue.
// A: LN1(x) for kQkv, attn for kProj, LN2(x1) for kFc1, g (already int8)
// for kFc2.
template <typename T, int MODE, bool ATTN_INT8>
__global__ void __launch_bounds__(kGemmThreads) gemm_i8_kernel(BlockArgs a, int M, int K,
                                                               int Nout) {
  constexpr bool kLN = MODE == kQkv || MODE == kFc1;
  __shared__ float s_mean[BM], s_rstd[BM];
  __shared__ int As[BM][kWords + 1];
  __shared__ int Bs[BN][kWords + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto src = [&](int m, int k) -> float {  // A before quantization
    const size_t o = (size_t)m * K + k;
    if (MODE == kQkv) return to_f(static_cast<const T*>(a.x)[o]);
    return MODE == kProj ? a.attn[o] : a.x1[o];
  };
  if (kLN) {  // one warp per row of the block's BM rows
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float s = 0.f, ss = 0.f;
      if (m < M) {
        for (int k = lane; k < K; k += 32) {
          const float v = src(m, k);
          s = __fadd_rn(s, v);
          ss = __fadd_rn(ss, __fmul_rn(v, v));
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mean = __fdiv_rn(s, (float)K);
        const float var = __fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mean, mean));
        s_mean[r] = mean;
        s_rstd[r] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
      }
    }
    __syncthreads();
  }
  const float* ln_s = a.norm[MODE == kQkv ? 0 : 2];
  const float* ln_b = a.norm[MODE == kQkv ? 1 : 3];
  const float inv = a.inv[MODE];
  auto a8 = [&](int m, int k) -> int {
    if (MODE == kFc2) return a.g[(size_t)m * K + k];
    float v = src(m, k);
    if (kLN) {
      const int r = m - m0;
      v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, s_mean[r]), s_rstd[r]), ln_s[k]), ln_b[k]);
    }
    return q8(v, inv);
  };

  const int8_t* __restrict__ w = a.w[MODE];
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += IBK) {
    for (int idx = tid; idx < BM * kWords; idx += kGemmThreads) {
      const int r = idx / kWords, c4 = idx % kWords;
      const int m = m0 + r, k = k0 + 4 * c4;
      uint32_t word = 0;
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) word |= byte_at(a8(m, k + e), e);
      }
      As[r][c4] = (int)word;
    }
    for (int idx = tid; idx < BN * kWords; idx += kGemmThreads) {
      const int cc = idx % BN, c4 = idx / BN;
      const int n = n0 + cc, k = k0 + 4 * c4;
      uint32_t word = 0;
      if (n < Nout) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) word |= byte_at(w[(size_t)(k + e) * Nout + n], e);
      }
      Bs[cc][c4] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int c4 = 0; c4 < kWords; ++c4) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][c4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][c4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int C = a.C;
  const float* deq = a.deq[MODE];
  const float* bias = a.bias[MODE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Nout) continue;
      const size_t o = (size_t)m * Nout + n;
      const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), deq[n]), bias[n]);
      if constexpr (MODE == kQkv) {
        const float t = n < C ? __fmul_rn(v, a.scale) : v;
        if constexpr (ATTN_INT8)
          static_cast<int8_t*>(a.qkv)[o] = (int8_t)q8(t, a.inv[4 + n / C]);
        else
          static_cast<T*>(a.qkv)[o] = from_f<T>(t);
      } else if constexpr (MODE == kProj) {
        a.x1[o] = __fadd_rn(to_f(static_cast<const T*>(a.x)[o]), v);
      } else if constexpr (MODE == kFc1) {
        a.g[o] = (int8_t)q8(gelu_poly(v, a.gelu_degree), a.inv[3]);
      } else {
        static_cast<T*>(a.out)[o] = from_f<T>(__fadd_rn(a.x1[o], v));
      }
    }
  }
}

template <typename T, int MODE, bool ATTN_INT8>
cudaError_t launch_gemm(const BlockArgs& a, int M, int K, int Nout, cudaStream_t s) {
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<T, MODE, ATTN_INT8><<<grid, kGemmThreads, 0, s>>>(a, M, K, Nout);
  return cudaGetLastError();
}

// ---------------------------------------------------------- int8 attention
size_t attention_i8_smem_bytes(int d, int n) {
  const size_t k_words = (size_t)KC * (d / 4 + 1), v_words = (size_t)d * (KC / 4 + 1);
  const size_t kv_words = k_words > v_words ? k_words : v_words;
  return (size_t)QT * n * (sizeof(float) + 1) + sizeof(int) * ((size_t)QT * (d / 4) + kv_words);
}

// grid B * heads * ceil(N / QT), query tiles fastest.  qkv8 [B N, 3C] int8:
// q8(q*scale), q8(k), q8(v); out [B N, C] float32.  N % 4 == 0.
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
attention_i8_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ mask,
                    const float* __restrict__ inv, float* __restrict__ out, int heads, int N,
                    int C) {
  static_assert(kAttnThreads % D == 0 && QT * D % kAttnThreads == 0, "tile");
  constexpr int DW = D / 4;         // packed words of a q or k row
  constexpr int KW = KC / 4;        // packed words of a key chunk
  constexpr int kRowsPerPass = kAttnThreads / D;
  constexpr int kPasses = QT / kRowsPerPass;
  extern __shared__ float smem[];
  float* S = smem;                                          // [QT][N] scores, then p
  int8_t* P8 = reinterpret_cast<int8_t*>(S + QT * N);       // [QT][N] rint(p * 127)
  int* Qw = reinterpret_cast<int*>(P8 + QT * N);            // [QT][DW]
  int* KVw = Qw + QT * DW;                                  // [KC][DW + 1] or [D][KW + 1]

  const int tiles = (N + QT - 1) / QT, bh = blockIdx.x / tiles;
  const int b = bh / heads, h = bh % heads, q0 = (blockIdx.x % tiles) * QT;
  const int rows = min(QT, N - q0);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * N, ld = 3 * (size_t)C;
  const float s_qk = __fdiv_rn(1.0f, __fmul_rn(inv[4], inv[5]));
  const float s_pv = __fdiv_rn(1.0f, __fmul_rn(inv[6], 127.0f));

  for (int i = tid; i < QT * DW; i += kAttnThreads) {
    const int r = i / DW, wd = i % DW;
    Qw[i] = r < rows ? reinterpret_cast<const int*>(qkv + (row0 + q0 + r) * ld + h * D)[wd] : 0;
  }
  // scores: int32 q8 . k8 times s_qk, plus the mask
  for (int kc = 0; kc < N; kc += KC) {
    const int kn = min(KC, N - kc);
    __syncthreads();
    for (int i = tid; i < KC * DW; i += kAttnThreads) {
      const int j = i / DW, wd = i % DW;
      KVw[j * (DW + 1) + wd] =
          j < kn ? reinterpret_cast<const int*>(qkv + (row0 + kc + j) * ld + C + h * D)[wd] : 0;
    }
    __syncthreads();
    for (int i = tid; i < QT * KC; i += kAttnThreads) {
      const int r = i / KC, j = i % KC;
      if (r >= rows || j >= kn) continue;
      int acc = 0;
#pragma unroll
      for (int wd = 0; wd < DW; ++wd) acc = __dp4a(Qw[r * DW + wd], KVw[j * (DW + 1) + wd], acc);
      float s = __fmul_rn(__int2float_rn(acc), s_qk);
      if (mask) s = __fadd_rn(s, mask[(size_t)(q0 + r) * N + kc + j]);
      S[r * N + kc + j] = s;
    }
  }
  __syncthreads();

  // one warp per row: p = exp(s - max) / sum, then rint(p * 127)
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kAttnThreads / 32) {
      float* srow = S + r * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float p = expf(__fsub_rn(srow[j], m));
        srow[j] = p;
        sum = __fadd_rn(sum, p);
      }
      sum = warp_sum(sum);
      for (int j = lane; j < N; j += 32)
        P8[r * N + j] = (int8_t)__float2int_rn(__fmul_rn(__fdiv_rn(srow[j], sum), 127.0f));
    }
  }

  // PV: int32 p8 . v8 over the keys, 4 keys a word; v chunk transposed
  const int d = tid % D, r0 = tid / D;
  int acc[kPasses] = {};
  for (int kc = 0; kc < N; kc += KC) {
    const int kn = min(KC, N - kc);
    __syncthreads();
    for (int i = tid; i < D * KW; i += kAttnThreads) {
      const int dd = i / KW, wd = i % KW;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * wd + e;
        if (j < kn) word |= byte_at(qkv[(row0 + kc + j) * ld + 2 * C + h * D + dd], e);
      }
      KVw[dd * (KW + 1) + wd] = (int)word;
    }
    __syncthreads();
    const int words = kn / 4;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = r0 + p * kRowsPerPass;
      if (r >= rows) continue;
      const int* prow = reinterpret_cast<const int*>(P8 + r * N + kc);
      for (int wd = 0; wd < words; ++wd) acc[p] = __dp4a(prow[wd], KVw[d * (KW + 1) + wd], acc[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int r = r0 + p * kRowsPerPass;
    if (r >= rows) continue;
    out[(row0 + q0 + r) * C + h * D + d] = __fmul_rn(__int2float_rn(acc[p]), s_pv);
  }
}

template <int D>
cudaError_t launch_attention_i8(const int8_t* qkv, const float* mask, const float* inv,
                                float* out, int B, int heads, int N, int C, cudaStream_t s) {
  const size_t smem = attention_i8_smem_bytes(D, N);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_i8_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)B * heads * ((N + QT - 1) / QT);
  attention_i8_kernel<D><<<grid, kAttnThreads, smem, s>>>(qkv, mask, inv, out, heads, N, C);
  return cudaGetLastError();
}

cudaError_t attention_i8(int D, const int8_t* qkv, const float* mask, const float* inv,
                         float* out, int B, int heads, int N, int C, cudaStream_t s) {
  switch (D) {
    case 8: return launch_attention_i8<8>(qkv, mask, inv, out, B, heads, N, C, s);
    case 16: return launch_attention_i8<16>(qkv, mask, inv, out, B, heads, N, C, s);
    case 32: return launch_attention_i8<32>(qkv, mask, inv, out, B, heads, N, C, s);
    case 64: return launch_attention_i8<64>(qkv, mask, inv, out, B, heads, N, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------- Block
template <typename T, bool ATTN_INT8>
int block_forward(const BlockArgs& a, int B, cudaStream_t s) {
  const int M = B * a.N, C = a.C, D = C / a.heads;
  TRY((launch_gemm<T, kQkv, ATTN_INT8>(a, M, C, 3 * C, s)));
  if constexpr (ATTN_INT8) {
    TRY(attention_i8(D, static_cast<const int8_t*>(a.qkv), a.mask, a.inv, a.attn, B, a.heads,
                     a.N, C, s));
  } else {
    const T* q = static_cast<const T*>(a.qkv);
    TRY(attention<T>(q, 3 * C, q + C, q + 2 * C, 3 * C, a.attn, C, a.mask, B, a.heads, a.N, D,
                     s));
  }
  TRY((launch_gemm<T, kProj, false>(a, M, C, C, s)));
  TRY((launch_gemm<T, kFc1, false>(a, M, C, a.hidden, s)));
  TRY((launch_gemm<T, kFc2, false>(a, M, a.hidden, C, s)));
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; attn_int8: 0 or 1.  x, out [B, N, C] in the
// working type; LN scales/biases, projection biases and dequant rows
// float32; kernels int8 [in, out]; inv float32 [8] on the device; mask
// [N, N] float32 or NULL.  Scratch: qkv [B N, 3C] (working type, or int8
// with attn_int8), attn and x1 [B N, C] float32, g [B N, hidden] int8.
// Returns 0 or the CUDA error code of the first failed launch
// (cudaErrorInvalidValue for shapes the kernels do not take).
int svtr_block_int8_forward(int dtype, int attn_int8, const void* x, const float* n1s,
                            const float* n1b, const float* n2s, const float* n2b,
                            const int8_t* qkv_w, const float* qkv_b, const float* qkv_deq,
                            const int8_t* proj_w, const float* proj_b, const float* proj_deq,
                            const int8_t* fc1_w, const float* fc1_b, const float* fc1_deq,
                            const int8_t* fc2_w, const float* fc2_b, const float* fc2_deq,
                            const float* inv, const float* mask, void* qkv, float* attn,
                            float* x1, int8_t* g, void* out, int B, int N, int C, int heads,
                            int hidden, int gelu_degree, float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || C % heads != 0 || (attn_int8 && N % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const BlockArgs a{x,
                    {n1s, n1b, n2s, n2b},
                    {qkv_w, proj_w, fc1_w, fc2_w},
                    {qkv_b, proj_b, fc1_b, fc2_b},
                    {qkv_deq, proj_deq, fc1_deq, fc2_deq},
                    inv,
                    mask,
                    qkv,
                    attn,
                    x1,
                    g,
                    out,
                    N,
                    C,
                    heads,
                    hidden,
                    gelu_degree,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attn_int8 ? block_forward<float, true>(a, B, s) : block_forward<float, false>(a, B, s);
  if (dtype == 1)
    return attn_int8 ? block_forward<__nv_bfloat16, true>(a, B, s)
                     : block_forward<__nv_bfloat16, false>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* svtr_block_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
