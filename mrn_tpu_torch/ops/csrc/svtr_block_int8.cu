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
//   - max-subtract softmax normalised before PV, float32 output:
//       ATTN_INT8 false: q*scale, k and v rounded to T, float32 scores, p
//       rounded to T before PV (the tile attention's kMaxSubEarly form);
//       ATTN_INT8 true: q8(q*scale), q8(k), q8(v) with their calibrated
//       scales, int32 QK^T times 1 / (inv_q inv_k), P quantized as
//       rint(p * 127), int32 PV times 1 / (inv_v 127);
//   - GELU through the degree-9 (or 15) erf polynomial or, under the serving
//     switch set_gelu_approximate(True), the tanh form (tanhf), before the
//     q8 of fc2's input; residual stream in float32, output rounded to T.
// Local Blocks on column-major tokens attend banded: query block a of qb
// rows sees the keys [starts[a], starts[a] + width) with the [N, width] band
// mask (the row-4 plan).  That is exact, though the Pallas kernel attends
// over the full mask: the keys outside the window carry -inf, so their p is
// exactly 0, and so is rint(p * 127).
//
// Bound on an H100: the four projections are 2 N C (4C + 2H) = 24 N C^2 int8
// operations per image and Block (H = 4C), ~1.36 GOP for SVTR's 12 Blocks,
// so at batch 256 ~0.18 ms at the 1,979 TOP/s int8 tensor-core peak; the
// attention adds 4 D per visible (query, key) pair at the bf16 (or int8)
// rate, and the bytes of one Block call (x, out, int8 weights, mask) take
// ~0.01 ms at 3.35 TB/s.  The Block is bound by its operations, but each of
// its five launches moves its intermediate ([M, 3C] qkv, [M, C] float32 attn
// and x1, [M, 4C] int8 g) through HBM, ~10x the bytes of the bound.
//
// Design: five launches per Block.
//   1. proj<qkv>: q8(LN1(x)) @ Wqkv -> q*scale, k, v in T, or already
//      quantized to int8 with ATTN_INT8;
//   2. attention: ATTN_INT8 false, the tile attention of
//      svtr_attention_tc.cuh (bf16 QK^T and PV on mma.sync m16n8k16, f32
//      register-tiled on the CUDA cores), strided rows of qkv, float32
//      output; ATTN_INT8 true, attention_i8_kernel below (QK^T and PV on the
//      int8 tensor cores);
//   3. proj<proj>: q8(attn) @ Wp + x -> x1 (float32);
//   4. proj<fc1>: q8(LN2(x1)) @ W1, GELU, quantized with fc2's scale into
//      int8 g (the value fc2 would compute from the float GELU);
//   5. proj<fc2>: g @ W2 + x1 -> out in T.
// The projections (proj_i8_kernel) run on the int8 tensor cores, mma.sync
// m16n8k32 (s8 x s8 -> s32, exact), in both working types: a block of 8
// warps computes a 128 x BN tile (BN 128 where the width allows, else 64),
// each warp 32 x BN/2, from k-tiles of 64 bytes.  For qkv, proj and fc1 (K =
// C <= 256) one block takes every column tile of its 128 rows: it maps its
// rows once (LayerNorm statistics from rows held in registers, C / 8 lanes
// a row, several rows a warp; the affine; q8) into an int8 A panel in
// shared memory, and streams only W through a 4-slot 16-byte cp.async
// ring.  fc2's A is already int8 (K = 4C <= 1024): A and W stream through
// the ring together, one block per output tile.  W comes as a K-contiguous
// [Nout, K] copy (prepare_int8, once per set of weights), so both operands
// load with 16-byte copies and ldmatrix (rows padded by 16 bytes: no bank
// conflicts).  The int32 tile (exact in float32: |acc| < 127^2 K < 2^24)
// leaves through shared memory in 16-byte rows (svtr_gemm_tc.cuh's
// store_tile) into the dequant epilogues.
// attention_i8_kernel follows the tile attention's plan: one block of 4
// warps per (image, head, span of up to 128 query rows of one band block);
// q8 and k8 rows staged by cp.async, zero-padded to the mma depth of 32
// (exact), scores of a 16-row tile in registers in the accumulator layout,
// one pass over a window of up to 256 keys, three passes (max; sum; PV)
// over 256-key segments for a wider one.  P goes to PV as rint(p * 127)
// packed straight from the score registers; a lane holds keys 2t, 2t+1, 8 +
// 2t, 9 + 2t of each 16, so the keys of PV's A fragment come in that order,
// and V is staged transposed (keys contiguous: sm_90 has no byte
// ldmatrix.trans) with its keys permuted the same way.  Integer sums are
// exact in any order.
// No atomics and no split-K: two launches on the same inputs are bitwise
// equal.  What it leaves on the table: wgmma and TMA, and keeping qkv, attn,
// x1 and g on chip across the Block.

#include <stdint.h>

#include "svtr_attention_tc.cuh"
#include "svtr_gemm_tc.cuh"

namespace {

#define TRY(call)                              \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

constexpr int kBK = 64;            // bytes of K per k-tile: two m16n8k32 steps
constexpr int kStages = 4;         // ring slots
constexpr int kMaxMapK = 256;      // K of a mapped A panel: one 8-wide chunk a lane

__device__ __forceinline__ int q8(float v, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(v, inv))));
}

// ---------------------------------------------------------------- A loaders
// The mapped operands of qkv, proj and fc1: rows of S ([M, ld], K <= 256
// columns), optionally LayerNorm'd with its affine, quantized with
// inv[slot] into the block's int8 panel (pitch bytes a row; columns K ..
// round_up(K, kBK) and rows past M zero).  A row is held in the registers
// of lpr lanes, 8 columns a lane (lpr: round_up(K, kBK) / 8 to a power of
// two, so 32 / lpr rows a warp at once), its sums reduced across them by
// shuffles; a warp's 16 rows are loaded 4 lpr-row sets at a time.
template <typename S, bool LN>
struct MapRows {
  static constexpr bool kPanel = true;
  const S* p;
  int ld;
  const float* scale;   // LN affine [K] (LN only)
  const float* shift;
  const float* inv;
  int slot;

  __device__ __forceinline__ void fill(int8_t* pan, int pitch, int m0, int M, int K) const {
    constexpr int kRows = kTileM / (kTileThreads / 32), kGroup = 4;
    const int kpad = round_up(K, kBK);
    const int lpr = kpad <= 64 ? 8 : kpad <= 128 ? 16 : 32, rpw = 32 / lpr;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int k = 8 * (lane % lpr), sub = lane / lpr;
    const bool in_k = k < K, in_pad = k < kpad;
    const float mul = __ldg(inv + slot);
    float sc[8] = {}, sh[8] = {};
    if (LN && in_k) {
      load8(scale + k, sc);
      load8(shift + k, sh);
    }
#pragma unroll 1
    for (int g0 = 0; g0 < kRows; g0 += kGroup * rpw) {   // kGroup * rpw <= kRows
      float v[kGroup][8];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int m = m0 + warp * kRows + g0 + r * rpw + sub;
        if (in_k && m < M) {
          load8(p + (size_t)m * ld + k, v[r]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[r][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int row = warp * kRows + g0 + r * rpw + sub;
        if constexpr (LN) {
          float s = 0.f, ss = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s = __fadd_rn(s, v[r][e]);
            ss = __fadd_rn(ss, __fmul_rn(v[r][e], v[r][e]));
          }
          for (int o = lpr >> 1; o > 0; o >>= 1) {
            s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
            ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
          }
          const float mean = __fdiv_rn(s, (float)K);
          const float var = __fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mean, mean));
          const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[r][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[r][e], mean), rstd), sc[e]),
                                sh[e]);
        }
        if (in_pad) {
          const bool ok = in_k && m0 + row < M;
          int qv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[e] = ok ? q8(v[r][e], mul) : 0;
          *reinterpret_cast<uint2*>(pan + row * pitch + k) =
              make_uint2(pack_s8(qv[0], qv[1], qv[2], qv[3]), pack_s8(qv[4], qv[5], qv[6], qv[7]));
        }
      }
    }
  }
};

// fc2's operand: int8 rows [M, ld], streamed through the ring
struct Int8Rows {
  static constexpr bool kPanel = false;
  const int8_t* p;
  int ld;
  __device__ __forceinline__ const int8_t* row(int m) const { return p + (size_t)m * ld; }
};

// ---------------------------------------------------------------- epilogues
// Each takes columns j .. j + 8 of row i of the int32 accumulator, as exact
// float32 values v (store_tile of svtr_gemm_tc.cuh); prefetch loads the
// residual, if any, into r.
struct Dequant {   // v = v * deq[j] + bias[j], two roundings
  const float* deq;
  const float* bias;
  __device__ __forceinline__ void operator()(int j, float (&v)[8]) const {
    float d[8], b[8];
    load8(deq + j, d);
    load8(bias + j, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(__fmul_rn(v[e], d[e]), b[e]);
  }
};

__device__ __forceinline__ void store_q8(int8_t* p, const float (&v)[8], float inv) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      pack_s8(q8(v[0], inv), q8(v[1], inv), q8(v[2], inv), q8(v[3], inv)),
      pack_s8(q8(v[4], inv), q8(v[5], inv), q8(v[6], inv), q8(v[7], inv)));
}

template <typename T, bool ATTN_INT8>
struct QkvOut {  // q * scale, k, v: in T, or q8 with inv[4 + part]
  Dequant dq;
  void* qkv;
  const float* inv;
  int C;
  float scale;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    dq(j, v);
    if (j < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], scale);
    }
    const size_t o = (size_t)i * 3 * C + j;
    if constexpr (ATTN_INT8)
      store_q8(static_cast<int8_t*>(qkv) + o, v, __ldg(inv + 4 + j / C));
    else
      store8(static_cast<T*>(qkv) + o, v);
  }
};

template <typename T>
struct ProjOut {  // x1 = x + v, float32
  Dequant dq;
  const T* x;
  float* x1;
  int C;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(x + (size_t)i * C + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    dq(j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(r[e], v[e]);
    store8(x1 + (size_t)i * C + j, v);
  }
};

struct Fc1Out {  // g = q8(gelu(v)) with fc2's scale inv[3]
  Dequant dq;
  int8_t* g;
  const float* inv;
  int hidden, form;
  __device__ void prefetch(int, int, float (&)[8]) const {}
  __device__ void operator()(int i, int j, float (&v)[8], const float (&)[8]) const {
    dq(j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu_form(v[e], form);
    store_q8(g + (size_t)i * hidden + j, v, __ldg(inv + 3));
  }
};

template <typename T>
struct Fc2Out {  // out = x1 + v in T
  Dequant dq;
  const float* x1;
  T* out;
  int C;
  __device__ void prefetch(int i, int j, float (&r)[8]) const { load8(x1 + (size_t)i * C + j, r); }
  __device__ void operator()(int i, int j, float (&v)[8], const float (&r)[8]) const {
    dq(j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(r[e], v[e]);
    store8(out + (size_t)i * C + j, v);
  }
};

// ------------------------------------------------------------- projections
// Shared memory: the A panel (PANEL: 128 rows of round_up(K, 64) + 16
// bytes), then the ring (kStages slots of a W k-tile [BN][64 + 16], and of
// A's [128][64 + 16] when it streams), which after the main loop holds the
// float32 output tile.
template <int BN, bool PANEL>
struct I8Tile {
  static constexpr int WN = BN / 2, MT = 2, NT = WN / 8;   // warp: 32 x WN
  static constexpr int RP = kBK + 16;                       // ring row pitch (bytes)
  static constexpr size_t kABytes = PANEL ? 0 : (size_t)kTileM * RP;
  static constexpr size_t kSlot = kABytes + (size_t)BN * RP;
  static constexpr size_t kRing = kStages * kSlot;
  static constexpr size_t kAfterPanel = kRing > tile_bytes<BN>() ? kRing : tile_bytes<BN>();
  static __host__ __device__ int panel_pitch(int K) { return PANEL ? round_up(K, kBK) + 16 : 0; }
  static __host__ __device__ size_t smem(int K) {
    return (size_t)kTileM * panel_pitch(K) + kAfterPanel;
  }
};

// The output tile of columns n0 .. n0 + BN of the block's 128 rows: out =
// A8 @ W for wt = W^T [Nout, K]; the panel is filled on the block's first
// tile only.
template <int BN, class A, class E>
__device__ __forceinline__ void gemm_i8(const A& a, const int8_t* __restrict__ wt, int M,
                                        int Nout, int K, const E& e, int n0, bool first) {
  constexpr bool kPanel = A::kPanel;
  using G = I8Tile<BN, kPanel>;
  extern __shared__ __align__(16) unsigned char i8_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int m0 = blockIdx.y * kTileM;
  const int tiles = (K + kBK - 1) / kBK;
  const int pp = G::panel_pitch(K);
  int8_t* pan = reinterpret_cast<int8_t*>(i8_smem);
  unsigned char* ring = i8_smem + (size_t)kTileM * pp;
  auto slot_a = [&](int s) { return reinterpret_cast<int8_t*>(ring + s * G::kSlot); };
  auto slot_b = [&](int s) {
    return reinterpret_cast<int8_t*>(ring + s * G::kSlot + G::kABytes);
  };

  // k-tile kt of W (and of a streamed A) into ring slot s; rows past M and
  // Nout and columns past K zero-filled (K % 16 == 0)
  auto load = [&](int kt, int s) {
    if constexpr (!kPanel) {
      int8_t* as = slot_a(s);
#pragma unroll
      for (int i = 0; i < kTileM * kBK / 16 / kTileThreads; ++i) {
        const int c = tid + i * kTileThreads, r = c / (kBK / 16), kc = 16 * (c % (kBK / 16));
        const int m = m0 + r, k = kt * kBK + kc;
        const bool ok = m < M && k < K;
        cp_async16(as + r * G::RP + kc, ok ? a.row(m) + k : a.row(0), ok);
      }
    }
    int8_t* bs = slot_b(s);
#pragma unroll
    for (int i = 0; i < BN * kBK / 16 / kTileThreads; ++i) {
      const int c = tid + i * kTileThreads, r = c / (kBK / 16), kc = 16 * (c % (kBK / 16));
      const int n = n0 + r, k = kt * kBK + kc;
      const bool ok = n < Nout && k < K;
      cp_async16(bs + r * G::RP + kc, ok ? wt + (size_t)n * K + k : wt, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  if constexpr (kPanel) {
    if (first) a.fill(pan, pp, m0, M, K);   // while the first W tiles are in flight
  }

  int acc[G::MT][G::NT][4] = {};
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // k-tile kt landed, the panel filled; slot (kt - 1) % kStages free
    const int next = kt + kStages - 1;
    if (next < tiles) load(next, next % kStages);
    cp_async_commit();
    const int s = kt % kStages;
    const int8_t* as = kPanel ? pan + kt * kBK : slot_a(s);
    const int ap = kPanel ? pp : G::RP;
    const int8_t* bs = slot_b(s);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
        ldsm_x4(af[mt], as + (wm * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ap + kk +
                            16 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < G::NT / 2; ++np) {
        uint32_t b[4];   // columns 16 np .. +8 and +8 .. +16, k kk .. +16 and +16 .. +32
        ldsm_x4(b, bs + (wn * G::WN + 16 * np + (lane & 7) + 8 * (lane >> 4)) * G::RP + kk +
                       16 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_s8(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the ring's last readers are done: it becomes the output tile

  float* cs = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h, c = wn * G::WN + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(cs + r * (BN + 4) + c) =
            make_float2(__int2float_rn(acc[mt][nt][2 * h]), __int2float_rn(acc[mt][nt][2 * h + 1]));
      }
  __syncthreads();
  store_tile<BN>(cs, m0, n0, M, Nout, e);
}

// Block (x, y): rows 128 y .. +128, column tiles x, x + gridDim.x, ... (a
// panel block takes them all)
template <int BN, class A, class E>
__global__ void __launch_bounds__(kTileThreads, 2)
proj_i8_kernel(A a, const int8_t* __restrict__ wt, E e, int M, int Nout, int K) {
  for (int n0 = blockIdx.x * BN; n0 < Nout; n0 += gridDim.x * BN) {
    const bool first = n0 == (int)blockIdx.x * BN;
    if (!first) __syncthreads();   // the previous tile's epilogue is done with shared memory
    gemm_i8<BN>(a, wt, M, Nout, K, e, n0, first);
  }
}

// Output columns per block: 128 where the width is a multiple of 128, else 64
inline int tile_n_i8(int Nout) { return Nout % 128 == 0 ? 128 : 64; }

template <int BN, class A, class E>
cudaError_t launch_proj_i8(const A& a, const int8_t* wt, const E& e, int M, int Nout, int K,
                           cudaStream_t stream) {
  const dim3 grid(A::kPanel ? 1 : (Nout + BN - 1) / BN, (M + kTileM - 1) / kTileM);
  const int smem = (int)I8Tile<BN, A::kPanel>::smem(K);
  const cudaError_t err = cudaFuncSetAttribute(
      proj_i8_kernel<BN, A, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  proj_i8_kernel<BN, A, E><<<grid, kTileThreads, smem, stream>>>(a, wt, e, M, Nout, K);
  return cudaGetLastError();
}

template <class A, class E>
cudaError_t proj_i8(const A& a, const int8_t* wt, const E& e, int M, int Nout, int K,
                    cudaStream_t stream) {
  if (tile_n_i8(Nout) == 128) return launch_proj_i8<128>(a, wt, e, M, Nout, K, stream);
  return launch_proj_i8<64>(a, wt, e, M, Nout, K, stream);
}

// ---------------------------------------------------------- int8 attention
template <int D>
struct I8Layout {
  static constexpr int DP = D < 32 ? 32 : D;   // head dim padded to the mma depth
  static constexpr int P = DP + 16;            // q8 and k8 row pitch (bytes)
  static constexpr int DV = D < 16 ? 16 : D;   // rows of V^T (two n-tiles a ldmatrix)
  static constexpr int CH = D < 16 ? 8 : 16;   // bytes a staging copy
};

// The plan (svtr_attention_tc.cuh's Plan): span as the tile attention's, a
// window of up to 8 * key_tiles keys in one pass, else 3 passes over
// segments of that many
Plan make_plan_i8(int D, int qb, int width) {
  Plan p;
  p.span = qb < kMaxSpan ? qb : kMaxSpan;
  p.key_tiles = width <= 128 ? 16 : 32;
  const int keys = 8 * p.key_tiles;
  p.segments = (width + keys - 1) / keys;
  p.passes = p.segments == 1 ? 1 : 3;
  const int dp = D < 32 ? 32 : D, dv = D < 16 ? 16 : D;
  p.smem = (round_up(p.span, 16) + keys) * (dp + 16) + dv * (keys + 16);
  return p;
}

struct I8AttnArgs {
  const int8_t* qkv;    // [B N, 3C]: q8(q * scale), q8(k), q8(v)
  float* out;           // [B N, C]
  const float* mask;    // [N, width] or NULL
  const int* starts;    // [N / qb] or NULL
  const float* inv;     // slots 4-6: q, k, v
  int heads, N, C, qb, width, span;
};

// rows [0, valid) of D bytes (row stride ld) into pitch-P shared rows [0,
// alloc), zero-padded to DP columns and alloc rows
template <int D>
__device__ __forceinline__ void stage_i8(int8_t* dst, const int8_t* src, size_t ld, int valid,
                                         int alloc) {
  using L = I8Layout<D>;
  constexpr int kChunks = L::DP / L::CH;
  for (int i = threadIdx.x; i < alloc * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid && c * L::CH < D;
    const int8_t* s = ok ? src + r * ld + c * L::CH : src;
    if constexpr (L::CH == 16)
      cp_async16(dst + r * L::P + c * 16, s, ok);
    else
      cp_async8(dst + r * L::P + c * 8, s, ok);
  }
}

// position of key k (of a window) in PV's k order: within each 16 keys, a
// lane's keys 2t, 2t+1, 8+2t, 9+2t come as positions 4t .. 4t+3
__device__ __forceinline__ int pv_position(int k) {
  const int kk = k & 15;
  return (k & ~15) + 4 * ((kk & 7) >> 1) + (kk & 1) + 2 * (kk >> 3);
}

// V rows [0, valid) of KEYS into Vt[d][pv_position(key)] (pitch KEYS + 16);
// keys past valid are zero
template <int D, int KEYS>
__device__ __forceinline__ void stage_vt(int8_t* vt, const int8_t* src, size_t ld, int valid) {
  constexpr int VP = KEYS + 16, kChunks = D / 8;
  for (int i = threadIdx.x; i < KEYS * kChunks; i += kTcThreads) {
    const int key = i / kChunks, d0 = 8 * (i % kChunks);
    uint2 w = make_uint2(0u, 0u);
    if (key < valid) w = __ldg(reinterpret_cast<const uint2*>(src + key * ld + d0));
    const int pos = pv_position(key);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vt[(d0 + e) * VP + pos] = (int8_t)(((e < 4 ? w.x : w.y) >> (8 * (e & 3))) & 0xff);
  }
}

// s = (q8 . k8) * s_qk for rows r0 .. r0+16 and keys 0 .. 8 NT of the staged
// tiles, float32, in the accumulator layout
template <int D, int NT>
__device__ __forceinline__ void scores_i8(float (&s)[NT][4], const int8_t* Qs, const int8_t* Ks,
                                          int r0, float s_qk) {
  using L = I8Layout<D>;
  constexpr int KS = L::DP / 32;
  const int lane = threadIdx.x % 32;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qa[ks], Qs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::P + 32 * ks +
                        16 * (lane >> 4));
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    int acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];   // keys 16 jp .. +8 and +8 .. +16
      ldsm_x4(b, Ks + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * L::P + 32 * ks +
                     16 * ((lane >> 3) & 1));
      mma_s8(acc[0], qa[ks], b[0], b[1]);
      mma_s8(acc[1], qa[ks], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[2 * jp][e] = __fmul_rn(__int2float_rn(acc[0][e]), s_qk);
      s[2 * jp + 1][e] = __fmul_rn(__int2float_rn(acc[1][e]), s_qk);
    }
  }
}

__device__ __forceinline__ int p8(float p) { return __float2int_rn(__fmul_rn(p, 127.0f)); }

// o += rint(p * 127) V over keys 0 .. 8 NT (o[dn]: head dims 8dn .. 8dn+8)
template <int D, int NT>
__device__ __forceinline__ void pv_i8(int (&o)[I8Layout<D>::DV / 8][4], const float (&p)[NT][4],
                                      const int8_t* Vt) {
  constexpr int VP = 8 * NT + 16;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < NT / 4; ++c) {   // 32 keys a step
    const uint32_t a[4] = {
        pack_s8(p8(p[4 * c][0]), p8(p[4 * c][1]), p8(p[4 * c + 1][0]), p8(p[4 * c + 1][1])),
        pack_s8(p8(p[4 * c][2]), p8(p[4 * c][3]), p8(p[4 * c + 1][2]), p8(p[4 * c + 1][3])),
        pack_s8(p8(p[4 * c + 2][0]), p8(p[4 * c + 2][1]), p8(p[4 * c + 3][0]),
                p8(p[4 * c + 3][1])),
        pack_s8(p8(p[4 * c + 2][2]), p8(p[4 * c + 2][3]), p8(p[4 * c + 3][2]),
                p8(p[4 * c + 3][3]))};
#pragma unroll
    for (int dp = 0; dp < I8Layout<D>::DV / 16; ++dp) {
      uint32_t b[4];   // head dims 16 dp .. +8 and +8 .. +16
      ldsm_x4(b, Vt + (16 * dp + (lane & 7) + 8 * (lane >> 4)) * VP + 32 * c +
                     16 * ((lane >> 3) & 1));
      mma_s8(o[2 * dp], a, b[0], b[1]);
      mma_s8(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// out rows r0 + g, r0 + g + 8 (of the span's valid rows), head dims 8dn +
// 2t: o * s_pv
template <int D>
__device__ __forceinline__ void store_i8(float* op, int ld, const int (&o)[I8Layout<D>::DV / 8][4],
                                         float s_pv, int r0, int rows) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row < rows)
        *reinterpret_cast<float2*>(op + (size_t)row * ld + 8 * dn + 2 * t) =
            make_float2(__fmul_rn(__int2float_rn(o[dn][2 * h]), s_pv),
                        __fmul_rn(__int2float_rn(o[dn][2 * h + 1]), s_pv));
    }
}

// grid batch * heads * ceil(N / span), spans fastest
template <int D, int NT>
__global__ void __launch_bounds__(kTcThreads) attention_i8_kernel(const I8AttnArgs a) {
  using L = I8Layout<D>;
  constexpr int kKeys = 8 * NT, VP = kKeys + 16;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_i8);   // [span][P]
  int8_t* Ks = Qs + round_up(a.span, 16) * L::P;      // [kKeys][P]
  int8_t* Vt = Ks + kKeys * L::P;                     // [DV][VP]

  const int spans = (a.N + a.span - 1) / a.span;
  const int bh = blockIdx.x / spans, q0 = (blockIdx.x % spans) * a.span;
  const int b = bh / a.heads, h = bh % a.heads;
  const int rows = min(a.span, a.N - q0);
  const int kbase = a.starts != nullptr ? a.starts[q0 / a.qb] : 0;
  const size_t ld = 3 * (size_t)a.C, row0 = (size_t)b * a.N;
  const int8_t* kp = a.qkv + (row0 + kbase) * ld + a.C + h * D;
  const int8_t* vp = kp + a.C;
  const float* mrow = a.mask != nullptr ? a.mask + (size_t)q0 * a.width : nullptr;
  float* op = a.out + (row0 + q0) * a.C + h * D;
  const float s_qk = __fdiv_rn(1.0f, __fmul_rn(__ldg(a.inv + 4), __ldg(a.inv + 5)));
  const float s_pv = __fdiv_rn(1.0f, __fmul_rn(__ldg(a.inv + 6), 127.0f));
  const int warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < (L::DV - D) * VP; i += kTcThreads) Vt[D * VP + i] = 0;
  stage_i8<D>(Qs, a.qkv + (row0 + q0) * ld + h * D, ld, rows, round_up(rows, 16));
  const int segments = (a.width + kKeys - 1) / kKeys;
  if (segments == 1) {   // the whole window at once, the scores in registers
    stage_i8<D>(Ks, kp, ld, a.width, kKeys);
    cp_async_commit();
    stage_vt<D, kKeys>(Vt, vp, ld, a.width);
    cp_async_wait_all();
    __syncthreads();
    for (int round = 0; round < kRounds; ++round) {
      const int r0 = 16 * (warp + kTcWarps * round);
      if (r0 >= rows) continue;
      float s[NT][4], r[2] = {1.f, 1.f};
      scores_i8<D, NT>(s, Qs, Ks, r0, s_qk);
      mask_scores<NT>(s, r0, rows, a.width, 0, mrow, a.width);
      softmax_tile<float, kMaxSubEarly, NT>(s, r);
      int o[L::DV / 8][4] = {};
      pv_i8<D, NT>(o, s, Vt);
      store_i8<D>(op, a.C, o, s_pv, r0, rows);
    }
    return;
  }
  // a wider window: per round, the row max, the row sum and PV in three
  // passes over kKeys-key segments, recomputing the scores
  for (int round = 0; round < kRounds && 16 * kTcWarps * round < rows; ++round) {
    const int r0 = 16 * (warp + kTcWarps * round);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int o[L::DV / 8][4] = {};
    for (int pass = 0; pass < 3; ++pass) {
      for (int sg = 0; sg < segments; ++sg) {
        const int k0 = sg * kKeys, kn = min(kKeys, a.width - k0);
        __syncthreads();   // the previous segment's readers are done
        stage_i8<D>(Ks, kp + (size_t)k0 * ld, ld, kn, kKeys);
        cp_async_commit();
        if (pass == 2) stage_vt<D, kKeys>(Vt, vp + (size_t)k0 * ld, ld, kn);
        cp_async_wait_all();
        __syncthreads();
        if (r0 >= rows) continue;
        float s[NT][4];
        scores_i8<D, NT>(s, Qs, Ks, r0, s_qk);
        mask_scores<NT>(s, r0, rows, kn, k0, mrow, a.width);
        if (pass == 0) {
          lane_max<NT>(s, m);
        } else if (pass == 1) {
          exp_sum<NT>(s, m, l);
        } else {
          float unused[2] = {0.f, 0.f};
          exp_sum<NT>(s, m, unused);
          normalise<NT>(s, l);
          pv_i8<D, NT>(o, s, Vt);
        }
      }
      if (pass == 0) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      } else if (pass == 1) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
    }
    if (r0 < rows) store_i8<D>(op, a.C, o, s_pv, r0, rows);
  }
}

template <int D>
cudaError_t launch_attention_i8(const I8AttnArgs& a, int batch, const Plan& plan,
                                cudaStream_t s) {
  auto kernel = plan.key_tiles == 16 ? &attention_i8_kernel<D, 16> : &attention_i8_kernel<D, 32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)batch * a.heads * ((a.N + a.span - 1) / a.span);
  kernel<<<grid, kTcThreads, plan.smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t attention_i8(const int8_t* qkv, float* out, const float* mask, const int* starts,
                         const float* inv, int batch, int heads, int N, int C, int qb,
                         int width, cudaStream_t s) {
  const int D = C / heads;
  const Plan plan = make_plan_i8(D, qb, width);
  const I8AttnArgs a{qkv, out, mask, starts, inv, heads, N, C, qb, width, plan.span};
  switch (D) {
    case 8: return launch_attention_i8<8>(a, batch, plan, s);
    case 16: return launch_attention_i8<16>(a, batch, plan, s);
    case 32: return launch_attention_i8<32>(a, batch, plan, s);
    case 64: return launch_attention_i8<64>(a, batch, plan, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------- Block
struct BlockArgs {
  const void* x;          // [M, C] in T
  const float* norm[4];   // LN1 scale, LN1 bias, LN2 scale, LN2 bias
  const int8_t* wt[4];    // projection kernels transposed, [Nout, K], Mode order
  const float* bias[4];   // float32 biases
  const float* deq[4];    // float32 dequant rows s_act * w_scale[out]
  const float* inv;       // [8]: slots 0-3 the projections, 4-6 q, k, v
  const float* mask;      // [N, width] float32 or NULL
  const int* starts;      // [N / qb] int32 or NULL
  void* qkv;              // [M, 3C]: T, or int8 with ATTN_INT8
  float* attn;            // [M, C]
  float* x1;              // [M, C]
  int8_t* g;              // [M, hidden]: q8(gelu(fc1)) with fc2's scale
  void* out;              // [M, C] in T
  int N, C, heads, hidden, qb, width, gelu;  // gelu: 9, 15 or kGeluTanh
  float scale;
};

template <typename T, bool ATTN_INT8>
int block_forward(const BlockArgs& a, int B, cudaStream_t s) {
  const int M = B * a.N, C = a.C;
  const T* x = static_cast<const T*>(a.x);
  TRY(proj_i8(MapRows<T, true>{x, C, a.norm[0], a.norm[1], a.inv, 0}, a.wt[0],
              QkvOut<T, ATTN_INT8>{{a.deq[0], a.bias[0]}, a.qkv, a.inv, C, a.scale}, M, 3 * C,
              C, s));
  if constexpr (ATTN_INT8) {
    TRY(attention_i8(static_cast<const int8_t*>(a.qkv), a.attn, a.mask, a.starts, a.inv, B,
                     a.heads, a.N, C, a.qb, a.width, s));
  } else {
    const T* q = static_cast<const T*>(a.qkv);
    TRY((attention_tc<T, kMaxSubEarly, false, float>(q, 3 * C, q + C, q + 2 * C, 3 * C, a.attn,
                                                     C, a.mask, a.starts, B, a.heads, a.N,
                                                     C / a.heads, a.qb, a.width, s)));
  }
  TRY(proj_i8(MapRows<float, false>{a.attn, C, nullptr, nullptr, a.inv, 1}, a.wt[1],
              ProjOut<T>{{a.deq[1], a.bias[1]}, x, a.x1, C}, M, C, C, s));
  TRY(proj_i8(MapRows<float, true>{a.x1, C, a.norm[2], a.norm[3], a.inv, 2}, a.wt[2],
              Fc1Out{{a.deq[2], a.bias[2]}, a.g, a.inv, a.hidden, a.gelu}, M, a.hidden,
              C, s));
  TRY(proj_i8(Int8Rows{a.g, a.hidden}, a.wt[3],
              Fc2Out<T>{{a.deq[3], a.bias[3]}, a.x1, static_cast<T*>(a.out), C}, M, C,
              a.hidden, s));
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; attn_int8: 0 or 1.  x, out [B, N, C] in the
// working type; LN scales/biases, projection biases and dequant rows
// float32; kernels int8 transposed, [out, in] (k contiguous); inv float32
// [8] on the device.  Full attention: starts NULL, qb == width == N, mask
// [N, N] float32 or NULL; banded: starts int32 [N / qb] on the device (qb a
// multiple of 32), mask [N, width].  Scratch: qkv [B N, 3C] (working type,
// or int8 with attn_int8), attn and x1 [B N, C] float32, g [B N, hidden]
// int8.  C a multiple of 16 up to 256, head dim 8, 16, 32 or 64, hidden a
// multiple of 16; every pointer 16-byte aligned.  gelu: 9 or 15, the erf
// polynomial of that degree, or 0 (kGeluTanh), the tanh form.  Returns 0 or the CUDA
// error code of the first failed launch (cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for arguments the kernels do not take).
int svtr_block_int8_forward(int dtype, int attn_int8, const void* x, const float* n1s,
                            const float* n1b, const float* n2s, const float* n2b,
                            const int8_t* qkv_wt, const float* qkv_b, const float* qkv_deq,
                            const int8_t* proj_wt, const float* proj_b, const float* proj_deq,
                            const int8_t* fc1_wt, const float* fc1_b, const float* fc1_deq,
                            const int8_t* fc2_wt, const float* fc2_b, const float* fc2_deq,
                            const float* inv, const float* mask, const int* starts, void* qkv,
                            float* attn, float* x1, int8_t* g, void* out, int B, int N, int C,
                            int heads, int hidden, int qb, int width, int gelu,
                            float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || C % heads != 0 || C % 16 != 0 || C > kMaxMapK ||
      hidden <= 0 || hidden % 16 != 0 || !gelu_form_ok(gelu))
    return (int)cudaErrorInvalidValue;
  const int D = C / heads;
  if (D != 8 && D != 16 && D != 32 && D != 64) return (int)cudaErrorInvalidValue;
  if (starts == nullptr && (qb != N || width != N)) return (int)cudaErrorInvalidValue;
  if (starts != nullptr && (qb % QT != 0 || N % qb != 0 || width > N))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x,      n1s,    n1b,     n2s,    n2b,   qkv_wt,  qkv_b,  qkv_deq,
                        proj_wt, proj_b, proj_deq, fc1_wt, fc1_b, fc1_deq, fc2_wt, fc2_b,
                        fc2_deq, inv,    mask,    qkv,    attn,  x1,      g,      out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const BlockArgs a{x,
                    {n1s, n1b, n2s, n2b},
                    {qkv_wt, proj_wt, fc1_wt, fc2_wt},
                    {qkv_b, proj_b, fc1_b, fc2_b},
                    {qkv_deq, proj_deq, fc1_deq, fc2_deq},
                    inv,
                    mask,
                    starts,
                    qkv,
                    attn,
                    x1,
                    g,
                    out,
                    N,
                    C,
                    heads,
                    hidden,
                    qb,
                    width,
                    gelu,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attn_int8 ? block_forward<float, true>(a, B, s) : block_forward<float, false>(a, B, s);
  if (dtype == 1)
    return attn_int8 ? block_forward<__nv_bfloat16, true>(a, B, s)
                     : block_forward<__nv_bfloat16, false>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of svtr_block_int8_forward: out[0..4] the attention's
// (query rows per block, key tiles held in registers, key segments, passes
// over the keys, dynamic shared-memory bytes), out[5..8] the output columns
// per 128-row block of the qkv, proj, fc1 and fc2 projections.
int svtr_block_int8_plan(int dtype, int attn_int8, int N, int C, int heads, int hidden, int qb,
                         int width, int* out) {
  const int D = C / heads;
  export_plan(attn_int8 ? make_plan_i8(D, qb, width)
                        : make_plan(kMaxSubEarly, dtype, N, D, qb, width),
              out);
  const int widths[4] = {3 * C, C, hidden, C};
  for (int i = 0; i < 4; ++i) out[5 + i] = tile_n_i8(widths[i]);
  return 0;
}

const char* svtr_block_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
