// Projection main loops for Hopper (sm_90a), shared by svtr_block.cu (the
// inference Block, row 4 of the kernel table) and svtr_train_block.cu (the
// training Block forward, row 5, and the data gradients of its backward,
// rows 6 and 7, on transposed weights).  The backward's weight gradients run
// svtr_wgrad_tc.cuh.
//
// out[i, j] = sum over k of round_T(A(i, k)) * W[k, j], float32
// accumulation, for W [K, Nout] row-major in T, handed to the epilogue in
// pairs of neighbouring columns.  A comes through a loader functor, so each
// caller keeps its fusions (LayerNorm on the A loads; bias, residual,
// q-scale, GELU and droppath in the epilogue).  A loader provides
//   using Src;                            the element type of A in memory
//   const Src* row(int i);                row i of A (16-byte aligned)
//   void map8(int i, int k, float (&v)[8]);  the float32 operand of A[i,
//                                         k..k+8) from its loaded values
//   void prepare(int m0);                 set-up for the block's rows m0 ..
//                                         m0 + kTileM (barriers allowed)
//   static constexpr bool kMap;           whether map8 changes anything
//   static constexpr bool kWholeRows;     whether prepare is worth sharing:
//                                         one block then takes every column
//                                         tile of its rows
// and an epilogue takes 8 columns j .. j + 8 of row i at a time (j a
// multiple of 8): e.prefetch(i, j, r) loads what it reads besides the
// accumulator (a residual) into r, e(i, j, v, r) stores from the float32
// accumulator v.  The prefetches of kRound chunks (an epilogue's kRound, 4
// by default) are issued before their first store, so their latencies
// overlap.  An epilogue with kColumnSums also adds its float32 values into
// the thread's column sums (e(i, j, v, r, sums)), and e.columns(rb, j, s)
// then gets the sum over row block rb's rows of column j, in a fixed order.
// K and Nout are multiples of 8 (C is heads x D with D >= 8).
//
// Bound on an H100: a projection of K = 64..1024 moves its A and its output
// once (48..96 bytes a row element pair in bf16) against 2K operations per
// output, so at K <= 256 it is held by the bytes as much as by the tensor
// cores; in float32 the 67 TFLOP/s CUDA-core rate holds it.
//
// bfloat16 (gemm_tc_bf16): mma.sync m16n8k16, bf16 in, float32 accumulate.
// A block of 8 warps computes a 128 x BN tile (BN 64 or 128, picked per
// shape by tile_n: the output widths are 64..1024), each warp 32 x BN/2.
// k-tiles of 32 sit in a ring of 4 shared-memory slots (3 for a float32 A),
// filled by 16-byte cp.async copies of A in its source type and of W, three
// k-tiles ahead of the products: at K = 64..128 the whole reduction is in
// flight at once, which is what holds these short products (a first design
// that staged A through registers one k-tile ahead ran at 0.4-0.9 TB/s).
// The loader's map (LayerNorm) and the rounding to bf16 run on the landed
// tile in shared memory (in place for a bf16 A, into a bf16 tile for a
// float32 one); the LayerNorm statistics are computed while the first
// copies are in flight.  W is read with ldmatrix.trans, A with ldmatrix;
// rows are padded by 16 bytes, which keeps ldmatrix free of bank conflicts.
// mma.sync rather than wgmma and TMA: at K = 64..256 the products are held
// by the bytes as much as by the operations, and mma.sync fed from a deep
// cp.async ring is the step that moves them off the CUDA cores.
//
// float32 (gemm_f32): the CUDA cores, no TF32 (it would move the results
// away from the plain versions).  A block of 256 threads computes a 128 x BN
// tile (BN 128 where the width allows, else 64), 8 x BN/16 accumulators a
// thread, from the same kind of cp.async ring (3 slots of 32-deep k-tiles,
// the map applied in place): per 4 k a thread reads its 8 rows of A as
// float4s along k and its columns of W as float4s, 256 FMAs per 16 shared
// loads at BN 128 (128 per 12 at BN 64).
//
// No split-K and no atomics: every output is one thread's sum in a fixed
// order, so two launches on the same inputs are bitwise equal.

#pragma once

#include <type_traits>

#include "svtr_common.cuh"
#include "svtr_mma.cuh"

namespace {

constexpr int kTileM = 128, kTileThreads = 256;

// Eight consecutive values of S in registers: one 16-byte load for bf16,
// two for float
template <typename S>
struct Chunk8;

template <>
struct Chunk8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// v[0..8) from / to p[0..8) (p 16-byte aligned), rounded to the type of p
template <typename S>
__device__ __forceinline__ void load8(const S* p, float (&v)[8]) {
  Chunk8<S> c;
  c.load(p);
  c.get(v);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// ------------------------------------------------------------------ loaders
// A row-major [M, ld] matrix, the single-pass LayerNorm of each row applied
// in float32: (x - mean) * rstd with rstd = rsqrt(E[x^2] - mean^2 + 1e-6),
// then * scale[k] + shift[k] unless scale is NULL (the inference Block's
// bare LayerNorm on folded weights).  The statistics of the block's rows are
// computed by prepare (one warp per 16 rows) into shared memory.
template <typename S>
struct LayerNormRows {
  using Src = S;
  static constexpr bool kMap = true, kWholeRows = true;
  const S* p;
  int ld, M;
  const float* scale = nullptr;   // [ld] or NULL
  const float* shift = nullptr;
  const float* stats = nullptr;   // the block's rows: mean, rstd (shared memory)
  int m0 = 0;

  __device__ __forceinline__ const S* row(int i) const { return p + (size_t)i * ld; }

  __device__ __forceinline__ void map8(int i, int k, float (&v)[8]) const {
    const float mu = stats[2 * (i - m0)], rs = stats[2 * (i - m0) + 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rs;
    if (scale != nullptr) {
      float sc[8], sh[8];
      load8(scale + k, sc);
      load8(shift + k, sh);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = v[e] * sc[e] + sh[e];
    }
  }

  __device__ __forceinline__ void prepare(int first) {
    __shared__ float s_stats[2 * kTileM];
    // all 16 rows' loads in flight at once for bf16, 8 for float32
    constexpr int kRows = kTileM / (kTileThreads / 32), kGroup = sizeof(S) == 2 ? 16 : 8;
    m0 = first;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
    for (int g0 = 0; g0 < kRows; g0 += kGroup) {
      float s[kGroup], ss[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) s[r] = ss[r] = 0.f;
      for (int c = lane; c < ld / 8; c += 32) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const int m = m0 + warp * kRows + g0 + r;
          if (m < M) {
            Chunk8<S> ch;
            ch.load(row(m) + 8 * c);
            float v[8];
            ch.get(v);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s[r] += v[e];
              ss[r] += v[e] * v[e];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const float sum = warp_sum(s[r]), sq = warp_sum(ss[r]);
        if (lane == 0) {
          const float mean = sum / ld;
          const float var = sq / ld - mean * mean;
          const int rr = warp * kRows + g0 + r;
          s_stats[2 * rr] = mean;
          s_stats[2 * rr + 1] = rsqrtf(var + 1e-6f);
        }
      }
    }
    __syncthreads();
    stats = s_stats;
  }
};

// ---------------------------------------------------------------- epilogue
template <class E, class = void>
struct EpiRound {
  static constexpr int value = 4;
};
template <class E>
struct EpiRound<E, std::void_t<decltype(E::kRound)>> {
  static constexpr int value = E::kRound;
};
template <class E, class = void>
struct EpiSums : std::false_type {};
template <class E>
struct EpiSums<E, std::void_t<decltype(E::kColumnSums)>> : std::bool_constant<E::kColumnSums> {};

// The block's [128, BN] float32 tile, already in shared memory at cs (pitch
// BN + 4), handed to the epilogue in chunks of 8 columns: a warp covers
// whole rows, so loads and stores are 16-byte and coalesced.  A thread's
// chunks are all in the same 8 columns (256 threads are a multiple of BN /
// 8), so with kColumnSums its sums are those columns' over its rows; the
// threads' sums are then added in thread order in shared memory (which the
// tile held).
template <int BN, class E>
__device__ __forceinline__ void store_tile(float* cs, int m0, int n0, int M, int Nout,
                                           const E& e) {
  // kRound chunks a round: their prefetches in flight together (4: 32 registers)
  constexpr int kPer = kTileM * BN / 8 / kTileThreads;
  constexpr int kRound = EpiRound<E>::value < kPer ? EpiRound<E>::value : kPer;
  constexpr int kRowChunks = BN / 8;
  constexpr bool kSums = EpiSums<E>::value;
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kRound) {
    float r[kRound][8];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int c = threadIdx.x + (u0 + u) * kTileThreads;
      const int i = m0 + c / kRowChunks, j = n0 + 8 * (c % kRowChunks);
      if (i < M && j < Nout) e.prefetch(i, j, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int c = threadIdx.x + (u0 + u) * kTileThreads;
      const int rr = c / kRowChunks, cc = 8 * (c % kRowChunks);
      const int i = m0 + rr, j = n0 + cc;
      if (i >= M || j >= Nout) continue;
      const float4 a = lds4(cs + rr * (BN + 4) + cc), b = lds4(cs + rr * (BN + 4) + cc + 4);
      float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      if constexpr (kSums)
        e(i, j, v, r[u], sums);
      else
        e(i, j, v, r[u]);
    }
  }
  if constexpr (kSums) {
    __syncthreads();   // every thread is done reading the tile
    store8(cs + 8 * threadIdx.x, sums);
    __syncthreads();
    constexpr int kRowsOf = kTileThreads / kRowChunks;
    const int j = threadIdx.x;
    if (j < BN && n0 + j < Nout) {
      float s = 0.f;
      for (int q = 0; q < kRowsOf; ++q) s += cs[8 * (q * kRowChunks + j / 8) + j % 8];
      e.columns(m0 / kTileM, n0 + j, s);
    }
  }
}

template <int BN>
constexpr size_t tile_bytes() { return sizeof(float) * kTileM * (BN + 4); }

// ------------------------------------------------------------- bf16 path
template <int BN_, typename Src>
struct TcTile {
  static constexpr int BM = kTileM, BN = BN_, BK = 32;
  static constexpr bool kF32A = std::is_same<Src, float>::value;
  static constexpr int kStages = kF32A ? 3 : 4;
  static constexpr int WN = BN / 2, MT = 2, NT = WN / 8;    // warp: 32 x WN
  static constexpr int AP = BK + 8, BP = BN + 8;             // bf16 row pitches
  static constexpr int RP = kF32A ? BK + 4 : AP;             // A slot pitch (Src)
  static constexpr int kE = 16 / (int)sizeof(Src);           // A elements per copy
  static constexpr int kACopies = BM * BK / kE / kTileThreads;
  static constexpr int kBCopies = BK * BN / 8 / kTileThreads;
  static constexpr int kChunks = BM * BK / 8 / kTileThreads;  // 8-element maps
  static constexpr size_t kABytes = sizeof(Src) * BM * RP;
  static constexpr size_t kSlot = kABytes + sizeof(__nv_bfloat16) * BK * BP;
  // the ring, then (float32 A) the bf16 tile the products read; after the
  // loop the same bytes hold the output tile
  static constexpr size_t kRing = kStages * kSlot + (kF32A ? sizeof(__nv_bfloat16) * BM * AP : 0);
  static constexpr size_t kSmem = kRing > tile_bytes<BN>() ? kRing : tile_bytes<BN>();
};

// The output tile of columns n0 .. n0 + BN of the block's 128 rows; prepare
// runs on the block's first tile only.
template <int BN, class A, class E>
__device__ __forceinline__ void gemm_tc_bf16(A& a, const __nv_bfloat16* __restrict__ w, int M,
                                             int Nout, int K, const E& e, int n0, bool first) {
  using Src = typename A::Src;
  using G = TcTile<BN, Src>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int m0 = blockIdx.y * G::BM;
  const int tiles = (K + G::BK - 1) / G::BK;
  auto slot_a = [&](int s) { return reinterpret_cast<Src*>(gemm_smem + s * G::kSlot); };
  auto slot_b = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(gemm_smem + s * G::kSlot + G::kABytes);
  };

  // k-tile kt of A and W into ring slot s (rows and columns past M, K and
  // Nout zero-filled)
  auto load = [&](int kt, int s) {
    Src* as = slot_a(s);
#pragma unroll
    for (int i = 0; i < G::kACopies; ++i) {
      const int c = tid + i * kTileThreads, r = c / (G::BK / G::kE);
      const int kc = G::kE * (c % (G::BK / G::kE)), m = m0 + r, k = kt * G::BK + kc;
      const bool ok = m < M && k < K;
      cp_async16(as + r * G::RP + kc, ok ? a.row(m) + k : a.row(0), ok);
    }
    __nv_bfloat16* bs = slot_b(s);
#pragma unroll
    for (int i = 0; i < G::kBCopies; ++i) {
      const int c = tid + i * kTileThreads, kr = c / (BN / 8), nc = c % (BN / 8);
      const int k = kt * G::BK + kr, n = n0 + 8 * nc;
      const bool ok = k < K && n < Nout;
      cp_async16(bs + kr * G::BP + 8 * nc, ok ? w + (size_t)k * Nout + n : w, ok);
    }
  };

  // the loader's map and the rounding to bf16, on the landed A tile of slot
  // s: in place (bf16 A) or into the bf16 tile (float32 A); padding stays 0
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(gemm_smem + G::kStages * G::kSlot);
  auto map_tile = [&](int kt, int s) {
    const Src* as = slot_a(s);
    __nv_bfloat16* dst = G::kF32A ? conv : reinterpret_cast<__nv_bfloat16*>(slot_a(s));
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int c = tid + i * kTileThreads, r = c / (G::BK / 8), kc = 8 * (c % (G::BK / 8));
      const int m = m0 + r, k = kt * G::BK + kc;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) {
        float v[8];
        if constexpr (G::kF32A) {
          const float4 x0 = *reinterpret_cast<const float4*>(as + r * G::RP + kc);
          const float4 x1 = *reinterpret_cast<const float4*>(as + r * G::RP + kc + 4);
          v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
          v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
        } else {
          Chunk8<Src> ch;
          ch.u = *reinterpret_cast<const uint4*>(as + r * G::RP + kc);
          ch.get(v);
        }
        a.map8(m, k, v);
        packed = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
      *reinterpret_cast<uint4*>(dst + r * G::AP + kc) = packed;
    }
  };

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  if (first) a.prepare(m0);   // LayerNorm statistics while the first tiles are in flight

  float acc[G::MT][G::NT][4] = {};
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();   // k-tile kt landed; slot (kt - 1) % kStages is free
    const int next = kt + G::kStages - 1;
    if (next < tiles) load(next, next % G::kStages);
    cp_async_commit();
    const int s = kt % G::kStages;
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(slot_a(s));
    if constexpr (G::kF32A || A::kMap) {
      map_tile(kt, s);
      __syncthreads();
      if constexpr (G::kF32A) as = conv;
    }
    const __nv_bfloat16* bs = slot_b(s);
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
        ldsm_x4(af[mt], as + (wm * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * G::AP +
                            kk + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < G::NT / 2; ++np) {
        uint32_t b[4];   // k rows kk .. +16, columns +16 np .. +8 and +8 .. +16
        ldsm_x4_trans(b, bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * G::BP +
                             wn * G::WN + 16 * np + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the ring's last readers are done: it becomes the output tile

  float* cs = reinterpret_cast<float*>(gemm_smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h, c = wn * G::WN + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(cs + r * (BN + 4) + c) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();
  store_tile<BN>(cs, m0, n0, M, Nout, e);
}

// ---------------------------------------------------------- float32 path
// Two layouts of the shared memory.  Ring: kStages slots of an A and a W
// k-tile.  Panel (a whole-rows loader with K <= kPanelK): the block's whole
// A [128, K], loaded and mapped once for all its column tiles, then a ring
// of W k-tiles; the output tile follows the panel.
constexpr int kPanelK = 256;

template <int BN_>
struct F32Tile {
  static constexpr int BM = kTileM, BN = BN_, BK = 32, TN = BN / 16, kStages = 3;
  static constexpr int AP = BK + 4, BP = BN + 4;   // row-major A and W, float pitches
  static constexpr int kACopies = BM * BK / 4 / kTileThreads;
  static constexpr int kBCopies = BK * BN / 4 / kTileThreads;
  static constexpr int kChunks = BM * BK / 8 / kTileThreads;
  static constexpr size_t kABytes = sizeof(float) * BM * AP;
  static constexpr size_t kWBytes = sizeof(float) * BK * BP;
  static constexpr size_t kSlot = kABytes + kWBytes;
  static constexpr size_t kRing = kStages * kSlot;
  static constexpr size_t kSmem = kRing > tile_bytes<BN>() ? kRing : tile_bytes<BN>();
  static constexpr size_t kWRing = kStages * kWBytes;
  static constexpr size_t kAfterPanel = kWRing > tile_bytes<BN>() ? kWRing : tile_bytes<BN>();
  // panel row pitch (floats) and bytes for a reduction of K
  static __host__ __device__ int panel_pitch(int K) { return (K + BK - 1) / BK * BK + 4; }
  static __host__ __device__ size_t panel_bytes(int K) {
    return sizeof(float) * BM * panel_pitch(K);
  }
};

template <int BN, class A, class E>
__device__ __forceinline__ void gemm_f32(A& a, const float* __restrict__ w, int M, int Nout,
                                         int K, const E& e, int n0, bool first) {
  using G = F32Tile<BN>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * G::BM;
  const int tiles = (K + G::BK - 1) / G::BK;
  const bool panel = A::kWholeRows && K <= kPanelK;
  const int pp = G::panel_pitch(K);
  unsigned char* ring = gemm_smem + (panel ? G::panel_bytes(K) : 0);
  float* pan = reinterpret_cast<float*>(gemm_smem);
  auto slot_a = [&](int s) { return reinterpret_cast<float*>(ring + s * G::kSlot); };
  auto slot_b = [&](int s) {
    return reinterpret_cast<float*>(ring + (panel ? s * G::kWBytes : s * G::kSlot + G::kABytes));
  };

  // A k-tile kt into dst (row pitch ld); W k-tile kt into ring slot s (past
  // M, K, Nout: zero-filled)
  auto load_a = [&](int kt, float* dst, int ld) {
#pragma unroll
    for (int i = 0; i < G::kACopies; ++i) {
      const int c = tid + i * kTileThreads, r = c / (G::BK / 4), kc = 4 * (c % (G::BK / 4));
      const int m = m0 + r, k = kt * G::BK + kc;
      const bool ok = m < M && k < K;
      cp_async16(dst + r * ld + kc, ok ? a.row(m) + k : a.row(0), ok);
    }
  };
  auto load_w = [&](int kt, int s) {
    float* bs = slot_b(s);
#pragma unroll
    for (int i = 0; i < G::kBCopies; ++i) {
      const int c = tid + i * kTileThreads, kr = c / (BN / 4), nc = c % (BN / 4);
      const int k = kt * G::BK + kr, n = n0 + 4 * nc;
      const bool ok = k < K && n < Nout;
      cp_async16(bs + kr * G::BP + 4 * nc, ok ? w + (size_t)k * Nout + n : w, ok);
    }
  };
  auto load = [&](int kt, int s) {
    if (!panel) load_a(kt, slot_a(s), G::AP);
    load_w(kt, s);
  };
  // the loader's map on a landed A k-tile (row pitch ld), in place; padding
  // stays 0
  auto map_tile = [&](int kt, float* as, int ld) {
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int c = tid + i * kTileThreads, r = c / (G::BK / 8), kc = 8 * (c % (G::BK / 8));
      const int m = m0 + r, k = kt * G::BK + kc;
      if (m >= M || k >= K) continue;
      float* p = as + r * ld + kc;
      const float4 x0 = lds4(p), x1 = lds4(p + 4);
      float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      a.map8(m, k, v);
      store8(p, v);
    }
  };

  if (panel && first) {   // the whole A panel, one group ahead of W's
    for (int kt = 0; kt < tiles; ++kt) load_a(kt, pan + kt * G::BK, pp);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  if (first) a.prepare(m0);
  if (panel && first) {
    cp_async_wait<G::kStages - 1>();
    __syncthreads();
    if constexpr (A::kMap)
      for (int kt = 0; kt < tiles; ++kt) map_tile(kt, pan + kt * G::BK, pp);
  }

  // thread (tx, ty): rows ty + 16 i (neighbouring ty on other banks),
  // columns 4 tx .. +4 (and 64 + 4 tx .. +4)
  float acc[8][G::TN] = {};
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();   // k-tile kt landed; slot (kt - 1) % kStages is free
    const int next = kt + G::kStages - 1;
    if (next < tiles) load(next, next % G::kStages);
    cp_async_commit();
    const int s = kt % G::kStages;
    if constexpr (A::kMap) {
      if (!panel) {
        map_tile(kt, slot_a(s), G::AP);
        __syncthreads();
      }
    }
    const int ld = panel ? pp : G::AP;
    const float* as = (panel ? pan + kt * G::BK : slot_a(s)) + ty * ld;
    const float* bs = slot_b(s) + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 4) {
      float4 af[8];   // rows ty + 16 i, k kk .. kk + 4
#pragma unroll
      for (int i = 0; i < 8; ++i) af[i] = lds4(as + 16 * i * ld + kk);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        float bv[G::TN];
#pragma unroll
        for (int q = 0; q < G::TN / 4; ++q) {
          const float4 b = lds4(bs + (kk + k4) * G::BP + 64 * q);
          bv[4 * q] = b.x; bv[4 * q + 1] = b.y; bv[4 * q + 2] = b.z; bv[4 * q + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = k4 == 0 ? af[i].x : k4 == 1 ? af[i].y : k4 == 2 ? af[i].z : af[i].w;
#pragma unroll
          for (int j = 0; j < G::TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the ring's last readers are done: it becomes the output tile

  float* cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < G::TN / 4; ++q)
      *reinterpret_cast<float4*>(cs + (ty + 16 * i) * (BN + 4) + 64 * q + 4 * tx) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  __syncthreads();
  store_tile<BN>(cs, m0, n0, M, Nout, e);
}

// ------------------------------------------------------------------ kernel
// Output columns per block: 128 where the width is a multiple of 128, else
// 64 (the 64 and 192 wide outputs of SVTR's stage 1); in float32 128 only
// for K >= 256, where the products outweigh the latency that its one block
// per SM leaves exposed.
inline int tile_n(int dtype, int Nout, int K) {
  return Nout % 128 == 0 && (dtype == 1 || K >= 256) ? 128 : 64;
}

// Blocks per SM the register budget is cut for: two, except the float32
// 128-wide tile, whose 64 accumulators a thread spill under a 128-register
// cap (it runs one block of 8 warps per SM with up to 255 registers)
template <typename T, int BN>
constexpr int min_blocks() { return std::is_same<T, float>::value && BN == 128 ? 1 : 2; }

// Block (x, y): rows 128 y .. +128, column tiles x, x + gridDim.x, ...
template <typename T, int BN, class A, class E>
__global__ void __launch_bounds__(kTileThreads, min_blocks<T, BN>())
proj_kernel(A a, const T* __restrict__ w, E e, int M, int Nout, int K) {
  for (int n0 = blockIdx.x * BN; n0 < Nout; n0 += gridDim.x * BN) {
    const bool first = n0 == (int)blockIdx.x * BN;
    if (!first) __syncthreads();   // the previous tile's epilogue is done with shared memory
    if constexpr (std::is_same<T, float>::value)
      gemm_f32<BN>(a, w, M, Nout, K, e, n0, first);
    else
      gemm_tc_bf16<BN>(a, w, M, Nout, K, e, n0, first);
  }
}

template <typename T, int BN, class A, class E>
cudaError_t launch_proj(A a, const T* w, E e, int M, int Nout, int K, cudaStream_t stream) {
  const dim3 grid(A::kWholeRows ? 1 : (Nout + BN - 1) / BN, (M + kTileM - 1) / kTileM);
  int smem = (int)TcTile<BN, typename A::Src>::kSmem;
  if constexpr (std::is_same<T, float>::value) {
    using G = F32Tile<BN>;
    smem = (int)(A::kWholeRows && K <= kPanelK ? G::panel_bytes(K) + G::kAfterPanel : G::kSmem);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      proj_kernel<T, BN, A, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  proj_kernel<T, BN, A, E><<<grid, kTileThreads, smem, stream>>>(a, w, e, M, Nout, K);
  return cudaGetLastError();
}

// One projection: grid of (Nout / BN, M / 128) tiles, column tiles fastest
// (the tiles of one row block share its A rows in L2), or of (1, M / 128)
// blocks that each take all column tiles of their rows (kWholeRows: the
// LayerNorm statistics computed once per row block).
template <typename T, class A, class E>
cudaError_t proj(A a, const T* w, E e, int M, int Nout, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || Nout <= 0 || K % 8 || Nout % 8) return cudaErrorInvalidValue;
  if (tile_n(std::is_same<T, float>::value ? 0 : 1, Nout, K) == 128)
    return launch_proj<T, 128>(a, w, e, M, Nout, K, stream);
  return launch_proj<T, 64>(a, w, e, M, Nout, K, stream);
}

}  // namespace
