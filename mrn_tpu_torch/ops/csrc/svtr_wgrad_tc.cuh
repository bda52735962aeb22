// Weight-gradient main loops for Hopper (sm_90a): the products of the fused
// training Block's backward (svtr_train_block.cu, rows 6 and 7 of the
// kernel table) that sum over all B*N rows,
//
//   dW[k1, k2] = sum over m of round_T(A(m, k1)) * round_T(B(m, k2)),
//
// float32 accumulation, A [M, K1] and B [M, K2] row-major (m-major) in the
// working type T behind loaders (Src, row(m), kMap, and for the map Row,
// row_state(m), map8(state, k, v); Mat of svtr_common.cuh, the others in
// svtr_train_block.cu), and, where asked, the column sums of the unrounded
// float32 B(m, k2) (a bias gradient) folded in.  K1 and K2 are multiples of
// 8.
//
// Bound on an H100: each call reads A and B once (M x (K1 + K2) elements)
// against 2 M K1 K2 operations, so in bf16 it is held by the bytes; in
// float32 the 67 TFLOP/s CUDA-core rate holds it.
//
// Parallelism comes from the rows: the outputs have few tiles (dWp at C =
// 64 is one 64 x 64 tile), so blockIdx.z splits M into a fixed number of
// contiguous chunks, chosen from the shapes alone (split_rows).  Each block
// writes its float32 partial tile, and its partial column sums where it
// holds the first k1 tile; reduce_parts then sums the partials in chunk
// order.  No float atomics anywhere: two launches on the same inputs are
// bitwise equal.
//
// Staging: both operands m-major in a ring of 6 k-tiles, filled by 16-byte
// cp.async copies.  Each side's map (GELU, LayerNorm, droppath scale) runs
// in place on the landed tile, before the rounding to T, as the forward
// treats its A (svtr_gemm_tc.cuh); the maps of k-tile kt + 1 run after the
// products of kt, one barrier a k-tile apart, with what they read per row
// (LayerNorm statistics, droppath scales) fetched before those products.
//
// bfloat16: mma.sync m16n8k16 on 32-row k-tiles, a block of 8 warps per TM
// x TN output tile (64 or 128 along each side); the A fragment (k1 x m)
// comes from the m-major tile by ldmatrix.trans, the B fragment (m x k2) as
// the forward's W fragment.  float32: outer products on the CUDA cores on
// 16-row k-tiles, no TF32.

#pragma once

#include <algorithm>
#include <type_traits>

#include "svtr_gemm_tc.cuh"

namespace {

constexpr int kChunkRows = 32;   // row chunks are a multiple of the k-tiles

// Output tile along one side: 128 where the width is a multiple of 128
inline int wg_tile(int K) { return K % 128 == 0 ? 128 : 64; }

// A reduction over M rows in count contiguous chunks of chunk rows (a
// multiple of 32): at most two blocks per SM of the card's 132, so that all
// run in one wave (a 17th chunk of 16 tiles left 8 blocks to a second wave
// and cost up to 2x), chunks of at least 256 rows.  Fixed by the shapes
// alone.
struct Split {
  int count, chunk;
};

inline Split split_rows(int M, int tiles) {
  int s = 2 * 132 / tiles;
  s = std::max(1, std::min(s, M / 256));
  int chunk = (M + s - 1) / s;
  chunk = (chunk + kChunkRows - 1) / kChunkRows * kChunkRows;
  return {(M + chunk - 1) / chunk, chunk};
}

inline Split wg_split(int M, int K1, int K2) {
  const int tm = wg_tile(K1), tn = wg_tile(K2);
  return split_rows(M, ((K1 + tm - 1) / tm) * ((K2 + tn - 1) / tn));
}

// Floats of partial sums a weight gradient needs: its tiles and column sums
inline long long wgrad_floats(int M, int K1, int K2) {
  return (long long)wg_split(M, K1, K2).count * ((long long)K1 * K2 + K2);
}

// ------------------------------------------------------------- staging
// The ring of one output tile: both operands in T, BK rows (m) a k-tile,
// rows padded by 16 bytes (ldmatrix and float4 reads free of bank
// conflicts).  bf16 takes 32-row k-tiles (two mma k-steps), float32 16-row
// ones, so that six slots leave room for two blocks an SM.
template <typename T, int TM_, int TN_>
struct WgTile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int TM = TM_, TN = TN_, BK = kF32 ? 16 : 32, kStages = 6;
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int AP = TM + kPad, BP = TN + kPad;   // row pitches (elements)
  static constexpr size_t kABytes = sizeof(T) * BK * AP;
  static constexpr size_t kSlot = kABytes + sizeof(T) * BK * BP;
  static constexpr size_t kRing = kStages * kSlot;
  static constexpr size_t kSums = sizeof(float) * kTileThreads * 8;
  static constexpr size_t kSmem = kRing > kSums ? kRing : kSums;
};

// k-tile rows m0 .. m0 + BK of a loader's columns k0 .. k0 + TW into dst
// (row pitch in elements); rows >= m_end and columns >= K zero-filled
template <int BK, int TW, class L>
__device__ __forceinline__ void wg_load(const L& l, typename L::Src* dst, int pitch, int m0,
                                        int m_end, int k0, int K) {
  constexpr int kE = 16 / (int)sizeof(typename L::Src), kPerRow = TW / kE;
  constexpr int kCopies = BK * kPerRow / kTileThreads;
  static_assert(kCopies * kTileThreads == BK * kPerRow, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = threadIdx.x + i * kTileThreads, r = c / kPerRow, kc = kE * (c % kPerRow);
    const int m = m0 + r, k = k0 + kc;
    const bool ok = m < m_end && k < K;
    cp_async16(dst + r * pitch + kc, ok ? l.row(m) + k : l.row(0), ok);
  }
}

// One side's row states for the thread's chunks of a k-tile (chunk c =
// tid + 256 i: row c / (TW / 8)), fetched a k-tile ahead of its map
template <int BK, int TW, class L>
struct WgRows {
  static constexpr int kPerRow = TW / 8, kAll = BK * kPerRow;
  static constexpr int kChunks = (kAll + kTileThreads - 1) / kTileThreads;
  typename L::Row r[kChunks];

  __device__ __forceinline__ void fetch(const L& l, int m0, int m_end) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * kTileThreads, m = m0 + c / kPerRow;
      if (kAll % kTileThreads && c >= kAll) break;
      if (m < m_end) r[i] = l.row_state(m);
    }
  }
};

// The loader's map on a landed k-tile, in place, the result rounded to the
// tile's type; rows >= m_end and columns >= K become 0.  With sums, the
// mapped float32 values, before the rounding, are added into cs: a thread's
// 8 columns are the same in every k-tile (256 threads are a multiple of TW
// / 8 chunks a row).
template <int BK, int TW, class L>
__device__ __forceinline__ void wg_map(const L& l, const WgRows<BK, TW, L>& rows,
                                       typename L::Src* tile, int pitch, int m0, int m_end,
                                       int k0, int K, bool sums, float (&cs)[8]) {
  using Src = typename L::Src;
  using R = WgRows<BK, TW, L>;
#pragma unroll
  for (int i = 0; i < R::kChunks; ++i) {
    const int c = threadIdx.x + i * kTileThreads, r = c / R::kPerRow, kc = 8 * (c % R::kPerRow);
    if (R::kAll % kTileThreads && c >= R::kAll) break;
    const int m = m0 + r, k = k0 + kc;
    Src* p = tile + r * pitch + kc;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < m_end && k < K) {
      if constexpr (std::is_same<Src, float>::value) {
        const float4 x0 = lds4(p), x1 = lds4(p + 4);
        v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
        v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
      } else {
        Chunk8<Src> ch;
        ch.u = *reinterpret_cast<const uint4*>(p);
        ch.get(v);
      }
      l.map8(rows.r[i], k, v);
      if (sums) {
#pragma unroll
        for (int e = 0; e < 8; ++e) cs[e] += v[e];
      }
    }
    store8(p, v);
  }
}

// ---------------------------------------------------------- products
// bf16: the block's 8 warps in WMW x WNW, each a WM x WN part of the TM x TN
// tile (MT x NT mma tiles); A (k1 x m) by ldmatrix.trans from the m-major
// tile, B (m x k2) as the forward's W fragment.
template <int TM, int TN>
struct WgWarps {
  static constexpr int WMW = TM == 128 ? 4 : 2, WNW = 8 / WMW;
  static constexpr int WM = TM / WMW, WN = TN / WNW, MT = WM / 16, NT = WN / 8;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
};

template <int TM, int TN>
struct WgAccTc {
  using W = WgWarps<TM, TN>;
  float acc[W::MT][W::NT][4] = {};

  __device__ __forceinline__ void products(const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                           int ap, int bp) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp % W::WMW, wn = warp / W::WMW;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      uint32_t af[W::MT][4];   // k1 rows +16 mt .. +16, m kk .. kk + 16
#pragma unroll
      for (int mt = 0; mt < W::MT; ++mt)
        ldsm_x4_trans(af[mt], as + (kk + (lane & 7) + 8 * (lane >> 4)) * ap + wm * W::WM +
                                  mt * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int np = 0; np < W::NT / 2; ++np) {
        uint32_t b[4];   // m kk .. kk + 16, k2 columns +16 np .. +8 and +8 .. +16
        ldsm_x4_trans(b, bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * bp + wn * W::WN +
                             16 * np + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < W::MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int k1_0, int k2_0, int K1, int K2) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp % W::WMW, wn = warp / W::WMW, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < W::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = k1_0 + wm * W::WM + mt * 16 + g + 8 * h;
          const int c = k2_0 + wn * W::WN + nt * 8 + 2 * t;
          if (r < K1 && c < K2)
            *reinterpret_cast<float2*>(out + (size_t)r * K2 + c) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
  }
};

// float32: thread (tx, ty) holds k1 = 4 tx + 64 p + e and k2 = 4 ty + 64 q +
// f, and per row m reads float4s of both tiles along k1 and k2 (at 128 x
// 128: 64 FMAs per 4 shared loads).
template <int TM, int TN>
struct WgAccF32 {
  static constexpr int PA = TM / 64, PB = TN / 64;
  float acc[4 * PA][4 * PB] = {};

  __device__ __forceinline__ void products(const float* as, const float* bs, int ap, int bp) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    as += 4 * tx;
    bs += 4 * ty;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float a[4 * PA], b[4 * PB];
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const float4 v = lds4(as + r * ap + 64 * p);
        a[4 * p] = v.x; a[4 * p + 1] = v.y; a[4 * p + 2] = v.z; a[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const float4 v = lds4(bs + r * bp + 64 * q);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * PA; ++i)
#pragma unroll
        for (int j = 0; j < 4 * PB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* out, int k1_0, int k2_0, int K1, int K2) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4 * PA; ++i) {
      const int r = k1_0 + 64 * (i / 4) + 4 * tx + i % 4;
      if (r >= K1) continue;
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const int c = k2_0 + 64 * q + 4 * ty;
        if (c < K2)
          *reinterpret_cast<float4*>(out + (size_t)r * K2 + c) = make_float4(
              acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
      }
    }
  }
};

// ------------------------------------------------------------ main loop
// Rows m_beg .. m_end of one output tile.  Software-pipelined: the maps of
// k-tile kt + 1 run while the products of kt do (they touch other slots),
// so one barrier a k-tile separates them, and kStages - 2 k-tiles are in
// flight.
template <typename T, int TM, int TN, class LA, class LB>
__device__ __forceinline__ void wgrad_tile(const LA& la, const LB& lb, float* __restrict__ out,
                                           int m_beg, int m_end, int k1_0, int k2_0, int K1,
                                           int K2, bool sums, float (&cs)[8]) {
  static_assert(std::is_same<typename LA::Src, T>::value &&
                    std::is_same<typename LB::Src, T>::value,
                "weight-gradient operands are in the working type");
  using G = WgTile<T, TM, TN>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int tiles = (m_end - m_beg + G::BK - 1) / G::BK;
  auto slot_a = [&](int kt) {
    return reinterpret_cast<T*>(wg_smem + (kt % G::kStages) * G::kSlot);
  };
  auto slot_b = [&](int kt) {
    return reinterpret_cast<T*>(wg_smem + (kt % G::kStages) * G::kSlot + G::kABytes);
  };
  auto load = [&](int kt) {
    if (kt < tiles) {
      const int m0 = m_beg + kt * G::BK;
      wg_load<G::BK, TM>(la, slot_a(kt), G::AP, m0, m_end, k1_0, K1);
      wg_load<G::BK, TN>(lb, slot_b(kt), G::BP, m0, m_end, k2_0, K2);
    }
    cp_async_commit();
  };
  WgRows<G::BK, TM, LA> rows_a;
  WgRows<G::BK, TN, LB> rows_b;
  auto fetch = [&](int kt) {
    const int m0 = m_beg + kt * G::BK;
    if constexpr (LA::kMap) rows_a.fetch(la, m0, m_end);
    if constexpr (LB::kMap) rows_b.fetch(lb, m0, m_end);
  };
  auto map = [&](int kt) {
    const int m0 = m_beg + kt * G::BK;
    if constexpr (LA::kMap)
      wg_map(la, rows_a, slot_a(kt), G::AP, m0, m_end, k1_0, K1, false, cs);
    if (LB::kMap || sums) wg_map(lb, rows_b, slot_b(kt), G::BP, m0, m_end, k2_0, K2, sums, cs);
  };

  fetch(0);
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) load(s);
  cp_async_wait<G::kStages - 2>();
  __syncthreads();   // k-tile 0 landed
  map(0);
  typename std::conditional<G::kF32, WgAccF32<TM, TN>, WgAccTc<TM, TN>>::type acc;
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<G::kStages - 3>();
    __syncthreads();   // k-tile kt mapped, kt + 1 landed, slot of kt - 1 free
    load(kt + G::kStages - 1);
    if (kt + 1 < tiles) fetch(kt + 1);   // in flight under the products
    acc.products(slot_a(kt), slot_b(kt), G::AP, G::BP);
    if (kt + 1 < tiles) map(kt + 1);
  }
  cp_async_wait_all();
  acc.store(out, k1_0, k2_0, K1, K2);
}

// ------------------------------------------------------------- kernels
// Block (x, y, z): output tile k1 x TM .. +TM, k2 y TN .. +TN over rows
// chunk z; partial tile to part[z][K1][K2], and with kBias the partial
// column sums of B (blocks x == 0) to bias_part[z][K2].
template <typename T, int TM, int TN, bool kBias, class LA, class LB>
__global__ void __launch_bounds__(kTileThreads, 2)
wgrad_kernel(LA la, LB lb, float* __restrict__ part, float* __restrict__ bias_part, int M,
             int K1, int K2, int chunk) {
  const int z = blockIdx.z, m_beg = z * chunk, m_end = min(M, m_beg + chunk);
  const int k1_0 = blockIdx.x * TM, k2_0 = blockIdx.y * TN;
  const bool sums = kBias && blockIdx.x == 0;
  float* out = part + (size_t)z * K1 * K2;
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  wgrad_tile<T, TM, TN>(la, lb, out, m_beg, m_end, k1_0, k2_0, K1, K2, sums, cs);
  if (!sums) return;
  // the column sums of threads with the same columns, in thread order
  extern __shared__ __align__(16) unsigned char wg_smem[];
  float* buf = reinterpret_cast<float*>(wg_smem);
  __syncthreads();   // the ring's last readers are done
  store8(buf + 8 * threadIdx.x, cs);
  __syncthreads();
  constexpr int kGroups = TN / 8, kRowsOf = kTileThreads / kGroups;
  const int j = threadIdx.x;
  if (j < TN && k2_0 + j < K2) {
    float s = 0.f;
    for (int q = 0; q < kRowsOf; ++q) s += buf[8 * (q * kGroups + j / 8) + j % 8];
    bias_part[(size_t)z * K2 + k2_0 + j] = s;
  }
}

// out1[e] = sum over z = 0 .. S-1 of part1[z][e] (e < E1), likewise out2
// from part2 (E2, may be 0); E1 and E2 are multiples of 4.  A block of W
// warps takes 32 V consecutive elements, V a lane (4 where that leaves a
// wave of blocks, else 1): warp w sums chunks w, w + W, ... in order, then
// the W warp sums are added in warp order.  V and W come from the shapes
// alone, so the order is fixed.
constexpr int kReduceWarps = 32;

template <int V>
__global__ void __launch_bounds__(32 * kReduceWarps)
reduce_parts_kernel(const float* __restrict__ part1, float* __restrict__ out1, int E1,
                    const float* __restrict__ part2, float* __restrict__ out2, int E2, int S) {
  __shared__ float ws[kReduceWarps][32 * V];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, W = blockDim.x / 32;
  const int e = V * (blockIdx.x * 32 + lane);
  const bool first = e < E1;
  const float* part = first ? part1 : part2;
  const int E = first ? E1 : E2, ee = first ? e : e - E1;
  float s[V] = {};
  if (ee < E) {
#pragma unroll 4
    for (int z = warp; z < S; z += W) {
      float v[V];
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(part + (size_t)z * E + ee));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        v[0] = __ldg(part + (size_t)z * E + ee);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] += v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) ws[warp][V * lane + i] = s[i];
  __syncthreads();
  if (warp == 0 && ee < E) {
    float* out = (first ? out1 : out2) + ee;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = ws[0][V * lane + i];
      for (int w = 1; w < W; ++w) t += ws[w][V * lane + i];
      out[i] = t;
    }
  }
}

cudaError_t reduce_parts(const float* part1, float* out1, int E1, const float* part2,
                         float* out2, int E2, int S, cudaStream_t stream) {
  if (E1 % 4 || E2 % 4) return cudaErrorInvalidValue;
  const int warps = std::max(1, std::min(kReduceWarps, S / 4));
  if ((E1 + E2) / 128 >= 132)
    reduce_parts_kernel<4><<<(E1 + E2 + 127) / 128, 32 * warps, 0, stream>>>(
        part1, out1, E1, part2, out2, E2, S);
  else
    reduce_parts_kernel<1><<<(E1 + E2 + 31) / 32, 32 * warps, 0, stream>>>(
        part1, out1, E1, part2, out2, E2, S);
  return cudaGetLastError();
}

template <typename T, int TM, int TN, bool kBias, class LA, class LB>
cudaError_t launch_wgrad(LA la, LB lb, float* part, float* bias_part, int M, int K1, int K2,
                         Split sp, cudaStream_t stream) {
  const size_t smem = WgTile<T, TM, TN>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<T, TM, TN, kBias, LA, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K1 + TM - 1) / TM, (K2 + TN - 1) / TN, sp.count);
  wgrad_kernel<T, TM, TN, kBias, LA, LB><<<grid, kTileThreads, smem, stream>>>(
      la, lb, part, bias_part, M, K1, K2, sp.chunk);
  return cudaGetLastError();
}

// dw [K1, K2] = sum over all M rows of round_T(a(m, k1)) round_T(b(m, k2))
// and, with kBias, db [K2] = sum over the rows of the unrounded b(m, k2);
// work holds wgrad_floats(M, K1, K2) floats of partials.
template <typename T, bool kBias, class LA, class LB>
cudaError_t weight_grad(LA la, LB lb, float* dw, float* db, float* work, int M, int K1, int K2,
                        cudaStream_t stream) {
  if (M <= 0 || K1 <= 0 || K2 <= 0 || K1 % 8 || K2 % 8) return cudaErrorInvalidValue;
  const Split sp = wg_split(M, K1, K2);
  float* bias_part = kBias ? work + (size_t)sp.count * K1 * K2 : nullptr;
  cudaError_t err;
  const int tm = wg_tile(K1), tn = wg_tile(K2);
  if (tm == 128 && tn == 128)
    err = launch_wgrad<T, 128, 128, kBias>(la, lb, work, bias_part, M, K1, K2, sp, stream);
  else if (tm == 128)
    err = launch_wgrad<T, 128, 64, kBias>(la, lb, work, bias_part, M, K1, K2, sp, stream);
  else if (tn == 128)
    err = launch_wgrad<T, 64, 128, kBias>(la, lb, work, bias_part, M, K1, K2, sp, stream);
  else
    err = launch_wgrad<T, 64, 64, kBias>(la, lb, work, bias_part, M, K1, K2, sp, stream);
  if (err != cudaSuccess) return err;
  return reduce_parts(work, dw, K1 * K2, bias_part, db, kBias ? K2 : 0, sp.count, stream);
}

}  // namespace
