// Copyright 2026 The container-engine-accelerators-tpu Authors.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.

// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU forward kernels of
// container_engine_accelerators_tpu/ops/attention.py: `_fwd_kernel`
// (:136, K/V resident in VMEM) and `_fwd_kernel_stream` (:237, K/V
// streamed on a third grid axis). The TPU needed two because VMEM could
// not hold a long sequence's K/V; here every block streams K/V tiles
// through shared memory, so one kernel serves both and `streaming=` is
// only validated by the wrapper.
//
// Same function as the Pallas kernels: online softmax in f32 with
// scale 1/sqrt(D); keys past the true length, the causal future and
// keys outside the window band (p - W, p] get the -1e9 score the TPU
// kernels use (not -inf, so the running state matches theirs step for
// step); O is written in the input type and lse = m + log(den) in f32.
//
// Layout: q, k, v are [B, S, H, D] read through their strides (the
// head dim must be contiguous), so the transformer hands over slices
// of its fused projection without a transpose copy. O is a contiguous
// [B, S, H, D], lse a contiguous [B, S, H].
//
// What bounds it on an H100: 4*D operations per kept (query, key) pair
// against a few bytes per row, so the tensor cores' rate (at [8, 2048,
// 8, 64] causal, 34 GFLOP: 0.035 ms at 989 TFLOP/s); what keeps a
// kernel from it is feeding the tensor cores and the softmax between
// the two products (an exp2 a score on the special-function unit).
//
// Head dims: the wrapper pads a head dim that is not a multiple of 8
// to one and passes the true head dim's scale (`head_dim_route`), so
// `dim` here is a multiple of 8. Up to 128 the kernels below run at
// DMAX 64 or 128. Above, bf16 on rows a TMA tensor map describes runs
// the Hopper kernel at DMAX 256 up to head dim 256 (the wrapper's
// route kRouteHopper; 136-248 zero-filled by TMA past the last
// column); everything else runs the wide kernels (at the end of this
// file), which split O's columns into 128-column chunks over grid.y.
// Row tiles and heads share grid.x (flash_grid.cuh), so no sequence
// length meets a grid limit.
//
// Five kernels, chosen by the input type, the head dim and the rows'
// alignment (the wrapper's `kernel_route`):
//
// bf16, the Hopper kernel (`flash_fwd_wgmma_tc_kernel`, for every
// input a TMA tensor map can describe, the wrapper's `tma_rows`, up to
// head dim 256). Only
// wgmma reaches the tensor cores' full rate on this card, so the design
// is FlashAttention-3's shape (wgmma_tma.cuh has the building blocks):
// one producer warpgroup whose first thread loads the block's Q tile
// once and keeps K/V tiles of 64 keys in flight by TMA (4-D tensor maps
// over the caller's strides, 128-byte swizzle, zeros past D and the
// length) through an mbarrier ring of 2-3 stages; consumer warpgroups
// of 64 query rows each, with registers handed over by setmaxnreg. A
// consumer loads its Q rows once into registers (ldmatrix from the
// swizzled tile) as the A operand of every S. Per K/V tile it issues
// O += P.V of the last tile (P in bf16 as the register A operand, V the
// MN-major B operand read through the descriptor) and S = Q.K^T of this
// one (K the B operand) back to back, waits once (a softmax beside an
// in-flight P.V made ptxas serialize the wgmmas at D 64), then runs the
// online softmax on the accumulator
// (the quad of lanes holding a row reduces with two shuffles; exp2 on
// the special-function unit alone) and rescales O. Three consumers a
// block (192-row tiles) at D 64, two at D 128, one block an SM, once
// the grid fills the card's 132 SMs; otherwise one consumer and two
// blocks an SM (the serving prefill's [1, S, 8, 64]), so no SM idles.
// Tiles outside a consumer's own key range (past its diagonal, before
// its window edge) are waited for and released only; only tiles a mask
// can touch pay for the mask; causal tiles run heaviest first. A head
// dim below 64 is zero-padded to 64 columns by TMA (D 16: four times
// the product work, a small share of a short call). Rounding P to bf16
// before P.V is the one change of numerics against the f32 kernel (as
// in FlashAttention-2 and -3); the row sums stay f32. Each output tile
// has one owner block, no atomics: two launches are bitwise equal.
// At DMAX 256 (head dims 136-256) O alone takes 128 registers a
// thread, so a block is two consumers of 64 rows and no producer, one
// block an SM: Q stays in shared memory as the A operand of S
// (wgmma_ss), K and V stream through rings of their own, a tile's
// softmax runs while the last tile's P.V and the other consumer's
// products are in flight, and the heads go in groups whose K and V
// the L2 cache holds (fwd_wide_body).
//
// bf16 rows that a tensor map cannot describe (a view whose rows start
// off 16 bytes, a broadcast stride; `tma_rows` is 0) take the mma.sync
// kernel (`flash_fwd_tc_kernel`, FlashAttention-2's shape): 4 warps
// per 64-row Q tile, K/V tiles staged by 2-byte loads into padded
// shared memory (mma_bf16.cuh), S and P.V by mma.m16n8k16. No other
// case up to D 128 reaches it.
//
// Above D 128, on rows a tensor map cannot describe or above head dim
// 256: `flash_fwd_wide_tc_kernel` (bf16, mma.sync); f32 at any rows:
// `flash_fwd_f32_wide_kernel` (FMA).
//
// f32, the exact FMA kernel (`flash_fwd_f32_kernel`): the tensor cores
// would round f32 inputs to TF32 (10-bit mantissa), outside the f32
// limit of 1e-4, so f32 stays on the CUDA cores: one 256-thread block
// per (batch*head, 64-row Q tile), K/V tiles of 64 keys staged as f32,
// scores and P@V by 4x4 register tiles of FMAs. The CUDA cores' 67
// TFLOP/s bound it.
//
// All bound the K-tile loop below by the window and above by the
// causal diagonal and the true length (the bounds of the Pallas
// kernel's fori_loop, attention.py:159-161, at this tile size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_grid.cuh"
#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

using cea_grid::kHopperWideDim;
using cea_grid::kRouteHopper;
using cea_grid::kWideCols;
using cea_grid::l2_group;
using cea_grid::Place;
using cea_grid::place;
using cea_grid::place_grouped;
using cea_mma::bf16;

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per staged tile
constexpr float kNeg = -1e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int batch, seq, heads, dim;
  // Element strides of the batch, sequence and head dims.
  long long q_stride[3], k_stride[3], v_stride[3];
  int causal, window;
  float scale;
  // The route (the wrapper's `kernel_route`, flash_grid.cuh):
  // kRouteHopper when a TMA tensor map describes q, k, v (`tma_rows`) up
  // to head dim 256; otherwise 0, or above 128 kRouteRows16 (the wide
  // kernel's 16-byte staging).
  int aligned;
};

// ---------------------------------------------------------------------
// f32: the exact FMA kernel.

constexpr int kThreadsY = 16;
constexpr int kThreadsX = 16;
constexpr int kRowsPerThread = kBlockQ / kThreadsY;  // 4
constexpr int kKeysPerThread = kBlockK / kThreadsX;  // 4
constexpr int kThreads = kThreadsY * kThreadsX;      // 256

// Reductions over the 16 threads that share a query row: they are 16
// consecutive lanes of one warp, and an xor butterfly leaves every
// lane with the bitwise-same result.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr size_t f32_smem_bytes(int dmax) {
  return sizeof(float) *
         (size_t)(3 * kBlockK * (dmax + 1) + kBlockQ * (kBlockK + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const Params p) {
  constexpr int kLd = DMAX + 1;  // +1: conflict-free column reads
  constexpr int kCols = DMAX / kThreadsX;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBlockQ][kLd]
  float* k_s = q_s + kBlockQ * kLd;  // [kBlockK][kLd]
  float* v_s = k_s + kBlockK * kLd;  // [kBlockK][kLd]
  float* p_s = v_s + kBlockK * kLd;  // [kBlockQ][kBlockK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kBlockQ);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kBlockQ;
  const int seq = p.seq;
  const int dim = p.dim;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_stride[0] +
                    h * p.q_stride[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_stride[0] +
                    h * p.k_stride[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_stride[0] +
                    h * p.v_stride[2];

  for (int i = tid; i < kBlockQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int pos = q0 + r;
    q_s[r * kLd + c] = (pos < seq && c < dim) ? qg[pos * p.q_stride[1] + c]
                                              : 0.f;
  }

  // Key range this Q tile can see: up to the diagonal of its last real
  // row (causal) or the true length, and from the window edge of its
  // first row.
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  float m[kRowsPerThread], den[kRowsPerThread];
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_lo / kBlockK; kt <= k_hi / kBlockK; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q staged; previous tile's readers are done
    for (int i = tid; i < kBlockK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      const int pos = k0 + r;
      const bool in = pos < seq && c < dim;
      k_s[r * kLd + c] = in ? kg[pos * p.k_stride[1] + c] : 0.f;
      v_s[r * kLd + c] = in ? vg[pos * p.v_stride[1] + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < dim; ++c) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = q_s[(ty + kThreadsY * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = k_s[(tx + kThreadsX * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + kThreadsY * i;
      const int q_pos = q0 + r;
      float block_max = kNeg;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int k_pos = k0 + tx + kThreadsX * j;
        bool keep = k_pos < seq;
        if (p.causal) {
          keep = keep && q_pos >= k_pos;
          if (p.window) keep = keep && k_pos > q_pos - p.window;
        }
        s[i][j] = keep ? s[i][j] * p.scale : kNeg;
        block_max = fmaxf(block_max, s[i][j]);
      }
      const float new_m = fmaxf(m[i], row_max(block_max));
      const float corr = expf(m[i] - new_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float e = expf(s[i][j] - new_m);
        p_s[r * (kBlockK + 1) + tx + kThreadsX * j] = e;
        sum += e;
      }
      den[i] = den[i] * corr + row_sum(sum);
      m[i] = new_m;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty + kThreadsY * i) * (kBlockK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[j * kLd + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q_pos = q0 + ty + kThreadsY * i;
    if (q_pos >= seq) continue;
    const long long row = (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
    float* og = static_cast<float*>(p.o) + row * dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kThreadsX * c;
      if (col < dim) og[col] = acc[i][c] / den[i];
    }
    if (tx == 0) p.lse[row] = m[i] + logf(den[i]);
  }
}

// ---------------------------------------------------------------------
// bf16: the tensor-core kernel.

constexpr int kTcWarps = 4;  // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;

constexpr size_t tc_smem_bytes(int dmax) {
  // Q, then two K and two V tiles, [64][dmax + 8] bf16 each.
  return sizeof(bf16) * (size_t)(kBlockQ + 4 * kBlockK) * (dmax + 8);
}

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kLd = DMAX + 8;
  constexpr int kSteps = DMAX / 16;  // 16-deep steps over the head dim
  constexpr int kNb = kBlockK / 8;   // 8-key blocks of a score tile
  constexpr int kNd = DMAX / 8;      // 8-column blocks of O
  constexpr int kTile = kBlockK * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockQ][kLd]
  bf16* k_s = q_s + kBlockQ * kLd;                // [2][kBlockK][kLd]
  bf16* v_s = k_s + 2 * kTile;                    // [2][kBlockK][kLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kBlockQ);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kBlockQ;
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];

  // The key range this Q tile sees, as in the f32 kernel.
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kBlockK, kt_hi = k_hi / kBlockK;

  stage_rows<kBlockQ, DMAX, kTcThreads>(q_s, qg, p.q_stride[1], q0, seq,
                                        dim);
  stage_rows<kBlockK, DMAX, kTcThreads>(k_s, kg, p.k_stride[1],
                                        kt_lo * kBlockK, seq, dim);
  stage_rows<kBlockK, DMAX, kTcThreads>(v_s, vg, p.v_stride[1],
                                        kt_lo * kBlockK, seq, dim);

  // Scores in log2 units: exp(x) = exp2(x * log2 e), folded into the
  // scale; the -1e9 mask value goes with them.
  const float scale2 = p.scale * kLog2e;
  const float neg2 = kNeg * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  uint32_t qf[kSteps][4];
  float o[kNd][4];
  float m[2] = {neg2, neg2};
  float den[2] = {0.f, 0.f};  // this lane's share of the row sums
#pragma unroll
  for (int j = 0; j < kNd; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile into the other buffer
      const int next = (kt + 1) * kBlockK;
      stage_rows<kBlockK, DMAX, kTcThreads>(k_s + (buf ^ 1) * kTile, kg,
                                            p.k_stride[1], next, seq, dim);
      stage_rows<kBlockK, DMAX, kTcThreads>(v_s + (buf ^ 1) * kTile, vg,
                                            p.v_stride[1], next, seq, dim);
    }
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        load_a(qf[ks], q_s + warp * 16 * kLd, kLd, ks * 16, lane);
    }
    const bf16* kb = k_s + buf * kTile;
    const bf16* vb = v_s + buf * kTile;

    float s[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kNb; j += 2) {
        uint32_t bk[4];
        load_b_rows(bk, kb, kLd, j * 8, ks * 16, lane);
        mma(s[j], qf[ks], bk[0], bk[1]);
        mma(s[j + 1], qf[ks], bk[2], bk[3]);
      }
    }

    const int k0 = kt * kBlockK;
    const bool masked =
        k0 + kBlockK > seq ||
        (p.causal && (k0 + kBlockK - 1 > q0 ||
                      (p.window && k0 <= q0 + kBlockQ - 1 - p.window)));
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q_pos = row0 + (e >> 1) * 8;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          bool keep = k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          s[j][e] = keep ? s[j][e] * scale2 : neg2;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }

    // Online softmax on the fragments: row i of this lane is row0 + 8i,
    // its values s[j][2i], s[j][2i + 1]; the quad shares the row.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kNb; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float new_m = quad_max(mx);
      const float corr = exp2f(m[i] - new_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        s[j][2 * i] = exp2f(s[j][2 * i] - new_m);
        s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - new_m);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      den[i] = den[i] * corr + sum;
      m[i] = new_m;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
    }

    // O += P.V, P in bf16 as the A operand, 16 keys a step.
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bv[4];
        load_b_cols(bv, vb, kLd, ks * 16, j * 8, lane);
        mma(o[j], pa, bv[0], bv[1]);
        mma(o[j + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this tile's readers are done before it reloads
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = row0 + 8 * i;
    const float total = quad_sum(den[i]);
    if (q_pos >= seq) continue;
    const float inv = 1.f / total;
    const long long row =
        (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
    bf16* og = static_cast<bf16*>(p.o) + row * dim;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dim)
        *reinterpret_cast<__nv_bfloat162*>(og + col) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
    if (t == 0) p.lse[row] = m[i] * kLn2 + logf(total);
  }
}

// ---------------------------------------------------------------------
// bf16: the Hopper kernel (wgmma + TMA).

// Parameters of the Hopper kernel: the tensor maps of q, k, v (read in
// place from the caller's strides) beside the common ones.
struct TmaParams {
  CUtensorMap tq, tk, tv;
  Params p;
};

// One block: WG consumer warpgroups of 64 query rows each (the Q tile
// is 64 * WG rows) and one producer warpgroup whose first thread keeps
// TMA loads of K/V tiles of 64 keys in flight through a ring of
// kStages. Where the grid fills the card, one block an SM with three
// consumers (D 64) or two (D 128, whose O takes twice the registers);
// where it does not, WG 1 and two blocks an SM. (128-key tiles, S by
// m64n128k16 with two consumers, measured slower at [8, 2048, 8, 64]
// and much slower with the W 512 band, whose edge tiles they waste.)
// At DMAX 256 (kWide: kernel head dims 136-256) O takes 128 f32
// registers a thread beside S (32) and P's A operands (16), so a block
// is two consumers of 64 query rows and no producer warpgroup, one
// block an SM (fwd_wide_body): Q takes 64 KB, K and V stream through
// rings of their own (kKStages and kVStages tiles of 32 KB).
template <int DMAX, int WG>
struct FwdWg {
  static constexpr bool kWide = DMAX > 128;
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kRowsQ = 64 * WG;
  // Three stages where they fit (a tile landing while a consumer holds
  // the last tile's V and this tile's K), two otherwise.
  static constexpr int kStages = (WG == 1 && DMAX > 64) ? 2 : 3;
  static constexpr int kThreads = 128 * (kWide ? WG : WG + 1);
  static constexpr int kMinBlocks = (WG == 1 && !kWide) ? 2 : 1;
  // setmaxnreg: the producer keeps 24 registers a thread; the consumers
  // take what the block's allocation (65536 / kThreads / kMinBlocks,
  // rounded down to 8: 128, 168 or 128 a thread) leaves. Without a
  // producer (kWide) no registers move: each thread may hold 255.
  static constexpr int kRegsProducer = kWide ? 0 : 24;
  static constexpr int kRegsConsumer =
      kWide ? 0 : WG == 1 ? 232 : WG == 2 ? 240 : 160;
  static constexpr int kChunkQ = kRowsQ * cea_hopper::kRowBytes;
  static constexpr int kChunkK = kBlockK * cea_hopper::kRowBytes;
  static constexpr int kQBytes = kChunks * kChunkQ;
  static constexpr int kKBytes = kChunks * kChunkK;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKBytes;
  // kWide: K's slot frees once the tile's S is in, V's only once its
  // P.V is, a tile later; each ring has a loading thread of its own,
  // so a K load never waits behind a V slot.
  static constexpr int kKStages = 3;
  static constexpr int kVStages = 2;
  static constexpr size_t smem_bytes() {
    // 1024 bytes of alignment slack, Q, the K/V ring (kWide: the K ring
    // and the V ring), the barriers (kWide: and Q's address).
    return kWide ? 1024 + kQBytes + (kKStages + kVStages) * kKBytes +
                       sizeof(uint64_t) * (2 + 2 * (kKStages + kVStages))
                 : 1024 + kQBytes + kStages * kStageBytes +
                       sizeof(uint64_t) * (1 + 2 * kStages);
  }
  static_assert(!kWide || WG == 2, "D 256: two consumers");
  static_assert(smem_bytes() <= 232448, "an H100 block's shared memory");
};

// What the masks read, held in registers by each consumer (the masks
// run on every element of a masked tile).
struct MaskShape {
  int seq, causal, window;
};

// The online-softmax step of one score tile `sc` (an accumulator), in
// place, in log2 units: scale, the -1e9 masks where
// `masked`, the running max and sum of this lane's two rows (row r
// holds sc[4j + 2r], sc[4j + 2r + 1]; the quad shares a row),
// P = exp2(s - m). Returns in corr[r] the factor the row's O must take.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&den)[2],
                                             float (&corr)[2],
                                             const MaskShape& p, int row0,
                                             int k0, int t, bool masked,
                                             float scale2, float neg2) {
  // Unmasked tiles fold the scale into the exponent's FMA: the row max
  // of the raw scores times the (positive) scale is the max of the
  // scaled ones.
  float k_scale = scale2;
  if (masked) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int q_pos = row0 + ((e >> 1) & 1) * 8;
      const int k_pos = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
      bool keep = k_pos < p.seq;
      if (p.causal) {
        keep = keep && q_pos >= k_pos;
        if (p.window) keep = keep && k_pos > q_pos - p.window;
      }
      sc[e] = keep ? sc[e] * scale2 : neg2;
    }
    k_scale = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -3.0e38f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    const float new_m = fmaxf(m[r], cea_hopper::quad_max(mx) * k_scale);
    corr[r] = cea_hopper::fast_exp2(m[r] - new_m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = sc[4 * j + 2 * r + h];
        x = cea_hopper::fast_exp2(fmaf(x, k_scale, -new_m));
        sum += x;
      }
    }
    den[r] = den[r] * corr[r] + sum;
    m[r] = new_m;
  }
}

// S = Q.K^T for one warpgroup: Q the register A operand (`qf`), K the
// K-major B operand (a [64][64]-chunked tile), one wgmma a 16-deep step.
template <int DMAX>
__device__ __forceinline__ void fwd_scores(float (&sc)[32],
                                           const uint32_t (&qf)[DMAX / 16][4],
                                           const unsigned char* ks) {
  using namespace cea_hopper;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_rs_n64<0>(sc, qf[kk], kmajor_desc(ks, kBlockK * kRowBytes, kk),
                    kk > 0);
}

// O += P.V for one warpgroup: P the register A operand (16 keys a
// step), V the MN-major B operand, 64 columns of O a wgmma.
template <int DMAX>
__device__ __forceinline__ void fwd_pv(float (&o)[DMAX / 64][32],
                                       const uint32_t (&pa)[kBlockK / 16][4],
                                       const unsigned char* vs) {
  using namespace cea_hopper;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DMAX / 64; ++c)
      wgmma_rs_n64<1>(o[c], pa[kk],
                      mnmajor_desc(vs, kBlockK * kRowBytes, c, kk));
}

// The block's work up to DMAX 128: WG consumer warpgroups of 64 query
// rows each, one K/V ring.
template <int DMAX, int WG>
__device__ __forceinline__ void fwd_own_rows(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = FwdWg<DMAX, WG>;
  constexpr int kStages = C::kStages;
  constexpr int kSteps = kBlockK / 16;  // 16-key steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* kv_s = q_s + C::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + kStages *
                                                 C::kStageBytes);
  uint64_t* full = q_full + 1;       // [kStages]: K/V tile landed
  uint64_t* empty = full + kStages;  // [kStages]: every consumer done

  const Params& p = tp.p;
  const Place pl = place(p.batch, p.heads, p.seq, C::kRowsQ);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * C::kRowsQ;
  const int seq = p.seq;
  // The key range the block's Q tile sees, as in the other kernels.
  const int q_last = min(q0 + C::kRowsQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kBlockK, kt_hi = k_hi / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // Producer: Q once, then the K/V tiles through the ring.
    setmaxnreg_dec<C::kRegsProducer>();
    if (threadIdx.x == 128 * WG) {
      tma_prefetch_map(&tp.tk);
      tma_prefetch_map(&tp.tv);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(q_s + c * C::kChunkQ, &tp.tq, q_full, 64 * c, h, q0, b);
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        unsigned char* ks = kv_s + s * C::kStageBytes;
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(ks + c * C::kChunkK, &tp.tk, &full[s], 64 * c, h,
                      kt * kBlockK, b);
          tma_load_4d(ks + C::kKBytes + c * C::kChunkK, &tp.tv, &full[s],
                      64 * c, h, kt * kBlockK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows r0 .. r0 + 63.
    setmaxnreg_inc<C::kRegsConsumer>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg;
    const int row0 = r0 + warp * 16 + g;  // this lane's rows: row0, +8
    const float scale2 = p.scale * kLog2e;
    const float neg2 = kNeg * kLog2e;
    const MaskShape sh = {seq, p.causal, p.window};
    const unsigned char* q_w = q_s + 64 * wg * kRowBytes;
    // This warpgroup computes tiles [c_lo, c_hi] of the block's range;
    // the others are masked for all its rows (past its causal
    // diagonal, before its window edge, or rows past the length), and
    // it only waits for them and releases them, in ring order.
    const int c_lo =
        max(kt_lo, (p.causal && p.window)
                       ? max(0, r0 - p.window + 1) / kBlockK
                       : 0);
    const int c_hi =
        r0 >= seq ? -1
                  : (p.causal ? min(r0 + 63, seq - 1) / kBlockK : kt_hi);
    int i = 0;  // ring position of tile kt_lo + i
    auto release = [&](int n) {
      for (; n > 0; --n, ++i) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
      }
    };
    // A tile's scores need their masks if a mask can reach one of them.
    auto masked = [&](int k0) {
      return k0 + kBlockK > seq ||
             (p.causal && (k0 + kBlockK - 1 > r0 ||
                           (p.window && k0 <= r0 + 63 - p.window)));
    };

    float o[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m[2] = {neg2, neg2};
    float den[2] = {0.f, 0.f};  // this lane's share of the row sums
    float corr[2];
    uint32_t pa[kSteps][4];

    if (c_lo > c_hi) {
      release(kt_hi - kt_lo + 1);
    } else {
      release(c_lo - kt_lo);
      mbar_wait(q_full, 0);
      // Q stays in registers as the A operand of every S = Q.K^T: only
      // K is read from shared memory per tile.
      uint32_t qf[DMAX / 16][4];
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        load_a_sw128(qf[kk], q_w, C::kChunkQ, kk, warp, lane);
      // The first tile: S = Q.K^T, then its softmax.
      int prev = i;
      mbar_wait(&full[prev % kStages], (prev / kStages) & 1);
      {
        float sc[32];
        wgmma_fence();
        fwd_scores<DMAX>(sc, qf,
                         kv_s + (prev % kStages) * C::kStageBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, m, den, corr, sh, row0, c_lo * kBlockK, t,
                     masked(c_lo * kBlockK), scale2, neg2);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) acc_to_a(pa[kk], sc, kk);
      }
      ++i;
      // Each further tile: O += P.V of the last tile and S of this one,
      // back to back on the tensor cores, then this tile's softmax (a
      // softmax beside an in-flight P.V made ptxas serialize the
      // wgmmas).
      for (int kt = c_lo + 1; kt <= c_hi; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(&full[s], (i / kStages) & 1);
        float sc[32];
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
        wgmma_fence();
        fwd_pv<DMAX>(
            o, pa, kv_s + (prev % kStages) * C::kStageBytes + C::kKBytes);
        fwd_scores<DMAX>(sc, qf, kv_s + s * C::kStageBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
        if (lane == 0) mbar_arrive(&empty[prev % kStages]);
        softmax_tile(sc, m, den, corr, sh, row0, kt * kBlockK, t,
                     masked(kt * kBlockK), scale2, neg2);
        // O, holding the last tile's P.V, moves to this tile's max.
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[c][4 * j + 2 * r] *= corr[r];
              o[c][4 * j + 2 * r + 1] *= corr[r];
            }
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) acc_to_a(pa[kk], sc, kk);
        prev = i;
      }
      // The last tile's P.V.
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
      wgmma_fence();
      fwd_pv<DMAX>(
          o, pa, kv_s + (prev % kStages) * C::kStageBytes + C::kKBytes);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
      if (lane == 0) mbar_arrive(&empty[prev % kStages]);
      release(kt_hi - c_hi);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q_pos = row0 + 8 * r;
        const float total = quad_sum(den[r]);
        if (q_pos >= seq) continue;
        const float inv = 1.f / total;
        const long long row =
            (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
        bf16* og = static_cast<bf16*>(p.o) + row * p.dim;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + j * 8 + 2 * t;
            if (col < p.dim)
              *reinterpret_cast<__nv_bfloat162*>(og + col) =
                  __floats2bfloat162_rn(o[c][4 * j + 2 * r] * inv,
                                        o[c][4 * j + 2 * r + 1] * inv);
          }
        if (t == 0) p.lse[row] = m[r] * kLn2 + logf(total);
      }
    }
  }
}

// S = Q.K^T for consumer `wg` at DMAX 256: its 64 rows of Q the
// shared-memory A operand (from the address `q_addr` holds), K the
// K-major B operand (`ks`, a K ring slot); issued and committed as one
// wgmma group, not waited for. Q's address is read at each call, so
// its 16 descriptors are formed beside their wgmma and not held in 32
// registers across the loop (O's 128 take most of the budget).
template <int DMAX>
__device__ __forceinline__ void fwd_wide_scores(float (&sc)[32],
                                                const uint32_t* q_addr,
                                                const unsigned char* ks,
                                                int wg) {
  using namespace cea_hopper;
  using C = FwdWg<DMAX, 2>;
  // Warpgroup wg's 64 rows of the block's Q tile.
  const uint32_t q_a = ld_shared_volatile(q_addr) + 64 * wg * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss_n64<0>(sc, kmajor_desc_at(q_a, C::kChunkQ, kk),
                    kmajor_desc(ks, C::kChunkK, kk), kk > 0);
  wgmma_commit();
}

// The block's work at DMAX 256 (FwdWg::kWide): two consumer warpgroups
// and no producer. Warpgroup wg owns query rows q0 + 64 wg .. + 63 of
// the block's 128, and both run every key tile of the block's range (a
// tile outside a warpgroup's own range is masked for all its rows: it
// leaves the warpgroup's O and row sums as they were, or, before the
// first tile it sees, is wiped by that tile's rescale). Per tile a
// warpgroup queues this tile's S and the last tile's P.V as two wgmma
// groups, frees the K slot and runs the online softmax once S is in,
// while P.V runs (it reads P's A operands and writes O, which the
// softmax leaves alone, so ptxas keeps the wgmma asynchronous), then
// frees the V slot, rescales O and forms the next P. The two take turns
// on the tensor cores (named barriers 1 and 2): a warpgroup issues its
// products, then hands the turn over, so one's softmax runs beside the
// other's products. The first thread of warpgroup 0 loads Q (64 KB) and
// the K tiles, that of warpgroup 1 the V tiles, each refilling the
// slot a tile freed a turn before; each K and V tile serves 128 rows.
template <int DMAX>
__device__ __forceinline__ void fwd_wide_body(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = FwdWg<DMAX, 2>;
  constexpr int kKStages = C::kKStages;
  constexpr int kVStages = C::kVStages;
  constexpr int kSteps = kBlockK / 16;  // 16-key steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* k_ring = q_s + C::kQBytes;
  unsigned char* v_ring = k_ring + kKStages * C::kKBytes;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_ring + kVStages * C::kKBytes);
  uint64_t* k_full = q_full + 1;          // [kKStages]: K tile landed
  uint64_t* k_empty = k_full + kKStages;  // [kKStages]: both S done
  uint64_t* v_full = k_empty + kKStages;  // [kVStages]
  uint64_t* v_empty = v_full + kVStages;  // [kVStages]: both P.V done
  // Q's shared address (fwd_wide_scores).
  uint32_t* q_addr = reinterpret_cast<uint32_t*>(v_empty + kVStages);

  const Params& p = tp.p;
  // Heads in groups whose K and V the L2 cache holds (place_grouped).
  const Place pl = place_grouped(
      p.batch, p.heads, p.seq, C::kRowsQ,
      l2_group(p.batch * p.heads, p.seq, p.dim));
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the last Q tiles see the most keys; run them first.
  const int q0 = (pl.tiles - 1 - pl.rank) * C::kRowsQ;
  const int seq = p.seq;
  // The key range the block's Q tile sees, as in the other kernels.
  const int q_last = min(q0 + C::kRowsQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kBlockK, kt_hi = k_hi / kBlockK;
  const int n = kt_hi - kt_lo + 1;  // key tiles, both warpgroups'
  // Key tile i of the range into its ring slot.
  auto load_k = [&](int i) {
    const int s = i % kKStages;
    mbar_arrive_expect_tx(&k_full[s], C::kKBytes);
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(k_ring + s * C::kKBytes + c * C::kChunkK, &tp.tk,
                  &k_full[s], 64 * c, h, (kt_lo + i) * kBlockK, b);
  };
  auto load_v = [&](int i) {
    const int s = i % kVStages;
    mbar_arrive_expect_tx(&v_full[s], C::kKBytes);
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(v_ring + s * C::kKBytes + c * C::kChunkK, &tp.tv,
                  &v_full[s], 64 * c, h, (kt_lo + i) * kBlockK, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    q_addr[0] = smem_u32(q_s);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch_map(&tp.tk);
    mbar_arrive_expect_tx(q_full, C::kQBytes);
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(q_s + c * C::kChunkQ, &tp.tq, q_full, 64 * c, h, q0, b);
    for (int i = 0; i < min(kKStages, n); ++i) load_k(i);
  } else if (threadIdx.x == 128) {
    tma_prefetch_map(&tp.tv);
    for (int i = 0; i < min(kVStages, n); ++i) load_v(i);
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row0 = r0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const float scale2 = p.scale * kLog2e;
  const float neg2 = kNeg * kLog2e;
  const MaskShape sh = {seq, p.causal, p.window};
  auto k_tile = [&](int i) { return k_ring + (i % kKStages) * C::kKBytes; };
  auto v_tile = [&](int i) { return v_ring + (i % kVStages) * C::kKBytes; };
  // A tile's scores need their masks if a mask can reach one of them.
  auto masked = [&](int k0) {
    return k0 + kBlockK > seq ||
           (p.causal && (k0 + kBlockK - 1 > r0 ||
                         (p.window && k0 <= r0 + 63 - p.window)));
  };
  // The turn on the tensor cores: warpgroup wg waits at barrier 1 + wg
  // and hands over at the other's.
  auto take_turn = [&] { named_barrier_sync(1 + wg, 256); };
  auto pass_turn = [&] { named_barrier_arrive(2 - wg, 256); };

  float o[C::kChunks][32];
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {neg2, neg2};
  float den[2] = {0.f, 0.f};  // this lane's share of the row sums
  float corr[2];
  float sc[32];
  uint32_t pa[kSteps][4];
  if (wg == 1) pass_turn();  // warpgroup 0 goes first
  mbar_wait(q_full, 0);
  // The first tile: S, then its softmax.
  mbar_wait(&k_full[0], 0);
  take_turn();
  wgmma_fence();
  fwd_wide_scores<DMAX>(sc, q_addr, k_tile(0), wg);
  pass_turn();
  wgmma_wait<0>();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(&k_empty[0]);
  softmax_tile(sc, m, den, corr, sh, row0, kt_lo * kBlockK, t,
               masked(kt_lo * kBlockK), scale2, neg2);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) acc_to_a(pa[kk], sc, kk);
  // Each further tile: in this warpgroup's turn its S, then the last
  // tile's P.V; the softmax once S is in, while P.V (and the other
  // warpgroup's products) run; then O moves to this tile's max.
  for (int i = 1; i < n; ++i) {
    const int prev = i - 1;
    mbar_wait(&k_full[i % kKStages], (i / kKStages) & 1);
    mbar_wait(&v_full[prev % kVStages], (prev / kVStages) & 1);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
    take_turn();
    wgmma_fence();
    fwd_wide_scores<DMAX>(sc, q_addr, k_tile(i), wg);
    fwd_pv<DMAX>(o, pa, v_tile(prev));
    wgmma_commit();
    pass_turn();
    wgmma_wait<1>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[i % kKStages]);
    softmax_tile(sc, m, den, corr, sh, row0, (kt_lo + i) * kBlockK, t,
                 masked((kt_lo + i) * kBlockK), scale2, neg2);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
    if (lane == 0) mbar_arrive(&v_empty[prev % kVStages]);
    // Refill the slots tile prev held, once both warpgroups are done
    // with it: its K (the other warpgroup's S of it ran a turn ago) by
    // warpgroup 0, its V (warpgroup 0's P.V of it ran a turn ago) by
    // warpgroup 1.
    if (threadIdx.x == 0 && prev + kKStages < n) {
      mbar_wait(&k_empty[prev % kKStages], (prev / kKStages) & 1);
      load_k(prev + kKStages);
    } else if (threadIdx.x == 128 && prev + kVStages < n) {
      mbar_wait(&v_empty[prev % kVStages], (prev / kVStages) & 1);
      load_v(prev + kVStages);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * r] *= corr[r];
          o[c][4 * j + 2 * r + 1] *= corr[r];
        }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) acc_to_a(pa[kk], sc, kk);
  }
  // The last tile's P.V (warpgroup 1 hands over no turn after it: none
  // is left).
  mbar_wait(&v_full[(n - 1) % kVStages], ((n - 1) / kVStages) & 1);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);
  take_turn();
  wgmma_fence();
  fwd_pv<DMAX>(o, pa, v_tile(n - 1));
  wgmma_commit();
  if (wg == 0) pass_turn();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + 8 * r;
    const float total = quad_sum(den[r]);
    if (q_pos >= seq) continue;
    const float inv = 1.f / total;
    const long long row =
        (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
    bf16* og = static_cast<bf16*>(p.o) + row * p.dim;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + j * 8 + 2 * t;
        if (col < p.dim)
          *reinterpret_cast<__nv_bfloat162*>(og + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * r] * inv,
                                    o[c][4 * j + 2 * r + 1] * inv);
      }
    if (t == 0) p.lse[row] = m[r] * kLn2 + logf(total);
  }
}

template <int DMAX, int WG>
__global__ void __launch_bounds__(FwdWg<DMAX, WG>::kThreads,
                                  FwdWg<DMAX, WG>::kMinBlocks)
flash_fwd_wgmma_tc_kernel(const __grid_constant__ TmaParams tp) {
  if constexpr (FwdWg<DMAX, WG>::kWide)
    fwd_wide_body<DMAX>(tp);
  else
    fwd_own_rows<DMAX, WG>(tp);
}

// ---------------------------------------------------------------------
// Head dims above 128: the wide kernels, f32 (FMA, at any rows) and
// bf16 (mma.sync: rows no tensor map describes, head dims above 256).
//
// A block owns 64 query rows and one 128-column chunk of O (grid.y;
// flash_grid.cuh). S = Q.K^T runs over the whole head dim, Q and K
// staged slab by slab (64 columns in f32, 128 in bf16), then P.V runs
// over the chunk's V columns alone. The registers stay those of the D
// 128 kernels at any D; the price is S computed once a chunk
// (ceil(D / 128) times). Every chunk's block computes S in the same
// order, so m and the row sums are bitwise equal across the chunks,
// and chunk 0 writes lse. bf16 holds the block's Q slabs for the whole
// K loop up to D 512 and stages one again a K tile above; it stages
// rows by 16-byte loads where every row starts on 16 bytes (the
// wrapper's flag kRouteRows16), by 2-byte loads otherwise. At
// [4, 2048, 16, 256] causal the bf16 one took about 8x its bound
// (PERF.md §6), where the Hopper kernel above now serves TMA rows.

constexpr int kF32Slab = 64;  // Q/K columns staged at a time (f32)

constexpr size_t f32_wide_smem_bytes() {
  // Q and K slabs, the V chunk and P.
  return sizeof(float) * (size_t)(2 * kBlockK * (kF32Slab + 1) +
                                  kBlockK * (kWideCols + 1) +
                                  kBlockQ * (kBlockK + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_wide_kernel(const Params p) {
  constexpr int kLdS = kF32Slab + 1;
  constexpr int kLdV = kWideCols + 1;
  constexpr int kCols = kWideCols / kThreadsX;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][kLdS]
  float* k_s = q_s + kBlockQ * kLdS;  // [kBlockK][kLdS]
  float* v_s = k_s + kBlockK * kLdS;  // [kBlockK][kLdV]
  float* p_s = v_s + kBlockK * kLdV;  // [kBlockQ][kBlockK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kBlockQ);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kBlockQ;
  const int c0 = blockIdx.y * kWideCols;  // this block's O columns
  const int seq = p.seq;
  const int dim = p.dim;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_stride[0] +
                    h * p.q_stride[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_stride[0] +
                    h * p.k_stride[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_stride[0] +
                    h * p.v_stride[2];

  // The key range, as in flash_fwd_f32_kernel.
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  float m[kRowsPerThread], den[kRowsPerThread];
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_lo / kBlockK; kt <= k_hi / kBlockK; ++kt) {
    const int k0 = kt * kBlockK;
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dim; d0 += kF32Slab) {
      const int w = min(kF32Slab, dim - d0);
      __syncthreads();  // the last slab's (or tile's) readers are done
      for (int i = tid; i < kBlockK * kF32Slab; i += kThreads) {
        const int r = i / kF32Slab, c = i % kF32Slab;
        const int q_pos = q0 + r, k_pos = k0 + r;
        q_s[r * kLdS + c] = (q_pos < seq && c < w)
                                ? qg[q_pos * p.q_stride[1] + d0 + c]
                                : 0.f;
        k_s[r * kLdS + c] = (k_pos < seq && c < w)
                                ? kg[k_pos * p.k_stride[1] + d0 + c]
                                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < w; ++c) {
        float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          qv[i] = q_s[(ty + kThreadsY * i) * kLdS + c];
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          kv[j] = k_s[(tx + kThreadsX * j) * kLdS + c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kKeysPerThread; ++j)
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // This tile's V chunk (its last readers were done before the slab
    // loop's first barrier; the barrier after P publishes it).
    for (int i = tid; i < kBlockK * kWideCols; i += kThreads) {
      const int r = i / kWideCols, c = i % kWideCols;
      const int pos = k0 + r;
      v_s[r * kLdV + c] = (pos < seq && c0 + c < dim)
                              ? vg[pos * p.v_stride[1] + c0 + c]
                              : 0.f;
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + kThreadsY * i;
      const int q_pos = q0 + r;
      float block_max = kNeg;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int k_pos = k0 + tx + kThreadsX * j;
        bool keep = k_pos < seq;
        if (p.causal) {
          keep = keep && q_pos >= k_pos;
          if (p.window) keep = keep && k_pos > q_pos - p.window;
        }
        s[i][j] = keep ? s[i][j] * p.scale : kNeg;
        block_max = fmaxf(block_max, s[i][j]);
      }
      const float new_m = fmaxf(m[i], row_max(block_max));
      const float corr = expf(m[i] - new_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float e = expf(s[i][j] - new_m);
        p_s[r * (kBlockK + 1) + tx + kThreadsX * j] = e;
        sum += e;
      }
      den[i] = den[i] * corr + row_sum(sum);
      m[i] = new_m;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty + kThreadsY * i) * (kBlockK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        vv[c] = v_s[j * kLdV + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q_pos = q0 + ty + kThreadsY * i;
    if (q_pos >= seq) continue;
    const long long row =
        (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
    float* og = static_cast<float*>(p.o) + row * dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + kThreadsX * c;
      if (col < dim) og[col] = acc[i][c] / den[i];
    }
    if (tx == 0 && blockIdx.y == 0) p.lse[row] = m[i] + logf(den[i]);
  }
}

size_t tc_wide_smem_bytes(int dim) {
  // The Q slabs held, a K slab and the V chunk, [64][kWideCols + 8]
  // bf16 each.
  return sizeof(bf16) *
         (size_t)(cea_grid::held_slabs(dim) * kBlockQ + 2 * kBlockK) *
         (kWideCols + 8);
}

__global__ void __launch_bounds__(kTcThreads)
flash_fwd_wide_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kLd = kWideCols + 8;
  constexpr int kNb = kBlockK / 8;    // 8-key blocks of a score tile
  constexpr int kNd = kWideCols / 8;  // 8-column blocks of the O chunk
  const int slabs = cea_grid::wide_chunks(p.dim);
  const bool held = slabs <= cea_grid::kHeldSlabs;  // Q staged once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [slabs or 1][kBlockQ][kLd]
  bf16* k_s = q_s + (held ? slabs : 1) * kBlockQ * kLd;  // [kBlockK][kLd]
  bf16* v_s = k_s + kBlockK * kLd;                        // [kBlockK][kLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kBlockQ);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kBlockQ;
  const int c0 = blockIdx.y * kWideCols;  // this block's O columns
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];

  // The key range, as in the f32 kernel.
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  // Scores in log2 units, as in flash_fwd_tc_kernel.
  const float scale2 = p.scale * kLog2e;
  const float neg2 = kNeg * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  if (held) {  // published by the K loop's first barrier
    for (int sl = 0; sl < slabs; ++sl)
      stage_rows_by<kBlockQ, kWideCols, kTcThreads>(
          p.aligned, q_s + sl * kBlockQ * kLd, qg + sl * kWideCols,
          p.q_stride[1], q0, seq, dim - sl * kWideCols);
  }
  float o[kNd][4];
  float m[2] = {neg2, neg2};
  float den[2] = {0.f, 0.f};  // this lane's share of the row sums
#pragma unroll
  for (int j = 0; j < kNd; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = k_lo / kBlockK; kt <= k_hi / kBlockK; ++kt) {
    const int k0 = kt * kBlockK;
    float s[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int sl = 0; sl < slabs; ++sl) {
      const int d0 = sl * kWideCols;
      __syncthreads();  // the last slab's (or tile's) readers are done
      if (!held)
        stage_rows_by<kBlockQ, kWideCols, kTcThreads>(
            p.aligned, q_s, qg + d0, p.q_stride[1], q0, seq, dim - d0);
      stage_rows_by<kBlockK, kWideCols, kTcThreads>(
          p.aligned, k_s, kg + d0, p.k_stride[1], k0, seq, dim - d0);
      __syncthreads();
      const bf16* qw = q_s + ((held ? sl : 0) * kBlockQ + warp * 16) * kLd;
      const int steps = (min(kWideCols, dim - d0) + 15) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t qa[4];
        load_a(qa, qw, kLd, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < kNb; j += 2) {
          uint32_t bk[4];
          load_b_rows(bk, k_s, kLd, j * 8, ks * 16, lane);
          mma(s[j], qa, bk[0], bk[1]);
          mma(s[j + 1], qa, bk[2], bk[3]);
        }
      }
    }
    // This tile's V chunk (its last readers were done before the slab
    // loop's first barrier).
    stage_rows_by<kBlockK, kWideCols, kTcThreads>(
        p.aligned, v_s, vg + c0, p.v_stride[1], k0, seq, dim - c0);
    __syncthreads();

    const bool masked =
        k0 + kBlockK > seq ||
        (p.causal && (k0 + kBlockK - 1 > q0 ||
                      (p.window && k0 <= q0 + kBlockQ - 1 - p.window)));
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q_pos = row0 + (e >> 1) * 8;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          bool keep = k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          s[j][e] = keep ? s[j][e] * scale2 : neg2;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kNb; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float new_m = quad_max(mx);
      const float corr = exp2f(m[i] - new_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        s[j][2 * i] = exp2f(s[j][2 * i] - new_m);
        s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - new_m);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      den[i] = den[i] * corr + sum;
      m[i] = new_m;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
    }

    // O += P.V over the chunk, P in bf16 as the A operand.
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bv[4];
        load_b_cols(bv, v_s, kLd, ks * 16, j * 8, lane);
        mma(o[j], pa, bv[0], bv[1]);
        mma(o[j + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = row0 + 8 * i;
    const float total = quad_sum(den[i]);
    if (q_pos >= seq) continue;
    const float inv = 1.f / total;
    const long long row =
        (static_cast<long long>(b) * seq + q_pos) * p.heads + h;
    bf16* og = static_cast<bf16*>(p.o) + row * dim;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < dim)
        *reinterpret_cast<__nv_bfloat162*>(og + col) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
    if (t == 0 && blockIdx.y == 0) p.lse[row] = m[i] * kLn2 + logf(total);
  }
}

// A wide kernel over 64-row tiles and the head dim's column chunks.
template <typename Kernel>
cudaError_t launch_wide(Kernel kernel, const Params& p, size_t smem,
                        int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, kBlockQ,
                          cea_grid::wide_chunks(p.dim), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, kBlockQ, 1, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, kBlockQ, 1, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<DMAX><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX, int WG>
cudaError_t launch_wg_n(const Params& p, cudaStream_t stream) {
  using C = FwdWg<DMAX, WG>;
  auto kernel = flash_fwd_wgmma_tc_kernel<DMAX, WG>;
  const size_t smem = C::smem_bytes();
  cudaError_t err = cea_hopper::prepare_launch<C>(
      kernel, C::kThreads, WG, C::kRegsProducer, C::kRegsConsumer, smem);
  if (err != cudaSuccess) return err;
  TmaParams tp;
  tp.p = p;
  const long long* strides[3] = {p.q_stride, p.k_stride, p.v_stride};
  const void* bases[3] = {p.q, p.k, p.v};
  CUtensorMap* maps[3] = {&tp.tq, &tp.tk, &tp.tv};
  for (int i = 0; i < 3; ++i) {
    const long long st[3] = {strides[i][0], strides[i][1], strides[i][2]};
    err = cea_hopper::encode_rows(maps[i], bases[i], p.batch, p.seq,
                                  p.heads, p.dim, st,
                                  i == 0 ? C::kRowsQ : kBlockK);
    if (err != cudaSuccess) return err;
  }
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, C::kRowsQ, 1, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, smem, stream>>>(tp);
  return cudaGetLastError();
}

// Three consumer warpgroups (192-row Q tiles) at D 64, two (128-row)
// at D 128, one block an SM, once the grid of such tiles fills the
// card's 132 SMs; otherwise one (64-row tiles, two blocks an SM), so a
// short or single-sequence prefill still spreads over the SMs. At DMAX
// 256 always two and no producer (128-row tiles, one block an SM; 1024
// blocks at [4, 2048, 16, 256]).
template <int DMAX>
cudaError_t launch_wg(const Params& p, cudaStream_t stream) {
  if constexpr (FwdWg<DMAX, 2>::kWide) {
    return launch_wg_n<DMAX, 2>(p, stream);
  } else {
    constexpr int kWg = DMAX == 64 ? 3 : 2;
    const long long tiles = static_cast<long long>(p.batch) * p.heads *
                            ((p.seq + 64 * kWg - 1) / (64 * kWg));
    return tiles >= 132 ? launch_wg_n<DMAX, kWg>(p, stream)
                        : launch_wg_n<DMAX, 1>(p, stream);
  }
}

}  // namespace

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor cores).
// Strides are in elements. `aligned` is the route (`kernel_route`, as
// the backward's entry points read it): kRouteHopper (1) when a TMA
// tensor map can read q, k and v in place (16-byte base, every stepped
// stride a nonzero multiple of 16 bytes) up to head dim 256: the
// Hopper kernel (DMAX 256 above 128); otherwise the mma.sync kernels,
// up to 128 with 2-byte loads (0), above 128 the wide kernel with
// 16-byte staging (kRouteRows16, every row on 16 bytes) or 2-byte
// staging (0).
// Returns the cudaError_t of the launch (0 = success); the caller
// raises on anything else. The wrapper has checked shapes, types and
// that the head dim is contiguous, and hands over a head dim that is a
// multiple of 8 (any, padded) with the true head dim's scale.
extern "C" int cea_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int batch,
                             int seq, int heads, int dim, long long q_sb,
                             long long q_ss, long long q_sh, long long k_sb,
                             long long k_ss, long long k_sh, long long v_sb,
                             long long v_ss, long long v_sh, int causal,
                             int window, float scale, int aligned,
                             void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.dim = dim;
  p.q_stride[0] = q_sb;
  p.q_stride[1] = q_ss;
  p.q_stride[2] = q_sh;
  p.k_stride[0] = k_sb;
  p.k_stride[1] = k_ss;
  p.k_stride[2] = k_sh;
  p.v_stride[0] = v_sb;
  p.v_stride[1] = v_ss;
  p.v_stride[2] = v_sh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.aligned = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim > kWideCols) {
    if (dtype == 1 && aligned == kRouteHopper)
      return static_cast<int>(dim > kHopperWideDim
                                  ? cudaErrorInvalidValue
                                  : launch_wg<kHopperWideDim>(p, st));
    if (dtype == 0)
      return static_cast<int>(launch_wide(flash_fwd_f32_wide_kernel, p,
                                          f32_wide_smem_bytes(), kThreads,
                                          st));
    if (dtype == 1)
      return static_cast<int>(launch_wide(flash_fwd_wide_tc_kernel, p,
                                          tc_wide_smem_bytes(p.dim), kTcThreads,
                                          st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = dim > 64;
  if (dtype == 0)
    return static_cast<int>(wide ? launch_f32<128>(p, st)
                                 : launch_f32<64>(p, st));
  if (dtype == 1 && aligned == kRouteHopper)
    return static_cast<int>(wide ? launch_wg<128>(p, st)
                                 : launch_wg<64>(p, st));
  if (dtype == 1)
    return static_cast<int>(wide ? launch_tc<128>(p, st)
                                 : launch_tc<64>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
