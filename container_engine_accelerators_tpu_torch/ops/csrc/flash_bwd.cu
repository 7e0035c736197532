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

// Flash-attention backward for Hopper (sm_90a), plain C interface:
// dQ and dK/dV, each by a tensor-core kernel (bf16) and an FMA kernel
// (f32).
//
// Replaces the four Pallas TPU backward kernels of
// container_engine_accelerators_tpu/ops/attention.py: `_dq_kernel` and
// `_dq_kernel_stream` (dQ), `_dkv_kernel` and `_dkv_kernel_stream`
// (dK/dV). The TPU needed a resident and a streaming variant of each
// because VMEM could not hold a long sequence's K/V (or Q/dO); here
// every block streams its partner tiles through shared memory, so one
// kernel per role serves both, and `streaming=`/`block=` are only
// validated by the wrapper.
//
// Same function as the Pallas kernels (`_dq_step`, `_dkv_step`):
// scores s = q.k * scale with the -1e9 masks of the forward (keys past
// the true length, the causal future, keys outside the window band
// (p - W, p]); p = exp(s - lse); dp = dO.v; ds = p * (dp - delta) *
// scale, where delta = rowsum(dO * O) - g_lse comes from the wrapper;
// dQ = sum_j ds.k, dV = sum_i p.dO, dK = sum_i ds.q. All sums in f32
// registers, no atomics: each output tile is owned by one block, so
// the result is deterministic. Outputs are written in the input type.
//
// Layout: q, k, v, dO are [B, S, H, D] read through their strides (the
// head dim must be contiguous); lse and delta are contiguous [B, S, H]
// f32; dQ, dK, dV are contiguous [B, S, H, D].
//
// What bounds them on an H100: at the training slice's shapes
// ([8, 2048, 8, 64] bf16, causal) dQ does 6*D and dK/dV 8*D
// operations per kept (query, key) pair, about 52 and 69 GFLOP, against
// 85-101 MB of traffic, so the tensor cores' rate bounds both (about
// 0.05-0.07 ms at 989 TFLOP/s), and what keeps a kernel from that
// bound is feeding them and the elementwise step between the products
// (an exp2 a score on the special-function unit).
//
// Head dims: the wrapper pads a head dim that is not a multiple of 8
// to one and passes the true head dim's scale (`head_dim_route`), so
// `dim` here is a multiple of 8. Up to 128 the six kernels below run
// at DMAX 64 or 128. Above 128, bf16 on rows a TMA tensor map
// describes runs the Hopper dQ and dK/dV at DMAX 256 up to head dim
// 256 (the wrapper's route kRouteHopper; 136-248 zero-filled by TMA
// past the last column); everything else runs four wide kernels (after
// the mma.sync ones) that split the outputs' columns into 128-column
// chunks over grid.y. Row tiles and heads share grid.x
// (flash_grid.cuh), so no sequence length meets a grid limit.
//
// Six kernels up to D 128, chosen by the role, the input type and
// (bf16) the rows' alignment. Only wgmma reaches the tensor cores' full
// rate on this card, so bf16 runs on the Hopper kernels (wgmma + TMA;
// wgmma_tma.cuh has the building blocks) for every input a TMA tensor
// map can describe (the wrapper's `tma_rows`), and on the mma.sync
// kernels (mma.m16n8k16 bf16 with f32 accumulators, the helpers of
// mma_bf16.cuh) otherwise. Every kernel evaluates masks only on the
// tiles a mask can touch (the diagonal, the window edge, the ragged
// end) and runs scores in log2 units (exp2, scale * log2 e folded in).
//
// At DMAX 256 (`flash_bwd_dq_wgmma_tc_kernel<256,1>`,
// `flash_bwd_dkv_wgmma_tc_kernel<256,2>`) every product runs once over
// the whole head dim, as at DMAX 128; what changes is the budget. dQ:
// one consumer warpgroup on 64 query rows, one block an SM, dQ in 128
// f32 registers, Q and dO (64 KB) loaded once, K and V in rings of
// their own (three and two 32 KB stages: V frees once the scores are
// in, K a tile later, after the dQ product). dK/dV: one 64-key tile a
// block; dK and dV of 64 keys x 256 columns (256 registers a thread in
// one warpgroup) split over two consumer warpgroups of 128 columns
// each, which also split each Q/dO tile's 64 query columns of S^T and
// dP^T (m64n32) and hand each other their halves of P^T and dS^T in
// bf16 through shared memory behind a named barrier; no producer
// warpgroup (the consumers issue the loads), so each thread may hold
// 255 registers.
//
// dQ, bf16, the Hopper kernel (`flash_bwd_dq_wgmma_tc_kernel`): the
//   forward's structure with one more product. One block per
//   (batch*head, 64 * WG query rows), the last (heaviest causal) tiles
//   first: a producer warpgroup whose first thread loads the block's Q
//   and dO once by TMA, then streams 64-key K/V tiles by TMA through a
//   three-stage mbarrier ring (two at D 128 with one consumer); WG
//   consumer warpgroups of 64 rows each (three at D 64 and two at D
//   128, one block an SM, once the grid fills the card's 132 SMs;
//   otherwise one and two blocks an SM), registers handed over by
//   setmaxnreg. A consumer holds its rows' lse (log2 units) and delta
//   in registers for the whole loop (no ring: they do not change with
//   the K/V tile). Per tile it runs S = Q.K^T and dP = dO.V^T (Q and
//   dO the A operands, held in registers by a lone consumer at D 64
//   and read from shared memory otherwise; K and V K-major B
//   operands), forms P = exp2(S * scale * log2 e - lse * log2 e) and
//   dS = P * (dP - delta) * scale on the accumulators (exp2 on the
//   special-function unit alone), rounds dS to bf16 as the register A
//   operand of dQ += dS.K (K read MN-major through the descriptor: no
//   transposing load). The next tile's two score products go to the
//   tensor cores ahead of this tile's dQ product, and the consumer
//   forms the next dS while that product runs. Key tiles from the
//   window's lower edge to the causal diagonal (the bounds of
//   `_dq_kernel`, attention.py:183-185, at this tile size); tiles
//   outside a consumer's own range are waited for and released only.
//   dQ stays in f32 registers for the whole loop and is written once.
// dQ, bf16 rows a tensor map cannot describe (`tma_rows` 0: a view
//   whose rows start off 16 bytes, a broadcast stride), and no other
//   case up to D 128: the mma.sync kernel (`flash_bwd_dq_tc_kernel`):
//   128-thread blocks of 4 warps, each warp owning 16 rows of a 64-row
//   Q tile; Q
//   and dO staged once and held as A fragments (re-read from shared
//   memory at each step at DMAX 128), K/V tiles in two buffers (rows
//   by 2-byte loads); per tile S and dP, then dQ += dS.K with dS as the
//   A operand from the registers and K through ldmatrix.trans.
// dK/dV, bf16, the Hopper kernel (`flash_bwd_dkv_wgmma_tc_kernel`, for
//   every input a TMA tensor map can describe). One block per
//   (batch*head, 64 * WG keys): a producer warpgroup whose first warp
//   loads the block's K and V once by TMA, then streams Q/dO tiles of
//   64 queries (32 at D 128, where dK and dV alone take 128 accumulator
//   registers a thread) by TMA through a three-stage mbarrier ring,
//   their lse and delta rows beside them (read by the warp's lanes
//   before the slot frees, so the global reads do not delay the TMA
//   issue); WG consumer warpgroups of 64 keys each (two, one block an
//   SM, once the grid fills the card's 132 SMs; otherwise one and two
//   blocks an SM), registers handed over by setmaxnreg. Per Q/dO tile a
//   consumer runs S^T = K.Q^T and dP^T = V.dO^T (rows: its keys; K and
//   V the A operands, held in registers at D 64 and read from shared
//   memory at D 128, Q and dO the B operands),
//   forms P^T and dS^T on the accumulators (exp2 on the special-function
//   unit alone), rounds them to bf16 as the register A operands of
//   dV += P^T.dO and dK += dS^T.Q (dO and Q read MN-major through the
//   descriptor: no transposing load), and queues the next tile's two
//   score products behind those on the tensor cores before it waits.
//   Query tiles from the causal lower bound to the window's upper bound
//   (`_dkv_kernel`, attention.py:212-215); tiles outside a consumer's
//   own range are waited for and released only. dK and dV stay in f32
//   registers for the whole loop and are written once. dQ stays in its
//   own kernel (no atomics folded in, as FlashAttention-3 does), so
//   every output keeps one owner block.
// dK/dV, bf16 rows a tensor map cannot describe (`tma_rows` 0: a view
//   whose rows start off 16 bytes, a broadcast stride), and no other
//   case up to D 128: the mma.sync kernel (`flash_bwd_dkv_tc_kernel`):
//   128-thread blocks, one per (batch*head, 64-key tile); K and V
//   staged once (the
//   mma.sync kernels stage rows by 2-byte loads); Q and dO tiles
//   (64 queries, 32 at D > 64) with their lse and delta rows; per tile
//   S^T and dP^T, then dV and dK with P^T and dS^T as A fragments from
//   the registers (dO and Q through ldmatrix.trans).
// Rounding P^T and dS^T (dK/dV) and dS (dQ) to bf16 before the second
// product is the change of numerics against the f32 kernels (as in
// FlashAttention-2); lse, delta, the row terms and every accumulator
// stay f32.
//
// f32 (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`): exact FMA
// kernels on the CUDA cores (67 TFLOP/s at most); the tensor cores
// would round f32 inputs to TF32, outside the f32 limit of 1e-4. One
// 256-thread block per (batch*head, 64-row tile) with the same tile
// bounds; partner tiles staged as f32; scores by 4x4 register tiles,
// ds (dQ) or p^T and ds^T (dK/dV) through shared memory, the outputs
// by 4 x D/16 register tiles.
//
// Causal tiles run heaviest first. No atomics anywhere: each output
// tile is owned by one block, so every result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_grid.cuh"
#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

using cea_grid::kHopperWideDim;
using cea_grid::kRouteHopper;
using cea_grid::kWideCols;
using cea_grid::Place;
using cea_grid::place;
using cea_mma::bf16;

constexpr int kTile = 64;  // rows of the block's own tile and of a partner tile
constexpr int kThreadsY = 16;
constexpr int kThreadsX = 16;
constexpr int kPer = kTile / kThreadsY;  // 4 rows (and 4 columns) a thread
constexpr int kThreads = kThreadsY * kThreadsX;  // 256
constexpr int kLdT = kTile + 1;  // +1: conflict-free column reads

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;  // dQ, or dK
  void* out1;  // unused, or dV
  int batch, seq, heads, dim;
  // Element strides of the batch, sequence and head dims.
  long long q_stride[3], k_stride[3], v_stride[3], do_stride[3];
  int causal, window;
  float scale;
  // The route (the wrapper's `kernel_route`, flash_grid.cuh): up to
  // head dim 128, kRouteHopper when a TMA tensor map describes q, k, v
  // and dO (`tma_rows`), 0 otherwise; above, kRouteHopper for the Hopper
  // kernels at DMAX 256, kRouteRows16 or 0 for the wide mma.sync kernels
  // (16-byte or 2-byte staging).
  int aligned;
};

// ---------------------------------------------------------------------
// f32: the exact FMA kernels.

// Whether query q_pos sees key k_pos (both already known < seq).
__device__ __forceinline__ bool sees(const Params& p, int q_pos, int k_pos) {
  if (!p.causal) return true;
  if (q_pos < k_pos) return false;
  return !p.window || k_pos > q_pos - p.window;
}

// Stage rows [r0, r0 + kTile) of a [B, S, H, D] operand into shared
// memory as [kTile][DMAX + 1], zero past the true length and dim.
template <int DMAX>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      long long row_stride, int r0,
                                      int seq, int dim) {
  constexpr int kLd = DMAX + 1;
  for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int pos = r0 + r;
    dst[r * kLd + c] =
        (pos < seq && c < dim) ? base[pos * row_stride + c] : 0.f;
  }
}

// acc[a][b] += sum_c x[row(a)][c] * y[col(b)][c] over the first `dim`
// columns: rows ty + 16a of x, rows tx + 16b of y.
template <int DMAX>
__device__ __forceinline__ void dot_tile_add(float (&acc)[kPer][kPer],
                                             const float* x, const float* y,
                                             int dim, int ty, int tx) {
  constexpr int kLd = DMAX + 1;
#pragma unroll 4
  for (int c = 0; c < dim; ++c) {
    float xv[kPer], yv[kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a) xv[a] = x[(ty + kThreadsY * a) * kLd + c];
#pragma unroll
    for (int b = 0; b < kPer; ++b) yv[b] = y[(tx + kThreadsX * b) * kLd + c];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int b = 0; b < kPer; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) acc[a][b] = 0.f;
}

// acc[a][b] = sum_c x[row(a)][c] * y[col(b)][c] (dot_tile_add from 0).
template <int DMAX>
__device__ __forceinline__ void dot_tile(float (&acc)[kPer][kPer],
                                         const float* x, const float* y,
                                         int dim, int ty, int tx) {
  zero_tile(acc);
  dot_tile_add<DMAX>(acc, x, y, dim, ty, tx);
}

// out[a][c] += sum_j w[row(a)][j] * y[j][col(c)]: rows ty + 16a of the
// [kTile][kLdT] weights, columns tx + 16c of the [kTile][DMAX + 1] y.
template <int DMAX>
__device__ __forceinline__ void accumulate(float (&out)[kPer][DMAX / kThreadsX],
                                           const float* w, const float* y,
                                           int ty, int tx) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / kThreadsX;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float wv[kPer], yv[kCols];
#pragma unroll
    for (int a = 0; a < kPer; ++a) wv[a] = w[(ty + kThreadsY * a) * kLdT + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) yv[c] = y[j * kLd + tx + kThreadsX * c];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[a][c] = fmaf(wv[a], yv[c], out[a][c]);
  }
}

// Write rows ty + 16a of a tile starting at r0 into a contiguous
// [B, S, H, D] output, columns from c0 on.
template <int DMAX>
__device__ __forceinline__ void write_tile(
    void* out, const float (&acc)[kPer][DMAX / kThreadsX], const Params& p,
    int b, int h, int r0, int ty, int tx, int c0 = 0) {
  constexpr int kCols = DMAX / kThreadsX;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int pos = r0 + ty + kThreadsY * a;
    if (pos >= p.seq) continue;
    const long long row =
        (static_cast<long long>(b) * p.seq + pos) * p.heads + h;
    float* dst = static_cast<float*>(out) + row * p.dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + kThreadsX * c;
      if (col < p.dim) dst[col] = acc[a][c];
    }
  }
}

constexpr size_t f32_smem_bytes(int dmax) {
  // Four [kTile][dmax + 1] operand tiles, two [kTile][kTile + 1] weight
  // tiles, and two rows of kTile (lse, delta).
  return sizeof(float) * (size_t)(4 * kTile * (dmax + 1) +
                                  2 * kTile * kLdT + 2 * kTile);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / kThreadsX;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* ds_s = v_s + kTile * kLd;  // [kTile][kLdT]
  float* lse_s = ds_s + 2 * kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kTile;
  const int seq = p.seq;

  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_stride[0] +
                     h * p.do_stride[2];

  stage<DMAX>(q_s, qg, p.q_stride[1], q0, seq, p.dim);
  stage<DMAX>(do_s, dog, p.do_stride[1], q0, seq, p.dim);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int pos = q0 + r;
    const long long row = (static_cast<long long>(b) * seq + pos) * p.heads + h;
    lse_s[r] = pos < seq ? p.lse[row] : 0.f;
    delta_s[r] = pos < seq ? p.delta[row] : 0.f;
  }

  // The key range this Q tile sees, as in the forward.
  const int q_last = min(q0 + kTile, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  float dq[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[a][c] = 0.f;

  for (int kt = k_lo / kTile; kt <= k_hi / kTile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // Q/dO staged; the previous tile's readers are done
    stage<DMAX>(k_s, kg, p.k_stride[1], k0, seq, p.dim);
    stage<DMAX>(v_s, vg, p.v_stride[1], k0, seq, p.dim);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    dot_tile<DMAX>(s, q_s, k_s, p.dim, ty, tx);
    dot_tile<DMAX>(dp, do_s, v_s, p.dim, ty, tx);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int r = ty + kThreadsY * a;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kThreadsX * j;
        const int k_pos = k0 + c;
        const bool keep = q_pos < seq && k_pos < seq && sees(p, q_pos, k_pos);
        // exp(-1e9 - lse) is exactly 0 in f32: a masked pair adds 0.
        const float pr = keep ? expf(s[a][j] * p.scale - lse_s[r]) : 0.f;
        ds_s[r * kLdT + c] = pr * (dp[a][j] - delta_s[r]) * p.scale;
      }
    }
    __syncthreads();
    accumulate<DMAX>(dq, ds_s, k_s, ty, tx);
  }
  write_tile<DMAX>(p.out0, dq, p, b, h, q0, ty, tx);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / kThreadsX;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;
  float* do_s = q_s + kTile * kLd;
  float* pt_s = do_s + kTile * kLd;  // p^T  [key][query]
  float* dst_s = pt_s + kTile * kLdT;  // ds^T [key][query]
  float* lse_s = dst_s + kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * kTile;
  const int seq = p.seq;

  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_stride[0] +
                     h * p.do_stride[2];

  stage<DMAX>(k_s, kg, p.k_stride[1], k0, seq, p.dim);
  stage<DMAX>(v_s, vg, p.v_stride[1], k0, seq, p.dim);

  // The query range that sees this key tile: from the causal diagonal
  // to the window's reach of its last real key.
  const int k_last = min(k0 + kTile, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;

  float dk[kPer][kCols], dv[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int qt = q_lo / kTile; qt <= q_hi / kTile; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // K/V staged; the previous tile's readers are done
    stage<DMAX>(q_s, qg, p.q_stride[1], q0, seq, p.dim);
    stage<DMAX>(do_s, dog, p.do_stride[1], q0, seq, p.dim);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int pos = q0 + r;
      const long long row =
          (static_cast<long long>(b) * seq + pos) * p.heads + h;
      lse_s[r] = pos < seq ? p.lse[row] : 0.f;
      delta_s[r] = pos < seq ? p.delta[row] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are this block's keys, columns queries.
    float st[kPer][kPer], dpt[kPer][kPer];
    dot_tile<DMAX>(st, k_s, q_s, p.dim, ty, tx);
    dot_tile<DMAX>(dpt, v_s, do_s, p.dim, ty, tx);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int r = ty + kThreadsY * a;
      const int k_pos = k0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kThreadsX * j;
        const int q_pos = q0 + c;
        const bool keep = q_pos < seq && k_pos < seq && sees(p, q_pos, k_pos);
        const float pr = keep ? expf(st[a][j] * p.scale - lse_s[c]) : 0.f;
        pt_s[r * kLdT + c] = pr;
        dst_s[r * kLdT + c] = pr * (dpt[a][j] - delta_s[c]) * p.scale;
      }
    }
    __syncthreads();
    accumulate<DMAX>(dv, pt_s, do_s, ty, tx);
    accumulate<DMAX>(dk, dst_s, q_s, ty, tx);
  }
  write_tile<DMAX>(p.out0, dk, p, b, h, k0, ty, tx);
  write_tile<DMAX>(p.out1, dv, p, b, h, k0, ty, tx);
}

// ---------------------------------------------------------------------
// bf16: the tensor-core kernels.

constexpr int kTcThreads = 128;  // 4 warps, 16 rows of the own tile each

// dQ. The Q and dO A fragments (2 * DMAX / 16 * 4 registers) stay in
// registers across the loop at DMAX 64; at DMAX 128 they would take 64
// of the registers that dQ, S and dP (128) leave, so they are re-read
// from shared memory at each step.
template <int DMAX>
struct DqTc {
  static constexpr int kLd = DMAX + 8;
  static constexpr bool kHoldA = DMAX <= 64;
  static constexpr size_t smem_bytes() {
    // Q and dO tiles, then two K and two V tiles, [kTile][kLd] bf16.
    return sizeof(bf16) * (size_t)6 * kTile * kLd;
  }
};

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kLd = DqTc<DMAX>::kLd;
  constexpr bool kHoldA = DqTc<DMAX>::kHoldA;
  constexpr int kSteps = DMAX / 16;  // 16-deep steps over the head dim
  constexpr int kNb = kTile / 8;     // 8-key blocks of a score tile
  constexpr int kNd = DMAX / 8;      // 8-column blocks of dQ
  constexpr int kTileSz = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][kLd]
  bf16* do_s = q_s + kTileSz;                     // [kTile][kLd]
  bf16* k_s = do_s + kTileSz;                     // [2][kTile][kLd]
  bf16* v_s = k_s + 2 * kTileSz;                  // [2][kTile][kLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kTile;
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] +
                    h * p.do_stride[2];

  // The key range this Q tile sees, as in the f32 kernel.
  const int q_last = min(q0 + kTile, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kTile, kt_hi = k_hi / kTile;

  stage_rows<kTile, DMAX, kTcThreads>(q_s, qg, p.q_stride[1], q0, seq, dim);
  stage_rows<kTile, DMAX, kTcThreads>(do_s, dog, p.do_stride[1], q0, seq,
                                      dim);
  stage_rows<kTile, DMAX, kTcThreads>(k_s, kg, p.k_stride[1], kt_lo * kTile,
                                      seq, dim);
  stage_rows<kTile, DMAX, kTcThreads>(v_s, vg, p.v_stride[1], kt_lo * kTile,
                                      seq, dim);

  // This lane's rows row0 and row0 + 8: lse in log2 units, and delta.
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + 8 * i;
    const long long row =
        (static_cast<long long>(b) * seq + pos) * p.heads + h;
    lse2[i] = pos < seq ? p.lse[row] * kLog2e : 0.f;
    delta[i] = pos < seq ? p.delta[row] : 0.f;
  }

  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
  const bf16* qw = q_s + warp * 16 * kLd;  // this warp's Q and dO rows
  const bf16* dow = do_s + warp * 16 * kLd;
  uint32_t qf[kHoldA ? kSteps : 1][4], df[kHoldA ? kSteps : 1][4];
  float dq[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile into the other buffer
      const int next = (kt + 1) * kTile;
      stage_rows<kTile, DMAX, kTcThreads>(k_s + (buf ^ 1) * kTileSz, kg,
                                          p.k_stride[1], next, seq, dim);
      stage_rows<kTile, DMAX, kTcThreads>(v_s + (buf ^ 1) * kTileSz, vg,
                                          p.v_stride[1], next, seq, dim);
    }
    __syncthreads();
    if constexpr (kHoldA) {
      if (kt == kt_lo) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          load_a(qf[ks], qw, kLd, ks * 16, lane);
          load_a(df[ks], dow, kLd, ks * 16, lane);
        }
      }
    }
    const bf16* kb = k_s + buf * kTileSz;
    const bf16* vb = v_s + buf * kTileSz;

    // S = Q.K^T and dP = dO.V^T for this warp's 16 rows.
    float s[kNb][4], dp[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qa[4], da[4];
      if constexpr (kHoldA) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[ks][e];
          da[e] = df[ks][e];
        }
      } else {
        load_a(qa, qw, kLd, ks * 16, lane);
        load_a(da, dow, kLd, ks * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < kNb; j += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows(bk, kb, kLd, j * 8, ks * 16, lane);
        load_b_rows(bv, vb, kLd, j * 8, ks * 16, lane);
        mma(s[j], qa, bk[0], bk[1]);
        mma(s[j + 1], qa, bk[2], bk[3]);
        mma(dp[j], da, bv[0], bv[1]);
        mma(dp[j + 1], da, bv[2], bv[3]);
      }
    }

    // P and dS on the fragments: element e of block j is row row0 +
    // 8 * (e >> 1), key k0 + j * 8 + 2t + (e & 1). dS overwrites S.
    const int k0 = kt * kTile;
    const bool masked =
        k0 + kTile > seq ||
        (p.causal && (k0 + kTile - 1 > q0 ||
                      (p.window && k0 <= q0 + kTile - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = exp2f(fmaf(s[j][e], scale2, -lse2[i]));
        if (masked) {
          const int q_pos = row0 + 8 * i;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          bool keep = k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          pr = keep ? pr : 0.f;
        }
        s[j][e] = pr * (dp[j][e] - delta[i]) * p.scale;
      }

    // dQ += dS.K, dS in bf16 as the A operand, 16 keys a step.
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      c_to_a(a, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bk[4];
        load_b_cols(bk, kb, kLd, ks * 16, j * 8, lane);
        mma(dq[j], a, bk[0], bk[1]);
        mma(dq[j + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this tile's readers are done before it reloads
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + 8 * i;
    if (pos >= seq) continue;
    bf16* dqg = static_cast<bf16*>(p.out0) +
                ((static_cast<long long>(b) * seq + pos) * p.heads + h) * dim;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dim)
        *reinterpret_cast<__nv_bfloat162*>(dqg + col) =
            __floats2bfloat162_rn(dq[j][2 * i], dq[j][2 * i + 1]);
    }
  }
}

// dK/dV. kQ queries a partner tile: 64, or 32 at DMAX 128 (dK and dV
// take 2 * DMAX / 8 * 4 f32 registers).

template <int DMAX>
struct DkvTc {
  static constexpr int kQ = DMAX <= 64 ? 64 : 32;
  static constexpr int kLd = DMAX + 8;
  static constexpr size_t smem_bytes() {
    // K and V tiles, two Q and two dO tiles in bf16, then lse and
    // delta rows for both buffers in f32.
    return sizeof(bf16) * (size_t)(2 * kTile + 4 * kQ) * kLd +
           sizeof(float) * 4 * kQ;
  }
};

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kQ = DkvTc<DMAX>::kQ;
  constexpr int kLd = DkvTc<DMAX>::kLd;
  constexpr int kSteps = DMAX / 16;  // 16-deep steps over the head dim
  constexpr int kNb = kQ / 8;        // 8-query blocks of a score tile
  constexpr int kNd = DMAX / 8;      // 8-column blocks of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][kLd]
  bf16* v_s = k_s + kTile * kLd;                  // [kTile][kLd]
  bf16* q_s = v_s + kTile * kLd;                  // [2][kQ][kLd]
  bf16* do_s = q_s + 2 * kQ * kLd;                // [2][kQ][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kQ * kLd);  // [2][kQ]
  float* delta_s = lse_s + 2 * kQ;                                // [2][kQ]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * kTile;
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] +
                    h * p.do_stride[2];
  // lse and delta of (b, position, h) sit at (b * seq + pos) * heads + h.
  const long long row_base = static_cast<long long>(b) * seq * p.heads + h;

  // The query range that sees this key tile, as in the f32 kernel.
  const int k_last = min(k0 + kTile, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;
  const int qt_lo = q_lo / kQ, qt_hi = q_hi / kQ;

  // Stage Q/dO tile qt, with its lse and delta rows, into buffer buf.
  auto stage_partner = [&](int qt, int buf) {
    const int q0 = qt * kQ;
    stage_rows<kQ, DMAX, kTcThreads>(q_s + buf * kQ * kLd, qg, p.q_stride[1],
                                     q0, seq, dim);
    stage_rows<kQ, DMAX, kTcThreads>(do_s + buf * kQ * kLd, dog,
                                     p.do_stride[1], q0, seq, dim);
    for (int r = threadIdx.x; r < kQ; r += kTcThreads) {
      const int pos = q0 + r;
      const bool in = pos < seq;
      const long long row = row_base + static_cast<long long>(pos) * p.heads;
      cp_async4(lse_s + buf * kQ + r, in ? p.lse + row : p.lse, in);
      cp_async4(delta_s + buf * kQ + r, in ? p.delta + row : p.delta, in);
    }
  };

  stage_rows<kTile, DMAX, kTcThreads>(k_s, kg, p.k_stride[1], k0, seq, dim);
  stage_rows<kTile, DMAX, kTcThreads>(v_s, vg, p.v_stride[1], k0, seq, dim);
  stage_partner(qt_lo, 0);
  cp_async_commit();

  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
  const int key0 = k0 + warp * 16 + g;     // this lane's keys: key0, key0 + 8
  const bf16* kw = k_s + warp * 16 * kLd;  // this warp's K rows
  const bf16* vw = v_s + warp * 16 * kLd;
  float dk[kNd][4], dv[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = qt_lo; qt <= qt_hi; ++qt) {
    const int buf = (qt - qt_lo) & 1;
    if (qt < qt_hi) {  // the next tile (its lse/delta rows by cp.async)
      stage_partner(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qb = q_s + buf * kQ * kLd;
    const bf16* dob = do_s + buf * kQ * kLd;
    const float* lse_b = lse_s + buf * kQ;
    const float* delta_b = delta_s + buf * kQ;

    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 keys.
    float st[kNb][4], dpt[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t ka[4], va[4];
      load_a(ka, kw, kLd, ks * 16, lane);
      load_a(va, vw, kLd, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < kNb; j += 2) {
        uint32_t bq[4], bd[4];
        load_b_rows(bq, qb, kLd, j * 8, ks * 16, lane);
        load_b_rows(bd, dob, kLd, j * 8, ks * 16, lane);
        mma(st[j], ka, bq[0], bq[1]);
        mma(st[j + 1], ka, bq[2], bq[3]);
        mma(dpt[j], va, bd[0], bd[1]);
        mma(dpt[j + 1], va, bd[2], bd[3]);
      }
    }

    // P^T and dS^T on the fragments: element e of block j is key
    // key0 + 8 * (e >> 1), query column j * 8 + 2t + (e & 1).
    const int q0 = qt * kQ;
    const bool masked =
        q0 + kQ > seq || k0 + kTile > seq ||
        (p.causal && (q0 < k0 + kTile - 1 ||
                      (p.window && k0 <= q0 + kQ - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float pr = exp2f(fmaf(st[j][e], scale2, -lse_b[c] * kLog2e));
        if (masked) {
          const int q_pos = q0 + c;
          const int k_pos = key0 + (e >> 1) * 8;
          bool keep = q_pos < seq && k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          pr = keep ? pr : 0.f;
        }
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - delta_b[c]) * p.scale;
      }

    // dV += P^T.dO and dK += dS^T.Q, 16 queries a step.
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * ks], st[2 * ks + 1]);
      c_to_a(da, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bd[4], bq[4];
        load_b_cols(bd, dob, kLd, ks * 16, j * 8, lane);
        load_b_cols(bq, qb, kLd, ks * 16, j * 8, lane);
        mma(dv[j], pa, bd[0], bd[1]);
        mma(dv[j + 1], pa, bd[2], bd[3]);
        mma(dk[j], da, bq[0], bq[1]);
        mma(dk[j + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this tile's readers are done before it reloads
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = key0 + 8 * i;
    if (pos >= seq) continue;
    const long long off =
        ((static_cast<long long>(b) * seq + pos) * p.heads + h) * dim;
    bf16* dkg = static_cast<bf16*>(p.out0) + off;
    bf16* dvg = static_cast<bf16*>(p.out1) + off;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= dim) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkg + col) =
          __floats2bfloat162_rn(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + col) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// Head dims above 128: the wide kernels, f32 (FMA) and bf16 (mma.sync).
//
// A block owns its 64-row tile and one 128-column chunk of dQ (or of
// dK and dV; grid.y, flash_grid.cuh). S and dP run over the whole head
// dim, their operands staged slab by slab (64 columns in f32, 128 in
// bf16), then the block's products run over its chunk's columns of the
// partner operand alone (K for dQ; dO and Q for dV and dK). The
// registers stay those of the D 128 kernels at any D; the price is S
// and dP computed once a chunk. f32 stages the chunk's partner columns
// beside the slabs. bf16 visits its own chunk's slab last, so the
// partner slab then in shared memory is the chunk (the summation order
// of S differs between chunks, which share nothing), holds the block's
// own slabs (Q and dO; K and V) for the whole partner loop up to D 512
// and stages one again a partner tile above, and stages rows by
// 16-byte loads where every row starts on 16 bytes (the wrapper's
// flag), by 2-byte loads otherwise. bf16 on rows a TMA tensor map
// describes runs the Hopper kernels up to head dim 256 instead (DMAX
// 256, dispatch_wide); these serve bf16 broadcast or off-16-byte rows,
// head dims above 256, and f32.

constexpr int kF32Slab = 64;  // columns of a staged f32 slab
constexpr int kLdS = kF32Slab + 1;
constexpr int kLdW = kWideCols + 1;

constexpr size_t f32_wide_smem_bytes() {
  // Four slabs, two chunk tiles, two weight tiles, two rows.
  return sizeof(float) * (size_t)(4 * kTile * kLdS + 2 * kTile * kLdW +
                                  2 * kTile * kLdT + 2 * kTile);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_wide_kernel(const Params p) {
  constexpr int kCols = kWideCols / kThreadsX;
  extern __shared__ float smem[];
  float* q_s = smem;                  // slabs, [kTile][kLdS]
  float* do_s = q_s + kTile * kLdS;
  float* k_s = do_s + kTile * kLdS;
  float* v_s = k_s + kTile * kLdS;
  float* kc_s = v_s + kTile * kLdS;   // K's chunk, [kTile][kLdW]
  float* ds_s = kc_s + 2 * kTile * kLdW;  // [kTile][kLdT]
  float* lse_s = ds_s + 2 * kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kTile;
  const int c0 = blockIdx.y * kWideCols;  // this block's dQ columns
  const int seq = p.seq;
  const int dim = p.dim;

  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_stride[0] +
                     h * p.do_stride[2];

  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int pos = q0 + r;
    const long long row = (static_cast<long long>(b) * seq + pos) * p.heads + h;
    lse_s[r] = pos < seq ? p.lse[row] : 0.f;
    delta_s[r] = pos < seq ? p.delta[row] : 0.f;
  }

  // The key range this Q tile sees, as in flash_bwd_dq_kernel.
  const int q_last = min(q0 + kTile, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  float dq[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[a][c] = 0.f;

  for (int kt = k_lo / kTile; kt <= k_hi / kTile; ++kt) {
    const int k0 = kt * kTile;
    float s[kPer][kPer], dp[kPer][kPer];
    zero_tile(s);
    zero_tile(dp);
    for (int d0 = 0; d0 < dim; d0 += kF32Slab) {
      const int w = min(kF32Slab, dim - d0);
      __syncthreads();  // the last slab's (or tile's) readers are done
      stage<kF32Slab>(q_s, qg + d0, p.q_stride[1], q0, seq, w);
      stage<kF32Slab>(do_s, dog + d0, p.do_stride[1], q0, seq, w);
      stage<kF32Slab>(k_s, kg + d0, p.k_stride[1], k0, seq, w);
      stage<kF32Slab>(v_s, vg + d0, p.v_stride[1], k0, seq, w);
      __syncthreads();
      dot_tile_add<kF32Slab>(s, q_s, k_s, w, ty, tx);
      dot_tile_add<kF32Slab>(dp, do_s, v_s, w, ty, tx);
    }
    stage<kWideCols>(kc_s, kg + c0, p.k_stride[1], k0, seq, dim - c0);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int r = ty + kThreadsY * a;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kThreadsX * j;
        const int k_pos = k0 + c;
        const bool keep = q_pos < seq && k_pos < seq && sees(p, q_pos, k_pos);
        const float pr = keep ? expf(s[a][j] * p.scale - lse_s[r]) : 0.f;
        ds_s[r * kLdT + c] = pr * (dp[a][j] - delta_s[r]) * p.scale;
      }
    }
    __syncthreads();
    accumulate<kWideCols>(dq, ds_s, kc_s, ty, tx);
  }
  write_tile<kWideCols>(p.out0, dq, p, b, h, q0, ty, tx, c0);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_wide_kernel(const Params p) {
  constexpr int kCols = kWideCols / kThreadsX;
  extern __shared__ float smem[];
  float* k_s = smem;                  // slabs, [kTile][kLdS]
  float* v_s = k_s + kTile * kLdS;
  float* q_s = v_s + kTile * kLdS;
  float* do_s = q_s + kTile * kLdS;
  float* qc_s = do_s + kTile * kLdS;  // Q's and dO's chunks, [kTile][kLdW]
  float* doc_s = qc_s + kTile * kLdW;
  float* pt_s = doc_s + kTile * kLdW;  // p^T  [key][query]
  float* dst_s = pt_s + kTile * kLdT;  // ds^T [key][query]
  float* lse_s = dst_s + kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * kTile;
  const int c0 = blockIdx.y * kWideCols;  // this block's dK/dV columns
  const int seq = p.seq;
  const int dim = p.dim;

  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_stride[0] +
                     h * p.do_stride[2];

  // The query range that sees this key tile, as in flash_bwd_dkv_kernel.
  const int k_last = min(k0 + kTile, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;

  float dk[kPer][kCols], dv[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int qt = q_lo / kTile; qt <= q_hi / kTile; ++qt) {
    const int q0 = qt * kTile;
    float st[kPer][kPer], dpt[kPer][kPer];
    zero_tile(st);
    zero_tile(dpt);
    for (int d0 = 0; d0 < dim; d0 += kF32Slab) {
      const int w = min(kF32Slab, dim - d0);
      __syncthreads();  // the last slab's (or tile's) readers are done
      stage<kF32Slab>(k_s, kg + d0, p.k_stride[1], k0, seq, w);
      stage<kF32Slab>(v_s, vg + d0, p.v_stride[1], k0, seq, w);
      stage<kF32Slab>(q_s, qg + d0, p.q_stride[1], q0, seq, w);
      stage<kF32Slab>(do_s, dog + d0, p.do_stride[1], q0, seq, w);
      if (d0 == 0) {
        for (int r = threadIdx.x; r < kTile; r += kThreads) {
          const int pos = q0 + r;
          const long long row =
              (static_cast<long long>(b) * seq + pos) * p.heads + h;
          lse_s[r] = pos < seq ? p.lse[row] : 0.f;
          delta_s[r] = pos < seq ? p.delta[row] : 0.f;
        }
      }
      __syncthreads();
      // Transposed scores: rows are this block's keys, columns queries.
      dot_tile_add<kF32Slab>(st, k_s, q_s, w, ty, tx);
      dot_tile_add<kF32Slab>(dpt, v_s, do_s, w, ty, tx);
    }
    stage<kWideCols>(qc_s, qg + c0, p.q_stride[1], q0, seq, dim - c0);
    stage<kWideCols>(doc_s, dog + c0, p.do_stride[1], q0, seq, dim - c0);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int r = ty + kThreadsY * a;
      const int k_pos = k0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kThreadsX * j;
        const int q_pos = q0 + c;
        const bool keep = q_pos < seq && k_pos < seq && sees(p, q_pos, k_pos);
        const float pr = keep ? expf(st[a][j] * p.scale - lse_s[c]) : 0.f;
        pt_s[r * kLdT + c] = pr;
        dst_s[r * kLdT + c] = pr * (dpt[a][j] - delta_s[c]) * p.scale;
      }
    }
    __syncthreads();
    accumulate<kWideCols>(dv, pt_s, doc_s, ty, tx);
    accumulate<kWideCols>(dk, dst_s, qc_s, ty, tx);
  }
  write_tile<kWideCols>(p.out0, dk, p, b, h, k0, ty, tx, c0);
  write_tile<kWideCols>(p.out1, dv, p, b, h, k0, ty, tx, c0);
}

constexpr int kLdWide = kWideCols + 8;  // bf16 slab and chunk rows

size_t dq_wide_tc_smem_bytes(int dim) {
  // The Q and dO slabs held, a K and a V slab, [kTile][kLdWide] bf16
  // each.
  return sizeof(bf16) * (size_t)(2 * cea_grid::held_slabs(dim) + 2) *
         kTile * kLdWide;
}

__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_wide_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kLd = kLdWide;
  constexpr int kNb = kTile / 8;      // 8-key blocks of a score tile
  constexpr int kNd = kWideCols / 8;  // 8-column blocks of the dQ chunk
  constexpr int kTileSz = kTile * kLd;
  const int slabs = cea_grid::wide_chunks(p.dim);
  const bool held = slabs <= cea_grid::kHeldSlabs;  // Q and dO staged once
  const int n_held = held ? slabs : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [n_held][kTile][kLd]
  bf16* do_s = q_s + n_held * kTileSz;            // [n_held][kTile][kLd]
  bf16* k_s = do_s + n_held * kTileSz;            // slabs, [kTile][kLd]
  bf16* v_s = k_s + kTileSz;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  const int q0 = (pl.tiles - 1 - pl.rank) * kTile;
  const int c0 = blockIdx.y * kWideCols;  // this block's dQ columns
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] +
                    h * p.do_stride[2];

  // The key range this Q tile sees, as in flash_bwd_dq_kernel.
  const int q_last = min(q0 + kTile, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;

  // This lane's rows row0 and row0 + 8: lse in log2 units, and delta.
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + 8 * i;
    const long long row =
        (static_cast<long long>(b) * seq + pos) * p.heads + h;
    lse2[i] = pos < seq ? p.lse[row] * kLog2e : 0.f;
    delta[i] = pos < seq ? p.delta[row] : 0.f;
  }

  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
  if (held) {  // published by the K loop's first barrier
    for (int sl = 0; sl < slabs; ++sl) {
      const int d0 = sl * kWideCols;
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, q_s + sl * kTileSz, qg + d0, p.q_stride[1], q0, seq,
          dim - d0);
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, do_s + sl * kTileSz, dog + d0, p.do_stride[1], q0, seq,
          dim - d0);
    }
  }
  float dq[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = k_lo / kTile; kt <= k_hi / kTile; ++kt) {
    const int k0 = kt * kTile;
    // S = Q.K^T and dP = dO.V^T for this warp's 16 rows, slab by slab.
    float s[kNb][4], dp[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // The slabs in turn, this block's chunk last: its K slab is then
    // the K chunk of the dQ product.
    for (int i = 1; i <= slabs; ++i) {
      const int sl = (blockIdx.y + i) % slabs;
      const int d0 = sl * kWideCols;
      __syncthreads();  // the last slab's (or tile's) readers are done
      if (!held) {
        stage_rows_by<kTile, kWideCols, kTcThreads>(
            p.aligned, q_s, qg + d0, p.q_stride[1], q0, seq, dim - d0);
        stage_rows_by<kTile, kWideCols, kTcThreads>(
            p.aligned, do_s, dog + d0, p.do_stride[1], q0, seq, dim - d0);
      }
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, k_s, kg + d0, p.k_stride[1], k0, seq, dim - d0);
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, v_s, vg + d0, p.v_stride[1], k0, seq, dim - d0);
      __syncthreads();
      // This warp's Q and dO rows of the slab.
      const int own = ((held ? sl : 0) * kTile + warp * 16) * kLd;
      const bf16* qw = q_s + own;
      const bf16* dow = do_s + own;
      const int steps = (min(kWideCols, dim - d0) + 15) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t qa[4], da[4];
        load_a(qa, qw, kLd, ks * 16, lane);
        load_a(da, dow, kLd, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < kNb; j += 2) {
          uint32_t bk[4], bv[4];
          load_b_rows(bk, k_s, kLd, j * 8, ks * 16, lane);
          load_b_rows(bv, v_s, kLd, j * 8, ks * 16, lane);
          mma(s[j], qa, bk[0], bk[1]);
          mma(s[j + 1], qa, bk[2], bk[3]);
          mma(dp[j], da, bv[0], bv[1]);
          mma(dp[j + 1], da, bv[2], bv[3]);
        }
      }
    }
    // P and dS on the fragments, as in flash_bwd_dq_tc_kernel.
    const bool masked =
        k0 + kTile > seq ||
        (p.causal && (k0 + kTile - 1 > q0 ||
                      (p.window && k0 <= q0 + kTile - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = exp2f(fmaf(s[j][e], scale2, -lse2[i]));
        if (masked) {
          const int q_pos = row0 + 8 * i;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          bool keep = k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          pr = keep ? pr : 0.f;
        }
        s[j][e] = pr * (dp[j][e] - delta[i]) * p.scale;
      }

    // dQ += dS.K over the chunk, dS in bf16 as the A operand.
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      c_to_a(a, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bk[4];
        load_b_cols(bk, k_s, kLd, ks * 16, j * 8, lane);
        mma(dq[j], a, bk[0], bk[1]);
        mma(dq[j + 1], a, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + 8 * i;
    if (pos >= seq) continue;
    bf16* dqg = static_cast<bf16*>(p.out0) +
                ((static_cast<long long>(b) * seq + pos) * p.heads + h) * dim;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < dim)
        *reinterpret_cast<__nv_bfloat162*>(dqg + col) =
            __floats2bfloat162_rn(dq[j][2 * i], dq[j][2 * i + 1]);
    }
  }
}

constexpr int kQWide = 32;  // queries a partner tile (dK/dV, bf16)

size_t dkv_wide_tc_smem_bytes(int dim) {
  // The K and V slabs held and a Q and a dO slab, in bf16; lse and
  // delta rows in f32.
  return sizeof(bf16) *
             (size_t)(2 * cea_grid::held_slabs(dim) * kTile + 2 * kQWide) *
             kLdWide +
         sizeof(float) * 2 * kQWide;
}

__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_wide_tc_kernel(const Params p) {
  using namespace cea_mma;
  constexpr int kQ = kQWide;
  constexpr int kLd = kLdWide;
  constexpr int kNb = kQ / 8;         // 8-query blocks of a score tile
  constexpr int kNd = kWideCols / 8;  // 8-column blocks of dK, dV chunks
  constexpr int kTileSz = kTile * kLd;
  const int slabs = cea_grid::wide_chunks(p.dim);
  const bool held = slabs <= cea_grid::kHeldSlabs;  // K and V staged once
  const int n_held = held ? slabs : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [n_held][kTile][kLd]
  bf16* v_s = k_s + n_held * kTileSz;             // [n_held][kTile][kLd]
  bf16* q_s = v_s + n_held * kTileSz;             // slabs, [kQ][kLd]
  bf16* do_s = q_s + kQ * kLd;
  float* lse_s = reinterpret_cast<float*>(do_s + kQ * kLd);  // [kQ]
  float* delta_s = lse_s + kQ;                                // [kQ]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * kTile;
  const int c0 = blockIdx.y * kWideCols;  // this block's dK/dV columns
  const int seq = p.seq;
  const int dim = p.dim;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_stride[0] +
                   h * p.q_stride[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_stride[0] +
                   h * p.k_stride[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_stride[0] +
                   h * p.v_stride[2];
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] +
                    h * p.do_stride[2];

  // The query range that sees this key tile, as in the f32 kernel.
  const int k_last = min(k0 + kTile, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;

  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
  const int key0 = k0 + warp * 16 + g;     // this lane's keys: key0, key0 + 8
  if (held) {  // published by the Q loop's first barrier
    for (int sl = 0; sl < slabs; ++sl) {
      const int d0 = sl * kWideCols;
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, k_s + sl * kTileSz, kg + d0, p.k_stride[1], k0, seq,
          dim - d0);
      stage_rows_by<kTile, kWideCols, kTcThreads>(
          p.aligned, v_s + sl * kTileSz, vg + d0, p.v_stride[1], k0, seq,
          dim - d0);
    }
  }
  float dk[kNd][4], dv[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = q_lo / kQ; qt <= q_hi / kQ; ++qt) {
    const int q0 = qt * kQ;
    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 keys, slab by
    // slab.
    float st[kNb][4], dpt[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    // The slabs in turn, this block's chunk last: its Q and dO slabs
    // are then the chunks of the dK and dV products.
    for (int i = 1; i <= slabs; ++i) {
      const int sl = (blockIdx.y + i) % slabs;
      const int d0 = sl * kWideCols;
      __syncthreads();  // the last slab's (or tile's) readers are done
      if (!held) {
        stage_rows_by<kTile, kWideCols, kTcThreads>(
            p.aligned, k_s, kg + d0, p.k_stride[1], k0, seq, dim - d0);
        stage_rows_by<kTile, kWideCols, kTcThreads>(
            p.aligned, v_s, vg + d0, p.v_stride[1], k0, seq, dim - d0);
      }
      stage_rows_by<kQ, kWideCols, kTcThreads>(
          p.aligned, q_s, qg + d0, p.q_stride[1], q0, seq, dim - d0);
      stage_rows_by<kQ, kWideCols, kTcThreads>(
          p.aligned, do_s, dog + d0, p.do_stride[1], q0, seq, dim - d0);
      if (i == 1) {
        for (int r = threadIdx.x; r < kQ; r += kTcThreads) {
          const int pos = q0 + r;
          const long long row =
              (static_cast<long long>(b) * seq + pos) * p.heads + h;
          lse_s[r] = pos < seq ? p.lse[row] : 0.f;
          delta_s[r] = pos < seq ? p.delta[row] : 0.f;
        }
      }
      __syncthreads();
      // This warp's K and V rows of the slab.
      const int own = ((held ? sl : 0) * kTile + warp * 16) * kLd;
      const bf16* kw = k_s + own;
      const bf16* vw = v_s + own;
      const int steps = (min(kWideCols, dim - d0) + 15) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t ka[4], va[4];
        load_a(ka, kw, kLd, ks * 16, lane);
        load_a(va, vw, kLd, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < kNb; j += 2) {
          uint32_t bq[4], bd[4];
          load_b_rows(bq, q_s, kLd, j * 8, ks * 16, lane);
          load_b_rows(bd, do_s, kLd, j * 8, ks * 16, lane);
          mma(st[j], ka, bq[0], bq[1]);
          mma(st[j + 1], ka, bq[2], bq[3]);
          mma(dpt[j], va, bd[0], bd[1]);
          mma(dpt[j + 1], va, bd[2], bd[3]);
        }
      }
    }

    // P^T and dS^T on the fragments, as in flash_bwd_dkv_tc_kernel.
    const bool masked =
        q0 + kQ > seq || k0 + kTile > seq ||
        (p.causal && (q0 < k0 + kTile - 1 ||
                      (p.window && k0 <= q0 + kQ - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float pr = exp2f(fmaf(st[j][e], scale2, -lse_s[c] * kLog2e));
        if (masked) {
          const int q_pos = q0 + c;
          const int k_pos = key0 + (e >> 1) * 8;
          bool keep = q_pos < seq && k_pos < seq;
          if (p.causal) {
            keep = keep && q_pos >= k_pos;
            if (p.window) keep = keep && k_pos > q_pos - p.window;
          }
          pr = keep ? pr : 0.f;
        }
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - delta_s[c]) * p.scale;
      }

    // dV += P^T.dO and dK += dS^T.Q over the chunks, 16 queries a step.
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * ks], st[2 * ks + 1]);
      c_to_a(da, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int j = 0; j < kNd; j += 2) {
        uint32_t bd[4], bq[4];
        load_b_cols(bd, do_s, kLd, ks * 16, j * 8, lane);
        load_b_cols(bq, q_s, kLd, ks * 16, j * 8, lane);
        mma(dv[j], pa, bd[0], bd[1]);
        mma(dv[j + 1], pa, bd[2], bd[3]);
        mma(dk[j], da, bq[0], bq[1]);
        mma(dk[j + 1], da, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = key0 + 8 * i;
    if (pos >= seq) continue;
    const long long off =
        ((static_cast<long long>(b) * seq + pos) * p.heads + h) * dim;
    bf16* dkg = static_cast<bf16*>(p.out0) + off;
    bf16* dvg = static_cast<bf16*>(p.out1) + off;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col >= dim) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkg + col) =
          __floats2bfloat162_rn(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + col) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// dK/dV, bf16: the Hopper kernel (wgmma + TMA).

// Parameters of the Hopper kernel: the tensor maps of q, k, v and dO
// (read in place from the caller's strides) beside the common ones.
struct TmaParams {
  CUtensorMap tq, tk, tv, tdo;
  Params p;
};

// One block: WG consumer warpgroups and a producer (a warpgroup; one
// warp at DMAX 256). Up to DMAX 128 each consumer owns 64 keys (the
// block's key tile is 64 * WG) and every column of their dK and dV. At
// DMAX 256 (kSplit) dK and dV
// of 64 keys take 256 f32 registers a thread, more than one warpgroup
// holds, so a block owns one 64-key tile and its two consumers split
// the columns: each holds 128 columns of dK and dV (kOwnChunks 64-column
// chunks, 128 registers) and computes kQHalf = 32 of a Q/dO tile's 64
// query columns of S^T and dP^T, and the two hand each other their
// halves of P^T and dS^T in bf16 through shared memory (kPdsBytes a
// tile, two buffers) behind a named barrier, so every product runs
// once. The producer's first warp loads K and V once by TMA, then
// streams Q/dO tiles of kQ queries by TMA with their lse and delta rows
// (plain loads by its 32 lanes) through a ring of kStages. kQ is 64, or
// 32 at DMAX 128, where dK and dV alone take 128 accumulator registers
// a thread.
template <int DMAX, int WG>
struct DkvWg {
  static constexpr bool kSplit = DMAX > 128;
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kKeys = kSplit ? 64 : 64 * WG;
  static constexpr int kQ = DMAX == 128 ? 32 : 64;
  static constexpr int kQHalf = kQ / WG;
  static constexpr int kOwnChunks = kSplit ? kChunks / WG : kChunks;
  // K and V as register A operands of the score products (D 64 only).
  static constexpr bool kHoldKV = DMAX <= 64;
  static constexpr int kHeldSteps = kHoldKV ? DMAX / 16 : 1;
  // At DMAX 256 two 64 KB stages fit beside K, V and the P^T/dS^T
  // buffers; three do not.
  static constexpr int kStages = kSplit ? 2 : 3;
  // kSplit: no producer warpgroup (the consumers issue the loads) and no
  // setmaxnreg, so every thread may hold 255 registers. Beside a producer
  // warpgroup ptxas held these consumers to the block's 168 whatever
  // setmaxnreg gave them, spilled and serialized the wgmma; a producer
  // warp alone (288 threads) is charged registers as a warpgroup.
  static constexpr int kThreads = 128 * (kSplit ? WG : WG + 1);
  static constexpr int kMinBlocks = WG == 2 ? 1 : 2;
  static constexpr int kRegsProducer = kSplit ? 0 : 24;
  static constexpr int kRegsConsumer = kSplit ? 0 : WG == 2 ? 240 : 232;
  static constexpr int kChunkK = kKeys * cea_hopper::kRowBytes;
  static constexpr int kKBytes = kChunks * kChunkK;  // K or V
  static constexpr int kChunkQ = kQ * cea_hopper::kRowBytes;
  static constexpr int kQBytes = kChunks * kChunkQ;  // Q or dO
  static constexpr int kStageBytes = 2 * kQBytes;
  // P^T, then dS^T: [kKeys][kQ] bf16 each, one swizzled chunk.
  static constexpr int kPdsBytes = kSplit ? 2 * kKeys * kQ * 2 : 0;
  static constexpr size_t smem_bytes() {
    // Alignment slack, K, V, the Q/dO ring, the P^T/dS^T buffers, the
    // lse/delta ring, the barriers (and K's and V's addresses).
    return 1024 + 2 * kKBytes + kStages * kStageBytes + 2 * kPdsBytes +
           sizeof(float) * kStages * 2 * kQ +
           sizeof(uint64_t) * (1 + 2 * kStages + (kSplit ? 1 : 0));
  }
  static_assert(!kSplit || (WG == 2 && kQ == cea_hopper::kChunkCols &&
                            kChunks % WG == 0),
                "the column split: two consumers, one 64-query chunk");
  static_assert(smem_bytes() <= 232448, "an H100 block's shared memory");
};

// S^T = K.Q^T and dP^T = V.dO^T of one ring stage (`qd`: its Q tile,
// then its dO tile) for one warpgroup's keys: issued and committed as
// one wgmma group, not waited for. At D 64 K and V are register A
// operands (`kf`, `vf`, loaded once), so a tile reads only Q and dO
// from shared memory; at D 128 they stay in shared memory (`k_w`,
// `v_w`), where dK and dV leave no registers for them.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_scores(
    float (&st)[DkvWg<DMAX, WG>::kQ / 2],
    float (&dpt)[DkvWg<DMAX, WG>::kQ / 2],
    const uint32_t (&kf)[DkvWg<DMAX, WG>::kHeldSteps][4],
    const uint32_t (&vf)[DkvWg<DMAX, WG>::kHeldSteps][4],
    const unsigned char* k_w, const unsigned char* v_w,
    const unsigned char* qd) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  if constexpr (C::kHoldKV) {
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_rs_n64<0>(st, kf[kk], kmajor_desc(qd, C::kChunkQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_rs_n64<0>(dpt, vf[kk],
                      kmajor_desc(qd + C::kQBytes, C::kChunkQ, kk), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss<C::kQ, 0>(st, kmajor_desc(k_w, C::kChunkK, kk),
                         kmajor_desc(qd, C::kChunkQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss<C::kQ, 0>(dpt, kmajor_desc(v_w, C::kChunkK, kk),
                         kmajor_desc(qd + C::kQBytes, C::kChunkQ, kk),
                         kk > 0);
  }
  wgmma_commit();
}

// One query tile's second half for one warpgroup: P^T and dS^T on the
// score accumulators (element e is key key0 + 8 ((e >> 1) & 1), query
// column 8 (e >> 2) + 2t + (e & 1) of the tile at q0), rounded to bf16
// as register A operands; then dV += P^T.dO and dK += dS^T.Q (dO and
// Q the MN-major B operands, 16 queries a step), issued and committed
// as one wgmma group, not waited for.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_update(
    float (&st)[DkvWg<DMAX, WG>::kQ / 2],
    float (&dpt)[DkvWg<DMAX, WG>::kQ / 2],
    float (&dk)[DMAX / 64][32], float (&dv)[DMAX / 64][32],
    uint32_t (&pa)[DkvWg<DMAX, WG>::kQ / 16][4],
    uint32_t (&da)[DkvWg<DMAX, WG>::kQ / 16][4], const unsigned char* qd,
    const float* lse_b, const float* delta_b, const Params& p, int q0,
    int kw, int key0, int t, float scale2) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  constexpr int kQ = C::kQ;
  const int seq = p.seq;
  fence_regs(st);
  fence_regs(dpt);
  const bool masked =
      q0 + kQ > seq || kw + 64 > seq ||
      (p.causal &&
       (q0 < kw + 63 || (p.window && kw <= q0 + kQ - 1 - p.window)));
#pragma unroll
  for (int e = 0; e < kQ / 2; ++e) {
    const int col = (e >> 2) * 8 + 2 * t + (e & 1);
    float pr = fast_exp2(fmaf(st[e], scale2, -lse_b[col]));
    if (masked) {
      const int q_pos = q0 + col;
      const int k_pos = key0 + ((e >> 1) & 1) * 8;
      bool keep = q_pos < seq && k_pos < seq;
      if (p.causal) {
        keep = keep && q_pos >= k_pos;
        if (p.window) keep = keep && k_pos > q_pos - p.window;
      }
      pr = keep ? pr : 0.f;
    }
    st[e] = pr;
    dpt[e] = pr * (dpt[e] - delta_b[col]) * p.scale;
  }
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    acc_to_a(pa[kk], st, kk);
    acc_to_a(da[kk], dpt, kk);
  }
  __syncwarp();  // this warp's reads of lse/delta are done
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    fence_regs(dv[c]);
    fence_regs(dk[c]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      wgmma_rs_n64<1>(dv[c], pa[kk],
                      mnmajor_desc(qd + C::kQBytes, C::kChunkQ, c, kk));
      wgmma_rs_n64<1>(dk[c], da[kk], mnmajor_desc(qd, C::kChunkQ, c, kk));
    }
  wgmma_commit();
}

// The block's work up to DMAX 128: each consumer warpgroup owns 64
// keys and every column of their dK and dV.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_own_keys(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  constexpr int kStages = C::kStages;
  constexpr int kQ = C::kQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);
  unsigned char* v_s = k_s + C::kKBytes;
  unsigned char* qd_s = v_s + C::kKBytes;  // stage s: Q, then dO
  float* rows_s = reinterpret_cast<float*>(qd_s + kStages * C::kStageBytes);
  // stage s: lse (log2 units) at rows_s + 2 s kQ, delta after it
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * kQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const Params& p = tp.p;
  const Place pl = place(p.batch, p.heads, p.seq, C::kKeys);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 =
      (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * C::kKeys;
  const int seq = p.seq;
  // The query range that sees the block's keys, as in the f32 kernel.
  const int k_last = min(k0 + C::kKeys, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;
  const int qt_lo = q_lo / kQ, qt_hi = q_hi / kQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);       // the producer warp's lanes
      mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == WG) {
    setmaxnreg_dec<C::kRegsProducer>();
    if (threadIdx.x < 128 * WG + 32) {
      // lse and delta of (b, position, h) at (b * seq + pos) * heads + h.
      const long long row_base = static_cast<long long>(b) * seq * p.heads + h;
      if (lane == 0) {
        tma_prefetch_map(&tp.tq);
        tma_prefetch_map(&tp.tdo);
        mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(k_s + c * C::kChunkK, &tp.tk, kv_full, 64 * c, h, k0, b);
          tma_load_4d(v_s + c * C::kChunkK, &tp.tv, kv_full, 64 * c, h, k0, b);
        }
      }
      for (int qt = qt_lo, i = 0; qt <= qt_hi; ++qt, ++i) {
        const int s = i % kStages;
        const int q0 = qt * kQ;
        // This tile's lse and delta rows, read before the slot frees.
        float lv[kQ / 32], dv_[kQ / 32];
#pragma unroll
        for (int u = 0; u < kQ / 32; ++u) {
          const int pos = q0 + lane + 32 * u;
          const bool in = pos < seq;
          const long long row =
              row_base + static_cast<long long>(pos) * p.heads;
          lv[u] = in ? p.lse[row] * kLog2e : 0.f;
          dv_[u] = in ? p.delta[row] : 0.f;
        }
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* lse_s = rows_s + 2 * s * kQ;
#pragma unroll
        for (int u = 0; u < kQ / 32; ++u) {
          lse_s[lane + 32 * u] = lv[u];
          lse_s[kQ + lane + 32 * u] = dv_[u];
        }
        if (lane == 0) {
          unsigned char* qs = qd_s + s * C::kStageBytes;
          mbar_arrive_expect_tx(&full[s], C::kStageBytes);
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(qs + c * C::kChunkQ, &tp.tq, &full[s], 64 * c, h, q0,
                        b);
            tma_load_4d(qs + C::kQBytes + c * C::kChunkQ, &tp.tdo, &full[s],
                        64 * c, h, q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys kw .. kw + 63.
    setmaxnreg_inc<C::kRegsConsumer>();
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + 64 * wg;
    const int key0 = kw + warp * 16 + g;  // this lane's keys: key0, +8
    const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
    const unsigned char* k_w = k_s + 64 * wg * kRowBytes;
    const unsigned char* v_w = v_s + 64 * wg * kRowBytes;
    // This warpgroup computes query tiles [c_lo, c_hi] of the block's
    // range; the others see none of its keys (before its causal
    // diagonal, past its window band, or keys past the length), and it
    // only waits for them and releases them, in ring order.
    const int kw_last = min(kw + 63, seq - 1);
    const int c_lo = max(qt_lo, p.causal ? kw / kQ : 0);
    const int c_hi =
        kw >= seq ? -1
                  : ((p.causal && p.window)
                         ? min(seq - 1, kw_last + p.window - 1) / kQ
                         : qt_hi);
    int i = 0;  // ring position of query tile qt_lo + i
    auto release = [&](int n) {
      for (; n > 0; --n, ++i) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
      }
    };
    float st[kQ / 2], dpt[kQ / 2];

    float dk[C::kChunks][32], dv[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;
    uint32_t pa[kQ / 16][4], da[kQ / 16][4];

    if (c_lo > c_hi) {
      release(qt_hi - qt_lo + 1);
    } else {
      release(c_lo - qt_lo);
      mbar_wait(kv_full, 0);
      uint32_t kf[C::kHeldSteps][4], vf[C::kHeldSteps][4];
      if constexpr (C::kHoldKV) {
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
          load_a_sw128(kf[kk], k_w, C::kChunkK, kk, warp, lane);
          load_a_sw128(vf[kk], v_w, C::kChunkK, kk, warp, lane);
        }
      }
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wgmma_fence();
      dkv_scores<DMAX, WG>(st, dpt, kf, vf, k_w, v_w,
                           qd_s + (i % kStages) * C::kStageBytes);
      wgmma_wait<0>();
      // Each tile but the last: its dV/dK products, then the next
      // tile's scores queued behind them on the tensor cores.
      for (int qt = c_lo; qt < c_hi; ++qt, ++i) {
        const int s = i % kStages;
        const int next = i + 1;
        const float* lse_b = rows_s + 2 * s * kQ;
        mbar_wait(&full[next % kStages], (next / kStages) & 1);
        dkv_update<DMAX, WG>(st, dpt, dk, dv, pa, da,
                             qd_s + s * C::kStageBytes, lse_b, lse_b + kQ,
                             p, qt * kQ, kw, key0, t, scale2);
        dkv_scores<DMAX, WG>(st, dpt, kf, vf, k_w, v_w,
                             qd_s + (next % kStages) * C::kStageBytes);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      {
        const int s = i % kStages;
        const float* lse_b = rows_s + 2 * s * kQ;
        dkv_update<DMAX, WG>(st, dpt, dk, dv, pa, da,
                             qd_s + s * C::kStageBytes, lse_b, lse_b + kQ,
                             p, c_hi * kQ, kw, key0, t, scale2);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        if (lane == 0) mbar_arrive(&empty[s]);
        ++i;
      }
      release(qt_hi - c_hi);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = key0 + 8 * r;
        if (pos >= seq) continue;
        const long long off =
            ((static_cast<long long>(b) * seq + pos) * p.heads + h) * p.dim;
        bf16* dkg = static_cast<bf16*>(p.out0) + off;
        bf16* dvg = static_cast<bf16*>(p.out1) + off;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + j * 8 + 2 * t;
            if (col >= p.dim) continue;
            *reinterpret_cast<__nv_bfloat162*>(dkg + col) =
                __floats2bfloat162_rn(dk[c][4 * j + 2 * r],
                                      dk[c][4 * j + 2 * r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dvg + col) =
                __floats2bfloat162_rn(dv[c][4 * j + 2 * r],
                                      dv[c][4 * j + 2 * r + 1]);
          }
      }
    }
  }
}

// S^T and dP^T of one ring stage (`qd`: its Q tile, then its dO tile)
// for consumer `wg` of the column split: its kQHalf query columns
// against the block's 64 keys (K and V the A operands from shared
// memory, m64n32 over the whole head dim), issued and committed as one
// wgmma group, not waited for.
//
// K's and V's shared addresses come from `kv_addr` (shared memory), read
// at each call: their 32 descriptors are then formed beside their wgmma
// inside the loop. Hoisted out of it, as the compilers do with
// addresses they see are fixed, they held 64 registers across it.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_split_scores(
    float (&st)[DkvWg<DMAX, WG>::kQHalf / 2],
    float (&dpt)[DkvWg<DMAX, WG>::kQHalf / 2], const uint32_t* kv_addr,
    const unsigned char* qd, int wg) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  const uint32_t k_a = ld_shared_volatile(kv_addr);
  const uint32_t v_a = ld_shared_volatile(kv_addr + 1);
  // Rows kQHalf * wg .. of every chunk: whole 8-row swizzle groups.
  const unsigned char* qh = qd + wg * C::kQHalf * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss<C::kQHalf, 0>(st, kmajor_desc_at(k_a, C::kChunkK, kk),
                           kmajor_desc(qh, C::kChunkQ, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss<C::kQHalf, 0>(dpt, kmajor_desc_at(v_a, C::kChunkK, kk),
                           kmajor_desc(qh + C::kQBytes, C::kChunkQ, kk),
                           kk > 0);
  wgmma_commit();
}

// dV += P^T.dO and dK += dS^T.Q over the tile's kQ queries for
// consumer `wg`'s columns (its kOwnChunks chunks): P^T and dS^T the
// K-major A operands from the shared buffer `pds`, dO and Q the
// MN-major B operands from the stage `qd`; issued and committed as one
// wgmma group, not waited for.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_split_update(
    float (&dk)[DkvWg<DMAX, WG>::kOwnChunks][32],
    float (&dv)[DkvWg<DMAX, WG>::kOwnChunks][32], const unsigned char* pds,
    const unsigned char* qd, int wg) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  const unsigned char* ds = pds + C::kPdsBytes / 2;
#pragma unroll
  for (int kk = 0; kk < C::kQ / 16; ++kk)
#pragma unroll
    for (int c = 0; c < C::kOwnChunks; ++c) {
      const int chunk = C::kOwnChunks * wg + c;
      wgmma_ss_n64<1>(dv[c], kmajor_desc(pds, 0, kk),
                      mnmajor_desc(qd + C::kQBytes, C::kChunkQ, chunk, kk),
                      1);
      wgmma_ss_n64<1>(dk[c], kmajor_desc(ds, 0, kk),
                      mnmajor_desc(qd, C::kChunkQ, chunk, kk), 1);
    }
  wgmma_commit();
}

// Consumer `wg`'s half of P^T and dS^T for the query tile at q0 from
// its score accumulators (element e is key key0 + 8 ((e >> 1) & 1),
// query column 8 (e >> 2) + 2t + (e & 1) of its kQHalf columns; `rows`:
// the stage's lse of those columns, their delta kQ after): P^T =
// exp2(S^T * scale * log2 e - lse * log2 e), zero where a mask drops
// the pair (exp2 on the special-function unit alone), and dS^T = P^T *
// (dP^T - delta) * scale, each pair written as bf16 into buffer `pds`
// (its query columns of the [64 keys][kQ] swizzled tiles, P^T then
// dS^T) as soon as it is formed; then the stores are made visible to
// wgmma.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_split_terms(
    float (&st)[DkvWg<DMAX, WG>::kQHalf / 2],
    float (&dpt)[DkvWg<DMAX, WG>::kQHalf / 2], const float* rows,
    const Params& p, int k0, int q0, int key0, int wg, int warp, int g,
    int t, float scale2, unsigned char* pds) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  const int seq = p.seq;
  const float* lse_b = rows;
  const float* delta_b = lse_b + C::kQ;
  const int qc = q0 + C::kQHalf * wg;  // this consumer's first query
  const bool masked =
      k0 + C::kKeys > seq || q0 + C::kQ > seq ||
      (p.causal && (q0 < k0 + C::kKeys - 1 ||
                    (p.window && k0 <= q0 + C::kQ - 1 - p.window)));
  fence_regs(st);
  fence_regs(dpt);
#pragma unroll
  for (int e = 0; e < C::kQHalf / 2; e += 2) {
    float pr[2], ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = (e >> 2) * 8 + 2 * t + u;
      pr[u] = fast_exp2(fmaf(st[e + u], scale2, -lse_b[col] * kLog2e));
      if (masked) {
        const int q_pos = qc + col;
        const int k_pos = key0 + ((e >> 1) & 1) * 8;
        bool keep = q_pos < seq && k_pos < seq;
        if (p.causal) {
          keep = keep && q_pos >= k_pos;
          if (p.window) keep = keep && k_pos > q_pos - p.window;
        }
        pr[u] = keep ? pr[u] : 0.f;
      }
      ds[u] = pr[u] * (dpt[e + u] - delta_b[col]) * p.scale;
    }
    const int row = warp * 16 + g + ((e >> 1) & 1) * 8;
    const int col = C::kQHalf * wg + (e >> 2) * 8 + 2 * t;
    store_sw128_pair(pds, row, col, pr[0], pr[1]);
    store_sw128_pair(pds + C::kPdsBytes / 2, row, col, ds[0], ds[1]);
  }
  fence_proxy_async();
}

// The loads of query tile qt (ring slot `slot`) for the column split,
// issued by the consumers themselves: thread 0 the Q and dO tiles by
// TMA, the first warp's lanes the tile's lse and delta rows by
// cp.async (zeros past the sequence), each lane arriving on the slot's
// barrier once its copies land.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_split_load(
    const TmaParams& tp, unsigned char* qd_s, float* rows_s, uint64_t* full,
    int slot, int qt, int b, int h) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  constexpr int kQ = C::kQ;
  const Params& p = tp.p;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int q0 = qt * kQ;
  if (lane == 0) {
    unsigned char* qs = qd_s + slot * C::kStageBytes;
    mbar_arrive_expect_tx(&full[slot], C::kStageBytes);
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(qs + c * C::kChunkQ, &tp.tq, &full[slot], 64 * c, h, q0,
                  b);
      tma_load_4d(qs + C::kQBytes + c * C::kChunkQ, &tp.tdo, &full[slot],
                  64 * c, h, q0, b);
    }
  }
  // lse and delta of (b, position, h) at (b * seq + pos) * heads + h.
  float* lse_s = rows_s + 2 * slot * kQ;
  const long long row_base = static_cast<long long>(b) * p.seq * p.heads + h;
#pragma unroll
  for (int u = 0; u < kQ / 32; ++u) {
    const int pos = q0 + lane + 32 * u;
    const bool in = pos < p.seq;
    const long long row =
        in ? row_base + static_cast<long long>(pos) * p.heads : row_base;
    cea_mma::cp_async4(lse_s + lane + 32 * u, p.lse + row, in);
    cea_mma::cp_async4(lse_s + kQ + lane + 32 * u, p.delta + row, in);
  }
  cp_async_mbar_arrive(&full[slot]);
}

// The block's work at DMAX 256 (DkvWg::kSplit): one 64-key tile, two
// consumer warpgroups splitting its columns, and no producer
// warpgroup: the consumers load K and V, and each query tile into the
// ring's slot the tile two before it used, past the named barrier at
// which both consumers have finished with that slot
// (dkv_split_load). For each Q/dO tile i but the last a consumer queues
// its products of tile i (reading buffer i % 2), then the scores of
// tile i + 1, whose load lands while the products run, on the tensor
// cores; once both are in it writes its half of P^T and dS^T of tile
// i + 1 into buffer (i + 1) % 2 and meets the other consumer at the
// named barrier. Buffer (i + 1) % 2 was last read by the products of
// tile i - 1, which both consumers finished before the barrier of tile
// i. Both consumers see the same query tiles, so each meets every
// barrier.
template <int DMAX, int WG>
__device__ __forceinline__ void dkv_split_cols(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = DkvWg<DMAX, WG>;
  constexpr int kStages = C::kStages;
  constexpr int kQ = C::kQ;
  constexpr int kOwn = C::kOwnChunks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);
  unsigned char* v_s = k_s + C::kKBytes;
  unsigned char* qd_s = v_s + C::kKBytes;  // stage s: Q, then dO
  // buffer u: P^T, then dS^T
  unsigned char* pds_s = qd_s + kStages * C::kStageBytes;
  float* rows_s = reinterpret_cast<float*>(pds_s + 2 * C::kPdsBytes);
  // stage s: lse at rows_s + 2 s kQ, delta after it
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * kQ);
  uint64_t* full = kv_full + 1;  // [kStages]: the slot's tile landed
  // K's and V's shared addresses (dkv_split_scores).
  uint32_t* kv_addr = reinterpret_cast<uint32_t*>(full + kStages);

  const Params& p = tp.p;
  const Place pl = place(p.batch, p.heads, p.seq, C::kKeys);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? pl.rank : pl.tiles - 1 - pl.rank) * C::kKeys;
  const int seq = p.seq;
  // The query range that sees the block's keys, as in the f32 kernel.
  const int k_last = min(k0 + C::kKeys, seq) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      (p.causal && p.window) ? min(seq - 1, k_last + p.window - 1) : seq - 1;
  const int qt_lo = q_lo / kQ;
  const int n = q_hi / kQ - qt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    // Thread 0's expect_tx arrival and one cp.async arrival a lane of
    // the first warp.
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1 + 32);
    kv_addr[0] = smem_u32(k_s);
    kv_addr[1] = smem_u32(v_s);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch_map(&tp.tq);
    tma_prefetch_map(&tp.tdo);
    mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(k_s + c * C::kChunkK, &tp.tk, kv_full, 64 * c, h, k0, b);
      tma_load_4d(v_s + c * C::kChunkK, &tp.tv, kv_full, 64 * c, h, k0, b);
    }
  }
  for (int i = 0; i < kStages && i < n; ++i)
    dkv_split_load<DMAX, WG>(tp, qd_s, rows_s, full, i, qt_lo + i, b, h);

  // Consumer warpgroup wg: query columns kQHalf * wg .. of each tile's
  // scores, chunks kOwnChunks * wg .. of dK and dV.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, +8
  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
  auto stage = [&](int i) { return qd_s + (i % kStages) * C::kStageBytes; };
  // The stage's lse and delta rows of this consumer's query columns.
  auto lse_rows = [&](int i) {
    return rows_s + 2 * (i % kStages) * kQ + C::kQHalf * wg;
  };
  auto wait_tile = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  };

  float st[C::kQHalf / 2], dpt[C::kQHalf / 2];
  float dk[kOwn][32], dv[kOwn][32];
#pragma unroll
  for (int c = 0; c < kOwn; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;

  // The first tile: its scores, then its half of P^T and dS^T into
  // buffer 0.
  mbar_wait(kv_full, 0);
  wait_tile(0);
  wgmma_fence();
  dkv_split_scores<DMAX, WG>(st, dpt, kv_addr, stage(0), wg);
  wgmma_wait<0>();
  dkv_split_terms<DMAX, WG>(st, dpt, lse_rows(0), p, k0, qt_lo * kQ, key0,
                            wg, warp, g, t, scale2, pds_s);
  named_barrier_sync(1, 128 * WG);
  for (int i = 0; i + 1 < n; ++i) {
    const int next = i + 1;
    wgmma_fence();
    dkv_split_update<DMAX, WG>(dk, dv, pds_s + (i & 1) * C::kPdsBytes,
                               stage(i), wg);
    wait_tile(next);
    dkv_split_scores<DMAX, WG>(st, dpt, kv_addr, stage(next), wg);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOwn; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    dkv_split_terms<DMAX, WG>(st, dpt, lse_rows(next), p, k0,
                              (qt_lo + next) * kQ, key0, wg, warp, g, t,
                              scale2, pds_s + (next & 1) * C::kPdsBytes);
    named_barrier_sync(1, 128 * WG);
    // Both consumers are done with tile i's slot: load tile i + kStages.
    if (i + kStages < n)
      dkv_split_load<DMAX, WG>(tp, qd_s, rows_s, full, i % kStages,
                               qt_lo + i + kStages, b, h);
  }
  // The last tile's products.
  wgmma_fence();
  dkv_split_update<DMAX, WG>(dk, dv, pds_s + ((n - 1) & 1) * C::kPdsBytes,
                             stage(n - 1), wg);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    fence_regs(dv[c]);
    fence_regs(dk[c]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = key0 + 8 * r;
    if (pos >= seq) continue;
    const long long off =
        ((static_cast<long long>(b) * seq + pos) * p.heads + h) * p.dim;
    bf16* dkg = static_cast<bf16*>(p.out0) + off;
    bf16* dvg = static_cast<bf16*>(p.out1) + off;
#pragma unroll
    for (int c = 0; c < kOwn; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (kOwn * wg + c) + j * 8 + 2 * t;
        if (col >= p.dim) continue;
        *reinterpret_cast<__nv_bfloat162*>(dkg + col) =
            __floats2bfloat162_rn(dk[c][4 * j + 2 * r],
                                  dk[c][4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + col) =
            __floats2bfloat162_rn(dv[c][4 * j + 2 * r],
                                  dv[c][4 * j + 2 * r + 1]);
      }
  }
}

template <int DMAX, int WG>
__global__ void __launch_bounds__(DkvWg<DMAX, WG>::kThreads,
                                  DkvWg<DMAX, WG>::kMinBlocks)
flash_bwd_dkv_wgmma_tc_kernel(const __grid_constant__ TmaParams tp) {
  if constexpr (DkvWg<DMAX, WG>::kSplit)
    dkv_split_cols<DMAX, WG>(tp);
  else
    dkv_own_keys<DMAX, WG>(tp);
}

template <int DMAX, int WG>
cudaError_t launch_dkv_wg_n(const Params& p, cudaStream_t stream) {
  using C = DkvWg<DMAX, WG>;
  auto kernel = flash_bwd_dkv_wgmma_tc_kernel<DMAX, WG>;
  const size_t smem = C::smem_bytes();
  cudaError_t err = cea_hopper::prepare_launch<C>(
      kernel, C::kThreads, WG, C::kRegsProducer, C::kRegsConsumer, smem);
  if (err != cudaSuccess) return err;
  TmaParams tp;
  tp.p = p;
  const long long* strides[4] = {p.q_stride, p.k_stride, p.v_stride,
                                 p.do_stride};
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  CUtensorMap* maps[4] = {&tp.tq, &tp.tk, &tp.tv, &tp.tdo};
  for (int i = 0; i < 4; ++i) {
    const long long st[3] = {strides[i][0], strides[i][1], strides[i][2]};
    const bool keys = i == 1 || i == 2;
    err = cea_hopper::encode_rows(maps[i], bases[i], p.batch, p.seq,
                                  p.heads, p.dim, st,
                                  keys ? C::kKeys : C::kQ);
    if (err != cudaSuccess) return err;
  }
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, C::kKeys, 1, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, smem, stream>>>(tp);
  return cudaGetLastError();
}

// Two consumer warpgroups (128-key tiles, one block an SM) once the
// grid of such tiles fills the card's 132 SMs; otherwise one. At DMAX
// 256 always two, splitting a 64-key tile's columns (2048 blocks at
// [4, 2048, 16, 256]).
template <int DMAX>
cudaError_t launch_dkv_wg(const Params& p, cudaStream_t stream) {
  if constexpr (DkvWg<DMAX, 2>::kSplit) {
    return launch_dkv_wg_n<DMAX, 2>(p, stream);
  } else {
    const long long tiles128 =
        static_cast<long long>(p.batch) * p.heads * ((p.seq + 127) / 128);
    return tiles128 >= 132 ? launch_dkv_wg_n<DMAX, 2>(p, stream)
                           : launch_dkv_wg_n<DMAX, 1>(p, stream);
  }
}

// ---------------------------------------------------------------------
// dQ, bf16: the Hopper kernel (wgmma + TMA).

// One block: WG consumer warpgroups of 64 query rows each (the block's
// Q tile is 64 * WG rows) and one producer warpgroup whose first thread
// loads Q and dO once by TMA, then streams K/V tiles of 64 keys by TMA
// through a ring of kStages. Unlike dK/dV, a consumer's lse and delta
// rows are fixed for the whole loop, so they sit in its registers and
// need no ring. At DMAX 256 (kWide: kernel head dims 136-256) a block
// is one consumer, one block an SM (dq_wide_body): Q and dO take 64 KB,
// K and V stream through rings of their own (kKStages and kVStages
// tiles of 32 KB), and the consumer holds dQ in 128 f32 registers a
// thread beside S and dP (64) and dS's A operands (16).
template <int DMAX, int WG>
struct DqWg {
  static constexpr bool kWide = DMAX > 128;
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kRowsQ = 64 * WG;
  // Q and dO as register A operands of the score products where the
  // budget holds them, at D 64 with one consumer (232 registers a
  // thread): dQ, S and dP take 96, dS's A operands 16, Q and dO 32
  // more. With three consumers (160 registers) and at D 128 (dQ alone
  // 64) they stay in shared memory.
  static constexpr bool kHoldQ = DMAX <= 64 && WG == 1;
  static constexpr int kHeldSteps = kHoldQ ? DMAX / 16 : 1;
  // Three stages where they fit, two where two blocks an SM at D 128
  // would not (kWide: kKStages and kVStages).
  static constexpr int kStages = (WG == 1 && DMAX > 64) ? 2 : 3;
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr int kMinBlocks = (WG == 1 && !kWide) ? 2 : 1;
  // A lone consumer at one block an SM takes what the block holds (the
  // 256-thread block's 255 registers a thread to start with).
  static constexpr int kRegsProducer = kWide ? 56 : 24;
  static constexpr int kRegsConsumer =
      kWide ? 256 : WG == 1 ? 232 : WG == 2 ? 240 : 160;
  static constexpr int kChunkQ = kRowsQ * cea_hopper::kRowBytes;
  static constexpr int kQBytes = kChunks * kChunkQ;  // Q or dO
  static constexpr int kChunkK = kTile * cea_hopper::kRowBytes;
  static constexpr int kKBytes = kChunks * kChunkK;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKBytes;
  // kWide: V is read by the score products alone, so its slot frees
  // once a tile's scores are in; K is read again by the tile's dQ
  // product, a tile later. Three K stages and two V stages keep each
  // load a tile ahead of its use, where one ring of two K/V stages
  // freed a slot only as the tile after it began.
  static constexpr int kKStages = 3;
  static constexpr int kVStages = 2;
  static constexpr size_t smem_bytes() {
    // Alignment slack, Q and dO, the K/V ring (kWide: the K ring and the
    // V ring), the barriers (kWide: and Q's and dO's addresses).
    return kWide ? 1024 + 2 * kQBytes + (kKStages + kVStages) * kKBytes +
                       sizeof(uint64_t) * (2 + 2 * (kKStages + kVStages))
                 : 1024 + 2 * kQBytes + kStages * kStageBytes +
                       sizeof(uint64_t) * (1 + 2 * kStages);
  }
  static_assert(!kWide || WG == 1, "D 256: one consumer");
  static_assert(smem_bytes() <= 232448, "an H100 block's shared memory");
};

// S = Q.K^T and dP = dO.V^T of one ring stage (`kv`: its K tile, then
// its V tile) for one warpgroup's rows: issued and committed as one
// wgmma group, not waited for. K and V are K-major B operands; Q and dO
// are register A operands (`qf`, `df`, loaded once) where C::kHoldQ,
// otherwise read from shared memory (`q_w`, `do_w`).
template <int DMAX, int WG>
__device__ __forceinline__ void dq_scores(
    float (&s)[32], float (&dp)[32],
    const uint32_t (&qf)[DqWg<DMAX, WG>::kHeldSteps][4],
    const uint32_t (&df)[DqWg<DMAX, WG>::kHeldSteps][4],
    const unsigned char* q_w, const unsigned char* do_w,
    const unsigned char* kv) {
  using namespace cea_hopper;
  using C = DqWg<DMAX, WG>;
  if constexpr (C::kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_rs_n64<0>(s, qf[kk], kmajor_desc(kv, C::kChunkK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_rs_n64<0>(dp, df[kk],
                      kmajor_desc(kv + C::kKBytes, C::kChunkK, kk), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss_n64<0>(s, kmajor_desc(q_w, C::kChunkQ, kk),
                      kmajor_desc(kv, C::kChunkK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss_n64<0>(dp, kmajor_desc(do_w, C::kChunkQ, kk),
                      kmajor_desc(kv + C::kKBytes, C::kChunkK, kk), kk > 0);
  }
  wgmma_commit();
}

// dS of one K/V tile for one warpgroup, in place on the score
// accumulator `s` (element e is row row0 + 8 ((e >> 1) & 1), key k0 +
// 8 (e >> 2) + 2t + (e & 1)): P = exp2(S * scale * log2 e - lse *
// log2 e), zero where `masked` and a mask drops the pair, then
// dS = P * (dP * scale - delta * scale), `delta` holding delta * scale.
__device__ __forceinline__ void dq_ds(
    float (&s)[32], const float (&dp)[32], const float (&lse2)[2],
    const float (&delta)[2], const Params& p, int k0, int row0, int t,
    bool masked, float scale2) {
  using namespace cea_hopper;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    float pr = fast_exp2(fmaf(s[e], scale2, -lse2[r]));
    if (masked) {
      const int q_pos = row0 + 8 * r;
      const int k_pos = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
      bool keep = k_pos < p.seq;
      if (p.causal) {
        keep = keep && q_pos >= k_pos;
        if (p.window) keep = keep && k_pos > q_pos - p.window;
      }
      pr = keep ? pr : 0.f;
    }
    s[e] = pr * fmaf(dp[e], p.scale, -delta[r]);
  }
}

// dQ += dS.K for one warpgroup: dS the register A operand (`dsa`, 16
// keys a step), K the MN-major B operand (`ks`: the stage's K tile, no
// transposing load); issued and committed as one wgmma group, not
// waited for.
template <int DMAX, int WG>
__device__ __forceinline__ void dq_product(float (&dq)[DMAX / 64][32],
                                           const uint32_t (&dsa)[kTile / 16][4],
                                           const unsigned char* ks) {
  using namespace cea_hopper;
  using C = DqWg<DMAX, WG>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      wgmma_rs_n64<1>(dq[c], dsa[kk], mnmajor_desc(ks, C::kChunkK, c, kk));
  wgmma_commit();
}

// The block's work up to DMAX 128: WG consumer warpgroups of 64 query
// rows each, one K/V ring.
template <int DMAX, int WG>
__device__ __forceinline__ void dq_own_rows(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = DqWg<DMAX, WG>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* do_s = q_s + C::kQBytes;
  unsigned char* kv_s = do_s + C::kQBytes;  // stage s: K, then V
  uint64_t* qd_full =
      reinterpret_cast<uint64_t*>(kv_s + kStages * C::kStageBytes);
  uint64_t* full = qd_full + 1;      // [kStages]: K/V tile landed
  uint64_t* empty = full + kStages;  // [kStages]: every consumer done

  const Params& p = tp.p;
  const Place pl = place(p.batch, p.heads, p.seq, C::kRowsQ);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the last Q tiles see the most keys; run them first.
  const int q0 = (pl.tiles - 1 - pl.rank) * C::kRowsQ;
  const int seq = p.seq;
  // The key range the block's Q tile sees, as in the f32 kernel.
  const int q_last = min(q0 + C::kRowsQ, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kTile, kt_hi = k_hi / kTile;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // Producer: Q and dO once, then the K/V tiles through the ring.
    setmaxnreg_dec<C::kRegsProducer>();
    if (threadIdx.x == 128 * WG) {
      tma_prefetch_map(&tp.tk);
      tma_prefetch_map(&tp.tv);
      mbar_arrive_expect_tx(qd_full, 2 * C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(q_s + c * C::kChunkQ, &tp.tq, qd_full, 64 * c, h, q0, b);
        tma_load_4d(do_s + c * C::kChunkQ, &tp.tdo, qd_full, 64 * c, h, q0,
                    b);
      }
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        unsigned char* ks = kv_s + s * C::kStageBytes;
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(ks + c * C::kChunkK, &tp.tk, &full[s], 64 * c, h,
                      kt * kTile, b);
          tma_load_4d(ks + C::kKBytes + c * C::kChunkK, &tp.tv, &full[s],
                      64 * c, h, kt * kTile, b);
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
    const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
    const unsigned char* q_w = q_s + 64 * wg * kRowBytes;
    const unsigned char* do_w = do_s + 64 * wg * kRowBytes;
    // This warpgroup computes tiles [c_lo, c_hi] of the block's range;
    // the others are masked for all its rows (past its causal
    // diagonal, before its window edge, or rows past the length), and
    // it only waits for them and releases them, in ring order.
    const int c_lo =
        max(kt_lo, (p.causal && p.window) ? max(0, r0 - p.window + 1) / kTile
                                          : 0);
    const int c_hi =
        r0 >= seq ? -1 : (p.causal ? min(r0 + 63, seq - 1) / kTile : kt_hi);
    int i = 0;  // ring position of tile kt_lo + i
    auto release = [&](int n) {
      for (; n > 0; --n, ++i) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
      }
    };
    // A tile's scores need their masks if a mask can reach one of them.
    auto masked = [&](int k0) {
      return k0 + kTile > seq ||
             (p.causal && (k0 + kTile - 1 > r0 ||
                           (p.window && k0 <= r0 + 63 - p.window)));
    };

    if (c_lo > c_hi) {
      release(kt_hi - kt_lo + 1);
    } else {
      release(c_lo - kt_lo);
      // This lane's rows' lse (log2 units) and delta * scale, for every
      // tile.
      float lse2[2], delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = row0 + 8 * r;
        const long long row =
            (static_cast<long long>(b) * seq + pos) * p.heads + h;
        lse2[r] = pos < seq ? p.lse[row] * kLog2e : 0.f;
        delta[r] = pos < seq ? p.delta[row] * p.scale : 0.f;
      }
      float dq[C::kChunks][32];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
      float s[32], dp[32];
      uint32_t dsa[kTile / 16][4];
      uint32_t qf[C::kHeldSteps][4], df[C::kHeldSteps][4];
      mbar_wait(qd_full, 0);
      if constexpr (C::kHoldQ) {
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
          load_a_sw128(qf[kk], q_w, C::kChunkQ, kk, warp, lane);
          load_a_sw128(df[kk], do_w, C::kChunkQ, kk, warp, lane);
        }
      }
      // The first tile: its scores, then its dS.
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wgmma_fence();
      dq_scores<DMAX, WG>(s, dp, qf, df, q_w, do_w,
                          kv_s + (i % kStages) * C::kStageBytes);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dq_ds(s, dp, lse2, delta, p, c_lo * kTile, row0, t,
            masked(c_lo * kTile), scale2);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(dsa[kk], s, kk);
      // Each tile but the last: the next tile's scores, then this
      // tile's dQ product on the tensor cores; the next tile's dS runs
      // once the scores are in, while the product is in flight (it
      // reads `dsa` and writes `dq`, which dS leaves alone, so ptxas
      // keeps the wgmma asynchronous).
      for (int kt = c_lo; kt < c_hi; ++kt, ++i) {
        const int st = i % kStages;
        const int next = i + 1;
        mbar_wait(&full[next % kStages], (next / kStages) & 1);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
        wgmma_fence();
        dq_scores<DMAX, WG>(s, dp, qf, df, q_w, do_w,
                            kv_s + (next % kStages) * C::kStageBytes);
        dq_product<DMAX, WG>(dq, dsa, kv_s + st * C::kStageBytes);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        dq_ds(s, dp, lse2, delta, p, (kt + 1) * kTile, row0, t,
              masked((kt + 1) * kTile), scale2);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
        if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(dsa[kk], s, kk);
      }
      {  // the last tile's dQ product
        const int st = i % kStages;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
        wgmma_fence();
        dq_product<DMAX, WG>(dq, dsa, kv_s + st * C::kStageBytes);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
        if (lane == 0) mbar_arrive(&empty[st]);
        ++i;
      }
      release(kt_hi - c_hi);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = row0 + 8 * r;
        if (pos >= seq) continue;
        bf16* dqg = static_cast<bf16*>(p.out0) +
                    ((static_cast<long long>(b) * seq + pos) * p.heads + h) *
                        p.dim;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + j * 8 + 2 * t;
            if (col < p.dim)
              *reinterpret_cast<__nv_bfloat162*>(dqg + col) =
                  __floats2bfloat162_rn(dq[c][4 * j + 2 * r],
                                        dq[c][4 * j + 2 * r + 1]);
          }
      }
    }
  }
}

// S = Q.K^T and dP = dO.V^T for the lone consumer at DMAX 256, Q and
// dO from shared memory at the addresses `qd_addr` holds, K and V from
// their own rings (`k_t`, `v_t`): issued and committed as one wgmma
// group, not waited for. Q's and dO's addresses are read at each call
// (as K's and V's in dkv_split_scores): their 32 descriptors are formed
// beside their wgmma, not held in 64 registers across the loop.
template <int DMAX>
__device__ __forceinline__ void dq_wide_scores(
    float (&s)[32], float (&dp)[32], const uint32_t* qd_addr,
    const unsigned char* k_t, const unsigned char* v_t) {
  using namespace cea_hopper;
  using C = DqWg<DMAX, 1>;
  const uint32_t q_a = ld_shared_volatile(qd_addr);
  const uint32_t do_a = ld_shared_volatile(qd_addr + 1);
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss_n64<0>(s, kmajor_desc_at(q_a, C::kChunkQ, kk),
                    kmajor_desc(k_t, C::kChunkK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss_n64<0>(dp, kmajor_desc_at(do_a, C::kChunkQ, kk),
                    kmajor_desc(v_t, C::kChunkK, kk), kk > 0);
  wgmma_commit();
}

// The block's work at DMAX 256 (DqWg::kWide): one consumer warpgroup on
// 64 query rows, every key tile of their range. Per tile it queues the
// next tile's scores and this tile's dQ product, frees the next tile's
// V slot once the scores are in, forms the next dS while the product
// runs, then frees this tile's K slot.
template <int DMAX>
__device__ __forceinline__ void dq_wide_body(const TmaParams& tp) {
  using namespace cea_hopper;
  using C = DqWg<DMAX, 1>;
  constexpr int kKStages = C::kKStages;
  constexpr int kVStages = C::kVStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* do_s = q_s + C::kQBytes;
  unsigned char* k_ring = do_s + C::kQBytes;
  unsigned char* v_ring = k_ring + kKStages * C::kKBytes;
  uint64_t* qd_full =
      reinterpret_cast<uint64_t*>(v_ring + kVStages * C::kKBytes);
  uint64_t* k_full = qd_full + 1;        // [kKStages]: K tile landed
  uint64_t* k_empty = k_full + kKStages;  // [kKStages]: its products done
  uint64_t* v_full = k_empty + kKStages;  // [kVStages]
  uint64_t* v_empty = v_full + kVStages;  // [kVStages]: its scores done
  // Q's and dO's shared addresses (dq_wide_scores).
  uint32_t* qd_addr = reinterpret_cast<uint32_t*>(v_empty + kVStages);

  const Params& p = tp.p;
  const Place pl = place(p.batch, p.heads, p.seq, kTile);
  const int b = pl.b;
  const int h = pl.h;
  // Causal: the last Q tiles see the most keys; run them first.
  const int q0 = (pl.tiles - 1 - pl.rank) * kTile;
  const int seq = p.seq;
  // The key range the block's Q tile sees, as in the f32 kernel.
  const int q_last = min(q0 + kTile, seq) - 1;
  const int k_hi = p.causal ? q_last : seq - 1;
  const int k_lo = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_lo / kTile, kt_hi = k_hi / kTile;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 4);
    }
    qd_addr[0] = smem_u32(q_s);
    qd_addr[1] = smem_u32(do_s);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: Q and dO once, then each key tile's K and V.
    setmaxnreg_dec<C::kRegsProducer>();
    if (threadIdx.x == 128) {
      tma_prefetch_map(&tp.tk);
      tma_prefetch_map(&tp.tv);
      mbar_arrive_expect_tx(qd_full, 2 * C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(q_s + c * C::kChunkQ, &tp.tq, qd_full, 64 * c, h, q0, b);
        tma_load_4d(do_s + c * C::kChunkQ, &tp.tdo, qd_full, 64 * c, h, q0,
                    b);
      }
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int sk = i % kKStages, sv = i % kVStages;
        mbar_wait(&k_empty[sk], ((i / kKStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[sk], C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(k_ring + sk * C::kKBytes + c * C::kChunkK, &tp.tk,
                      &k_full[sk], 64 * c, h, kt * kTile, b);
        mbar_wait(&v_empty[sv], ((i / kVStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&v_full[sv], C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(v_ring + sv * C::kKBytes + c * C::kChunkK, &tp.tv,
                      &v_full[sv], 64 * c, h, kt * kTile, b);
      }
    }
  } else {
    setmaxnreg_inc<C::kRegsConsumer>();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x / 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, +8
    const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x * log2 e)
    auto k_tile = [&](int i) { return k_ring + (i % kKStages) * C::kKBytes; };
    auto v_tile = [&](int i) { return v_ring + (i % kVStages) * C::kKBytes; };
    auto wait_kv = [&](int i) {
      mbar_wait(&k_full[i % kKStages], (i / kKStages) & 1);
      mbar_wait(&v_full[i % kVStages], (i / kVStages) & 1);
    };
    // A tile's scores need their masks if a mask can reach one of them.
    auto masked = [&](int k0) {
      return k0 + kTile > seq ||
             (p.causal && (k0 + kTile - 1 > q0 ||
                           (p.window && k0 <= q0 + kTile - 1 - p.window)));
    };
    // This lane's rows' lse (log2 units) and delta * scale.
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = row0 + 8 * r;
      const long long row =
          (static_cast<long long>(b) * seq + pos) * p.heads + h;
      lse2[r] = pos < seq ? p.lse[row] * kLog2e : 0.f;
      delta[r] = pos < seq ? p.delta[row] * p.scale : 0.f;
    }
    float dq[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
    float s[32], dp[32];
    uint32_t dsa[kTile / 16][4];
    mbar_wait(qd_full, 0);
    // The first tile: its scores, then its dS.
    wait_kv(0);
    wgmma_fence();
    dq_wide_scores<DMAX>(s, dp, qd_addr, k_tile(0), v_tile(0));
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&v_empty[0]);
    fence_regs(s);
    fence_regs(dp);
    dq_ds(s, dp, lse2, delta, p, kt_lo * kTile, row0, t,
          masked(kt_lo * kTile), scale2);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(dsa[kk], s, kk);
    // Each tile but the last: the next tile's scores, then this tile's
    // dQ product; the next dS once the scores are in, while the product
    // runs.
    const int n = kt_hi - kt_lo + 1;
    for (int i = 0; i + 1 < n; ++i) {
      const int next = i + 1;
      wait_kv(next);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
      wgmma_fence();
      dq_wide_scores<DMAX>(s, dp, qd_addr, k_tile(next), v_tile(next));
      dq_product<DMAX, 1>(dq, dsa, k_tile(i));
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&v_empty[next % kVStages]);
      fence_regs(s);
      fence_regs(dp);
      dq_ds(s, dp, lse2, delta, p, (kt_lo + next) * kTile, row0, t,
            masked((kt_lo + next) * kTile), scale2);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
      if (lane == 0) mbar_arrive(&k_empty[i % kKStages]);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(dsa[kk], s, kk);
    }
    {  // the last tile's dQ product
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
      wgmma_fence();
      dq_product<DMAX, 1>(dq, dsa, k_tile(n - 1));
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_regs(dq[c]);
      if (lane == 0) mbar_arrive(&k_empty[(n - 1) % kKStages]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = row0 + 8 * r;
      if (pos >= seq) continue;
      bf16* dqg = static_cast<bf16*>(p.out0) +
                  ((static_cast<long long>(b) * seq + pos) * p.heads + h) *
                      p.dim;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + j * 8 + 2 * t;
          if (col < p.dim)
            *reinterpret_cast<__nv_bfloat162*>(dqg + col) =
                __floats2bfloat162_rn(dq[c][4 * j + 2 * r],
                                      dq[c][4 * j + 2 * r + 1]);
        }
    }
  }
}

template <int DMAX, int WG>
__global__ void __launch_bounds__(DqWg<DMAX, WG>::kThreads,
                                  DqWg<DMAX, WG>::kMinBlocks)
flash_bwd_dq_wgmma_tc_kernel(const __grid_constant__ TmaParams tp) {
  if constexpr (DqWg<DMAX, WG>::kWide)
    dq_wide_body<DMAX>(tp);
  else
    dq_own_rows<DMAX, WG>(tp);
}

template <int DMAX, int WG>
cudaError_t launch_dq_wg_n(const Params& p, cudaStream_t stream) {
  using C = DqWg<DMAX, WG>;
  auto kernel = flash_bwd_dq_wgmma_tc_kernel<DMAX, WG>;
  const size_t smem = C::smem_bytes();
  cudaError_t err = cea_hopper::prepare_launch<C>(
      kernel, C::kThreads, WG, C::kRegsProducer, C::kRegsConsumer, smem);
  if (err != cudaSuccess) return err;
  TmaParams tp;
  tp.p = p;
  const long long* strides[4] = {p.q_stride, p.k_stride, p.v_stride,
                                 p.do_stride};
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  CUtensorMap* maps[4] = {&tp.tq, &tp.tk, &tp.tv, &tp.tdo};
  for (int i = 0; i < 4; ++i) {
    const long long st[3] = {strides[i][0], strides[i][1], strides[i][2]};
    const bool keys = i == 1 || i == 2;
    err = cea_hopper::encode_rows(maps[i], bases[i], p.batch, p.seq,
                                  p.heads, p.dim, st,
                                  keys ? kTile : C::kRowsQ);
    if (err != cudaSuccess) return err;
  }
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, C::kRowsQ, 1, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, smem, stream>>>(tp);
  return cudaGetLastError();
}

// As the forward: three consumer warpgroups (192-row Q tiles, Q and dO
// read from shared memory) at D 64 and two (128-row) at D 128, one
// block an SM, once the grid of such tiles fills the card's 132 SMs;
// otherwise one (64-row tiles, two blocks an SM). At [8, 2048, 8, 64]
// three consumers took 0.178 ms and two 0.215, whether two held Q and
// dO in registers or read them from shared memory (flash_bench.py on
// an NVIDIA H100 80GB HBM3 at 700 W, before the dS step overlapped the
// dQ product): the third warpgroup's dS step hides behind the others'
// products. At DMAX 256 always one (64-row tiles, one block an SM;
// 2048 blocks at [4, 2048, 16, 256]).
template <int DMAX>
cudaError_t launch_dq_wg(const Params& p, cudaStream_t stream) {
  if constexpr (DqWg<DMAX, 1>::kWide) {
    return launch_dq_wg_n<DMAX, 1>(p, stream);
  } else {
    constexpr int kWg = DMAX == 64 ? 3 : 2;
    const long long tiles = static_cast<long long>(p.batch) * p.heads *
                            ((p.seq + 64 * kWg - 1) / (64 * kWg));
    return tiles >= 132 ? launch_dq_wg_n<DMAX, kWg>(p, stream)
                        : launch_dq_wg_n<DMAX, 1>(p, stream);
  }
}

// 64-row tiles over every head, and `chunks` column chunks (the wide
// kernels; 1 otherwise).
template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem, int threads,
                   cudaStream_t stream, int chunks = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = cea_grid::grid_of(p.batch, p.heads, p.seq, kTile, chunks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16 goes to the tensor-core kernels (the Hopper kernels where a
// tensor map describes the rows, the mma.sync ones otherwise), f32 to
// the FMA kernels.
template <int DMAX>
cudaError_t dispatch(const Params& p, int dtype, bool dkv,
                     cudaStream_t stream) {
  if (dtype == 0)
    return dkv ? launch(flash_bwd_dkv_kernel<DMAX>, p,
                        f32_smem_bytes(DMAX), kThreads, stream)
               : launch(flash_bwd_dq_kernel<DMAX>, p,
                        f32_smem_bytes(DMAX), kThreads, stream);
  if (dtype == 1 && p.aligned)
    return dkv ? launch_dkv_wg<DMAX>(p, stream) : launch_dq_wg<DMAX>(p, stream);
  if (dtype == 1)
    return dkv ? launch(flash_bwd_dkv_tc_kernel<DMAX>, p,
                        DkvTc<DMAX>::smem_bytes(), kTcThreads, stream)
               : launch(flash_bwd_dq_tc_kernel<DMAX>, p,
                        DqTc<DMAX>::smem_bytes(), kTcThreads, stream);
  return cudaErrorInvalidValue;
}

// Head dims above 128. bf16 whose rows a tensor map describes (the
// route kRouteHopper, which the wrapper passes up to kernel head dim
// kHopperWideDim) runs the Hopper kernels at DMAX 256; every other
// input the wide kernels: f32 on FMA, bf16 on mma.sync with rows staged
// by 16-byte loads (2, the wrapper's ROUTE_ROWS16) or by 2-byte loads
// (0).
cudaError_t dispatch_wide(const Params& p, int dtype, bool dkv,
                          cudaStream_t stream) {
  if (dtype == 1 && p.aligned == kRouteHopper) {
    if (p.dim > kHopperWideDim) return cudaErrorInvalidValue;
    return dkv ? launch_dkv_wg<kHopperWideDim>(p, stream)
               : launch_dq_wg<kHopperWideDim>(p, stream);
  }
  const int chunks = cea_grid::wide_chunks(p.dim);
  if (dtype == 0)
    return dkv ? launch(flash_bwd_dkv_f32_wide_kernel, p,
                        f32_wide_smem_bytes(), kThreads, stream, chunks)
               : launch(flash_bwd_dq_f32_wide_kernel, p,
                        f32_wide_smem_bytes(), kThreads, stream, chunks);
  if (dtype == 1)
    return dkv ? launch(flash_bwd_dkv_wide_tc_kernel, p,
                        dkv_wide_tc_smem_bytes(p.dim), kTcThreads, stream,
                        chunks)
               : launch(flash_bwd_dq_wide_tc_kernel, p,
                        dq_wide_tc_smem_bytes(p.dim), kTcThreads, stream,
                        chunks);
  return cudaErrorInvalidValue;
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1,
        int dtype, int batch, int seq, int heads, int dim,
        const long long* strides, int causal, int window, float scale,
        int aligned, void* stream, bool dkv) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.dim = dim;
  for (int i = 0; i < 3; ++i) {
    p.q_stride[i] = strides[i];
    p.k_stride[i] = strides[3 + i];
    p.v_stride[i] = strides[6 + i];
    p.do_stride[i] = strides[9 + i];
  }
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.aligned = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim > kWideCols)
    return static_cast<int>(dispatch_wide(p, dtype, dkv, st));
  return static_cast<int>(dim > 64 ? dispatch<128>(p, dtype, dkv, st)
                                   : dispatch<64>(p, dtype, dkv, st));
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; strides in
// elements, (batch, seq, head) for q, k, v, dO in that order. `aligned`
// is the route (`kernel_route`): kRouteHopper (1)
// when a TMA tensor map can read q, k, v and dO in place (16-byte base,
// every stepped stride a nonzero multiple of 16 bytes) up to head dim
// 256: bf16 dQ and dK/dV take the Hopper kernels; otherwise the
// mma.sync kernels, up to 128 with 2-byte loads (0), above 128 the wide
// kernels with 16-byte staging (2, every row on 16 bytes) or 2-byte
// staging (0).
// Return the cudaError_t of the launch (0 = success); the caller
// raises on anything else. The wrapper has checked shapes, types, that
// the head dim is contiguous and that lse and delta are contiguous
// [B, S, H] f32, and hands over a head dim that is a multiple of 8
// (any, padded) with the true head dim's scale.
#define CEA_BWD_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, void *out0, void *out1, int dtype, \
      int batch, int seq, int heads, int dim, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,        \
      long long v_sb, long long v_ss, long long v_sh, long long do_sb,       \
      long long do_ss, long long do_sh, int causal, int window, float scale, \
      int aligned, void *stream

#define CEA_BWD_STRIDES                                                   \
  const long long strides[12] = {q_sb,  q_ss,  q_sh,  k_sb, k_ss, k_sh, \
                                 v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh}

// dQ into out0 (out1 unused).
extern "C" int cea_flash_bwd_dq(CEA_BWD_ARGS) {
  CEA_BWD_STRIDES;
  return run(q, k, v, dout, lse, delta, out0, out1, dtype, batch, seq, heads,
             dim, strides, causal, window, scale, aligned, stream, false);
}

// dK into out0, dV into out1.
extern "C" int cea_flash_bwd_dkv(CEA_BWD_ARGS) {
  CEA_BWD_STRIDES;
  return run(q, k, v, dout, lse, delta, out0, out1, dtype, batch, seq, heads,
             dim, strides, causal, window, scale, aligned, stream, true);
}
