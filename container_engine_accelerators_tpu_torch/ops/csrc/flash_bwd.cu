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
// bound is feeding them.
//
// Four kernels, two per role, chosen by the input type. bf16 runs on
// the tensor cores (mma.m16n8k16 bf16 with f32 accumulators, the
// helpers of mma_bf16.cuh), with 128-thread blocks of 4 warps, each
// warp owning 16 rows of the block's tile; partner tiles come in
// double-buffered by 16-byte cp.async (2-byte loads where a row does
// not start on 16 bytes); masks are evaluated only on the tiles a mask
// can touch (the diagonal, the window edge, the ragged end), and
// scores run in log2 units (exp2, scale * log2 e folded in).
//
// dQ, bf16 (`flash_bwd_dq_tc_kernel`): the forward's structure with two
//   products before the softmax step. One block per (batch*head,
//   64-row Q tile); Q and dO staged once and held as A fragments in
//   registers (re-read from shared memory at each step at DMAX 128,
//   where dQ's accumulators leave no room for them); this lane's two
//   rows of lse (in log2 units) and delta in registers; 64-key K/V
//   tiles from the window's lower edge to the causal diagonal (the
//   bounds of `_dq_kernel`, attention.py:183-185, at this tile size).
//   Per tile: S = Q.K^T and dP = dO.V^T (K and V as B operands);
//   P = exp2(S * scale * log2 e - lse * log2 e) and dS = P * (dP -
//   delta) * scale on the fragments; then dQ += dS.K with dS rounded to
//   bf16 as the A operand straight from the registers and K through
//   ldmatrix.trans. dQ stays in f32 registers for the whole loop and is
//   written once.
// dK/dV, bf16 (`flash_bwd_dkv_tc_kernel`): one block per (batch*head,
//   64-key tile); K and V staged once; Q and dO tiles (64 queries, 32
//   at D > 64 to keep the accumulators in registers) with their lse
//   and delta rows, between the causal lower bound and the window's
//   upper bound (`_dkv_kernel`, attention.py:212-215). Per tile,
//   transposed (rows are the block's keys): S^T = K.Q^T and dP^T =
//   V.dO^T; P^T and dS^T on the fragments; then dV += P^T.dO and dK +=
//   dS^T.Q with P^T and dS^T rounded to bf16 as A operands from the
//   registers (dO and Q through ldmatrix.trans). dK and dV stay in f32
//   registers for the whole loop.
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

#include "mma_bf16.cuh"

namespace {

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
  int aligned;  // every q/k/v/dO row starts on 16 bytes
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

// acc[a][b] = sum_c x[row(a)][c] * y[col(b)][c] over the first `dim`
// columns: rows ty + 16a of x, rows tx + 16b of y.
template <int DMAX>
__device__ __forceinline__ void dot_tile(float (&acc)[kPer][kPer],
                                         const float* x, const float* y,
                                         int dim, int ty, int tx) {
  constexpr int kLd = DMAX + 1;
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) acc[a][b] = 0.f;
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
// [B, S, H, D] output.
template <int DMAX>
__device__ __forceinline__ void write_tile(
    void* out, const float (&acc)[kPer][DMAX / kThreadsX], const Params& p,
    int b, int h, int r0, int ty, int tx) {
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
      const int col = tx + kThreadsX * c;
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kTile;
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int seq = p.seq;
  const int dim = p.dim;
  const bool aligned = p.aligned;

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

  stage_rows<kTile, DMAX, kTcThreads>(q_s, qg, p.q_stride[1], q0, seq, dim,
                                      aligned);
  stage_rows<kTile, DMAX, kTcThreads>(do_s, dog, p.do_stride[1], q0, seq,
                                      dim, aligned);
  stage_rows<kTile, DMAX, kTcThreads>(k_s, kg, p.k_stride[1], kt_lo * kTile,
                                      seq, dim, aligned);
  stage_rows<kTile, DMAX, kTcThreads>(v_s, vg, p.v_stride[1], kt_lo * kTile,
                                      seq, dim, aligned);
  cp_async_commit();

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
    if (kt < kt_hi) {  // the next tile loads while this one computes
      const int next = (kt + 1) * kTile;
      stage_rows<kTile, DMAX, kTcThreads>(k_s + (buf ^ 1) * kTileSz, kg,
                                          p.k_stride[1], next, seq, dim,
                                          aligned);
      stage_rows<kTile, DMAX, kTcThreads>(v_s + (buf ^ 1) * kTileSz, vg,
                                          p.v_stride[1], next, seq, dim,
                                          aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  // Causal: the first key tiles see the most queries; run them first.
  const int k0 = (p.causal ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kTile;
  const int seq = p.seq;
  const int dim = p.dim;
  const bool aligned = p.aligned;

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
                                     q0, seq, dim, aligned);
    stage_rows<kQ, DMAX, kTcThreads>(do_s + buf * kQ * kLd, dog,
                                     p.do_stride[1], q0, seq, dim, aligned);
    for (int r = threadIdx.x; r < kQ; r += kTcThreads) {
      const int pos = q0 + r;
      const bool in = pos < seq;
      const long long row = row_base + static_cast<long long>(pos) * p.heads;
      cp_async4(lse_s + buf * kQ + r, in ? p.lse + row : p.lse, in);
      cp_async4(delta_s + buf * kQ + r, in ? p.delta + row : p.delta, in);
    }
  };

  stage_rows<kTile, DMAX, kTcThreads>(k_s, kg, p.k_stride[1], k0, seq, dim,
                                      aligned);
  stage_rows<kTile, DMAX, kTcThreads>(v_s, vg, p.v_stride[1], k0, seq, dim,
                                      aligned);
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
    if (qt < qt_hi) {  // the next tile loads while this one computes
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem, int threads,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.seq + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16 goes to the tensor-core kernels, f32 to the FMA kernels.
template <int DMAX>
cudaError_t dispatch(const Params& p, int dtype, bool dkv,
                     cudaStream_t stream) {
  if (dtype == 0)
    return dkv ? launch(flash_bwd_dkv_kernel<DMAX>, p,
                        f32_smem_bytes(DMAX), kThreads, stream)
               : launch(flash_bwd_dq_kernel<DMAX>, p,
                        f32_smem_bytes(DMAX), kThreads, stream);
  if (dtype == 1)
    return dkv ? launch(flash_bwd_dkv_tc_kernel<DMAX>, p,
                        DkvTc<DMAX>::smem_bytes(), kTcThreads, stream)
               : launch(flash_bwd_dq_tc_kernel<DMAX>, p,
                        DqTc<DMAX>::smem_bytes(), kTcThreads, stream);
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
  return static_cast<int>(dim > 64 ? dispatch<128>(p, dtype, dkv, st)
                                   : dispatch<64>(p, dtype, dkv, st));
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; strides in
// elements, (batch, seq, head) for q, k, v, dO in that order; aligned
// = 1 when every q/k/v/dO row starts on 16 bytes (read by the bf16
// kernels, which stage by 2-byte loads otherwise). Return
// the cudaError_t of the launch (0 = success); the caller raises on
// anything else. The wrapper has checked shapes, types, the head dim
// (<= 128, multiple of 8) and that it is contiguous, and that lse and
// delta are contiguous [B, S, H] f32.
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
