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
// one dQ kernel and one dK/dV kernel.
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
// What bounds it on an H100: at the training slice's shapes
// ([8, 2048, 8, 64] bf16, causal) dQ does 6*D and dK/dV 8*D
// operations per kept (query, key) pair, about 52 and 69 GFLOP, against
// 85-101 MB of traffic, so the tensor cores' rate bounds both (about
// 0.05-0.07 ms at 989 TFLOP/s). This first kernel does its products
// with f32 FMAs on the CUDA cores (67 TFLOP/s at most), so it cannot
// come near that bound; it is built to be right and simple:
//   dQ: one 256-thread block per (batch*head, 64-row Q tile); Q, dO,
//       lse, delta staged once; K/V tiles of 64 keys from the window's
//       lower edge to the causal diagonal (the bounds of `_dq_kernel`,
//       attention.py:183-185, at this tile size); per tile, scores and
//       dp by 4x4 register tiles, ds through shared memory, dQ by
//       4 x D/16 register tiles.
//   dK/dV: one 256-thread block per (batch*head, 64-key tile); K, V
//       staged once; Q/dO tiles from the causal lower bound to the
//       window's upper bound (`_dkv_kernel`, attention.py:212-215);
//       p^T and ds^T through shared memory, dK and dV by 4 x D/16
//       register tiles each.
// Causal tiles run heaviest first. Tensor cores (mma/wgmma) and TMA
// are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Whether query q_pos sees key k_pos (both already known < seq).
__device__ __forceinline__ bool sees(const Params& p, int q_pos, int k_pos) {
  if (!p.causal) return true;
  if (q_pos < k_pos) return false;
  return !p.window || k_pos > q_pos - p.window;
}

// Stage rows [r0, r0 + kTile) of a [B, S, H, D] operand into shared
// memory as f32 [kTile][DMAX + 1], zero past the true length and dim.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      long long row_stride, int r0,
                                      int seq, int dim) {
  constexpr int kLd = DMAX + 1;
  for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int pos = r0 + r;
    dst[r * kLd + c] =
        (pos < seq && c < dim) ? to_f32(base[pos * row_stride + c]) : 0.f;
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
template <typename T, int DMAX>
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
    T* dst = static_cast<T*>(out) + row * p.dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kThreadsX * c;
      if (col < p.dim) store(dst + col, acc[a][c]);
    }
  }
}

constexpr size_t smem_bytes(int dmax) {
  // Four [kTile][dmax + 1] operand tiles, two [kTile][kTile + 1] weight
  // tiles, and two rows of kTile (lse, delta).
  return sizeof(float) * (size_t)(4 * kTile * (dmax + 1) +
                                  2 * kTile * kLdT + 2 * kTile);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.do_stride[0] + h * p.do_stride[2];

  stage<T, DMAX>(q_s, qg, p.q_stride[1], q0, seq, p.dim);
  stage<T, DMAX>(do_s, dog, p.do_stride[1], q0, seq, p.dim);
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
    stage<T, DMAX>(k_s, kg, p.k_stride[1], k0, seq, p.dim);
    stage<T, DMAX>(v_s, vg, p.v_stride[1], k0, seq, p.dim);
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
  write_tile<T, DMAX>(p.out0, dq, p, b, h, q0, ty, tx);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.do_stride[0] + h * p.do_stride[2];

  stage<T, DMAX>(k_s, kg, p.k_stride[1], k0, seq, p.dim);
  stage<T, DMAX>(v_s, vg, p.v_stride[1], k0, seq, p.dim);

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
    stage<T, DMAX>(q_s, qg, p.q_stride[1], q0, seq, p.dim);
    stage<T, DMAX>(do_s, dog, p.do_stride[1], q0, seq, p.dim);
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
  write_tile<T, DMAX>(p.out0, dk, p, b, h, k0, ty, tx);
  write_tile<T, DMAX>(p.out1, dv, p, b, h, k0, ty, tx);
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  const size_t smem = smem_bytes(DMAX);
  auto kernel = dkv ? flash_bwd_dkv_kernel<T, DMAX> : flash_bwd_dq_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.seq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Params& p, bool dkv, cudaStream_t stream) {
  return p.dim <= 64 ? launch<T, 64>(p, dkv, stream)
                     : launch<T, 128>(p, dkv, stream);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1,
        int dtype, int batch, int seq, int heads, int dim,
        const long long* strides, int causal, int window, float scale,
        void* stream, bool dkv) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_dim<float>(p, dkv, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_dim<__nv_bfloat16>(p, dkv, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; strides in
// elements, (batch, seq, head) for q, k, v, dO in that order. Return
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
      void *stream

#define CEA_BWD_STRIDES                                                   \
  const long long strides[12] = {q_sb,  q_ss,  q_sh,  k_sb, k_ss, k_sh, \
                                 v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh}

// dQ into out0 (out1 unused).
extern "C" int cea_flash_bwd_dq(CEA_BWD_ARGS) {
  CEA_BWD_STRIDES;
  return run(q, k, v, dout, lse, delta, out0, out1, dtype, batch, seq, heads,
             dim, strides, causal, window, scale, stream, false);
}

// dK into out0, dV into out1.
extern "C" int cea_flash_bwd_dkv(CEA_BWD_ARGS) {
  CEA_BWD_STRIDES;
  return run(q, k, v, dout, lse, delta, out0, out1, dtype, batch, seq, heads,
             dim, strides, causal, window, scale, stream, true);
}
