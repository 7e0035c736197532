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
// (K/V resident in VMEM) and `_fwd_kernel_stream` (K/V streamed on a
// third grid axis). The TPU needed two because VMEM could not hold a
// long sequence's K/V; here every block streams K/V tiles through
// shared memory, so one kernel serves both and `streaming=` is only
// validated by the wrapper.
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
// What bounds it on an H100: at the serving prefill widths (S <= 1920,
// H = 8, D = 64, batch 1) the whole call moves a few MB and does a few
// GFLOP, a few microseconds at the card's 3.35 TB/s and 989 TFLOP/s,
// so launch overhead and the kernel's own instruction rate decide its
// time. The design keeps it simple and exact: one 256-thread block per
// (batch*head, 64-row Q tile), K/V tiles of 64 keys staged in shared
// memory as f32, scores and P@V by register-tiled FMAs (4x4 scores and
// 4 x D/16 outputs per thread), online-softmax state in registers, and
// the K-tile loop bounded below by the window and above by the causal
// diagonal and the true length (the bounds of the Pallas kernel's
// fori_loop, attention.py:159-161, at this kernel's tile size).
// Causal Q tiles run heaviest first. Tensor cores (mma/wgmma) and TMA
// are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per staged tile
constexpr int kThreadsY = 16;
constexpr int kThreadsX = 16;
constexpr int kRowsPerThread = kBlockQ / kThreadsY;  // 4
constexpr int kKeysPerThread = kBlockK / kThreadsX;  // 4
constexpr int kThreads = kThreadsY * kThreadsX;      // 256
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
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

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

constexpr size_t smem_bytes(int dmax) {
  return sizeof(float) *
         (size_t)(3 * kBlockK * (dmax + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int seq = p.seq;
  const int dim = p.dim;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_stride[0] +
                h * p.q_stride[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_stride[0] +
                h * p.k_stride[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_stride[0] +
                h * p.v_stride[2];

  for (int i = tid; i < kBlockQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int pos = q0 + r;
    q_s[r * kLd + c] = (pos < seq && c < dim)
                           ? to_f32(qg[pos * p.q_stride[1] + c])
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
      k_s[r * kLd + c] = in ? to_f32(kg[pos * p.k_stride[1] + c]) : 0.f;
      v_s[r * kLd + c] = in ? to_f32(vg[pos * p.v_stride[1] + c]) : 0.f;
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
    T* og = static_cast<T*>(p.o) + row * dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kThreadsX * c;
      if (col < dim) store(og + col, acc[i][c] / den[i]);
    }
    if (tx == 0) p.lse[row] = m[i] + logf(den[i]);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Params& p, cudaStream_t stream) {
  return p.dim <= 64 ? launch<T, 64>(p, stream) : launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns
// the cudaError_t of the launch (0 = success); the caller raises on
// anything else. The wrapper has checked shapes, types, head dim
// (<= 128, multiple of 8) and that the head dim is contiguous.
extern "C" int cea_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int batch,
                             int seq, int heads, int dim, long long q_sb,
                             long long q_ss, long long q_sh, long long k_sb,
                             long long k_ss, long long k_sh, long long v_sb,
                             long long v_ss, long long v_sh, int causal,
                             int window, float scale, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_dim<float>(p, st));
  if (dtype == 1) return static_cast<int>(dispatch_dim<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
