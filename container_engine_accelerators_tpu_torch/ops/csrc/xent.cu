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

// Fused softmax cross-entropy for Hopper (sm_90a), plain C interface:
// a forward and a backward kernel.
//
// Replaces the two Pallas TPU kernels of
// container_engine_accelerators_tpu/ops/xent.py: `_fwd_kernel` (per
// row: max, log-sum-exp, label logit by iota compare, loss = lse -
// shifted[label]) and `_bwd_kernel` (dlogits = (softmax - onehot) *
// g). The TPU kernels take 128-row tiles of a padded [Bp, Cp] array
// (`_pad_inputs`); here one block owns one row and masks the ragged
// end itself, so nothing is padded or copied. A label outside [0, C)
// matches no class, as in the Pallas kernel (the iota compare finds
// nothing): the label logit counts as 0, the loss is the row's
// log-sum-exp of the shifted logits, and the backward subtracts no
// one-hot.
//
// What bounds it on an H100: at the training slice's shapes (logits
// [16376, 32000] f32) the forward reads 2.10 GB and the backward reads
// and writes 4.19 GB, and both do a few operations per element, so
// memory bandwidth bounds them (0.63 ms and 1.25 ms at 3.35 TB/s). The
// design keeps the row's traffic coalesced: 256 threads per row, 16-byte
// loads and stores when the row allows them (f32 with C % 4 == 0 and an
// aligned base), a per-thread online max/sum in f32 merged across the
// block by warp shuffles and shared memory. The backward recomputes the
// row's max and sum (a second read of the row, as the Pallas kernel
// recomputes them) before it writes; keeping the forward's lse to skip
// that read is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Online (max, sum of exp(x - max)) state and its merge.
struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  // -inf states (no element seen) contribute nothing.
  const float sa = a.m == -CUDART_INF_F ? 0.f : a.s * expf(a.m - m);
  const float sb = b.m == -CUDART_INF_F ? 0.f : b.s * expf(b.m - m);
  return {m, sa + sb};
}

__device__ __forceinline__ void add(MaxSum& st, float x) {
  if (x > st.m) {
    st.s = st.s * expf(st.m - x) + 1.f;
    st.m = x;
  } else {
    st.s += expf(x - st.m);
  }
}

// Block-wide merge; every thread gets the row's (max, sum).
__device__ MaxSum block_merge(MaxSum st, MaxSum* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum other = {__shfl_xor_sync(0xffffffffu, st.m, off),
                    __shfl_xor_sync(0xffffffffu, st.s, off)};
    st = merge(st, other);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = st;
  __syncthreads();
  MaxSum total = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = merge(total, scratch[w]);
  return total;
}

// The row's (max, sum) over its C logits. VEC: 16-byte float4 loads.
template <typename T, bool VEC>
__device__ MaxSum row_stats(const T* row, int c, MaxSum* scratch) {
  MaxSum st = {-CUDART_INF_F, 0.f};
  if constexpr (VEC) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int i = threadIdx.x; i < c / 4; i += kThreads) {
      const float4 x = row4[i];
      add(st, x.x);
      add(st, x.y);
      add(st, x.z);
      add(st, x.w);
    }
  } else {
    for (int i = threadIdx.x; i < c; i += kThreads) add(st, to_f32(row[i]));
  }
  return block_merge(st, scratch);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* logits, const long long* labels, float* loss,
                int c) {
  __shared__ MaxSum scratch[kWarps];
  const long long r = blockIdx.x;
  const T* row = logits + r * c;
  const MaxSum st = row_stats<T, VEC>(row, c, scratch);
  if (threadIdx.x == 0) {
    const long long label = labels[r];
    const float label_logit =
        (label >= 0 && label < c) ? to_f32(row[label]) - st.m : 0.f;
    loss[r] = logf(st.s) - label_logit;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* logits, const long long* labels, const float* g,
                T* dlogits, int c) {
  __shared__ MaxSum scratch[kWarps];
  const long long r = blockIdx.x;
  const T* row = logits + r * c;
  T* out = dlogits + r * c;
  const MaxSum st = row_stats<T, VEC>(row, c, scratch);
  const long long label = labels[r];
  const float gr = g[r];
  const float inv = 1.f / st.s;
  if constexpr (VEC) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < c / 4; i += kThreads) {
      const float4 x = row4[i];
      const int j = 4 * i;
      float4 y;
      y.x = (expf(x.x - st.m) * inv - (j == label)) * gr;
      y.y = (expf(x.y - st.m) * inv - (j + 1 == label)) * gr;
      y.z = (expf(x.z - st.m) * inv - (j + 2 == label)) * gr;
      y.w = (expf(x.w - st.m) * inv - (j + 3 == label)) * gr;
      out4[i] = y;
    }
  } else {
    for (int i = threadIdx.x; i < c; i += kThreads) {
      const float p = expf(to_f32(row[i]) - st.m) * inv;
      store(out + i, (p - (i == label)) * gr);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* logits, const void* labels, const void* g,
                   void* out, int n, int c, bool bwd, cudaStream_t stream) {
  if (bwd)
    xent_bwd_kernel<T, VEC><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const long long*>(labels),
        static_cast<const float*>(g), static_cast<T*>(out), c);
  else
    xent_fwd_kernel<T, VEC><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const long long*>(labels),
        static_cast<float*>(out), c);
  return cudaGetLastError();
}

int run(const void* logits, const void* labels, const void* g, void* out,
        int dtype, int n, int c, int vec, bool bwd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec)
    err = launch<float, true>(logits, labels, g, out, n, c, bwd, st);
  else if (dtype == 0)
    err = launch<float, false>(logits, labels, g, out, n, c, bwd, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, false>(logits, labels, g, out, n, c, bwd, st);
  return static_cast<int>(err);
}

}  // namespace

// logits: contiguous [n, c] (dtype 0 = float32, 1 = bfloat16); labels:
// contiguous [n] int64; vec = 1 only for float32 rows that allow
// 16-byte access (c % 4 == 0, 16-byte aligned base). Returns the
// cudaError_t of the launch (0 = success).

// loss: [n] float32.
extern "C" int cea_xent_fwd(const void* logits, const void* labels,
                            void* loss, int dtype, int n, int c, int vec,
                            void* stream) {
  return run(logits, labels, nullptr, loss, dtype, n, c, vec, false, stream);
}

// g: [n] float32 upstream cotangent; dlogits: [n, c] in the logits' type.
extern "C" int cea_xent_bwd(const void* logits, const void* labels,
                            const void* g, void* dlogits, int dtype, int n,
                            int c, int vec, void* stream) {
  return run(logits, labels, g, dlogits, dtype, n, c, vec, true, stream);
}
