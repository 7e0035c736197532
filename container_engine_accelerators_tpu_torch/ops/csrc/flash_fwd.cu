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
// Two kernels, chosen by the input type:
//
// bf16, the tensor-core kernel (`flash_fwd_tc_kernel`). The work is
// 4*D operations per kept (query, key) pair against a few bytes per
// row, so the tensor cores' rate bounds it (at [8, 2048, 8, 64]
// causal, 34 GFLOP: 0.035 ms at 989 TFLOP/s) and what keeps a kernel
// from it is feeding them. The design, FlashAttention-2's on
// mma.sync: one 128-thread block per (batch*head, 64-row Q tile), each
// warp owning 16 query rows; Q goes once into registers as A fragments;
// K/V tiles of 64 keys stay in bf16 in padded shared memory (see
// mma_bf16.cuh), double-buffered by 16-byte cp.async so the next tile
// loads while this one computes; S = Q.K^T and O += P.V by
// mma.m16n8k16 with f32 accumulators; the online softmax runs on the
// accumulator fragments (a row lives in a quad of lanes: two shuffles),
// and P, rounded to bf16, is the A operand of P.V straight from the
// registers. Only the tiles a mask can touch (the diagonal, the window
// edge, the ragged end) pay for the mask. The rounding of P to bf16
// before P.V is the one change of numerics against the f32 kernel (as
// in FlashAttention-2); the row sums stay in f32. Rows that do not
// start on 16 bytes (a misaligned view) are staged with 2-byte loads
// by the same kernel.
//
// f32, the exact FMA kernel (`flash_fwd_f32_kernel`): the tensor cores
// would round f32 inputs to TF32 (10-bit mantissa), outside the f32
// limit of 1e-4, so f32 stays on the CUDA cores: one 256-thread block
// per (batch*head, 64-row Q tile), K/V tiles of 64 keys staged as f32,
// scores and P@V by 4x4 register tiles of FMAs. The CUDA cores' 67
// TFLOP/s bound it.
//
// Both bound the K-tile loop below by the window and above by the
// causal diagonal and the true length (the bounds of the Pallas
// kernel's fori_loop, attention.py:159-161, at this tile size), and
// run causal Q tiles heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

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
  int aligned;  // every q/k/v row starts on 16 bytes
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
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
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int seq = p.seq;
  const int dim = p.dim;
  const bool aligned = p.aligned;

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

  stage_rows<kBlockQ, DMAX, kTcThreads>(q_s, qg, p.q_stride[1], q0, seq, dim,
                                        aligned);
  stage_rows<kBlockK, DMAX, kTcThreads>(k_s, kg, p.k_stride[1],
                                        kt_lo * kBlockK, seq, dim, aligned);
  stage_rows<kBlockK, DMAX, kTcThreads>(v_s, vg, p.v_stride[1],
                                        kt_lo * kBlockK, seq, dim, aligned);
  cp_async_commit();

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
    if (kt < kt_hi) {  // the next tile loads while this one computes
      const int next = (kt + 1) * kBlockK;
      stage_rows<kBlockK, DMAX, kTcThreads>(k_s + (buf ^ 1) * kTile, kg,
                                            p.k_stride[1], next, seq, dim,
                                            aligned);
      stage_rows<kBlockK, DMAX, kTcThreads>(v_s + (buf ^ 1) * kTile, vg,
                                            p.v_stride[1], next, seq, dim,
                                            aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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

template <int DMAX>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.seq + kBlockQ - 1) / kBlockQ);
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
  const dim3 grid(p.batch * p.heads, (p.seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_tc_kernel<DMAX><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements; aligned = 1 when every q/k/v row starts on
// 16 bytes (pointer and strides). Returns the cudaError_t of the
// launch (0 = success); the caller raises on anything else. The
// wrapper has checked shapes, types, head dim (<= 128, multiple of 8)
// and that the head dim is contiguous.
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
  const bool wide = dim > 64;
  if (dtype == 0)
    return static_cast<int>(wide ? launch_f32<128>(p, st)
                                 : launch_f32<64>(p, st));
  if (dtype == 1)
    return static_cast<int>(wide ? launch_tc<128>(p, st)
                                 : launch_tc<64>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
