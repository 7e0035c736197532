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

// Building blocks of the bf16 mma.sync flash kernels (flash_fwd.cu,
// flash_bwd.cu; the inputs a TMA tensor map cannot describe, and head
// dims above 128): staging of [rows][D] tiles into padded shared memory
// by 2-byte loads (or 16-byte loads where every row starts on 16
// bytes), 4-byte cp.async for row vectors, ldmatrix fragment loads and
// the mma.sync.m16n8k16 bf16 product with f32 accumulators.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane = 4 * g + t):
//   A 16x16 (row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                        a3 (g+8, 2t+8..);
//   B 16x8 (k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C 16x8 f32:          c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column blocks pack, in
// bf16, into the A fragment of one 16-deep step: a product's result
// feeds the next product without touching shared memory.
//
// Shared tiles hold DMAX + 8 bf16 a row: the 16-byte pad puts the 8
// rows an ldmatrix reads on 8 different 16-byte bank groups, so the
// loads are conflict-free, and keeps every row 16-byte aligned for
// ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cea_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when !in (nothing
// is read then, but src must still be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 step (bf16 inputs, f32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16x2 register (lo in the low half, the
// element of the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one 16-deep step from the C fragments of 8-column
// blocks 2j and 2j + 1 of a 16-row result, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragment of rows [0, 16) x columns [kc, kc + 16) of a row-major
// [rows][ld] shared tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int kc, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + kc + (lane >> 4) * 8);
}

// B fragments of the product X . Y^T, Y a row-major [n][ld] shared
// tile (rows are the product's columns): rows [n0, n0 + 16) x columns
// [kc, kc + 16). b[0], b[1] are block n0's, b[2], b[3] block n0 + 8's.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile,
                                            int ld, int n0, int kc,
                                            int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + kc +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of the product X . Y, Y a row-major [k][ld] shared tile:
// rows [kc, kc + 16) x columns [n0, n0 + 16), transposed by ldmatrix.
// b[0], b[1] are column block n0's, b[2], b[3] block n0 + 8's.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile,
                                            int ld, int kc, int n0,
                                            int lane) {
  ldmatrix_x4_trans(b, tile + (kc + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// Stage rows [r0, r0 + ROWS) of one head of a [B, S, H, D] bf16 operand
// (`src` at its (b, h) origin, `row_stride` elements between
// positions) into a [ROWS][DMAX + 8] shared tile, zero past the true
// length and the head dim (a multiple of 8), by 2-byte loads (a row
// need not start on 16 bytes), done when this returns.
template <int ROWS, int DMAX, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int seq, int dim) {
  constexpr int kLd = DMAX + 8;
  for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    const int pos = r0 + r;
    dst[r * kLd + c] = (pos < seq && c < dim) ? src[pos * row_stride + c]
                                              : __float2bfloat16_rn(0.f);
  }
}

// stage_rows by 16-byte loads, for rows that start on 16 bytes (the
// pointer and the row stride) with the columns in range, `dim`, a
// multiple of 8.
template <int ROWS, int DMAX, int THREADS>
__device__ __forceinline__ void stage_rows16(bf16* dst, const bf16* src,
                                             long long row_stride, int r0,
                                             int seq, int dim) {
  constexpr int kLd = DMAX + 8;
  constexpr int kVecs = DMAX / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < ROWS * kVecs; i += THREADS) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const int pos = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pos < seq && c < dim)
      v = *reinterpret_cast<const uint4*>(src + pos * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
  }
}

// stage_rows16 where `vec` (every row on 16 bytes), stage_rows
// otherwise.
template <int ROWS, int DMAX, int THREADS>
__device__ __forceinline__ void stage_rows_by(bool vec, bf16* dst,
                                              const bf16* src,
                                              long long row_stride, int r0,
                                              int seq, int dim) {
  if (vec)
    stage_rows16<ROWS, DMAX, THREADS>(dst, src, row_stride, r0, seq, dim);
  else
    stage_rows<ROWS, DMAX, THREADS>(dst, src, row_stride, r0, seq, dim);
}

// Quad reductions: the four lanes 4g .. 4g + 3 share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace cea_mma
