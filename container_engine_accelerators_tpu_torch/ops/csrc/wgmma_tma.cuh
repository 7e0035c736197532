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

// Building blocks of the Hopper flash kernels (the bf16 forward in
// flash_fwd.cu, dQ and dK/dV in flash_bwd.cu): TMA tile loads guarded
// by mbarriers, wgmma.mma_async on 128-byte-swizzled shared tiles,
// register hand-over between a producer warpgroup and its consumers,
// and tiles handed between consumers through shared memory.
//
// Why these and not the mma.sync helpers of mma_bf16.cuh: on an H100
// only wgmma reaches the tensor cores' full rate, and wgmma reads its
// shared operands through a descriptor of one of the swizzled layouts.
// TMA writes exactly that layout (CU_TENSOR_MAP_SWIZZLE_128B), needs
// one thread to move a whole tile and reports to an mbarrier, so the
// other warps spend no registers or instructions on loads.
//
// Tiles: every operand tile is [rows][64] bf16 per 64-column chunk of
// the head dim (a row is 128 bytes, the swizzle's span), rows a
// multiple of 8, each chunk 1024-byte aligned. A head dim above 64 is
// two chunks; one below 64 is zero-filled by TMA past the tensor's
// last column (and past its last row), so the products need no edge
// code.
//
// Descriptor use (PTX ISA "Matrix Descriptor"; CUTLASS's
// make_gmma_desc):
//   K-major (the product's depth contiguous, e.g. Q or K over the head
//   dim): 8-row groups 1024 bytes apart (SBO); a 16-deep step moves the
//   start address 32 bytes inside the swizzle atom.
//   MN-major (the product's N contiguous, e.g. V, or dO and Q in dK/dV,
//   read with trans-b): the depth runs down the rows, 8-row groups 1024
//   bytes apart; a 16-deep step moves the start 16 rows (2048 bytes).
//   Each instruction here is N 64 (or 32) wide, one swizzle atom, so
//   the stride between atoms along N is never read; it is set to 1024
//   bytes as well.
//
// Fragments (PTX ISA, wgmma m64nNk16, warp w of the warpgroup owns rows
// 16w .. 16w + 15, lane = 4g + t): the f32 accumulator holds, for each
// 8-column block j, d[4j], d[4j + 1] at (row g, columns 8j + 2t, +1)
// and d[4j + 2], d[4j + 3] at row g + 8; a register A operand (four
// bf16x2) is mma.m16n8k16's A fragment. So the accumulator's blocks
// 2k and 2k + 1, rounded to bf16, are the A operand of the 16-deep
// step k of the next product, with no pass through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cea_hopper {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kChunkCols = 64;        // bf16 columns of one swizzled row
constexpr int kRowBytes = 128;        // bytes of one swizzled row
constexpr uint32_t kGroupBytes = 1024;  // 8 swizzled rows
// A barrier phase that does not complete within this many ns is a
// broken pipeline: trap (a launch failure the caller raises on) rather
// than hang the card. No launch of these kernels takes a second.
constexpr uint64_t kWaitLimitNs = 10000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the swizzle atom's
// alignment; dynamic shared memory only promises 16).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------------
// mbarriers.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of asynchronous (TMA) transfer before
// the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed (the barrier
// starts in phase 0: waiting on parity 0 blocks until the first phase
// completes, on parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// ---------------------------------------------------------------------
// TMA.

// One box of a 4-D tensor map (head dim, heads, positions, batch) into
// shared memory at dst, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed
// (the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------
// Hand-over between consumer warpgroups through shared memory.

// Make this thread's plain shared-memory stores visible to the
// asynchronous proxy (the wgmma that reads them as a shared operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads's) over `threads`
// threads, a multiple of 32.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting: the other threads of
// the `threads` sync on it.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------
// Register hand-over (whole warpgroups; the count a multiple of 8).

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------
// wgmma.

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at p:
// start address, leading byte offset `lbo`, stride byte offset 1024
// (8 rows), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc_at(uint32_t a, uint32_t lbo) {
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return sw128_desc_at(smem_u32(p), lbo);
}

// A K-major operand (depth contiguous): 16-deep step `ks` of the
// [rows][64]-chunked tile at shared address `tile` whose chunks are
// `chunk_bytes` apart.
__device__ __forceinline__ uint64_t kmajor_desc_at(uint32_t tile,
                                                   int chunk_bytes, int ks) {
  return sw128_desc_at(tile + (ks / 4) * chunk_bytes + (ks % 4) * 32, 16);
}

__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int chunk_bytes, int ks) {
  return kmajor_desc_at(smem_u32(tile), chunk_bytes, ks);
}

// A word of shared memory, read anew at every call: what is computed
// from it stays where it is used (neither compiler hoists it out of a
// loop), e.g. the descriptors of a tile that a loop reads each pass,
// which hoisted would hold two registers each across the loop.
__device__ __forceinline__ uint32_t ld_shared_volatile(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_u32(p)));
  return v;
}

// An MN-major operand (N contiguous, depth down the rows): 16-deep
// step `ks` of N-chunk `c` of the tile at `tile`.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int chunk_bytes, int c,
                                                 int ks) {
  return sw128_desc(tile + c * chunk_bytes + ks * 16 * kRowBytes,
                    kGroupBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers
// across the asynchronous region (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = a . b (+ d unless scale_d == 0), a and b from
// shared memory; TRANS_B 0: b K-major, 1: b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 32 f32) = a . b (+ d unless scale_d == 0), both from shared
// memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// The N-wide shared-shared product of the two above.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma_ss: N 32 or 64");
  if constexpr (N == 64) {
    wgmma_ss_n64<TRANS_B>(d, a, b, scale_d);
  } else {
    wgmma_ss_n32<TRANS_B>(d, a, b, scale_d);
  }
}

// d (64 x 64 f32) = a . b (+ d unless scale_d == 0), a (64 x 16 bf16)
// from registers (the A fragment above), b from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TRANS_B));
}

// The register A operand of 16-deep step kk, for this warp's 16 rows
// (rows 16 warp .. + 15), from a [rows][64]-chunked 128-byte-swizzled
// tile whose chunks are `chunk_bytes` apart and whose first row starts
// an 8-row swizzle group: one ldmatrix.x4 (lanes 0-15 address rows
// 0-15 at columns 16 kk, lanes 16-31 the same rows 8 columns on; the
// 16-byte unit u of row r sits at unit u ^ (r % 8)).
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4],
                                             const unsigned char* tile,
                                             int chunk_bytes, int kk,
                                             int warp, int lane) {
  const int row = warp * 16 + (lane & 15);
  const int unit = (kk % 4) * 2 + (lane >> 4);
  const unsigned char* src = tile + (kk / 4) * chunk_bytes +
                             row * kRowBytes + ((unit ^ (row & 7)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(src)));
}

// Two f32 values as one bf16x2 register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values rounded to bf16 into (row, columns col and col + 1;
// col even) of a [rows][64] 128-byte-swizzled tile whose first row
// starts an 8-row swizzle group: the layout TMA writes and a K-major
// descriptor reads (the 16-byte unit u of row r sits at unit u ^ (r %
// 8), as in load_a_sw128).
__device__ __forceinline__ void store_sw128_pair(unsigned char* tile,
                                                 int row, int col, float lo,
                                                 float hi) {
  *reinterpret_cast<uint32_t*>(tile + row * kRowBytes +
                               (((col >> 3) ^ (row & 7)) << 4) +
                               (col & 7) * 2) = pack_bf16(lo, hi);
}

// The A operand of 16-deep step k of the next product from
// accumulator blocks 2k and 2k + 1, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[N], int k) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// 2^x by the special-function unit alone (results below 2^-126 flush
// to 0; exp2f adds range handling for them).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Quad reductions: lanes 4g .. 4g + 3 share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------
// Host: tensor maps.

// cuTensorMapEncodeTiled's signature (cuda.h), looked up at run time
// with cudaGetDriverEntryPoint so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  // Host threads launch concurrently (ctypes drops the GIL): the
  // pointer is published atomically; a failed lookup is tried again.
  static std::atomic<EncodeTiledFn> fn{nullptr};
  EncodeTiledFn f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      f = reinterpret_cast<EncodeTiledFn>(p);
      fn.store(f, std::memory_order_release);
    }
  }
  return f;
}

// Make the current device's primary context current in the calling
// host thread, once a thread. cuTensorMapEncodeTiled is a driver call
// and fails with CUDA_ERROR_INVALID_CONTEXT in a thread where no
// context is current, which a host thread's first launch can meet:
// PyTorch's caching allocator hands it its tensors without a runtime
// call that would bind one. cudaSetDevice binds it (CUDA 12).
inline cudaError_t bind_thread_context() {
  static thread_local bool bound = false;
  if (bound) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  bound = err == cudaSuccess;
  return err;
}

// The tensor map of one [B, S, H, D] bf16 operand read through its
// element strides (batch, position, head; the head dim contiguous):
// dims (D, H, S, B), boxes of 64 columns x 1 head x `box_rows`
// positions x 1 batch, 128-byte swizzle, zeros past D and past S. The
// caller has checked that the base and every stride of a dimension
// longer than 1 are 16-byte multiples (a stride of a dimension of
// length 1 is never stepped and is replaced by a valid one).
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int batch,
                               int seq, int heads, int dim,
                               const long long (&stride)[3], int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t packed = static_cast<cuuint64_t>(dim) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      heads > 1 ? static_cast<cuuint64_t>(stride[2]) * 2 : packed,
      seq > 1 ? static_cast<cuuint64_t>(stride[1]) * 2 : packed,
      batch > 1 ? static_cast<cuuint64_t>(stride[0]) * 2 : packed};
  const cuuint32_t box[4] = {kChunkCols, 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Before every launch of kernel `fn`: bind the thread's context
// (bind_thread_context, for the tensor maps the launch encodes next).
// Once a device, before its first launch there (`Config`, the kernel's
// configuration type, keys the once): check that it was compiled with
// enough registers a thread for its producer warpgroup to drop to
// `dec` and its `consumers` warpgroups to rise to `inc` (setmaxnreg
// moves registers inside the block's allocation; asking for more than
// it holds would stall), and opt in to `smem` bytes of dynamic shared
// memory.
template <typename Config, typename Kernel>
cudaError_t prepare_launch(Kernel fn, int threads, int consumers, int dec,
                           int inc, size_t smem) {
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = bind_thread_context();
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && ready[dev].load()))
    return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * threads < 128 * dec + 128 * consumers * inc)
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

}  // namespace cea_hopper
