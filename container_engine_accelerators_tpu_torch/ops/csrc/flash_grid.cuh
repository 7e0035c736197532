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

// The launch grid of the flash kernels (flash_fwd.cu, flash_bwd.cu),
// and the column chunks and held slabs of their wide kernels.
//
// grid.x runs over (row tile, batch * head) pairs, batch * head
// fastest: the blocks of one row tile over every head go out together,
// and the tile that runs first (the heaviest, in causal order) is the
// kernel's own choice from `rank`. Neither a long sequence's tile
// count nor B * H meets the 65535 limit of grid.y and grid.z; grid.x
// takes 2^31 - 1 blocks. grid.y counts the 128-column chunks of a head
// dim above 128 (the wide kernels); it is 1 otherwise.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace cea_grid {

// Output columns a block of a wide kernel owns (head dims above 128).
constexpr int kWideCols = 128;

// The route each flash entry point takes as its `aligned` flag (the
// wrapper's `kernel_route`, one rule for the forward, dQ and dK/dV):
// kRouteHopper for bf16 rows a TMA tensor map describes up to head dim
// kHopperWideDim (the Hopper kernels; 136-256 at DMAX 256); otherwise 0
// (up to 128: the mma.sync kernels; above: the wide kernels staging
// rows by 2-byte loads) or, above 128, kRouteRows16 (the wide kernels
// staging rows by 16-byte loads). f32 runs its FMA kernels whatever
// the flag.
constexpr int kRouteHopper = 1;
constexpr int kRouteRows16 = 2;
constexpr int kHopperWideDim = 256;

struct Place {
  int b, h;   // batch and head
  int rank;   // the row tile's place in launch order, 0 first
  int tiles;  // row tiles of `rows` rows over the sequence
};

__device__ __forceinline__ Place place(int batch, int heads, int seq,
                                       int rows) {
  const unsigned bh_n = static_cast<unsigned>(batch) * heads;
  const unsigned bh = blockIdx.x % bh_n;
  Place pl;
  pl.b = static_cast<int>(bh / heads);
  pl.h = static_cast<int>(bh % heads);
  pl.rank = static_cast<int>(blockIdx.x / bh_n);
  pl.tiles = (seq + rows - 1) / rows;
  return pl;
}

// K and V bytes (bf16) of the (batch, head) pairs whose row tiles run
// together under `place_grouped`: a share of the card's 50 MB L2 cache
// that holds them while every row tile of those pairs streams them.
constexpr long long kL2GroupBytes = 8ll << 20;

// The (batch, head) pairs of a group under `place_grouped`: as many as
// kL2GroupBytes of K and V hold at this length and head dim, at least
// one, at most every pair.
__host__ __device__ inline int l2_group(int pairs, int seq, int dim) {
  const long long per = 4ll * seq * dim;  // K and V of one pair, bf16
  const long long g = kL2GroupBytes / per;
  return g < 1 ? 1 : (g > pairs ? pairs : static_cast<int>(g));
}

// As `place`, for a kernel whose K and V over every head outgrow the L2
// cache (bf16 head dim 256: 2 MB a pair at S 2048, 128 MB at
// [4, 2048, 16, 256]): grid.x runs over groups of `group` pairs, one
// group after another, and inside a group over (row tile, pair), pairs
// fastest, so the tiles in flight share the K and V rows of a few
// pairs, and inside each group the heaviest tile still goes first.
__device__ __forceinline__ Place place_grouped(int batch, int heads, int seq,
                                               int rows, int group) {
  const unsigned bh_n = static_cast<unsigned>(batch) * heads;
  const unsigned tiles = (static_cast<unsigned>(seq) + rows - 1) / rows;
  const unsigned per = static_cast<unsigned>(group) * tiles;
  const unsigned g0 = blockIdx.x / per * group;  // the group's first pair
  const unsigned in = blockIdx.x % per;
  const unsigned gn = min(static_cast<unsigned>(group), bh_n - g0);
  const unsigned bh = g0 + in % gn;
  Place pl;
  pl.b = static_cast<int>(bh / heads);
  pl.h = static_cast<int>(bh % heads);
  pl.rank = static_cast<int>(in / gn);
  pl.tiles = static_cast<int>(tiles);
  return pl;
}

// The grid of `rows`-row tiles over batch * heads, `chunks` column
// chunks on grid.y; an error when it exceeds what a launch takes.
inline cudaError_t grid_of(int batch, int heads, int seq, int rows,
                           int chunks, dim3* grid) {
  const long long n = static_cast<long long>(batch) * heads *
                      ((static_cast<long long>(seq) + rows - 1) / rows);
  if (n > INT_MAX || chunks > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(n), static_cast<unsigned>(chunks));
  return cudaSuccess;
}

// Column chunks of a head dim on a wide kernel's grid.y (also the
// bf16 wide kernels' 128-column slabs of S).
__host__ __device__ inline int wide_chunks(int dim) {
  return (dim + kWideCols - 1) / kWideCols;
}

// The bf16 wide kernels hold all of a block's own slabs (Q; Q and dO;
// K and V) across the partner loop up to this many (D <= 512), and
// stage one again a partner tile above.
constexpr int kHeldSlabs = 4;

// The own slabs a bf16 wide kernel keeps in shared memory at a time,
// for the launch's shared-memory size. The kernels compute it inline:
// through this function ptxas gave the bf16 wide forward 172 registers
// instead of 164, two blocks an SM instead of three, and twice the time.
inline int held_slabs(int dim) {
  const int slabs = wide_chunks(dim);
  return slabs <= kHeldSlabs ? slabs : 1;
}

}  // namespace cea_grid
