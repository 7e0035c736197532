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
