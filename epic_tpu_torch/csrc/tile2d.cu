// Temporally blocked red-black relaxation of a 2D grid on NVIDIA Hopper
// (sm_90a): grids beyond the 50 MB L2, and wide grids.
//
// Replaces four TPU kernels, and two test-only ones, which all compute one
// function (K sweeps of the grid, the delta of sweep 0, optionally the state
// u1 after sweep 0) and differ only in how they stage data through VMEM:
//   epic_tile2d_chunk <- epic_tpu/solver/pallas_biggrid.py:199
//                        _band_kernel_dma_impl (K3; row bands, K-row halos)
//                        and :100 _band_kernel (T2, pre-gathered bands),
//                        pallas_tiled2d.py:120 _tile_kernel_impl (K5; row x
//                        column slabs), and with u1 pallas_sweep.py:109
//                        _multisweep_check_kernel (T1)
//   epic_tile2d_cycle <- pallas_cycle.py:59 _cycle_kernel_impl (K4) and :355
//                        _cycle_kernel_tiled_impl (K6): N chunks in one
//                        launch, ping-pong between two buffers
//   epic_tile2d_solve <- the while loops of pallas_biggrid.py:482
//                        _solve_banded and pallas_tiled2d.py:430 _solve_tiled
//                        over K3-K6 with the check folded into chunk 0: the
//                        whole stagger protocol in one launch
// The plain torch version is epic_tpu_torch/solver/tiled.py. The same tile
// pass also runs one shard's chunk of the 2D mesh solver:
//   epic_shard2d_chunk <- epic_tpu/parallel/sharded.py:89 _sweep_k_local_kernel
//                         (K14; the whole extended block in VMEM) and :152
//                         _band_shard_kernel (K15; DMA row bands for shards
//                         beyond VMEM), which compute one function
// with the plain version sweep_k_local in
// epic_tpu_torch/parallel/hopper_shard2d.py. And the 2D resident route,
// every shard of one device in one launch:
//   epic_resident2d_cycle <- epic_tpu/parallel/resident.py:188 _resident_kernel
//                            (K16; a shard in a 128-lane guard layout, DMA
//                            row bands, src -> aliased dst) and
//                            resident_tiled.py:167 _chunk_cycle (K17; K6's
//                            body at nc = 1 on the tiled guard layout): one
//                            chunk of a shard, its trapezoid, the delta over
//                            its centre; here N chunks ping-pong in one launch
//   epic_resident2d_solve <- the while loops of resident.py:451 and
//                            resident_tiled.py:315 _solve_resident (the whole
//                            solve inside shard_map over K16/K17's chunks)
// with the plain versions in epic_tpu_torch/parallel/hopper_resident2d.py.
//
// Design. A full-width band never fits shared memory here (8192 columns x 48
// rows x 5 B is 1.9 MB), so one layout answers both TPU layouts: a block owns
// a kTH x kTW centre of the unpadded H x W grid (the last row and column of
// tiles ragged), loads (kTH+2K) x (kTW+2K) cells of u (float) and of a frozen
// byte (locked, the grid's ring, or outside the grid, where u is
// LOG_SPACE_OBSTACLE) into dynamic shared memory, and runs up to K sweeps
// there in place (a class reads only the other class; __syncthreads between
// sweeps). Sweep s updates a cell only inside the trapezoid of
// pallas_biggrid.py:251-255 (local row and column in (s, ext-1-s)), of the
// class (y + x) % 2 != (t0 + s) % 2 in global coordinates; after K sweeps the
// centre is exact and is written to dst, never to src, whose halo the
// neighbouring blocks read. So chunks ping-pong between two buffers, and
// grid-wide barriers (cooperative_groups::this_grid().sync()) separate the
// chunks of a cycle or a solve.
//
// Delta. max |u1 - u0| over the block's centre cells that lie in the grid,
// never over fill cells (ROADMAP R7), reduced with block_max_atomic
// (sweep_common.cuh): deterministic, since max is exact in any order.
//
// The shard. After the halo exchange a shard's buffer holds its h x w centre
// with a K-deep halo from the neighbouring shards (frozen, and never written,
// outside the mesh). For the view of that he x we = (h + 2K) x (w + 2K)
// block (a row pitch, for u and its frozen bytes alike), sweep s of a chunk
// updates a cell (R, C) only inside the block's trapezoid, s+1 <= R < he-1-s
// and s+1 <= C < we-1-s (sharded.py:105; K15's static edge guards give the
// same cells, :225), only if its frozen byte is 0 (locked, the grid's ring,
// mesh padding and out-of-mesh halo), and only of the 2D class
// (par0 + R + C) % 2 != (t0 + s) % 2, par0 the parity of the block's global
// origin (sharded.py:94-101). So the tile pass differs from the grid's in
// three points: the frozen bytes come from the input, the parity from the
// block's origin, and the block's trapezoid bounds the tile's. The delta is
// sweep 0's over every cell it updates anywhere in the block
// (sharded.py:109-110): halo cells repeat the neighbours' arithmetic, so the
// max over the shards equals core's delta. One launch a shard a chunk, a
// tile a block. The TPU's constraints (depth a multiple of 4, 128-lane
// widths, sharded.py:474-481) do not apply: any K that fits shared memory,
// any shard extent.
//
// The resident route. A device's shards share one plan (a table, below):
// for each shard its blocks and, for each of the eight neighbours of its
// view, whether the tile reads that neighbour's current centre directly
// (a shard of the same device: no halo copy) or the shard's own halo (a
// neighbour on another device or process, copied there by the host between
// launches, or outside the mesh: the fill, frozen). The frozen bytes always
// come from the own block, whose halos are exchanged once per edit. A
// block strides over (shard, tile) pairs; every shard of a chunk reads the
// same set of blocks (u or twin) and writes the other, and a grid barrier
// separates chunks. The delta is taken over the shards' centres: each
// chunk starts from the neighbours' current values, so a halo cell repeats
// its owner's sweep-0 update, and the max over the shards equals the block
// delta's (K14/K15) and K16/K17's interior delta's.
//
// Numerics. lse4 from sweep_common.cuh, no --use_fast_math: the kernels give
// the plain version's (and solver/core.py's) bits.
//
// Memory. The source is read with __ldcg (L2, not L1): in a cycle or a
// solve the previous chunk's blocks wrote it during the same launch.
//
// Bound on this card. A chunk of K sweeps moves each cell through HBM about
// once (the halo reads (1 + 2K/kTH)(1 + 2K/kTW) of the grid, 5 B a cell, plus
// 4 B written), so beyond L2 the kernels are no longer bound by HBM bytes,
// as K1 is, but by the lse4 arithmetic in shared memory (two expf and logf
// calls' worth of accurate libm code a cell) and by the halo recompute
// (the trapezoid's mean area over the centre's). Simple first: one thread
// per cell of a class, an integer division by a run-time width per cell,
// 2-way bank conflicts on the stride-2 class; tuning is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kObstacle = -1e6f;  // constants.LOG_SPACE_OBSTACLE

// The centre a block owns and the threads of a block: the fastest of the
// shapes measured at 4096^2 and 8192^2 on an H100 (PERF.md).
// solver/hopper_tile2d.py's TILE holds the same centre.
constexpr int kTH = 64;
constexpr int kTW = 128;
constexpr int kThreads = 512;

// The grid, the tiling and the chunk depth bound of one launch.
struct Tiling {
  const uint8_t* locked;
  int H, W;       // the unpadded grid
  int K;          // halo depth: the most sweeps a chunk may run
  int nx;         // tiles across
  int n_tiles;
};

// The block's dynamic shared memory holds u of the extended tile, then its
// frozen bytes.
__device__ __forceinline__ uint8_t* frozen_of(float* smem, int K) {
  return reinterpret_cast<uint8_t*>(smem + (kTH + 2 * K) * (kTW + 2 * K));
}

// The centre (ch x cw of it), from shared memory to out (tile.at gives a
// centre cell's address).
template <class Tile>
__device__ __forceinline__ void write_centre(const float* us, float* out, const Tile& tile) {
  const int EC = kTW + 2 * tile.K;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW;
    const int c = i % kTW;
    if (r < tile.ch && c < tile.cw) *tile.at(out, r, c) = us[(tile.K + r) * EC + tile.K + c];
  }
}

// One chunk of `ns` (1..K) sweeps from iteration t0 on one tile, in the
// tile's local coordinates (local (0, 0) is the first cell of its K-deep
// halo): load the halo-extended tile, sweep it under the trapezoid that
// tile.last_row/last_col bound, write the centre to dst (and after sweep 0
// to u1, when given), max-accumulate sweep 0's delta over the cells that
// tile.in_delta admits into delta_acc (when given). Every thread of the
// block calls it; us/fs are the block's dynamic shared memory. The Tile
// type is a compile-time choice, so each caller's pass holds only its own
// state in registers: the solve kernel sits at its limit of 64.
template <class Tile>
__device__ __forceinline__ void tile_pass(const Tile& tile, float* dst, float* u1, int t0,
                                          int ns, unsigned int* delta_acc, float* us,
                                          uint8_t* fs) {
  const int ER = kTH + 2 * tile.K;
  const int EC = kTW + 2 * tile.K;
  for (int i = threadIdx.x; i < ER * EC; i += kThreads) {
    const int lr = i / EC;
    tile.load(lr, i - lr * EC, us[i], fs[i]);
  }
  __syncthreads();

  const int par = tile.par();  // (row + column) & 1 of local (0, 0) in global coordinates
  float local = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const int want = ((t0 + s) & 1) ^ 1;  // the class updated: (par + lr + lc) & 1 == want
    const int r0 = s + 1;                 // the trapezoid: rows r0..r1, columns c0..c1
    const int c0 = s + 1;                 // (never empty: the centre has a cell and s < K)
    const int r1 = tile.last_row(s);
    const int c1 = tile.last_col(s);
    const int half = (c1 - c0 + 2) / 2;   // cells of one class in a row, at most
    const int units = (r1 - r0 + 1) * half;
    for (int i = threadIdx.x; i < units; i += kThreads) {
      const int row = i / half;
      const int lr = r0 + row;
      const int lc = c0 + ((par + lr + c0 + want) & 1) + 2 * (i - row * half);
      if (lc > c1) continue;
      const int li = lr * EC + lc;
      if (fs[li]) continue;
      const float v = lse4(us[li - EC], us[li + EC], us[li - 1], us[li + 1]);
      if (s == 0 && tile.in_delta(lr, lc)) local = fmaxf(local, fabsf(v - us[li]));
      us[li] = v;
    }
    __syncthreads();
    if (s == 0 && u1 != nullptr) {
      write_centre(us, u1, tile);
      __syncthreads();
    }
  }
  if (delta_acc != nullptr) block_max_atomic<kThreads>(local, delta_acc);
  write_centre(us, dst, tile);
  __syncthreads();  // the next tile reuses us/fs
}

// A tile of the unpadded H x W grid whose centre starts at (gy0, gx0):
// frozen cells are locked or on the grid's ring; beyond the grid
// LOG_SPACE_OBSTACLE, frozen; the trapezoid is the tile's own; the delta
// covers the centre's cells in the grid.
struct GridTile {
  const float* src;
  const uint8_t* locked;
  int H, W, K, gy0, gx0, ch, cw;
  __device__ __forceinline__ void load(int lr, int lc, float& v, uint8_t& f) const {
    const int y = gy0 - K + lr;
    const int x = gx0 - K + lc;
    v = kObstacle;
    f = 1;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t idx = static_cast<size_t>(y) * W + x;
      v = __ldcg(src + idx);
      f = (locked[idx] != 0) | (y == 0) | (y == H - 1) | (x == 0) | (x == W - 1);
    }
  }
  __device__ __forceinline__ int par() const { return (gy0 + gx0) & 1; }  // -2K is even
  __device__ __forceinline__ int last_row(int s) const { return kTH + 2 * K - 2 - s; }
  __device__ __forceinline__ int last_col(int s) const { return kTW + 2 * K - 2 - s; }
  __device__ __forceinline__ bool in_delta(int lr, int lc) const {
    return lr >= K && lr < K + ch && lc >= K && lc < K + cw;
  }
  __device__ __forceinline__ float* at(float* out, int r, int c) const {
    return out + static_cast<size_t>(gy0 + r) * W + gx0 + c;
  }
};

// One chunk of `ns` (1..K) sweeps from iteration t0 on tile `tile` of the
// grid, src -> dst (and u1).
__device__ void tile_chunk(const float* src, float* dst, float* u1, const Tiling& g, int tile,
                           int t0, int ns, unsigned int* delta_acc, float* us, uint8_t* fs) {
  const int ty = tile / g.nx;
  const int gy0 = ty * kTH;
  const int gx0 = (tile - ty * g.nx) * kTW;
  const GridTile t{src, g.locked, g.H, g.W, g.K, gy0, gx0, min(kTH, g.H - gy0),
                   min(kTW, g.W - gx0)};
  tile_pass(t, dst, u1, t0, ns, delta_acc, us, fs);
}

// All tiles of one chunk, strided over the blocks.
__device__ void all_tiles(const float* src, float* dst, float* u1, const Tiling& g, int t0,
                          int ns, unsigned int* delta_acc, float* us, uint8_t* fs) {
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x)
    tile_chunk(src, dst, u1, g, tile, t0, ns, delta_acc, us, fs);
}

// K3/K5 (and T1/T2): one chunk from iteration *it + t_off; a block a tile.
__global__ void __launch_bounds__(kThreads)
tile_chunk_kernel(const float* src, float* dst, float* u1, Tiling g, const int* it, int t_off,
                  int ns, unsigned int* delta_bits) {
  extern __shared__ float smem[];
  tile_chunk(src, dst, u1, g, blockIdx.x, *it + t_off, ns, delta_bits, smem, frozen_of(smem, g.K));
}

// K4/K6: `total` sweeps from *it + t_off spread over n_chunks chunks; chunk
// c reads a when c is even and b otherwise and writes the other, its
// sweep-0 delta into deltas[c] (zeroed by the caller). An even count ends in
// a.
__global__ void __launch_bounds__(kThreads)
tile_cycle_kernel(float* a, float* b, Tiling g, const int* it, int t_off, int total,
                  int n_chunks, unsigned int* deltas) {
  extern __shared__ float smem[];
  uint8_t* fs = frozen_of(smem, g.K);
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_tiles((c & 1) ? b : a, (c & 1) ? a : b, nullptr, g, t, ns, deltas + c, smem, fs);
    t += ns;
  }
}

// The stagger protocol of solver/core.py, resumable: from the iteration,
// delta and verdict in it_io/delta_io/done_io, run cycles while not done and
// it < bound. A cycle is the checked chunk of depth min(K, stagger) from
// cur to oth, writing u1 too; a barrier; one decision that every thread
// reads (exit with u1 once delta < eps and it + 1 >= m_max); else the
// remaining stagger - depth sweeps as further chunks, a barrier after each.
// acc holds two zeroed slots that the checks alternate between; the next
// check's slot is cleared after this check's barrier, and at least one
// barrier (a rest chunk's, or the extra one when there is none) separates
// the clear from the next check's atomics. The state ends in u: the last
// step copies it there when it is in twin or u1.
__global__ void __launch_bounds__(kThreads)
tile_solve_kernel(float* u, float* twin, float* u1, Tiling g, const float* eps_ptr, int m_max,
                  int bound, int stagger, unsigned int* acc, int* it_io, float* delta_io,
                  int* done_io) {
  extern __shared__ float smem[];
  uint8_t* fs = frozen_of(smem, g.K);
  cg::grid_group grid = cg::this_grid();
  const float eps = *eps_ptr;
  int it = *it_io;
  float delta = *delta_io;
  bool done = *done_io != 0;
  const int depth = min(g.K, stagger);
  const int rest = stagger - depth;
  const int n_rest = (rest + g.K - 1) / g.K;
  float* cur = u;
  float* oth = twin;
  int slot = 0;
  while (!done && it < bound) {
    all_tiles(cur, oth, u1, g, it, depth, acc + slot, smem, fs);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < eps && it + 1 >= m_max;
    if (done) {
      it += 1;
      cur = u1;
      break;
    }
    float* tmp = cur;
    cur = oth;
    oth = tmp;
    int t = it + depth;
    for (int r = 0; r < n_rest; ++r) {
      const int ns = spread_at(rest, n_rest, r);
      all_tiles(cur, oth, nullptr, g, t, ns, nullptr, smem, fs);
      grid.sync();
      tmp = cur;
      cur = oth;
      oth = tmp;
      t += ns;
    }
    if (n_rest == 0) grid.sync();
    it += stagger;
  }
  if (cur != u) {
    const size_t n = static_cast<size_t>(g.H) * g.W;
    for (size_t i = grid.thread_rank(); i < n; i += grid.size()) u[i] = __ldcg(cur + i);
  }
  if (grid.thread_rank() == 0) {
    *it_io = it;
    *delta_io = delta;
    *done_io = done ? 1 : 0;
  }
}

// A tile of one shard's K-extended block: a view of he x we cells with row
// pitch ld (elements) for u and the frozen bytes alike, the tile's local
// (0, 0) at the view's (r0, c0); beyond the view LOG_SPACE_OBSTACLE, frozen.
// The block's trapezoid bounds the tile's (its lower ends are the tile's);
// the tiles' halos are the block's, so their sweep-0 trapezoids cover the
// whole block, and the delta covers every cell they update.
struct ShardTile {
  const float* src;
  const uint8_t* frozen;
  long long ld;
  int he, we, K, par0, r0, c0, ch, cw;
  __device__ __forceinline__ void load(int lr, int lc, float& v, uint8_t& f) const {
    const int R = r0 + lr;
    const int C = c0 + lc;
    v = kObstacle;
    f = 1;
    if (R < he && C < we) {
      const long long idx = static_cast<long long>(R) * ld + C;
      v = __ldcg(src + idx);
      f = frozen[idx] != 0;
    }
  }
  __device__ __forceinline__ int par() const { return (par0 + r0 + c0) & 1; }
  __device__ __forceinline__ int last_row(int s) const {
    return min(kTH + 2 * K, he - r0) - 2 - s;
  }
  __device__ __forceinline__ int last_col(int s) const {
    return min(kTW + 2 * K, we - c0) - 2 - s;
  }
  __device__ __forceinline__ bool in_delta(int, int) const { return true; }
  __device__ __forceinline__ float* at(float* out, int r, int c) const {
    return out + static_cast<long long>(r0 + K + r) * ld + c0 + K + c;
  }
};

// One shard's chunk of the 2D mesh solver.
struct Shard {
  const float* src;
  float* dst;
  float* u1;
  const uint8_t* frozen;
  long long ld;   // row pitch of u and frozen, in elements
  int he, we;     // the extended block
  int K;          // its halo depth
  int par0;       // (global row + global column) & 1 of the block's (0, 0)
  int nx;         // tiles across
};

// K14/K15: one chunk of ns (1..K) sweeps from iteration *it + t_off on a
// shard's block, a tile a block.
__global__ void __launch_bounds__(kThreads)
shard_chunk_kernel(Shard g, const int* it, int t_off, int ns, unsigned int* delta_bits) {
  extern __shared__ float smem[];
  const int ty = blockIdx.x / g.nx;
  const int r0 = ty * kTH;
  const int c0 = (blockIdx.x - ty * g.nx) * kTW;
  const ShardTile t{g.src, g.frozen, g.ld, g.he, g.we, g.K, g.par0, r0, c0,
                    min(kTH, g.he - 2 * g.K - r0), min(kTW, g.we - 2 * g.K - c0)};
  tile_pass(t, g.dst, g.u1, *it + t_off, ns, delta_bits, smem, frozen_of(smem, g.K));
}

// The resident route's plan of one device: kPlanCols int64 a shard (its
// slot): the addresses of its blocks (set 0, the current u; set 1, the twin;
// set 2, u1, or 0 when none), of its frozen bytes, the parity of its block's
// (0, 0), and for each of the nine regions of its view (rows above, within
// and below the centre x columns left, within and right, row-major; region
// 4 the centre) the slot whose centre it reads, or -1 for the own block.
// Every block is (h + 2H) x (w + 2H) cells with row pitch ld; a chunk of
// depth K reads the view of (h + 2K) x (w + 2K) cells at (H - K, H - K).
constexpr int kPlanCols = 14;
constexpr int kPlanFrozen = 3;
constexpr int kPlanPar0 = 4;
constexpr int kPlanRegions = 5;

struct Plan {
  const long long* rows;
  long long ld;
  int n_shards, h, w, H, K;
  int nx;        // tiles across a shard
  int n_tiles;   // tiles a shard
};

// For one (shard, chunk): where each region of the view is read, and the
// shift of a view cell's index there (0 in the own block).
struct Regions {
  const float* src[9];
  long long shift[9];
};

// A tile of a resident shard's view, local (0, 0) at view (r0, c0): u from
// the region's source, the frozen bytes from the own block; beyond the view
// LOG_SPACE_OBSTACLE, frozen. The view's trapezoid bounds the tile's, as
// ShardTile's does; the delta covers the tile's centre cells, which are the
// shard's.
struct ResidentTile {
  const Regions* reg;
  const uint8_t* frozen;   // at the view's (0, 0)
  long long ld;
  int h, w, K, par0, r0, c0, ch, cw;
  __device__ __forceinline__ void load(int lr, int lc, float& v, uint8_t& f) const {
    const int R = r0 + lr;
    const int C = c0 + lc;
    v = kObstacle;
    f = 1;
    if (R < h + 2 * K && C < w + 2 * K) {
      const long long idx = static_cast<long long>(R) * ld + C;
      const int n = 3 * ((R >= K) + (R >= K + h)) + (C >= K) + (C >= K + w);
      v = __ldcg(reg->src[n] + (idx - reg->shift[n]));
      f = frozen[idx] != 0;
    }
  }
  __device__ __forceinline__ int par() const { return (par0 + r0 + c0) & 1; }
  __device__ __forceinline__ int last_row(int s) const {
    return min(kTH + 2 * K, h + 2 * K - r0) - 2 - s;
  }
  __device__ __forceinline__ int last_col(int s) const {
    return min(kTW + 2 * K, w + 2 * K - c0) - 2 - s;
  }
  __device__ __forceinline__ bool in_delta(int lr, int lc) const {
    return lr >= K && lr < K + ch && lc >= K && lc < K + cw;
  }
  __device__ __forceinline__ float* at(float* out, int r, int c) const {
    return out + static_cast<long long>(r0 + K + r) * ld + c0 + K + c;
  }
};

// One chunk of ns sweeps from t0 on job `job` of the plan (shard job /
// n_tiles, one of its tiles): set src_set to set dst_set, and with with_u1
// the centre after sweep 0 to set 2. The nine regions go to shared memory
// first: a direct neighbour's region is its block of set src_set, shifted
// by its offset on the mesh (K <= h, w, so a region lies in one centre).
__device__ void resident_job(const Plan& p, int job, int src_set, int dst_set, bool with_u1,
                             int t0, int ns, unsigned int* delta_acc, float* us, uint8_t* fs,
                             Regions* reg) {
  const int slot = job / p.n_tiles;
  const int tile = job - slot * p.n_tiles;
  const long long* row = p.rows + static_cast<long long>(slot) * kPlanCols;
  const long long v0 = static_cast<long long>(p.H - p.K) * (p.ld + 1);   // the view's (0, 0)
  if (threadIdx.x < 9) {
    const int n = threadIdx.x;
    const long long nb = row[kPlanRegions + n];
    const long long* from = nb >= 0 ? p.rows + nb * kPlanCols : row;
    reg->src[n] = reinterpret_cast<const float*>(from[src_set]) + v0;
    reg->shift[n] = nb >= 0 ? (n / 3 - 1) * static_cast<long long>(p.h) * p.ld + (n % 3 - 1) * p.w
                            : 0;
  }
  __syncthreads();
  const int ty = tile / p.nx;
  const int r0 = ty * kTH;
  const int c0 = (tile - ty * p.nx) * kTW;
  const ResidentTile t{reg, reinterpret_cast<const uint8_t*>(row[kPlanFrozen]) + v0, p.ld,
                       p.h, p.w, p.K, static_cast<int>(row[kPlanPar0]), r0, c0,
                       min(kTH, p.h - r0), min(kTW, p.w - c0)};
  float* dst = reinterpret_cast<float*>(row[dst_set]) + v0;
  float* u1 = with_u1 ? reinterpret_cast<float*>(row[2]) + v0 : nullptr;
  tile_pass(t, dst, u1, t0, ns, delta_acc, us, fs);
}

// Every (shard, tile) job of one chunk, strided over the blocks.
__device__ void all_resident_jobs(const Plan& p, int src_set, int dst_set, bool with_u1, int t0,
                                  int ns, unsigned int* delta_acc, float* us, uint8_t* fs,
                                  Regions* reg) {
  const int jobs = p.n_shards * p.n_tiles;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x)
    resident_job(p, job, src_set, dst_set, with_u1, t0, ns, delta_acc, us, fs, reg);
}

// K16/K17: `total` sweeps from *it + t_off over n_chunks chunks on every
// shard of the plan; chunk c reads set c & 1 and writes the other, its
// sweep-0 delta (max over the plan's centres) into deltas[c] (zeroed by the
// caller); with with_u1, chunk 0 writes u1 too. An even count ends in set 0.
__global__ void __launch_bounds__(kThreads)
resident_cycle_kernel(Plan p, const int* it, int t_off, int total, int n_chunks, int with_u1,
                      unsigned int* deltas) {
  extern __shared__ float smem[];
  __shared__ Regions reg;
  uint8_t* fs = frozen_of(smem, p.K);
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_resident_jobs(p, c & 1, (c & 1) ^ 1, c == 0 && with_u1 != 0, t, ns, deltas + c, smem, fs,
                      &reg);
    t += ns;
  }
}

// The centres of every shard of the plan, set `from` to set `to`.
__device__ void copy_centres(const Plan& p, int from, int to, cg::grid_group& grid) {
  const long long cells = static_cast<long long>(p.h) * p.w;
  for (int s = 0; s < p.n_shards; ++s) {
    const long long* row = p.rows + static_cast<long long>(s) * kPlanCols;
    const float* a = reinterpret_cast<const float*>(row[from]);
    float* b = reinterpret_cast<float*>(row[to]);
    for (long long i = grid.thread_rank(); i < cells; i += grid.size()) {
      const long long r = i / p.w;
      const long long off = (p.H + r) * p.ld + p.H + (i - r * p.w);
      b[off] = __ldcg(a + off);
    }
  }
}

// tile_solve_kernel's resumable stagger protocol over every shard of a plan
// that covers the whole mesh (no neighbour copied by the host): sets 0 and 1
// ping-pong, the check chunk writes set 2 (u1) too. The state ends in set 0:
// the last step copies the centres there from set 1 or 2.
__global__ void __launch_bounds__(kThreads)
resident_solve_kernel(Plan p, const float* eps_ptr, int m_max, int bound, int stagger,
                      unsigned int* acc, int* it_io, float* delta_io, int* done_io) {
  extern __shared__ float smem[];
  __shared__ Regions reg;
  uint8_t* fs = frozen_of(smem, p.K);
  cg::grid_group grid = cg::this_grid();
  const float eps = *eps_ptr;
  int it = *it_io;
  float delta = *delta_io;
  bool done = *done_io != 0;
  const int depth = min(p.K, stagger);
  const int rest = stagger - depth;
  const int n_rest = (rest + p.K - 1) / p.K;
  int cur = 0;
  int slot = 0;
  while (!done && it < bound) {
    all_resident_jobs(p, cur, cur ^ 1, true, it, depth, acc + slot, smem, fs, &reg);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < eps && it + 1 >= m_max;
    if (done) {
      it += 1;
      cur = 2;
      break;
    }
    cur ^= 1;
    int t = it + depth;
    for (int r = 0; r < n_rest; ++r) {
      const int ns = spread_at(rest, n_rest, r);
      all_resident_jobs(p, cur, cur ^ 1, false, t, ns, nullptr, smem, fs, &reg);
      grid.sync();
      cur ^= 1;
      t += ns;
    }
    if (n_rest == 0) grid.sync();
    it += stagger;
  }
  if (cur != 0) copy_centres(p, cur, 0, grid);
  if (grid.thread_rank() == 0) {
    *it_io = it;
    *delta_io = delta;
    *done_io = done ? 1 : 0;
  }
}

Plan make_plan(const void* rows, int n_shards, int h, int w, int H, long long ld, int K) {
  Plan p;
  p.rows = static_cast<const long long*>(rows);
  p.ld = ld;
  p.n_shards = n_shards;
  p.h = h;
  p.w = w;
  p.H = H;
  p.K = K;
  p.nx = (w + kTW - 1) / kTW;
  p.n_tiles = ((h + kTH - 1) / kTH) * p.nx;
  return p;
}

size_t smem_bytes(int K) {
  return static_cast<size_t>(kTH + 2 * K) * (kTW + 2 * K) * (sizeof(float) + 1);
}

Tiling make_tiling(const void* locked, int H, int W, int K) {
  Tiling g;
  g.locked = static_cast<const uint8_t*>(locked);
  g.H = H;
  g.W = W;
  g.K = K;
  g.nx = (W + kTW - 1) / kTW;
  g.n_tiles = ((H + kTH - 1) / kTH) * g.nx;
  return g;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u, twin, u1, src and dst are f32[H, W] and locked
// u8[H, W], contiguous; src and dst are distinct. K is the halo depth
// (SolverConfig.tile_depth).

// One chunk of ns (1..K) sweeps from iteration *it + t_off, src -> dst; with
// u1 non-null, the state after sweep 0 goes there too; sweep 0's delta is
// max-accumulated into delta (zeroed by the caller).
int epic_tile2d_chunk(const void* src, void* dst, void* u1, const void* locked, int H, int W,
                      const void* it, int t_off, int ns, void* delta, int K, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Tiling g = make_tiling(locked, H, W, K);
  const size_t smem = smem_bytes(g.K);
  err = allow_smem(reinterpret_cast<const void*>(tile_chunk_kernel), smem);
  if (err != cudaSuccess) return err;
  tile_chunk_kernel<<<g.n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<float*>(u1), g,
      static_cast<const int*>(it), t_off, ns, static_cast<unsigned int*>(delta));
  return cudaGetLastError();
}

// `total` sweeps from *it + t_off spread over n_chunks ping-pong chunks
// (a -> b -> a ...), none deeper than K; deltas[c] gets chunk c's sweep-0
// delta (zeroed by the caller). The state ends in a when n_chunks is even.
int epic_tile2d_cycle(void* a, void* b, const void* locked, int H, int W, const void* it,
                      int t_off, int total, int n_chunks, void* deltas, int K, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g = make_tiling(locked, H, W, K);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&a, &b, &g, &it_i, &t_off, &total, &n_chunks, &d_u};
  return launch_cooperative(reinterpret_cast<const void*>(tile_cycle_kernel), kThreads, g.n_tiles,
                            smem_bytes(g.K), args, device, static_cast<cudaStream_t>(stream));
}

// The solve protocol in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in u and the three scalars are written back. twin and u1
// are scratch grids; acc two zeroed uint32 slots.
int epic_tile2d_solve(void* u, void* twin, void* u1, const void* locked, int H, int W,
                      const void* eps, int m_max, int bound, int stagger, void* acc,
                      void* it_io, void* delta_io, void* done_io, int K, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g = make_tiling(locked, H, W, K);
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&u, &twin, &u1, &g, &eps_f, &m_max, &bound, &stagger,
                  &acc, &it_io, &delta_io, &done_io};
  return launch_cooperative(reinterpret_cast<const void*>(tile_solve_kernel), kThreads, g.n_tiles,
                            smem_bytes(g.K), args, device, static_cast<cudaStream_t>(stream));
}

// One chunk of ns (1..K) sweeps from iteration *it + t_off on one shard's
// K-extended block: src, dst and u1 (u1 may be null) are views of he x we
// f32 cells with row pitch ld (elements), frozen a u8 view of the same shape
// and pitch; src is read, dst's centre (rows and columns K .. end-K) written,
// and with u1 the centre after sweep 0 too. par0 is (row0 + col0) & 1 of the
// view's (0, 0) in global coordinates. With delta non-null, sweep 0's delta
// over the whole block is max-accumulated into it (zeroed by the caller).
int epic_shard2d_chunk(const void* src, void* dst, void* u1, const void* frozen, long long ld,
                       int he, int we, int K, int par0, const void* it, int t_off, int ns,
                       void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Shard g;
  g.src = static_cast<const float*>(src);
  g.dst = static_cast<float*>(dst);
  g.u1 = static_cast<float*>(u1);
  g.frozen = static_cast<const uint8_t*>(frozen);
  g.ld = ld;
  g.he = he;
  g.we = we;
  g.K = K;
  g.par0 = par0 & 1;
  g.nx = (we - 2 * K + kTW - 1) / kTW;
  const int ny = (he - 2 * K + kTH - 1) / kTH;
  const size_t smem = smem_bytes(K);
  err = allow_smem(reinterpret_cast<const void*>(shard_chunk_kernel), smem);
  if (err != cudaSuccess) return err;
  shard_chunk_kernel<<<ny * g.nx, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int*>(it), t_off, ns, static_cast<unsigned int*>(delta));
  return cudaGetLastError();
}

// The resident route on one device's plan: `plan` is n_shards rows of
// kPlanCols int64 (see Plan) on the device; every shard's centre is h x w,
// its blocks (h + 2H) x (w + 2H) with row pitch ld, and K (<= H, h, w) the
// chunk depth. `total` sweeps from *it + t_off spread over n_chunks
// ping-pong chunks (set 0 -> set 1 -> set 0 ...), none deeper than K, in
// one cooperative launch; with with_u1, chunk 0 writes the centres after
// sweep 0 to set 2; deltas[c] gets chunk c's sweep-0 delta over the plan's
// centres (zeroed by the caller). The state ends in set 0 when n_chunks is
// even.
int epic_resident2d_cycle(const void* plan, int n_shards, int h, int w, int H, long long ld,
                          int K, const void* it, int t_off, int total, int n_chunks, int with_u1,
                          void* deltas, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan p = make_plan(plan, n_shards, h, w, H, ld, K);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&p, &it_i, &t_off, &total, &n_chunks, &with_u1, &d_u};
  return launch_cooperative(reinterpret_cast<const void*>(resident_cycle_kernel), kThreads,
                            n_shards * p.n_tiles, smem_bytes(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

// The solve protocol on a plan that covers the whole mesh (no neighbour
// copied by the host), in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in set 0 and the three scalars are written back. acc holds
// two zeroed uint32 slots.
int epic_resident2d_solve(const void* plan, int n_shards, int h, int w, int H, long long ld,
                          int K, const void* eps, int m_max, int bound, int stagger, void* acc,
                          void* it_io, void* delta_io, void* done_io, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan p = make_plan(plan, n_shards, h, w, H, ld, K);
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&p, &eps_f, &m_max, &bound, &stagger, &acc, &it_io, &delta_io, &done_io};
  return launch_cooperative(reinterpret_cast<const void*>(resident_solve_kernel), kThreads,
                            n_shards * p.n_tiles, smem_bytes(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
