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
// And the tiled route of the batched scenario solves, B independent H x W
// lanes of one [B, H, W] batch (lanes beyond the clusters of batched2d.cu):
//   epic_lanes2d_chunk <- epic_tpu/solver/pallas_batched.py:65 _block_kernel
//                         (K12: K sweeps of a collage of lanes, a delta a
//                         block), with the gating of _block_kernel_gated
//   epic_lanes2d_solve <- pallas_batched.py:214 _block_kernel_gated (K13)
//                         and the while_loop of _solve_collage_device
//                         (:275) that drives it: the lockstep protocol with
//                         per-lane retirement, in one launch
// with the plain version lanes_update_n / lanes_solve in
// epic_tpu_torch/solver/tiled.py (see "The lanes" below).
//
// Design. A full-width band never fits shared memory here (8192 columns x 48
// rows x 4 B is 1.6 MB), so one layout answers both TPU layouts: a block owns
// a TH x TW centre of the unpadded H x W grid (the last row and column of
// tiles ragged), loads the (TH+2K) x (TW+2K) cells of its halo-extended
// tile (u, and whether it is frozen: locked, the grid's ring, or outside the
// grid, where u is LOG_SPACE_OBSTACLE) into dynamic shared memory, and runs
// up to K sweeps there in place (a class reads only the other class;
// __syncthreads between sweeps). Sweep s updates a cell only inside the
// trapezoid of pallas_biggrid.py:251-255 (local row and column in (s,
// ext-1-s)), of the class (y + x) % 2 != (t0 + s) % 2 in global coordinates;
// after K sweeps the centre is exact and is written to dst, never to src,
// whose halo the neighbouring blocks read. So chunks ping-pong between two
// buffers, and grid-wide barriers (cooperative_groups::this_grid().sync())
// separate the chunks of a cycle or a solve.
//
// The tile in shared memory, class-split. Cell (lr, lc) of the extended
// tile has class q = (par + lr + lc) & 1 (par: the parity of local (0, 0) in
// global coordinates) and lives at a[q][lr * P + (lc >> 1)]: each class in
// its own array of P = (TW + 2K) / 2 cells a row. In a row the cells of
// class q are the columns o + 2j, o = (par + lr + q) & 1, so cell j's N and S
// neighbours are a[1-q] at rows lr -+ 1, index j, and its W and E ones a[1-q]
// at row lr, indices j + o - 1 and j + o: lanes at consecutive j touch
// consecutive words, free of bank conflicts. The frozen flags are bits, one
// a cell, in 32-bit words per class row (f[q][lr * NW + j / 32], bit j % 32),
// so a cell costs 4 B and 1/8 B of shared memory (smem_bytes), and the
// 96 x 160 tile at K = 16 (101 KB) leaves room for two blocks an SM. The
// load gives a lane the pair of columns (2m, 2m+1), which lands at index m
// of both arrays (one float2 __ldcg where the row's address allows), and
// builds the frozen words with two ballots.
//
// Sweeps with no division. A warp walks a strip of rows down the tile, its
// lanes at consecutive j, and keeps the other class's cells at its j in the
// rows above in registers: an update costs two shared loads (the row below,
// and the W or E neighbour that is not index j) besides its frozen word and
// its store. Rows go in pairs of known o, so no parity arithmetic is left a
// cell; sweep 0 is its own instantiation (kFirst), so the delta test stays
// out of sweeps 1..ns-1; lse4 runs on every lane and only the store is
// predicated. The loop comes to some 84 SASS instructions an update, of
// which lse4 is 71.
//
// Two tile shapes. Beyond the L2 the 96 x 160 tile (Big) is the fastest of
// the shapes measured: its class row of 96 cells at K = 16 is three whole
// warps, and its halo recompute 1.27x (64 x 128's is 1.39x). A launch whose
// grid, shard or plan gives the SMs fewer than two such tiles each (the
// maze, its mesh shards) runs on the 32 x 96 tile (Small) instead, which
// spreads the same work over more SMs.
//
// What each step measured on one 8192 x 4096 shard chunk at K = 16 (H100
// 80GB HBM3, 700 W; tile_probe --shapes2d, the earlier design 1.76 ms):
// class-split rows, a warp a row, at 64 x 128: 2.08 ms (a class row of 80
// cells idles a quarter of the lanes); a flat walk over the trapezoid's
// cells, one division a sweep: 1.83 ms, 1.60 ms at 96 x 160; the strip walk
// with registers down a column: 1.55 ms; rows in pairs of known parity:
// 1.39 ms; the predicated store: 1.35 ms. The small tile took the maze's
// tile solve from 225 ms to 116 ms. The solve kernels keep the tile and the
// pass's arguments in shared memory while they sweep (kStash), which is
// what lets them fit 64 registers with no spill.
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
// delta's (K14/K15) and K16/K17's interior delta's. The tile's load
// resolves the region once a row: a row of the view crosses at most three
// regions (left halo, centre, right halo), whose row addresses it computes
// from the table before its cells, so a cell only picks one of three.
//
// The lanes. A lane of the batch is a grid of its own with the same class
// rule ((y + x) % 2 != t % 2 in lane coordinates) and the same frozen ring,
// so a lane's tile is a GridTile of that grid: its source, locked and
// output pointers are the batch's offset by L * H * W, and its trapezoid,
// parity and delta cells are the lane's own. A cell beyond the lane (below
// a ragged last row, past the last column) is LOG_SPACE_OBSTACLE and
// frozen, never a cell of the next lane. A job is a (lane, tile) pair;
// blocks stride over the jobs of the lanes that run, as all_tiles strides
// over tiles, and sweep 0's delta goes as float bits through atomicMax into
// the lane's slot. A chunk of num_sweeps runs as ceil(num_sweeps / K)
// chunks of the pass that ping-pong between u and a twin batch, a grid
// barrier between them: HBM sees a lane's cell once per K sweeps, not once
// a sweep. A lane whose gate is off is neither read nor written.
// The solve runs every lane in lockstep on one iteration t: a checked
// chunk that writes u1, a barrier, then each lane's verdict (retire when
// delta < eps[L] and t + 1 >= m_max, its state its slice of u1, which no
// later chunk writes), then the rest of the cycle over the lanes still
// active. At the end each lane is copied into u from where its state is.
//
// Numerics. lse4 from sweep_common.cuh, no --use_fast_math: the kernels give
// the plain version's (and solver/core.py's) bits.
//
// Memory. The source is read with __ldcg (L2, not L1): in a cycle or a
// solve the previous chunk's blocks wrote it during the same launch.
//
// Bound on this card. A chunk of K sweeps moves each cell through HBM about
// once (the halo reads (1 + 2K/TH)(1 + 2K/TW) of the grid, 5 B a cell, plus
// 4 B written), so beyond L2 the kernels are not bound by HBM bytes, as K1
// is, but by the instructions the SMs issue: the accurate lse4 (four expf
// and a logf, no fast math: 71 SASS instructions, chip_smoke.py's
// LSE4_SASS) and the dozen around it, over the halo recompute and the lanes
// a class row leaves idle. chip_smoke.py's issue_bound_ms prices the useful
// updates at LSE4_SASS each; PERF.md holds the kernels' share of it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kObstacle = -1e6f;  // constants.LOG_SPACE_OBSTACLE

// The centre a block owns, the threads of a block and the blocks an SM the
// register budget is held to: the fastest of the shapes tile_probe
// --shapes2d measured on an H100 (PERF.md). solver/hopper_tile2d.py's TILE
// holds the same centre. A grid (or shard, or plan) too small to give every
// SM two such tiles runs on the small tile instead (TILE_SMALL there), which
// spreads it over more SMs at the cost of more halo recompute.
constexpr int kTH = 96;
constexpr int kTW = 160;
constexpr int kSmallTH = 32;
constexpr int kSmallTW = 96;
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0, "whole warps");

// A tile shape: a TH x TW centre; a class row of its extended tile at depth
// K holds class_row(K) cells of u and frozen_words(K) words of frozen bits.
template <int TH, int TW>
struct Shape {
  static_assert(TW % 2 == 0, "a class row is half of an extended row of even width");
  static constexpr int kTH = TH;
  static constexpr int kTW = TW;
  __host__ __device__ static constexpr int class_row(int K) { return TW / 2 + K; }
  __host__ __device__ static constexpr int frozen_words(int K) {
    return (class_row(K) + 31) / 32;
  }
};
using Big = Shape<kTH, kTW>;
using Small = Shape<kSmallTH, kSmallTW>;

// The grid, the tiling and the chunk depth bound of one launch.
struct Tiling {
  const uint8_t* locked;
  int H, W;       // the unpadded grid
  int K;          // halo depth: the most sweeps a chunk may run
  int nx;         // tiles across
  int n_tiles;
};

// The block's dynamic shared memory.
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

// Its layout for shape S at depth K: a(0), a(1) (u of each class, rows of P
// floats), then f(0), f(1) (the frozen bits of each class, rows of NW words).
template <class S>
struct Smem {
  int P, NW;
  int rows;   // TH + 2K
  __device__ __forceinline__ explicit Smem(int K)
      : P(S::class_row(K)), NW(S::frozen_words(K)), rows(S::kTH + 2 * K) {}
  __device__ __forceinline__ float* a(int q) const { return dyn_smem() + q * rows * P; }
  __device__ __forceinline__ uint32_t* f(int q) const {
    return reinterpret_cast<uint32_t*>(dyn_smem() + 2 * rows * P) + q * rows * NW;
  }
};

// Whether p is aligned to `bytes` (a power of two).
__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The centre (ch x cw of it), from shared memory to out (tile.at gives a
// centre cell's address).
template <class S, class Tile>
__device__ __forceinline__ void write_centre(const Smem<S>& m, int par, float* out,
                                             const Tile& tile) {
  for (int i = threadIdx.x; i < S::kTH * S::kTW; i += kThreads) {
    const int r = i / S::kTW;
    const int c = i - r * S::kTW;
    if (r < tile.ch && c < tile.cw) {
      const int lr = tile.K + r;
      const int lc = tile.K + c;
      *tile.at(out, r, c) = m.a((par + lr + lc) & 1)[lr * m.P + (lc >> 1)];
    }
  }
}

// Load the halo-extended tile into shared memory: a warp a row, a lane a
// pair of columns (2m, 2m+1), which go to index m of the row in both class
// arrays; the pair's frozen flags become bits by ballot. Cells beyond the
// source are LOG_SPACE_OBSTACLE and frozen, and so are the bits past a
// row's P cells, which no sweep reads.
template <class S, class Tile>
__device__ __forceinline__ void load_tile(const Tile& tile, const Smem<S>& m, int par) {
  const int lane = threadIdx.x & 31;
  for (int lr = threadIdx.x >> 5; lr < m.rows; lr += kWarps) {
    const typename Tile::Row row = tile.row(lr);
    const int qe = (par + lr) & 1;   // the class of the even local columns
    float* ae = m.a(qe) + lr * m.P;
    float* ao = m.a(qe ^ 1) + lr * m.P;
    for (int mb = 0; mb < m.P; mb += 32) {
      const int j = mb + lane;
      float ve = kObstacle, vo = kObstacle;
      bool fe = true, fo = true;
      if (j < m.P) {
        tile.pair(row, j, ve, fe, vo, fo);
        ae[j] = ve;
        ao[j] = vo;
      }
      const uint32_t be = __ballot_sync(0xffffffffu, fe);
      const uint32_t bo = __ballot_sync(0xffffffffu, fo);
      if (lane == 0) {
        m.f(qe)[lr * m.NW + (mb >> 5)] = be;
        m.f(qe ^ 1)[lr * m.NW + (mb >> 5)] = bo;
      }
    }
  }
}

// The update of one cell (cell j of row lr, local column lc) from its N, S,
// W and E neighbours into *cur, unless `ok` is false (outside the
// trapezoid) or its bit in `frozen` is set; with kFirst, |new - old| is
// max-accumulated into `local` where tile.in_delta admits the cell. The
// lse4 runs on every lane and only the store is predicated: a warp whose
// lanes are all skipped is rare on a map, and a branch around the update
// costs every other warp its divergence bookkeeping.
template <bool kFirst, class Tile>
__device__ __forceinline__ void update(const Tile& tile, bool ok, uint32_t frozen, uint32_t bit,
                                       int lr, int lc, float n, float s, float w, float e,
                                       float* cur, float& local) {
  const float v = lse4(n, s, w, e);
  if (ok && !(frozen & bit)) {
    if (kFirst && tile.in_delta(lr, lc)) local = fmaxf(local, fabsf(v - *cur));
    *cur = v;
  }
}

// One sweep s of class q inside the trapezoid (rows s+1..last_row(s),
// columns s+1..last_col(s)). A warp walks a strip of consecutive rows, its
// lanes at consecutive j (one column block of 32 after another, from the
// trapezoid's first j of either parity). Cell j of row lr is local column
// o + 2j, o = (par + lr + q) & 1 alternating down the strip, so the walk
// takes rows in pairs of o = 0 then o = 1 (a lone row at either end) and
// each lane knows at the start of a column block whether its cell lies in
// the trapezoid's columns for either parity. A lane keeps the other class's
// cells at its j in the rows above and at (`above`, `mid`): a row costs it
// one load for the row below and one for its W (o = 0) or E (o = 1)
// neighbour, the other side being index j itself. With kFirst (sweep 0) it
// returns `local` max-accumulated over the cells tile.in_delta admits.
template <bool kFirst, class S, class Tile>
__device__ __forceinline__ float sweep(const Tile& tile, const Smem<S>& m, int par, int q, int s,
                                       float local) {
  const int c0 = s + 1;                  // the first row and column
  const int c1 = tile.last_col(s);
  const int r1 = tile.last_row(s);
  const int strip = (r1 - s + kWarps - 1) / kWarps;
  const int first = c0 + (threadIdx.x >> 5) * strip;
  const int last = min(first + strip - 1, r1);
  const int jmax = c1 >> 1;              // the last j of either parity
  const int P = m.P;
  const int NW = m.NW;
  const int lane = threadIdx.x & 31;
  for (int j = (c0 >> 1) + lane; j - lane <= jmax; j += 32) {
    const bool in_j = j <= jmax;
    const bool ok0 = in_j && 2 * j >= c0 && 2 * j <= c1;           // o = 0: column 2j
    const bool ok1 = in_j && 2 * j + 1 >= c0 && 2 * j + 1 <= c1;   // o = 1: column 2j + 1
    const uint32_t bit = 1u << (j & 31);
    int lr = first;
    const float* col = m.a(q ^ 1) + lr * P + j;   // the other class, row lr, index j
    float* cur = m.a(q) + lr * P + j;
    const uint32_t* fz = m.f(q) + lr * NW + (j >> 5);
    if (lr > last) continue;
    float above = col[-P];
    float mid = col[0];
    if ((par + lr + q) & 1) {            // a first row of o = 1
      const float b = col[P];
      update<kFirst>(tile, ok1, *fz, bit, lr, 2 * j + 1, above, b, mid, col[1], cur, local);
      above = mid;
      mid = b;
      col += P;
      cur += P;
      fz += NW;
      ++lr;
    }
    for (; lr < last; lr += 2) {         // rows lr (o = 0) and lr + 1 (o = 1)
      const float b1 = col[P];
      update<kFirst>(tile, ok0, fz[0], bit, lr, 2 * j, above, b1, col[-1], mid, cur, local);
      const float b2 = col[2 * P];
      update<kFirst>(tile, ok1, fz[NW], bit, lr + 1, 2 * j + 1, mid, b2, b1, col[P + 1],
                     cur + P, local);
      above = b1;
      mid = b2;
      col += 2 * P;
      cur += 2 * P;
      fz += 2 * NW;
    }
    if (lr == last)                      // a last row of o = 0
      update<kFirst>(tile, ok0, *fz, bit, lr, 2 * j, above, col[P], col[-1], mid, cur, local);
  }
  return local;
}

// One chunk of `ns` (1..K) sweeps from iteration t0 on one tile, in the
// tile's local coordinates (local (0, 0) is the first cell of its K-deep
// halo): load the halo-extended tile, sweep it under the trapezoid that
// tile.last_row/last_col bound, write the centre to dst (and after sweep 0
// to u1, when given), max-accumulate sweep 0's delta over the cells that
// tile.in_delta admits into delta_acc (when given). Every thread of the
// block calls it. The Tile type is a compile-time choice, so each caller's
// pass holds only its own state. With kStash (the solve kernels, whose loop
// state stays live across the passes) the tile and the pass's arguments
// wait in shared memory, the same for every thread, while the block sweeps,
// so that the sweeps and the loop fit the 64 registers of two blocks an SM;
// elsewhere they stay in registers, which the sweeps measured faster with.
template <bool kStash, class Tile>
__device__ __forceinline__ void tile_pass(const Tile& tile_in, float* dst_in, float* u1_in,
                                          int t0_in, int ns_in, unsigned int* delta_acc_in) {
  struct Pass {
    Tile tile;
    float* dst;
    float* u1;
    unsigned int* delta_acc;
    int t0, ns;
  };
  __shared__ Pass stash;
  const Pass own{tile_in, dst_in, u1_in, delta_acc_in, t0_in, ns_in};
  if (kStash && threadIdx.x == 0) stash = own;
  const Smem<typename Tile::S> m(tile_in.K);
  const int par = tile_in.par();  // (row + column) & 1 of local (0, 0) in global coordinates
  load_tile(tile_in, m, par);
  __syncthreads();
  const Pass& pass = kStash ? stash : own;
  const Tile& tile = pass.tile;
  // Sweep t updates the class (par + lr + lc) & 1 == ((t0 + t) & 1) ^ 1.
  float local = sweep<true>(tile, m, par, ((pass.t0 & 1) ^ 1), 0, 0.0f);
  __syncthreads();
  if (pass.u1 != nullptr) {
    write_centre(m, par, pass.u1, tile);
    __syncthreads();
  }
  for (int s = 1; s < pass.ns; ++s) {
    sweep<false>(tile, m, par, ((pass.t0 + s) & 1) ^ 1, s, 0.0f);
    __syncthreads();
  }
  if (pass.delta_acc != nullptr) block_max_atomic<kThreads>(local, pass.delta_acc);
  write_centre(m, par, pass.dst, tile);
  __syncthreads();  // the next tile reuses the shared memory
}

// A tile of the unpadded H x W grid whose centre starts at (gy0, gx0):
// frozen cells are locked or on the grid's ring; beyond the grid
// LOG_SPACE_OBSTACLE, frozen; the trapezoid is the tile's own; the delta
// covers the centre's cells in the grid.
template <class Shape>
struct GridTile {
  using S = Shape;
  const float* src;
  const uint8_t* locked;
  int H, W, K, gy0, gx0, ch, cw;
  struct Row {
    long long idx;   // the grid index of local column 0 (x = gx0 - K)
    bool in, ring;   // the row lies in the grid; it is the grid's first or last
  };
  __device__ __forceinline__ Row row(int lr) const {
    const int y = gy0 - K + lr;
    return Row{static_cast<long long>(y) * W + gx0 - K, y >= 0 && y < H, y == 0 || y == H - 1};
  }
  __device__ __forceinline__ void cell(const Row& r, int lc, float& v, bool& f) const {
    const int x = gx0 - K + lc;
    if (r.in && x >= 0 && x < W) {
      v = __ldcg(src + r.idx + lc);
      f = locked[r.idx + lc] != 0 || r.ring || x == 0 || x == W - 1;
    }
  }
  __device__ __forceinline__ void pair(const Row& r, int j, float& ve, bool& fe, float& vo,
                                       bool& fo) const {
    const int x = gx0 - K + 2 * j;
    const float* p = src + r.idx + 2 * j;
    const uint8_t* l = locked + r.idx + 2 * j;
    if (r.in && x >= 0 && x + 1 < W && aligned(p, 8) && aligned(l, 2)) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
      const uchar2 b = *reinterpret_cast<const uchar2*>(l);
      ve = v.x;
      vo = v.y;
      fe = b.x != 0 || r.ring || x == 0;
      fo = b.y != 0 || r.ring || x + 1 == W - 1;
    } else {
      cell(r, 2 * j, ve, fe);
      cell(r, 2 * j + 1, vo, fo);
    }
  }
  __device__ __forceinline__ int par() const { return (gy0 + gx0) & 1; }  // -2K is even
  __device__ __forceinline__ int last_row(int s) const { return S::kTH + 2 * K - 2 - s; }
  __device__ __forceinline__ int last_col(int s) const { return S::kTW + 2 * K - 2 - s; }
  __device__ __forceinline__ bool in_delta(int lr, int lc) const {
    return lr >= K && lr < K + ch && lc >= K && lc < K + cw;
  }
  __device__ __forceinline__ float* at(float* out, int r, int c) const {
    return out + static_cast<size_t>(gy0 + r) * W + gx0 + c;
  }
};

// One chunk of `ns` (1..K) sweeps from iteration t0 on tile `tile` of the
// grid, src -> dst (and u1).
template <class S, bool kStash = false>
__device__ void tile_chunk(const float* src, float* dst, float* u1, const Tiling& g, int tile,
                           int t0, int ns, unsigned int* delta_acc) {
  const int ty = tile / g.nx;
  const int gy0 = ty * S::kTH;
  const int gx0 = (tile - ty * g.nx) * S::kTW;
  const GridTile<S> t{src, g.locked, g.H, g.W, g.K, gy0, gx0, min(S::kTH, g.H - gy0),
                      min(S::kTW, g.W - gx0)};
  tile_pass<kStash>(t, dst, u1, t0, ns, delta_acc);
}

// All tiles of one chunk, strided over the blocks.
template <class S, bool kStash = false>
__device__ void all_tiles(const float* src, float* dst, float* u1, const Tiling& g, int t0,
                          int ns, unsigned int* delta_acc) {
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x)
    tile_chunk<S, kStash>(src, dst, u1, g, tile, t0, ns, delta_acc);
}

// K3/K5 (and T1/T2): one chunk from iteration *it + t_off; a block a tile.
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_chunk_kernel(const float* src, float* dst, float* u1, Tiling g, const int* it, int t_off,
                  int ns, unsigned int* delta_bits) {
  tile_chunk<S>(src, dst, u1, g, blockIdx.x, *it + t_off, ns, delta_bits);
}

// K4/K6: `total` sweeps from *it + t_off spread over n_chunks chunks; chunk
// c reads a when c is even and b otherwise and writes the other, its
// sweep-0 delta into deltas[c] (zeroed by the caller). An even count ends in
// a.
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_cycle_kernel(float* a, float* b, Tiling g, const int* it, int t_off, int total,
                  int n_chunks, unsigned int* deltas) {
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_tiles<S>((c & 1) ? b : a, (c & 1) ? a : b, nullptr, g, t, ns, deltas + c);
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
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_solve_kernel(float* u, float* twin, float* u1, Tiling g, const float* eps_ptr, int m_max,
                  int bound, int stagger, unsigned int* acc, int* it_io, float* delta_io,
                  int* done_io) {
  cg::grid_group grid = cg::this_grid();
  // Few registers stay live across the tile passes: where the state is
  // follows from the count of chunks run (u after an even count, twin after
  // an odd one), and the schedule and eps are read again where needed.
  int it = *it_io;
  float delta = *delta_io;
  bool done = *done_io != 0;
  int flips = 0;
  int slot = 0;
  while (!done && it < bound) {
    const int depth = min(g.K, stagger);
    all_tiles<S, true>((flips & 1) ? twin : u, (flips & 1) ? u : twin, u1, g, it, depth,
                       acc + slot);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < *eps_ptr && it + 1 >= m_max;
    if (done) {
      it += 1;
      break;
    }
    ++flips;
    const int rest = stagger - depth;
    const int n_rest = (rest + g.K - 1) / g.K;
    int t = it + depth;
    for (int r = 0; r < n_rest; ++r) {
      const int ns = spread_at(rest, n_rest, r);
      all_tiles<S, true>((flips & 1) ? twin : u, (flips & 1) ? u : twin, nullptr, g, t, ns,
                         nullptr);
      grid.sync();
      ++flips;
      t += ns;
    }
    if (n_rest == 0) grid.sync();
    it += stagger;
  }
  const float* cur = done ? u1 : (flips & 1) ? twin : u;
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
template <class Shape>
struct ShardTile {
  using S = Shape;
  const float* src;
  const uint8_t* frozen;
  long long ld;
  int he, we, K, par0, r0, c0, ch, cw;
  struct Row {
    long long idx;   // the view index of local column 0 (view column c0)
    int n;           // the row's cells inside the view (0 below it)
  };
  __device__ __forceinline__ Row row(int lr) const {
    const int R = r0 + lr;
    return Row{static_cast<long long>(R) * ld + c0, R < he ? we - c0 : 0};
  }
  __device__ __forceinline__ void cell(const Row& r, int lc, float& v, bool& f) const {
    if (lc < r.n) {
      v = __ldcg(src + r.idx + lc);
      f = frozen[r.idx + lc] != 0;
    }
  }
  __device__ __forceinline__ void pair(const Row& r, int j, float& ve, bool& fe, float& vo,
                                       bool& fo) const {
    const float* p = src + r.idx + 2 * j;
    const uint8_t* l = frozen + r.idx + 2 * j;
    if (2 * j + 1 < r.n && aligned(p, 8) && aligned(l, 2)) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
      const uchar2 b = *reinterpret_cast<const uchar2*>(l);
      ve = v.x;
      vo = v.y;
      fe = b.x != 0;
      fo = b.y != 0;
    } else {
      cell(r, 2 * j, ve, fe);
      cell(r, 2 * j + 1, vo, fo);
    }
  }
  __device__ __forceinline__ int par() const { return (par0 + r0 + c0) & 1; }
  __device__ __forceinline__ int last_row(int s) const {
    return min(S::kTH + 2 * K, he - r0) - 2 - s;
  }
  __device__ __forceinline__ int last_col(int s) const {
    return min(S::kTW + 2 * K, we - c0) - 2 - s;
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
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
shard_chunk_kernel(Shard g, const int* it, int t_off, int ns, unsigned int* delta_bits) {
  const int ty = blockIdx.x / g.nx;
  const int r0 = ty * S::kTH;
  const int c0 = (blockIdx.x - ty * g.nx) * S::kTW;
  const ShardTile<S> t{g.src, g.frozen, g.ld, g.he, g.we, g.K, g.par0, r0, c0,
                       min(S::kTH, g.he - 2 * g.K - r0), min(S::kTW, g.we - 2 * g.K - c0)};
  tile_pass<false>(t, g.dst, g.u1, *it + t_off, ns, delta_bits);
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
template <class Shape>
struct ResidentTile {
  using S = Shape;
  const Regions* reg;
  const uint8_t* frozen;   // at the view's (0, 0)
  long long ld;
  int h, w, K, par0, r0, c0, ch, cw;
  struct Row {
    const float *s0, *s1, *s2;   // local column 0 of this row in the left, centre and
                                 // right column band's source
    long long idx;               // the view index of local column 0 (the frozen bytes)
    int n;                       // the row's cells inside the view (0 below it)
    int t1, t2;                  // the local columns where the centre and the right band start
  };
  __device__ __forceinline__ Row row(int lr) const {
    const int R = r0 + lr;
    const int n = 3 * ((R >= K) + (R >= K + h));   // the row band's first region
    Row r;
    r.idx = static_cast<long long>(R) * ld + c0;
    r.s0 = reg->src[n] + (r.idx - reg->shift[n]);
    r.s1 = reg->src[n + 1] + (r.idx - reg->shift[n + 1]);
    r.s2 = reg->src[n + 2] + (r.idx - reg->shift[n + 2]);
    r.n = R < h + 2 * K ? w + 2 * K - c0 : 0;
    r.t1 = K - c0;
    r.t2 = K + w - c0;
    return r;
  }
  // The source of local column lc of the row.
  __device__ __forceinline__ const float* seg(const Row& r, int lc) const {
    return lc < r.t1 ? r.s0 : lc < r.t2 ? r.s1 : r.s2;
  }
  __device__ __forceinline__ void cell(const Row& r, int lc, float& v, bool& f) const {
    if (lc < r.n) {
      v = __ldcg(seg(r, lc) + lc);
      f = frozen[r.idx + lc] != 0;
    }
  }
  __device__ __forceinline__ void pair(const Row& r, int j, float& ve, bool& fe, float& vo,
                                       bool& fo) const {
    const float* base = seg(r, 2 * j);
    const float* p = base + 2 * j;
    const uint8_t* l = frozen + r.idx + 2 * j;
    if (2 * j + 1 < r.n && base == seg(r, 2 * j + 1) && aligned(p, 8) && aligned(l, 2)) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
      const uchar2 f2 = *reinterpret_cast<const uchar2*>(l);
      ve = v.x;
      vo = v.y;
      fe = f2.x != 0;
      fo = f2.y != 0;
    } else {
      cell(r, 2 * j, ve, fe);
      cell(r, 2 * j + 1, vo, fo);
    }
  }
  __device__ __forceinline__ int par() const { return (par0 + r0 + c0) & 1; }
  __device__ __forceinline__ int last_row(int s) const {
    return min(S::kTH + 2 * K, h + 2 * K - r0) - 2 - s;
  }
  __device__ __forceinline__ int last_col(int s) const {
    return min(S::kTW + 2 * K, w + 2 * K - c0) - 2 - s;
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
template <class S, bool kStash>
__device__ void resident_job(const Plan& p, int job, int src_set, int dst_set, bool with_u1,
                             int t0, int ns, unsigned int* delta_acc, Regions* reg) {
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
  const int r0 = ty * S::kTH;
  const int c0 = (tile - ty * p.nx) * S::kTW;
  const ResidentTile<S> t{reg, reinterpret_cast<const uint8_t*>(row[kPlanFrozen]) + v0, p.ld,
                          p.h, p.w, p.K, static_cast<int>(row[kPlanPar0]), r0, c0,
                          min(S::kTH, p.h - r0), min(S::kTW, p.w - c0)};
  float* dst = reinterpret_cast<float*>(row[dst_set]) + v0;
  float* u1 = with_u1 ? reinterpret_cast<float*>(row[2]) + v0 : nullptr;
  tile_pass<kStash>(t, dst, u1, t0, ns, delta_acc);
}

// Every (shard, tile) job of one chunk, strided over the blocks.
template <class S, bool kStash = false>
__device__ void all_resident_jobs(const Plan& p, int src_set, int dst_set, bool with_u1, int t0,
                                  int ns, unsigned int* delta_acc, Regions* reg) {
  const int jobs = p.n_shards * p.n_tiles;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x)
    resident_job<S, kStash>(p, job, src_set, dst_set, with_u1, t0, ns, delta_acc, reg);
}

// K16/K17: `total` sweeps from *it + t_off over n_chunks chunks on every
// shard of the plan; chunk c reads set c & 1 and writes the other, its
// sweep-0 delta (max over the plan's centres) into deltas[c] (zeroed by the
// caller); with with_u1, chunk 0 writes u1 too. An even count ends in set 0.
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
resident_cycle_kernel(Plan p, const int* it, int t_off, int total, int n_chunks, int with_u1,
                      unsigned int* deltas) {
  __shared__ Regions reg;
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_resident_jobs<S>(p, c & 1, (c & 1) ^ 1, c == 0 && with_u1 != 0, t, ns, deltas + c, &reg);
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
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
resident_solve_kernel(Plan p, const float* eps_ptr, int m_max, int bound, int stagger,
                      unsigned int* acc, int* it_io, float* delta_io, int* done_io) {
  __shared__ Regions reg;
  cg::grid_group grid = cg::this_grid();
  // Only the iteration and `cur` stay live across the passes: cur's bits
  // 0-1 the set holding the state (2: u1, after a passing check), bit 2 the
  // next check's slot, bit 3 set once a check ran (the last check's delta is
  // read back from its slot at the end). The incoming verdict is kept in
  // shared memory (thread 0 writes *done_io at the end, while another block
  // may still be reading). The rest of a cycle runs in chunks of K and a
  // last shorter one, as plain_solve runs it.
  __shared__ int done0;
  if (threadIdx.x == 0) done0 = *done_io;
  __syncthreads();
  int it = *it_io;
  int cur = 0;
  while (done0 == 0 && it < bound) {
    const int depth = min(p.K, stagger);
    const int slot = (cur >> 2) & 1;
    all_resident_jobs<S, true>(p, cur & 3, (cur & 3) ^ 1, true, it, depth, acc + slot, &reg);
    grid.sync();
    const float delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    cur = (cur ^ 4) | 8;
    if (delta < *eps_ptr && it + 1 >= m_max) {
      it += 1;
      cur = (cur & 12) | 2;
      break;
    }
    cur ^= 1;
    int t = it + depth;
    if (t == it + stagger) grid.sync();
    for (; t < it + stagger; t += p.K) {
      all_resident_jobs<S, true>(p, cur & 3, (cur & 3) ^ 1, false, t, min(p.K, it + stagger - t),
                                 nullptr, &reg);
      grid.sync();
      cur ^= 1;
    }
    it += stagger;
  }
  if ((cur & 3) != 0) copy_centres(p, cur & 3, 0, grid);
  if (grid.thread_rank() == 0) {
    if (cur & 8) *delta_io = __uint_as_float(__ldcg(acc + (((cur >> 2) & 1) ^ 1)));
    *done_io = done0 != 0 || (cur & 3) == 2 ? 1 : 0;
    *it_io = it;
  }
}

// A batch of B lanes (K12/K13's tiled route): `one` tiles a single H x W
// lane, its `locked` the batch's first lane.
struct Lanes {
  Tiling one;
  int B;
};

// Which lanes a chunk sweeps: not one whose flag (when flags is given)
// equals `stop`, nor, when d is given, one whose delta d[L] is below eps[L]
// (the lanes that just passed the exit rule). Every thread of a block
// reads the same answer.
struct LaneGate {
  const uint8_t* flags;
  uint8_t stop;
  const unsigned int* d;
  const float* eps;
  __device__ __forceinline__ bool runs(int L) const {
    if (flags != nullptr && __ldcg(flags + L) == stop) return false;
    return d == nullptr || !(__uint_as_float(__ldcg(d + L)) < eps[L]);
  }
};

// Every (lane, tile) job of one chunk over the lanes the gate runs, strided
// over the blocks: lane L's tile is a GridTile of the lane on the batch's
// pointers offset by L * H * W, its sweep-0 delta into deltas[L] (when
// given).
template <class S, bool kStash>
__device__ void all_lane_jobs(const float* src, float* dst, float* u1, const Lanes& b,
                              const LaneGate& gate, int t0, int ns, unsigned int* deltas) {
  const int n_tiles = b.one.n_tiles;
  const int jobs = b.B * n_tiles;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int L = job / n_tiles;
    if (!gate.runs(L)) continue;
    const size_t off = static_cast<size_t>(L) * b.one.H * b.one.W;
    Tiling lane = b.one;
    lane.locked += off;
    tile_chunk<S, kStash>(src + off, dst + off, u1 == nullptr ? nullptr : u1 + off, lane,
                          job - L * n_tiles, t0, ns, deltas == nullptr ? nullptr : deltas + L);
  }
}

// Lane L of `from` into the same lane of `to`, by the whole grid.
__device__ void copy_lane(const float* from, float* to, const Lanes& b, int L,
                          cg::grid_group& grid) {
  const size_t n = static_cast<size_t>(b.one.H) * b.one.W;
  const size_t off = static_cast<size_t>(L) * n;
  for (size_t i = grid.thread_rank(); i < n; i += grid.size()) to[off + i] = __ldcg(from + off + i);
}

// K12 on the tiled route: num_sweeps sweeps from iteration *it over the
// lanes whose active flag is 1 (every lane when active is null), as
// ceil(num_sweeps / K) chunks spread as tiled.spread spreads them, u ->
// twin -> u ...; chunk 0's delta max-accumulated into delta_bits[L] (zeroed
// by the caller: a lane that does not run keeps 0). After an odd count the
// running lanes are copied back into u. One call site of the pass.
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lanes_tile_chunk_kernel(float* u, float* twin, Lanes b, const int* it, int num_sweeps,
                        const uint8_t* active, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const LaneGate gate{active, 0, nullptr, nullptr};
  const int n_chunks = (num_sweeps + b.one.K - 1) / b.one.K;
  int t = *it;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(num_sweeps, n_chunks, c);
    if (c > 0) grid.sync();
    all_lane_jobs<S, false>((c & 1) ? twin : u, (c & 1) ? u : twin, nullptr, b, gate, t, ns,
                            c == 0 ? delta_bits : nullptr);
    t += ns;
  }
  if (n_chunks & 1) {
    grid.sync();
    for (int L = 0; L < b.B; ++L)
      if (gate.runs(L)) copy_lane(twin, u, b, L, grid);
  }
}

// K13 and _solve_collage_device's loop on the tiled route: the lockstep
// protocol of solver/batched.py lockstep for every lane at once, from t = 0
// while t < max_iterations. A cycle: the checked chunk of depth
// min(K, stagger) over the lanes not retired, writing u1 too, its deltas
// into acc's half `slot`; a barrier; each lane's owner thread records its
// delta and iteration count, retires it when delta < eps[L] and t + 1 >=
// m_max (its state is then its u1 slice, which no later chunk writes),
// clears its word of the other half and counts the lanes still active into
// count[slot]; then the remaining stagger - depth sweeps as further chunks
// over the lanes the gate runs: not retired before the cycle, nor passing
// the exit rule on this cycle's delta (so a block never waits for the
// owners' flags, whichever value of a flag being written it reads), a
// barrier after each (one more when there is none). Then every thread reads
// the same count and exits at 0. Each of acc's two [B] halves and count's
// two slots is cleared one cycle before its next use, with at least one
// barrier between the clear and the next atomics. The chunk count `flips`
// says where an active lane's state is (twin when odd); at the end each
// lane is copied into u from u1 or the twin. The caller zeroes acc, count,
// retired and iters and sets deltas to eps + 1, the values a lane keeps if
// it never runs a check. One call site of the pass (see tile3d.cu's solve).
template <class S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lanes_tile_solve_kernel(float* u, float* twin, float* u1, Lanes b, const float* eps,
                        int m_max, int max_iterations, int stagger, unsigned int* acc,
                        int* count, uint8_t* retired, int* iters, float* deltas) {
  cg::grid_group grid = cg::this_grid();
  const int depth = min(b.one.K, stagger);
  const int rest = stagger - depth;
  const int n_rest = (rest + b.one.K - 1) / b.one.K;
  int flips = 0;
  int slot = 0;
  for (int t = 0; t < max_iterations; t += stagger) {
    unsigned int* now = acc + static_cast<size_t>(slot) * b.B;
    int ts = t;
    for (int c = 0; c <= n_rest; ++c) {
      const bool check = c == 0;
      const int ns = check ? depth : spread_at(rest, n_rest, c - 1);
      const LaneGate gate{retired, 1, !check && t + 1 >= m_max ? now : nullptr, eps};
      all_lane_jobs<S, true>((flips & 1) ? twin : u, (flips & 1) ? u : twin,
                             check ? u1 : nullptr, b, gate, ts, ns, check ? now : nullptr);
      grid.sync();
      ++flips;
      ts += ns;
      if (check) {
        int still = 0;
        for (long long L = grid.thread_rank(); L < b.B; L += grid.size()) {
          if (__ldcg(retired + L) == 0) {
            const float d = __uint_as_float(__ldcg(now + L));
            const bool done = d < eps[L] && t + 1 >= m_max;
            deltas[L] = d;
            iters[L] = done ? t + 1 : t + stagger;
            if (done) {
              retired[L] = 1;
            } else {
              ++still;
            }
          }
          acc[static_cast<size_t>(slot ^ 1) * b.B + L] = 0u;
        }
        for (int off = 16; off > 0; off >>= 1) still += __shfl_xor_sync(0xffffffffu, still, off);
        if ((threadIdx.x & 31) == 0 && still > 0) atomicAdd(count + slot, still);
      }
    }
    if (n_rest == 0) grid.sync();
    if (__ldcg(count + slot) == 0) break;
    if (grid.thread_rank() == 0) count[slot ^ 1] = 0;
    slot ^= 1;
  }
  const float* cur = (flips & 1) ? twin : u;
  for (int L = 0; L < b.B; ++L) {
    const float* from = __ldcg(retired + L) ? u1 : cur;
    if (from != u) copy_lane(from, u, b, L, grid);
  }
}

// Tiles of shape S across w columns, and over an h x w centre.
template <class S>
int tiles_across(int w) {
  return (w + S::kTW - 1) / S::kTW;
}
template <class S>
long long tile_count(int h, int w) {
  return static_cast<long long>((h + S::kTH - 1) / S::kTH) * tiles_across<S>(w);
}

// The shape for work of n_big big tiles on `device`: the big tile where it
// gives every SM two (the blocks an SM holds at the default depth), else
// the small one. The SM count is read once a device (a launch on the mesh's
// small shards is host bound).
bool use_big(long long n_big, int device) {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int n = device >= 0 && device < kDevices ? sms[device] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return true;
    if (device >= 0 && device < kDevices) sms[device] = n;
  }
  return n_big >= 2LL * n;
}

template <class S>
Plan make_plan(const void* rows, int n_shards, int h, int w, int H, long long ld, int K) {
  Plan p;
  p.rows = static_cast<const long long*>(rows);
  p.ld = ld;
  p.n_shards = n_shards;
  p.h = h;
  p.w = w;
  p.H = H;
  p.K = K;
  p.nx = tiles_across<S>(w);
  p.n_tiles = static_cast<int>(tile_count<S>(h, w));
  return p;
}

// The dynamic shared memory of one block of shape S (Smem): two class arrays
// of u and two of frozen words, TH + 2K rows each. solver/hopper_tile2d.py's
// tile_smem_bytes gives the same.
template <class S>
size_t smem_bytes(int K) {
  return static_cast<size_t>(S::kTH + 2 * K) * 2 *
         (S::class_row(K) * sizeof(float) + S::frozen_words(K) * sizeof(uint32_t));
}

template <class S>
Tiling make_tiling(const void* locked, int H, int W, int K) {
  Tiling g;
  g.locked = static_cast<const uint8_t*>(locked);
  g.H = H;
  g.W = W;
  g.K = K;
  g.nx = tiles_across<S>(W);
  g.n_tiles = static_cast<int>(tile_count<S>(H, W));
  return g;
}

template <class S>
int tile2d_chunk(const void* src, void* dst, void* u1, const void* locked, int H, int W,
                 const void* it, int t_off, int ns, void* delta, int K, void* stream) {
  const Tiling g = make_tiling<S>(locked, H, W, K);
  const size_t smem = smem_bytes<S>(g.K);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(tile_chunk_kernel<S>), smem);
  if (err != cudaSuccess) return err;
  tile_chunk_kernel<S><<<g.n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<float*>(u1), g,
      static_cast<const int*>(it), t_off, ns, static_cast<unsigned int*>(delta));
  return cudaGetLastError();
}

template <class S>
int tile2d_cycle(void* a, void* b, const void* locked, int H, int W, const void* it, int t_off,
                 int total, int n_chunks, void* deltas, int K, void* stream, int device) {
  Tiling g = make_tiling<S>(locked, H, W, K);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&a, &b, &g, &it_i, &t_off, &total, &n_chunks, &d_u};
  return launch_cooperative(reinterpret_cast<const void*>(tile_cycle_kernel<S>), kThreads,
                            g.n_tiles, smem_bytes<S>(g.K), args, device,
                            static_cast<cudaStream_t>(stream));
}

template <class S>
int tile2d_solve(void* u, void* twin, void* u1, const void* locked, int H, int W,
                 const void* eps, int m_max, int bound, int stagger, void* acc, void* it_io,
                 void* delta_io, void* done_io, int K, void* stream, int device) {
  Tiling g = make_tiling<S>(locked, H, W, K);
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&u, &twin, &u1, &g, &eps_f, &m_max, &bound, &stagger,
                  &acc, &it_io, &delta_io, &done_io};
  return launch_cooperative(reinterpret_cast<const void*>(tile_solve_kernel<S>), kThreads,
                            g.n_tiles, smem_bytes<S>(g.K), args, device,
                            static_cast<cudaStream_t>(stream));
}

template <class S>
int shard2d_chunk(Shard g, const void* it, int t_off, int ns, void* delta, void* stream) {
  g.nx = tiles_across<S>(g.we - 2 * g.K);
  const int n = static_cast<int>(tile_count<S>(g.he - 2 * g.K, g.we - 2 * g.K));
  const size_t smem = smem_bytes<S>(g.K);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(shard_chunk_kernel<S>), smem);
  if (err != cudaSuccess) return err;
  shard_chunk_kernel<S><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int*>(it), t_off, ns, static_cast<unsigned int*>(delta));
  return cudaGetLastError();
}

template <class S>
int resident2d_cycle(const void* plan, int n_shards, int h, int w, int H, long long ld, int K,
                     const void* it, int t_off, int total, int n_chunks, int with_u1,
                     void* deltas, void* stream, int device) {
  Plan p = make_plan<S>(plan, n_shards, h, w, H, ld, K);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&p, &it_i, &t_off, &total, &n_chunks, &with_u1, &d_u};
  return launch_cooperative(reinterpret_cast<const void*>(resident_cycle_kernel<S>), kThreads,
                            n_shards * p.n_tiles, smem_bytes<S>(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

template <class S>
int resident2d_solve(const void* plan, int n_shards, int h, int w, int H, long long ld, int K,
                     const void* eps, int m_max, int bound, int stagger, void* acc, void* it_io,
                     void* delta_io, void* done_io, void* stream, int device) {
  Plan p = make_plan<S>(plan, n_shards, h, w, H, ld, K);
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&p, &eps_f, &m_max, &bound, &stagger, &acc, &it_io, &delta_io, &done_io};
  return launch_cooperative(reinterpret_cast<const void*>(resident_solve_kernel<S>), kThreads,
                            n_shards * p.n_tiles, smem_bytes<S>(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

// Whether the tiled route takes B lanes of H x W at depth K: a lane of at
// least one cell, a depth of at least one sweep, and a job count that fits
// an int.
bool lanes_ok(int B, int H, int W, int K) {
  return B >= 0 && H >= 1 && W >= 1 && K >= 1 && B * tile_count<Small>(H, W) <= INT_MAX;
}

template <class S>
int lanes2d_chunk(float* u, float* twin, const void* locked, int B, int H, int W, const int* it,
                  int num_sweeps, const uint8_t* active, unsigned int* delta, int K, void* stream,
                  int device) {
  Lanes b{make_tiling<S>(locked, H, W, K), B};
  void* args[] = {&u, &twin, &b, &it, &num_sweeps, &active, &delta};
  return launch_cooperative(reinterpret_cast<const void*>(lanes_tile_chunk_kernel<S>),
                            kThreads, B * b.one.n_tiles, smem_bytes<S>(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

template <class S>
int lanes2d_solve(float* u, float* twin, float* u1, const void* locked, int B, int H, int W,
                  const float* eps, int m_max, int max_iterations, int stagger,
                  unsigned int* acc, int* count, uint8_t* retired, int* iters, float* deltas,
                  int K, void* stream, int device) {
  Lanes b{make_tiling<S>(locked, H, W, K), B};
  void* args[] = {&u, &twin, &u1, &b, &eps, &m_max, &max_iterations, &stagger,
                  &acc, &count, &retired, &iters, &deltas};
  return launch_cooperative(reinterpret_cast<const void*>(lanes_tile_solve_kernel<S>),
                            kThreads, B * b.one.n_tiles, smem_bytes<S>(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch of depth K asks for on the big tile
// (the small tile asks for less).
long long epic_tile2d_smem_bytes(int K) { return static_cast<long long>(smem_bytes<Big>(K)); }

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u, twin, u1, src and dst are f32[H, W] and locked
// u8[H, W], contiguous; src and dst are distinct. K is the halo depth
// (SolverConfig.tile_depth). Each picks the tile shape by use_big.

// One chunk of ns (1..K) sweeps from iteration *it + t_off, src -> dst; with
// u1 non-null, the state after sweep 0 goes there too; sweep 0's delta is
// max-accumulated into delta (zeroed by the caller).
int epic_tile2d_chunk(const void* src, void* dst, void* u1, const void* locked, int H, int W,
                      const void* it, int t_off, int ns, void* delta, int K, void* stream,
                      int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return use_big(tile_count<Big>(H, W), device)
             ? tile2d_chunk<Big>(src, dst, u1, locked, H, W, it, t_off, ns, delta, K, stream)
             : tile2d_chunk<Small>(src, dst, u1, locked, H, W, it, t_off, ns, delta, K, stream);
}

// `total` sweeps from *it + t_off spread over n_chunks ping-pong chunks
// (a -> b -> a ...), none deeper than K; deltas[c] gets chunk c's sweep-0
// delta (zeroed by the caller). The state ends in a when n_chunks is even.
int epic_tile2d_cycle(void* a, void* b, const void* locked, int H, int W, const void* it,
                      int t_off, int total, int n_chunks, void* deltas, int K, void* stream,
                      int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return use_big(tile_count<Big>(H, W), device)
             ? tile2d_cycle<Big>(a, b, locked, H, W, it, t_off, total, n_chunks, deltas, K,
                                 stream, device)
             : tile2d_cycle<Small>(a, b, locked, H, W, it, t_off, total, n_chunks, deltas, K,
                                   stream, device);
}

// The solve protocol in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in u and the three scalars are written back. twin and u1
// are scratch grids; acc two zeroed uint32 slots.
int epic_tile2d_solve(void* u, void* twin, void* u1, const void* locked, int H, int W,
                      const void* eps, int m_max, int bound, int stagger, void* acc,
                      void* it_io, void* delta_io, void* done_io, int K, void* stream,
                      int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return use_big(tile_count<Big>(H, W), device)
             ? tile2d_solve<Big>(u, twin, u1, locked, H, W, eps, m_max, bound, stagger, acc,
                                 it_io, delta_io, done_io, K, stream, device)
             : tile2d_solve<Small>(u, twin, u1, locked, H, W, eps, m_max, bound, stagger, acc,
                                   it_io, delta_io, done_io, K, stream, device);
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
  const cudaError_t err = cudaSetDevice(device);
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
  return use_big(tile_count<Big>(he - 2 * K, we - 2 * K), device)
             ? shard2d_chunk<Big>(g, it, t_off, ns, delta, stream)
             : shard2d_chunk<Small>(g, it, t_off, ns, delta, stream);
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return use_big(n_shards * tile_count<Big>(h, w), device)
             ? resident2d_cycle<Big>(plan, n_shards, h, w, H, ld, K, it, t_off, total,
                                     n_chunks, with_u1, deltas, stream, device)
             : resident2d_cycle<Small>(plan, n_shards, h, w, H, ld, K, it, t_off, total,
                                       n_chunks, with_u1, deltas, stream, device);
}

// The solve protocol on a plan that covers the whole mesh (no neighbour
// copied by the host), in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in set 0 and the three scalars are written back. acc holds
// two zeroed uint32 slots.
int epic_resident2d_solve(const void* plan, int n_shards, int h, int w, int H, long long ld,
                          int K, const void* eps, int m_max, int bound, int stagger, void* acc,
                          void* it_io, void* delta_io, void* done_io, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return use_big(n_shards * tile_count<Big>(h, w), device)
             ? resident2d_solve<Big>(plan, n_shards, h, w, H, ld, K, eps, m_max, bound, stagger,
                                     acc, it_io, delta_io, done_io, stream, device)
             : resident2d_solve<Small>(plan, n_shards, h, w, H, ld, K, eps, m_max, bound,
                                       stagger, acc, it_io, delta_io, done_io, stream, device);
}

// The batched entries' tiled route (K12, K13): u, twin and u1 are f32[B, H,
// W] and locked u8[B, H, W], contiguous and distinct; any B, H and W (odd
// ones too); K the halo depth. Both pick the tile shape by use_big over the
// jobs of every lane and refuse (cudaErrorInvalidValue, no launch) a lane
// or depth lanes_ok does not take; B = 0 launches nothing.

// num_sweeps (>= 1) sweeps from iteration *it of the lanes whose active flag
// (u8[B], or null for all) is 1, u updated in place (twin is scratch); each
// running lane's sweep-0 delta max-accumulated into delta[L] (f32[B],
// zeroed by the caller).
int epic_lanes2d_chunk(void* u, void* twin, const void* locked, int B, int H, int W,
                       const void* it, int num_sweeps, const void* active, void* delta, int K,
                       void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!lanes_ok(B, H, W, K) || num_sweeps < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  float* u_f = static_cast<float*>(u);
  float* twin_f = static_cast<float*>(twin);
  const int* it_i = static_cast<const int*>(it);
  const uint8_t* active_b = static_cast<const uint8_t*>(active);
  unsigned int* delta_u = static_cast<unsigned int*>(delta);
  return use_big(B * tile_count<Big>(H, W), device)
             ? lanes2d_chunk<Big>(u_f, twin_f, locked, B, H, W, it_i, num_sweeps, active_b,
                                  delta_u, K, stream, device)
             : lanes2d_chunk<Small>(u_f, twin_f, locked, B, H, W, it_i, num_sweeps, active_b,
                                    delta_u, K, stream, device);
}

// The lockstep solve of every lane from t = 0 while t < max_iterations, in
// one launch, u updated in place (twin and u1 are scratch). retired u8[B],
// iters i32[B] and deltas f32[B] hold the caller's starting values (0, 0,
// eps + 1) and get each lane's result; acc (u32[2B]) and count (i32[2]),
// zeroed, are the protocol's scratch. eps is f32[B], m_max the iteration a
// lane may first retire after (max(H, W)).
int epic_lanes2d_solve(void* u, void* twin, void* u1, const void* locked, int B, int H, int W,
                       const void* eps, int m_max, int max_iterations, int stagger, void* acc,
                       void* count, void* retired, void* iters, void* deltas, int K,
                       void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!lanes_ok(B, H, W, K) || stagger < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  float* u_f = static_cast<float*>(u);
  float* twin_f = static_cast<float*>(twin);
  float* u1_f = static_cast<float*>(u1);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* count_i = static_cast<int*>(count);
  uint8_t* retired_b = static_cast<uint8_t*>(retired);
  int* iters_i = static_cast<int*>(iters);
  float* deltas_f = static_cast<float*>(deltas);
  return use_big(B * tile_count<Big>(H, W), device)
             ? lanes2d_solve<Big>(u_f, twin_f, u1_f, locked, B, H, W, eps_f, m_max,
                                  max_iterations, stagger, acc_u, count_i, retired_b, iters_i,
                                  deltas_f, K, stream, device)
             : lanes2d_solve<Small>(u_f, twin_f, u1_f, locked, B, H, W, eps_f, m_max,
                                    max_iterations, stagger, acc_u, count_i, retired_b, iters_i,
                                    deltas_f, K, stream, device);
}

}  // extern "C"
