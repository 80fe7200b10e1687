// Red-black log-space relaxation of a 2D grid on NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of epic_tpu/solver/pallas_sweep.py:
//   epic_sweep2d_chunk  <- _multisweep_kernel   (K sweeps, delta of sweep 0;
//                                                the anytime tick)
//   epic_sweep2d_solve  <- _solve_whole_kernel  (the whole stagger protocol,
//                                                exit decision included, in
//                                                one launch)
//   epic_sweep2d_solve_resident <- the same, on resident tiles (below);
//                                  solver/hopper_sweep.py routes a grid here
//                                  where its tile plan fits shared memory
// The plain torch version of all three is epic_tpu_torch/solver/core.py.
//
// Design. The TPU kernels hold a padded grid in VMEM and ping-pong whole
// arrays; neither carries over. Here one persistent cooperative kernel works
// in place on the unpadded H x W grid: a sweep of one parity class reads only
// the other class, so updating in place is race-free, and no padding or
// frozen mask is needed (the interior 1 <= y <= H-2, 1 <= x <= W-2 is taken
// by index). Blocks stride over the rows and threads over a row's cells of
// the active class, and cooperative_groups::this_grid().sync() separates the
// sweeps, so K sweeps (or a whole solve) are one launch and a tick never
// waits for the host.
//
// Numerics. lse4 (sweep_common.cuh) keeps the pinned op order of
// epic_tpu_torch/solver/_sweep_body.py: max tree over ((N,S),(W,E)), a
// left-associated sum of expf, logf, minus float32(log 4). Built without
// --use_fast_math, expf/logf are the accurate functions PyTorch's CUDA
// exp/log call, so the kernels and the plain version give the same bits.
//
// Delta. |u1 - u0| >= 0, so the float's bits order like unsigned ints: each
// block reduces its maximum and issues one atomicMax on the bits. Max is
// exact in any order, so the result is deterministic.
//
// Memory. u is read with __ldcg (L2, not L1): other blocks write it during
// the launch, and neither the read-only path (__ldg, const __restrict__) nor
// a stale L1 line may serve an old value across a grid barrier.
//
// Bound on this card. A sweep moves about 1.5 reads and 0.5 writes of 4 B
// per cell (the other class in full, the updated half once) plus half a byte
// of the lock mask, and pays one grid barrier. A grid that fits the 50 MB L2
// (maze 482^2, 0.93 MB) is bound by the barrier and launch latency; a grid
// beyond it (4096^2, 67 MB) by HBM bandwidth, and goes to the tile kernels
// (tile2d.cu). Holding the grid in the shared memory of thread-block
// clusters instead, with a cluster barrier a sweep and neighbour flags every
// K sweeps, was measured and lost to this kernel on the maze and umass; the
// measurements, and where that design's source is kept, are in PERF.md.
//
// The resident route. In place, a grid in the L2 pays one grid barrier a
// sweep, about 1.6 of the maze's 2.45 us a sweep (tile_probe --sweep2d).
// epic_sweep2d_solve_resident pays one every K = 8 sweeps at most: the
// grid is cut into at most one tile an SM (hopper_sweep.resident_plan:
// maze 12 x 11 tiles of 41 x 44, umass 6 x 22 of 52 x 44), and each block
// keeps its tile with a K-deep halo in shared memory for the whole solve,
// class-split with frozen bits as tile2d.cu keeps its tiles (4 B and a bit a
// cell). A chunk runs up to K sweeps there, each over the centre widened by
// the sweeps still to come, so the centre is exact at its end; then the
// exchange: the centre's K-deep border to one of two H x W scratch grids
// (alternating, so one barrier an exchange is race-free), the grid barrier,
// the K-deep halo back by asynchronous copies. The checked sweep is a chunk
// of its own over the centre alone, so its delta and exit are K2's; u is
// written once, at the exit. What bounds it (tile_probe --resident, H100,
// maze 1.25 us a sweep): the walk, 0.86 us, at about 60% of the issue
// rate, since a sweep of a 41 x 44 tile is a few rows a warp and its
// latency shows; the exchange, about 2.7 us (0.22 us a sweep of copies and
// 0.16 of barrier over the 14 exchanges of a 100-sweep cycle). K = 2 and 4
// took 1.98 and 1.48 us a sweep: more exchanges cost more than the thinner
// halo saves.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// One sweep over the class (y + x) % 2 != t % 2 of the interior. Blocks
// stride over the rows; the threads of a block stride over the row's cells of
// the class, x = x0(y) + 2k, so neighbouring threads touch neighbouring
// pairs of floats. With kCheck, returns this thread's max |u1 - u0|.
template <bool kCheck>
__device__ float sweep(float* u, const uint8_t* locked, int H, int W, int t) {
  const int q = (t & 1) ^ 1;  // the class updated: (y + x) & 1 == q
  float local = 0.0f;
  for (int y = 1 + blockIdx.x; y <= H - 2; y += gridDim.x) {
    const size_t row = static_cast<size_t>(y) * W;
    for (int x = 1 + ((y + 1 + q) & 1) + 2 * threadIdx.x; x <= W - 2; x += 2 * blockDim.x) {
      const size_t idx = row + x;
      if (locked[idx]) continue;
      const float v = lse4(__ldcg(u + idx - W), __ldcg(u + idx + W),
                           __ldcg(u + idx - 1), __ldcg(u + idx + 1));
      if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(u + idx)));
      u[idx] = v;
    }
  }
  return local;
}

// K1: num_sweeps sweeps starting at iteration *it; the delta of sweep 0 is
// max-accumulated into delta_bits, which the caller zeroed.
__global__ void __launch_bounds__(kThreads)
chunk_kernel(float* u, const uint8_t* locked, int H, int W, const int* it,
             int num_sweeps, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = *it;
  block_max_atomic<kThreads>(sweep<true>(u, locked, H, W, t0), delta_bits);
  for (int k = 1; k < num_sweeps; ++k) {
    grid.sync();
    sweep<false>(u, locked, H, W, t0 + k);
  }
}

// K2: the stagger protocol of epic_tpu/solver/pallas_sweep.py:156-176 and
// solver/core.py. Each cycle: a checked sweep, a barrier, then every thread
// reads the same delta and decides; on exit the grid already is u1, so
// nothing is computed and discarded. acc holds two zeroed slots that the
// checks alternate between: the slot for the next check is cleared right
// after this check's barrier, and at least one barrier separates that clear
// from the next check's atomics (the plain sweeps' barriers, or the extra
// one when stagger == 1).
__global__ void __launch_bounds__(kThreads)
solve_kernel(float* u, const uint8_t* locked, int H, int W, const float* eps_ptr,
             int m_max, int max_iterations, int stagger, unsigned int* acc,
             int* it_out, float* delta_out, int* done_out) {
  cg::grid_group grid = cg::this_grid();
  const float eps = *eps_ptr;
  int it = 0;
  float delta = eps + 1.0f;
  bool done = false;
  int slot = 0;
  while (!done && it < max_iterations) {
    block_max_atomic<kThreads>(sweep<true>(u, locked, H, W, it), acc + slot);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < eps && it + 1 >= m_max;
    if (done) {
      it += 1;
      break;
    }
    for (int s = 1; s < stagger; ++s) {
      sweep<false>(u, locked, H, W, it + s);
      grid.sync();
    }
    if (stagger == 1) grid.sync();
    it += stagger;
  }
  if (grid.thread_rank() == 0) {
    *it_out = it;
    *delta_out = delta;
    *done_out = done ? 1 : 0;
  }
}

// K2's resident route: the grid cut into at most one tile an SM, each kept in
// its block's shared memory for the whole solve (see the head of the file).
namespace resident {

constexpr int kDepth = 8;   // K: the most sweeps between two grid barriers
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kObstacle = -1e6f;  // constants.LOG_SPACE_OBSTACLE

// A block's tile: a ch x cw centre at (gy0, gx0) of the H x W grid (th x tw
// but in the last row and column of tiles), kept with a kDepth-deep halo as
// rows x cols cells, class-split: cell (lr, lc) of class (par + lr + lc) & 1
// lives at a(q)[lr * P + (lc >> 1)], its frozen flag at bit (lc >> 1) % 32 of
// f(q)[lr * NW + (lc >> 6)].
struct Tile {
  int H, W, gy0, gx0, ch, cw, rows, cols, P, NW, par;
  __device__ __forceinline__ Tile(int H_, int W_, int th, int tw, int nx) : H(H_), W(W_) {
    const int ty = blockIdx.x / nx;
    gy0 = ty * th;
    gx0 = (blockIdx.x - ty * nx) * tw;
    ch = min(th, H - gy0);
    cw = min(tw, W - gx0);
    rows = th + 2 * kDepth;
    cols = tw + 2 * kDepth;
    P = cols / 2;
    NW = (P + 31) / 32;
    par = (gy0 + gx0) & 1;   // of local (0, 0): -2K is even
  }
  __device__ __forceinline__ float* a(int q) const {
    extern __shared__ float smem[];
    return smem + q * rows * P;
  }
  __device__ __forceinline__ uint32_t* f(int q) const {
    return reinterpret_cast<uint32_t*>(a(2)) + q * rows * NW;
  }
  __device__ __forceinline__ float& at(int lr, int lc) const {
    return a((par + lr + lc) & 1)[lr * P + (lc >> 1)];
  }
};

// The halo-extended tile from u into shared memory: a warp a row, a lane the
// pair of local columns (2j, 2j + 1), which land at index j of both class
// arrays, their frozen flags (locked, the grid's ring, outside the grid)
// gathered into words by ballot. Cells outside the grid are
// LOG_SPACE_OBSTACLE and frozen.
__device__ __forceinline__ void load(const Tile& t, const float* u, const uint8_t* locked) {
  const int lane = threadIdx.x & 31;
  for (int lr = threadIdx.x >> 5; lr < t.rows; lr += kWarps) {
    const int y = t.gy0 - kDepth + lr;
    const bool in_row = y >= 0 && y < t.H;
    const bool ring_row = y == 0 || y == t.H - 1;
    const int qe = (t.par + lr) & 1;
    for (int mb = 0; mb < t.P; mb += 32) {
      const int j = mb + lane;
      float v[2] = {kObstacle, kObstacle};
      bool fz[2] = {true, true};
      if (j < t.P) {
        for (int o = 0; o < 2; ++o) {
          const int x = t.gx0 - kDepth + 2 * j + o;
          if (in_row && x >= 0 && x < t.W) {
            const size_t idx = static_cast<size_t>(y) * t.W + x;
            v[o] = u[idx];
            fz[o] = locked[idx] != 0 || ring_row || x == 0 || x == t.W - 1;
          }
        }
        t.a(qe)[lr * t.P + j] = v[0];
        t.a(qe ^ 1)[lr * t.P + j] = v[1];
      }
      const uint32_t be = __ballot_sync(0xffffffffu, fz[0]);
      const uint32_t bo = __ballot_sync(0xffffffffu, fz[1]);
      if (lane == 0) {
        t.f(qe)[lr * t.NW + (mb >> 5)] = be;
        t.f(qe ^ 1)[lr * t.NW + (mb >> 5)] = bo;
      }
    }
  }
}

// A cell's new value v into *cur where `ok` (inside the sweep's rectangle and
// not frozen); with kCheck, |v - old| is max-accumulated into `local`. lse4
// runs on every lane and only the store is predicated.
template <bool kCheck>
__device__ __forceinline__ void store(bool ok, float v, float* cur, float& local) {
  if (ok) {
    if (kCheck) local = fmaxf(local, fabsf(v - *cur));
    *cur = v;
  }
}

// One sweep of class q over the centre widened by m cells on each side
// (local rows and columns K - m .. K + ch - 1 + m): sweep s of a chunk of
// depth d takes m = d - 1 - s, so the cells it reads are exact after sweep
// s - 1 and the centre is exact after the chunk. The strip walk of
// tile2d.cu's sweep: a warp walks a strip of rows, its lanes at consecutive
// class indices j, rows in pairs of known column offset o = (par + lr + q)
// & 1 (cell j of the row is local column o + 2j), the other class's cells
// at j in the rows above kept in registers; a pair's loads all come before
// its stores, so that its two lse4 chains interleave. With kCheck (m = 0,
// the centre) returns the thread's max |u1 - u0|.
template <bool kCheck>
__device__ __forceinline__ float sweep(const Tile& t, int q, int m) {
  const int lo = kDepth - m;
  const int r1 = kDepth + t.ch - 1 + m;
  const int c1 = kDepth + t.cw - 1 + m;
  const int strip = (r1 - lo + kWarps) / kWarps;
  const int first = lo + (threadIdx.x >> 5) * strip;
  const int last = min(first + strip - 1, r1);
  const int jmax = c1 >> 1;   // the last j of either offset; at most P - 1
  const int lane = threadIdx.x & 31;
  const int P = t.P;
  const int NW = t.NW;
  float local = 0.0f;
  if (first > last) return local;
  for (int jb = lo >> 1; jb <= jmax; jb += 32) {
    const int j = jb + lane;
    const bool ok0 = j <= jmax && 2 * j >= lo;             // o = 0: column 2j
    const bool ok1 = 2 * j + 1 >= lo && 2 * j + 1 <= c1;   // o = 1: column 2j + 1
    const int jc = min(j, P - 1);   // lanes past the row read inside it
    const uint32_t bit = 1u << (j & 31);
    int lr = first;
    const float* col = t.a(q ^ 1) + lr * P + jc;   // the other class, row lr, index j
    float* cur = t.a(q) + lr * P + jc;
    const uint32_t* fz = t.f(q) + lr * NW + (jc >> 5);
    float above = col[-P];
    float mid = col[0];
    if ((t.par + lr + q) & 1) {   // a first row of o = 1
      const float b = col[P];
      store<kCheck>(ok1 && !(*fz & bit), lse4(above, b, mid, col[1]), cur, local);
      above = mid;
      mid = b;
      col += P;
      cur += P;
      fz += NW;
      ++lr;
    }
    for (; lr < last; lr += 2) {   // rows lr (o = 0) and lr + 1 (o = 1)
      const float b1 = col[P];
      const float b2 = col[2 * P];
      const float w0 = col[-1];
      const float e1 = col[P + 1];
      const bool up0 = ok0 && !(fz[0] & bit);
      const bool up1 = ok1 && !(fz[NW] & bit);
      const float v0 = lse4(above, b1, w0, mid);
      const float v1 = lse4(mid, b2, b1, e1);
      store<kCheck>(up0, v0, cur, local);
      store<kCheck>(up1, v1, cur + P, local);
      above = b1;
      mid = b2;
      col += 2 * P;
      cur += 2 * P;
      fz += 2 * NW;
    }
    if (lr == last)   // a last row of o = 0
      store<kCheck>(ok0 && !(*fz & bit), lse4(above, col[P], col[-1], mid), cur, local);
  }
  return local;
}

// The cells of an h x w rectangle within kDepth of its edge, a warp a row
// (rows `first`, first + kWarps, ...): fn(r, c) for each. A row among the
// first or last kDepth is whole, its lanes striding over it; every other row
// has its kDepth cells at each end, a lane each.
template <class Fn>
__device__ __forceinline__ void ring(int h, int w, int first, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int side = min(w, 2 * kDepth);
  for (int r = first; r < h; r += kWarps) {
    if (r < kDepth || r >= h - kDepth) {
      for (int c = lane; c < w; c += 32) fn(r, c);
    } else {
      for (int e = lane; e < side; e += 32) fn(r, e < kDepth ? e : w - side + e);
    }
  }
}

// After a chunk: the centre's cells within K of its edge to the exchange
// buffer `x` (an H x W grid), a grid barrier, then the halo's cells inside
// the grid back from it. Every cell a halo holds lies within K of the edge
// of the centre that owns it.
__device__ __forceinline__ void exchange(const Tile& t, float* x, cg::grid_group& grid) {
  const int warp = threadIdx.x >> 5;
  ring(t.ch, t.cw, warp, [&](int r, int c) {
    x[static_cast<size_t>(t.gy0 + r) * t.W + t.gx0 + c] = t.at(kDepth + r, kDepth + c);
  });
  grid.sync();
  // Asynchronous copies, so that every halo cell of a thread is in flight at
  // once. They read through L1, which the grid barrier has invalidated.
  ring(t.rows, t.cols, warp, [&](int lr, int lc) {
    const int y = t.gy0 - kDepth + lr;
    const int x0 = t.gx0 - kDepth + lc;
    if (y >= 0 && y < t.H && x0 >= 0 && x0 < t.W)
      __pipeline_memcpy_async(&t.at(lr, lc), x + static_cast<size_t>(y) * t.W + x0, 4);
  });
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The stagger protocol of solve_kernel on resident tiles, a block a tile.
// A cycle: the checked sweep as a chunk of depth 1 over the centre, its delta
// through block_max_atomic into acc (K2's two slots, cleared as there), the
// exchange, whose barrier also publishes the delta; the decision; then the
// other stagger - 1 sweeps in chunks of at most K (spread_at), each followed
// by an exchange. The exchanges alternate between the two halves of
// `scratch` (two H x W grids), so one barrier an exchange is race-free: every
// block reads exchange e's half before it reaches the barrier of exchange
// e + 1, and only after that barrier does any block write that half again
// (exchange e + 2). On exit each block writes its centre into u.
__global__ void __launch_bounds__(kThreads, 1)
solve_kernel(float* u, const uint8_t* locked, int H, int W, const float* eps_ptr, int m_max,
             int max_iterations, int stagger, unsigned int* acc, int* it_out, float* delta_out,
             int* done_out, float* scratch, int th, int tw, int nx) {
  cg::grid_group grid = cg::this_grid();
  const Tile t(H, W, th, tw, nx);
  const size_t cells = static_cast<size_t>(H) * W;
  load(t, u, locked);
  __syncthreads();
  const float eps = *eps_ptr;
  int it = 0;
  float delta = eps + 1.0f;
  bool done = false;
  int slot = 0;
  int half = 0;
  while (!done && it < max_iterations) {
    block_max_atomic<kThreads>(sweep<true>(t, (it & 1) ^ 1, 0), acc + slot);
    __syncthreads();
    exchange(t, scratch + half * cells, grid);
    half ^= 1;
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < eps && it + 1 >= m_max;
    if (done) {
      it += 1;
      break;
    }
    const int rest = stagger - 1;
    const int n_rest = (rest + kDepth - 1) / kDepth;
    int s0 = it + 1;
    for (int c = 0; c < n_rest; ++c) {
      const int ns = spread_at(rest, n_rest, c);
      for (int s = 0; s < ns; ++s) {
        sweep<false>(t, ((s0 + s) & 1) ^ 1, ns - 1 - s);
        __syncthreads();
      }
      exchange(t, scratch + half * cells, grid);
      half ^= 1;
      s0 += ns;
    }
    if (stagger == 1) grid.sync();
    it += stagger;
  }
  for (int i = threadIdx.x; i < t.ch * t.cw; i += kThreads) {
    const int r = i / t.cw;
    const int c = i - r * t.cw;
    u[static_cast<size_t>(t.gy0 + r) * W + t.gx0 + c] = t.at(kDepth + r, kDepth + c);
  }
  if (grid.thread_rank() == 0) {
    *it_out = it;
    *delta_out = delta;
    *done_out = done ? 1 : 0;
  }
}

// Dynamic shared memory of a th x tw tile (hopper_sweep.resident_smem_bytes).
inline size_t smem_bytes(int th, int tw) {
  const size_t rows = th + 2 * kDepth;
  const size_t P = tw / 2 + kDepth;
  return rows * 2 * (4 * P + 4 * ((P + 31) / 32));
}

}  // namespace resident

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).

int epic_sweep2d_chunk(void* u, const void* locked, int H, int W, const void* it,
                       int num_sweeps, void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_blocks(reinterpret_cast<const void*>(chunk_kernel), kThreads, device, H - 2, &blocks,
                    0);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&u_f, &locked_b, &H, &W, &it_i, &num_sweeps, &delta_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chunk_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int epic_sweep2d_solve(void* u, const void* locked, int H, int W, const void* eps,
                       int m_max, int max_iterations, int stagger, void* acc,
                       void* it_out, void* delta_out, void* done_out, void* stream,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_blocks(reinterpret_cast<const void*>(solve_kernel), kThreads, device, H - 2, &blocks,
                    0);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* it_i = static_cast<int*>(it_out);
  float* delta_f = static_cast<float*>(delta_out);
  int* done_i = static_cast<int*>(done_out);
  void* args[] = {&u_f, &locked_b, &H, &W, &eps_f, &m_max, &max_iterations, &stagger,
                  &acc_u, &it_i, &delta_f, &done_i};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(solve_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2 on resident tiles: the arguments of epic_sweep2d_solve, the scratch of
// two H x W float grids for the exchanges, and the tile th x tw of the plan
// (hopper_sweep.resident_plan; tw even). Refuses a plan whose tiles the card
// cannot hold at once, one block an SM.
int epic_sweep2d_solve_resident(void* u, const void* locked, int H, int W, const void* eps,
                                int m_max, int max_iterations, int stagger, void* acc,
                                void* it_out, void* delta_out, void* done_out, void* scratch,
                                int th, int tw, void* stream, int device) {
  if (th < 1 || tw < 2 || tw % 2 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(resident::solve_kernel);
  const size_t smem = resident::smem_bytes(th, tw);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int nx = (W + tw - 1) / tw;
  const int n_tiles = (H + th - 1) / th * nx;
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, resident::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || n_tiles > sms) return cudaErrorCooperativeLaunchTooLarge;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* it_i = static_cast<int*>(it_out);
  float* delta_f = static_cast<float*>(delta_out);
  int* done_i = static_cast<int*>(done_out);
  float* scratch_f = static_cast<float*>(scratch);
  void* args[] = {&u_f,  &locked_b, &H,     &W,       &eps_f,     &m_max, &max_iterations,
                  &stagger, &acc_u, &it_i, &delta_f, &done_i, &scratch_f, &th, &tw, &nx};
  err = cudaLaunchCooperativeKernel(kernel, dim3(n_tiles), dim3(resident::kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* epic_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
