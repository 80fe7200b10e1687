// Temporally blocked red-black relaxation of a 3D volume on NVIDIA Hopper
// (sm_90a): volumes beyond the 50 MB L2, deep and wide-plane.
//
// Replaces five TPU kernels (one test-only), which all compute one function
// (ns <= K lse6 sweeps of the volume, the delta of sweep 0, optionally the
// state u1 after sweep 0) and differ only in how they stage data through
// VMEM:
//   epic_tile3d_chunk <- epic_tpu/solver/pallas_biggrid3d.py:221
//                        _band3d_kernel_dma (K8; plane bands, k-plane
//                        halos) and :115 _band3d_kernel (T3, pre-gathered
//                        bands), pallas_tiled3d.py:121 _tile3d_kernel_impl
//                        (K10; z-band x y-tile x x-tile slabs), and with u1
//                        its check variant _tile3d_kernel_check (:225)
//   epic_tile3d_cycle <- pallas_cycle.py:657 _cycle_kernel3d (K9) and :869
//                        _cycle_kernel_tiled3d (K11): N chunks in one launch,
//                        ping-pong between two buffers
//   epic_tile3d_solve <- the while loops of pallas_biggrid3d.py:460
//                        _solve_banded and pallas_tiled3d.py:451
//                        _solve_tiled3d over K8-K11: the whole stagger
//                        protocol in one launch, the check folded into the
//                        first chunk of each cycle
// The plain torch version is epic_tpu_torch/solver/tiled3d.py.
//
// Design: tile2d.cu's, one dimension up. A block owns a kTD x kTH x kTW
// centre of the unpadded D x H x W volume (the last tiles along each axis
// ragged), loads (kTD+2K)(kTH+2K)(kTW+2K) voxels of u (float) and of a frozen
// byte (locked, the volume's shell, or outside the volume, where u is
// LOG_SPACE_OBSTACLE) into dynamic shared memory, and runs up to K sweeps
// there in place (a class reads only the other class; __syncthreads between
// sweeps). The trapezoid shrinks on all three axes: sweep s updates a voxel
// only where its local z, y and x all lie in (s, ext-1-s)
// (pallas_tiled3d.py:196-200), and only of the class (z + y + x) % 2 ==
// (t0 + s) % 2 in global coordinates -- the class 3D updates, the other one
// than 2D's (tests/goldens/fuzz3d_seed0 pins it). After ns sweeps the centre
// is exact and is written to dst, never to src, whose halo the neighbouring
// blocks read: chunks ping-pong between two buffers, and grid-wide barriers
// (cooperative_groups::this_grid().sync()) separate the chunks of a cycle or
// a solve. A cycle spreads its sweeps over its chunks, none deeper than K, so
// pallas_cycle's shallow `ns < k` chunk (valid only with one chunk, ROADMAP
// R2) has no counterpart.
//
// Indexing. The centre and the block size are compile-time constants, so
// the write-out divides by constants; the load and the sweeps walk their
// boxes with BoxCursor, which steps (z, y, x) by the block size with adds
// and compares instead of a division per voxel. Global indices are size_t:
// 32 x 2048 x 2048 voxels of 4 B overflow an int.
//
// Delta. max |u1 - u0| over the block's centre voxels that lie in the
// volume, never over fill voxels (ROADMAP R7), reduced with
// block_max_atomic (sweep_common.cuh): deterministic, since max is exact in
// any order.
//
// Numerics. lse6 from sweep_common.cuh, no --use_fast_math: the kernels give
// the plain version's (and solver/core.py's) bits.
//
// Memory. The source is read with __ldcg (L2, not L1): in a cycle or a
// solve the previous chunk's blocks wrote it during the same launch.
//
// Bound on this card. K7 (sweep3d.cu) moves about 9 B a voxel a sweep
// through HBM beyond the L2. A chunk here reads the extended tile once (5 B a
// voxel of it) and writes the centre (4 B): at 8 x 16 x 64 and K = 3,
// (5 * 14*22*70 / (8*16*64) + 4) / 3 = 5.7 B a voxel a sweep, for 1.48x the
// centre's updates (the trapezoid's mean volume over the centre's). On an
// H100 the time goes to instructions, not bytes: refilling the tile every
// chunk and the index work of each voxel come on top of the lse6 arithmetic
// (six expf and a logf, accurate libm code, an update), and a sweep takes
// 1.3x (32 x 2048 x 2048) to 1.9x (256^3) K7's time (tile_probe.py, PERF.md).
// So solver.update_volume and solve_volume send no volume here yet
// (hopper_tile3d.CROSSOVER_L2). ROADMAP queues the design that drops the z
// halo: a block that marches along z through a y x x column and keeps K time
// levels in shared memory. Simple first: one thread per voxel of a class,
// 2-way bank conflicts on the stride-2 class.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kObstacle = -1e6f;  // constants.LOG_SPACE_OBSTACLE

// The centre a block owns and the threads of a block: the fastest, at
// K = 3, of the shapes tile_probe.py --shapes measured at 256^3 and
// 32 x 2048 x 2048 on an H100 (PERF.md); at 108 KB two blocks share an SM.
// solver/hopper_tile3d.py's TILE holds the same centre.
constexpr int kTD = 8;
constexpr int kTH = 16;
constexpr int kTW = 64;
constexpr int kThreads = 512;
// At most 64 registers a thread (1024 threads an SM): two 512-thread blocks
// share an SM wherever their shared memory allows it (the solve kernel
// otherwise takes 96 and runs one block an SM).
constexpr int kMinBlocks = 1024 / kThreads;

// The volume, the tiling and the chunk depth bound of one launch.
struct Tiling {
  const uint8_t* locked;
  int D, H, W;    // the unpadded volume
  int K;          // halo depth: the most sweeps a chunk may run
  int ny, nx;     // tiles down y and across x
  int n_tiles;
};

__host__ __device__ __forceinline__ int ext_voxels(int K) {
  return (kTD + 2 * K) * (kTH + 2 * K) * (kTW + 2 * K);
}

// The block's dynamic shared memory holds u of the extended tile, then its
// frozen bytes.
__device__ __forceinline__ uint8_t* frozen_of(float* smem, const Tiling& g) {
  return reinterpret_cast<uint8_t*>(smem + ext_voxels(g.K));
}

// This thread's walk over an nz x ny x nx box (x fastest), kThreads voxels a
// step: flat index i = threadIdx.x + n * kThreads is (z, y, x) after n calls
// of advance(). Two divisions when made, none per step.
struct BoxCursor {
  int z, y, x;
  int dz, dy, dx;
  int ny, nx;

  __device__ BoxCursor(int ny_, int nx_) : ny(ny_), nx(nx_) {
    const int r = threadIdx.x / nx;
    x = threadIdx.x - r * nx;
    z = r / ny;
    y = r - z * ny;
    const int q = kThreads / nx;
    dx = kThreads - q * nx;
    dz = q / ny;
    dy = q - dz * ny;
  }

  __device__ __forceinline__ void advance() {
    x += dx;
    int carry = x >= nx;
    if (carry) x -= nx;
    y += dy + carry;
    carry = y >= ny;
    if (carry) y -= ny;
    z += dz + carry;
  }
};

// The centre's voxels that lie in the volume (cd x ch x cw of it), from
// shared memory to out.
__device__ __forceinline__ void write_centre(const float* us, float* out, const Tiling& g,
                                             int gz0, int gy0, int gx0, int cd, int ch,
                                             int cw) {
  const int EH = kTH + 2 * g.K;
  const int EW = kTW + 2 * g.K;
  for (int i = threadIdx.x; i < kTD * kTH * kTW; i += kThreads) {
    const int x = i % kTW;
    const int r = i / kTW;
    const int y = r % kTH;
    const int z = r / kTH;
    if (z < cd && y < ch && x < cw)
      out[(static_cast<size_t>(gz0 + z) * g.H + gy0 + y) * g.W + gx0 + x] =
          us[((g.K + z) * EH + g.K + y) * EW + g.K + x];
  }
}

// One chunk of `ns` (1..K) sweeps from iteration t0 on tile `tile`: load the
// halo-extended tile, sweep, write the centre to dst (and after sweep 0 to
// u1, when given), max-accumulate sweep 0's delta into delta_acc (when
// given). Every thread of the block calls it; us/fs are the block's dynamic
// shared memory.
__device__ void tile_chunk(const float* src, float* dst, float* u1, const Tiling& g, int tile,
                           int t0, int ns, unsigned int* delta_acc, float* us, uint8_t* fs) {
  const int ED = kTD + 2 * g.K;
  const int EH = kTH + 2 * g.K;
  const int EW = kTW + 2 * g.K;
  const int plane = EH * EW;
  const int tz = tile / (g.ny * g.nx);
  const int rest = tile - tz * g.ny * g.nx;
  const int ty = rest / g.nx;
  const int tx = rest - ty * g.nx;
  const int gz0 = tz * kTD;              // global voxel of the centre's first one
  const int gy0 = ty * kTH;
  const int gx0 = tx * kTW;
  const int cd = min(kTD, g.D - gz0);    // centre extents inside the volume
  const int ch = min(kTH, g.H - gy0);
  const int cw = min(kTW, g.W - gx0);

  {
    BoxCursor c(EH, EW);
    for (int i = threadIdx.x; i < ED * plane; i += kThreads, c.advance()) {
      const int z = gz0 - g.K + c.z;
      const int y = gy0 - g.K + c.y;
      const int x = gx0 - g.K + c.x;
      float v = kObstacle;
      uint8_t f = 1;
      if (z >= 0 && z < g.D && y >= 0 && y < g.H && x >= 0 && x < g.W) {
        const size_t idx = (static_cast<size_t>(z) * g.H + y) * g.W + x;
        v = __ldcg(src + idx);
        f = (g.locked[idx] != 0) | (z == 0) | (z == g.D - 1) | (y == 0) | (y == g.H - 1) |
            (x == 0) | (x == g.W - 1);
      }
      us[i] = v;
      fs[i] = f;
    }
  }
  __syncthreads();

  // (z + y + x) & 1 of local (0, 0, 0), whose global voxel is the centre's
  // first minus K on each axis: -3K has K's parity.
  const int par = (gz0 + gy0 + gx0 + g.K) & 1;
  float local = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const int want = (t0 + s) & 1;       // the class updated: (z + y + x) & 1 == want
    const int lo = s + 1;                // the trapezoid: lo..E-2-s on each axis
    const int c1 = EW - 2 - s;
    const int half = (c1 - lo + 2) / 2;  // voxels of one class in a row, at most
    const int nzs = ED - 2 - 2 * s;
    const int nys = EH - 2 - 2 * s;
    BoxCursor c(nys, half);
    for (int i = threadIdx.x; i < nzs * nys * half; i += kThreads, c.advance()) {
      const int lz = lo + c.z;
      const int ly = lo + c.y;
      const int lx = lo + ((par + lz + ly + lo + want) & 1) + 2 * c.x;
      if (lx > c1) continue;
      const int li = (lz * EH + ly) * EW + lx;
      if (fs[li]) continue;
      const float v = lse6(us[li - plane], us[li + plane], us[li - EW], us[li + EW],
                           us[li - 1], us[li + 1]);
      if (s == 0 && lz >= g.K && lz < g.K + cd && ly >= g.K && ly < g.K + ch &&
          lx >= g.K && lx < g.K + cw)
        local = fmaxf(local, fabsf(v - us[li]));
      us[li] = v;
    }
    __syncthreads();
    if (s == 0 && u1 != nullptr) {
      write_centre(us, u1, g, gz0, gy0, gx0, cd, ch, cw);
      __syncthreads();
    }
  }
  if (delta_acc != nullptr) block_max_atomic<kThreads>(local, delta_acc);
  write_centre(us, dst, g, gz0, gy0, gx0, cd, ch, cw);
  __syncthreads();  // the next tile reuses us/fs
}

// All tiles of one chunk, strided over the blocks.
__device__ void all_tiles(const float* src, float* dst, float* u1, const Tiling& g, int t0,
                          int ns, unsigned int* delta_acc, float* us, uint8_t* fs) {
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x)
    tile_chunk(src, dst, u1, g, tile, t0, ns, delta_acc, us, fs);
}

// K8/K10 (and T3, and with u1 the K10 check): one chunk from iteration
// *it + t_off; a block a tile.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_chunk_kernel(const float* src, float* dst, float* u1, Tiling g, const int* it, int t_off,
                  int ns, unsigned int* delta_bits) {
  extern __shared__ float smem[];
  tile_chunk(src, dst, u1, g, blockIdx.x, *it + t_off, ns, delta_bits, smem, frozen_of(smem, g));
}

// K9/K11: `total` sweeps from *it + t_off spread over n_chunks chunks;
// chunk c reads a when c is even and b otherwise and writes the other, its
// sweep-0 delta into deltas[c] (zeroed by the caller). An even count ends in
// a.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_cycle_kernel(float* a, float* b, Tiling g, const int* it, int t_off, int total,
                  int n_chunks, unsigned int* deltas) {
  extern __shared__ float smem[];
  uint8_t* fs = frozen_of(smem, g);
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_tiles((c & 1) ? b : a, (c & 1) ? a : b, nullptr, g, t, ns, deltas + c, smem, fs);
    t += ns;
  }
}

// The stagger protocol of solver/core.py, resumable, as tile2d.cu's
// tile_solve_kernel runs it: from the iteration, delta and verdict in
// it_io/delta_io/done_io, run cycles while not done and it < bound. A cycle
// is the checked chunk of depth min(K, stagger) from cur to oth, writing u1
// too; a barrier; one decision that every thread reads (exit with u1 once
// delta < eps and it + 1 >= m_max); else the remaining stagger - depth
// sweeps as further chunks, a barrier after each. acc holds two zeroed slots
// that the checks alternate between; the next check's slot is cleared after
// this check's barrier, and at least one barrier (a rest chunk's, or the
// extra one when there is none) separates the clear from the next check's
// atomics. The state ends in u: the last step copies it there when it is in
// twin or u1.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_solve_kernel(float* u, float* twin, float* u1, Tiling g, const float* eps_ptr, int m_max,
                  int bound, int stagger, unsigned int* acc, int* it_io, float* delta_io,
                  int* done_io) {
  extern __shared__ float smem[];
  uint8_t* fs = frozen_of(smem, g);
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
    const size_t n = static_cast<size_t>(g.D) * g.H * g.W;
    for (size_t i = grid.thread_rank(); i < n; i += grid.size()) u[i] = __ldcg(cur + i);
  }
  if (grid.thread_rank() == 0) {
    *it_io = it;
    *delta_io = delta;
    *done_io = done ? 1 : 0;
  }
}

size_t smem_bytes(const Tiling& g) {
  return static_cast<size_t>(ext_voxels(g.K)) * (sizeof(float) + 1);
}

Tiling make_tiling(const void* locked, int D, int H, int W, int K) {
  Tiling g;
  g.locked = static_cast<const uint8_t*>(locked);
  g.D = D;
  g.H = H;
  g.W = W;
  g.K = K;
  g.ny = (H + kTH - 1) / kTH;
  g.nx = (W + kTW - 1) / kTW;
  g.n_tiles = ((D + kTD - 1) / kTD) * g.ny * g.nx;
  return g;
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch of depth K asks for (5 B a voxel of the
// extended tile; solver/hopper_tile3d.py's smem_bytes gives the same).
long long epic_tile3d_smem_bytes(int K) {
  return static_cast<long long>(ext_voxels(K)) * (sizeof(float) + 1);
}

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u, twin, u1, src and dst are f32[D, H, W] and locked
// u8[D, H, W], contiguous; src and dst are distinct. K is the halo depth.

// One chunk of ns (1..K) sweeps from iteration *it + t_off, src -> dst; with
// u1 non-null, the state after sweep 0 goes there too; sweep 0's delta is
// max-accumulated into delta (zeroed by the caller).
int epic_tile3d_chunk(const void* src, void* dst, void* u1, const void* locked, int D, int H,
                      int W, const void* it, int t_off, int ns, void* delta, int K,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Tiling g = make_tiling(locked, D, H, W, K);
  const size_t smem = smem_bytes(g);
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
int epic_tile3d_cycle(void* a, void* b, const void* locked, int D, int H, int W,
                      const void* it, int t_off, int total, int n_chunks, void* deltas, int K,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g = make_tiling(locked, D, H, W, K);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&a, &b, &g, &it_i, &t_off, &total, &n_chunks, &d_u};
  return launch_cooperative(reinterpret_cast<const void*>(tile_cycle_kernel), kThreads, g.n_tiles,
                            smem_bytes(g), args, device, static_cast<cudaStream_t>(stream));
}

// The solve protocol in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in u and the three scalars are written back. twin and u1
// are scratch volumes; acc two zeroed uint32 slots.
int epic_tile3d_solve(void* u, void* twin, void* u1, const void* locked, int D, int H, int W,
                      const void* eps, int m_max, int bound, int stagger, void* acc,
                      void* it_io, void* delta_io, void* done_io, int K, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g = make_tiling(locked, D, H, W, K);
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&u, &twin, &u1, &g, &eps_f, &m_max, &bound, &stagger,
                  &acc, &it_io, &delta_io, &done_io};
  return launch_cooperative(reinterpret_cast<const void*>(tile_solve_kernel), kThreads, g.n_tiles,
                            smem_bytes(g), args, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
