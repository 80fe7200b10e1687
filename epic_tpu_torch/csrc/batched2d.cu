// Red-black log-space relaxation of B independent 2D lanes on NVIDIA Hopper
// (sm_90a): the batched scenario solves (BASELINE config 3).
//
// Replaces the two TPU kernels of epic_tpu/solver/pallas_batched.py:
//   epic_batched2d_chunk <- _block_kernel        (sweep_chunk_blocks: K sweeps,
//                                                 delta of sweep 0), with the
//                                                 gating of _block_kernel_gated
//                                                 as optional per-lane flags
//   epic_batched2d_solve <- _block_kernel_gated  and the while_loop of
//                                                 _solve_collage_device that
//                                                 drives it: the whole lockstep
//                                                 protocol with per-lane
//                                                 retirement, in one launch
// The plain torch version of both is epic_tpu_torch/solver/batched.py.
//
// The batch is the contiguous [B, H, W] tensor, updated in place. Each lane's
// interior is 1 <= y <= H-2, 1 <= x <= W-2, its ring frozen, and its class at
// iteration t is (y + x) % 2 != t % 2 in the lane's own coordinates. Lanes
// never exchange data, and the lockstep protocol decides each lane on its
// own delta (batched.py lockstep), so a lane can run its whole chunk, or its
// whole solve, alone. Each entry has two routes, which the caller names by
// the blocks a lane takes (solver/hopper_batched.py lane_resident and
// lane_cluster; the entry never picks one). Lanes past every cluster take a
// third, the tiled route, whose entries (epic_lanes2d_chunk and
// epic_lanes2d_solve) live in tile2d.cu beside the tile pass they run.
//
// The resident route (a lane that fits a block's shared memory). The TPU
// kernels keep a VMEM block of lanes for all num_sweeps sweeps; here one
// block owns one lane, in an ordinary launch of B blocks, so the block
// scheduler hands an SM its next lane the moment one finishes. The block
// loads its lane's u and locked once (16-byte loads where the row allows)
// into dynamic shared memory, class-split as tile2d.cu stores a tile: cell
// (y, x) of class q = (y + x) & 1 lives at a[q][y * P + (x >> 1)], P = (W +
// 1) / 2, and its frozen flag (locked, or the ring) is bit j % 32 of word
// f[q][y * NW + j / 32], j = x >> 1. A 128^2 lane takes 64 KB of u and 2 KB
// of bits (lane_smem_bytes), three blocks an SM; a block has 256 threads
// where three or more lanes fit an SM, else 512. The sweeps run there, a
// __syncthreads() between them, with no grid barrier: a warp walks a strip of
// rows, its lanes at consecutive j, and carries the other class's cells at
// its j down the strip in registers, rows in pairs of known column offset,
// so no cell divides (tile2d.cu's walk, without its halo: no trapezoid and
// no recompute). Sweep 0's max |u1 - u0| over the interior is reduced with
// warp shuffles and one shared word, and written straight to the lane's
// slot. At the end the block writes the lane's interior back: HBM sees each
// cell once a chunk, or once a solve. The chunk entry's block returns at
// once for a lane whose active flag is 0 (the pass-through of
// _block_kernel_gated, pallas_batched.py:230-232), and the solve entry's
// block runs the protocol for its own lane from t = 0 until it retires or
// the cap is reached: a checked sweep; record the delta; retire when delta <
// eps[lane] and t + 1 >= m_max (iterations t + 1), else run stagger - 1
// plain sweeps (iterations t + stagger).
//
// The cluster route (a lane too large for a block's shared memory that a
// thread-block cluster of c = 2..16 blocks holds). One cluster owns one lane,
// in an ordinary launch of B * c blocks with the cluster dimension as a
// launch attribute (not cooperative: a cluster whose lane is done frees its
// SMs for the next lane's cluster at once). Block `rank` keeps a band of
// the lane's rows plus one halo row above and one below in the resident
// layout (Band: the band is a small lane of its own, whose class flips where
// its first kept row is odd) and walks it as a resident block walks its
// lane. After each sweep it copies the cells its edge rows just updated into
// the neighbouring bands' halo rows (DSMEM stores), then the cluster barrier
// (barrier.cluster.arrive.release / wait.acquire): one barrier a sweep, and
// HBM sees each cell once a chunk or a solve. Each block reduces its band's
// delta with shuffles and an atomicMax on the float bits into a word of rank
// 0's shared memory; the solve's verdict is read there by every block after
// the checked sweep's barrier, so the cluster leaves its loop together.
//
// Numerics. lse4 from sweep_common.cuh, no --use_fast_math: every route gives
// the plain version's bits on the card.
//
// Bound on this card. At 4096 lanes of 128^2 the batch holds 67M cells: 268
// MB of u and 67 MB of locked, 5x the 50 MB L2. Resident, a chunk moves
// each cell through HBM once (0.18 ms for the batch at 3.35 TB/s), so the
// route is bound by the instructions the SMs issue: an accurate lse4 is 71
// SASS instructions (chip_smoke.py's issue_bound_ms) and the walk a dozen
// more. The cluster route is bound the same way, plus a cluster barrier and
// 2 (W + 1) / 2 DSMEM stores a block a sweep. PERF.md holds every route's
// times beside the bounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The resident route's two blocks (one lane each): threads, and the blocks
// an SM the register budget is held to. A launch takes the small block where
// the occupancy query gives it at least kSmallLanesPerSM lanes an SM, else
// the big one. Measured with `tile_probe --batch` on an H100 80GB HBM3 at
// 700 W (PERF.md): 256 threads were 2-20% faster on square lanes of 32 to
// 128 (three or more an SM; at 128^2 9.88 against 10.06 ms a 100-sweep
// chunk of 4096 lanes), 512 threads 10-50% faster from 160 up (two or one).
constexpr int kSmallLaneThreads = 256;
constexpr int kSmallLaneMinBlocks = 3;
constexpr int kBigLaneThreads = 512;
constexpr int kBigLaneMinBlocks = 2;
constexpr int kSmallLanesPerSM = 3;
constexpr int kDeltaSlots = 3;  // the solve's rotating delta words (lane_solve_kernel)

// The cluster route's block (one band of a lane each). Measured with
// `tile_probe --batch` on an H100 80GB HBM3 at 700 W (PERF.md): 1024
// threads a block gained at most 4% at each batch's best size, lost up to 12%.
constexpr int kClusterThreads = 512;
constexpr int kClusterMinBlocks = 1;
constexpr int kMaxCluster = 16;  // the largest cluster Hopper allows (non-portable past 8)

// ---------------------------------------------------------------- resident

// The lane's layout in dynamic shared memory: a(0), a(1) (u of each class,
// H rows of P floats), f(0), f(1) (the frozen bits of each class, H rows of
// NW words), then kDeltaSlots delta words. lane_smem_bytes gives its size.
struct LaneSmem {
  int H, W, P, NW;
  __host__ __device__ static int class_row(int W) { return (W + 1) / 2; }
  __host__ __device__ static int words(int W) { return (class_row(W) + 31) / 32; }
  __device__ __forceinline__ LaneSmem(int h, int w) : H(h), W(w), P(class_row(w)), NW(words(w)) {}
  __device__ __forceinline__ static float* base() {
    extern __shared__ float smem[];
    return smem;
  }
  __device__ __forceinline__ float* a(int q) const { return base() + q * H * P; }
  __device__ __forceinline__ uint32_t* f(int q) const {
    return reinterpret_cast<uint32_t*>(base() + 2 * H * P) + q * H * NW;
  }
  __device__ __forceinline__ unsigned int* delta(int slot) const {
    return reinterpret_cast<unsigned int*>(f(2)) + slot;
  }
};

size_t lane_smem_bytes(int H, int W) {
  const size_t h = H;
  return 4 * (2 * h * LaneSmem::class_row(W) + 2 * h * LaneSmem::words(W) + kDeltaSlots);
}

// Whether p is aligned to `bytes` (a power of two).
__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Set the frozen bits of `bits` (bit i for index j + i) in class row `row`.
__device__ __forceinline__ void freeze(uint32_t* row, int j, uint32_t bits) {
  if (bits) atomicOr(row + (j >> 5), bits << (j & 31));
}

// Load lane u / locked (H x W, row-major) into m: a warp a row, a lane four
// columns (4c .. 4c+3, one float4 and one uchar4) where the row's addresses
// allow, which land at indices 2c and 2c+1 of both class rows; else a lane a
// column. A cell is frozen if locked or on the ring. Zeroes the delta
// words; ends with a barrier.
template <int kThreads>
__device__ void load_lane(const float* u, const uint8_t* locked, const LaneSmem& m) {
  constexpr int kWarps = kThreads / 32;
  for (int i = threadIdx.x; i < 2 * m.H * m.NW + kDeltaSlots; i += kThreads) m.f(0)[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int H = m.H;
  const int W = m.W;
  for (int y = threadIdx.x >> 5; y < H; y += kWarps) {
    const float* ur = u + static_cast<size_t>(y) * W;
    const uint8_t* lr = locked + static_cast<size_t>(y) * W;
    const bool ring = y == 0 || y == H - 1;
    const int qe = y & 1;  // the class of the even columns
    float* ae = m.a(qe) + y * m.P;
    float* ao = m.a(qe ^ 1) + y * m.P;
    uint32_t* fe = m.f(qe) + y * m.NW;
    uint32_t* fo = m.f(qe ^ 1) + y * m.NW;
    int x0 = 0;
    if (aligned(ur, 16) && aligned(lr, 4)) {
      const int n4 = W >> 2;
      for (int c = lane; c < n4; c += 32) {
        const float4 v = reinterpret_cast<const float4*>(ur)[c];
        const uchar4 b = reinterpret_cast<const uchar4*>(lr)[c];
        const int x = 4 * c;
        const int j = 2 * c;
        ae[j] = v.x;
        ae[j + 1] = v.z;
        ao[j] = v.y;
        ao[j + 1] = v.w;
        freeze(fe, j, static_cast<uint32_t>(b.x != 0 || ring || x == 0) |
                          static_cast<uint32_t>(b.z != 0 || ring || x + 2 == W - 1) << 1);
        freeze(fo, j, static_cast<uint32_t>(b.y != 0 || ring || x + 1 == W - 1) |
                          static_cast<uint32_t>(b.w != 0 || ring || x + 3 == W - 1) << 1);
      }
      x0 = n4 * 4;
    }
    for (int x = x0 + lane; x < W; x += 32) {
      const int q = (y + x) & 1;
      const int j = x >> 1;
      m.a(q)[y * m.P + j] = ur[x];
      freeze(m.f(q) + y * m.NW, j, lr[x] != 0 || ring || x == 0 || x == W - 1);
    }
  }
  __syncthreads();
}

// Write the lane's interior back to u: a warp a row, a lane a column.
template <int kThreads>
__device__ void store_lane(float* u, const LaneSmem& m) {
  const int lane = threadIdx.x & 31;
  for (int y = 1 + (threadIdx.x >> 5); y < m.H - 1; y += kThreads / 32) {
    float* ur = u + static_cast<size_t>(y) * m.W;
    for (int x = 1 + lane; x < m.W - 1; x += 32) ur[x] = m.a((y + x) & 1)[y * m.P + (x >> 1)];
  }
}

// The update of one cell from its N, S, W and E neighbours into *cur, unless
// `ok` is false (outside the interior's columns) or its frozen bit is set;
// with kFirst, |new - old| is max-accumulated into `local`. lse4 runs on
// every lane and only the store is predicated (tile2d.cu's update).
template <bool kFirst>
__device__ __forceinline__ void update(bool ok, uint32_t frozen, uint32_t bit, float n, float s,
                                       float w, float e, float* cur, float& local) {
  const float v = lse4(n, s, w, e);
  if (ok && !(frozen & bit)) {
    if (kFirst) local = fmaxf(local, fabsf(v - *cur));
    *cur = v;
  }
}

// One sweep of class q over the lane's interior (rows 1..H-2, columns
// 1..W-2). A warp walks a strip of consecutive rows, its lanes at
// consecutive j, one column block of 32 after another. Cell j of row y is
// column o + 2j, o = (y + q) & 1 alternating down the strip, so rows go in
// pairs of o = 0 then o = 1 (a lone row at either end), and a lane knows at
// the start of a column block whether its cell lies in the interior's
// columns for either o. It keeps the other class's cells at its j in the
// row above and its own row (`above`, `mid`): a row costs one load for the
// row below and one for its W (o = 0) or E (o = 1) neighbour. A lane past
// the last j reads at the last j (its store is off), so no read leaves the
// lane's arrays. With kFirst it returns `local` max-accumulated.
template <bool kFirst, int kThreads>
__device__ __forceinline__ float sweep_lane(const LaneSmem& m, int q, float local) {
  constexpr int kWarps = kThreads / 32;
  const int r1 = m.H - 2;  // the last interior row and column
  const int c1 = m.W - 2;
  const int strip = (r1 + kWarps - 1) / kWarps;
  const int first = 1 + (threadIdx.x >> 5) * strip;
  const int last = min(first + strip - 1, r1);
  if (first > last) return local;
  const int jmax = c1 >> 1;  // the last j of either o
  const int P = m.P;
  const int NW = m.NW;
  const int lane = threadIdx.x & 31;
  for (int jb = 0; jb <= jmax; jb += 32) {
    const int j = min(jb + lane, jmax);
    const bool in_j = jb + lane <= jmax;
    const bool ok0 = in_j && j >= 1 && 2 * j <= c1;  // o = 0: column 2j
    const bool ok1 = in_j && 2 * j + 1 <= c1;        // o = 1: column 2j + 1
    const uint32_t bit = 1u << (j & 31);
    int y = first;
    const float* col = m.a(q ^ 1) + y * P + j;  // the other class, row y, index j
    float* cur = m.a(q) + y * P + j;
    const uint32_t* fz = m.f(q) + y * NW + (j >> 5);
    float above = col[-P];
    float mid = col[0];
    if ((y + q) & 1) {  // a first row of o = 1
      const float b = col[P];
      update<kFirst>(ok1, *fz, bit, above, b, mid, col[1], cur, local);
      above = mid;
      mid = b;
      col += P;
      cur += P;
      fz += NW;
      ++y;
    }
    for (; y < last; y += 2) {  // rows y (o = 0) and y + 1 (o = 1)
      const float b1 = col[P];
      update<kFirst>(ok0, fz[0], bit, above, b1, col[-1], mid, cur, local);
      const float b2 = col[2 * P];
      update<kFirst>(ok1, fz[NW], bit, mid, b2, b1, col[P + 1], cur + P, local);
      above = b1;
      mid = b2;
      col += 2 * P;
      cur += 2 * P;
      fz += 2 * NW;
    }
    if (y == last)  // a last row of o = 0
      update<kFirst>(ok0, *fz, bit, above, col[P], col[-1], mid, cur, local);
  }
  return local;
}

// Max-accumulate each thread's `local` into *word: warp shuffles, then one
// atomicMax on the float bits a warp (values >= 0: exact in any order).
__device__ __forceinline__ void reduce_delta(float local, unsigned int* word) {
  for (int off = 16; off > 0; off >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  if ((threadIdx.x & 31) == 0 && local > 0.0f) atomicMax(word, __float_as_uint(local));
}

// K12 on the resident route: block L takes lane L. A lane whose active flag
// is 0 (when active is given) returns with delta 0 and is not read; else
// num_sweeps sweeps from iteration *it in shared memory, delta[L] its
// sweep-0 delta.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lane_chunk_kernel(float* u, const uint8_t* locked, int H, int W, const int* it, int num_sweeps,
                  const uint8_t* active, float* delta) {
  const int L = blockIdx.x;
  if (active != nullptr && active[L] == 0) {
    if (threadIdx.x == 0) delta[L] = 0.0f;
    return;
  }
  const LaneSmem m(H, W);
  float* lu = u + static_cast<size_t>(L) * H * W;
  load_lane<kThreads>(lu, locked + static_cast<size_t>(L) * H * W, m);
  const int t0 = *it;
  reduce_delta(sweep_lane<true, kThreads>(m, (t0 & 1) ^ 1, 0.0f), m.delta(0));
  __syncthreads();
  for (int s = 1; s < num_sweeps; ++s) {
    sweep_lane<false, kThreads>(m, ((t0 + s) & 1) ^ 1, 0.0f);
    __syncthreads();
  }
  if (threadIdx.x == 0) delta[L] = __uint_as_float(*m.delta(0));
  store_lane<kThreads>(lu, m);
}

// K13 and _solve_collage_device's loop on the resident route: block L runs
// the lockstep protocol (batched.py lockstep) for lane L alone, from t = 0
// while t < max_iterations. A cycle: a checked sweep; its delta d; retire
// when d < eps[L] and t + 1 >= m_max; else stagger - 1 plain sweeps. Cycle c
// reduces into delta slot c % 3, and thread 0 clears slot (c + 1) % 3 before
// the cycle's barrier: every thread read that slot two cycles back, before
// the last cycle's barrier, and adds to it only after this one. At the end
// deltas[L], iters[L] (t + 1 if it retired, else the next cycle's t) and
// retired[L]; a lane that never ran a check keeps the caller's values
// (deltas eps + 1, iters 0, retired 0).
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lane_solve_kernel(float* u, const uint8_t* locked, int H, int W, const float* eps, int m_max,
                  int max_iterations, int stagger, uint8_t* retired, int* iters, float* deltas) {
  const int L = blockIdx.x;
  const LaneSmem m(H, W);
  float* lu = u + static_cast<size_t>(L) * H * W;
  load_lane<kThreads>(lu, locked + static_cast<size_t>(L) * H * W, m);
  const float e = eps[L];
  float d = 0.0f;
  bool done = false;
  int t = 0;
  for (int c = 0; t < max_iterations; t += stagger, ++c) {
    const int slot = c % kDeltaSlots;
    if (threadIdx.x == 0) *m.delta((c + 1) % kDeltaSlots) = 0u;
    reduce_delta(sweep_lane<true, kThreads>(m, (t & 1) ^ 1, 0.0f), m.delta(slot));
    __syncthreads();
    d = __uint_as_float(*m.delta(slot));
    done = d < e && t + 1 >= m_max;
    if (done) break;
    for (int s = 1; s < stagger; ++s) {
      sweep_lane<false, kThreads>(m, ((t + s) & 1) ^ 1, 0.0f);
      __syncthreads();
    }
  }
  if (threadIdx.x == 0 && max_iterations > 0) {
    deltas[L] = d;
    iters[L] = done ? t + 1 : t;
    retired[L] = done;
  }
  store_lane<kThreads>(lu, m);
}

// Launch a resident kernel, `small` or `big` (its two blocks' instances), a
// block a lane with lane_smem_bytes of dynamic shared memory. A lane that
// does not fit the device's opt-in shared memory a block is refused
// (cudaErrorInvalidValue): the caller names the route, and no other is
// taken.
cudaError_t launch_lanes(const void* small, const void* big, int B, int H, int W, void** args,
                         int device, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const size_t smem = lane_smem_bytes(H, W);
  if (H < 1 || W < 1 || smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  err = allow_smem(small, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small, kSmallLaneThreads, smem);
  if (err != cudaSuccess) return err;
  const bool use_small = per_sm >= kSmallLanesPerSM;
  if (!use_small) {
    err = allow_smem(big, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchKernel(use_small ? small : big, dim3(B),
                         dim3(use_small ? kSmallLaneThreads : kBigLaneThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define LANE_KERNELS(name)                                                             \
  reinterpret_cast<const void*>(name<kSmallLaneThreads, kSmallLaneMinBlocks>),        \
      reinterpret_cast<const void*>(name<kBigLaneThreads, kBigLaneMinBlocks>)

// ---------------------------------------------------------------- cluster

// Block `rank` of a cluster of c cuts the lane's n = H - 2 interior rows into
// c bands of n / c or n / c + 1 rows, the longer first (a rank past n gets
// none): its first interior row r0 and its row count. The block keeps rows
// r0 - 1 .. r0 + rows, its band and one halo row above and one below, as
// the resident route keeps a lane of rows + 2 rows (LaneSmem, load_lane,
// store_lane, sweep_lane), in the band's own coordinates: its halo rows are
// that lane's ring (frozen), and its class-split arrays hold local class
// (ly + x) & 1. Lane class q is local class q ^ ((r0 - 1) & 1): a band whose
// first kept row is odd flips it.
struct Band {
  int r0, rows;
  __host__ __device__ Band(int n, int c, int rank)
      : r0(1 + rank * (n / c) + (rank < n % c ? rank : n % c)),
        rows(n / c + (rank < n % c ? 1 : 0)) {}
  __device__ LaneSmem smem(int W) const { return LaneSmem(rows + 2, W); }
  __host__ __device__ int local(int q) const { return q ^ ((r0 - 1) & 1); }
};

// The largest band's layout: every block of a cluster launch gets it.
size_t cluster_smem_bytes(int H, int W, int c) {
  const int n = H > 2 ? H - 2 : 0;
  return lane_smem_bytes(Band(n, c, 0).rows + 2, W);
}

// The cluster barrier: every thread of every block of the cluster arrives
// (release: its shared and DSMEM stores before it are seen by any thread
// past the wait) and waits (acquire).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One block of a lane's cluster: its band, its layout, and where the band
// of each neighbour keeps the halo row this band's edge row feeds.
struct ClusterBlock {
  cg::cluster_group cluster;
  int n, c, rank, W;
  Band band;
  LaneSmem m;
  __device__ ClusterBlock(int H, int w)
      : cluster(cg::this_cluster()),
        n(H - 2),
        c(static_cast<int>(cluster.num_blocks())),
        rank(static_cast<int>(cluster.block_rank())),
        W(w),
        band(n, c, rank),
        m(band.rows + 2, w) {}
  // Rank 0's delta word `slot`, where every block of the cluster reduces.
  __device__ unsigned int* delta(int slot) const {
    return cluster.map_shared_rank(Band(n, c, 0).smem(W).delta(slot), 0);
  }
  // The cells of lane class q in this band's first and last rows, copied
  // into the bottom halo row of the band above and the top halo row of the
  // band below (DSMEM stores; neighbour ranks without rows get nothing).
  template <int kThreads>
  __device__ void push_edges(int q) const {
    if (band.rows == 0) return;
    const int P = m.P;
    const float* top = m.a(band.local(q)) + P;
    const float* bottom = m.a(band.local(q)) + band.rows * P;
    float* up = nullptr;
    float* down = nullptr;
    if (rank > 0) {
      const Band b(n, c, rank - 1);
      up = cluster.map_shared_rank(b.smem(W).a(b.local(q)) + (b.rows + 1) * P, rank - 1);
    }
    const Band below(n, c, rank + 1);
    if (rank + 1 < c && below.rows > 0)
      down = cluster.map_shared_rank(below.smem(W).a(below.local(q)), rank + 1);
    for (int i = threadIdx.x; i < 2 * P; i += kThreads) {
      if (i < P) {
        if (up != nullptr) up[i] = top[i];
      } else if (down != nullptr) {
        down[i - P] = bottom[i - P];
      }
    }
  }
};

// One sweep of lane class q over the block's band, then the push of its
// edge rows and the cluster barrier. With kFirst the band's max |u1 - u0|
// goes into `word` (rank 0's).
template <bool kFirst, int kThreads>
__device__ __forceinline__ void cluster_sweep(const ClusterBlock& cb, int q, unsigned int* word) {
  const float local = sweep_lane<kFirst, kThreads>(cb.m, cb.band.local(q), 0.0f);
  if (kFirst) reduce_delta(local, word);
  __syncthreads();
  cb.push_edges<kThreads>(q);
  cluster_barrier();
}

// K12 on the cluster route: cluster L (c blocks) takes lane L. A lane whose
// active flag is 0 returns at once in every block, before any DSMEM
// access, with delta 0; else each block loads its band, a cluster barrier
// (every block started, rank 0's delta words zeroed), num_sweeps sweeps
// from iteration *it, delta[L] the sweep-0 delta, and each block writes
// its band back. The last sweep's barrier is the last DSMEM access.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cluster_chunk_kernel(float* u, const uint8_t* locked, int H, int W, const int* it,
                     int num_sweeps, const uint8_t* active, float* delta) {
  const ClusterBlock cb(H, W);
  const int L = blockIdx.x / cb.c;
  if (active != nullptr && active[L] == 0) {
    if (cb.rank == 0 && threadIdx.x == 0) delta[L] = 0.0f;
    return;
  }
  const size_t off = (static_cast<size_t>(L) * H + cb.band.r0 - 1) * W;
  load_lane<kThreads>(u + off, locked + off, cb.m);
  cb.cluster.sync();
  const int t0 = *it;
  cluster_sweep<true, kThreads>(cb, (t0 & 1) ^ 1, cb.delta(0));
  for (int s = 1; s < num_sweeps; ++s)
    cluster_sweep<false, kThreads>(cb, ((t0 + s) & 1) ^ 1, nullptr);
  if (cb.rank == 0 && threadIdx.x == 0) delta[L] = __uint_as_float(*cb.m.delta(0));
  store_lane<kThreads>(u + off, cb.m);
}

// K13 and _solve_collage_device's loop on the cluster route: cluster L runs
// lane_solve_kernel's protocol for lane L. Cycle k reduces into rank 0's
// delta slot k % 3 and, after the checked sweep's whole barrier, every
// thread of the cluster reads it and takes the same verdict. Rank 0's
// thread 0 clears slot (k + 1) % 3 before that barrier: every block read it
// in cycle k - 2, before arriving at a barrier that rank 0 has passed, and
// reduces into it only after this one. A last barrier keeps rank 0's words
// alive until every block has read them; rank 0 writes the results.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cluster_solve_kernel(float* u, const uint8_t* locked, int H, int W, const float* eps,
                     int m_max, int max_iterations, int stagger, uint8_t* retired, int* iters,
                     float* deltas) {
  const ClusterBlock cb(H, W);
  const int L = blockIdx.x / cb.c;
  const size_t off = (static_cast<size_t>(L) * H + cb.band.r0 - 1) * W;
  load_lane<kThreads>(u + off, locked + off, cb.m);
  cb.cluster.sync();
  const float e = eps[L];
  float d = 0.0f;
  bool done = false;
  int t = 0;
  for (int k = 0; t < max_iterations; t += stagger, ++k) {
    unsigned int* word = cb.delta(k % kDeltaSlots);
    if (cb.rank == 0 && threadIdx.x == 0) *cb.m.delta((k + 1) % kDeltaSlots) = 0u;
    cluster_sweep<true, kThreads>(cb, (t & 1) ^ 1, word);
    d = __uint_as_float(*word);
    done = d < e && t + 1 >= m_max;
    if (done) break;
    for (int s = 1; s < stagger; ++s)
      cluster_sweep<false, kThreads>(cb, ((t + s) & 1) ^ 1, nullptr);
  }
  cb.cluster.sync();
  if (cb.rank == 0 && threadIdx.x == 0 && max_iterations > 0) {
    deltas[L] = d;
    iters[L] = done ? t + 1 : t;
    retired[L] = done;
  }
  store_lane<kThreads>(u + off, cb.m);
}

// A launch of a cluster kernel for c blocks a lane: B * c blocks of
// kClusterThreads, clusters of c, each block with cluster_smem_bytes. A c
// outside 2..kMaxCluster, a lane under 3 x 3, a band beyond the device's
// opt-in shared memory a block, or a cluster the occupancy query cannot
// place is refused (cudaErrorInvalidValue, cudaErrorInvalidConfiguration)
// with no launch: the caller names the route, and no other is taken.
cudaError_t cluster_config(const void* kernel, int B, int H, int W, int c, int device,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (c < 2 || c > kMaxCluster || H < 3 || W < 3) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const size_t smem = cluster_smem_bytes(H, W, c);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (c > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned int>(B > 0 ? B : 1) * c);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (err != cudaSuccess) return err;
  return clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

cudaError_t launch_clusters(const void* kernel, int B, int H, int W, int c, void** args,
                            int device, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, B, H, W, c, device, stream, &cfg, &attr);
  if (err != cudaSuccess || B == 0) return err;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define CLUSTER_KERNEL(name) \
  reinterpret_cast<const void*>(name<kClusterThreads, kClusterMinBlocks>)

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u is f32[B, H, W] and locked u8[B, H, W], contiguous.
// `blocks` names the route by the blocks a lane takes: 1 the resident
// kernels (refused with cudaErrorInvalidValue for a lane beyond
// epic_batched2d_smem_bytes' fit), c >= 2 the cluster kernels with clusters
// of c (refused as cluster_config says); any other value is refused
// (cudaErrorInvalidValue): lanes past every cluster go to tile2d.cu's
// epic_lanes2d_* entries.

// The resident route's dynamic shared memory for an H x W lane.
long long epic_batched2d_smem_bytes(int H, int W) {
  return static_cast<long long>(lane_smem_bytes(H, W));
}

// The cluster route's dynamic shared memory a block for an H x W lane in
// clusters of c: the largest band's layout.
long long epic_batched2d_cluster_smem_bytes(int H, int W, int c) {
  return c < 1 ? -1 : static_cast<long long>(cluster_smem_bytes(H, W, c));
}

// *largest: the largest c <= kMaxCluster for which the occupancy query
// places at least one cluster of the cluster chunk kernel, each block with
// the device's whole opt-in shared memory (so any lane's band fits), or 0.
int epic_batched2d_max_cluster(int device, int* largest) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* kernel = CLUSTER_KERNEL(cluster_chunk_kernel);
  err = allow_smem(kernel, limit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *largest = 0;
  for (int c = kMaxCluster; c >= 2; --c) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = limit;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters > 0) {
      *largest = c;
      break;
    }
  }
  return cudaSuccess;
}

// delta is f32[B]: every lane's is written (0 for a lane whose active flag
// is 0).
int epic_batched2d_chunk(void* u, const void* locked, int B, int H, int W, const void* it,
                         int num_sweeps, const void* active, void* delta, int blocks,
                         void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const int* it_i = static_cast<const int*>(it);
  const uint8_t* active_b = static_cast<const uint8_t*>(active);
  float* delta_f = static_cast<float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&u_f, &locked_b, &H, &W, &it_i, &num_sweeps, &active_b, &delta_f};
  if (blocks == 1) return launch_lanes(LANE_KERNELS(lane_chunk_kernel), B, H, W, args, device, s);
  return launch_clusters(CLUSTER_KERNEL(cluster_chunk_kernel), B, H, W, blocks, args, device, s);
}

// retired u8[B], iters i32[B] and deltas f32[B] hold the caller's starting
// values (0, 0, eps + 1).
int epic_batched2d_solve(void* u, const void* locked, int B, int H, int W, const void* eps,
                         int m_max, int max_iterations, int stagger, void* retired, void* iters,
                         void* deltas, int blocks, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  uint8_t* retired_b = static_cast<uint8_t*>(retired);
  int* iters_i = static_cast<int*>(iters);
  float* deltas_f = static_cast<float*>(deltas);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&u_f, &locked_b, &H, &W, &eps_f, &m_max, &max_iterations, &stagger,
                  &retired_b, &iters_i, &deltas_f};
  if (blocks == 1) return launch_lanes(LANE_KERNELS(lane_solve_kernel), B, H, W, args, device, s);
  return launch_clusters(CLUSTER_KERNEL(cluster_solve_kernel), B, H, W, blocks, args, device, s);
}

}  // extern "C"
