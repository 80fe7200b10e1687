// The 3D mesh solver's kernels on NVIDIA Hopper (sm_90a): one shard's chunk,
// and every shard of a device in one launch.
//
// Replaces four TPU kernels, which all compute one function (ns guarded lse6
// sweeps of one shard's extended block from iteration t0, exact on the
// shard's centre, and sweep 0's delta) and differ only in how they stage
// data through VMEM:
//   epic_shard3d_chunk    <- epic_tpu/parallel/sharded3d.py:170
//                            _sweep_k_local_kernel (K18; the whole block in
//                            VMEM) and :243 _band_shard3d_kernel (K19; DMA
//                            plane bands), the delta over the whole block;
//                            resident3d.py:233 _chunk_cycle (K20; K11's body
//                            at nc = 1 on a plane-guarded resident shard) and
//                            resident_z.py:166 _resident_z_kernel (K21; whole
//                            planes and guard planes), the delta over the
//                            centre. Every chunk runs right after a halo
//                            exchange, so at sweep 0 a halo voxel holds its
//                            owner's values and gets its owner's update (out-
//                            of-mesh halo and padding are frozen): the max
//                            over the shards is the same, and the entry takes
//                            the whole block
//   epic_resident3d_cycle <- the same four, on every shard of a device whose
//                            face neighbours all live on it (a whole plan):
//                            ns sweeps of the shards' centres in one launch
//   epic_resident3d_solve <- the solve loops around them (sharded3d.py's
//                            and resident3d.py's / resident_z.py's host
//                            loops of stagger cycles), in one launch
// The plain versions are sweep_k_local3d in
// epic_tpu_torch/parallel/hopper_shard3d.py and plain_cycle3d/plain_solve3d
// in epic_tpu_torch/parallel/hopper_resident3d.py.
//
// The block. After the halo exchange a shard's buffer holds its centre with
// a halo of hz, hy, hx voxels on the axes the mesh cuts (0 on the others):
// a view of de x he x we voxels with a plane pitch lp and a row pitch lr (in
// elements, u, u1 and the frozen bytes alike). Sweep s updates a voxel
// (Z, Y, X) only inside the block's trapezoid, s+1 <= L <= e-2-s on a cut
// axis (sharded3d.py:157-159, :192-194; K19's static edge guards and K21's
// plane trapezoid give the same voxels) and 1 <= L <= e-2 on an uncut one
// (its faces are the volume's frozen shell or mesh padding), only if its
// frozen byte is 0 (locked, the shell, padding, out-of-mesh halo), and only
// of the 3D class (par0 + Z + Y + X) % 2 == (t0 + s) % 2, par0 the parity of
// the block's global origin (sharded3d.py:161, :196, :318; the class is the
// other one than 2D's, and the two must not be unified).
//
// Design: K7's (sweep3d.cu), not the temporally blocked tile pass of
// tile3d.cu, which loses to K7 at every volume measured on this card. One
// persistent cooperative kernel relaxes in place in device memory (a class
// reads only the other class, so the update is race-free) with a grid
// barrier between sweeps. Shard rows are short (80 voxels on a 2 x 4 mesh of
// 256^3), so no thread group owns a row: a lane takes one class voxel of a
// flat walk (Walk below) over the half-row slots of the sweep's box, x =
// x0 + 2j + (parity), the slot past a row's end masked. The walk turns a
// flat index into its digits once a thread a sweep and then steps by the
// grid's thread count with carries, so no voxel pays a division. Offsets are
// 64-bit: a 64 x 1024 x 1024 block with halos passes 2^31 bytes; the flat
// index is 32-bit (the wrappers refuse a sweep of 2^31 slots or more).
//
// The per-shard entry needs no twin: the halo voxels a chunk leaves stale
// are rewritten by the next exchange, since a neighbour reads only this
// shard's centre faces. The device entries need no halo: a whole plan's
// launch updates only the centres, and a read that leaves a centre across a
// cut face goes to that face's neighbour's centre on the same device (a
// DIRECT face), in place, so the launch computes K7's sweeps on the whole
// volume. Across an OUTSIDE face (the mesh's edge) it reads the own halo,
// which holds the frozen fill; no voxel updated reads it, since the volume's
// shell lies there. An uncut axis stays inside the block (its positions 0
// and e-1 are the frozen shell or padding). Only the updated voxel's own
// frozen byte is read. A neighbour that lives on another device or process
// (a COPIED face) is not the device entries' to read: such a plan takes the
// per-shard entry after a halo exchange.
//
// u1, when given, receives the centres after sweep 0 (the solve's checked
// chunk keeps it on exit): a barrier, a copy pass, and a barrier before
// sweep 1. The delta is max |u1 - u0| of sweep 0 (over the whole block for
// the per-shard entry, over the centres for the device entries), reduced
// with block_max_atomic (deterministic: max is exact in any order). The
// solve entry checks its cycles' first sweeps in place, as K7's solve3d
// does: the state on exit is the checked sweep's, so it needs no u1.
//
// Numerics. lse6 from sweep_common.cuh, no --use_fast_math: the plain
// versions' bits.
//
// Bound on this card. An update reads six neighbours; a shard of 256^3 on
// 2 x 4 or 8 x 1 x 1 meshes (about 15 MB of u and frozen bytes with its
// halos) fits the 50 MB L2, so the per-shard chunk is bound by L2 traffic,
// the issue of its updates (lse6 is 91 SASS instructions) and the barrier;
// a whole volume's launch is bound as K7 is: by HBM bandwidth past the L2
// (256^3, 64 x 1024 x 1024), by the updates' issue and the barriers within
// it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsShard = 128;
// Blocks an SM must hold (launch bounds): caps the device entries'
// registers, so that enough warps hide the loads' latency.
constexpr int kMinBlocksDevice = 12;

// A flat walk over the positions (i3, i2, i1, i0) of a box whose three
// fastest extents are n0, n1, n2 (i3 is bounded by the count): the grid's
// thread g takes flat indices g, g + G, g + 2G, ... below the count, G the
// grid's thread count. The digits of g and of G are taken once, by 32-bit
// division; each step adds G's digits with carries. The extents are the
// caller's (kernel parameters, mostly), passed again to each step, so the
// walk holds only its position and G's digits in registers.
struct Walk {
  unsigned int i;
  int i0, i1, i2, i3;
  int d0, d1, d2, d3;

  __device__ static void digits(unsigned int v, int n0, int n1, int n2, int& a0, int& a1,
                                int& a2, int& a3) {
    a0 = static_cast<int>(v % n0);
    v /= n0;
    a1 = static_cast<int>(v % n1);
    v /= n1;
    a2 = static_cast<int>(v % n2);
    a3 = static_cast<int>(v / n2);
  }
  __device__ Walk(int n0, int n1, int n2) : i(blockIdx.x * blockDim.x + threadIdx.x) {
    digits(i, n0, n1, n2, i0, i1, i2, i3);
    digits(gridDim.x * blockDim.x, n0, n1, n2, d0, d1, d2, d3);
  }
  __device__ __forceinline__ void next(int n0, int n1, int n2) {
    i += gridDim.x * blockDim.x;
    i0 += d0;
    i1 += d1;
    i2 += d2;
    i3 += d3;
    if (i0 >= n0) {
      i0 -= n0;
      ++i1;
    }
    if (i1 >= n1) {
      i1 -= n1;
      ++i2;
    }
    if (i2 >= n2) {
      i2 -= n2;
      ++i3;
    }
  }
};

// ---------------------------------------------------------------------------
// One shard's chunk (epic_shard3d_chunk)
// ---------------------------------------------------------------------------

struct Shard3 {
  float* u;               // the block's (0, 0, 0)
  float* u1;              // null, or a block of u's pitches for the centre after sweep 0
  const uint8_t* frozen;
  long long lp, lr;       // plane and row pitch, in elements
  int de, he, we;         // the block
  int hz, hy, hx;         // halo depth on each axis (0 where the mesh does not cut it)
  int par0;               // (z + y + x) & 1 of the block's (0, 0, 0), global
};

// The positions [lo, hi] sweep s updates on an axis of extent e and halo h.
__device__ __forceinline__ void span(int e, int h, int s, int& lo, int& hi) {
  lo = h > 0 ? s + 1 : 1;
  hi = h > 0 ? e - 2 - s : e - 2;
}

// Sweep s over the class (par0 + z + y + x) & 1 == t & 1 of the trapezoid,
// a lane a half-row slot. With kCheck, returns this thread's max |u1 - u0|.
template <bool kCheck>
__device__ float sweep(const Shard3& g, int s, int t) {
  int z0, z1, y0, y1, x0, x1;
  span(g.de, g.hz, s, z0, z1);
  span(g.he, g.hy, s, y0, y1);
  span(g.we, g.hx, s, x0, x1);
  float local = 0.0f;
  if (z1 < z0 || y1 < y0 || x1 < x0) return local;
  const int ny = y1 - y0 + 1;
  const int nz = z1 - z0 + 1;
  const int nj = (x1 - x0 + 2) / 2;
  const int q = (t + g.par0 + x0) & 1;
  const unsigned int count = static_cast<unsigned int>(nz) * ny * nj;
  for (Walk w(nj, ny, nz); w.i < count; w.next(nj, ny, nz)) {
    const int z = z0 + w.i2;
    const int y = y0 + w.i1;
    const int x = x0 + 2 * w.i0 + ((q + z + y) & 1);
    if (x > x1) continue;
    const long long idx = z * g.lp + y * g.lr + x;
    if (g.frozen[idx]) continue;
    const float v = lse6(__ldcg(g.u + idx - g.lp), __ldcg(g.u + idx + g.lp),
                         __ldcg(g.u + idx - g.lr), __ldcg(g.u + idx + g.lr),
                         __ldcg(g.u + idx - 1), __ldcg(g.u + idx + 1));
    if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(g.u + idx)));
    g.u[idx] = v;
  }
  return local;
}

// u's centre into u1, a lane a voxel.
__device__ void copy_centre(const Shard3& g) {
  const int cz = g.de - 2 * g.hz;
  const int cy = g.he - 2 * g.hy;
  const int cx = g.we - 2 * g.hx;
  const unsigned int count = static_cast<unsigned int>(cz) * cy * cx;
  for (Walk w(cx, cy, cz); w.i < count; w.next(cx, cy, cz)) {
    const long long idx = (g.hz + w.i2) * g.lp + (g.hy + w.i1) * g.lr + g.hx + w.i0;
    g.u1[idx] = __ldcg(g.u + idx);
  }
}

// K18-K21: one chunk of ns sweeps from iteration *it + t_off on a shard's
// block, in place; sweep 0's delta max-accumulated into delta_bits when it
// is not null.
__global__ void __launch_bounds__(kThreadsShard)
shard3d_chunk_kernel(Shard3 g, const int* it, int t_off, int ns, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = *it + t_off;
  if (delta_bits != nullptr) {
    block_max_atomic<kThreadsShard>(sweep<true>(g, 0, t0), delta_bits);
  } else {
    sweep<false>(g, 0, t0);
  }
  if (g.u1 != nullptr) {
    grid.sync();
    copy_centre(g);
  }
  for (int s = 1; s < ns; ++s) {
    grid.sync();
    sweep<false>(g, s, t0 + s);
  }
}

// ---------------------------------------------------------------------------
// Every shard of a device (epic_resident3d_cycle, epic_resident3d_solve)
// ---------------------------------------------------------------------------

// The plan's table (parallel/hopper_resident3d.py's _table): a row of int64
// a shard, with its blocks' addresses (u, u1 or 0, frozen; the block's
// (0, 0, 0)), the parity of its centre's global origin, and the slot of each
// face's DIRECT neighbour in the order (z-, z+, y-, y+, x-, x+) (-1: the own
// block).
constexpr int kPlanU = 0;
constexpr int kPlanU1 = 1;
constexpr int kPlanFrozen = 2;
constexpr int kPlanPar0 = 3;
constexpr int kPlanFaces = 4;
constexpr int kPlanCols = 10;

struct Plan3 {
  const long long* rows;
  int n_shards;
  int d, h, w;            // every shard's centre
  int hz, hy, hx;         // the centre's origin in the block
  long long lp, lr;       // the blocks' plane and row pitch, in elements
  // The shard's centre origin in its block, and each face's shift: a voxel
  // across face f of the centre lies at the same offset from the DIRECT
  // neighbour's centre origin plus shift f (z-: +d planes, z+: -d, ...).
  __device__ __forceinline__ long long origin() const { return hz * lp + hy * lr + hx; }
  __device__ __forceinline__ long long shift(int f) const {
    const long long n = f < 2 ? d * lp : f < 4 ? h * lr : static_cast<long long>(w);
    return (f & 1) ? -n : n;
  }
};

// The array a read across face f of shard s indexes: the DIRECT
// neighbour's u at its centre origin, shifted, else the own u.
__device__ __forceinline__ const float* across(const Plan3& p, int s, int f, const float* own) {
  const long long nb = p.rows[static_cast<long long>(s) * kPlanCols + kPlanFaces + f];
  if (nb < 0) return own;
  return reinterpret_cast<const float*>(p.rows[nb * kPlanCols + kPlanU]) + p.origin() +
         p.shift(f);
}

// One shard's centre as a lane reads it: u and the frozen bytes at the
// centre's origin, the parity of its global origin, and the arrays the
// reads across its x faces index (every row has voxels on both).
struct Centre {
  float* u;
  const uint8_t* frozen;
  const float* xm;
  const float* xp;
  int par;
};

__device__ __forceinline__ void load_centre(const Plan3& p, int s, Centre& c) {
  const long long* row = p.rows + static_cast<long long>(s) * kPlanCols;
  const long long o = p.origin();
  c.u = reinterpret_cast<float*>(row[kPlanU]) + o;
  c.frozen = reinterpret_cast<const uint8_t*>(row[kPlanFrozen]) + o;
  c.par = static_cast<int>(row[kPlanPar0]) & 1;
  c.xm = across(p, s, 4, c.u);
  c.xp = across(p, s, 5, c.u);
}

// Sweep t over the class (par + z + y + x) & 1 == t & 1 of every shard's
// centre, a lane a half-row slot. The x neighbours come from the own block
// or, at a row's ends, the x faces' arrays (a select, so no lane diverges);
// the z and y neighbours from the own block, except on the centre's z and y
// faces, whose rows look their arrays up in the plan's table (a branch
// that a row takes as a whole). With kCheck, returns this thread's max
// |u1 - u0|.
template <bool kCheck>
__device__ float centre_sweep(const Plan3& p, int t) {
  const int nj = (p.w + 1) / 2;
  Centre c;
  int cur = -1;
  float local = 0.0f;
  const unsigned int count = static_cast<unsigned int>(p.n_shards) * p.d * p.h * nj;
  for (Walk wk(nj, p.h, p.d); wk.i < count; wk.next(nj, p.h, p.d)) {
    if (wk.i3 != cur) {
      cur = wk.i3;
      load_centre(p, cur, c);
    }
    const int z = wk.i2;
    const int y = wk.i1;
    const int x = 2 * wk.i0 + ((t + c.par + z + y) & 1);
    if (x >= p.w) continue;
    const long long idx = z * p.lp + y * p.lr + x;
    if (c.frozen[idx]) continue;
    const float* q = c.u + idx;
    float zm, zp, ym, yp;
    if (static_cast<unsigned int>(z - 1) < static_cast<unsigned int>(p.d - 2) &&
        static_cast<unsigned int>(y - 1) < static_cast<unsigned int>(p.h - 2)) {
      zm = __ldcg(q - p.lp);
      zp = __ldcg(q + p.lp);
      ym = __ldcg(q - p.lr);
      yp = __ldcg(q + p.lr);
    } else {
      zm = __ldcg((z == 0 ? across(p, cur, 0, c.u) : c.u) + idx - p.lp);
      zp = __ldcg((z == p.d - 1 ? across(p, cur, 1, c.u) : c.u) + idx + p.lp);
      ym = __ldcg((y == 0 ? across(p, cur, 2, c.u) : c.u) + idx - p.lr);
      yp = __ldcg((y == p.h - 1 ? across(p, cur, 3, c.u) : c.u) + idx + p.lr);
    }
    const float xm = __ldcg((x == 0 ? c.xm : c.u) + idx - 1);
    const float xp = __ldcg((x == p.w - 1 ? c.xp : c.u) + idx + 1);
    const float v = lse6(zm, zp, ym, yp, xm, xp);
    if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(q)));
    c.u[idx] = v;
  }
  return local;
}

// Every shard's centre into its u1 block, a lane a voxel.
__device__ void copy_centres(const Plan3& p) {
  const long long o = p.origin();
  const unsigned int count = static_cast<unsigned int>(p.n_shards) * p.d * p.h * p.w;
  for (Walk wk(p.w, p.h, p.d); wk.i < count; wk.next(p.w, p.h, p.d)) {
    const long long* row = p.rows + static_cast<long long>(wk.i3) * kPlanCols;
    const long long idx = o + wk.i2 * p.lp + wk.i1 * p.lr + wk.i0;
    reinterpret_cast<float*>(row[kPlanU1])[idx] =
        __ldcg(reinterpret_cast<const float*>(row[kPlanU]) + idx);
  }
}

// ns sweeps from *it + t_off on every shard of the plan, in place; sweep
// 0's delta over the centres max-accumulated into delta_bits (zeroed by the
// caller); with with_u1 the centres after sweep 0 to the u1 blocks.
__global__ void __launch_bounds__(kThreadsShard, kMinBlocksDevice)
resident3d_cycle_kernel(Plan3 p, const int* it, int t_off, int ns, int with_u1,
                        unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = *it + t_off;
  block_max_atomic<kThreadsShard>(centre_sweep<true>(p, t0), delta_bits);
  if (with_u1 != 0) {
    grid.sync();
    copy_centres(p);
  }
  for (int s = 1; s < ns; ++s) {
    grid.sync();
    centre_sweep<false>(p, t0 + s);
  }
}

// K7's solve3d_kernel on every shard of the plan, resumable: from the
// iteration, delta and verdict in it_io/delta_io/done_io, run stagger
// cycles while not done and it < bound. Each cycle a checked sweep, a
// barrier, then every thread reads the same delta and decides (exit only
// right after a passing check with it + 1 >= m_max); on exit the centres
// already hold the checked sweep's state. acc holds two zeroed slots that
// the checks alternate between, each cleared a barrier before its next use.
// The incoming verdict is kept in shared memory (thread 0 writes *done_io at
// the end, while another block may still be reading).
__global__ void __launch_bounds__(kThreadsShard, kMinBlocksDevice)
resident3d_solve_kernel(Plan3 p, const float* eps_ptr, int m_max, int bound, int stagger,
                        unsigned int* acc, int* it_io, float* delta_io, int* done_io) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int done0;
  if (threadIdx.x == 0) done0 = *done_io;
  __syncthreads();
  const float eps = *eps_ptr;
  int it = *it_io;
  float delta = 0.0f;
  bool checked = false;
  bool done = false;
  int slot = 0;
  while (done0 == 0 && it < bound) {
    block_max_atomic<kThreadsShard>(centre_sweep<true>(p, it), acc + slot);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    checked = true;
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    if (delta < eps && it + 1 >= m_max) {
      it += 1;
      done = true;
      break;
    }
    for (int s = 1; s < stagger; ++s) {
      centre_sweep<false>(p, it + s);
      grid.sync();
    }
    if (stagger == 1) grid.sync();
    it += stagger;
  }
  if (grid.thread_rank() == 0) {
    *it_io = it;
    if (checked) *delta_io = delta;
    *done_io = done0 != 0 || done ? 1 : 0;
  }
}

// The plan of an entry's arguments, and the blocks of a cooperative launch
// that gives a lane each class slot of a sweep (at most what the card holds).
Plan3 make_plan(const void* table, int n_shards, int d, int h, int w, int hz, int hy, int hx,
                long long lp, long long lr) {
  Plan3 p;
  p.rows = static_cast<const long long*>(table);
  p.n_shards = n_shards;
  p.d = d;
  p.h = h;
  p.w = w;
  p.hz = hz;
  p.hy = hy;
  p.hx = hx;
  p.lp = lp;
  p.lr = lr;
  return p;
}

cudaError_t launch(const void* kernel, long long slots, void** args, int device, void* stream) {
  int blocks = 0;
  cudaError_t err = grid_blocks(kernel, kThreadsShard, device,
                                (slots + kThreadsShard - 1) / kThreadsShard, &blocks, 0);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreadsShard), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream), does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// (0 on success).

// One chunk of ns sweeps from iteration *it + t_off on one shard's extended
// block, in place: u (f32) and frozen (u8) are views of de x he x we voxels
// with plane pitch lp and row pitch lr (elements); hz, hy, hx the halo on
// each axis (0 where the mesh does not cut it; ns is at most the smallest
// non-zero one); par0 the (z + y + x) & 1 of the view's (0, 0, 0) in global
// coordinates. With u1 non-null (a view of u's pitches, another buffer), the
// centre after sweep 0 goes there. With delta non-null, sweep 0's delta over
// the whole block is max-accumulated into it (zeroed by the caller). The
// block's class slots, de * he * ceil(we / 2), must be below 2^31.
int epic_shard3d_chunk(void* u, void* u1, const void* frozen, long long lp, long long lr, int de,
                       int he, int we, int hz, int hy, int hx, int par0, const void* it,
                       int t_off, int ns, void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Shard3 g;
  g.u = static_cast<float*>(u);
  g.u1 = static_cast<float*>(u1);
  g.frozen = static_cast<const uint8_t*>(frozen);
  g.lp = lp;
  g.lr = lr;
  g.de = de;
  g.he = he;
  g.we = we;
  g.hz = hz;
  g.hy = hy;
  g.hx = hx;
  g.par0 = par0 & 1;
  const long long slots = (de > 2 && he > 2 && we > 2)
                              ? static_cast<long long>(de - 2) * (he - 2) * ((we - 1) / 2)
                              : 0;
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&g, &it_i, &t_off, &ns, &delta_bits};
  return launch(reinterpret_cast<const void*>(shard3d_chunk_kernel), slots, args, device, stream);
}

// ns sweeps from iteration *it + t_off on every shard of a whole plan, in
// place: `plan` is the device table of n_shards rows (kPlanCols int64 each:
// the u, u1 or 0, and frozen blocks' addresses, the centre's parity origin,
// six face slots); every shard's centre is d x h x w at (hz, hy, hx) in a
// block of plane pitch lp and row pitch lr (elements). Sweep 0's delta over
// the centres is max-accumulated into `delta` (zeroed by the caller); with
// with_u1 the centres after sweep 0 go to the u1 blocks. The centres' class
// slots, n_shards * d * h * ceil(w / 2), must be below 2^31.
int epic_resident3d_cycle(const void* plan, int n_shards, int d, int h, int w, int hz, int hy,
                          int hx, long long lp, long long lr, const void* it, int t_off, int ns,
                          int with_u1, void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan3 p = make_plan(plan, n_shards, d, h, w, hz, hy, hx, lp, lr);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&p, &it_i, &t_off, &ns, &with_u1, &delta_bits};
  return launch(reinterpret_cast<const void*>(resident3d_cycle_kernel),
                static_cast<long long>(n_shards) * d * h * ((w + 1) / 2), args, device, stream);
}

// The stagger protocol on every shard of a whole plan (the plan's arguments
// as for epic_resident3d_cycle), resumed from *it_io, *delta_io and
// *done_io and run while not done and the iteration is below `bound`; the
// three are updated in place. eps is a device float; acc two zeroed uints.
int epic_resident3d_solve(const void* plan, int n_shards, int d, int h, int w, int hz, int hy,
                          int hx, long long lp, long long lr, const void* eps, int m_max,
                          int bound, int stagger, void* acc, void* it_io, void* delta_io,
                          void* done_io, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan3 p = make_plan(plan, n_shards, d, h, w, hz, hy, hx, lp, lr);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* it_i = static_cast<int*>(it_io);
  float* delta_f = static_cast<float*>(delta_io);
  int* done_i = static_cast<int*>(done_io);
  void* args[] = {&p, &eps_f, &m_max, &bound, &stagger, &acc_u, &it_i, &delta_f, &done_i};
  return launch(reinterpret_cast<const void*>(resident3d_solve_kernel),
                static_cast<long long>(n_shards) * d * h * ((w + 1) / 2), args, device, stream);
}

}  // extern "C"
