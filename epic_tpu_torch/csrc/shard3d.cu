// One shard's chunk of the 3D mesh solver on NVIDIA Hopper (sm_90a).
//
// Replaces four TPU kernels, which all compute one function (ns guarded lse6
// sweeps of one shard's extended block from iteration t0, exact on the
// shard's centre, and sweep 0's delta) and differ only in how they stage
// data through VMEM:
//   epic_shard3d_chunk <- epic_tpu/parallel/sharded3d.py:170
//                         _sweep_k_local_kernel (K18; the whole block in VMEM)
//                         and :243 _band_shard3d_kernel (K19; DMA plane
//                         bands), the delta over the whole block;
//                         resident3d.py:233 _chunk_cycle (K20; K11's body at
//                         nc = 1 on a plane-guarded resident shard) and
//                         resident_z.py:166 _resident_z_kernel (K21; whole
//                         planes and guard planes), the delta over the
//                         centre. Every chunk runs right after a halo
//                         exchange, so at sweep 0 a halo voxel holds its
//                         owner's values and gets its owner's update (out-of-
//                         mesh halo and padding are frozen): the max over the
//                         shards is the same, and the entry takes the whole
//                         block
// The plain version is sweep_k_local3d in
// epic_tpu_torch/parallel/hopper_shard3d.py.
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
// persistent cooperative kernel relaxes the block in place in device memory
// (a class reads only the other class, so the update is race-free) with a
// grid barrier between sweeps. No twin is needed: the halo voxels the chunk
// leaves stale are rewritten by the next exchange, since a neighbour reads
// only this shard's centre faces. Shard rows are short (80 voxels on a
// 2 x 4 mesh of 256^3), so a warp, not a block, owns a (Z, Y) row, and its
// lanes take the row's voxels of the class two apart. Offsets are 64-bit: a
// 64 x 1024 x 1024 block with halos passes 2^31 bytes.
//
// u1, when given, receives the centre after sweep 0 (the solve's checked
// chunk keeps it on exit): a barrier, a copy pass over the centre, and a
// barrier before sweep 1. The delta is max |u1 - u0| of sweep 0 over the
// whole block, reduced with block_max_atomic (deterministic: max is exact
// in any order).
//
// Numerics. lse6 from sweep_common.cuh, no --use_fast_math: the plain
// version's bits.
//
// Bound on this card. An update reads six neighbours; a shard of 256^3 on
// 2 x 4 or 8 x 1 x 1 meshes (about 15 MB of u and frozen bytes with its
// halos) fits the 50 MB L2, so a chunk is bound by L2 traffic and the
// barrier, one launch a shard a chunk; a 64 x 1024 x 1024 volume's shards
// (46 MB) sit at the L2's edge, and past it by HBM bandwidth, as K7 is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsShard = 128;
constexpr int kWarpsShard = kThreadsShard / 32;

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

// Sweep s over the class (par0 + z + y + x) & 1 == t & 1 of the trapezoid.
// With kCheck, returns this thread's max |u1 - u0|.
template <bool kCheck>
__device__ float sweep(const Shard3& g, int s, int t) {
  int z0, z1, y0, y1, x0, x1;
  span(g.de, g.hz, s, z0, z1);
  span(g.he, g.hy, s, y0, y1);
  span(g.we, g.hx, s, x0, x1);
  float local = 0.0f;
  if (z1 < z0 || y1 < y0 || x1 < x0) return local;
  const int ny = y1 - y0 + 1;
  const int rows = (z1 - z0 + 1) * ny;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsShard;
  for (int r = blockIdx.x * kWarpsShard + (threadIdx.x >> 5); r < rows; r += stride) {
    const int z = z0 + r / ny;
    const int y = y0 + r % ny;
    const long long row = z * g.lp + y * g.lr;
    for (int x = x0 + ((t + g.par0 + z + y + x0) & 1) + 2 * lane; x <= x1; x += 64) {
      const long long idx = row + x;
      if (g.frozen[idx]) continue;
      const float v = lse6(__ldcg(g.u + idx - g.lp), __ldcg(g.u + idx + g.lp),
                           __ldcg(g.u + idx - g.lr), __ldcg(g.u + idx + g.lr),
                           __ldcg(g.u + idx - 1), __ldcg(g.u + idx + 1));
      if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(g.u + idx)));
      g.u[idx] = v;
    }
  }
  return local;
}

// u's centre into u1, a warp a row.
__device__ void copy_centre(const Shard3& g) {
  const int cy = g.he - 2 * g.hy;
  const int rows = (g.de - 2 * g.hz) * cy;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsShard;
  for (int r = blockIdx.x * kWarpsShard + (threadIdx.x >> 5); r < rows; r += stride) {
    const long long row = (g.hz + r / cy) * g.lp + (g.hy + r % cy) * g.lr;
    for (int x = g.hx + lane; x < g.we - g.hx; x += 32) g.u1[row + x] = __ldcg(g.u + row + x);
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

}  // namespace

extern "C" {

// One chunk of ns sweeps from iteration *it + t_off on one shard's extended
// block, in place: u (f32) and frozen (u8) are views of de x he x we voxels
// with plane pitch lp and row pitch lr (elements); hz, hy, hx the halo on
// each axis (0 where the mesh does not cut it; ns is at most the smallest
// non-zero one); par0 the (z + y + x) & 1 of the view's (0, 0, 0) in global
// coordinates. With u1 non-null (a view of u's pitches, another buffer), the
// centre after sweep 0 goes there. With delta non-null, sweep 0's delta over
// the whole block is max-accumulated into it (zeroed by the caller). Launches
// on `stream` (PyTorch's current stream), does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
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
  const long long rows = (de > 2 && he > 2) ? static_cast<long long>(de - 2) * (he - 2) : 0;
  int blocks = 0;
  err = grid_blocks(reinterpret_cast<const void*>(shard3d_chunk_kernel), kThreadsShard, device,
                    (rows + kWarpsShard - 1) / kWarpsShard, &blocks, 0);
  if (err != cudaSuccess) return err;
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&g, &it_i, &t_off, &ns, &delta_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(shard3d_chunk_kernel),
                                    dim3(blocks), dim3(kThreadsShard), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
