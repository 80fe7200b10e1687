// Red-black log-space relaxation of a 3D volume on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of epic_tpu/solver/pallas_sweep3d.py:
//   epic_sweep3d_chunk  <- _multisweep3d_kernel (K sweeps, delta of sweep 0;
//                          the anytime tick, via sweep3d_chunk_flat)
//   epic_sweep3d_solve  <- _solve_padded's while_loop of _multisweep3d_kernel
//                          calls (the whole stagger protocol, exit decision
//                          included, in one launch)
// The plain torch version of both is epic_tpu_torch/solver/core.py.
//
// Design: that of sweep2d.cu, one dimension up. The TPU kernel flattens a
// padded volume to [D*Hp, Wp] so that all six neighbours are rank-2 rolls,
// and masks the wrap garbage with a frozen array; none of that carries over.
// One persistent cooperative kernel works in place on the unpadded D x H x W
// volume: a sweep of one parity class reads only the other class, so the
// in-place update is race-free, and the interior 1 <= z <= D-2,
// 1 <= y <= H-2, 1 <= x <= W-2 is taken by index. Blocks stride over the
// interior (z, y) rows and threads over a row's voxels of the active class,
// x = x0(z, y) + 2k; cooperative_groups::this_grid().sync() separates the
// sweeps. A block has 128 threads: a 256-wide row holds 127 voxels of a class.
//
// Parity. 3D updates (z + y + x) % 2 == t % 2, the other class than 2D
// (the reference's x1-even offset negation, harmonic_cpu.cpp:96-99; pinned
// by tests/goldens/fuzz3d_seed0.npz).
//
// Numerics. lse6 (sweep_common.cuh) keeps the pinned op order of
// epic_tpu_torch/solver/_sweep_body.py: neighbours (z-, z+, y-, y+, x-, x+),
// a left-to-right fmaxf chain, a left-associated sum of expf, logf, minus
// float32(log 6). Built without --use_fast_math, so the kernels and the plain
// version give the same bits.
//
// Delta and memory: as in sweep2d.cu (block max, one atomicMax on the bits;
// u read with __ldcg, never through the read-only or L1 path).
//
// Bound on this card. An update reads six neighbours, of which z+-1 lie a
// plane (H*W floats) away and are reused from L2 only while three planes stay
// resident. At 30x256x256 (7.9 MB of u) the volume lives in the 50 MB L2 and
// a sweep is bound by the grid barrier and L2 traffic; at 256^3 (67 MB) by
// HBM bandwidth, about one read and one write of u and a read of the mask
// a sweep.
//
// Volumes beyond 2M cells went to four more TPU kernels (K8-K11:
// pallas_biggrid3d, pallas_tiled3d, pallas_cycle's 3D cycles). Their port is
// tile3d.cu, a block that marches a column segment along z and runs K
// sweeps a trip to memory. Beyond the L2 this kernel's z neighbours come
// back from the L2 only while a few planes fit it: on planes of 1448^2 and
// more a sweep here costs 5.2-7.2 us a million voxels on an H100, against
// 4.3-5.4 on cubes and smaller planes (tile_probe.py --volumes, PERF.md).
// solver.update_volume and solve_volume send the wide-plane volumes past
// the L2 to tile3d.cu (hopper_tile3d.past_crossover) and keep every other
// volume here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads3d = 128;

// Interior (z, y) rows of a D x H x W volume; 0 when it has no interior.
__host__ __device__ __forceinline__ long long interior_rows(int D, int H, int W) {
  return (D > 2 && H > 2 && W > 2) ? static_cast<long long>(D - 2) * (H - 2) : 0;
}

// One sweep over the class (z + y + x) % 2 == t % 2 of the interior. With
// kCheck, returns this thread's max |u1 - u0|.
template <bool kCheck>
__device__ float sweep(float* u, const uint8_t* locked, int D, int H, int W, int t) {
  const int q = t & 1;  // the class updated: (z + y + x) & 1 == q
  const long long rows = interior_rows(D, H, W);
  const size_t plane = static_cast<size_t>(H) * W;
  float local = 0.0f;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int z = 1 + static_cast<int>(r / (H - 2));
    const int y = 1 + static_cast<int>(r % (H - 2));
    const size_t row = (static_cast<size_t>(z) * H + y) * W;
    for (int x = 1 + ((z + y + 1 + q) & 1) + 2 * threadIdx.x; x <= W - 2; x += 2 * blockDim.x) {
      const size_t idx = row + x;
      if (locked[idx]) continue;
      const float v = lse6(__ldcg(u + idx - plane), __ldcg(u + idx + plane),
                           __ldcg(u + idx - W), __ldcg(u + idx + W),
                           __ldcg(u + idx - 1), __ldcg(u + idx + 1));
      if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(u + idx)));
      u[idx] = v;
    }
  }
  return local;
}

// K7 as a tick: num_sweeps sweeps starting at iteration *it; the delta of
// sweep 0 is max-accumulated into delta_bits, which the caller zeroed.
__global__ void __launch_bounds__(kThreads3d)
chunk3d_kernel(float* u, const uint8_t* locked, int D, int H, int W, const int* it,
               int num_sweeps, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = *it;
  block_max_atomic<kThreads3d>(sweep<true>(u, locked, D, H, W, t0), delta_bits);
  for (int k = 1; k < num_sweeps; ++k) {
    grid.sync();
    sweep<false>(u, locked, D, H, W, t0 + k);
  }
}

// The stagger protocol of pallas_sweep3d._solve_padded and solver/core.py,
// as sweep2d.cu's solve_kernel runs it: each cycle a checked sweep, a
// barrier, then every thread reads the same delta and decides; on exit the
// volume already is u1. acc holds two zeroed slots that the checks alternate
// between, each cleared a barrier before its next use.
__global__ void __launch_bounds__(kThreads3d)
solve3d_kernel(float* u, const uint8_t* locked, int D, int H, int W, const float* eps_ptr,
               int m_max, int max_iterations, int stagger, unsigned int* acc,
               int* it_out, float* delta_out, int* done_out) {
  cg::grid_group grid = cg::this_grid();
  const float eps = *eps_ptr;
  int it = 0;
  float delta = eps + 1.0f;
  bool done = false;
  int slot = 0;
  while (!done && it < max_iterations) {
    block_max_atomic<kThreads3d>(sweep<true>(u, locked, D, H, W, it), acc + slot);
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
      sweep<false>(u, locked, D, H, W, it + s);
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

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). epic_cuda_error_string is in sweep2d.cu.

int epic_sweep3d_chunk(void* u, const void* locked, int D, int H, int W, const void* it,
                       int num_sweeps, void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_blocks(reinterpret_cast<const void*>(chunk3d_kernel), kThreads3d, device,
                    interior_rows(D, H, W), &blocks, 0);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&u_f, &locked_b, &D, &H, &W, &it_i, &num_sweeps, &delta_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chunk3d_kernel), dim3(blocks),
                                    dim3(kThreads3d), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int epic_sweep3d_solve(void* u, const void* locked, int D, int H, int W, const void* eps,
                       int m_max, int max_iterations, int stagger, void* acc,
                       void* it_out, void* delta_out, void* done_out, void* stream,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_blocks(reinterpret_cast<const void*>(solve3d_kernel), kThreads3d, device,
                    interior_rows(D, H, W), &blocks, 0);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* it_i = static_cast<int*>(it_out);
  float* delta_f = static_cast<float*>(delta_out);
  int* done_i = static_cast<int*>(done_out);
  void* args[] = {&u_f, &locked_b, &D, &H, &W, &eps_f, &m_max, &max_iterations, &stagger,
                  &acc_u, &it_i, &delta_f, &done_i};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(solve3d_kernel), dim3(blocks),
                                    dim3(kThreads3d), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
