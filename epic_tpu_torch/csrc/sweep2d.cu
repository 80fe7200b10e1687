// Red-black log-space relaxation of a 2D grid on NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of epic_tpu/solver/pallas_sweep.py:
//   epic_sweep2d_chunk  <- _multisweep_kernel   (K sweeps, delta of sweep 0;
//                                                the anytime tick)
//   epic_sweep2d_solve  <- _solve_whole_kernel  (the whole stagger protocol,
//                                                exit decision included, in
//                                                one launch)
// The plain torch version of both is epic_tpu_torch/solver/core.py.
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

#include <cooperative_groups.h>
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

const char* epic_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
