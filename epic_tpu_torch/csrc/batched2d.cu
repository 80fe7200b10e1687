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
// Design. The TPU packs lanes into a collage of VMEM-sized blocks whose frozen
// seams stand in for halos, and returns one delta per block. None of that
// carries over. Here the batch is the contiguous [B, H, W] tensor, updated in
// place (a sweep of one parity class reads only the other class). Each lane's
// interior 1 <= y <= H-2, 1 <= x <= W-2 is taken by index, and the class is
// (y + x) % 2 != t % 2 in the lane's own coordinates, on one shared t. The
// work units are the B * (H-2) (lane, row) pairs, one warp to a unit: a 128-
// wide row holds 63 cells of a class, which one warp covers in two strides,
// where a 256-thread block on a row (sweep2d.cu) would leave three quarters of
// its threads idle. One persistent cooperative kernel strides its warps over
// the units; cooperative_groups::this_grid().sync() separates the sweeps. A
// lane that is inactive or retired is skipped: in place, skipping is the
// pass-through of _block_kernel_gated (pallas_batched.py:230-232).
//
// Delta. Per lane, never per block of lanes: each warp reduces its row's
// max |u1 - u0| with shuffles and issues one atomicMax on the float bits into
// its lane's slot. The values are >= 0, so the bits order like unsigned ints
// and max is exact in any order: the result is deterministic.
//
// Numerics. lse4 from sweep_common.cuh, no --use_fast_math: the kernels give
// the plain version's bits on the card.
//
// Memory. u and the retirement flags are read with __ldcg (L2, not L1): other
// blocks write them during the launch, and no stale L1 line may serve an old
// value across a grid barrier.
//
// Bound on this card. At 4096 lanes of 128^2 the batch holds 67M cells: 268 MB
// of u and 67 MB of locked, about 5x the 50 MB L2. A sweep then moves about
// 9 B a cell through HBM (the other class read in full, the updated half read
// and written, the lock mask), so the kernels are HBM bound, like sweep2d.cu at
// 4096^2: on an H100 80GB HBM3 at a 700 W power limit a full sweep took
// 0.316 ms, about 1.9 TB/s. Keeping K sweeps of many small lanes in shared
// memory (temporal blocking; a 128^2 lane is 64 KB) would cut those bytes
// K-fold, and is later work. So is a list of the active lanes: skipping a
// retired lane costs each warp a flag read per (lane, row) unit, and a sweep
// with one lane active still took 76 us on the same card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsB = 256;
constexpr int kWarpsB = kThreadsB / 32;

// Lane `lane` runs unless a gate is given and its flag is not `run`.
__device__ __forceinline__ bool lane_runs(const uint8_t* gate, uint8_t run, int lane) {
  return gate == nullptr || __ldcg(gate + lane) == run;
}

// One sweep of the class (y + x) % 2 != t % 2 over every running lane. Warps
// stride over the (lane, row) units; a warp's threads over the row's cells of
// the class, x = x0(y) + 2k, so neighbouring threads touch neighbouring pairs
// of floats. With kCheck, each row's max |u1 - u0| goes into acc[lane].
template <bool kCheck>
__device__ void sweep_batch(float* u, const uint8_t* locked, int B, int H, int W, int t,
                            const uint8_t* gate, uint8_t run, unsigned int* acc) {
  const int q = (t & 1) ^ 1;  // the class updated: (y + x) & 1 == q
  const int lane_id = threadIdx.x & 31;
  const long long rows = H - 2;
  const long long units = static_cast<long long>(B) * rows;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       r < units; r += n_warps) {
    const int L = static_cast<int>(r / rows);
    const int y = 1 + static_cast<int>(r - L * rows);
    if (!lane_runs(gate, run, L)) continue;  // warp-uniform
    const size_t row = (static_cast<size_t>(L) * H + y) * W;
    float local = 0.0f;
    for (int x = 1 + ((y + 1 + q) & 1) + 2 * lane_id; x <= W - 2; x += 64) {
      const size_t idx = row + x;
      if (locked[idx]) continue;
      const float v = lse4(__ldcg(u + idx - W), __ldcg(u + idx + W),
                           __ldcg(u + idx - 1), __ldcg(u + idx + 1));
      if (kCheck) local = fmaxf(local, fabsf(v - __ldcg(u + idx)));
      u[idx] = v;
    }
    if (kCheck) {
      for (int off = 16; off > 0; off >>= 1)
        local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
      if (lane_id == 0 && local > 0.0f) atomicMax(acc + L, __float_as_uint(local));
    }
  }
}

// K12: num_sweeps sweeps from iteration *it over the lanes whose active flag
// is 1 (all lanes when active is null); each lane's sweep-0 delta is
// max-accumulated into delta_bits[lane], which the caller zeroed.
__global__ void __launch_bounds__(kThreadsB)
batch_chunk_kernel(float* u, const uint8_t* locked, int B, int H, int W, const int* it,
                   int num_sweeps, const uint8_t* active, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = *it;
  sweep_batch<true>(u, locked, B, H, W, t0, active, 1, delta_bits);
  for (int k = 1; k < num_sweeps; ++k) {
    grid.sync();
    sweep_batch<false>(u, locked, B, H, W, t0 + k, active, 1, nullptr);
  }
}

// K13 and _solve_collage_device (pallas_batched.py:275-359): the lockstep
// protocol of epic_tpu/solver/batched.py:110-132 for every lane at once. Each
// cycle: a checked sweep of the active lanes into acc[slot]; a barrier; each
// lane's owner thread records its delta and iteration count, retires it when
// delta < eps[lane] and t + 1 >= m_max, clears the lane's other slot and
// counts the lanes still active into count[slot]; a barrier, after which
// every thread reads the same count and the same retired flags; exit if no
// lane is active, else stagger - 1 plain sweeps of the active lanes. Each of
// acc's two [B] halves and count's two slots is cleared one cycle before its
// next use, with at least one barrier between the clear and the next atomics
// (the plain sweeps' barriers, or the extra one when stagger == 1). The
// caller zeroes acc, count, retired and iters and sets deltas to eps + 1, the
// values a lane keeps if it never runs a check.
__global__ void __launch_bounds__(kThreadsB)
batch_solve_kernel(float* u, const uint8_t* locked, int B, int H, int W, const float* eps,
                   int m_max, int max_iterations, int stagger, unsigned int* acc, int* count,
                   uint8_t* retired, int* iters, float* deltas) {
  cg::grid_group grid = cg::this_grid();
  const long long me = grid.thread_rank();
  const long long n_threads = grid.size();
  int slot = 0;
  for (int t = 0; t < max_iterations; t += stagger) {
    unsigned int* acc_now = acc + static_cast<size_t>(slot) * B;
    unsigned int* acc_next = acc + static_cast<size_t>(slot ^ 1) * B;
    sweep_batch<true>(u, locked, B, H, W, t, retired, 0, acc_now);
    grid.sync();
    int still = 0;
    for (long long L = me; L < B; L += n_threads) {
      if (__ldcg(retired + L) == 0) {
        const float d = __uint_as_float(__ldcg(acc_now + L));
        const bool done = d < eps[L] && t + 1 >= m_max;
        deltas[L] = d;
        // A lane that stays active runs the cycle's stagger - 1 plain sweeps.
        iters[L] = done ? t + 1 : t + stagger;
        if (done) {
          retired[L] = 1;
        } else {
          ++still;
        }
      }
      acc_next[L] = 0u;
    }
    for (int off = 16; off > 0; off >>= 1) still += __shfl_xor_sync(0xffffffffu, still, off);
    if ((threadIdx.x & 31) == 0 && still > 0) atomicAdd(count + slot, still);
    grid.sync();
    if (__ldcg(count + slot) == 0) break;
    if (me == 0) count[slot ^ 1] = 0;
    for (int s = 1; s < stagger; ++s) {
      sweep_batch<false>(u, locked, B, H, W, t + s, retired, 0, nullptr);
      grid.sync();
    }
    if (stagger == 1) grid.sync();
    slot ^= 1;
  }
}

// Blocks for a cooperative launch: one warp to a (lane, row) unit, at most
// what the card holds at once.
cudaError_t batch_blocks(const void* kernel, int device, int B, int H, int* blocks) {
  const long long units = static_cast<long long>(B) * (H - 2);
  return grid_blocks(kernel, kThreadsB, device, (units + kWarpsB - 1) / kWarpsB, blocks,
                     0);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u is f32[B, H, W] and locked u8[B, H, W], contiguous.

int epic_batched2d_chunk(void* u, const void* locked, int B, int H, int W, const void* it,
                         int num_sweeps, const void* active, void* delta, void* stream,
                         int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = batch_blocks(reinterpret_cast<const void*>(batch_chunk_kernel), device, B, H, &blocks);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const int* it_i = static_cast<const int*>(it);
  const uint8_t* active_b = static_cast<const uint8_t*>(active);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&u_f, &locked_b, &B, &H, &W, &it_i, &num_sweeps, &active_b, &delta_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(batch_chunk_kernel),
                                    dim3(blocks), dim3(kThreadsB), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int epic_batched2d_solve(void* u, const void* locked, int B, int H, int W, const void* eps,
                         int m_max, int max_iterations, int stagger, void* acc, void* count,
                         void* retired, void* iters, void* deltas, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = batch_blocks(reinterpret_cast<const void*>(batch_solve_kernel), device, B, H, &blocks);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* count_i = static_cast<int*>(count);
  uint8_t* retired_b = static_cast<uint8_t*>(retired);
  int* iters_i = static_cast<int*>(iters);
  float* deltas_f = static_cast<float*>(deltas);
  void* args[] = {&u_f, &locked_b, &B, &H, &W, &eps_f, &m_max, &max_iterations, &stagger,
                  &acc_u, &count_i, &retired_b, &iters_i, &deltas_f};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(batch_solve_kernel),
                                    dim3(blocks), dim3(kThreadsB), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
