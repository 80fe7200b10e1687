// Pieces shared by the red-black kernels (sweep2d.cu, sweep3d.cu,
// batched2d.cu): the 2D stencil, the block-wide delta reduction and the size
// of a cooperative grid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog4 = 1.38629436f;  // float32(log(4.0))

// The 2D update in the pinned op order of epic_tpu_torch/solver/_sweep_body.py
// (harmonic_cpu.cpp:59-70): a max tree over ((N,S),(W,E)), a left-associated
// sum of expf, logf, minus float32(log 4). Used by the single-grid and the
// batched 2D kernels, so both give the plain version's bits.
__device__ __forceinline__ float lse4(float n, float s, float w, float e) {
  const float m = fmaxf(fmaxf(n, s), fmaxf(w, e));
  const float sum = ((expf(n - m) + expf(s - m)) + expf(w - m)) + expf(e - m);
  return (m + logf(sum)) - kLog4;
}

// Block-wide max of v, then one atomicMax on the float bits at acc. The
// value is |u1 - u0| >= 0, so its bits order like unsigned ints, and max is
// exact in any order: the result is deterministic.
template <int kBlock>
__device__ void block_max_atomic(float v, unsigned int* acc) {
  __shared__ float warp_max[kBlock / 32];
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) atomicMax(acc, __float_as_uint(v));
  }
}

// Blocks for a cooperative launch: one per unit of work (`rows`, at least
// one), at most what the card holds at once (a larger cooperative grid is
// refused at launch). `smem_bytes` is the launch's dynamic shared memory,
// which bounds how many blocks share an SM.
inline cudaError_t grid_blocks(const void* kernel, int threads, int device, long long rows,
                               int* blocks, size_t smem_bytes) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long want = rows > 0 ? rows : 1;
  *blocks = static_cast<int>(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace
