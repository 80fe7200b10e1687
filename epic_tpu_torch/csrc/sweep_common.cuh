// Pieces shared by the red-black kernels (sweep2d.cu, sweep3d.cu,
// batched2d.cu, tile2d.cu, tile3d.cu): the 2D and 3D stencils, the
// block-wide delta reduction, the size of a cooperative grid, and the tile
// kernels' chunk spread and cooperative launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog4 = 1.38629436f;  // float32(log(4.0))
constexpr float kLog6 = 1.79175949f;  // float32(log(6.0))

// The 2D update in the pinned op order of epic_tpu_torch/solver/_sweep_body.py
// (harmonic_cpu.cpp:59-70): a max tree over ((N,S),(W,E)), a left-associated
// sum of expf, logf, minus float32(log 4). Used by the single-grid and the
// batched 2D kernels, so both give the plain version's bits.
__device__ __forceinline__ float lse4(float n, float s, float w, float e) {
  const float m = fmaxf(fmaxf(n, s), fmaxf(w, e));
  const float sum = ((expf(n - m) + expf(s - m)) + expf(w - m)) + expf(e - m);
  return (m + logf(sum)) - kLog4;
}

// The 3D update in the pinned op order of _sweep_body.lse6: neighbours
// (z-, z+, y-, y+, x-, x+), a left-to-right fmaxf chain, a left-associated
// sum of expf, logf, minus float32(log 6). Used by the in-place and the tile
// 3D kernels.
__device__ __forceinline__ float lse6(float zm, float zp, float ym, float yp, float xm,
                                      float xp) {
  float m = fmaxf(zm, zp);
  m = fmaxf(m, ym);
  m = fmaxf(m, yp);
  m = fmaxf(m, xm);
  m = fmaxf(m, xp);
  float s = expf(zm - m);
  s = s + expf(zp - m);
  s = s + expf(ym - m);
  s = s + expf(yp - m);
  s = s + expf(xm - m);
  s = s + expf(xp - m);
  return (m + logf(s)) - kLog6;
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

// The tile kernels (tile2d.cu, tile3d.cu).

// `total` sweeps spread over `n_chunks` chunks, earlier chunks one deeper:
// chunk c's share (solver/tiled.py spread).
__device__ __forceinline__ int spread_at(int total, int n_chunks, int c) {
  return total / n_chunks + (c < total % n_chunks ? 1 : 0);
}

// Allow a launch `bytes` of dynamic shared memory (above 48 KB this must
// precede both the occupancy query and the launch).
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A cooperative launch of `kernel` with `args`: a block of `threads` per
// tile, at most what the card holds at once with `smem` bytes of dynamic
// shared memory a block.
inline cudaError_t launch_cooperative(const void* kernel, int threads, int n_tiles, size_t smem,
                                      void** args, int device, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_blocks(kernel, threads, device, n_tiles, &blocks, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;  // the tile does not fit an SM
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
