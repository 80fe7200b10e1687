// Red-black log-space relaxation of a 3D volume on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of epic_tpu/solver/pallas_sweep3d.py:
//   epic_sweep3d_chunk  <- _multisweep3d_kernel (:88; K sweeps, delta of
//                          sweep 0; the anytime tick, via sweep3d_chunk_flat)
//   epic_sweep3d_solve  <- _solve_padded's while_loop of _multisweep3d_kernel
//                          calls (:261; the whole stagger protocol, exit
//                          decision included, in one launch)
// The plain torch version of both is epic_tpu_torch/solver/core.py; the
// walk below is modelled in solver/hopper_sweep3d.py (plan, walk_cells).
//
// Bound on this card. One sweep of an in-place pass reads u and locked and
// writes u: 9 B a voxel through HBM (8.1 B with the locked bytes packed to
// bits), 0.045 ms a 256^3 sweep at 3.35 TB/s. An accurate lse6 is 91 SASS
// instructions, so the issue bound of a sweep is (voxels / 2) x 91 over 132
// SMs x 128 lanes: 0.020 ms at 256^3, 2.2 us at 30 x 256 x 256, whose u and
// locked (9.8 MB) stay in the 50 MB L2. The per-row design this replaced (a
// 128-thread block a (z, y) row, one class voxel a thread, seven 4-byte
// loads an update that bypass L1, a 64-bit division a row, a grid barrier
// a sweep with up to 2,112 blocks arriving) took 13.3 us a sweep inside the
// L2 and 72.5 us at 256^3, and lost to tile3d.cu on wide planes, where its
// z neighbours stopped coming back from the L2.
//
// Design: in place, one sweep a pass, a persistent cooperative kernel with
// cooperative_groups::this_grid().sync() between sweeps. A sweep of class
// (z + y + x) % 2 == t % 2 reads only the other class and writes only its
// own, so its updates are independent and can run in any order.
// - A lane owns a quad: 8 consecutive voxels x0 .. x0 + 7 of a row (x0 a
//   multiple of 8), 4 of each class, and walks a segment of planes along z.
//   Rows z - 1, z and z + 1 of its quad stay in registers, so each plane of
//   u is loaded once a segment (two 16-byte loads), not three times; the
//   y - 1 and y + 1 rows are 16-byte loads of the neighbouring lanes' rows,
//   mostly L1 hits; the x neighbour past the quad is one 4-byte load. The
//   four lse6 chains run together, and a half quad whose voxels are all
//   inside x = 1 .. W - 2 is stored with one 16-byte store (a voxel of the
//   other class, or a locked one, is written back unchanged: no lane writes
//   it in this sweep); a half at a row end stores only its updated voxels,
//   so the shell is never written. The class's offset in the quad flips
//   with each plane: the walk is unrolled by two planes, each with its
//   offset a constant.
// - Frozen bits: the quad's 8 locked bytes are two 4-byte loads a plane,
//   packed to 8 bits and or-ed with the lane's shell bits (x = 0, x >= W - 1),
//   set once a unit.
// - Units: (segment, row patch) pairs. A patch is rb rows of pw quads
//   (rb = kThreads3d / pw), a lane's row and quad computed once a launch
//   (Lanes); segments cut the interior planes into the length that
//   finishes soonest on the card's blocks (make_plan; the same rule in
//   hopper_sweep3d.plan). A block walks units blockIdx.x + k gridDim.x,
//   their digits advanced by carries: no division a row or a unit.
// - Fewer, larger blocks at the barrier: kThreads3d lanes, kMinBlocks3d
//   blocks an SM, at most 132 arrivals on an H100 (the per-row design: up
//   to 2,112), with the registers of one block an SM (no spills). Patches
//   are 32, 16 or 8 quads wide, so a warp never spans rows of both class
//   offsets (a warp that does runs both walks one after the other).
// - The next plane's row is loaded a step ahead.
// - Alignment: a row starts on a 16-byte boundary only when W % 4 == 0. Then
//   u and locked are read as above (the wrapper checks that u is 16-byte and
//   locked 4-byte aligned, and raises otherwise); for any other W the same
//   walk reads and writes voxel by voxel. Offsets are signed 64-bit, and no
//   pointer is formed outside the volume: x0 - 1 is read only when the
//   quad's first voxel is updated (so x0 >= 1), x0 + 8 only when its last
//   is, and half a quad past the row's end is not read.
// - L1: u is read through L1 (plain ld.global), not __ldcg. Within a sweep
//   every value a lane reads from another lane's voxels is of the class the
//   sweep leaves alone, so no line goes stale between barriers; the grid
//   barrier invalidates L1 (CCTL.IVALL in this kernel's SASS, counted by
//   tile_probe.py --sweep3d, which also builds the __ldcg form).
//
// Parity. 3D updates (z + y + x) % 2 == t % 2, the other class than 2D
// (the reference's x1-even offset negation, harmonic_cpu.cpp:96-99; pinned
// by tests/goldens/fuzz3d_seed0.npz).
//
// Numerics. lse6 (sweep_common.cuh) keeps the pinned op order of
// epic_tpu_torch/solver/_sweep_body.py: neighbours (z-, z+, y-, y+, x-, x+),
// a left-to-right fmaxf chain, a left-associated sum of expf, logf, minus
// float32(log 6). Built without --use_fast_math, so the kernels and the plain
// version give the same bits. The delta of a checked sweep is the max of
// |v - u0| over the updated voxels, reduced with block_max_atomic
// (deterministic: max is exact in any order).
//
// Measured (tile_probe.py --sweep3d and --volumes, H100 80GB HBM3, 700 W,
// PERF.md): 9.5 us a sweep at 30 x 256 x 256, 1.7 of them the grid barrier
// alone (the per-row design's: 4.4); 66 us at 256^3, 2.4 TB/s of the 9.5 B
// a voxel a sweep it moves with its segment halos. Reading u through L2
// only (__ldcg) is 1.5-1.8x slower, the locked bytes cost 6-10% (the most
// that packing them to bits could gain), the prefetch gains 2-8% past the
// L2, and two blocks an SM or 1024 lanes (64 registers, spilling) lose
// 18-27% within the L2 and 14-43% past it.
//
// Volumes beyond 2M cells went to four more TPU kernels (K8-K11). Their port
// is tile3d.cu, a block that marches a column segment along z and runs K
// sweeps a trip to memory. This kernel measured as fast or faster on every
// volume tried, from 30 x 256^2 to 768^3, 2048 x 384^2 and 8 x 4096^2
// (640^3 a tie within 1%), so solver.update_volume and solve_volume send
// every volume here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads3d = 512;    // lanes a block
constexpr int kMinBlocks3d = 1;    // blocks an SM, which the registers are held to
constexpr int kMaxBand = 32;       // quads across a patch, at most
constexpr int kMinBand = 8;        // and at least, unless the row has fewer

// A launch's plan, the same on the host and the device (hopper_sweep3d.plan
// mirrors make_plan).
struct Plan {
  int segments, tz;   // the interior planes 1 .. D - 2 in segments of tz (the last ragged)
  int pw, rb;         // a patch: rb rows of pw quads
  int nb, nrb;        // patches across a row's quads and down the interior rows
  long long units;    // segments x nrb x nb
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The relative cost of a lane in a patch pw quads wide, in hundredths:
// narrower patches split a warp over more rows (tile_probe.py --sweep3d's
// band copies: 16 quads 0.6-3.6% and 8 quads 7.6-12.4% slower than 32 on
// 256^3, 512^3 and 32 x 2048^2).
inline int band_cost(int pw) { return pw >= 32 ? 100 : pw >= 16 ? 103 : 110; }

// The plan of a D x H x W volume on `slots` blocks: patches as above, and
// the segment count whose rounds x (tz + 2) steps (a lane loads tz + 2
// planes) is least, the fewest segments on a tie. No interior: no units.
inline Plan make_plan(int D, int H, int W, int slots) {
  Plan p{0, 0, 1, 1, 1, 1, 0};
  if (D < 3 || H < 3 || W < 3) return p;
  const int n = D - 2;
  const int qw = cdiv(W, 8);
  p.pw = 1;
  while (p.pw < qw && p.pw < kMinBand) p.pw *= 2;
  if (qw >= kMinBand) {
    p.pw = kMaxBand;
    for (int c = kMaxBand / 2; c >= kMinBand; c /= 2)
      if (cdiv(qw, c) * c * band_cost(c) < cdiv(qw, p.pw) * p.pw * band_cost(p.pw)) p.pw = c;
  }
  p.nb = cdiv(qw, p.pw);
  p.rb = kThreads3d / p.pw;
  p.nrb = cdiv(H - 2, p.rb);
  const long long patches = static_cast<long long>(p.nb) * p.nrb;
  const long long s = slots > 0 ? slots : 1;
  long long best = -1;
  for (int want = 1; want <= n; ++want) {
    const int tz = cdiv(n, want);
    const int segments = cdiv(n, tz);
    const long long cost = (segments * patches + s - 1) / s * (tz + 2);
    if (best < 0 || cost < best) {
      best = cost;
      p.segments = segments;
      p.tz = tz;
    }
  }
  p.units = p.segments * patches;
  return p;
}

// The digits (cb, rb, seg) of a unit, cb fastest: a block's units are
// blockIdx.x + k gridDim.x, advanced by the digits of gridDim.x with carries.
struct Digits {
  int cb, rb, seg;
  __device__ Digits(long long v, const Plan& p) {
    cb = static_cast<int>(v % p.nb);
    v /= p.nb;
    rb = static_cast<int>(v % p.nrb);
    seg = static_cast<int>(v / p.nrb);
  }
  __device__ __forceinline__ void add(const Digits& d, const Plan& p) {
    cb += d.cb;
    int c = cb >= p.nb;
    cb -= c ? p.nb : 0;
    rb += d.rb + c;
    c = rb >= p.nrb;
    rb -= c ? p.nrb : 0;
    seg += d.seg + c;
  }
};

// What a thread keeps for the launch: the volume, the plan, its lane's
// place in a patch, and its block's first unit and stride. Lane tid has
// row slot s = tid / pw and quad j = tid % pw; the slots hold the patch's
// even rows first, then its odd rows, so a warp's rows share their class
// offset (a warp that spans two rows of opposite parity would run both
// walks one after the other) but for the one warp at the switch.
struct Lanes {
  int D, H, W;
  Plan p;
  int s, j;          // the lane's row slot and quad in a patch
  int r;             // its row in the patch
  bool lane_ok;      // s < rb (a patch may leave the block's last lanes idle)
  Digits first, step;
  __device__ Lanes(int D_, int H_, int W_, const Plan& p_)
      : D(D_), H(H_), W(W_), p(p_), s(static_cast<int>(threadIdx.x) / p_.pw),
        j(static_cast<int>(threadIdx.x) - s * p_.pw),
        r(s < (p_.rb + 1) / 2 ? 2 * s : 2 * (s - (p_.rb + 1) / 2) + 1), lane_ok(s < p_.rb),
        first(blockIdx.x, p_), step(gridDim.x, p_) {}
};

// u through L1 (safe: see the head note).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }

// The quad's voxels at offset `at` of u (lim of them in the row): two
// 16-byte loads (kVec), or voxel by voxel. Voxels past the row are 0.
template <bool kVec>
__device__ __forceinline__ void load8(const float* u, long long at, int lim, float (&r)[8]) {
  if (kVec) {
    const float4 a = ld4(u + at);
    const float4 b = lim > 4 ? ld4(u + at + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = k < lim ? ld1(u + at + k) : 0.f;
  }
}

// Bit k set where the quad's locked byte k is not 0 (voxels past the row: 0).
__device__ __forceinline__ unsigned pack4(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

template <bool kVec>
__device__ __forceinline__ unsigned locked_bits(const uint8_t* locked, long long at, int lim) {
  if (kVec) {
    const unsigned lo = __ldg(reinterpret_cast<const unsigned*>(locked + at));
    const unsigned hi = lim > 4 ? __ldg(reinterpret_cast<const unsigned*>(locked + at + 4)) : 0u;
    return pack4(lo) | (pack4(hi) << 4);
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < lim && locked[at + k]) bits |= 1u << k;
  return bits;
}

// The quad of one unit: its offsets and bits, fixed for the segment.
struct Quad {
  long long at;        // offset of voxel (z, y, x0), advanced a plane a step
  long long plane;     // H * W
  int W, lim;          // the row's width; the quad's voxels in the row (1..8)
  unsigned shell;      // bit k: x0 + k is the shell (0, W - 1) or past the row
  unsigned whole;      // bit h: half h lies inside x = 1 .. W - 2 (one 16-byte store)
};

// One plane z of the walk: the class voxels at offsets O, O + 2, O + 4, O + 6
// of row B, with A = row z - 1 and C = row z + 1, updated in B and stored;
// then A <- B, B <- C. C came a step ago and row z + 2 is loaded into N
// here, before this step's stores, when there is a next step (`more`): a
// lane writes only its own voxels, and their values are the ones it loads,
// so the early load reads what a later one would.
template <bool kVec, bool kCheck, int O>
__device__ __forceinline__ void step(float* u, const uint8_t* locked, Quad& q, bool more,
                                     float (&A)[8], float (&B)[8], float (&C)[8], float (&N)[8],
                                     float& local) {
  float ym[8], yp[8];
  if (more) load8<kVec>(u, q.at + 2 * q.plane, q.lim, N);   // the next step's row z + 2
  load8<kVec>(u, q.at - q.W, q.lim, ym);
  load8<kVec>(u, q.at + q.W, q.lim, yp);
  const unsigned upd = ~(locked_bits<kVec>(locked, q.at, q.lim) | q.shell) & (O ? 0xAAu : 0x55u);
  // The x neighbour past the quad, read only where the voxel next to it is
  // updated (then it lies in the row).
  float xe = 0.f;
  if (O == 0 ? (upd & 1u) : (upd & 0x80u)) xe = ld1(u + q.at + (O == 0 ? -1 : 8));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = O + 2 * i;
    const float v = lse6(A[k], C[k], ym[k], yp[k], k == 0 ? xe : B[k - 1], k == 7 ? xe : B[k + 1]);
    if ((upd >> k) & 1u) {
      if (kCheck) local = fmaxf(local, fabsf(v - B[k]));
      B[k] = v;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!((upd >> (4 * h)) & 0xFu)) continue;
    if (kVec && ((q.whole >> h) & 1u)) {
      *reinterpret_cast<float4*>(u + q.at + 4 * h) =
          make_float4(B[4 * h], B[4 * h + 1], B[4 * h + 2], B[4 * h + 3]);
    } else {
#pragma unroll
      for (int k = 4 * h; k < 4 * h + 4; ++k)
        if ((upd >> k) & 1u) u[q.at + k] = B[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    A[k] = B[k];
    B[k] = C[k];
    C[k] = N[k];
  }
  q.at += q.plane;
}

// A lane's segment, planes z0 .. z1 - 1, the first with class offset O;
// with kCheck, returns the max |u1 - u0| of its updates.
template <bool kVec, bool kCheck, int O>
__device__ __noinline__ float walk(float* u, const uint8_t* locked, Quad q, int z0, int z1) {
  float local = 0.0f;
  float A[8], B[8], C[8], N[8] = {};
  load8<kVec>(u, q.at - q.plane, q.lim, A);
  load8<kVec>(u, q.at, q.lim, B);
  load8<kVec>(u, q.at + q.plane, q.lim, C);
  for (int z = z0; z < z1; z += 2) {
    step<kVec, kCheck, O>(u, locked, q, z + 1 < z1, A, B, C, N, local);
    if (z + 1 == z1) break;
    step<kVec, kCheck, 1 - O>(u, locked, q, z + 2 < z1, A, B, C, N, local);
  }
  return local;
}

// One sweep over the class (z + y + x) % 2 == t % 2 of the interior: every
// unit of this block. With kCheck, returns this thread's max |u1 - u0|.
template <bool kCheck>
__device__ float sweep(float* u, const uint8_t* locked, const Lanes& g, int t) {
  float local = 0.0f;
  const Plan& p = g.p;
  Digits d = g.first;
  for (long long unit = blockIdx.x; unit < p.units; unit += gridDim.x, d.add(g.step, p)) {
    const int y = 1 + d.rb * p.rb + g.r;
    const int jq = d.cb * p.pw + g.j;
    const int x0 = 8 * jq;
    if (!g.lane_ok || y > g.H - 2 || x0 >= g.W) continue;
    const int z0 = 1 + d.seg * p.tz;
    const int z1 = min(z0 + p.tz, g.D - 1);
    Quad q;
    q.plane = static_cast<long long>(g.H) * g.W;
    q.at = (static_cast<long long>(z0) * g.H + y) * g.W + x0;
    q.W = g.W;
    q.lim = min(8, g.W - x0);
    q.shell = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (x0 + k == 0 || x0 + k >= g.W - 1) q.shell |= 1u << k;
    q.whole = (x0 >= 1 && x0 + 3 <= g.W - 2 ? 1u : 0u) | (x0 + 7 <= g.W - 2 ? 2u : 0u);
    const bool vec = (g.W & 3) == 0;
    float m;
    if ((t + z0 + y) & 1)
      m = vec ? walk<true, kCheck, 1>(u, locked, q, z0, z1)
              : walk<false, kCheck, 1>(u, locked, q, z0, z1);
    else
      m = vec ? walk<true, kCheck, 0>(u, locked, q, z0, z1)
              : walk<false, kCheck, 0>(u, locked, q, z0, z1);
    local = fmaxf(local, m);
  }
  return local;
}

// K7 as a tick: num_sweeps sweeps starting at iteration *it; the delta of
// sweep 0 is max-accumulated into delta_bits, which the caller zeroed.
__global__ void __launch_bounds__(kThreads3d, kMinBlocks3d)
chunk3d_kernel(float* u, const uint8_t* locked, int D, int H, int W, Plan plan, const int* it,
               int num_sweeps, unsigned int* delta_bits) {
  cg::grid_group grid = cg::this_grid();
  const Lanes g(D, H, W, plan);
  const int t0 = *it;
  block_max_atomic<kThreads3d>(sweep<true>(u, locked, g, t0), delta_bits);
  for (int k = 1; k < num_sweeps; ++k) {
    grid.sync();
    sweep<false>(u, locked, g, t0 + k);
  }
}

// The stagger protocol of pallas_sweep3d._solve_padded and solver/core.py,
// as sweep2d.cu's solve_kernel runs it: each cycle a checked sweep, a
// barrier, then every thread reads the same delta and decides; on exit the
// volume already is u1. acc holds two zeroed slots that the checks alternate
// between, each cleared a barrier before its next use.
__global__ void __launch_bounds__(kThreads3d, kMinBlocks3d)
solve3d_kernel(float* u, const uint8_t* locked, int D, int H, int W, Plan plan,
               const float* eps_ptr, int m_max, int max_iterations, int stagger,
               unsigned int* acc, int* it_out, float* delta_out, int* done_out) {
  cg::grid_group grid = cg::this_grid();
  const Lanes g(D, H, W, plan);
  const float eps = *eps_ptr;
  int it = 0;
  float delta = eps + 1.0f;
  bool done = false;
  int slot = 0;
  while (!done && it < max_iterations) {
    block_max_atomic<kThreads3d>(sweep<true>(u, locked, g, it), acc + slot);
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
      sweep<false>(u, locked, g, it + s);
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

// The blocks the card holds at once of `kernel` (the plan's slots).
cudaError_t slots_of(const void* kernel, int device, int* slots) {
  return grid_blocks(kernel, kThreads3d, device, 1LL << 40, slots, 0);
}

// The plan on this card and the launch's blocks: one a unit, at most the slots.
cudaError_t plan_launch(const void* kernel, int D, int H, int W, int device, Plan* plan,
                        int* blocks) {
  int slots = 0;
  const cudaError_t err = slots_of(kernel, device, &slots);
  if (err != cudaSuccess) return err;
  *plan = make_plan(D, H, W, slots);
  *blocks = static_cast<int>(plan->units < slots ? (plan->units > 0 ? plan->units : 1) : slots);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). epic_cuda_error_string is in sweep2d.cu. u must be
// 16-byte and locked 4-byte aligned (hopper_sweep3d.check_aligned).

int epic_sweep3d_chunk(void* u, const void* locked, int D, int H, int W, const void* it,
                       int num_sweeps, void* delta, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(chunk3d_kernel);
  Plan plan;
  int blocks = 0;
  err = plan_launch(kernel, D, H, W, device, &plan, &blocks);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* delta_bits = static_cast<unsigned int*>(delta);
  void* args[] = {&u_f, &locked_b, &D, &H, &W, &plan, &it_i, &num_sweeps, &delta_bits};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads3d), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int epic_sweep3d_solve(void* u, const void* locked, int D, int H, int W, const void* eps,
                       int m_max, int max_iterations, int stagger, void* acc,
                       void* it_out, void* delta_out, void* done_out, void* stream,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(solve3d_kernel);
  Plan plan;
  int blocks = 0;
  err = plan_launch(kernel, D, H, W, device, &plan, &blocks);
  if (err != cudaSuccess) return err;
  float* u_f = static_cast<float*>(u);
  const uint8_t* locked_b = static_cast<const uint8_t*>(locked);
  const float* eps_f = static_cast<const float*>(eps);
  unsigned int* acc_u = static_cast<unsigned int*>(acc);
  int* it_i = static_cast<int*>(it_out);
  float* delta_f = static_cast<float*>(delta_out);
  int* done_i = static_cast<int*>(done_out);
  void* args[] = {&u_f, &locked_b, &D, &H, &W, &plan, &eps_f, &m_max, &max_iterations,
                  &stagger, &acc_u, &it_i, &delta_f, &done_i};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads3d), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan of a D x H x W volume on `slots` blocks, as seven ints into out:
// segments, tz, pw, rb, nb, nrb, units (hopper_sweep3d.plan's fields).
int epic_sweep3d_plan(int D, int H, int W, int slots, void* out) {
  const Plan p = make_plan(D, H, W, slots);
  int* o = static_cast<int*>(out);
  o[0] = p.segments, o[1] = p.tz, o[2] = p.pw, o[3] = p.rb, o[4] = p.nb, o[5] = p.nrb;
  o[6] = static_cast<int>(p.units);
  return 0;
}

// The slots of the chunk and the solve kernel on `device` into out[0], out[1].
int epic_sweep3d_slots(int device, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  err = slots_of(reinterpret_cast<const void*>(chunk3d_kernel), device, o);
  if (err != cudaSuccess) return err;
  return slots_of(reinterpret_cast<const void*>(solve3d_kernel), device, o + 1);
}

}  // extern "C"
