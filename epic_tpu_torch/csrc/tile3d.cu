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
// The plain torch version is epic_tpu_torch/solver/tiled3d.py; every tile
// shape gives its bits.
//
// Bound on this card. K7 (sweep3d.cu) moves about 9 B a voxel a sweep
// through HBM beyond the L2 (u read and written, locked read), 0.0725 ms a
// 256^3 sweep on an H100. An accurate lse6 update is 91 SASS instructions
// (six expf, a logf), so beyond the L2 a pass that keeps K sweeps on chip is
// bound by instruction issue, not bytes: 2.0 ms for 100 sweeps of 256^3 at
// the issue bound, 0.28 ms of HBM at 3.4 B a voxel a sweep. What a design
// pays on top is recomputed halo and the instructions around each update:
// a tile with a halo on all six faces, (TD+2K)(TH+2K)(TW+2K) voxels loaded a
// chunk, loads 2.6x its centre and sweeps 1.48x at 8 x 16 x 64, K = 3, and
// ran 1.3x-1.9x slower than K7 (PERF.md). Marching along z drops the z halo.
//
// Design: a block that marches along z. A block owns a column segment, a
// TZ x kTH x kTW centre (TZ a run-time argument, the rule's in
// solver/hopper_tile3d.py tile_for; the last segment and columns ragged). Its
// halo is K deep in y and x; in z it has ns planes at a segment's two ends
// only, and none at the volume's ends, whose shell planes are frozen. The
// block streams the extended column's planes in z order through a ring of
// K + 3 planes in dynamic shared memory: at step p plane p has arrived, and
// each thread runs levels l = 1..ns in ascending order, level l on plane
// p - l, on its own fixed (y, x) pairs. Level l is sweep t0 + l - 1: it
// updates a voxel of class (z + y + x) % 2 == (t0 + l - 1) % 2 in global
// coordinates (3D updates the other class than 2D), not frozen, inside the
// xy trapezoid (its distance from the extended plane's edge at least
// l + K - ns) and the z range (at least l planes inside a loaded end that
// is not the volume's). In place, in one buffer a plane: a voxel's z
// neighbours are of the other class, which level l leaves alone, so plane
// p - l - 1 still holds their level l - 1 values, and plane p - l + 1 got
// them from this thread's level l - 1 a moment before. That is the whole
// dependency between levels within a step, so one __syncthreads a step
// suffices; descending levels would give other bits
// (tests/test_torch_tiled3d.py models both). At step p the levels read
// planes p - ns - 1 .. p, ns + 2 slots, and plane p + 1 is in flight: K + 3
// slots cover every depth.
//
// Within a step every level of a pair of adjacent x (one of each class)
// updates the same voxel of it: the class of (p - l, y, x) at sweep
// t0 + l - 1 depends on p + y + x only, so the pair's updated voxel has
// x = 2j + o with o set by the row's parity and p. The plane is stored
// split by x parity, each parity in its own array of EH rows of whole quads
// (4 pairs) with a guard row above and below (so every neighbour index
// lies in the ring). A lane owns a quad, 4 consecutive pairs of a row:
// every level reads its quad's voxels and their y, z and x neighbours with
// one 16-byte load each (and one 4-byte load for the x neighbour past the
// quad), runs the four lse6 chains together, and stores the four results
// with one 16-byte store (a voxel the level leaves alone is written back
// unchanged; no other lane writes it in that step). Each level's results
// stay in registers as the next level's z+ neighbours (plane p - l + 1 at
// the same x). A lane keeps the frozen bits of its pairs (locked, the
// volume's shell, or outside the volume) for the last planes, two bits a
// plane, shifted in as each plane arrives.
//
// Lanes and levels. The quads of a plane are ordered by their rows'
// distance from the plane's y edges, farthest first, a lane a quad, so a
// block has a warp for every 32 quads (384 lanes at K = 4). A level's
// trapezoid covers a prefix of the order, so a warp past it skips the level
// whole. No store of a level is read by another lane in the same step:
// every voxel a level writes is of the class its neighbours' updates do not
// read. The kernels are instantiated for each K in 1..kMaxK, so every
// extent and offset of the ring is a constant; a K beyond kMaxK would not
// fit an H100's shared memory with this column.
//
// Loads. Each lane copies its quad's voxels of plane p + 1 that lie in the
// volume into their ring slot with cp.async (4 B a voxel) and loads their
// locked bytes into registers, while step p computes; each thread waits for
// its copies, and the step's barrier publishes them. Voxels outside the
// volume are not loaded: they are frozen and never the neighbour of an
// updated voxel (an updated voxel is interior, so all six of its neighbours
// lie in the volume), so what their slots hold is never read into a
// result. Each voxel of the extended column is loaded once a chunk.
// cp.async caches in L1, and the previous chunk's blocks wrote the source
// during the same launch: the grid barrier between chunks invalidates L1
// (CCTL.IVALL in its SASS), so no stale line is read.
//
// Outputs. Level 1 on centre voxels inside the volume gives sweep 0's delta;
// when asked, the plane after level 1 goes to u1 (both voxels of a pair: the
// other one is still at level 0); level ns writes the centre plane to dst,
// never to src, whose halo the neighbouring blocks read: chunks ping-pong
// between two buffers, and grid-wide barriers
// (cooperative_groups::this_grid().sync()) separate the chunks of a cycle or
// a solve. Fill voxels are never written and never enter the delta (ROADMAP
// R7). The delta is reduced with block_max_atomic (sweep_common.cuh):
// deterministic, since max is exact in any order.
//
// Numerics. lse6 from sweep_common.cuh, no --use_fast_math: the kernels give
// the plain version's (and solver/core.py's) bits.
//
// Measured (tile_probe.py --volumes, --shapes and --ablate3d, H100 80GB
// HBM3, 700 W, PERF.md): beyond the L2 a sweep takes 3.8-5.2 us a million
// voxels, 3.8-4.0 where the columns are whole and fill the card, at K = 4
// on this 32 x 128 column, one block an SM (the fastest of the columns and
// register budgets --shapes tried; with a lane a pair instead of a quad,
// 4.1-4.9). K7's per-row design took 4.2-5.4 on cubes and smaller planes
// and 5.2-7.2 on planes of 1448^2 and more, where its z neighbours no
// longer came back from the L2, and the router sent the volumes with
// planes of 1024^2 and more here; K7's z walk (sweep3d.cu) keeps them in
// registers and measured as fast or faster on every volume, so no volume
// is routed here (solver.update_volume). With each lse6 replaced by a max
// the pass keeps 55-57% of its time, and without the step barrier it
// loses 10%: the time goes to the instructions around each update (the
// level's predicates and set-up, the per-step copies and frozen bits), to
// the voxels a level visits outside its trapezoid and to the wait at each
// step's barrier, not to bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The column a block owns (kTH x kTW): solver/hopper_tile3d.py's COLUMN
// holds the same column, and tile_probe.py --shapes builds copies of this
// file with other values.
constexpr int kTH = 32;
constexpr int kTW = 128;
// The deepest halo (and chunk) the kernels take: the entries dispatch to one
// instantiation a depth, 1..kMaxK.
constexpr int kMaxK = 5;
// The blocks an SM holds at once, which the registers are held to (the
// tile rule of solver/hopper_tile3d.py counts one an SM).
constexpr int kMinBlocks = 1;

static_assert(kTH % 2 == 0 && kTW % 2 == 0, "the extended plane is whole pairs and row pairs");

// The extended plane at halo depth K and its ring, all compile-time.
template <int K>
struct Ext {
  static constexpr int EH = kTH + 2 * K;   // rows
  static constexpr int EW = kTW + 2 * K;   // voxels a row
  static constexpr int P = EW / 2;         // pairs a row
  static constexpr int P4 = (P + 3) / 4 * 4;   // a row's pitch: whole quads of pairs
  static constexpr int QR = P4 / 4;        // quads a row
  static constexpr int QUADS = EH * QR;    // quads of a plane: a lane each
  static constexpr int THREADS = (QUADS + 31) / 32 * 32;
  // One x-parity array of a plane: the EH rows and a guard row above and
  // below them, so that every neighbour index of every quad lies in the ring.
  static constexpr int PA = (EH + 2) * P4;
  static constexpr int SLOT = 2 * PA;      // floats of a plane
  static constexpr int R = K + 3;          // ring slots
};

// The volume and the tiling of one launch.
struct Tiling {
  const uint8_t* locked;
  int D, H, W;   // the unpadded volume
  int TZ;        // planes of a column segment
  int ny, nx;    // columns down y and across x
  int n_tiles;   // segments x columns
};

__host__ __device__ __forceinline__ size_t ring_floats(int K) {
  return static_cast<size_t>(K + 3) * (kTH + 2 * K + 2) * 2 * (((kTW + 2 * K) / 2 + 3) / 4 * 4);
}

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The quads of a plane are ordered by their rows' distance from the plane's
// y edges, farthest first (row slot q holds row row_of_slot(q); a slot's
// quads in x order). A level's trapezoid then covers a prefix of the order,
// and the warps past it skip the level whole.
template <int EH>
__device__ __forceinline__ int row_of_slot(int q) {
  return (q & 1) ? EH / 2 + (q >> 1) : EH / 2 - 1 - (q >> 1);
}

// Per pair k of a quad, packed once a tile: each voxel b's deepest level (4
// bits at 4b; a level l runs where l <= it), whether it is a centre voxel
// (bit 8+b), its frozen bit from y and x (bit 10+b: the volume's shell, or
// outside it or its extended plane), and whether it lies in the volume
// (bit 12+b).
constexpr int kCentre = 8;
constexpr int kFrozenXY = 10;
constexpr int kInVolume = 12;

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One chunk of `ns` (1..K) sweeps from iteration t0 on tile `tile`, src ->
// dst (and after sweep 0 to u1, when given), sweep 0's delta max-accumulated
// into delta_acc (when given). Every thread of the block calls it; ring is
// the block's dynamic shared memory.
template <int K>
__device__ __forceinline__ void tile_chunk(const float* src, float* dst, float* u1,
                                           const Tiling& g, int tile, int t0, int ns,
                                           unsigned int* delta_acc, float* ring) {
  using E = Ext<K>;
  const int cols = g.ny * g.nx;
  const int tz = tile / cols;
  const int rest = tile - tz * cols;
  const int ty = rest / g.nx;
  const int tx = rest - ty * g.nx;
  const int gz0 = tz * g.TZ;             // global voxel of the centre's first one
  const int gy0 = ty * kTH;
  const int gx0 = tx * kTW;
  const int cz = min(g.TZ, g.D - gz0);   // centre extents inside the volume
  const int ch = min(kTH, g.H - gy0);
  const int cw = min(kTW, g.W - gx0);
  const int za = max(0, gz0 - ns);       // the loaded planes: za .. zb - 1
  const int zb = min(g.D, gz0 + cz + ns);
  const int z_last = gz0 + cz - 1 + ns;  // the step that finishes the last centre plane
  const int oy = gy0 - K;                // global (y, x) of the extended plane's (0, 0)
  const int ox = gx0 - K;
  const int off = K - ns;                // the xy trapezoid: level l where l + off <= reach
  const long long HW = static_cast<long long>(g.H) * g.W;
  const int quad = threadIdx.x;          // this lane's quad, in the order above
  const int first = quad & ~31;          // the warp's first quad

  // This lane's quad: pairs j0 .. j0 + 3 of row y, voxels x0 .. x0 + 7.
  int meta[4];
  int idx = E::P4;     // the quad's first pair in an x-parity array (a past-the-plane quad: harmless)
  int gat = 0;         // its first voxel's offset in a global plane (negative in the halo)
  int par = 0;         // the parity of global y + x of its first voxel
#pragma unroll
  for (int k = 0; k < 4; ++k) meta[k] = 0;
  if (quad < E::QUADS) {
    const int q = quad / E::QR;
    const int j0 = 4 * (quad - q * E::QR);
    const int y = row_of_slot<E::EH>(q);
    const int gy = oy + y;
    idx = (y + 1) * E::P4 + j0;
    gat = gy * g.W + ox + 2 * j0;
    par = (oy + y + ox) & 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int m = 0;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int x = 2 * (j0 + k) + b;
        const int gx = ox + x;
        const bool real = x < E::EW;      // not a pitch pad
        const int reach = min(min(y, E::EH - 1 - y), min(x, E::EW - 1 - x));
        const int deepest = real ? min(max(reach - off, 0), 15) : 0;
        const bool inside = real && gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
        const bool shell = !inside || gy == 0 || gy == g.H - 1 || gx == 0 || gx == g.W - 1;
        const bool centre = y >= K && y < K + ch && x >= K && x < K + cw;
        m |= (deepest << (4 * b)) | (int(centre) << (kCentre + b)) |
             (int(shell) << (kFrozenXY + b)) | (int(inside) << (kInVolume + b));
      }
      meta[k] = m;
    }
  }
  // Level l runs on planes lo0 + lo_l * l .. hi0 - hi_l * l: l planes inside a
  // loaded end that is not the volume's, whose shell planes are frozen.
  const int lo0 = za == 0 ? 1 : za;
  const int lo_l = za == 0 ? 0 : 1;
  const int hi0 = zb == g.D ? g.D - 2 : zb - 1;
  const int hi_l = zb == g.D ? 0 : 1;

  unsigned fz[4];      // frozen bits: plane p - m at bits 2m (x = 2j), 2m + 1 (2j + 1)
  int lk[8];           // the next plane's locked bytes
  float4 vz = make_float4(0.f, 0.f, 0.f, 0.f);   // the z+ neighbours of the next level's voxels
#pragma unroll
  for (int k = 0; k < 4; ++k) fz[k] = ~0u;
#pragma unroll
  for (int v = 0; v < 8; ++v) lk[v] = 0;

  float local = 0.0f;
  // Step za - 1 only starts plane za's loads; step p waits for plane p,
  // starts plane p + 1's, and runs levels 1..ns on planes p - 1 .. p - ns.
  int sp = (za + E::R - 1) % E::R;   // the ring slot of plane p
  for (int p = za - 1; p <= z_last; ++p) {
    const bool step = p >= za;
    const int sn = sp == E::R - 1 ? 0 : sp + 1;   // plane p + 1's
    if (step) {
      cp_async_wait_all();
      __syncthreads();   // plane p has arrived everywhere, and step p - 1 is done
      const bool have_p = p < zb;
      const unsigned zshell = (p == 0 || p == g.D - 1) ? 3u : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned bits = unsigned(lk[2 * k] != 0) | (unsigned(lk[2 * k + 1] != 0) << 1) |
                              ((meta[k] >> kFrozenXY) & 3) | zshell;
        fz[k] = (fz[k] << 2) | (have_p ? bits : 3u);
      }
    }
    if (p + 1 < zb) {
      // Start copying plane p + 1's voxels of this lane's quad that lie in
      // the volume into their ring slot, and load their locked bytes, used a
      // step from now. The quad's offset may lie before the volume (a halo
      // row or column): a pointer is formed only to a voxel inside it.
      const long long at = (p + 1) * HW + gat;
      float* slot = ring + sn * E::SLOT + idx;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          lk[2 * k + b] = 0;
          if ((meta[k] >> (kInVolume + b)) & 1) {
            cp_async4(slot + b * E::PA + k, src + (at + 2 * k + b));
            lk[2 * k + b] = __ldg(g.locked + (at + 2 * k + b));
          }
        }
      }
      cp_async_commit();
    }
    if (!step) {
      sp = sn;
      continue;
    }

    // Every level of this step updates the same voxel of each pair, x = 2j
    // + o, o the same for the whole quad (its row's parity); the levels each
    // pair may run this step (bit 2l: not frozen on plane p - l, and inside
    // the xy trapezoid).
    const int o = (par + p + t0 + 1) & 1;
    const int own = idx + o * E::PA;          // the quad's updated voxels
    const int oth = idx + (1 - o) * E::PA;    // their partners, the x neighbours
    unsigned allowed[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int deepest = (meta[k] >> (4 * o)) & 15;
      allowed[k] = ~(fz[k] >> o) & (0x55555554u & ((4u << (2 * deepest)) - 1u));
    }
    const int l_lo = max(1, p - zb + 1);
    const int l_hi = min(ns, p - za);
    bool chain = false;   // vz holds plane r + 1's values for the next level
    // Unrolled: every level's constants fold into its copy.
#pragma unroll
    for (int l = 1; l <= K; ++l) {
      if (l < l_lo || l > l_hi) continue;
      const int r = p - l;
      const bool zok = r >= lo0 + lo_l * l && r <= hi0 - hi_l * l;
      const bool in_centre = r >= gz0 && r < gz0 + cz;
      const bool out_u1 = l == 1 && u1 != nullptr && in_centre;
      const bool out_dst = l == ns && in_centre;
      // The quads of the rows this level's trapezoid reaches; the centre
      // rows, and so every output, lie within them. A warp past them skips
      // the level, and so every later one.
      const int limit = 2 * (E::EH / 2 - l - off) * E::QR;
      if ((!zok && !out_u1 && !out_dst) || first >= limit) {
        chain = false;
        continue;
      }
      const int sr = sp >= l ? sp - l : sp - l + E::R;   // plane r's slot
      float* cur = ring + sr * E::SLOT;
      const float* below = ring + (sr == 0 ? E::R - 1 : sr - 1) * E::SLOT;
      const float* above = ring + (sr == E::R - 1 ? 0 : sr + 1) * E::SLOT;
      float4 v = lds4(cur + own);
      const float4 xo = lds4(cur + oth);
      if (zok) {
        // The quad's four updates at once; one 16-byte load a neighbour.
        const float4 zm = lds4(below + own);
        const float4 zp = chain ? vz : lds4(above + own);
        const float4 ym = lds4(cur + own - E::P4);
        const float4 yp = lds4(cur + own + E::P4);
        const float xe = o ? cur[oth + 4] : cur[oth - 1];   // the x neighbour past the quad
        const bool lane_in = quad < limit;
        const unsigned bit = 1u << (2 * l);
        float t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // o = 0: x- is partner k - 1, x+ partner k; o = 1: x- partner k, x+ partner k + 1.
          const float xm = o ? at4(xo, k) : (k == 0 ? xe : at4(xo, k - 1));
          const float xp = o ? (k == 3 ? xe : at4(xo, k + 1)) : at4(xo, k);
          t[k] = lse6(at4(zm, k), at4(zp, k), at4(ym, k), at4(yp, k), xm, xp);
        }
        float nv[4] = {v.x, v.y, v.z, v.w};
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (lane_in && (allowed[k] & bit)) {
            if (l == 1 && in_centre && ((meta[k] >> (kCentre + o)) & 1))
              local = fmaxf(local, fabsf(t[k] - nv[k]));
            nv[k] = t[k];
            any = true;
          }
        }
        v = make_float4(nv[0], nv[1], nv[2], nv[3]);
        if (any) *reinterpret_cast<float4*>(cur + own) = v;   // the others keep their values
      }
      vz = v;
      if ((out_u1 || out_dst) && quad < E::QUADS) {
        float* outs[2] = {out_u1 ? u1 : nullptr, out_dst ? dst : nullptr};
        const long long at = r * HW + gat;   // indexes only centre voxels, in the volume
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float mine = at4(v, k), other = at4(xo, k);
          const float v0 = o ? other : mine;
          const float v1 = o ? mine : other;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (outs[w] == nullptr) continue;
            if ((meta[k] >> kCentre) & 1) outs[w][at + 2 * k] = v0;
            if ((meta[k] >> (kCentre + 1)) & 1) outs[w][at + 2 * k + 1] = v1;
          }
        }
      }
      chain = true;
    }
    sp = sn;
  }
  if (delta_acc != nullptr) block_max_atomic<E::THREADS>(local, delta_acc);
  __syncthreads();  // the next tile reuses the ring
}

// All tiles of one chunk, strided over the blocks.
template <int K>
__device__ __forceinline__ void all_tiles(const float* src, float* dst, float* u1,
                                          const Tiling& g, int t0, int ns,
                                          unsigned int* delta_acc, float* ring) {
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x)
    tile_chunk<K>(src, dst, u1, g, tile, t0, ns, delta_acc, ring);
}

// K8/K10 (and T3, and with u1 the K10 check): one chunk from iteration
// *it + t_off; a block a tile.
template <int K>
__global__ void __launch_bounds__(Ext<K>::THREADS, kMinBlocks)
tile_chunk_kernel(const float* src, float* dst, float* u1, Tiling g, const int* it, int t_off,
                  int ns, unsigned int* delta_bits) {
  extern __shared__ float smem[];
  tile_chunk<K>(src, dst, u1, g, blockIdx.x, *it + t_off, ns, delta_bits, smem);
}

// K9/K11: `total` sweeps from *it + t_off spread over n_chunks chunks;
// chunk c reads a when c is even and b otherwise and writes the other, its
// sweep-0 delta into deltas[c] (zeroed by the caller). An even count ends in
// a.
template <int K>
__global__ void __launch_bounds__(Ext<K>::THREADS, kMinBlocks)
tile_cycle_kernel(float* a, float* b, Tiling g, const int* it, int t_off, int total,
                  int n_chunks, unsigned int* deltas) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  int t = *it + t_off;
  for (int c = 0; c < n_chunks; ++c) {
    const int ns = spread_at(total, n_chunks, c);
    if (c > 0) grid.sync();
    all_tiles<K>((c & 1) ? b : a, (c & 1) ? a : b, nullptr, g, t, ns, deltas + c, smem);
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
template <int K>
__global__ void __launch_bounds__(Ext<K>::THREADS, kMinBlocks)
tile_solve_kernel(float* u, float* twin, float* u1, Tiling g, const float* eps_ptr, int m_max,
                  int bound, int stagger, unsigned int* acc, int* it_io, float* delta_io,
                  int* done_io) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const float eps = *eps_ptr;
  int it = *it_io;
  float delta = *delta_io;
  bool done = *done_io != 0;
  const int depth = min(K, stagger);
  const int rest = stagger - depth;
  const int n_rest = (rest + K - 1) / K;
  float* cur = u;
  float* oth = twin;
  int slot = 0;
  while (!done && it < bound) {
    // Chunk 0 is the check. One call site for every chunk keeps one copy of
    // the pass in the kernel, and is also a correctness workaround: an
    // earlier build of this pass with the check and the other chunks at two
    // call sites (the pass inlined twice, spilling 216 B) gave wrong fields
    // at K = 4 only, cause not found (ROADMAP.md section 3, open).
    // tile_probe.py --solve3d rebuilds the two-call-site form of this pass
    // and holds it to K7 at every depth.
    int t = it;
    for (int c = 0; c <= n_rest; ++c) {
      const bool check = c == 0;
      const int ns = check ? depth : spread_at(rest, n_rest, c - 1);
      all_tiles<K>(cur, oth, check ? u1 : nullptr, g, t, ns, check ? acc + slot : nullptr, smem);
      grid.sync();
      if (check) {
        delta = __uint_as_float(__ldcg(acc + slot));
        if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
        slot ^= 1;
        done = delta < eps && it + 1 >= m_max;
        if (done) {
          it += 1;
          cur = u1;
          break;
        }
      }
      float* tmp = cur;
      cur = oth;
      oth = tmp;
      t += ns;
    }
    if (done) break;
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

size_t smem_bytes(int K) { return ring_floats(K) * sizeof(float); }

// The tiling of a launch; false for a depth or segment the kernels do not
// take, or a plane too large for the kernels' int offsets within it.
bool make_tiling(const void* locked, int D, int H, int W, int TZ, int K, Tiling* g) {
  if (K < 1 || K > kMaxK || TZ < 1 || D < 1 || H < 1 || W < 1 ||
      static_cast<long long>(H + 2 * K) * (W + 2 * K) > INT_MAX)
    return false;
  g->locked = static_cast<const uint8_t*>(locked);
  g->D = D;
  g->H = H;
  g->W = W;
  g->TZ = TZ;
  g->ny = (H + kTH - 1) / kTH;
  g->nx = (W + kTW - 1) / kTW;
  g->n_tiles = ((D + TZ - 1) / TZ) * g->ny * g->nx;
  return true;
}

// The instantiation of `Kernel` for depth K (1..kMaxK; make_tiling has
// checked it), and its block size (a lane a quad of the extended plane).
struct Launch {
  const void* kernel;
  int threads;
};

template <template <int> class Kernel>
Launch at_depth(int K) {
  switch (K) {
    case 1: return {Kernel<1>::fn(), Ext<1>::THREADS};
    case 2: return {Kernel<2>::fn(), Ext<2>::THREADS};
    case 3: return {Kernel<3>::fn(), Ext<3>::THREADS};
    case 4: return {Kernel<4>::fn(), Ext<4>::THREADS};
    default: return {Kernel<5>::fn(), Ext<5>::THREADS};
  }
}
static_assert(kMaxK == 5, "at_depth lists the depths 1..kMaxK");

template <int K>
struct ChunkKernel {
  static const void* fn() { return reinterpret_cast<const void*>(tile_chunk_kernel<K>); }
};
template <int K>
struct CycleKernel {
  static const void* fn() { return reinterpret_cast<const void*>(tile_cycle_kernel<K>); }
};
template <int K>
struct SolveKernel {
  static const void* fn() { return reinterpret_cast<const void*>(tile_solve_kernel<K>); }
};

}  // namespace

extern "C" {

// The dynamic shared memory a launch of depth K asks for: K + 3 planes,
// each two x-parity arrays of kTH + 2K + 2 rows (the extended plane's and
// two guard rows) of (kTW + 2K) / 2 floats padded to whole quads
// (solver/hopper_tile3d.py's smem_bytes gives the same).
long long epic_tile3d_smem_bytes(int K) { return static_cast<long long>(smem_bytes(K)); }

// Each entry launches on `stream` (PyTorch's current stream, as a pointer),
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success). u, twin, u1, src and dst are f32[D, H, W] and locked
// u8[D, H, W], contiguous; src and dst are distinct. TZ is the planes of a
// column segment (hopper_tile3d.tile_for), K the halo depth in y and x
// (1..kMaxK).

// One chunk of ns (1..K) sweeps from iteration *it + t_off, src -> dst; with
// u1 non-null, the state after sweep 0 goes there too; sweep 0's delta is
// max-accumulated into delta (zeroed by the caller).
int epic_tile3d_chunk(const void* src, void* dst, void* u1, const void* locked, int D, int H,
                      int W, int TZ, const void* it, int t_off, int ns, void* delta, int K,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g;
  if (!make_tiling(locked, D, H, W, TZ, K, &g) || ns < 1 || ns > K) return cudaErrorInvalidValue;
  const Launch launch = at_depth<ChunkKernel>(K);
  const size_t smem = smem_bytes(K);
  err = allow_smem(launch.kernel, smem);
  if (err != cudaSuccess) return err;
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  float* f = static_cast<float*>(u1);
  const int* it_i = static_cast<const int*>(it);
  unsigned int* db = static_cast<unsigned int*>(delta);
  void* args[] = {&s, &d, &f, &g, &it_i, &t_off, &ns, &db};
  err = cudaLaunchKernel(launch.kernel, dim3(g.n_tiles), dim3(launch.threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `total` sweeps from *it + t_off spread over n_chunks ping-pong chunks
// (a -> b -> a ...), none deeper than K; deltas[c] gets chunk c's sweep-0
// delta (zeroed by the caller). The state ends in a when n_chunks is even.
int epic_tile3d_cycle(void* a, void* b, const void* locked, int D, int H, int W, int TZ,
                      const void* it, int t_off, int total, int n_chunks, void* deltas, int K,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g;
  if (!make_tiling(locked, D, H, W, TZ, K, &g)) return cudaErrorInvalidValue;
  const int* it_i = static_cast<const int*>(it);
  unsigned int* d_u = static_cast<unsigned int*>(deltas);
  void* args[] = {&a, &b, &g, &it_i, &t_off, &total, &n_chunks, &d_u};
  const Launch launch = at_depth<CycleKernel>(K);
  return launch_cooperative(launch.kernel, launch.threads, g.n_tiles, smem_bytes(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

// The solve protocol in one launch, resumed from (*it_io, *delta_io,
// *done_io) and run while not done and the iteration is below `bound`; the
// final state is in u and the three scalars are written back. twin and u1
// are scratch volumes; acc two zeroed uint32 slots.
int epic_tile3d_solve(void* u, void* twin, void* u1, const void* locked, int D, int H, int W,
                      int TZ, const void* eps, int m_max, int bound, int stagger, void* acc,
                      void* it_io, void* delta_io, void* done_io, int K, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Tiling g;
  if (!make_tiling(locked, D, H, W, TZ, K, &g)) return cudaErrorInvalidValue;
  const float* eps_f = static_cast<const float*>(eps);
  void* args[] = {&u, &twin, &u1, &g, &eps_f, &m_max, &bound, &stagger,
                  &acc, &it_io, &delta_io, &done_io};
  const Launch launch = at_depth<SolveKernel>(K);
  return launch_cooperative(launch.kernel, launch.threads, g.n_tiles, smem_bytes(K), args, device,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
