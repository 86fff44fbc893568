// Pair-expanded sweep of clustered scenes, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of directcomputeraytracing_tpu/accel/
// pairsweep.py and keeps their per-pair contracts (accel/pairsweep.py in
// the port holds the glue and the PyTorch twins):
//   emit_kernel         <- _emit_kernel (:78, launched by _emit_pairs
//                          :112): per (item, lane), one slab test of the
//                          item's super box under the ray's window cap and
//                          floor -> one enter byte;
//   pair_closest_kernel <- _pair_closest_kernel (:274, launched by
//                          _run_pair_sweep :399): per (ray, super) pair,
//                          the fine cull of the super's 32 child boxes and
//                          the nearest-first cluster walk, a packed argmin
//                          with no state across supers -> packed best, t,
//                          u, v, tri, inst, back, clusters swept;
//   pair_any_kernel     <- _pair_any_kernel (:359, same launcher): the
//                          same fine cull and a walk for occlusion under
//                          the ray's t_max -> one byte.
// Rays are the (9, Rp) rows [o; d; 1/d] of prep_rays; a pair names its
// ray by index, so no per-pair ray table is gathered (the TPU kernels read
// a (p_cap, 16) one).
//
// The emission. Bound: the ALU pipe (half the FP32 rate on Hopper), which
// runs the slab test's min/max and the rule's compares per (item, lane)
// cell beside 12 FP32 subtractions and products; the bytes, the grid
// written once (a byte a cell) and the rays, caps and boxes read once,
// take a quarter of that time. The first port ran one 1024-thread CUDA
// block per item and one thread per cell, and every cell reloaded its ray
// (40 bytes, from L2): the ray block's rays were read again for each of
// its items. Here a
// CUDA block of kEmitThreads threads takes one ray block, each thread
// kEmitLanes consecutive lanes, and loads its rays once into registers
// (o, 1/d and the cap as float4 rows: the slab test reads no direction).
// The block walks its ray block's items (seg[b]..seg[b + 1] of the
// block-major item list) in slices of kEmitSlice: the slice's super boxes
// are staged in shared memory (32 bytes an item, double-buffered, one
// barrier a slice), then each thread tests its lanes against each box and
// writes their 4 enter bytes as one 32-bit store (a warp writes 128
// contiguous bytes of the item's row). A ray block's slices go to `split`
// CUDA blocks (blockIdx.y takes slices blockIdx.y, blockIdx.y + split,
// ...; accel/pairsweep.py emit_shape picks split from shapes alone), so
// that a few long lists do not hold the card; a CUDA block with no slice,
// as every one of a ray block without items, exits before it reads a ray.
// Each cell computes worklist.cuh's slab-test values on the same operands
// and its enter rule with the +-kBig clamps folded into the compares
// (enters_fold, which gives the same answer on every input: proof
// below); the ALU pipe runs 10 min/max and 3 compares a cell.
//
// The sweeps. A pair list groups the pairs by super (grid order within a
// super) and cuts each super's run into chunks of at most kPairThreads
// pairs: (super, first pair, count).
//
// pair_closest_kernel. The first port ran a 256-thread CUDA block a
// chunk, a pair a thread: it copied the super's 512 slab rows (32 KiB)
// into shared memory behind a barrier when the chunk held at least 32
// pairs, kept the 32 entry distances of its fine cull in registers (100
// of them: 2 blocks, 16 warps an SM), and each lane walked its own
// clusters nearest first, so that a warp lasted as long as its longest
// lane (2.2-2.5 clusters where a pair enters about 1.0) and lanes testing
// different clusters read row k of each at a 1 KiB stride (one bank).
// Here it takes pair_any_kernel's shape: kSweepThreads threads a half
// chunk (blockIdx.y), a pair a lane, only the 32 child boxes staged. Each
// lane's fine cull (fine_mask, the any-hit sweep's, under its initial
// window w0 = window(bits(texp) | kLowM)) gives a 32-bit mask. The warp
// deals its (lane, entered cluster) tasks out 32 a round
// (dealt_keys): each lane tests one task's 16 rows through the read-only
// cache with the ray of the task's lane under that lane's w0 and writes
// the least packed key it finds (INT_MAX: none) into the warp's table
// keys (shared memory, a column a lane: the lane reads only its own
// bank). Then each lane replays the nearest-first walk alone (replay),
// taking its entered children's clamped entry distances tl from the
// staged boxes once more (entry): it pops its entered clusters by tl,
// lowest child on a tie, stops at the first whose tl is not below the
// window of its best, counts each popped cluster into iters, and takes
// a cluster's key where it is strictly below its best. One more test of
// the winning row gives its t, u, v and side. Every entered cluster is tested, also those beyond the point
// where the walk stops (schedule (a) of tools/pair_ab.py pair_census;
// dealing a pair's k-th nearest cluster only after its (k-1)-th, schedule
// (b), prunes as the walk does but takes as many rounds as the longest
// walk in the warp).
// Why the replay is worklist.cuh walk_closest bit for bit. Let B be the
// best when the walk pops a cluster and W = window(B) (W <= w0: B only
// falls). The walk tests the cluster under W and takes the least key of
// its rows that hit in [t_min, W) if that is below B; the replay takes K0,
// the least key under w0, if that is below B. A test's values t, u, v and
// side do not depend on its t_max; only its verdict does, through t <
// t_max. Where B >= 0 (as an int: texp >= 0) and W is a number, W > 0 and
// the float order of non-negative numbers is their bits' order: a row
// with t >= W has bits(t) >= (B | kLowM) + 1, whose low 9 bits are 0, so
// its key is at least (B | kLowM) + 1 > B; a row with t < W has bits(t)
// <= B | kLowM or negative bits (t < 0, or -0), so its key is at most B |
// kLowM. So if K0's row has t < W, it hits under W too and is the least
// key there (the rows that hit under W hit under w0); else every row that
// hits under w0 has t >= W, none hits under W, the walk finds no
// candidate, and K0 > B is not taken either. Both take the same key. Where
// B < 0 (texp < 0 or -0) W < 0 <= tl and neither pops a cluster; where W
// is NaN (texp NaN or +inf) neither enters one. So best, the window, the
// order of the pops, the stop and iters run the same, and the winning row
// is the same, whose test values the last test reproduces. tl: the twin's
// clamped entry is fmaxf(t_lo, 0) with t_lo = max(-kBig, x) where x is no
// NaN and -kBig where it is, so fmaxf(x, 0), which the fold leaves, is
// the same number but for the sign of a zero; tl is only compared.
// Bound: FP32 ALU in the fine cull (32 slab tests a pair) and the tests
// of the entered clusters (16 a cluster), and the latency of their rows
// (L2 / L1: a super's 32 KiB serves its chunks).
//
// pair_any_kernel. A pair enters about one of its super's 32 clusters,
// and a warp's 32 pairs about 6-7 together (tools/pair_ab.py
// pair_census), so a copy of the super's 512 rows per chunk, as the first
// port made, moves five times the rows the chunk tests, makes every thread
// wait for it at a barrier, holds 33 KiB of shared memory per 256-thread
// block, and lanes that test different clusters read row k of each at a
// 1 KiB stride: one shared-memory bank, serialised. Here a CUDA block of
// kSweepThreads threads takes half a chunk (blockIdx.y), a pair a lane,
// stages only the super's 32 child boxes (1 KiB, read by all lanes at the
// same address: a broadcast), and each lane runs its own fine cull (the
// rule of worklist.cuh child_enter under t_max, folded: enters_fold) into
// a 32-bit mask. A lane walking its own clusters would hold its warp as
// long as its longest lane (about 2.4 clusters where a pair enters 1.0),
// and a warp walking the union of its lanes' clusters through a shared
// ring tests about 6.7 (both slower on the pool and shadow sets,
// PERF.md). So the warp deals its (lane, cluster) tasks out 32 a round
// (balanced_walk): each lane tests one task's 16 rows, through the
// read-only cache, with the ray of the task's lane, and a warp of about
// 32 tasks takes one or two rounds. A lane's answer is the OR over the
// rows of every cluster its own fine cull admits (a task may stop at the
// first hit and skip a lane that has one), so it is the twin's bit for
// bit, whichever lane tests which cluster. A lane whose window is empty
// (t_max <= t_min, or a NaN) is done from the start: the test needs
// t_min <= t < t_max, so no row can hit. Bound: FP32 ALU in the fine cull
// (32 slab tests a pair) and the triangle tests up to a lane's first hit,
// and the latency of the rows (L2 / L1: a super's 32 KiB serves its
// chunks).
//
// Built with -fmad=false: kernels and twins agree bit for bit.

#include <cuda_runtime.h>

#include "worklist.cuh"

namespace {

using dcrt::Best;
using dcrt::kCluster;
using dcrt::kLowM;
using dcrt::kSuper;
using dcrt::kSuperRows;
using dcrt::RayInv;

constexpr int kPairThreads = 256;   // the largest chunk: pairs per chunk
constexpr int kRayBlock = 1024;     // rays per ray block (worklist.RB)
constexpr int kEmitThreads = 256;   // threads of an emission block
constexpr int kEmitLanes = kRayBlock / kEmitThreads;   // lanes a thread
constexpr int kEmitSlice = 16;      // items whose boxes are staged at once
constexpr int kSweepThreads = 128;  // threads of a sweep block
constexpr int kHalves = kPairThreads / kSweepThreads;   // blocks a chunk
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kEmitLanes == 4, "a thread stores its lanes' bytes as a word");
static_assert(2 * kEmitSlice <= kEmitThreads, "a thread stages a half box");
static_assert(2 * kSuper <= kSweepThreads, "a thread stages a half box");
static_assert(kPairThreads % kSweepThreads == 0, "whole halves of a chunk");
static_assert(kCluster % 4 == 0, "a cluster's rows four at a time");

// Component l of v (l a constant after unrolling).
__device__ __forceinline__ float elem(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// The enter rule with the +-kBig clamps folded into its compares.
//
// worklist.cuh's slab() and enters() compute, for a ray and a box, a_k =
// (lo_k - o_k) * inv_k and b_k = (hi_k - o_k) * inv_k per axis, m_k =
// fminf(a_k, b_k), M_k = fmaxf(a_k, b_k), t_lo = max(-kBig, m_0, m_1,
// m_2) and t_hi = min(kBig, M_0, M_1, M_2) (folded left to right), and
// enter = t_hi >= t_lo && t_hi >= 0 && t_lo < cap && t_hi >= t_min.
// enters_fold() computes the same a_k, b_k, m_k and M_k, x = max(m_0,
// m_1, m_2) and y = min(M_0, M_1, M_2) without the clamps (two operations
// less), and tests !(y < x) && !(y < t_floor) && !(x >= cap_b), t_floor =
// max(t_min, 0), cap_b = min(cap, the float after kBig) (one compare
// less). It gives enter exactly on a lane where lane_open(cap, t_min)
// holds: cap > -kBig and t_min <= kBig. Where that fails, enter is false
// for every box (t_lo >= -kBig >= cap, or t_hi <= kBig < t_min, or a NaN
// compare), and the callers clear the lane.
// Proof where it holds (then cap, t_min, t_floor and cap_b are no NaN and
// 0 <= t_floor <= kBig): fminf / fmaxf return the other operand where one
// is NaN and NaN where both are, so m_k is NaN iff a_k and b_k both are,
// iff M_k is; x is the max of the m_k that are no NaN (NaN iff all are),
// y the min of those M_k, x is NaN iff y is, t_lo = max(-kBig, x) and
// t_hi = min(kBig, y); the sign of a zero never matters, as every value
// is only compared.
// - x and y NaN: t_lo = -kBig, t_hi = kBig, so enter = (-kBig < cap) &&
//   (kBig >= t_min) = true, and the three unordered tests are true.
// - otherwise: t_hi >= t_floor iff y >= t_floor (kBig >= t_floor); then
//   t_hi >= 0 > -kBig, so t_hi >= t_lo iff y >= x and kBig >= x; t_lo <
//   cap iff x < cap (-kBig < cap); and x <= kBig && x < cap iff x <
//   cap_b. So enter iff y >= t_floor && y >= x && x < cap_b, the three
//   tests.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool lane_open(float cap, float t_min) {
  return cap > -dcrt::kBig && t_min <= dcrt::kBig;
}

__device__ __forceinline__ float cap_below_big(float cap) {
  return fminf(cap, __int_as_float(__float_as_int(dcrt::kBig) + 1));
}

// The fold's slab values of a ray and a box: x = max over the axes of
// fminf(a_k, b_k), y = min of fmaxf(a_k, b_k) (no clamps).
__device__ __forceinline__ void slab_fold(const RayInv& q, float lx,
                                          float ly, float lz, float hx,
                                          float hy, float hz, float& x,
                                          float& y) {
  float a = (lx - q.r.ox) * q.ix, b = (hx - q.r.ox) * q.ix;
  x = fminf(a, b);
  y = fmaxf(a, b);
  a = (ly - q.r.oy) * q.iy;
  b = (hy - q.r.oy) * q.iy;
  x = fmaxf(x, fminf(a, b));
  y = fminf(y, fmaxf(a, b));
  a = (lz - q.r.oz) * q.iz;
  b = (hz - q.r.oz) * q.iz;
  x = fmaxf(x, fminf(a, b));
  y = fminf(y, fmaxf(a, b));
}

__device__ __forceinline__ bool fold_rule(float x, float y, float cap_b,
                                          float t_floor) {
  return !(y < x) && !(y < t_floor) && !(x >= cap_b);
}

__device__ __forceinline__ bool enters_fold(const RayInv& q, float lx,
                                            float ly, float lz, float hx,
                                            float hy, float hz, float cap_b,
                                            float t_floor) {
  float x, y;
  slab_fold(q, lx, ly, lz, hx, hy, hz, x, y);
  return fold_rule(x, y, cap_b, t_floor);
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(const int* __restrict__ seg, const int* __restrict__ item_sup,
            const float* __restrict__ sbox, const float* __restrict__ od,
            const float* __restrict__ cap, int rp, float t_min,
            unsigned char* __restrict__ out) {
  __shared__ float4 boxes[2][kEmitSlice][2];
  const int b = blockIdx.x;
  const int first = __ldg(seg + b), n = __ldg(seg + b + 1) - first;
  const int n_slices = (n + kEmitSlice - 1) / kEmitSlice;
  if (static_cast<int>(blockIdx.y) >= n_slices) return;   // whole block
  const size_t n_rp = static_cast<size_t>(rp);
  const size_t i0 = static_cast<size_t>(b) * kRayBlock +
                    kEmitLanes * threadIdx.x;
  auto row4 = [&](const float* row) {
    return __ldg(reinterpret_cast<const float4*>(row + i0));
  };
  const float4 ox = row4(od), oy = row4(od + n_rp), oz = row4(od + 2 * n_rp);
  const float4 ix = row4(od + 6 * n_rp), iy = row4(od + 7 * n_rp),
               iz = row4(od + 8 * n_rp);
  const float4 cp = row4(cap);
  RayInv q[kEmitLanes];
  float cap_b[kEmitLanes];
  unsigned open = 0u;   // the bytes of the lanes where the rule can pass
#pragma unroll
  for (int l = 0; l < kEmitLanes; ++l) {
    // the slab test reads no direction
    q[l].r = dcrt::Ray{elem(ox, l), elem(oy, l), elem(oz, l), 0.f, 0.f, 0.f};
    q[l].ix = elem(ix, l);
    q[l].iy = elem(iy, l);
    q[l].iz = elem(iz, l);
    cap_b[l] = cap_below_big(elem(cp, l));
    if (lane_open(elem(cp, l), t_min)) open |= 0xffu << (8 * l);
  }
  const float t_floor = fmaxf(t_min, 0.f);
  const float4* sbox4 = reinterpret_cast<const float4*>(sbox);
  int buf = 0;
  for (int s = blockIdx.y; s < n_slices; s += gridDim.y, buf ^= 1) {
    const int k0 = first + s * kEmitSlice;
    const int m = min(kEmitSlice, n - s * kEmitSlice);
    // the other buffer was read before the last barrier: one a slice
    if (static_cast<int>(threadIdx.x) < 2 * m) {
      const int k = threadIdx.x >> 1, h = threadIdx.x & 1;
      boxes[buf][k][h] =
          __ldg(sbox4 + 2 * static_cast<size_t>(__ldg(item_sup + k0 + k)) + h);
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float4 lo = boxes[buf][k][0], hi = boxes[buf][k][1];
      unsigned word = 0u;
#pragma unroll
      for (int l = 0; l < kEmitLanes; ++l)   // a predicated OR a lane
        if (enters_fold(q[l], lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, cap_b[l],
                        t_floor))
          word |= 1u << (8 * l);
      reinterpret_cast<unsigned*>(
          out + static_cast<size_t>(k0 + k) * kRayBlock)[threadIdx.x] =
          word & open;
    }
  }
}

// The fine cull of both sweeps: the children whose box the ray enters
// before cap (the any-hit sweep's t_max, the closest sweep's initial
// window), in front of t_min (worklist.cuh child_enter's rule, folded;
// the caller clears a lane where lane_open fails).
__device__ __forceinline__ unsigned fine_mask(const RayInv& q,
                                              const float4* boxes, float cap,
                                              float t_min) {
  const float cap_b = cap_below_big(cap), t_floor = fmaxf(t_min, 0.f);
  unsigned mask = 0u;
#pragma unroll
  for (int c = 0; c < kSuper; ++c) {
    const float4 lo = boxes[2 * c], hi = boxes[2 * c + 1];
    if (enters_fold(q, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, cap_b, t_floor))
      mask |= 1u << c;
  }
  return mask;
}

// Whether one of the 16 rows at `base` of tab holds a hit in [t_min,
// t_max): the rows through the read-only cache four at a time, so that
// their loads are in flight together, stopping after the first four that
// hold a hit.
template <class Tri>
__device__ __forceinline__ bool cluster_hit(const dcrt::Ray& r,
                                            const typename Tri::Pre& pre,
                                            const float* __restrict__ tab,
                                            int base, float t_min,
                                            float t_max) {
  bool hit = false;
  for (int k = 0; k < kCluster && !hit; k += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dcrt::Hit h;
      hit |= Tri::template test<true>(r, pre, tab, base + k + i, t_min,
                                      t_max, h);
    }
  }
  return hit;
}

// The warp's (lane, entered cluster) tasks, lane-major: lane l's start
// at the exclusive prefix of the lanes' counts of set bits of mask (the
// return value); total is the count over the warp.
__device__ __forceinline__ int task_starts(unsigned mask, int& total) {
  const int lane = threadIdx.x & 31;
  int incl = __popc(mask);
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - __popc(mask);
}

// Task t's lane o (the last whose tasks start at or before t) and its
// rank k among that lane's tasks (all lanes, converged).
__device__ __forceinline__ int task_lane(int t, int excl, int& k) {
  int o = 0;
  for (int step = 16; step; step >>= 1)
    if (__shfl_sync(kFull, excl, o + step) <= t) o += step;
  k = t - __shfl_sync(kFull, excl, o);
  return o;
}

// The cluster of a lane's k-th task: its mask's k-th set bit.
__device__ __forceinline__ int kth_cluster(unsigned m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// Lane o's ray, by shuffles (all lanes, converged).
__device__ __forceinline__ dcrt::Ray ray_of(const dcrt::Ray& r, int o) {
  return dcrt::Ray{__shfl_sync(kFull, r.ox, o), __shfl_sync(kFull, r.oy, o),
                   __shfl_sync(kFull, r.oz, o), __shfl_sync(kFull, r.dx, o),
                   __shfl_sync(kFull, r.dy, o), __shfl_sync(kFull, r.dz, o)};
}

// The balanced walk: the warp's tasks (task_starts) 32 a round, each
// lane testing one task's 16 rows with the ray of the task's lane and
// recording a hit in the warp's word of `hits`; a task whose lane has a
// hit already is skipped. Returns this lane's occlusion.
template <class Tri>
__device__ __forceinline__ bool balanced_walk(const RayInv& q, float t_max,
                                              unsigned mask, const float* stab,
                                              float t_min,
                                              volatile unsigned* hits) {
  const int lane = threadIdx.x & 31;
  int total;
  const int excl = task_starts(mask, total);
  if (lane == 0) *hits = 0u;
  __syncwarp();
  for (int t = lane; t - lane < total; t += 32) {
    int k;
    const int o = task_lane(t, excl, k);
    const unsigned m = __shfl_sync(kFull, mask, o);
    const dcrt::Ray r = ray_of(q.r, o);
    const float tmax_o = __shfl_sync(kFull, t_max, o);
    if (t < total && !((*hits >> o) & 1u) &&
        cluster_hit<Tri>(r, Tri::prepare(r), stab,
                         kth_cluster(m, k) * kCluster, t_min, tmax_o))
      atomicOr(const_cast<unsigned*>(hits), 1u << o);
    __syncwarp();
  }
  return (*hits >> lane) & 1u;
}

template <class Tri>
__global__ void __launch_bounds__(kSweepThreads)
pair_any_kernel(const int* __restrict__ chunk_sup,
                const int* __restrict__ chunk_first,
                const int* __restrict__ chunk_count,
                const int* __restrict__ pair_ray,
                const float* __restrict__ cbox, const float* __restrict__ tab,
                const float* __restrict__ od, const float* __restrict__ tm,
                int rp, float t_min, unsigned char* __restrict__ out_occ) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ unsigned hits[kSweepWarps];
  const int n = chunk_count[blockIdx.x];
  const int base = blockIdx.y * kSweepThreads;   // this block's half
  if (base >= n) return;                       // whole block
  const int sup = chunk_sup[blockIdx.x];
  const float* stab = tab + static_cast<size_t>(sup) * kSuperRows * Tri::kCols;
  dcrt::stage_boxes(cbox, sup, boxes);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (base + warp * 32 >= n) return;           // whole warp
  const int j = base + threadIdx.x;
  const bool live = j < n;
  const size_t p = static_cast<size_t>(chunk_first[blockIdx.x]) + j;
  const int ray = live ? pair_ray[p] : 0;
  const RayInv q = dcrt::load_od(od, rp, ray);
  const float t_max = tm[ray];
  // an empty window holds no hit: such a lane is done from the start
  const bool open = live && t_max > t_min && lane_open(t_max, t_min);
  const unsigned mask = open ? fine_mask(q, boxes, t_max, t_min) : 0u;
  const bool occluded =
      balanced_walk<Tri>(q, t_max, mask, stab, t_min, hits + warp);
  if (live) out_occ[p] = occluded;
}

// The least packed key of child c's 16 rows of tab that hit in [t_min,
// t_max) (worklist.cuh test_cluster's candidate), INT_MAX if none: the
// rows through the read-only cache four at a time.
template <class Tri>
__device__ __forceinline__ int cluster_key(const dcrt::Ray& r,
                                           const typename Tri::Pre& pre,
                                           const float* __restrict__ tab,
                                           int c, float t_min, float t_max) {
  int cand = INT_MAX;
#pragma unroll 4
  for (int k = 0; k < kCluster; ++k) {
    dcrt::Hit h;
    if (Tri::template test<true>(r, pre, tab, c * kCluster + k, t_min, t_max,
                                 h))
      cand = min(cand, (__float_as_int(h.t) & ~kLowM) | ((c << 4) | k));
  }
  return cand;
}

// The dealt tests: the warp's (lane, entered cluster) tasks 32 a round,
// each lane testing one task's cluster with the ray and the initial
// window w0 of the task's lane o and writing its key to keys[c][o].
template <class Tri>
__device__ __forceinline__ void dealt_keys(const dcrt::Ray& r, float w0,
                                           unsigned mask, const float* stab,
                                           float t_min, int (*keys)[32]) {
  const int lane = threadIdx.x & 31;
  int total;
  const int excl = task_starts(mask, total);
  for (int t = lane; t - lane < total; t += 32) {
    int k;
    const int o = task_lane(t, excl, k);
    const unsigned m = __shfl_sync(kFull, mask, o);
    const dcrt::Ray ro = ray_of(r, o);
    const float w_o = __shfl_sync(kFull, w0, o);
    if (t < total) {
      const int c = kth_cluster(m, k);
      keys[c][o] = cluster_key<Tri>(ro, Tri::prepare(ro), stab, c, t_min,
                                    w_o);
    }
  }
  __syncwarp();
}

// The clamped entry distance tl of child c (worklist.cuh fine_cull's,
// but for the sign of a zero: see the header).
__device__ __forceinline__ float entry(const RayInv& q, const float4* boxes,
                                       int c) {
  const float4 lo = boxes[2 * c], hi = boxes[2 * c + 1];
  float x, y;
  slab_fold(q, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, x, y);
  return fmaxf(x, 0.f);
}

// The nearest-first walk replayed from the keys (see the header): pops
// this lane's entered clusters (mask) by tl, lowest child on a tie, until
// one starts at or beyond the window of the best; counts the pops into
// s.iters and takes a key strictly below s.best. Returns the winning row
// of the super (child * 16 + row of the cluster) or -1.
__device__ __forceinline__ int replay(unsigned mask, const RayInv& q,
                                      const float4* boxes,
                                      const int (*keys)[32], Best& s) {
  const int lane = threadIdx.x & 31;
  int row = -1;
  while (mask) {
    float m = INFINITY;
    int cs = 0;
    for (unsigned r = mask; r; r &= r - 1) {
      const int c = __ffs(r) - 1;
      const float x = entry(q, boxes, c);
      if (x < m) {
        m = x;
        cs = c;
      }
    }
    if (!(m < dcrt::window(s.best))) break;
    mask &= ~(1u << cs);
    ++s.iters;
    const int key = keys[cs][lane];
    if (key < s.best) {
      s.best = key;
      row = key & kLowM;
    }
  }
  return row;
}

template <class Tri>
__global__ void __launch_bounds__(kSweepThreads)
pair_closest_kernel(const int* __restrict__ chunk_sup,
                    const int* __restrict__ chunk_first,
                    const int* __restrict__ chunk_count,
                    const int* __restrict__ pair_ray,
                    const float* __restrict__ cbox,
                    const float* __restrict__ tab,
                    const float* __restrict__ od,
                    const float* __restrict__ texp, int rp, float t_min,
                    dcrt::ClosestOut out) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ int keys[kSweepWarps][kSuper][32];
  const int n = chunk_count[blockIdx.x];
  const int base = blockIdx.y * kSweepThreads;   // this block's half
  if (base >= n) return;                         // whole block
  const int sup = chunk_sup[blockIdx.x];
  const float* stab = tab + static_cast<size_t>(sup) * kSuperRows * Tri::kCols;
  dcrt::stage_boxes(cbox, sup, boxes);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (base + warp * 32 >= n) return;             // whole warp
  const int j = base + threadIdx.x;
  const bool live = j < n;
  const size_t p = static_cast<size_t>(chunk_first[blockIdx.x]) + j;
  const int ray = live ? pair_ray[p] : 0;
  const RayInv q = dcrt::load_od(od, rp, ray);
  Best s = dcrt::start_best(texp[ray]);
  const float w0 = dcrt::window(s.best);
  const unsigned mask =
      live && lane_open(w0, t_min) ? fine_mask(q, boxes, w0, t_min) : 0u;
  dealt_keys<Tri>(q.r, w0, mask, stab, t_min, keys[warp]);
  const int row = replay(mask, q, boxes, keys[warp], s);
  if (!live) return;
  if (row >= 0) {
    dcrt::Hit h;
    Tri::template test<true>(q.r, Tri::prepare(q.r), stab, row, t_min, w0,
                             h);
    s.t = h.t;
    s.u = h.u;
    s.v = h.v;
    s.back = h.back;
    s.row = row;
  }
  dcrt::store_soup<Tri>(out, p, stab, s, s.row);
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, launching nothing, for shapes it does not take.

// The largest chunk the sweeps take (kHalves blocks of each).
extern "C" int dcrt_pair_chunk() { return kPairThreads; }

// The emission's slice: items whose boxes a CUDA block stages at once.
extern "C" int dcrt_pair_emit_slice() { return kEmitSlice; }

// The (nb + 1,) int32 offsets seg of each ray block's items in the
// block-major item list (n_items of them, supers item_sup); `rb` rays per
// block (1024) and rp = nb * rb; `split` CUDA blocks a ray block; od, cap
// and out 16-byte aligned. out is (n_items, rb).
extern "C" int dcrt_pair_emit(const int* seg, const int* item_sup,
                              int n_items, int nb, int split,
                              const float* sbox, const float* od,
                              const float* cap, int rp, int rb, float t_min,
                              unsigned char* out, void* stream) {
  if (rb != kRayBlock || rp != nb * rb || split < 1 || split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && nb > 0)
    emit_kernel<<<dim3(nb, split), kEmitThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(seg, item_sup, sbox,
                                                       od, cap, rp, t_min,
                                                       out);
  return static_cast<int>(cudaGetLastError());
}

// The launch list: chunk j sweeps pairs [first[j], first[j] + count[j])
// of super sup[j] (count 0: nothing); count <= kPairThreads; kHalves
// blocks of kSweepThreads a chunk.
extern "C" int dcrt_pair_closest(const int* chunk_sup, const int* chunk_first,
                                 const int* chunk_count, int n_chunks,
                                 const int* pair_ray, const float* cbox,
                                 const float* tab, int watertight,
                                 const float* od, const float* texp, int rp,
                                 float t_min, int* best, float* t, float* u,
                                 float* v, int* tri, int* inst,
                                 unsigned char* back, int* iters,
                                 void* stream) {
  if (n_chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    const dim3 grid(n_chunks, kHalves);
    if (watertight)
      pair_closest_kernel<dcrt::RawWatertight><<<grid, kSweepThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, texp,
          rp, t_min, out);
    else
      pair_closest_kernel<dcrt::BaldwinWeber><<<grid, kSweepThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, texp,
          rp, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same launch list and blocks.
extern "C" int dcrt_pair_any(const int* chunk_sup, const int* chunk_first,
                             const int* chunk_count, int n_chunks,
                             const int* pair_ray, const float* cbox,
                             const float* tab, int watertight,
                             const float* od, const float* tm, int rp,
                             float t_min, unsigned char* occ, void* stream) {
  if (n_chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_chunks, kHalves);
    if (watertight)
      pair_any_kernel<dcrt::RawWatertight><<<grid, kSweepThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, tm,
          rp, t_min, occ);
    else
      pair_any_kernel<dcrt::BaldwinWeber><<<grid, kSweepThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, tm,
          rp, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernels' resources on this card, five ints per kernel in the order
// emission; closest Baldwin-Weber, watertight; any-hit Baldwin-Weber,
// watertight: resident blocks per SM, registers, static shared bytes,
// local (spill) bytes per thread, threads per block.
extern "C" int dcrt_pair_resources(int* out) {
  constexpr int kFns = 5;
  using dcrt::BaldwinWeber;
  using dcrt::RawWatertight;
  const void* fns[kFns] = {
      reinterpret_cast<const void*>(emit_kernel),
      reinterpret_cast<const void*>(pair_closest_kernel<BaldwinWeber>),
      reinterpret_cast<const void*>(pair_closest_kernel<RawWatertight>),
      reinterpret_cast<const void*>(pair_any_kernel<BaldwinWeber>),
      reinterpret_cast<const void*>(pair_any_kernel<RawWatertight>)};
  const int threads[kFns] = {kEmitThreads, kSweepThreads, kSweepThreads,
                             kSweepThreads, kSweepThreads};
  for (int f = 0; f < kFns; ++f) {
    cudaFuncAttributes a;
    cudaError_t err;
    if ((err = cudaFuncGetAttributes(&a, fns[f])) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             out + 5 * f, fns[f], threads[f], 0)) != cudaSuccess)
      return static_cast<int>(err);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = threads[f];
  }
  return static_cast<int>(cudaGetLastError());
}
