// Clustered cull-and-sweep over a world-space triangle soup, for Hopper
// (sm_90a).
//
// Replaces the three TPU kernels of the clustered half of
// directcomputeraytracing_tpu/accel/pallas_brute.py and keeps their
// contracts:
//   cull_kernel    <- _cull_kernel (:338, with _cull_one_block :346),
//                     launched by _cull_masks (:397);
//   closest_kernel <- _clustered_closest_kernel (:425), launched by
//                     clustered_closest_pallas (:554): (t, +inf on miss; u;
//                     v; tri i32; inst i32; back bool), the first triangle
//                     in cluster-table order among those at the minimum t,
//                     over the clusters the sweep admits for the ray;
//   any_kernel     <- _clustered_any_kernel (:508), launched by
//                     clustered_any_pallas (:601): occluded bool, a hit in
//                     [t_min, t_max[ray]) in a cluster admitted for the ray.
// Inputs (accel/clustered.py): the (Cg * 16, 12) f32 cluster table [v0 v1
// v2 | tri id | inst id | flip], Cg clusters a multiple of 16 (a group of
// 16 clusters is 256 rows; padding rows are zero and never hit), its rows
// in the test's 48-byte form (accel/brute.py prepare_rows, the form
// Moeller::stage / Watertight::stage write), the (Cg, 8) cluster boxes and
// the (Cg / 16, 8) group boxes [bmin | bmax | 0 0], and (R, 3) f32
// origins and directions. A ray block is 1024 consecutive rays; the masks
// are (n_blocks, Cg) and (n_blocks, Cg / 16) uint8.
//
// cull_kernel. Bound: operations, about 90 per (ray block, cluster) pair
// against 24 bytes per ray and a few per pair of mask. One CUDA block of
// 1024 threads per ray block. Each thread decides whether its ray can
// reach the scene: finite, a non-zero direction, and its own slab test
// enters the reach box (the union of the cluster boxes, widened). The
// block reduces the min and max of origin and direction per axis over
// those rays only (warp shuffles, then one warp over shared memory), so
// that parked lanes (2e9 along +x) and rays past the scene cannot stretch
// the bundle over the whole scene. Then one thread per (block, cluster)
// runs the reference's interval test in its order: the 1e-30 nudged
// reciprocals of the direction endpoints, the eight endpoint products,
// the `spans` rule, enter = (t_hi >= t_lo) & (t_hi >= 0). A half-warp
// ballot gives the group mask. Sound: a ray left out of the bounds misses
// the reach box, so by monotone rounding its slab test misses every
// cluster box inside it and it has no hit to lose.
//
// The sweeps' rule (the port's choice: the reference sweeps every cluster
// of its block's mask). Ray i tests the 16 rows of cluster c exactly when
// c is set in its ray block's cmask and at least one ray of its warp (the
// 32 rays i / 32) votes for c: its own slab test enters c's box, with the
// reciprocals of safe_inv and no t range, enter = t_hi >= t_lo && t_hi >=
// 0 (accel/clustered.py ray_votes, exact_masks_torch's arithmetic). Rays
// at or past n_rays, and rays with a non-finite origin or direction
// component, vote no: fminf drops a NaN operand where the twin's
// torch.minimum keeps it, so a non-finite ray has no vote the two read
// alike. A finite ray's slab test reads no NaN: safe_inv gives a finite,
// non-zero reciprocal (+-1e30 for a zero component), the box corners are
// finite, so every product is finite or +-inf, and fminf / fmaxf pick the
// value torch.minimum / torch.maximum pick. Sound in the reference's sense
// (pallas_brute.py:296-300): every cluster whose box the ray's own slab
// test enters is swept for it, since the cull's mask holds it. The result
// differs from a sweep of the whole block mask only where the winning hit
// lies in a cluster whose box no ray of the warp enters: the ray's own
// slab test misses the box of a triangle that it hits, an edge graze.
//
// closest_kernel / any_kernel. Bound: FP32 ALU, a lane's slab votes (one
// per group its block entered, one per masked cluster of the groups its
// warp enters) and 16 triangle tests per cluster admitted for its warp
// (chip_smoke.py counts them). 128-thread blocks, one warp per 32 rays,
// a ray per lane. Each warp walks its ray block's entered groups on its
// own, with no block-wide barrier:
// - the group mask 32 bytes at a time, a byte a lane (one ballot names
//   the chunk's entered groups), each lane loading its group's box beside
//   it;
// - per entered group, in order, each lane votes for the group box (from
//   the lane that loaded it, by shuffles) and the warp takes a ballot; on
//   a yes, the group's 16 mask bytes (one 16-byte load) and its 16
//   cluster boxes (a float4 a lane), and each lane votes for the box of
//   each masked cluster, a ballot a cluster: the admitted clusters;
// - an admitted cluster's 16 rows (768 bytes) go by cp.async into a
//   two-slot ring in the warp's shared memory while the cluster before it
//   is tested; each lane tests the rows in order with its best as t_max (a
//   row replaces the best only when strictly nearer: the reference's
//   first minimum). An any-hit lane stops at its first hit, and the warp
//   leaves once all its lanes are done.
// The group vote is exact. A group box holds each member box as the slab
// test reads it (accel/clustered.py group_boxes: per axis the min and max
// over the members of min(lo, hi) and max(lo, hi)). Along an axis with
// reciprocal r > 0 (r < 0 swaps the corners) the slab test reads a box
// [lo, hi] as [(lo - o) * r, (hi - o) * r] after min and max; rounded
// subtraction and multiplication are monotone, so lo_G <= lo_B gives
// (lo_G - o) * r <= (lo_B - o) * r, hi_G >= hi_B the same at the top, and
// the group's interval holds the member's on every axis: t_lo_G <= t_lo_B,
// t_hi_G >= t_hi_B, and a lane that enters the member (t_hi_B >= t_lo_B,
// t_hi_B >= 0) enters the group box. A group box no lane enters holds no
// cluster that a lane would admit. Padding clusters keep their inverted
// boxes, which a slab test reads as the cube [-1, 1]^3, so a padding
// cluster can be admitted: its rows are zero (Moeller: det 0; watertight:
// degenerate) and never hit. Built with -fmad=false, like brute_sweep.cu,
// so the kernels and their PyTorch twins (accel/clustered.py) agree bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "worklist.cuh"

namespace {

constexpr int kRayBlock = 1024;   // rays per mask row (clustered.RAY_BLOCK)
constexpr int kGroup = 16;        // clusters per group (CLUSTER_GROUP)
constexpr int kClusterRows = 16;  // rows per cluster (CLUSTER_SIZE)
constexpr int kWarps = kRayBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSweepThreads = 128;               // threads per CUDA block
constexpr int kSweepMinBlocks = 8;               // resident per SM
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSlot = 3 * kClusterRows;          // float4 of a cluster's rows

static_assert(kWarps == 32, "one warp reduces the per-warp bounds");
static_assert(2 * kGroup == 32, "a group's boxes are a float4 a lane");
static_assert(kSlot > 32 && kSlot <= 64, "two float4 copies a lane");

using dcrt::cp_async16;
using dcrt::cp_async_commit;
using dcrt::cp_async_wait;
using dcrt::Hit;
using dcrt::kBig;
using dcrt::load_ray;
using dcrt::load_row;
using dcrt::Moeller;
using dcrt::RayInv;
using dcrt::slab;
using dcrt::Watertight;

struct Reach {
  float lo[3], hi[3];
};

// 1 / x with |x| < 1e-30 nudged to +-1e-30 (the reference's reciprocal).
__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-30f ? (x >= 0.f ? 1e-30f : -1e-30f) : x);
}

// Whether a ray can reach the scene (accel/clustered.py: reach_mask).
__device__ bool reaches(const float v[6], const Reach& box) {
  for (int k = 0; k < 6; ++k)
    if (!isfinite(v[k])) return false;
  if (!(v[3] * v[3] + v[4] * v[4] + v[5] * v[5] > 0.f)) return false;
  float t_lo = -kBig, t_hi = kBig;
  for (int ax = 0; ax < 3; ++ax) {
    const float inv = safe_inv(v[3 + ax]);
    const float a = (box.lo[ax] - v[ax]) * inv;
    const float b = (box.hi[ax] - v[ax]) * inv;
    t_lo = fmaxf(t_lo, fminf(a, b));
    t_hi = fminf(t_hi, fmaxf(a, b));
  }
  return t_hi >= t_lo && t_hi >= 0.f;
}

__global__ void __launch_bounds__(kRayBlock)
cull_kernel(const float* __restrict__ cbox, int n_clusters,
            const float* __restrict__ o, const float* __restrict__ d,
            int n_rays, Reach reach, unsigned char* __restrict__ cmask,
            unsigned char* __restrict__ gmask) {
  __shared__ float s_warp[kWarps][12];
  __shared__ float s_block[12];   // min o, min d, max o, max d
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kRayBlock + tid;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n_rays) {
    for (int k = 0; k < 3; ++k) {
      v[k] = o[3 * i + k];
      v[3 + k] = d[3 * i + k];
    }
  }
  const bool in = i < n_rays && reaches(v, reach);
  float b[12];
  for (int k = 0; k < 6; ++k) {
    b[k] = in ? v[k] : INFINITY;
    b[6 + k] = in ? v[k] : -INFINITY;
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int k = 0; k < 6; ++k) {
      b[k] = fminf(b[k], __shfl_xor_sync(0xffffffffu, b[k], off));
      b[6 + k] = fmaxf(b[6 + k], __shfl_xor_sync(0xffffffffu, b[6 + k], off));
    }
  if (lane == 0)
    for (int k = 0; k < 12; ++k) s_warp[warp][k] = b[k];
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < 12; ++k) b[k] = s_warp[lane][k];
    for (int off = 16; off > 0; off >>= 1)
      for (int k = 0; k < 6; ++k) {
        b[k] = fminf(b[k], __shfl_xor_sync(0xffffffffu, b[k], off));
        b[6 + k] = fmaxf(b[6 + k],
                         __shfl_xor_sync(0xffffffffu, b[6 + k], off));
      }
    if (lane == 0)
      for (int k = 0; k < 12; ++k) s_block[k] = b[k];
  }
  __syncthreads();
  // no ray of the block reaches the scene: min > max, nothing is entered
  const bool any = s_block[0] <= s_block[6];
  bool spans[3];
  float o_lo[3], o_hi[3], i_lo[3], i_hi[3];
  for (int ax = 0; ax < 3; ++ax) {
    o_lo[ax] = s_block[ax];
    o_hi[ax] = s_block[6 + ax];
    const float d_lo = s_block[3 + ax], d_hi = s_block[9 + ax];
    spans[ax] = d_lo <= 0.f && d_hi >= 0.f;
    const float i_a = safe_inv(d_lo), i_b = safe_inv(d_hi);
    i_lo[ax] = fminf(i_a, i_b);
    i_hi[ax] = fmaxf(i_a, i_b);
  }
  const int n_groups = n_clusters / kGroup;
  for (int base = 0; base < n_clusters; base += kRayBlock) {
    const int c = base + tid;
    bool enter = false;
    if (any && c < n_clusters) {
      float t_lo = -kBig, t_hi = kBig;
      for (int ax = 0; ax < 3; ++ax) {
        if (spans[ax]) continue;
        const float b0 = cbox[8 * c + ax], b1 = cbox[8 * c + 3 + ax];
        const float n0_lo = b0 - o_hi[ax], n0_hi = b0 - o_lo[ax];
        const float n1_lo = b1 - o_hi[ax], n1_hi = b1 - o_lo[ax];
        const float cand[8] = {n0_lo * i_lo[ax], n0_lo * i_hi[ax],
                               n0_hi * i_lo[ax], n0_hi * i_hi[ax],
                               n1_lo * i_lo[ax], n1_lo * i_hi[ax],
                               n1_hi * i_lo[ax], n1_hi * i_hi[ax]};
        float ax_lo = cand[0], ax_hi = cand[0];
        for (int k = 1; k < 8; ++k) {
          ax_lo = fminf(ax_lo, cand[k]);
          ax_hi = fmaxf(ax_hi, cand[k]);
        }
        t_lo = fmaxf(t_lo, ax_lo);
        t_hi = fminf(t_hi, ax_hi);
      }
      enter = t_hi >= t_lo && t_hi >= 0.f;
    }
    // n_clusters is a multiple of 16: a half-warp is one group, all in
    // range or all out
    const unsigned bits = __ballot_sync(0xffffffffu, enter);
    if (c < n_clusters) {
      cmask[static_cast<size_t>(blockIdx.x) * n_clusters + c] = enter;
      if ((lane & 15) == 0)
        gmask[static_cast<size_t>(blockIdx.x) * n_groups + c / kGroup] =
            ((bits >> lane) & 0xffffu) != 0;
    }
  }
}

// Bit k set where cluster k of group g is entered: the group's 16 mask
// bytes as one 16-byte load (rows of Cg bytes, Cg a multiple of 16).
__device__ __forceinline__ unsigned group_bits(const unsigned char* cm,
                                               int g) {
  const uint4 q = reinterpret_cast<const uint4*>(cm)[g];
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
  for (int k = 0; k < kGroup; ++k)
    if ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
  return bits;
}

// A lane's ray as the sweeps read it: the ray and its reciprocals, and
// whether it votes (a ray below n_rays whose six components are finite).
struct LaneRay {
  RayInv q;
  bool votes;
};

__device__ __forceinline__ LaneRay lane_ray(const float* o, const float* d,
                                            int i, bool live) {
  LaneRay l;
  l.q.r = load_ray(o, d, live ? i : 0);
  l.q.ix = safe_inv(l.q.r.dx);
  l.q.iy = safe_inv(l.q.r.dy);
  l.q.iz = safe_inv(l.q.r.dz);
  l.votes = live && isfinite(l.q.r.ox) && isfinite(l.q.r.oy) &&
            isfinite(l.q.r.oz) && isfinite(l.q.r.dx) && isfinite(l.q.r.dy) &&
            isfinite(l.q.r.dz);
  return l;
}

// The lane's vote for box [lo, hi]: its own slab test enters it.
__device__ __forceinline__ bool vote(const LaneRay& l, float lx, float ly,
                                     float lz, float hx, float hy,
                                     float hz) {
  float t_lo, t_hi;
  slab(l.q, lx, ly, lz, hx, hy, hz, t_lo, t_hi);
  return l.votes && t_hi >= t_lo && t_hi >= 0.f;
}

// The warp's vote for the box held as (lo xyz, hi x), (hi yz, -, -) by
// lane k in a and b.
__device__ __forceinline__ bool warp_vote(const LaneRay& l, float4 a,
                                          float4 b, int k) {
  return __any_sync(
      kFull, vote(l, __shfl_sync(kFull, a.x, k), __shfl_sync(kFull, a.y, k),
                  __shfl_sync(kFull, a.z, k), __shfl_sync(kFull, a.w, k),
                  __shfl_sync(kFull, b.x, k), __shfl_sync(kFull, b.y, k)));
}

// A warp's walk over its ray block's entered groups: the chunk of 32
// groups at hand (its entered groups not yet voted on, and this lane's
// group box, group base + lane), then the admitted clusters of group g.
struct Walk {
  const unsigned char* gm;   // the ray block's group mask row
  const unsigned char* cm;   // and cluster mask row
  int n_groups, base, g;
  unsigned todo, adm;
  float4 box_a, box_b;
};

__device__ __forceinline__ Walk walk_start(const unsigned char* cmask,
                                           const unsigned char* gmask,
                                           int n_clusters, int blk) {
  Walk w;
  w.n_groups = n_clusters / kGroup;
  w.gm = gmask + static_cast<size_t>(blk) * w.n_groups;
  w.cm = cmask + static_cast<size_t>(blk) * n_clusters;
  w.base = -32;
  w.g = 0;
  w.todo = w.adm = 0u;
  w.box_a = w.box_b = make_float4(0.f, 0.f, 0.f, 0.f);
  return w;
}

// The walk's next admitted cluster, or -1 at its end (all lanes,
// converged: the result is the warp's).
__device__ __forceinline__ int next_cluster(Walk& w, const LaneRay& l,
                                            const float* __restrict__ gbox,
                                            const float* __restrict__ cbox) {
  const int lane = threadIdx.x & 31;
  while (!w.adm) {
    while (!w.todo) {
      w.base += 32;
      if (w.base >= w.n_groups) return -1;
      const int g = w.base + lane;
      const bool in = g < w.n_groups;
      if (in) {
        const float4* gb = reinterpret_cast<const float4*>(gbox) +
                           2 * static_cast<size_t>(g);
        w.box_a = __ldg(gb);
        w.box_b = __ldg(gb + 1);
      }
      w.todo = __ballot_sync(kFull, in && __ldg(w.gm + g) != 0);
    }
    const int k = __ffs(w.todo) - 1;
    w.todo &= w.todo - 1;
    if (!warp_vote(l, w.box_a, w.box_b, k)) continue;
    w.g = w.base + k;
    const unsigned bits = group_bits(w.cm, w.g);
    // lane j holds float4 j of the group's boxes: box j / 2, a half each
    const float4 b = __ldg(reinterpret_cast<const float4*>(cbox) +
                           static_cast<size_t>(w.g) * 2 * kGroup + lane);
    const float4 b2 = make_float4(__shfl_down_sync(kFull, b.x, 1),
                                  __shfl_down_sync(kFull, b.y, 1), 0.f, 0.f);
    unsigned adm = 0u;
    for (unsigned m = bits; m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      if (warp_vote(l, b, b2, 2 * c)) adm |= 1u << c;
    }
    w.adm = adm;
  }
  const int c = __ffs(w.adm) - 1;
  w.adm &= w.adm - 1;
  return w.g * kGroup + c;
}

// Start the copy of cluster c's 16 rows (kSlot float4) into a ring slot.
__device__ __forceinline__ void prefetch_cluster(float4* slot,
                                                 const float* rows, int c) {
  const int lane = threadIdx.x & 31;
  const float4* src =
      reinterpret_cast<const float4*>(rows) + static_cast<size_t>(c) * kSlot;
  cp_async16(slot + lane, src + lane);
  if (lane < kSlot - 32) cp_async16(slot + 32 + lane, src + 32 + lane);
}

template <class Test>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinBlocks)
closest_kernel(const float* __restrict__ ctab,
               const float* __restrict__ rows,
               const float* __restrict__ cbox,
               const float* __restrict__ gbox,
               const unsigned char* __restrict__ cmask,
               const unsigned char* __restrict__ gmask, int n_clusters,
               const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, float t_min, float* __restrict__ out_t,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_tri, int* __restrict__ out_inst,
               unsigned char* __restrict__ out_back) {
  __shared__ float4 ring[kSweepWarps][2][kSlot];
  const int warp = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (warp * 32 >= n_rays) return;   // the whole warp lies past the rays
  const int i = warp * 32 + (threadIdx.x & 31);
  const bool live = i < n_rays;
  const LaneRay l = lane_ray(o, d, i, live);
  const typename Test::Pre pre = Test::prepare(l.q.r);
  float4(*slot)[kSlot] = ring[threadIdx.x >> 5];
  Walk w = walk_start(cmask, gmask, n_clusters, warp / kWarps);
  Hit best{kBig, 0.f, 0.f, false};
  int best_j = -1;
  int c = next_cluster(w, l, gbox, cbox);
  if (c >= 0) prefetch_cluster(slot[0], rows, c);
  cp_async_commit();
  for (int s = 0; c >= 0; s ^= 1) {
    const int c2 = next_cluster(w, l, gbox, cbox);
    if (c2 >= 0) prefetch_cluster(slot[s ^ 1], rows, c2);
    cp_async_commit();
    cp_async_wait<1>();   // cluster c's rows have landed
    __syncwarp();
    const float4* t = slot[s];
#pragma unroll 4
    for (int j = 0; j < kClusterRows; ++j) {
      Hit h;
      if (Test::test(l.q.r, pre, t[3 * j], t[3 * j + 1], t[3 * j + 2], t_min,
                     best.t, h)) {
        best = h;
        best_j = c * kClusterRows + j;
      }
    }
    __syncwarp();         // the slot is read before it is refilled
    c = c2;
  }
  if (!live) return;
  float r[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (best_j >= 0) load_row(ctab, best_j, r);
  out_t[i] = best_j >= 0 ? best.t : INFINITY;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = static_cast<int>(r[9]);
  out_inst[i] = static_cast<int>(r[10]);
  out_back[i] = best_j >= 0 && (best.back != (r[11] > 0.5f));
}

template <class Test>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinBlocks)
any_kernel(const float* __restrict__ rows, const float* __restrict__ cbox,
           const float* __restrict__ gbox,
           const unsigned char* __restrict__ cmask,
           const unsigned char* __restrict__ gmask, int n_clusters,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, int n_rays, float t_min,
           unsigned char* __restrict__ out_occ) {
  __shared__ float4 ring[kSweepWarps][2][kSlot];
  const int warp = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (warp * 32 >= n_rays) return;
  const int i = warp * 32 + (threadIdx.x & 31);
  const bool live = i < n_rays;
  const LaneRay l = lane_ray(o, d, i, live);
  const typename Test::Pre pre = Test::prepare(l.q.r);
  const float tmax = live ? t_max[i] : 0.f;
  float4(*slot)[kSlot] = ring[threadIdx.x >> 5];
  Walk w = walk_start(cmask, gmask, n_clusters, warp / kWarps);
  // every lane votes to the end, done or not: the admission is the rule's
  bool done = !live, occluded = false;
  int c = next_cluster(w, l, gbox, cbox);
  if (c >= 0) prefetch_cluster(slot[0], rows, c);
  cp_async_commit();
  for (int s = 0; c >= 0 && !__all_sync(kFull, done); s ^= 1) {
    const int c2 = next_cluster(w, l, gbox, cbox);
    if (c2 >= 0) prefetch_cluster(slot[s ^ 1], rows, c2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const float4* t = slot[s];
    for (int j = 0; j < kClusterRows && !done; ++j) {
      Hit h;
      if (Test::test(l.q.r, pre, t[3 * j], t[3 * j + 1], t[3 * j + 2], t_min,
                     tmax, h))
        occluded = done = true;
    }
    __syncwarp();
    c = c2;
  }
  cp_async_wait<0>();     // no copy in flight into a finished warp's ring
  if (live) out_occ[i] = occluded;
}

inline dim3 sweep_grid(int n_rays) {
  return dim3((n_rays + kSweepThreads - 1) / kSweepThreads);
}

// Whether the sweeps take n_clusters: a positive multiple of kGroup.
inline bool whole_groups(int n_clusters) {
  return n_clusters > 0 && n_clusters % kGroup == 0;
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t; n_clusters is Cg, a multiple of 16. Each returns
// cudaGetLastError() after the launch; the sweeps return
// cudaErrorInvalidValue, and launch nothing, for a Cg they cannot take.

extern "C" int dcrt_cluster_cull(const float* cbox, int n_clusters,
                                 const float* o, const float* d, int n_rays,
                                 float lo_x, float lo_y, float lo_z,
                                 float hi_x, float hi_y, float hi_z,
                                 unsigned char* cmask, unsigned char* gmask,
                                 void* stream) {
  if (n_rays > 0) {
    const Reach reach{{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
    const dim3 grid((n_rays + kRayBlock - 1) / kRayBlock);
    cull_kernel<<<grid, kRayBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        cbox, n_clusters, o, d, n_rays, reach, cmask, gmask);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_cluster_closest(
    const float* ctab, const float* rows, const float* cbox,
    const float* gbox, const unsigned char* cmask,
    const unsigned char* gmask, int n_clusters, const float* o,
    const float* d, int n_rays, float t_min, int watertight, float* t,
    float* u, float* v, int* tri, int* inst, unsigned char* back,
    void* stream) {
  if (!whole_groups(n_clusters))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      closest_kernel<Watertight><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, rows, cbox, gbox, cmask, gmask, n_clusters, o, d, n_rays,
          t_min, t, u, v, tri, inst, back);
    else
      closest_kernel<Moeller><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, rows, cbox, gbox, cmask, gmask, n_clusters, o, d, n_rays,
          t_min, t, u, v, tri, inst, back);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_cluster_any(const float* rows, const float* cbox,
                                const float* gbox, const unsigned char* cmask,
                                const unsigned char* gmask, int n_clusters,
                                const float* o, const float* d,
                                const float* t_max, int n_rays, float t_min,
                                int watertight, unsigned char* occluded,
                                void* stream) {
  if (!whole_groups(n_clusters))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_kernel<Watertight><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          rows, cbox, gbox, cmask, gmask, n_clusters, o, d, t_max, n_rays,
          t_min, occluded);
    else
      any_kernel<Moeller><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          rows, cbox, gbox, cmask, gmask, n_clusters, o, d, t_max, n_rays,
          t_min, occluded);
  }
  return static_cast<int>(cudaGetLastError());
}

// The sweeps' resources on this card, five ints per kernel in the order
// closest Moeller, closest watertight, any-hit Moeller, any-hit
// watertight: resident blocks per SM, registers, static shared bytes,
// local (spill) bytes per thread, threads per block.
extern "C" int dcrt_cluster_resources(int* out) {
  constexpr int kFns = 4;
  const void* fns[kFns] = {
      reinterpret_cast<const void*>(closest_kernel<Moeller>),
      reinterpret_cast<const void*>(closest_kernel<Watertight>),
      reinterpret_cast<const void*>(any_kernel<Moeller>),
      reinterpret_cast<const void*>(any_kernel<Watertight>)};
  for (int f = 0; f < kFns; ++f) {
    cudaFuncAttributes a;
    cudaError_t err;
    if ((err = cudaFuncGetAttributes(&a, fns[f])) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             out + 5 * f, fns[f], kSweepThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = kSweepThreads;
  }
  return static_cast<int>(cudaGetLastError());
}
