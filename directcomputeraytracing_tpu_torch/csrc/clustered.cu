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
// cull_kernel. Each ray block's bounds are the min and max of origin and
// direction per axis over its rays that can reach the scene: finite, a
// non-zero direction, and its own slab test enters the reach box (the
// union of the cluster boxes, widened), so that parked lanes (2e9 along
// +x) and rays past the scene cannot stretch the bundle over the whole
// scene. Sound: a ray left out of the bounds misses the reach box, so by
// monotone rounding its slab test misses every cluster box inside it and
// it has no hit to lose. Then each (ray block, cluster) pair runs the
// reference's interval test: per axis where the bundle's direction does
// not span zero (`spans`: d_lo <= 0 <= d_hi), the 1e-30 nudged
// reciprocals i_a, i_b of the direction endpoints, i_lo = min, i_hi =
// max, the eight products of the numerators n in {b0, b1} - {o_lo, o_hi}
// with them, ax_lo = their min and ax_hi = their max folded into t_lo
// and t_hi from -kBig and kBig; enter = (t_hi >= t_lo) & (t_hi >= 0).
// The first port ran a 1024-thread CUDA block a ray block: each read the
// whole box table (16k clusters x 32 bytes, 0.5 GB through L2 for 2^20
// rays) and ran 8 products and 14 min/max an axis a pair, on the ALU
// pipe that issues at half the FP32 rate. Here:
// - A cluster of kCullBundles CUDA blocks (thread block cluster, Hopper)
//   takes kCullBundles consecutive ray blocks. Block y of the cluster
//   reduces the bounds of ray block 8x + y (a ray a thread, 4 a thread
//   in all, warp shuffles, then the 8 warps), the cluster meets at a
//   barrier, and every block reads the 8 bundles' bounds from its peers'
//   shared memory (distributed shared memory) and derives each axis's
//   constants once. Block y then takes slice y of the clusters (whole
//   groups), so a ray is read once and a box once per 8 ray blocks.
// - A thread takes 4 consecutive clusters at a time: two float4 loads a
//   box, each box's per-axis min and max corner (bmin, bmax) once, then
//   each of the 8 bundles against the 4 boxes: the 4 enter bytes as one
//   32-bit store, the group mask (4 lanes hold a group of 16) from a
//   ballot.
// - Per non-spanning axis 2 products and 2 min/max in place of 8 and 14.
//   Proof. The bundle's d_lo and d_hi are finite (only reaching rays are
//   in it) and do not span zero, so both are > 0 or both < 0, and so are
//   i_lo and i_hi: safe_inv keeps the sign and gives a finite non-zero
//   number (+-1e30 at most). The numerators are finite or +-inf (a
//   rounded difference of finite numbers may overflow), never NaN, and a
//   product of one with a finite non-zero i is no NaN either. Rounded
//   subtraction and multiplication are monotone: n -> n * i does not
//   fall with n for i > 0 and does not rise for i < 0, and x - y does not
//   fall with x nor rise with y. So for each i the least of n * i over
//   the four numerators is e * i with e = min(b0, b1) - o_hi (the least
//   numerator) where i > 0, and e = max(b0, b1) - o_lo (the greatest)
//   where i < 0; both i share a sign, so one e serves both, and ax_lo =
//   fminf(e * i_lo, e * i_hi). Likewise ax_hi = fmaxf(e' * i_lo, e' *
//   i_hi) with e' the other endpoint. Inverted padding boxes (b0 > b1)
//   take min(b0, b1) and max(b0, b1), as the eight products do. Every
//   value is one of the eight products and no NaN is compared, so ax_lo
//   and ax_hi equal the reference's but for the sign of a zero, and only
//   the mask, a comparison of them, is an output. A ray block with no
//   reaching ray (min > max: lo = +inf, hi = -inf) has no numbers to
//   test; its rows are all zero, as the twin's `lo <= hi` gate makes
//   them.
// Bound (tools/clustered_ab.py cull_bound): per (ray block, cluster) of a
// block with a reaching ray, 10 operations per non-spanning axis (2
// differences, 4 products and 4 min/max) and 3 for enter, 33 at most
// where the reference's count is 87 (FLOPS_INTERVAL, kept beside it);
// 24 bytes a ray, 32 a box and a byte a mask entry moved once.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "worklist.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRayBlock = 1024;   // rays per mask row (clustered.RAY_BLOCK)
constexpr int kGroup = 16;        // clusters per group (CLUSTER_GROUP)
constexpr int kClusterRows = 16;  // rows per cluster (CLUSTER_SIZE)
constexpr int kWarps = kRayBlock / 32;   // warps of a ray block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCullBundles = 8;   // ray blocks of a thread block cluster
constexpr int kCullThreads = 256;                        // a cull block's
constexpr int kCullWarps = kCullThreads / 32;
constexpr int kCullRays = kRayBlock / kCullThreads;      // rays a thread
constexpr int kCullBoxes = 4;     // consecutive clusters a thread tests
constexpr int kCullSpan = kCullThreads * kCullBoxes;     // clusters a pass
constexpr int kSpans = 0, kPos = 1, kNeg = 2;            // an axis's sign
constexpr int kSweepThreads = 128;               // threads per CUDA block
constexpr int kSweepMinBlocks = 8;               // resident per SM
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSlot = 3 * kClusterRows;          // float4 of a cluster's rows

static_assert(kCullBoxes == 4, "a thread's enter bytes are one word");
static_assert(kGroup % kCullBoxes == 0, "whole groups of lanes");
static_assert(kCullBundles <= kCullThreads, "a thread reads a bundle");
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

// The min and max of the 12 bounds over a warp (min o, min d, then max
// o, max d).
__device__ __forceinline__ void warp_bounds(float b[12]) {
  for (int off = 16; off > 0; off >>= 1)
    for (int k = 0; k < 6; ++k) {
      b[k] = fminf(b[k], __shfl_xor_sync(kFull, b[k], off));
      b[6 + k] = fmaxf(b[6 + k], __shfl_xor_sync(kFull, b[6 + k], off));
    }
}

// One axis of a (ray block, box) pair from the bundle's constants a =
// (o_lo, o_hi, i_lo, i_hi) and the box's min and max corner: the
// endpoint numerators by the axis's sign, 2 products each (see the
// header), folded into the entry and exit.
template <int kSign>
__device__ __forceinline__ void axis_fold(const float4& a, float bmin,
                                          float bmax, float& t_lo,
                                          float& t_hi) {
  const float e_lo = kSign == kPos ? bmin - a.y : bmax - a.x;
  const float e_hi = kSign == kPos ? bmax - a.x : bmin - a.y;
  t_lo = fmaxf(t_lo, fminf(e_lo * a.z, e_lo * a.w));
  t_hi = fminf(t_hi, fmaxf(e_hi * a.z, e_hi * a.w));
}

__global__ void __cluster_dims__(1, kCullBundles, 1)
    __launch_bounds__(kCullThreads)
cull_kernel(const float* __restrict__ cbox, int n_clusters,
            const float* __restrict__ o, const float* __restrict__ d,
            int n_rays, Reach reach, unsigned char* __restrict__ cmask,
            unsigned char* __restrict__ gmask) {
  __shared__ float s_warp[kCullWarps][12];
  __shared__ float s_bounds[12];   // this block's ray block: min o, min d,
                                   // max o, max d
  __shared__ float4 s_axis[kCullBundles][3];   // o_lo, o_hi, i_lo, i_hi
  __shared__ int s_sign[kCullBundles][3];      // kSpans, kPos or kNeg
  __shared__ int s_any[kCullBundles];          // a ray reaches the scene
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = static_cast<int>((static_cast<long long>(n_rays) +
                                   kRayBlock - 1) / kRayBlock);
  const int rb0 = blockIdx.x * kCullBundles;
  // 1. the bounds of ray block rb0 + rank over its reaching rays
  float b[12];
  for (int k = 0; k < 6; ++k) {
    b[k] = INFINITY;
    b[6 + k] = -INFINITY;
  }
  for (int j = 0; j < kCullRays; ++j) {
    const long long i = static_cast<long long>(rb0 + rank) * kRayBlock +
                        j * kCullThreads + tid;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < n_rays)
      for (int k = 0; k < 3; ++k) {
        v[k] = __ldg(o + 3 * i + k);
        v[3 + k] = __ldg(d + 3 * i + k);
      }
    if (i < n_rays && reaches(v, reach))
      for (int k = 0; k < 6; ++k) {
        b[k] = fminf(b[k], v[k]);
        b[6 + k] = fmaxf(b[6 + k], v[k]);
      }
  }
  warp_bounds(b);
  if (lane == 0)
    for (int k = 0; k < 12; ++k) s_warp[warp][k] = b[k];
  __syncthreads();
  if (tid < 12) {
    float x = s_warp[0][tid];
    for (int w = 1; w < kCullWarps; ++w)
      x = tid < 6 ? fminf(x, s_warp[w][tid]) : fmaxf(x, s_warp[w][tid]);
    s_bounds[tid] = x;
  }
  cluster.sync();   // every block's bounds are written
  // each bundle's axis constants, from its block's shared memory
  if (tid < kCullBundles) {
    const float* pb = cluster.map_shared_rank(s_bounds, tid);
    float lo[6], hi[6];
    for (int k = 0; k < 6; ++k) {
      lo[k] = pb[k];
      hi[k] = pb[6 + k];
    }
    // no ray of the block reaches the scene: min > max, nothing entered
    s_any[tid] = lo[0] <= hi[0];
    for (int ax = 0; ax < 3; ++ax) {
      const float d_lo = lo[3 + ax], d_hi = hi[3 + ax];
      const float i_a = safe_inv(d_lo), i_b = safe_inv(d_hi);
      s_axis[tid][ax] =
          make_float4(lo[ax], hi[ax], fminf(i_a, i_b), fmaxf(i_a, i_b));
      s_sign[tid][ax] = d_lo <= 0.f && d_hi >= 0.f ? kSpans
                        : d_lo > 0.f               ? kPos
                                                   : kNeg;
    }
  }
  cluster.sync();   // the peers' bounds are read; the constants visible
  // 2. slice `rank` of the clusters (whole groups) against the bundles
  const int n_groups = n_clusters / kGroup;
  const int per = (n_groups + kCullBundles - 1) / kCullBundles * kGroup;
  const int c_lo = rank * per, c_hi = min(n_clusters, c_lo + per);
  const int n_bund = min(kCullBundles, nb - rb0);
  const float4* box4 = reinterpret_cast<const float4*>(cbox);
  // a warp's clusters are consecutive, so its loop is uniform
  for (int cw = c_lo + warp * 32 * kCullBoxes; cw < c_hi; cw += kCullSpan) {
    const int c0 = cw + lane * kCullBoxes;
    const bool in = c0 < c_hi;   // all 4 lanes of a group alike
    float bmin[kCullBoxes][3], bmax[kCullBoxes][3];
#pragma unroll
    for (int k = 0; k < kCullBoxes; ++k) {
      // [lo xyz, hi x], [hi yz, 0 0]
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;
      if (in) {
        p = __ldg(box4 + 2 * static_cast<size_t>(c0 + k));
        q = __ldg(box4 + 2 * static_cast<size_t>(c0 + k) + 1);
      }
      bmin[k][0] = fminf(p.x, p.w);
      bmax[k][0] = fmaxf(p.x, p.w);
      bmin[k][1] = fminf(p.y, q.x);
      bmax[k][1] = fmaxf(p.y, q.x);
      bmin[k][2] = fminf(p.z, q.y);
      bmax[k][2] = fmaxf(p.z, q.y);
    }
    for (int bu = 0; bu < n_bund; ++bu) {
      unsigned word = 0u;
      if (s_any[bu] && in) {
        float t_lo[kCullBoxes], t_hi[kCullBoxes];
#pragma unroll
        for (int k = 0; k < kCullBoxes; ++k) {
          t_lo[k] = -kBig;
          t_hi[k] = kBig;
        }
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const int sign = s_sign[bu][ax];   // uniform: no divergence
          const float4 a = s_axis[bu][ax];
          if (sign == kPos) {
#pragma unroll
            for (int k = 0; k < kCullBoxes; ++k)
              axis_fold<kPos>(a, bmin[k][ax], bmax[k][ax], t_lo[k], t_hi[k]);
          } else if (sign == kNeg) {
#pragma unroll
            for (int k = 0; k < kCullBoxes; ++k)
              axis_fold<kNeg>(a, bmin[k][ax], bmax[k][ax], t_lo[k], t_hi[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kCullBoxes; ++k)
          if (t_hi[k] >= t_lo[k] && t_hi[k] >= 0.f) word |= 1u << (8 * k);
      }
      const unsigned groups = __ballot_sync(kFull, word != 0u);
      if (in) {
        const size_t row = static_cast<size_t>(rb0 + bu);
        *reinterpret_cast<unsigned*>(cmask + row * n_clusters + c0) = word;
        if (lane % (kGroup / kCullBoxes) == 0)
          gmask[row * n_groups + c0 / kGroup] =
              ((groups >> lane) & 0xfu) != 0u;
      }
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
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, and
// launches nothing, for a Cg it cannot take (the cull also for a cmask
// that is not 4-byte aligned).

extern "C" int dcrt_cluster_cull(const float* cbox, int n_clusters,
                                 const float* o, const float* d, int n_rays,
                                 float lo_x, float lo_y, float lo_z,
                                 float hi_x, float hi_y, float hi_z,
                                 unsigned char* cmask, unsigned char* gmask,
                                 void* stream) {
  if (!whole_groups(n_clusters) || reinterpret_cast<uintptr_t>(cmask) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const Reach reach{{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
    const long long nb = (n_rays + kRayBlock - 1LL) / kRayBlock;
    const dim3 grid(static_cast<unsigned>((nb + kCullBundles - 1) /
                                          kCullBundles),
                    kCullBundles);
    cull_kernel<<<grid, kCullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// The kernels' resources on this card, five ints per kernel in the order
// cull, closest Moeller, closest watertight, any-hit Moeller, any-hit
// watertight: resident blocks per SM, registers, static shared bytes,
// local (spill) bytes per thread, threads per block. The cull launches
// clusters of kCullBundles blocks: its resident blocks per SM are the
// card's most active clusters times kCullBundles over the SM count,
// rounded down.
extern "C" int dcrt_cluster_resources(int* out) {
  constexpr int kFns = 5;
  const void* fns[kFns] = {
      reinterpret_cast<const void*>(cull_kernel),
      reinterpret_cast<const void*>(closest_kernel<Moeller>),
      reinterpret_cast<const void*>(closest_kernel<Watertight>),
      reinterpret_cast<const void*>(any_kernel<Moeller>),
      reinterpret_cast<const void*>(any_kernel<Watertight>)};
  const int threads[kFns] = {kCullThreads, kSweepThreads, kSweepThreads,
                             kSweepThreads, kSweepThreads};
  for (int f = 0; f < kFns; ++f) {
    cudaFuncAttributes a;
    cudaError_t err;
    if ((err = cudaFuncGetAttributes(&a, fns[f])) != cudaSuccess)
      return static_cast<int>(err);
    if (f == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, kCullBundles);
      cfg.blockDim = dim3(kCullThreads);
      int clusters = 0, dev = 0, sms = 1;
      if ((err = cudaGetDevice(&dev)) == cudaSuccess &&
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) == cudaSuccess &&
          (err = cudaOccupancyMaxActiveClusters(&clusters, fns[f], &cfg)) ==
              cudaSuccess)
        out[0] = clusters * kCullBundles / sms;
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5 * f, fns[f],
                                                          threads[f], 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = threads[f];
  }
  return static_cast<int>(cudaGetLastError());
}
