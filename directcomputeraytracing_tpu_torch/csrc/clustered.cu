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
//                     over the clusters the ray's block entered;
//   any_kernel     <- _clustered_any_kernel (:508), launched by
//                     clustered_any_pallas (:601): occluded bool, a hit in
//                     [t_min, t_max[ray]) in a cluster the block entered.
// Inputs (accel/clustered.py): the (Cg * 16, 12) f32 cluster table [v0 v1
// v2 | tri id | inst id | flip], Cg clusters a multiple of 16 (a group of
// 16 clusters is 256 rows; padding rows are zero and never hit), the
// (Cg, 8) cluster boxes [bmin | bmax | 0 0], and (R, 3) f32 origins and
// directions. A ray block is 1024 consecutive rays; the masks are
// (n_blocks, Cg) and (n_blocks, Cg / 16) uint8.
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
// closest_kernel / any_kernel. Bound: FP32 ALU, one triangle test (about
// 45 operations, Moeller) per ray and row of each cluster its block
// entered. 256 threads, a quarter of a ray block, one ray per thread. The
// block walks the groups in order and skips one whose group mask is 0
// (the same byte for every thread: a uniform branch). For an entered
// group it stages the rows of the entered clusters into shared memory
// (one row per thread; for Moeller v0 and the two edges), then each
// thread tests them cluster by cluster, row by row, in ascending order,
// with its current best as t_max: a row replaces the best only when
// strictly nearer, which is the reference's first-minimum rule. An
// any-hit thread stops at its first hit, and the block stops once all of
// its rays are resolved. Built with -fmad=false, like brute_sweep.cu, so
// the kernels and their PyTorch twins (accel/clustered.py) agree bit for
// bit. A simple kernel, not tuned.

#include <cuda_runtime.h>
#include <math.h>

#include "ray_tri.cuh"

namespace {

constexpr int kRayBlock = 1024;   // rays per mask row (clustered.RAY_BLOCK)
constexpr int kGroup = 16;        // clusters per group (CLUSTER_GROUP)
constexpr int kClusterRows = 16;  // rows per cluster (CLUSTER_SIZE)
constexpr int kGroupRows = kGroup * kClusterRows;
constexpr int kSweepThreads = 256;
constexpr int kWarps = kRayBlock / 32;

static_assert(kSweepThreads == kGroupRows, "one staged row per thread");
static_assert(kRayBlock % kSweepThreads == 0, "whole ray blocks");
static_assert(kWarps == 32, "one warp reduces the per-warp bounds");

using dcrt::Hit;
using dcrt::kBig;
using dcrt::load_ray;
using dcrt::load_row;
using dcrt::Moeller;
using dcrt::Ray;
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

// Stage the rows of the entered clusters of group g, one row per thread.
template <class Test>
__device__ __forceinline__ void stage_group(const float* ctab, int g,
                                            unsigned bits,
                                            float4 (*tile)[3]) {
  const int k = threadIdx.x;
  if ((bits >> (k / kClusterRows)) & 1u) {
    float r[12];
    load_row(ctab, g * kGroupRows + k, r);
    Test::stage(r, tile[k]);
  }
}

template <class Test>
__global__ void __launch_bounds__(kSweepThreads)
closest_kernel(const float* __restrict__ ctab,
               const unsigned char* __restrict__ cmask,
               const unsigned char* __restrict__ gmask, int n_clusters,
               const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, float t_min, float* __restrict__ out_t,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_tri, int* __restrict__ out_inst,
               unsigned char* __restrict__ out_back) {
  __shared__ float4 tile[kGroupRows][3];
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  const int blk = blockIdx.x / (kRayBlock / kSweepThreads);
  const bool live = i < n_rays;
  const Ray ray = load_ray(o, d, live ? i : 0);
  const typename Test::Pre pre = Test::prepare(ray);
  const int n_groups = n_clusters / kGroup;
  const unsigned char* gm = gmask + static_cast<size_t>(blk) * n_groups;
  const unsigned char* cm = cmask + static_cast<size_t>(blk) * n_clusters;
  Hit best{kBig, 0.f, 0.f, false};
  int best_j = -1;
  for (int g = 0; g < n_groups; ++g) {
    if (!gm[g]) continue;
    const unsigned bits = group_bits(cm, g);
    __syncthreads();  // the previous group's tile is no longer read
    stage_group<Test>(ctab, g, bits, tile);
    __syncthreads();
    if (!live) continue;
    for (unsigned m = bits; m; m &= m - 1) {
      const int base = (__ffs(m) - 1) * kClusterRows;
#pragma unroll 4
      for (int j = base; j < base + kClusterRows; ++j) {
        Hit h;
        if (Test::test(ray, pre, tile[j][0], tile[j][1], tile[j][2], t_min,
                       best.t, h)) {
          best = h;
          best_j = g * kGroupRows + j;
        }
      }
    }
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
__global__ void __launch_bounds__(kSweepThreads)
any_kernel(const float* __restrict__ ctab,
           const unsigned char* __restrict__ cmask,
           const unsigned char* __restrict__ gmask, int n_clusters,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, int n_rays, float t_min,
           unsigned char* __restrict__ out_occ) {
  __shared__ float4 tile[kGroupRows][3];
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  const int blk = blockIdx.x / (kRayBlock / kSweepThreads);
  const bool live = i < n_rays;
  const Ray ray = load_ray(o, d, live ? i : 0);
  const typename Test::Pre pre = Test::prepare(ray);
  const float tmax = live ? t_max[i] : 0.f;
  const int n_groups = n_clusters / kGroup;
  const unsigned char* gm = gmask + static_cast<size_t>(blk) * n_groups;
  const unsigned char* cm = cmask + static_cast<size_t>(blk) * n_clusters;
  bool done = !live, occluded = false;
  for (int g = 0; g < n_groups; ++g) {
    if (!gm[g]) continue;
    // doubles as the barrier before the tile is overwritten
    if (__syncthreads_and(done)) break;
    const unsigned bits = group_bits(cm, g);
    stage_group<Test>(ctab, g, bits, tile);
    __syncthreads();
    for (unsigned m = bits; m && !done; m &= m - 1) {
      const int base = (__ffs(m) - 1) * kClusterRows;
      for (int j = base; j < base + kClusterRows; ++j) {
        Hit h;
        if (Test::test(ray, pre, tile[j][0], tile[j][1], tile[j][2], t_min,
                       tmax, h)) {
          occluded = done = true;
          break;
        }
      }
    }
  }
  if (live) out_occ[i] = occluded;
}

inline dim3 sweep_grid(int n_rays) {
  return dim3((n_rays + kSweepThreads - 1) / kSweepThreads);
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t; n_clusters is Cg, a multiple of 16. Each returns
// cudaGetLastError() after the launch.

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

extern "C" int dcrt_cluster_closest(const float* ctab,
                                    const unsigned char* cmask,
                                    const unsigned char* gmask,
                                    int n_clusters, const float* o,
                                    const float* d, int n_rays, float t_min,
                                    int watertight, float* t, float* u,
                                    float* v, int* tri, int* inst,
                                    unsigned char* back, void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      closest_kernel<Watertight><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, cmask, gmask, n_clusters, o, d, n_rays, t_min, t, u, v, tri,
          inst, back);
    else
      closest_kernel<Moeller><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, cmask, gmask, n_clusters, o, d, n_rays, t_min, t, u, v, tri,
          inst, back);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_cluster_any(const float* ctab, const unsigned char* cmask,
                                const unsigned char* gmask, int n_clusters,
                                const float* o, const float* d,
                                const float* t_max, int n_rays, float t_min,
                                int watertight, unsigned char* occluded,
                                void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_kernel<Watertight><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, cmask, gmask, n_clusters, o, d, t_max, n_rays, t_min,
          occluded);
    else
      any_kernel<Moeller><<<sweep_grid(n_rays), kSweepThreads, 0, s>>>(
          ctab, cmask, gmask, n_clusters, o, d, t_max, n_rays, t_min,
          occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
