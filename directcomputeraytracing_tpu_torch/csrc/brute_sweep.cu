// Dense ray sweep over a world-space triangle soup, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of directcomputeraytracing_tpu/accel/
// pallas_brute.py: _closest_kernel (:128, launched by brute_closest_pallas
// :222) and _any_kernel (:179, launched by brute_any_pallas :255), and
// keeps their contracts:
//   closest: (t, +inf on miss; u; v; tri i32; inst i32; back bool), the
//            first triangle in table order among those at the minimum t;
//   any:     occluded bool, a hit in [t_min, t_max[ray]).
// The table is the (B, 12) f32 soup [v0 v1 v2 | tri id | inst id | flip]
// (accel/brute.py:build_table); rays are (R, 3) f32 origins and directions.
//
// What bounds it: FP32 ALU. A Moeller test is about 30 flops plus one IEEE
// division, the watertight test about twice that; at 1M rays x 2048
// triangles that is ~6e10 flops against ~40 MB of memory traffic (rays
// once from HBM, the table once per block from L2).
//
// Design: one thread per ray keeps its best hit in registers. Each block
// stages the table through shared memory in 128-triangle tiles that all
// its threads read by broadcast (for Moeller the tile holds v0 and the two
// edges, so the edges are computed once per block, not once per ray).
// Triangles are visited in index order and a hit replaces the best only
// when strictly nearer, which is the reference's first-minimum tie rule.
// An any-hit thread stops at its first hit, and a block stops loading
// tiles once all of its rays are resolved. The tail block masks rays past
// R; nothing is padded. The library is built with -fmad=false, so every
// product and sum rounds as in the PyTorch twin (accel/brute.py) and the
// kernel and its twin agree bit for bit. The tests themselves live in
// ray_tri.cuh, shared with worklist.cu.

#include <cuda_runtime.h>
#include <math.h>

#include "ray_tri.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;

using dcrt::Hit;
using dcrt::kBig;
using dcrt::load_ray;
using dcrt::load_row;
using dcrt::Moeller;
using dcrt::Ray;
using dcrt::Watertight;

// Stage tile [base, base + n) of the table into shared memory.
template <class Test>
__device__ __forceinline__ void stage_tile(const float* tab, int base, int n,
                                           float4 (*tile)[3]) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    float r[12];
    load_row(tab, base + k, r);
    Test::stage(r, tile[k]);
  }
}

template <class Test>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ tab, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, float t_min, float* __restrict__ out_t,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_tri, int* __restrict__ out_inst,
               unsigned char* __restrict__ out_back) {
  __shared__ float4 tile[kTile][3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  const Ray ray = load_ray(o, d, live ? i : 0);
  const typename Test::Pre pre = Test::prepare(ray);
  Hit best{kBig, 0.f, 0.f, false};
  int best_j = -1;
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    __syncthreads();  // the previous tile is no longer read
    stage_tile<Test>(tab, base, n, tile);
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        Hit h;
        if (Test::test(ray, pre, tile[k][0], tile[k][1], tile[k][2], t_min,
                       best.t, h)) {
          best = h;
          best_j = base + k;
        }
      }
    }
  }
  if (!live) return;
  float r[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (best_j >= 0) load_row(tab, best_j, r);
  out_t[i] = best_j >= 0 ? best.t : INFINITY;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = static_cast<int>(r[9]);
  out_inst[i] = static_cast<int>(r[10]);
  out_back[i] = best_j >= 0 && (best.back != (r[11] > 0.5f));
}

template <class Test>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ tab, int n_tris,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, int n_rays, float t_min,
           unsigned char* __restrict__ out_occ) {
  __shared__ float4 tile[kTile][3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  const Ray ray = load_ray(o, d, live ? i : 0);
  const typename Test::Pre pre = Test::prepare(ray);
  const float tmax = live ? t_max[i] : 0.f;
  bool done = !live, occluded = false;
  for (int base = 0; base < n_tris; base += kTile) {
    // doubles as the barrier before the tile is overwritten
    if (__syncthreads_and(done)) break;
    const int n = min(kTile, n_tris - base);
    stage_tile<Test>(tab, base, n, tile);
    __syncthreads();
    for (int k = 0; k < n && !done; ++k) {
      Hit h;
      if (Test::test(ray, pre, tile[k][0], tile[k][1], tile[k][2], t_min,
                     tmax, h)) {
        occluded = done = true;
      }
    }
  }
  if (live) out_occ[i] = occluded;
}

inline dim3 grid_for(int n_rays) {
  return dim3((n_rays + kThreads - 1) / kThreads);
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after the launch.

extern "C" int dcrt_brute_closest(const float* tab, int n_tris, const float* o,
                                  const float* d, int n_rays, float t_min,
                                  int watertight, float* t, float* u, float* v,
                                  int* tri, int* inst, unsigned char* back,
                                  void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      closest_kernel<Watertight><<<grid_for(n_rays), kThreads, 0, s>>>(
          tab, n_tris, o, d, n_rays, t_min, t, u, v, tri, inst, back);
    else
      closest_kernel<Moeller><<<grid_for(n_rays), kThreads, 0, s>>>(
          tab, n_tris, o, d, n_rays, t_min, t, u, v, tri, inst, back);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_brute_any(const float* tab, int n_tris, const float* o,
                              const float* d, const float* t_max, int n_rays,
                              float t_min, int watertight,
                              unsigned char* occluded, void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_kernel<Watertight><<<grid_for(n_rays), kThreads, 0, s>>>(
          tab, n_tris, o, d, t_max, n_rays, t_min, occluded);
    else
      any_kernel<Moeller><<<grid_for(n_rays), kThreads, 0, s>>>(
          tab, n_tris, o, d, t_max, n_rays, t_min, occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
