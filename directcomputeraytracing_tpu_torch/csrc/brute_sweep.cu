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
// kernel and its twin agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
             d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// Row k of the table as three float4: (v0 v1.x) (v1.yz v2.xy) (v2.z meta).
__device__ __forceinline__ void load_row(const float* tab, int k, float r[12]) {
  const float4* p = reinterpret_cast<const float4*>(tab) + 3 * k;
  const float4 a = p[0], b = p[1], c = p[2];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

struct Hit {
  float t, u, v;
  bool back;
};

// Moeller-Trumbore; the tile holds (v0, e1 = v1 - v0, e2 = v2 - v0).
struct Moeller {
  struct Pre {};
  __device__ static Pre prepare(const Ray&) { return Pre{}; }

  __device__ static void stage(const float r[12], float4* g) {
    g[0] = make_float4(r[0], r[1], r[2], 0.f);
    g[1] = make_float4(r[3] - r[0], r[4] - r[1], r[5] - r[2], 0.f);
    g[2] = make_float4(r[6] - r[0], r[7] - r[1], r[8] - r[2], 0.f);
  }

  __device__ static bool test(const Ray& r, const Pre&, float4 v0, float4 e1,
                              float4 e2, float t_min, float t_max, Hit& h) {
    // pvec = d x e2
    const float px = r.dy * e2.z - r.dz * e2.y;
    const float py = r.dz * e2.x - r.dx * e2.z;
    const float pz = r.dx * e2.y - r.dy * e2.x;
    const float det = e1.x * px + e1.y * py + e1.z * pz;
    const bool det_ok = fabsf(det) >= 1e-10f;
    const float inv_det = 1.0f / (det_ok ? det : 1.0f);
    const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    // qvec = tvec x e1
    const float qx = ty * e1.z - tz * e1.y;
    const float qy = tz * e1.x - tx * e1.z;
    const float qz = tx * e1.y - ty * e1.x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
    h = Hit{t, u, v, det > -1e-10f};
    return det_ok && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
           t >= t_min && t < t_max;
  }
};

__device__ __forceinline__ float pick(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

// PBRT watertight permute+shear test; the tile holds (v0, v1, v2) and, in
// v0.w, 1 for a degenerate triangle (zero cross product).
struct Watertight {
  struct Pre {
    int kx, ky, kz;
    float sx, sy, inv_z;
  };

  __device__ static Pre prepare(const Ray& r) {
    const float ax = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
    Pre p;
    p.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    p.kx = p.kz == 2 ? 0 : p.kz + 1;
    p.ky = p.kx == 2 ? 0 : p.kx + 1;
    const float d_z = pick(r.dx, r.dy, r.dz, p.kz);
    p.inv_z = 1.0f / (fabsf(d_z) < 1e-30f ? 1e-30f : d_z);
    p.sx = -pick(r.dx, r.dy, r.dz, p.kx) * p.inv_z;
    p.sy = -pick(r.dx, r.dy, r.dz, p.ky) * p.inv_z;
    return p;
  }

  __device__ static void stage(const float r[12], float4* g) {
    const float ax = r[3] - r[0], ay = r[4] - r[1], az = r[5] - r[2];
    const float bx = r[6] - r[0], by = r[7] - r[1], bz = r[8] - r[2];
    const float cx = ay * bz - az * by;
    const float cy = az * bx - ax * bz;
    const float cz = ax * by - ay * bx;
    const bool degenerate = (cx * cx + cy * cy + cz * cz) == 0.f;
    g[0] = make_float4(r[0], r[1], r[2], degenerate ? 1.f : 0.f);
    g[1] = make_float4(r[3], r[4], r[5], 0.f);
    g[2] = make_float4(r[6], r[7], r[8], 0.f);
  }

  __device__ static void shear(const Ray& r, const Pre& p, float4 v, float& x,
                               float& y, float& z) {
    const float qx = v.x - r.ox, qy = v.y - r.oy, qz = v.z - r.oz;
    z = pick(qx, qy, qz, p.kz);
    x = pick(qx, qy, qz, p.kx) + p.sx * z;
    y = pick(qx, qy, qz, p.ky) + p.sy * z;
  }

  __device__ static bool test(const Ray& r, const Pre& p, float4 v0, float4 v1,
                              float4 v2, float t_min, float t_max, Hit& h) {
    float p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z;
    shear(r, p, v0, p0x, p0y, p0z);
    shear(r, p, v1, p1x, p1y, p1z);
    shear(r, p, v2, p2x, p2y, p2z);
    const float e0 = p1x * p2y - p2x * p1y;
    const float e1 = p2x * p0y - p0x * p2y;
    const float e2 = p0x * p1y - p1x * p0y;
    const bool mixed = (e0 < 0.f || e1 < 0.f || e2 < 0.f) &&
                       (e0 > 0.f || e1 > 0.f || e2 > 0.f);
    const float det = e0 + e1 + e2;
    const bool det_ok = det != 0.f;
    const float inv_det = 1.0f / (det_ok ? det : 1.0f);
    const float t = (e0 * p0z + e1 * p1z + e2 * p2z) * p.inv_z * inv_det;
    h = Hit{t, e1 * inv_det, e2 * inv_det, copysignf(1.f, p.inv_z) * det < 0.f};
    return !mixed && det_ok && v0.w == 0.f && t >= t_min && t < t_max;
  }
};

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
