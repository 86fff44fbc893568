// Ray-triangle tests shared by the port's CUDA sources (sm_90a).
//
// The device twins of accel/traverse.py: ray_triangle_moeller (Moeller)
// and ray_triangle_watertight (Watertight). Sources that include this
// are built with -fmad=false, so every product and sum rounds as in the
// PyTorch twins and kernel and twin agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dcrt {

constexpr float kBig = 3.0e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
             d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

struct Hit {
  float t, u, v;
  bool back;
};

// Row k of a (B, 12) triangle table [v0 v1 v2 | tri | inst | flip] as
// three float4: (v0 v1.x) (v1.yz v2.xy) (v2.z meta).
__device__ __forceinline__ void load_row(const float* tab, int k, float r[12]) {
  const float4* p = reinterpret_cast<const float4*>(tab) + 3 * k;
  const float4 a = p[0], b = p[1], c = p[2];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

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

}  // namespace dcrt
