// The work-list walk's device code, shared by worklist.cu and pairsweep.cu
// (sm_90a, built with -fmad=false like every source that includes
// ray_tri.cuh).
//
// A ray's walk over one super (32 child boxes of 16-triangle clusters):
// the fine cull tests the child boxes against the ray's window and floor,
// then `walk_closest` sweeps the entered clusters nearest first and stops
// at the first that starts beyond the window of its current best, or
// `walk_any` sweeps them in child order and stops at the first hit. The
// packed key of a hit is (bits(t) & ~kLowM) | (child << 4) | row, and a
// cluster's smallest key replaces the best only if strictly smaller; a
// candidate needs t inside the best's whole truncation quantum (window()).
// Slab rows come from device memory (kGlobal, read through the read-only
// cache) or from a copy in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "ray_tri.cuh"

namespace dcrt {

constexpr int kSuper = 32;                 // clusters per super
constexpr int kCluster = 16;               // triangles per cluster
constexpr int kSuperRows = kSuper * kCluster;
constexpr int kLowM = (kSuper << 4) - 1;   // packed-key id bits

struct RayInv {
  Ray r;
  float ix, iy, iz;
};

// Ray i of the (9, rp) rows [o; d; 1/d].
__device__ __forceinline__ RayInv load_od(const float* od, int rp, int i) {
  const size_t n = static_cast<size_t>(rp);
  RayInv q;
  q.r = Ray{od[i], od[n + i], od[2 * n + i], od[3 * n + i], od[4 * n + i],
            od[5 * n + i]};
  q.ix = od[6 * n + i];
  q.iy = od[7 * n + i];
  q.iz = od[8 * n + i];
  return q;
}

// Slab test of the ray against box [b0, b1]: entry t_lo, exit t_hi.
__device__ __forceinline__ void slab(const RayInv& q, float b0x, float b0y,
                                     float b0z, float b1x, float b1y,
                                     float b1z, float& t_lo, float& t_hi) {
  t_lo = -kBig;
  t_hi = kBig;
  float a = (b0x - q.r.ox) * q.ix, b = (b1x - q.r.ox) * q.ix;
  t_lo = fmaxf(t_lo, fminf(a, b));
  t_hi = fminf(t_hi, fmaxf(a, b));
  a = (b0y - q.r.oy) * q.iy;
  b = (b1y - q.r.oy) * q.iy;
  t_lo = fmaxf(t_lo, fminf(a, b));
  t_hi = fminf(t_hi, fmaxf(a, b));
  a = (b0z - q.r.oz) * q.iz;
  b = (b1z - q.r.oz) * q.iz;
  t_lo = fmaxf(t_lo, fminf(a, b));
  t_hi = fminf(t_hi, fmaxf(a, b));
}

// The enter rule of the fine cull and the pair emission: the ray crosses
// the box in front of t_min and enters it before cap.
__device__ __forceinline__ bool enters(float t_lo, float t_hi, float cap,
                                       float t_min) {
  return t_hi >= t_lo && t_hi >= 0.f && t_lo < cap && t_hi >= t_min;
}

// A 16-byte copy from device to shared memory by cp.async, and its
// group commit and wait (at most N groups left in flight).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

template <bool kGlobal>
__device__ __forceinline__ float ld1(const float* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// Baldwin-Weber on the (C*16, 16) rows [n | c0 | r1 | c1 | r2 | c2 | meta |
// row]: the twin is accel/worklist.py:bw_rows.
struct BaldwinWeber {
  static constexpr int kCols = 16, kMeta = 12;
  struct Pre {};
  __device__ static Pre prepare(const Ray&) { return Pre{}; }

  template <bool kGlobal = true>
  __device__ static bool test(const Ray& r, const Pre&,
                              const float* __restrict__ tab, int row,
                              float t_min, float t_max, Hit& h) {
    const float4* p = reinterpret_cast<const float4*>(tab) + 4 * row;
    const float4 a = ld4<kGlobal>(p), b = ld4<kGlobal>(p + 1),
                 c = ld4<kGlobal>(p + 2);
    const float den = a.x * r.dx + a.y * r.dy + a.z * r.dz;
    const bool den_ok = fabsf(den) >= 1e-10f;
    const float inv_den = 1.0f / (den_ok ? den : 1.0f);
    const float t = (a.w - (a.x * r.ox + a.y * r.oy + a.z * r.oz)) * inv_den;
    const float hx = r.ox + t * r.dx, hy = r.oy + t * r.dy,
                hz = r.oz + t * r.dz;
    const float u = b.x * hx + b.y * hy + b.z * hz + b.w;
    const float v = c.x * hx + c.y * hy + c.z * hz + c.w;
    h = Hit{t, u, v, den < 1e-10f};
    return den_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t >= t_min &&
           t < t_max;
  }
};

// Watertight on the raw (C*16, 13) rows [v0 v1 v2 | meta | row].
struct RawWatertight {
  static constexpr int kCols = 13, kMeta = 9;
  using Pre = Watertight::Pre;
  __device__ static Pre prepare(const Ray& r) {
    return Watertight::prepare(r);
  }

  template <bool kGlobal = true>
  __device__ static bool test(const Ray& r, const Pre& p,
                              const float* __restrict__ tab, int row,
                              float t_min, float t_max, Hit& h) {
    const float* q = tab + static_cast<size_t>(row) * kCols;
    float v[12];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = ld1<kGlobal>(q + k);
    v[9] = v[10] = v[11] = 0.f;
    float4 g[3];
    Watertight::stage(v, g);
    return Watertight::test(r, p, g[0], g[1], g[2], t_min, t_max, h);
  }
};

// Stage super `sup`'s 32 child boxes (2 float4 each) into shared memory.
__device__ __forceinline__ void stage_boxes(const float* cbox, int sup,
                                            float4* boxes) {
  if (threadIdx.x < 2 * kSuper)
    boxes[threadIdx.x] = __ldg(reinterpret_cast<const float4*>(cbox) +
                               static_cast<size_t>(sup) * 2 * kSuper +
                               threadIdx.x);
}

// Fine cull: does the ray cross child box c in front of t_min and enter
// it before cap? t_lo is its entry distance.
__device__ __forceinline__ bool child_enter(const RayInv& q,
                                            const float4* boxes, int c,
                                            float cap, float t_min,
                                            float& t_lo) {
  const float4 lo = boxes[2 * c], hi = boxes[2 * c + 1];
  float t_hi;
  slab(q, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, t_lo, t_hi);
  return enters(t_lo, t_hi, cap, t_min);
}

// The candidate window of a packed best: every t whose truncated bits
// do not exceed the best's, i.e. t < the float after (best | kLowM). With
// the strict key replacement this makes the result the least key over all
// hits the walk sweeps, whatever order it sweeps them in; a cluster or
// item entered at or beyond the window cannot hold a better key.
__device__ __forceinline__ float window(int best) {
  return __int_as_float((best | kLowM) + 1);
}

// The per-ray state of a closest walk: packed best, the winner's t, u, v,
// back flag and table row (-1: none), and clusters swept.
struct Best {
  int best;
  float t, u, v;
  bool back;
  int row, iters;

  // A cluster's smallest candidate (key cand, hit h in table row `row`)
  // replaces the best if strictly smaller; returns whether it did.
  __device__ __forceinline__ bool take(int cand, const Hit& h, int at) {
    if (!(cand < best)) return false;
    best = cand;
    t = h.t;
    u = h.u;
    v = h.v;
    back = h.back;
    row = at;
    return true;
  }
};

// The state before any hit: the best at the scene exit t_exit.
__device__ __forceinline__ Best start_best(float t_exit) {
  return Best{__float_as_int(t_exit) | kLowM, t_exit, 0.f, 0.f, false, -1, 0};
}

// The outputs of a closest sweep, one element per ray (or pair).
struct ClosestOut {
  int* best;
  float *t, *u, *v;
  int *tri, *inst;
  unsigned char* back;
  int* iters;

  __device__ __forceinline__ void store(size_t i, const Best& s, int tri_id,
                                        int inst_id, bool back_face) const {
    best[i] = s.best;
    t[i] = s.t;
    u[i] = s.u;
    v[i] = s.v;
    tri[i] = tri_id;
    inst[i] = inst_id;
    back[i] = back_face;
    iters[i] = s.iters;
  }
};

// Store a world-soup sweep's state at i: the winner's slab row `row` of
// tab (-1: none) gives its triangle and instance ids, and its flip column
// turns the back flag.
template <class Tri>
__device__ __forceinline__ void store_soup(const ClosestOut& out, size_t i,
                                           const float* tab, const Best& s,
                                           int row) {
  float tri = 0.f, inst = 0.f, flip = 0.f;
  if (row >= 0) {
    const float* meta = tab + static_cast<size_t>(row) * Tri::kCols +
                        Tri::kMeta;
    tri = meta[0];
    inst = meta[1];
    flip = meta[2];
  }
  out.store(i, s, static_cast<int>(tri), static_cast<int>(inst),
            row >= 0 && (s.back != (flip > 0.5f)));
}

// The fine cull of the staged child boxes under cap: the mask of entered
// children and their clamped entry distances tl.
__device__ __forceinline__ unsigned fine_cull(const RayInv& q,
                                              const float4* boxes, float cap,
                                              float t_min, float* tl) {
  unsigned mask = 0u;
#pragma unroll
  for (int c = 0; c < kSuper; ++c) {
    float t_lo;
    if (child_enter(q, boxes, c, cap, t_min, t_lo)) mask |= 1u << c;
    tl[c] = fmaxf(t_lo, 0.f);
  }
  return mask;
}

// Test the 16 rows of child c's cluster (rows base.. of tab) under the
// window t_max; the smallest packed key lowers cand, with its hit and row.
template <class Tri, bool kGlobal>
__device__ __forceinline__ void test_cluster(const Ray& r,
                                             const typename Tri::Pre& pre,
                                             const float* __restrict__ tab,
                                             int base, int c, float t_min,
                                             float t_max, int& cand, Hit& hc,
                                             int& crow) {
  for (int k = 0; k < kCluster; ++k) {
    Hit h;
    if (Tri::template test<kGlobal>(r, pre, tab, base + k, t_min, t_max,
                                    h)) {
      const int key = (__float_as_int(h.t) & ~kLowM) | ((c << 4) | k);
      if (key < cand) {
        cand = key;
        hc = h;
        crow = base + k;
      }
    }
  }
}

// Sweep the entered children (mask, entry distances tl) nearest first,
// lowest child on a tie, each cluster's 16 rows from `row0 + child * 16`
// of tab, tested with ray r. Stops at the first cluster that starts
// beyond the window of the current best. Returns whether the best
// improved.
template <class Tri, bool kGlobal>
__device__ __forceinline__ bool walk_closest(
    const Ray& r, const typename Tri::Pre& pre, const float* __restrict__ tab,
    int row0, float t_min, const float* tl, unsigned mask, Best& s) {
  bool improved = false;
  while (mask) {
    float m = INFINITY;
    int cs = 0;
#pragma unroll
    for (int c = 0; c < kSuper; ++c) {
      if (((mask >> c) & 1u) && tl[c] < m) {
        m = tl[c];
        cs = c;
      }
    }
    if (!(m < window(s.best))) break;
    mask &= ~(1u << cs);
    ++s.iters;
    int cand = INT_MAX, crow = -1;
    Hit hc{0.f, 0.f, 0.f, false};
    test_cluster<Tri, kGlobal>(r, pre, tab, row0 + cs * kCluster, cs, t_min,
                               window(s.best), cand, hc, crow);
    improved |= s.take(cand, hc, crow);
  }
  return improved;
}

// Occlusion over the staged super: the clusters whose child box ray q
// enters before t_max (in front of t_min), in child order, each tested
// with ray r; true at the first hit in [t_min, t_max).
template <class Tri, bool kGlobal>
__device__ __forceinline__ bool walk_any(const RayInv& q, const Ray& r,
                                         const typename Tri::Pre& pre,
                                         const float4* boxes,
                                         const float* __restrict__ tab,
                                         int row0, float t_max, float t_min) {
  for (int c = 0; c < kSuper; ++c) {
    float t_lo;
    if (!child_enter(q, boxes, c, t_max, t_min, t_lo)) continue;
    const int base = row0 + c * kCluster;
    for (int k = 0; k < kCluster; ++k) {
      Hit h;
      if (Tri::template test<kGlobal>(r, pre, tab, base + k, t_min, t_max, h))
        return true;
    }
  }
  return false;
}

}  // namespace dcrt
