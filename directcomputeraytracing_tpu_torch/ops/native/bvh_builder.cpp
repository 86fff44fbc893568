// Native SAH BVH builder of the PyTorch port.
//
// The port's own copy of the reference's C++ builder
// (directcomputeraytracing_tpu/ops/native/bvh_builder.cpp), with its C
// ABI, stack order, patching of right children, 12-bucket SAH with cost
// 0.125 + SA-weighted counts, stable median split for <= 4 prims, equal
// split for degenerate extents and stable partition. Its arithmetic is
// the port's numpy builder's (accel/build.py build_bvh), not the
// reference C++'s, so that the two give bit-equal node arrays:
//
//  - every min and max keeps the later of two equal values
//    (a < b ? a : b), as numpy's axis-0 reductions, minimum.at and
//    minimum.accumulate do. std::min and std::max keep the earlier, so a
//    box whose coordinates run +0, -0 got +0 where numpy keeps -0;
//  - the SAH surface area is float32 in numpy's order,
//    2 * ((dx*dy + dy*dz) + dz*dx) with d = max(hi - lo, 0), widened to
//    double only for the cost (int64 count x float32 area is float64 in
//    numpy). An area in double splits grids of near-tied boxes otherwise;
//  - a node's total area is numpy's max(area, 1e-30): the float32 area
//    or the double 1e-30;
//  - it is built with -ffp-contract=off and never -ffast-math: a
//    contracted or reassociated float32 sum is another value.
//
// Exposed as a C ABI for ctypes; all buffers are caller-allocated numpy
// arrays. Built and loaded by ops/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr double kTraversalCost = 0.125;
constexpr uint32_t kCountShift = 3;

struct Vec3 {
  float x, y, z;
};

// numpy's tie rule: of two equal values (+0 and -0) the later one
inline float min_np(float a, float b) { return a < b ? a : b; }
inline float max_np(float a, float b) { return a > b ? a : b; }

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {min_np(a.x, b.x), min_np(a.y, b.y), min_np(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {max_np(a.x, b.x), max_np(a.y, b.y), max_np(a.z, b.z)};
}

// accel/build.py _surface_area, in float32
inline float SurfaceArea(const Vec3& mn, const Vec3& mx) {
  float dx = max_np(mx.x - mn.x, 0.0f);
  float dy = max_np(mx.y - mn.y, 0.0f);
  float dz = max_np(mx.z - mn.z, 0.0f);
  return 2.0f * ((dx * dy + dy * dz) + dz * dx);
}

struct WorkItem {
  int64_t lo, hi;
  int32_t depth;
  int64_t patch;  // interior node whose right_or_prim points at this root
};

}  // namespace

extern "C" int dcrt_build_bvh(
    const float* prim_bbox_min,   // (n, 3)
    const float* prim_bbox_max,   // (n, 3)
    int64_t n,
    int32_t max_prims_in_node,
    float* out_bbox_min,          // (2n, 3) capacity
    float* out_bbox_max,          // (2n, 3)
    uint32_t* out_right_or_prim,  // (2n,)
    uint32_t* out_misc,           // (2n,)
    int64_t* out_prim_order,      // (n,)
    int32_t* out_leaf_depths,     // (n,)
    int64_t* out_node_count,
    int32_t* out_max_depth) {
  if (n <= 0) return 1;

  std::vector<Vec3> pmin(n), pmax(n), centroid(n);
  for (int64_t i = 0; i < n; ++i) {
    pmin[i] = {prim_bbox_min[3 * i], prim_bbox_min[3 * i + 1],
               prim_bbox_min[3 * i + 2]};
    pmax[i] = {prim_bbox_max[3 * i], prim_bbox_max[3 * i + 1],
               prim_bbox_max[3 * i + 2]};
    centroid[i] = {0.5f * (pmin[i].x + pmax[i].x),
                   0.5f * (pmin[i].y + pmax[i].y),
                   0.5f * (pmin[i].z + pmax[i].z)};
  }

  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::vector<int64_t> scratch(n);

  int64_t node_count = 0;
  int32_t max_depth = 0;

  auto emit = [&](const Vec3& mn, const Vec3& mx, uint32_t rop,
                  uint32_t misc) -> int64_t {
    int64_t k = node_count++;
    out_bbox_min[3 * k] = mn.x;
    out_bbox_min[3 * k + 1] = mn.y;
    out_bbox_min[3 * k + 2] = mn.z;
    out_bbox_max[3 * k] = mx.x;
    out_bbox_max[3 * k + 1] = mx.y;
    out_bbox_max[3 * k + 2] = mx.z;
    out_right_or_prim[k] = rop;
    out_misc[k] = misc;
    return k;
  };

  auto cen_axis = [&](int64_t prim, int axis) -> float {
    const Vec3& c = centroid[prim];
    return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  };

  std::vector<WorkItem> stack;
  stack.push_back({0, n, 1, -1});
  const Vec3 kInf = {std::numeric_limits<float>::infinity(),
                     std::numeric_limits<float>::infinity(),
                     std::numeric_limits<float>::infinity()};
  const Vec3 kNegInf = {-kInf.x, -kInf.y, -kInf.z};

  while (!stack.empty()) {
    WorkItem w = stack.back();
    stack.pop_back();
    int64_t lo = w.lo, hi = w.hi;
    int64_t count = hi - lo;
    max_depth = std::max(max_depth, w.depth);

    Vec3 bmin = kInf, bmax = kNegInf, cmin = kInf, cmax = kNegInf;
    for (int64_t i = lo; i < hi; ++i) {
      bmin = vmin(bmin, pmin[order[i]]);
      bmax = vmax(bmax, pmax[order[i]]);
      cmin = vmin(cmin, centroid[order[i]]);
      cmax = vmax(cmax, centroid[order[i]]);
    }
    Vec3 extent = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    // np.argmax picks the FIRST maximum
    int axis = 0;
    float best_ext = extent.x;
    if (extent.y > best_ext) { axis = 1; best_ext = extent.y; }
    if (extent.z > best_ext) { axis = 2; best_ext = extent.z; }
    float ext_axis = axis == 0 ? extent.x : (axis == 1 ? extent.y
                                                       : extent.z);
    float cmin_axis = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);

    bool make_leaf = count <= 1;
    int64_t mid = -1;

    auto stable_median = [&]() {
      std::stable_sort(order.begin() + lo, order.begin() + hi,
                       [&](int64_t a, int64_t b) {
                         return cen_axis(a, axis) < cen_axis(b, axis);
                       });
      mid = lo + count / 2;
    };

    if (!make_leaf) {
      if (ext_axis <= 0.0f) {
        if (count <= max_prims_in_node) {
          make_leaf = true;
        } else {
          mid = lo + count / 2;
        }
      } else if (count <= 4) {
        stable_median();
      } else {
        // 12-bucket SAH
        Vec3 bucket_min[kBuckets], bucket_max[kBuckets];
        int64_t bucket_cnt[kBuckets] = {0};
        for (int i = 0; i < kBuckets; ++i) {
          bucket_min[i] = kInf;
          bucket_max[i] = kNegInf;
        }
        auto bucket_of = [&](int64_t prim) {
          float rel = (cen_axis(prim, axis) - cmin_axis) / ext_axis;
          int64_t b = (int64_t)(rel * kBuckets);
          return (int)std::min<int64_t>(b, kBuckets - 1);
        };
        for (int64_t i = lo; i < hi; ++i) {
          int b = bucket_of(order[i]);
          bucket_cnt[b]++;
          bucket_min[b] = vmin(bucket_min[b], pmin[order[i]]);
          bucket_max[b] = vmax(bucket_max[b], pmax[order[i]]);
        }
        Vec3 lmin[kBuckets], lmax[kBuckets], rmin[kBuckets],
            rmax[kBuckets];
        int64_t lcnt[kBuckets], rcnt[kBuckets];
        Vec3 acc_min = kInf, acc_max = kNegInf;
        int64_t acc = 0;
        for (int i = 0; i < kBuckets; ++i) {
          acc_min = vmin(acc_min, bucket_min[i]);
          acc_max = vmax(acc_max, bucket_max[i]);
          acc += bucket_cnt[i];
          lmin[i] = acc_min;
          lmax[i] = acc_max;
          lcnt[i] = acc;
        }
        acc_min = kInf;
        acc_max = kNegInf;
        acc = 0;
        for (int i = kBuckets - 1; i >= 0; --i) {
          acc_min = vmin(acc_min, bucket_min[i]);
          acc_max = vmax(acc_max, bucket_max[i]);
          acc += bucket_cnt[i];
          rmin[i] = acc_min;
          rmax[i] = acc_max;
          rcnt[i] = acc;
        }
        // Python's max(area, 1e-30): the double 1e-30 where it is larger
        double area = SurfaceArea(bmin, bmax);
        double total_sa = 1e-30 > area ? 1e-30 : area;
        double best_cost = std::numeric_limits<double>::infinity();
        int best = 0;
        for (int s = 0; s < kBuckets - 1; ++s) {
          double sa_l = lcnt[s] ? SurfaceArea(lmin[s], lmax[s]) : 0.0f;
          double sa_r =
              rcnt[s + 1] ? SurfaceArea(rmin[s + 1], rmax[s + 1]) : 0.0f;
          double cost =
              kTraversalCost + ((double)lcnt[s] * sa_l +
                                (double)rcnt[s + 1] * sa_r) / total_sa;
          if (cost < best_cost) {  // first minimum wins (np.argmin)
            best_cost = cost;
            best = s;
          }
        }
        double leaf_cost = (double)count;
        if (count > max_prims_in_node || best_cost < leaf_cost) {
          // stable partition: left = bucket <= best
          int64_t nl = 0;
          for (int64_t i = lo; i < hi; ++i)
            if (bucket_of(order[i]) <= best) nl++;
          if (nl == 0 || nl == count) {
            stable_median();
          } else {
            int64_t li = 0, ri = nl;
            for (int64_t i = lo; i < hi; ++i) {
              if (bucket_of(order[i]) <= best)
                scratch[li++] = order[i];
              else
                scratch[ri++] = order[i];
            }
            std::memcpy(order.data() + lo, scratch.data(),
                        count * sizeof(int64_t));
            mid = lo + nl;
          }
        } else {
          make_leaf = true;
        }
      }
    }

    if (make_leaf) {
      emit(bmin, bmax, (uint32_t)lo,
           ((uint32_t)count << kCountShift) | (uint32_t)axis);
      for (int64_t i = lo; i < hi; ++i) out_leaf_depths[i] = w.depth;
    } else {
      int64_t node = emit(bmin, bmax, 0, (uint32_t)axis);
      stack.push_back({mid, hi, w.depth + 1, node});
      stack.push_back({lo, mid, w.depth + 1, -1});
    }
    if (w.patch >= 0) out_right_or_prim[w.patch] = (uint32_t)(node_count - 1);
  }

  std::memcpy(out_prim_order, order.data(), n * sizeof(int64_t));
  *out_node_count = node_count;
  *out_max_depth = max_depth;
  return 0;
}
