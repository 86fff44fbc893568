// Dense ray sweep over a world-space triangle soup, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of directcomputeraytracing_tpu/accel/
// pallas_brute.py: _closest_kernel (:128, launched by brute_closest_pallas
// :230) and _any_kernel (:179, launched by brute_any_pallas :264), and
// keeps their contracts:
//   closest: (t, +inf on miss; u; v; tri i32; inst i32; back bool), the
//            first triangle in table order among those at the minimum t;
//   any:     occluded bool, a hit in [t_min, t_max[ray]).
// The table is the (B, 12) f32 soup [v0 v1 v2 | tri id | inst id | flip]
// (accel/brute.py:build_table), read here only for the hit's ids and flip;
// the tests read the wrapper's prepared rows (accel/brute.py:prepare_rows,
// built once per scene in the twins' own float arithmetic): Moeller
// (v0, 0 | e1 = v1 - v0, 0 | e2 = v2 - v0, 0), watertight (v0, degenerate
// | v1, 0 | v2, 0), 48 bytes a row. Rays are (R, 3) f32 origins and
// directions.
//
// What bounds it: instruction issue. A Moeller test is 45 counted float
// operations, the watertight test about twice that, and the library is
// built with -fmad=false (below), so each costs at least as many
// instructions; at 1M rays x 2048 triangles that is ~1e11 instructions
// against ~40 MB of memory traffic. The first port (one ray a thread, the
// table restaged through 128-row tiles by every 256-ray block, every pair
// taking the whole test and its IEEE division) stood at about half of the
// no-FMA float32 rate. The design cuts instructions per pair:
//
// - Resident blocks, the table staged once. The launch holds as many CUDA
//   blocks as the card keeps resident (at most what the rays need). A
//   table of at most kResidentRows rows is copied into dynamic shared
//   memory once per block, and each warp then sweeps its rays with no
//   barrier. A larger table streams through a ring of kStages tiles of
//   kTile rows, filled by cp.async, so that the copy of the next tile
//   overlaps the tests on this one, and the block sweeps its rays
//   together. Each warp (streamed: each block) takes an equal share of the
//   rays, in slots of 32 (kThreads) consecutive rays, so no unit runs a
//   last round that the others skip.
// - Several rays a thread, a constant of each sieve (kRays): a row read
//   from shared memory (three broadcast float4 loads) serves kRays tests,
//   and their sieves form independent chains. Of 1, 2 and 4 rays a thread
//   (tools/brute_ab.py's sets on an H100 80GB HBM3 at 700 W; PERF.md) the
//   Moeller kernels were fastest at 2 on the 2^20-ray sets and the
//   watertight ones at 1 on every set (at 2 or 4 their registers hold
//   fewer blocks resident).
// - The division only for pairs that can hit, without a branch per pair.
//   Rows go by chunks of 64. A first pass, straight-line code, runs a
//   division-free sieve (below) on every (ray, row) pair of the chunk and
//   sets a bit of the ray's mask for each pair that passes; a second pass
//   walks each lane's bits in row order and runs the whole test of
//   ray_tri.cuh (dcrt::Moeller::test or dcrt::Watertight::test, left as
//   they are: clustered.cu and worklist.cu share them) on those pairs only.
//   A warp runs the second pass as often as its lane with the most bits;
//   a branch per pair would run it wherever any lane passed.
// - Any-hit leaves by warps: a lane is done once its rays are occluded or
//   can hit nothing (t_max <= t_min), and a warp leaves the row loop once
//   all its lanes are done (the streamed path: once the whole block is).
//
// Triangles are visited in index order (each lane's bits in row order,
// chunks in order) and a hit replaces the best only when strictly nearer,
// which is the reference's first-minimum tie rule. The sieves reject only
// pairs that the whole test rejects, and the pairs they pass run the whole
// test, so every result keeps the bits of the PyTorch twins
// (accel/brute.py); with -fmad=false every product and sum rounds as in
// the twins. Rays past R are masked; nothing is padded and nothing is
// written past R.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>

#include "ray_tri.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// resident blocks an SM the registers must allow: two 96 KB tables fit
// an SM; at one ray a thread four (at most 64 registers), which small
// tables then keep resident
constexpr int min_blocks(int rays_per_thread) {
  return rays_per_thread == 1 ? 4 : 2;
}
constexpr int kResidentRows = 2048;    // DENSE_MAX_TRIS: 96 KB of rows
constexpr int kTile = 256;             // streamed: rows a ring stage
constexpr int kStages = 3;
constexpr int kChunk = 64;             // rows a sieve mask covers
constexpr int kRowBytes = 48;
constexpr int kMaxSmem = kRowBytes * kResidentRows;  // the most a launch uses
constexpr unsigned kFull = 0xffffffffu;
constexpr float kOneUp = 1.0f + 0x1p-20f;  // exact in float

using dcrt::Hit;
using dcrt::kBig;
using dcrt::load_ray;
using dcrt::Ray;
using Mask = unsigned long long;       // a ray's sieve bits of a chunk

// x with its sign flipped where s's sign bit is set: x * sign(s), exactly.
__device__ __forceinline__ float flip_by(float x, float s) {
  return __int_as_float(__float_as_int(x) ^
                        (__float_as_int(s) & static_cast<int>(0x80000000u)));
}

// The Moeller sieve: pvec, det, tvec and u's numerator un exactly as
// dcrt::Moeller::test computes them (the same float operations in the
// same order), and a verdict from them without the division. Rows are
// (v0, e1, e2).
//
// Why it rejects only pairs that the whole test rejects. Let D = |det|,
// sigma = sign(det), U = sigma * un (an exact sign flip), m = D * 2^-20
// (exact: D >= 1e-10 stays normal) and r = fl(1 / D). The test computes
// inv_det = fl(1 / det) = sigma * r and u = fl(un * inv_det) = fl(U * r)
// (rounding to nearest is symmetric), and accepts only if det_ok,
// u >= 0 and u <= 1 (among others). For finite D >= 1e-10,
// r >= (1 / D)(1 - 2^-22): relative error 2^-24 while 1 / D is normal,
// and below 2^-126 an absolute error of at most 2^-150 against
// 1 / D > 2^-128. The sieve rejects where:
// - !det_ok: the test's own predicate on the same det (det at +-1e-10
//   and at +-0 decide alike; NaN fails both);
// - U < -m: then U * r < -2^-20 (1 - 2^-22) < -2^-21, so u <= -2^-21 < 0.
//   u at exactly 0 passes both, and so does a product that underflows to
//   -0 (tiny U, huge D: -0 >= 0);
// - U > fl(D * (1 + 2^-20)), a product that rounds by at most 2^-24 (or
//   overflows to +inf and rejects nothing): U * r > (1 + 2^-20)(1 - 2^-24)
//   (1 - 2^-22) > 1 + 2^-21, so u > 1 (or u = +inf for an infinite U). u
//   at exactly 1 (U = D) passes;
// - U is NaN (every comparison fails): then u is NaN, which fails u >= 0.
// With D = +inf, m and fl(D * (1 + 2^-20)) are +inf and only a NaN U is
// rejected.
// v, u + v and the t window are left to the test.
struct MoellerSieve {
  using Test = dcrt::Moeller;
  static constexpr int kRays = 2;

  __device__ __forceinline__ static bool pass(const Ray& r, const Test::Pre&,
                                              float4 v0, float4 e1,
                                              float4 e2) {
    // pvec = d x e2
    const float px = r.dy * e2.z - r.dz * e2.y;
    const float py = r.dz * e2.x - r.dx * e2.z;
    const float pz = r.dx * e2.y - r.dy * e2.x;
    const float det = e1.x * px + e1.y * py + e1.z * pz;
    const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
    const float un = tx * px + ty * py + tz * pz;
    const float ad = fabsf(det);
    const float us = flip_by(un, det);
    return ad >= 1e-10f && us >= ad * -0x1p-20f && us <= ad * kOneUp;
  }
};

// The watertight sieve: the three sheared vertices and the edge functions
// exactly as dcrt::Watertight::test computes them, and the test's own
// !mixed, det_ok and non-degenerate (v0.w == 0): it rejects exactly the
// pairs that fail one of them, before the division and t. Rows are (v0
// with the degenerate flag, v1, v2).
struct WatertightSieve {
  using Test = dcrt::Watertight;
  static constexpr int kRays = 1;

  __device__ __forceinline__ static bool pass(const Ray& r,
                                              const Test::Pre& pre, float4 v0,
                                              float4 v1, float4 v2) {
    float p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z;
    Test::shear(r, pre, v0, p0x, p0y, p0z);
    Test::shear(r, pre, v1, p1x, p1y, p1z);
    Test::shear(r, pre, v2, p2x, p2y, p2z);
    const float e0 = p1x * p2y - p2x * p1y;
    const float e1 = p2x * p0y - p0x * p2y;
    const float e2 = p0x * p1y - p1x * p0y;
    const bool mixed = (e0 < 0.f || e1 < 0.f || e2 < 0.f) &&
                       (e0 > 0.f || e1 > 0.f || e2 > 0.f);
    return !mixed && e0 + e1 + e2 != 0.f && v0.w == 0.f;
  }
};

// A lane's (or thread's) K rays: ray j is first + stride * j, so each j's
// loads and stores coalesce across the warp.
template <class S, int K>
struct Lanes {
  Ray ray[K];
  typename S::Test::Pre pre[K];
  bool live[K];

  __device__ __forceinline__ Lanes(const float* o, const float* d,
                                   int n_rays, int first, int stride) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + stride * j;
      live[j] = i < n_rays;
      ray[j] = load_ray(o, d, live[j] ? i : 0);
      pre[j] = S::Test::prepare(ray[j]);
    }
  }
};

// The first pass over rows [0, m) (m <= kChunk): bit k of mask[j] is set
// where ray j passes the sieve against row k. Groups of 8 rows build a
// byte each with constant bits (one predicated OR a pair); the last m % 8
// rows go one by one.
template <class S, int K>
__device__ __forceinline__ void sieve_chunk(const float4* __restrict__ rows,
                                            int m, const Lanes<S, K>& l,
                                            Mask (&mask)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) mask[j] = 0u;
  int k = 0;
#pragma unroll 1
  for (; k + 8 <= m; k += 8) {
    unsigned byte[K];
#pragma unroll
    for (int j = 0; j < K; ++j) byte[j] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4* row = rows + 3 * (k + i);
      const float4 a = row[0], b = row[1], c = row[2];
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (S::pass(l.ray[j], l.pre[j], a, b, c)) byte[j] |= 1u << i;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) mask[j] |= static_cast<Mask>(byte[j]) << k;
  }
#pragma unroll 1
  for (; k < m; ++k) {
    const float4 a = rows[3 * k], b = rows[3 * k + 1], c = rows[3 * k + 2];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (S::pass(l.ray[j], l.pre[j], a, b, c)) mask[j] |= Mask{1} << k;
  }
}

// Test the lane's rays against rows [0, n) of `rows` (table rows base...),
// keeping each ray's nearest hit.
template <class S, int K>
__device__ __forceinline__ void closest_rows(const float4* __restrict__ rows,
                                             int n, int base,
                                             const Lanes<S, K>& l,
                                             float t_min, Hit (&best)[K],
                                             int (&best_j)[K]) {
  for (int c = 0; c < n; c += kChunk) {
    const float4* chunk = rows + 3 * c;
    Mask mask[K];
    sieve_chunk<S, K>(chunk, min(kChunk, n - c), l, mask);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      while (mask[j]) {
        const int k = __ffsll(mask[j]) - 1;
        mask[j] &= mask[j] - 1u;
        Hit h;
        if (S::Test::test(l.ray[j], l.pre[j], chunk[3 * k], chunk[3 * k + 1],
                          chunk[3 * k + 2], t_min, best[j].t, h)) {
          best[j] = h;
          best_j[j] = base + c + k;
        }
      }
    }
  }
}

// Test the lane's rays that are not yet done against rows [0, n); a ray
// is done once occluded. Returns once the warp's lanes are all done.
template <class S, int K>
__device__ __forceinline__ void any_rows(const float4* __restrict__ rows,
                                         int n, const Lanes<S, K>& l,
                                         float t_min, const float (&tmax)[K],
                                         bool (&todo)[K], bool (&occ)[K]) {
  for (int c = 0; c < n; c += kChunk) {
    bool some = false;
#pragma unroll
    for (int j = 0; j < K; ++j) some |= todo[j];
    if (!__any_sync(kFull, some)) return;
    const float4* chunk = rows + 3 * c;
    Mask mask[K];
    sieve_chunk<S, K>(chunk, min(kChunk, n - c), l, mask);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!todo[j]) mask[j] = 0u;
      while (mask[j]) {
        const int k = __ffsll(mask[j]) - 1;
        mask[j] &= mask[j] - 1u;
        Hit h;
        if (S::Test::test(l.ray[j], l.pre[j], chunk[3 * k], chunk[3 * k + 1],
                          chunk[3 * k + 2], t_min, tmax[j], h)) {
          occ[j] = true;
          todo[j] = false;
          mask[j] = 0u;
        }
      }
    }
  }
}

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

// The whole table (n <= kResidentRows rows) into shared memory, once.
__device__ __forceinline__ void stage_all(float4* rows,
                                          const float4* __restrict__ prep,
                                          int n) {
  for (int c = threadIdx.x; c < 3 * n; c += kThreads) rows[c] = prep[c];
  __syncthreads();
}

// Start the copy of row tile `tile` into ring stage `tile % kStages`.
__device__ __forceinline__ void prefetch_tile(float4* ring,
                                              const float4* __restrict__ prep,
                                              int n_tris, int tile) {
  const int base = tile * kTile, n = min(kTile, n_tris - base);
  float4* stage = ring + (tile % kStages) * 3 * kTile;
  for (int c = threadIdx.x; c < 3 * n; c += kThreads)
    cp_async16(stage + c, prep + 3 * base + c);
}

// Stream the table through the ring for the block's rays: fn(rows, n,
// base) per tile; keep_going() is a block-wide vote taken at each tile's
// barrier (false: every thread leaves). The ring is free again on return.
template <class Fn, class Vote>
__device__ __forceinline__ void stream_rows(float4* ring,
                                            const float4* __restrict__ prep,
                                            int n_tris, Fn fn,
                                            Vote keep_going) {
  const int n_tiles = (n_tris + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) prefetch_tile(ring, prep, n_tris, s);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();      // tile t has landed (this thread's)
    if (!keep_going()) break;          // the barrier: everyone's has, and
                                       // stage (t - 1) % kStages is free
    if (t + kStages - 1 < n_tiles)
      prefetch_tile(ring, prep, n_tris, t + kStages - 1);
    cp_async_commit();
    const int base = t * kTile;
    fn(ring + (t % kStages) * 3 * kTile, min(kTile, n_tris - base), base);
  }
  cp_async_wait<0>();
  __syncthreads();
}

struct ClosestOut {
  float *t, *u, *v;
  int *tri, *inst;
  unsigned char* back;
};

struct Args {
  const float* tab;
  const float4* prep;
  int n_tris;
  const float* o;
  const float* d;
  const float* t_max;
  int n_rays;
  float t_min;
};

template <int K>
__device__ __forceinline__ void store_closest(const float* __restrict__ tab,
                                              int n_rays, int first,
                                              int stride,
                                              const Hit (&best)[K],
                                              const int (&best_j)[K],
                                              const ClosestOut& out) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = first + stride * j;
    if (i >= n_rays) continue;
    const bool hit = best_j[j] >= 0;
    // (v2.z, tri, inst, flip): the third float4 of the hit's table row
    const float4 meta =
        hit ? reinterpret_cast<const float4*>(tab)[3 * best_j[j] + 2]
            : make_float4(0.f, 0.f, 0.f, 0.f);
    out.t[i] = hit ? best[j].t : INFINITY;
    out.u[i] = best[j].u;
    out.v[i] = best[j].v;
    out.tri[i] = static_cast<int>(meta.y);
    out.inst[i] = static_cast<int>(meta.z);
    out.back[i] = hit && (best[j].back != (meta.w > 0.5f));
  }
}

// The closest sweep of K rays a thread from slot s (resident: a warp's
// slot of 32 rays; streamed: a block's slot of kThreads).
template <class S>
struct ClosestBody {
  const Args& a;
  const ClosestOut& out;
  float4* rows;
  bool resident;

  template <int K>
  __device__ __forceinline__ void run(int s) {
    const int stride = resident ? 32 : kThreads;
    const int first =
        s * stride + (resident ? (threadIdx.x & 31) : threadIdx.x);
    const Lanes<S, K> l(a.o, a.d, a.n_rays, first, stride);
    Hit best[K];
    int best_j[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      best[j] = Hit{kBig, 0.f, 0.f, false};
      best_j[j] = -1;
    }
    if (resident) {
      closest_rows<S, K>(rows, a.n_tris, 0, l, a.t_min, best, best_j);
    } else {
      stream_rows(
          rows, a.prep, a.n_tris,
          [&](const float4* tile, int n, int base) {
            closest_rows<S, K>(tile, n, base, l, a.t_min, best, best_j);
          },
          [] {
            __syncthreads();
            return true;
          });
    }
    store_closest<K>(a.tab, a.n_rays, first, stride, best, best_j, out);
  }
};

// The any-hit sweep, likewise.
template <class S>
struct AnyBody {
  const Args& a;
  unsigned char* out;
  float4* rows;
  bool resident;

  template <int K>
  __device__ __forceinline__ void run(int s) {
    const int stride = resident ? 32 : kThreads;
    const int first =
        s * stride + (resident ? (threadIdx.x & 31) : threadIdx.x);
    const Lanes<S, K> l(a.o, a.d, a.n_rays, first, stride);
    float tmax[K];
    bool todo[K], occ[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      tmax[j] = l.live[j] ? a.t_max[first + stride * j] : 0.f;
      // t_min <= t < t_max is empty: the ray can hit nothing
      todo[j] = l.live[j] && tmax[j] > a.t_min;
      occ[j] = false;
    }
    if (resident) {
      any_rows<S, K>(rows, a.n_tris, l, a.t_min, tmax, todo, occ);
    } else {
      stream_rows(
          rows, a.prep, a.n_tris,
          [&](const float4* tile, int n, int) {
            any_rows<S, K>(tile, n, l, a.t_min, tmax, todo, occ);
          },
          [&] {
            bool some = false;
#pragma unroll
            for (int j = 0; j < K; ++j) some |= todo[j];
            return __syncthreads_or(some) != 0;
          });
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (l.live[j]) out[first + stride * j] = occ[j];
  }
};

// Resident: stage the table, then each warp sweeps an equal share of the
// 32-ray slots; streamed: each block an equal share of the kThreads-ray
// slots. A share goes R slots at a time (slot s + j holds each lane's ray
// j), its last odd slot (R = 2) alone.
template <int R, class Body>
__device__ __forceinline__ void sweep(const Args& a, Body& body) {
  long long slots, unit, units;
  if (body.resident) {
    stage_all(body.rows, a.prep, a.n_tris);
    slots = (a.n_rays + 31) / 32;
    unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
    units = static_cast<long long>(gridDim.x) * kWarps;
  } else {
    slots = (a.n_rays + kThreads - 1) / kThreads;
    unit = blockIdx.x;
    units = gridDim.x;
  }
  int s = static_cast<int>(slots * unit / units);
  const int end = static_cast<int>(slots * (unit + 1) / units);
  static_assert(R == 1 || R == 2, "the tail below runs one slot");
  for (; s + R <= end; s += R) body.template run<R>(s);
  if constexpr (R == 2) {
    if (s < end) body.template run<1>(s);
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads, min_blocks(S::kRays))
closest_kernel(Args a, ClosestOut out) {
  extern __shared__ float4 rows[];
  ClosestBody<S> body{a, out, rows, a.n_tris <= kResidentRows};
  sweep<S::kRays>(a, body);
}

template <class S>
__global__ void __launch_bounds__(kThreads, min_blocks(S::kRays))
any_kernel(Args a, unsigned char* out) {
  extern __shared__ float4 rows[];
  AnyBody<S> body{a, out, rows, a.n_tris <= kResidentRows};
  sweep<S::kRays>(a, body);
}

inline int smem_bytes(int n_tris) {
  return n_tris <= kResidentRows ? kRowBytes * n_tris
                                 : kRowBytes * kStages * kTile;
}

// The blocks the card keeps resident of kernel fn with `smem` bytes of
// dynamic shared memory each, per (card, kernel, size): the first launch
// of each opts fn in to kMaxSmem and asks the occupancy, later ones read
// the answer here (a scene's casts take one or two sizes, so a cast makes
// no runtime call before its launch but cudaGetDevice). Once the table is
// full, sizes it does not hold are asked each time.
struct Resident {
  int dev;
  const void* fn;
  int smem, blocks;
};
constexpr int kResidentSlots = 64;
std::mutex resident_mutex;
Resident resident_seen[kResidentSlots];
int resident_count = 0;

cudaError_t resident_blocks(const void* fn, int smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(resident_mutex);
    for (int i = 0; i < resident_count; ++i) {
      const Resident& r = resident_seen[i];
      if (r.dev == dev && r.fn == fn && r.smem == smem) {
        *blocks = r.blocks;
        return cudaSuccess;
      }
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return err;
  *blocks = sms * std::max(1, per_sm);
  std::lock_guard<std::mutex> lock(resident_mutex);
  if (resident_count < kResidentSlots)
    resident_seen[resident_count++] = Resident{dev, fn, smem, *blocks};
  return cudaSuccess;
}

// The grid for fn: as many blocks as the card keeps resident, at most one
// a kThreads rays. Returns a CUDA error or 0.
template <class Fn>
int grid_for(Fn fn, int smem, int n_rays, int* blocks) {
  int resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(fn), smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = (n_rays + kThreads - 1) / kThreads;
  *blocks = std::max(1, std::min(need, resident));
  return 0;
}

// A C argument the kernels cannot take: a negative count of rows or rays.
inline bool bad_counts(int n_tris, int n_rays) {
  return n_tris < 0 || n_rays < 0;
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `tab` is the (B, 12)
// table, `prep` its prepared rows for the chosen test (16-byte aligned);
// `stream` is a cudaStream_t. Each returns 0 or the first CUDA error: a
// negative count (cudaErrorInvalidValue), the shared-memory opt-in, the
// occupancy query or the launch (cudaGetLastError()).

extern "C" int dcrt_brute_closest(const float* tab, const float* prep,
                                  int n_tris, const float* o, const float* d,
                                  int n_rays, float t_min, int watertight,
                                  float* t, float* u, float* v, int* tri,
                                  int* inst, unsigned char* back,
                                  void* stream) {
  if (bad_counts(n_tris, n_rays))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaGetLastError());
  const auto fn = watertight ? closest_kernel<WatertightSieve>
                             : closest_kernel<MoellerSieve>;
  const int smem = smem_bytes(n_tris);
  int blocks = 0;
  const int err = grid_for(fn, smem, n_rays, &blocks);
  if (err) return err;
  fn<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Args{tab, reinterpret_cast<const float4*>(prep), n_tris, o, d, nullptr,
           n_rays, t_min},
      ClosestOut{t, u, v, tri, inst, back});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_brute_any(const float* prep, int n_tris, const float* o,
                              const float* d, const float* t_max, int n_rays,
                              float t_min, int watertight,
                              unsigned char* occluded, void* stream) {
  if (bad_counts(n_tris, n_rays))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaGetLastError());
  const auto fn = watertight ? any_kernel<WatertightSieve>
                             : any_kernel<MoellerSieve>;
  const int smem = smem_bytes(n_tris);
  int blocks = 0;
  const int err = grid_for(fn, smem, n_rays, &blocks);
  if (err) return err;
  fn<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Args{nullptr, reinterpret_cast<const float4*>(prep), n_tris, o, d,
           t_max, n_rays, t_min},
      occluded);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' resources, for the report: per kernel (closest Moeller,
// closest watertight, any Moeller, any watertight) 5 ints: resident blocks
// per SM with a full resident table (kResidentRows rows), registers,
// static shared bytes, local (spill) bytes per thread, threads per block.
extern "C" int dcrt_brute_resources(int* out) {
  constexpr int kFns = 4;
  const void* fns[kFns] = {
      reinterpret_cast<const void*>(closest_kernel<MoellerSieve>),
      reinterpret_cast<const void*>(closest_kernel<WatertightSieve>),
      reinterpret_cast<const void*>(any_kernel<MoellerSieve>),
      reinterpret_cast<const void*>(any_kernel<WatertightSieve>)};
  const int smem = smem_bytes(kResidentRows);
  for (int f = 0; f < kFns; ++f) {
    cudaError_t err = cudaFuncSetAttribute(
        fns[f], cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, fns[f])) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             out + 5 * f, fns[f], kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = kThreads;
  }
  return static_cast<int>(cudaGetLastError());
}
