// Work-list traversal of clustered scenes, for Hopper (sm_90a).
//
// Replaces eight TPU kernels of directcomputeraytracing_tpu/accel/
// worklist.py and keeps their contracts (accel/worklist.py in the port
// holds the glue and the PyTorch twins):
//   cull_kernel    <- _cull_super_kernel (:365, launched by _cull_super
//                     :370): min entry distance over a block's rays, per
//                     (block, box), BIG where no ray enters within t_max;
//   refine_kernel  <- _refine_kernel (:445, launched by _refine_items
//                     :479): the same per (block, hyper) item over the
//                     hyper's member supers (both: see their section);
//   closest_grouped_kernel <- _wlg_closest_kernel (:1000): the closest hit
//                     by warps that each walk their ray block's items on
//                     their own (see its section below);
//   any_grouped_kernel     <- _wlg_any_kernel (:1113): occlusion, the same;
//   closest_ray_kernel<Tri, false> <- _wl_closest_kernel (:678, launched
//                     by _closest_impl :1750): closest hit per ray, a
//                     bit-packed argmin, by warps that walk their items on
//                     their own (see its section below);
//   closest_ray_kernel<Tri, true>  <- _wl_closest_inst_kernel (:1208): the
//                     same on instanced tables;
//   any_ray_kernel<Tri, false>     <- _wl_any_kernel (:866, launched by
//                     _any_impl :1916): occlusion within a per-ray t_max,
//                     by the same warp walk (see its section below);
//   any_ray_kernel<Tri, true>      <- _wl_any_inst_kernel (:1349): the
//                     same on instanced tables.
// Rays are the (9, Rp) rows [o; d; 1/d] of prep_rays, Rp a multiple of
// the block size RB (the culls run kCullThreads-thread blocks, one or a
// few per ray block, boxes on lanes; the sweeps kGroupThreads-thread
// blocks, several per ray block, one warp per 32 rays).
//
// What bounds them. The culls: FP32 ALU, ~30 instructions per (ray, box),
// the rays staged once per CUDA block and each box's min kept in a
// register (one barrier per chunk of up to 64 boxes), and on casts of a
// few ray blocks the latency of the staging. The sweeps: FP32 ALU in
// the per-ray fine cull (32 slab tests per item) and the triangle tests,
// and the latency of reading item boxes and 64-byte triangle rows from
// L2; rays of one warp that pick different clusters diverge.
//
// Design. The TPU grid walked (block, super) items in order and carried
// the best hit across them in the output block and a termination bound in
// an SMEM scalar. Here a ray's walk runs in one thread, over its ray
// block's item segment front to back, its packed best hit in registers.
// Every sweep lets each warp walk its ray block's items on its own (the
// sections below): it skips the items none of its rays can enter, copies
// the next item's boxes into shared memory while it sweeps the current
// one, and stops once its rays are done, with no block-wide barrier. The
// packed key is (bits(t) & ~kLowM) | (child << 4) | row, as in the
// reference, and a cluster's smallest key replaces
// the best only if strictly smaller; a candidate needs t inside the best's
// whole truncation quantum (window(), where the reference takes t < the
// best read as a float), so the result does not depend on the visiting
// order. Built with -fmad=false: kernels and twins agree bit for bit.
// The per-ray walk (fine cull, nearest-first cluster walk, occlusion
// walk) lives in worklist.cuh, shared with the pair sweep (pairsweep.cu).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "worklist.cuh"

namespace {

using dcrt::BaldwinWeber;
using dcrt::Best;
using dcrt::child_enter;
using dcrt::cp_async16;
using dcrt::cp_async_commit;
using dcrt::cp_async_wait;
using dcrt::Hit;
using dcrt::kBig;
using dcrt::kCluster;
using dcrt::kLowM;
using dcrt::kSuper;
using dcrt::kSuperRows;
using dcrt::load_od;
using dcrt::RawWatertight;
using dcrt::Ray;
using dcrt::RayInv;
using dcrt::slab;
using dcrt::start_best;
using dcrt::window;

// ---------------------------------------------------------------------------
// The culls <- _cull_super_kernel (:365, launched by _cull_super :370) and
// _refine_kernel (:445, launched by _refine_items :479): cull_kernel and
// refine_kernel, one body (entry_min_list).
//
// Both take, per ray block, a list of boxes and write for each the minimum
// over the block's rays of the clamped entry distance, kBig where no ray
// enters within its t_max. The cull's list is the same n boxes for every
// ray block (row b of the (nb, n) output); the refine's is the member
// supers of the block's (block, hyper) items, hs each, items
// seg[b]..seg[b + 1] of the block-sorted item list, whose rows of the
// (n_items, hs) output are contiguous: box j of block b is member j % hs of
// item seg[b] + j / hs and lands at out[seg[b] * hs + j]. So the cull is
// the refine of one item per block whose members are all n boxes.
//
// What bounds them: the ALU pipe (half the FP32 rate on Hopper), which
// runs the slab test's min/max and the compares: 14 of its instructions
// per (ray, box) beside 12 FP32 subtractions and products, against
// FLOPS_SLAB = 20 operations in the bound; on casts of a few ray blocks,
// the latency of staging the rays. The first port gave each (ray block,
// 32-box chunk) (cull) or item (refine) one 1024-thread block: every
// thread slab-tested its own ray against each box and took a 5-step
// shuffle butterfly per (warp, box) (five shuffles and five min per box
// beside the ~20 of the test), one barrier per 32 boxes; the refine
// reloaded its ray block's rays (40 B a ray) for every item, and a block
// of 1024 threads held a whole SM, idle at every barrier.
//
// Design. A CUDA block of kCullThreads threads stages its ray block's rays
// once into shared memory as the slab test reads them (origin and cap,
// then 1/d: 32 bytes a ray), then walks the block's box list in chunks of
// 2G boxes. Boxes ride lanes: thread t holds boxes t % G and t % G + G of
// the chunk in registers and loops over the rays of its slice (rays
// t / G, t / G + 256 / G, ...; the lanes of a slice read the same ray, a
// shared-memory broadcast), keeping each box's running min in a register,
// so there is no shuffle per (ray, box). A slice's partial minima meet the
// other slices' once per chunk: the slices of a warp by log2(32 / G)
// shuffles, the warps' in shared memory after one barrier, where one
// thread per box takes the min over the 8 warps and writes it. A chunk of
// at most G boxes runs one box a thread, and so do the G-box chunks of
// casts of very few ray blocks (k_max = 1, cull_shape). G is the widest
// of 32, 16 and 8 that wastes at most an eighth of a list's lanes (a
// refine list is hs times its items: 8 lanes fit hs = 8 exactly), at most
// the launcher's width. A ray block's chunks go to `split` CUDA blocks
// (blockIdx.y takes chunks blockIdx.y, blockIdx.y + split, ...), each
// staging the rays once (cull_shape): a list of one chunk, as most
// camera-ray lists are, is read with its rays once; long lists are cut so
// that no few of them hold the card; and casts of few ray blocks (an
// alpha recast pass, a late bounce), which would fill few SMs, also
// narrow G and may hold one box a thread. The slab test
// drops the +-kBig clamps of its first axis (two ALU instructions a
// pair) and the staged cap makes up for them (cull_cap), and the enter
// rule is y >= max(x, 0) && x <= cap: the same result as the twin's for
// every input. A min is order-free, so the output equals the twin's bit
// for bit. Copying the rays by cp.async would overlap nothing: a CUDA
// block has one ray block to stage. With 36 KB of shared memory six
// blocks fit an SM, and __launch_bounds__(256, kCullFill) holds a thread
// to their 40 registers (4 bytes spill); left to itself the compiler gave
// the cull 52 and four blocks an SM, 4-5 % slower on 1M-ray casts
// (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kCullThreads = 256;          // threads per CUDA block
constexpr int kCullFill = 6;               // resident CUDA blocks an SM
constexpr int kCullWarps = kCullThreads / 32;
constexpr int kCullMaxK = 2;               // boxes a thread holds
constexpr int kCullRow = kCullMaxK * 32;   // boxes of a chunk, at most
constexpr int kMaxRb = 1024;               // rays per ray block, at most

struct CullSmem {
  float4 ray[kMaxRb][2];                   // (ox, oy, oz, cap), (1/d, 0)
  float part[2][kCullWarps][kCullRow];     // warp partials, two chunks deep
};

// The cap a ray is staged with: with it, the unclamped slab test's entry x
// and exit y enter by y >= max(x, 0) && x <= cap exactly where the
// clamped test's t_lo = max(x, -kBig) and t_hi = min(y, kBig) enter by
// t_hi >= t_lo && t_hi >= 0 && t_lo <= t_max: that needs t_max >= -kBig
// (else NaN, which admits nothing) and x <= min(t_max, kBig).
__device__ __forceinline__ float cull_cap(float t_max) {
  return t_max >= -kBig ? fminf(t_max, kBig) : __int_as_float(0x7fffffff);
}

// The slab test without the +-kBig clamps: entry x, exit y.
__device__ __forceinline__ void slab_raw(const float4& o, const float4& v,
                                         const float* lo, const float* hi,
                                         float& x, float& y) {
  float a = (lo[0] - o.x) * v.x, b = (hi[0] - o.x) * v.x;
  x = fminf(a, b);
  y = fmaxf(a, b);
  a = (lo[1] - o.y) * v.y;
  b = (hi[1] - o.y) * v.y;
  x = fmaxf(x, fminf(a, b));
  y = fminf(y, fmaxf(a, b));
  a = (lo[2] - o.z) * v.z;
  b = (hi[2] - o.z) * v.z;
  x = fmaxf(x, fminf(a, b));
  y = fminf(y, fmaxf(a, b));
}

// The refine's box j of a ray block whose items start at item0 (the
// cull's: boxes[j], item0 = b, hyper 0, hs = n).
template <bool kCull>
__device__ __forceinline__ const float* list_box(
    const float* __restrict__ boxes, int hs, const int* __restrict__ hyp,
    int item0, int j) {
  if (kCull) return boxes + 8 * static_cast<size_t>(j);
  const int k = j / hs;
  return boxes + 8 * (static_cast<size_t>(__ldg(hyp + item0 + k)) * hs +
                      (j - k * hs));
}

// The chunk at j0 of nbox boxes: the thread's K boxes (j0 + k * g + slot;
// past the chunk's end a copy of its first, whose minimum is not written),
// their minima over the rays of its slice, then over the slices of its
// warp, into the warp's row of the partials.
template <int K, bool kCull>
__device__ __forceinline__ void chunk_min(
    const CullSmem& sm, float (*part)[kCullRow],
    const float* __restrict__ boxes, int hs, const int* __restrict__ hyp,
    int item0, int j0, int nbox, int g, int rb) {
  const int lane = threadIdx.x & 31, slot = threadIdx.x & (g - 1);
  const int slices = kCullThreads / g;
  float lo[K][3], hi[K][3], m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* b = list_box<kCull>(
        boxes, hs, hyp, item0, k * g + slot < nbox ? j0 + k * g + slot : j0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[k][c] = __ldg(b + c);
      hi[k][c] = __ldg(b + 3 + c);
    }
    m[k] = kBig;
  }
  for (int r = threadIdx.x / g; r < rb; r += slices) {
    const float4 o = sm.ray[r][0], v = sm.ray[r][1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x, y;
      slab_raw(o, v, lo[k], hi[k], x, y);
      const float t = fmaxf(x, 0.f);
      if (y >= t && x <= o.w) m[k] = fminf(m[k], t);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int off = g; off < 32; off <<= 1)
      m[k] = fminf(m[k], __shfl_xor_sync(0xffffffffu, m[k], off));
    if (lane < g) part[threadIdx.x >> 5][k * g + slot] = m[k];
  }
}

// The width of a list's box groups: the widest of 32, 16 and 8, at most
// 1 << g_max, that leaves at most an eighth of the list's lanes idle.
__device__ __forceinline__ int group_log2(int n_list, int g_max) {
  int gl = g_max;
  while (gl > 3 && ((-n_list) & ((1 << gl) - 1)) * 8 > n_list) --gl;
  return gl;
}

// The body of both culls for ray block blockIdx.x: its box list (the
// cull's n boxes, or the refine's items' members) in chunks of 2G boxes,
// chunks blockIdx.y, blockIdx.y + gridDim.y, ...
template <bool kCull>
__device__ __forceinline__ void entry_min_list(
    const float* __restrict__ boxes, int hs, const int* __restrict__ seg,
    const int* __restrict__ hyp, const float* __restrict__ od,
    const float* __restrict__ tm, int rp, int rb, int g_max, int k_max,
    float* __restrict__ out) {
  __shared__ CullSmem sm;
  const int b = blockIdx.x;
  const int item0 = kCull ? b : __ldg(seg + b);
  const int n_list = kCull ? hs : (__ldg(seg + b + 1) - item0) * hs;
  const int g = 1 << group_log2(n_list, g_max), chunk = k_max * g;
  const int n_chunks = (n_list + chunk - 1) / chunk;
  if (static_cast<int>(blockIdx.y) >= n_chunks) return;
  const size_t n = static_cast<size_t>(rp);
  for (int r = threadIdx.x; r < rb; r += kCullThreads) {
    const size_t i = static_cast<size_t>(b) * rb + r;
    sm.ray[r][0] = make_float4(od[i], od[n + i], od[2 * n + i],
                               cull_cap(tm[i]));
    sm.ray[r][1] = make_float4(od[6 * n + i], od[7 * n + i], od[8 * n + i],
                               0.f);
  }
  __syncthreads();
  float* const dst = out + static_cast<size_t>(item0) * hs;
  int buf = 0;
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y, buf ^= 1) {
    const int j0 = c * chunk, nbox = min(chunk, n_list - j0);
    if (k_max == 2 && nbox > g)
      chunk_min<2, kCull>(sm, sm.part[buf], boxes, hs, hyp, item0, j0, nbox,
                          g, rb);
    else
      chunk_min<1, kCull>(sm, sm.part[buf], boxes, hs, hyp, item0, j0, nbox,
                          g, rb);
    // the next chunk fills the other partials: one barrier a chunk
    __syncthreads();
    const int t = threadIdx.x;
    if (t < nbox) {
      float v = sm.part[buf][0][t];
      for (int w = 1; w < kCullWarps; ++w) v = fminf(v, sm.part[buf][w][t]);
      dst[j0 + t] = v;
    }
  }
}

__global__ void __launch_bounds__(kCullThreads, kCullFill)
cull_kernel(const float* __restrict__ boxes, int n_boxes,
            const float* __restrict__ od, const float* __restrict__ tm,
            int rp, int rb, int g_max, int k_max,
            float* __restrict__ out) {
  entry_min_list<true>(boxes, n_boxes, nullptr, nullptr, od, tm, rp, rb,
                       g_max, k_max, out);
}

__global__ void __launch_bounds__(kCullThreads, kCullFill)
refine_kernel(const float* __restrict__ hsup, int hs,
              const int* __restrict__ seg, const int* __restrict__ item_hyp,
              const float* __restrict__ od, const float* __restrict__ tm,
              int rp, int rb, int g_max, int k_max,
              float* __restrict__ out) {
  entry_min_list<false>(hsup, hs, seg, item_hyp, od, tm, rp, rb, g_max,
                        k_max, out);
}

// The culls' launch shape for nb ray blocks whose box lists hold up to
// max_list boxes: the widest box groups, 1 << g_max, and the boxes a
// thread holds, k_max (32 and 2; where nb x the chunks of a list falls
// short of kCullFill CUDA blocks an SM, 16 or 8, then 1), and the CUDA
// blocks per ray block, split: the chunks of the longest list, at most
// kCullSplit or, on casts of few ray blocks, kCullFill x SMs / nb. Lists
// of one cast differ in length (a sorted pool's ray blocks enter 0 to 64
// hypers), and many small CUDA blocks keep a few long lists from holding
// the card; those past their list's chunks exit before staging anything,
// which costs next to nothing (the refine of 1M camera rays took the same
// time at split 1, 8 and 12; PERF.md). On casts of few ray blocks, short
// chunks spread the work over more threads, each with a shorter chain.
constexpr int kCullSplit = 12;

void cull_shape(int nb, int max_list, int& g_max, int& k_max, int& split) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = max(sms, 1);
  }
  const int want = kCullFill * sms;
  auto chunks = [&](int gl, int k) {
    return (max_list + (k << gl) - 1) / (k << gl);
  };
  g_max = 5;
  k_max = kCullMaxK;
  while (g_max > 3 && nb * chunks(g_max, k_max) < want) --g_max;
  if (nb * chunks(g_max, k_max) < want) k_max = 1;
  split = max(1, min(chunks(g_max, k_max),
                     max(kCullSplit, (want + nb - 1) / nb)));
}

// ---------------------------------------------------------------------------
// Grouped sweeps <- _wlg_closest_kernel (:1000) and _wlg_any_kernel (:1113)
// (launched by _closest_impl :1750 and _any_impl :1916 with grouped=True).
//
// The TPU kernels gave each 128-lane group its own front-to-back cluster
// list; here the group is one warp (GL = 32). Per item, each lane's ray gets
// its fine cull of the 32 child boxes against its own best (closest) or
// t_max (any-hit; an occluded lane enters nothing). The warp's pick key for
// a child is (bits(t_g) & ~kKeyM) | child, held by lane `child`, t_g the
// least entry distance of the lanes that entered it (INT_MAX: none). Each
// step pops the two nearest keys with two __reduce_min_sync; every lane then
// sweeps the same cluster pair (uniform triangle loads), masked by its own
// fine cull. The closest walk stops once the nearest key, its low kKeyM bits
// cleared, starts beyond every lane's window (the group bound); the any-hit
// walk once every lane is occluded. Both clusters of a step are tested
// against the lane's window before the step, and the smallest candidate key
// replaces the best only if strictly smaller: the same hit as the per-ray
// sweep's (closest_ray_kernel), bit for bit. `iters` adds the step's
// clusters (1 or 2) for every lane that entered something in the item.
//
// What bounds them: FP32 ALU in the fine cull (32 slab tests of ~20
// operations per lane and item) and the triangle tests, and the latency
// of the loads of item boxes and triangle rows from L2. The first port
// walked a 1024-ray block in lockstep: two block-wide barriers per item
// (a vote, then the staging of the child boxes), every warp paying the
// slowest warp's walk and the whole fine cull of every item of its block,
// boxes loaded only after the barrier, and one 1024-thread block per SM.
//
// Design. Warps walk on their own: a CUDA block of kGroupThreads threads
// takes kGroupWarps warps of one ray block, and each warp walks the ray
// block's item segment with no block-wide barrier. Two cheap tests guard
// an item, both exact: the warp vote (closest: some lane's window lies
// beyond the item's entry distance, the first per-ray sweep's block vote
// taken per warp) and the super-box admission (some lane enters the
// item's admission box under its cap, enters() of worklist.cuh). The
// admission box (Tables.abox) is the min/max of the super's 32 child
// boxes as a slab test reads them, the super box itself unless the super
// holds padding (to a slab test an inverted padding box is the cube
// [-1, 1]^3). The slab planes are monotone in the box, so a lane that
// misses it enters no child: the fine cull would admit nothing, and
// results and `iters` are those of the walk without the test. The warp
// looks ahead 32 items at a time: lane j loads item j's super and entry
// distance and slab-tests its admission box against the warp's 32 rays
// (staged once in the warp's shared memory, their caps restaged per
// look-ahead), one ballot naming the admitted items. Caps only shrink
// along the walk, so an item refused early would be refused later; an
// admitted one is tested again, per lane, when its turn comes. The next
// admitted item's admission box and 32 child boxes (1,056 bytes) go by
// cp.async into a two-stage ring in the warp's shared memory while the
// current item is culled and swept. The pick keys come from a 32x32
// transpose: lane c tests child c against the warp's 32 staged rays and
// takes its key with no reduction, and the lanes' entry masks come back
// by 32 ballots (3-7 % faster than 32 per-lane child tests and 32
// __reduce_min_sync, PERF.md). 128-thread blocks at 8 resident per SM
// cap a thread at 64 registers: the closest kernels keep 8-32 bytes a
// thread in local memory. With the skips a warp does ~10 % of the block
// walk's fine cull on a sorted pool, and the walk's latency bounds it.
// ---------------------------------------------------------------------------

constexpr int kKeyM = 63;   // pick-key low bits: the child id
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupThreads = 128;                  // threads per CUDA block
constexpr int kGroupMinBlocks = 8;                  // resident per SM
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kStage = 2 + 2 * kSuper;              // float4 of a ring stage

// A warp's shared memory: the ring (each stage an item's admission box,
// then its 32 child boxes) and the warp's rays, (ox, oy, oz, cap) and (1/dx,
// 1/dy, 1/dz, 0) per lane.
struct WarpSmem {
  float4 stage[2][kStage];
  float4 ray[32][2];
};

// Start the copy of super `sup`'s boxes into a ring stage (every lane
// copies two child-box float4, lanes 0-1 the admission box).
__device__ __forceinline__ void prefetch_stage(float4* stage,
                                               const float* abox,
                                               const float* cbox, int sup) {
  const int lane = threadIdx.x & 31;
  const float4* c = reinterpret_cast<const float4*>(cbox) +
                    static_cast<size_t>(sup) * 2 * kSuper;
  cp_async16(stage + 2 + lane, c + lane);
  cp_async16(stage + 2 + 32 + lane, c + 32 + lane);
  if (lane < 2)
    cp_async16(stage + lane, reinterpret_cast<const float4*>(abox) +
                                 static_cast<size_t>(sup) * 2 + lane);
}

// Staged ray r (origin and inverse direction, all a slab test reads) and
// its cap.
__device__ __forceinline__ RayInv staged_ray(const WarpSmem& sm, int r,
                                             float& cap) {
  const float4 o = sm.ray[r][0], v = sm.ray[r][1];
  cap = o.w;
  return RayInv{Ray{o.x, o.y, o.z, 0.f, 0.f, 0.f}, v.x, v.y, v.z};
}

// Restage the lane's cap beside its ray (every lane, converged).
__device__ __forceinline__ void stage_cap(WarpSmem& sm, float cap) {
  __syncwarp();
  sm.ray[threadIdx.x & 31][0].w = cap;
  __syncwarp();
}

// An item of a warp's walk: its super and entry distance and, on
// instanced tables, the super's local super and instance.
struct Item {
  int sup;
  float t;
  int loc, ins;
};

// The warp's look-ahead over its ray block's items [next, end), 32 at a
// time: lane j holds item base + j, `adm` the items of the chunk that
// passed the vote and the admission.
struct ItemScan {
  int next, end, base;
  unsigned adm;
  Item it;
};

__device__ __forceinline__ ItemScan item_scan(const int* __restrict__ seg) {
  return ItemScan{seg[blockIdx.x], seg[blockIdx.x + 1], 0, 0u,
                  Item{0, 0.f, 0, 0}};
}

// The next admitted item, or false at the segment's end. kVote: closest
// (caps are the lanes' windows, and the warp vote applies). kInst: read
// the admitted items' local supers and instances (isup_local, isup_inst),
// one load per lane for the whole chunk.
template <bool kVote, bool kInst = false>
__device__ __forceinline__ bool next_item(
    ItemScan& sc, WarpSmem& sm, const int* __restrict__ item_sup,
    const float* __restrict__ item_t, const float* __restrict__ abox,
    float cap, float t_min, Item& out,
    const int* __restrict__ isup_local = nullptr,
    const int* __restrict__ isup_inst = nullptr) {
  const int lane = threadIdx.x & 31;
  while (!sc.adm) {
    if (sc.next >= sc.end) return false;
    sc.base = sc.next;
    sc.next += 32;
    const int j = sc.base + lane;
    const bool in = j < sc.end;
    sc.it.sup = in ? __ldg(item_sup + j) : 0;
    sc.it.t = kVote && in ? __ldg(item_t + j) : 0.f;
    bool a = in;
    if (kVote) {
      // windows are positive: their bits order like their values
      const float top =
          __int_as_float(__reduce_max_sync(kFull, __float_as_int(cap)));
      a = a && top > sc.it.t;
    }
    stage_cap(sm, cap);
    if (__any_sync(kFull, a)) {
      const float4* sb = reinterpret_cast<const float4*>(abox) +
                         static_cast<size_t>(sc.it.sup) * 2;
      const float4 lo = __ldg(sb), hi = __ldg(sb + 1);
      bool e = false;
      for (int r = 0; r < 32; ++r) {
        float c, t_lo, t_hi;
        const RayInv q = staged_ray(sm, r, c);
        slab(q, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, t_lo, t_hi);
        e = e || dcrt::enters(t_lo, t_hi, c, t_min);
      }
      a = a && e;
    }
    sc.adm = __ballot_sync(kFull, a);
    if (kInst && a) {
      sc.it.loc = __ldg(isup_local + sc.it.sup);
      sc.it.ins = __ldg(isup_inst + sc.it.sup);
    }
  }
  const int j = __ffs(sc.adm) - 1;
  sc.adm &= sc.adm - 1;
  out.sup = __shfl_sync(kFull, sc.it.sup, j);
  out.t = __shfl_sync(kFull, sc.it.t, j);
  if (kInst) {
    out.loc = __shfl_sync(kFull, sc.it.loc, j);
    out.ins = __shfl_sync(kFull, sc.it.ins, j);
  }
  return true;
}

// The warp's pick keys for the staged item (boxes: its 32 child boxes):
// lane c tests child c against the warp's rays under their caps and holds
// its key; ray r's mask of entered children comes back by ballot. Returns
// the lane's mask. `cap` is the lane's fine-cull ceiling.
__device__ __forceinline__ unsigned group_keys(WarpSmem& sm,
                                               const float4* boxes,
                                               float cap, float t_min,
                                               int& key) {
  const int lane = threadIdx.x & 31;
  const int big = __float_as_int(kBig);
  stage_cap(sm, cap);
  const float4 lo = boxes[2 * lane], hi = boxes[2 * lane + 1];
  unsigned mask = 0u;
  int m = big;
  for (int r = 0; r < 32; ++r) {
    float c, t_lo, t_hi;
    slab(staged_ray(sm, r, c), lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, t_lo,
         t_hi);
    const bool e = dcrt::enters(t_lo, t_hi, c, t_min);
    // entry distances are >= 0 (the sign bit is masked for -0.0), so
    // their bits order like their values
    if (e) m = min(m, __float_as_int(fmaxf(t_lo, 0.f)) & INT_MAX);
    const unsigned bal = __ballot_sync(kFull, e);
    if (lane == r) mask = bal;
  }
  key = m < big ? (m & ~kKeyM) | lane : INT_MAX;
  return mask;
}

// Pop the warp's nearest key; INT_MAX when none is left.
__device__ __forceinline__ int pop_key(int& key) {
  const int k = __reduce_min_sync(kFull, key);
  if (k != INT_MAX && (threadIdx.x & 31) == (k & kKeyM)) key = INT_MAX;
  return k;
}

// The super-box admission of the staged item: does some lane enter its
// admission box under its cap?
__device__ __forceinline__ bool admitted(const RayInv& q, const float4* stage,
                                         float cap, float t_min) {
  float t_lo;
  return __any_sync(kFull, child_enter(q, stage, 0, cap, t_min, t_lo));
}

// One item of the closest walk, its boxes staged (entry distance te).
template <class Tri>
__device__ __forceinline__ void closest_item(const RayInv& q,
                                             const typename Tri::Pre& pre,
                                             WarpSmem& sm, const float4* stage,
                                             int sup, float te,
                                             const float* __restrict__ tab,
                                             float t_min, Best& s) {
  const float cap = window(s.best);
  // the warp vote, then the admission
  if (!__any_sync(kFull, cap > te) || !admitted(q, stage, cap, t_min)) return;
  int key;
  const unsigned mask = group_keys(sm, stage + 2, cap, t_min, key);
  for (;;) {
    const int p1 = pop_key(key);
    const int p2 = p1 == INT_MAX ? INT_MAX : pop_key(key);
    // stop once the nearest cluster starts beyond every lane's window
    const int bound = __reduce_max_sync(kFull, s.best) | kLowM;
    if (p1 == INT_MAX || !((p1 & ~kKeyM) <= bound)) break;
    const int c1 = p1 & kKeyM, c2 = p2 & kKeyM;
    const bool has2 = p2 != INT_MAX;
    if (mask) s.iters += has2 ? 2 : 1;
    const float t_max = window(s.best);
    int cand = INT_MAX, crow = -1;
    Hit hc{0.f, 0.f, 0.f, false};
    for (int j = 0; j < 2; ++j) {
      const int c = j ? c2 : c1;
      if ((j && !has2) || !((mask >> c) & 1u)) continue;
      dcrt::test_cluster<Tri, true>(q.r, pre, tab,
                                    (sup * kSuper + c) * kCluster, c, t_min,
                                    t_max, cand, hc, crow);
    }
    s.take(cand, hc, crow);
  }
}

// One item of the occlusion walk, its boxes staged.
template <class Tri>
__device__ __forceinline__ void any_item(const RayInv& q,
                                         const typename Tri::Pre& pre,
                                         WarpSmem& sm, const float4* stage,
                                         int sup,
                                         const float* __restrict__ tab,
                                         float t_max, float t_min,
                                         bool& occ) {
  const float cap = occ ? -kBig : t_max;
  if (!admitted(q, stage, cap, t_min)) return;
  int key;
  const unsigned mask = group_keys(sm, stage + 2, cap, t_min, key);
  for (;;) {
    const int p1 = pop_key(key);
    const int p2 = p1 == INT_MAX ? INT_MAX : pop_key(key);
    if (p1 == INT_MAX || __all_sync(kFull, occ)) break;
    const int c1 = p1 & kKeyM, c2 = p2 & kKeyM;
    for (int s = 0; s < 2 && !occ; ++s) {
      const int c = s ? c2 : c1;
      if ((s && p2 == INT_MAX) || !((mask >> c) & 1u)) continue;
      const int base = (sup * kSuper + c) * kCluster;
      for (int r = 0; r < kCluster; ++r) {
        Hit h;
        if (Tri::test(q.r, pre, tab, base + r, t_min, t_max, h)) {
          occ = true;
          break;
        }
      }
    }
  }
}

// The warp's rays: lane's ray index i (-1: the warp lies past the ray
// block), staged into the warp's shared memory.
__device__ __forceinline__ int warp_ray(int rb) {
  const int w = blockIdx.y * kGroupWarps + (threadIdx.x >> 5);
  if (w * 32 >= rb) return -1;
  return blockIdx.x * rb + w * 32 + (threadIdx.x & 31);
}

__device__ __forceinline__ void stage_ray(WarpSmem& sm, const RayInv& q) {
  const int lane = threadIdx.x & 31;
  sm.ray[lane][0] = make_float4(q.r.ox, q.r.oy, q.r.oz, 0.f);
  sm.ray[lane][1] = make_float4(q.ix, q.iy, q.iz, 0.f);
}

template <class Tri>
__global__ void __launch_bounds__(kGroupThreads, kGroupMinBlocks)
closest_grouped_kernel(const int* __restrict__ seg,
                       const int* __restrict__ item_sup,
                       const float* __restrict__ item_t,
                       const float* __restrict__ abox,
                       const float* __restrict__ cbox,
                       const float* __restrict__ tab,
                       const float* __restrict__ od,
                       const float* __restrict__ texp, int rp, int rb,
                       float t_min, dcrt::ClosestOut out) {
  __shared__ WarpSmem smem[kGroupWarps];
  const int i = warp_ray(rb);
  if (i < 0) return;
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const RayInv q = load_od(od, rp, i);
  stage_ray(sm, q);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  Best s = start_best(texp[i]);
  ItemScan sc = item_scan(seg);
  Item it;
  bool have = next_item<true>(sc, sm, item_sup, item_t, abox,
                              window(s.best), t_min, it);
  if (have) prefetch_stage(sm.stage[0], abox, cbox, it.sup);
  cp_async_commit();
  for (int st = 0; have; st ^= 1) {
    Item it2;
    const bool have2 = next_item<true>(sc, sm, item_sup, item_t, abox,
                                       window(s.best), t_min, it2);
    if (have2) prefetch_stage(sm.stage[st ^ 1], abox, cbox, it2.sup);
    cp_async_commit();
    cp_async_wait<1>();   // this item's stage has landed
    __syncwarp();
    closest_item<Tri>(q, pre, sm, sm.stage[st], it.sup, it.t, tab, t_min,
                      s);
    __syncwarp();         // the stage is read before it is refilled
    have = have2;
    it = it2;
  }
  dcrt::store_soup<Tri>(out, i, tab, s, s.row);
}

template <class Tri>
__global__ void __launch_bounds__(kGroupThreads, kGroupMinBlocks)
any_grouped_kernel(const int* __restrict__ seg,
                   const int* __restrict__ item_sup,
                   const float* __restrict__ abox,
                   const float* __restrict__ cbox,
                   const float* __restrict__ tab,
                   const float* __restrict__ od, const float* __restrict__ tm,
                   int rp, int rb, float t_min,
                   unsigned char* __restrict__ out_occ) {
  __shared__ WarpSmem smem[kGroupWarps];
  const int i = warp_ray(rb);
  if (i < 0) return;
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const RayInv q = load_od(od, rp, i);
  stage_ray(sm, q);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  const float t_max = tm[i];
  bool occ = false;
  ItemScan sc = item_scan(seg);
  Item it;
  bool have = next_item<false>(sc, sm, item_sup, nullptr, abox, t_max,
                               t_min, it);
  if (have) prefetch_stage(sm.stage[0], abox, cbox, it.sup);
  cp_async_commit();
  // stop once every ray of the warp is occluded
  for (int st = 0; have && !__all_sync(kFull, occ); st ^= 1) {
    Item it2;
    const bool have2 = next_item<false>(sc, sm, item_sup, nullptr, abox,
                                        occ ? -kBig : t_max, t_min, it2);
    if (have2) prefetch_stage(sm.stage[st ^ 1], abox, cbox, it2.sup);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    any_item<Tri>(q, pre, sm, sm.stage[st], it.sup, tab, t_max, t_min,
                  occ);
    __syncwarp();
    have = have2;
    it = it2;
  }
  cp_async_wait<0>();     // no copy in flight into a finished warp's ring
  out_occ[i] = occ;
}

// ---------------------------------------------------------------------------
// Instanced sweeps <- _wl_closest_inst_kernel (:1208) and _wl_any_inst_kernel
// (:1349) (launched by _closest_impl :1722 and _any_impl :1889 on scenes
// with instanced tables): closest_ray_kernel<Tri, true> and
// any_ray_kernel<Tri, true> (the next two sections).
//
// The tables share each mesh's triangles: the slab rows are mesh-local,
// stored once, and a super is an (instance, local super) pair with world
// child boxes (isup_cbox). Items, the votes, the admission and the per-ray
// fine cull are the soup's, in world space with the world ray, so entry
// distances compare across items. The item's super gives its local super
// (isup_local) and its instance (isup_inst); the instance's world->local
// transform (12 floats of its inst_rows row) goes into the warp's ring
// beside the child boxes, and the ray is moved to local space once per
// item that its fine cull entered (to_local, the reference's _local_rays:
// the direction is not normalised, so t stays the world ray's parameter
// and the packed keys compare across instances; Tri::prepare runs on the
// local ray, since the watertight permutation follows the direction). The
// rows swept are (loc * kSuper + c) * kCluster + r. The closest kernel
// keeps the winning item's instance: the hit's instance is it, tri is the
// slab row's global id, and the back-face flag is the local test's as it
// is (a mirroring instance turns the world normal, and the soup's flip
// column turns it back; the reference's kernel XORs the flip in again,
// :1323).
//
// What bounds them: as on the soup, FP32 ALU in the fine cull (32 ray-box
// tests of ~20 operations per item) and in the triangle tests (31
// operations Baldwin-Weber, ~45 watertight, 16 per swept cluster), plus 33
// operations per entered item for the local ray, and the latency of
// reading item boxes and triangle rows from L2. Instanced supers are many
// and overlap, so a ray block walks more items than on the soup (340-690
// per incoherent 1024-ray block of sphere_grid(27, 27), PERF.md; the TPU's
// census: 44.3 clusters swept per ray against 8.0), and most of a block's
// items hold nothing for most of its warps. Both kernels walk by warps, so
// a warp pays the fine cull only of the items one of its own rays enters
// (3-4 % of its items on incoherent sets, PERF.md). Built with
// -fmad=false, so the local ray rounds as in the twin.
// ---------------------------------------------------------------------------

// [o, 1] @ M and d @ M for the (4, 3) world->local transform M in
// m[0..11], term by term in the twin's order.
__device__ __forceinline__ Ray to_local(const Ray& r, const float* m) {
  Ray l;
  l.ox = r.ox * m[0] + r.oy * m[3] + r.oz * m[6] + m[9];
  l.oy = r.ox * m[1] + r.oy * m[4] + r.oz * m[7] + m[10];
  l.oz = r.ox * m[2] + r.oy * m[5] + r.oz * m[8] + m[11];
  l.dx = r.dx * m[0] + r.dy * m[3] + r.dz * m[6];
  l.dy = r.dx * m[1] + r.dy * m[4] + r.dz * m[7];
  l.dz = r.dx * m[2] + r.dy * m[5] + r.dz * m[8];
  return l;
}

constexpr int kInstCols = 16;   // inst_rows: 3x3 | t | flip | 0 0 0
constexpr int kInstXf = 12;     // the columns of the transform

// ---------------------------------------------------------------------------
// Per-ray closest sweeps <- _wl_closest_kernel (:678) and
// _wl_closest_inst_kernel (:1208) (launched by _closest_impl :1750 and
// :1722): closest_ray_kernel<Tri, kInst>, kInst on instanced tables.
//
// Each ray keeps its own walk, exactly: per item its fine cull of the 32
// child boxes under its own window, then its nearest-first sweep of the
// clusters it entered (walk_closest), so the hit, the sweep state and
// `iters` (the clusters the ray itself swept) are the per-ray contract's
// (accel/worklist.py), unlike the grouped walk, whose warps pop shared
// pick keys.
//
// What bounds it: FP32 ALU in the fine cull and the triangle tests, and
// the latency of reading item boxes and triangle rows from L2. The first
// port gave a 1024-ray block one CUDA block walking its items in
// lockstep: per item a block-wide vote (__syncthreads_or) and a barrier
// after staging the 1 KB of child boxes, which were loaded only after it;
// every thread ran the whole fine cull of every item its block voted for,
// also where no ray of its warp entered the super; one resident block per
// SM at 64 registers, and the fine cull's 32 entry distances spilled.
//
// Design: the grouped sweeps' warp walk (previous sections) around the
// per-ray walk. 128-thread blocks over (rp / RB) x (RB / 128); each warp
// walks its ray block's item segment on its own, with no block-wide
// barrier. The look-ahead (next_item) votes per warp (some lane's window
// beyond the item's entry distance) and admits an item only if one of
// the warp's rays enters its admission box under its window; both tests
// are exact, caps only shrink along the walk, and each is taken again per
// item with the lanes' current windows before the fine cull. The next
// admitted item's admission box and 32 child boxes (and, on instanced
// tables, its instance's transform, 48 bytes of the 64-byte inst_rows
// row) go by cp.async into the warp's two-stage ring while the current
// item is culled and swept. Without a t_cap every skip is one the fine
// cull would make, so results and `iters` are the first port's bit for
// bit; with one, the vote is per warp where the first port's was per
// block (accel/worklist.py _voted: decoded hits are the same). One
// exception: a padding child's inverted box reads to the slab test as
// the cube [-1, 1]^3, which may lie outside the super box, so a ray that
// enters the cube in front of its hit swept the padded super's empty
// clusters whenever its block voted for the item, and now only when its
// warp does; `iters` alone differs there, by exactly those clusters (3
// rays of 262,144 on an instanced set; tools/worklist_ab.py
// padding_iters counts them). With the skips a
// warp admits 3-9 % of its (item, warp) pairs on incoherent sets, so a
// ray runs 3-9 % of the block walk's fine cull there; on an NVIDIA H100
// 80GB HBM3 at 700 W the sorted 2^18-ray pool of sphere_grid(12, 12)
// takes 0.842 ms against the first port's 6.615, 1M shadow rays 5.13
// against 43.56, and on sphere_grid(27, 27) 4.98 against 60.19
// (Baldwin-Weber; PERF.md). The grouped kernels' layout, 8 resident
// blocks per SM, caps a thread at 64 registers: it spills 154 bytes (214
// on instanced tables). Measured against it on the same card (PERF.md),
// 4 blocks (116-128 registers, no spill) ran 2-25 % slower on every set
// but one, since fewer warps hide less latency, and 6 (80 registers, 74
// and 142 bytes) up to 4 % faster on the soup's sorted pool and camera
// rays and up to 9 % slower on the other sets.
// ---------------------------------------------------------------------------

// A warp's shared memory on instanced tables: the ring, the rays and each
// stage's instance transform.
struct InstWarpSmem : WarpSmem {
  float4 xf[2][kInstXf / 4];
};

// Start the copy of item `it`'s boxes (and, kInst, its instance's
// transform: lanes 0-2) into ring stage st.
template <bool kInst, class Smem>
__device__ __forceinline__ void prefetch_item(Smem& sm, int st,
                                              const float* abox,
                                              const float* cbox,
                                              const float* inst_rows,
                                              const Item& it) {
  prefetch_stage(sm.stage[st], abox, cbox, it.sup);
  if constexpr (kInst) {
    const int lane = threadIdx.x & 31;
    if (lane < kInstXf / 4)
      cp_async16(sm.xf[st] + lane,
                 reinterpret_cast<const float4*>(inst_rows) +
                     static_cast<size_t>(it.ins) * (kInstCols / 4) + lane);
  }
}

// One item of a ray's walk, its boxes staged (xf: its instance's
// transform, kInst). Returns whether the ray's best improved.
template <class Tri, bool kInst>
__device__ __forceinline__ bool ray_item(const RayInv& q,
                                         const typename Tri::Pre& pre,
                                         const float4* stage, const float* xf,
                                         const Item& it,
                                         const float* __restrict__ tab,
                                         float t_min, Best& s) {
  const float cap = window(s.best);
  // the warp vote, then the admission
  if (!__any_sync(kFull, cap > it.t) || !admitted(q, stage, cap, t_min))
    return false;
  float tl[kSuper];
  const unsigned mask = dcrt::fine_cull(q, stage + 2, cap, t_min, tl);
  if constexpr (kInst) {
    if (!mask) return false;
    const Ray rl = to_local(q.r, xf);
    return dcrt::walk_closest<Tri, true>(rl, Tri::prepare(rl), tab,
                                         it.loc * kSuperRows, t_min, tl,
                                         mask, s);
  } else {
    return dcrt::walk_closest<Tri, true>(q.r, pre, tab, it.sup * kSuperRows,
                                         t_min, tl, mask, s);
  }
}

template <class Tri, bool kInst>
__global__ void __launch_bounds__(kGroupThreads, kGroupMinBlocks)
closest_ray_kernel(const int* __restrict__ seg,
                   const int* __restrict__ item_sup,
                   const float* __restrict__ item_t,
                   const float* __restrict__ abox,
                   const float* __restrict__ cbox,
                   const float* __restrict__ tab,
                   const int* __restrict__ isup_local,
                   const int* __restrict__ isup_inst,
                   const float* __restrict__ inst_rows,
                   const float* __restrict__ od,
                   const float* __restrict__ texp, int rp, int rb,
                   float t_min, dcrt::ClosestOut out) {
  using Smem = std::conditional_t<kInst, InstWarpSmem, WarpSmem>;
  __shared__ Smem smem[kGroupWarps];
  const int i = warp_ray(rb);
  if (i < 0) return;
  Smem& sm = smem[threadIdx.x >> 5];
  const RayInv q = load_od(od, rp, i);
  stage_ray(sm, q);
  // the world ray's test setup (instanced tables: per item, local ray)
  const typename Tri::Pre pre = Tri::prepare(q.r);
  Best s = start_best(texp[i]);
  int binst = 0;
  ItemScan sc = item_scan(seg);
  Item it;
  bool have = next_item<true, kInst>(sc, sm, item_sup, item_t, abox,
                                     window(s.best), t_min, it, isup_local,
                                     isup_inst);
  if (have) prefetch_item<kInst>(sm, 0, abox, cbox, inst_rows, it);
  cp_async_commit();
  for (int st = 0; have; st ^= 1) {
    Item it2;
    const bool have2 = next_item<true, kInst>(
        sc, sm, item_sup, item_t, abox, window(s.best), t_min, it2,
        isup_local, isup_inst);
    if (have2) prefetch_item<kInst>(sm, st ^ 1, abox, cbox, inst_rows, it2);
    cp_async_commit();
    cp_async_wait<1>();   // this item's stage has landed
    __syncwarp();
    const float* xf = nullptr;
    if constexpr (kInst) xf = reinterpret_cast<const float*>(sm.xf[st]);
    if (ray_item<Tri, kInst>(q, pre, sm.stage[st], xf, it, tab, t_min, s))
      binst = it.ins;
    __syncwarp();         // the stage is read before it is refilled
    have = have2;
    it = it2;
  }
  if constexpr (kInst) {
    const float tri =
        s.row >= 0
            ? tab[static_cast<size_t>(s.row) * Tri::kCols + Tri::kMeta]
            : 0.f;
    out.store(i, s, static_cast<int>(tri), s.row >= 0 ? binst : 0,
              s.row >= 0 && s.back);
  } else {
    dcrt::store_soup<Tri>(out, i, tab, s, s.row);
  }
}

// ---------------------------------------------------------------------------
// Per-ray any-hit sweeps <- _wl_any_kernel (:866) and _wl_any_inst_kernel
// (:1349) (launched by _any_impl :1916 and :1889): any_ray_kernel<Tri,
// kInst>, kInst on instanced tables. Every shadow ray of the megakernel
// takes one, and the instanced wavefront's pool any-hit casts take the
// instanced one.
//
// A ray is occluded iff some cluster that its fine cull admits under its
// t_max holds a hit in [t_min, t_max). That is order-free, so each lane
// keeps its own walk (its fine cull, then its entered clusters in child
// order until the first hit) and the answer is the twin's bit for bit,
// whichever items its warp skips, as long as it skips only items no lane
// of the warp could enter.
//
// What bounds it: FP32 ALU in the fine cull and the triangle tests, and
// the latency of reading item boxes and triangle rows from L2. Shadow
// rays mostly end unoccluded, so they walk every item of their block. The
// first port gave a 1024-ray block one CUDA block walking its items in
// lockstep: per item a block-wide vote (__syncthreads_and) and a barrier
// after staging the 1 KB of child boxes, which were loaded only after it;
// every thread ran the fine cull of every item its block had, also where
// no ray of its warp entered the super.
//
// Design: the grouped sweeps' warp walk around the per-ray occlusion walk
// (the closest kernel's, previous section, with the occlusion walk in
// place of the nearest-first one). 128-thread blocks over (rp / RB) x (RB
// / 128); each warp walks its ray block's item segment on its own, with no
// block-wide barrier. A lane is done once it is occluded, and from the
// start where t_max <= t_min (no hit lies in [t_min, t_max); padding rays
// are parked so): its cap is then -kBig, the reference's cap_row for an
// occluded ray, so it enters nothing, and the warp stops once every lane
// is done. The look-ahead (next_item) admits an item only if a lane
// enters its admission box under its cap; caps only shrink along the
// walk, and the admission is taken again per item with the current caps
// before the lanes' fine cull. The next admitted item's admission box and
// 32 child boxes (and, on instanced tables, its instance's transform) go
// by cp.async into the warp's two-stage ring while the current item is
// culled and swept. A lane moves its ray to instance space only for an
// item whose fine cull it entered, and the warps of a ray block without
// items read no ray. There is no array of entry distances, so the walk
// fits the 64 registers of 8 resident 128-thread blocks (56-64, no spill).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/worklist_ab.py, in
// turns with the block walk, Baldwin-Weber; PERF.md): on sphere_grid(12,
// 12) the sorted 2^18-ray pool 3.705 -> 0.335 ms, 1M shadow rays 36.93 ->
// 3.455, 1M random rays 15.91 -> 1.035; on sphere_grid(27, 27) 1M shadow
// rays 52.61 -> 3.108, the pool 7.879 -> 0.563. Camera rays (t_max up to
// 30) stop after a few items: 0.563 -> 0.309 on the soup, but 0.0322 ->
// 0.0451 on the instanced tables, where 374 items fall on 1,024 ray
// blocks and a warp with an item pays the walk's fixed cost (its rays
// staged, the look-ahead's 32 admission tests a lane, the admission
// again) beside the fine cull that was all the block walk did.
// ---------------------------------------------------------------------------

// The occlusion walk over the entered clusters (mask) of a super whose
// rows start at row0 of tab, in child order, each tested with ray r; true
// at the first hit in [t_min, t_max).
template <class Tri>
__device__ __forceinline__ bool any_clusters(const Ray& r,
                                             const typename Tri::Pre& pre,
                                             const float* __restrict__ tab,
                                             int row0, unsigned mask,
                                             float t_min, float t_max) {
  for (; mask; mask &= mask - 1) {
    const int base = row0 + (__ffs(mask) - 1) * kCluster;
    for (int k = 0; k < kCluster; ++k) {
      Hit h;
      if (Tri::test(r, pre, tab, base + k, t_min, t_max, h)) return true;
    }
  }
  return false;
}

// One item of a ray's occlusion walk, its boxes staged (xf: its
// instance's transform, kInst). done: the lane's answer is known; occ:
// the lane is occluded.
template <class Tri, bool kInst>
__device__ __forceinline__ void any_ray_item(const RayInv& q,
                                             const typename Tri::Pre& pre,
                                             const float4* stage,
                                             const float* xf, const Item& it,
                                             const float* __restrict__ tab,
                                             float t_max, float t_min,
                                             bool& done, bool& occ) {
  if (!admitted(q, stage, done ? -kBig : t_max, t_min) || done) return;
  float tl[kSuper];   // unread: the walk takes the clusters in child order
  const unsigned mask = dcrt::fine_cull(q, stage + 2, t_max, t_min, tl);
  if (!mask) return;
  if constexpr (kInst) {
    const Ray rl = to_local(q.r, xf);
    occ = any_clusters<Tri>(rl, Tri::prepare(rl), tab, it.loc * kSuperRows,
                            mask, t_min, t_max);
  } else {
    occ = any_clusters<Tri>(q.r, pre, tab, it.sup * kSuperRows, mask, t_min,
                            t_max);
  }
  done = occ;
}

template <class Tri, bool kInst>
__global__ void __launch_bounds__(kGroupThreads, kGroupMinBlocks)
any_ray_kernel(const int* __restrict__ seg, const int* __restrict__ item_sup,
               const float* __restrict__ abox, const float* __restrict__ cbox,
               const float* __restrict__ tab,
               const int* __restrict__ isup_local,
               const int* __restrict__ isup_inst,
               const float* __restrict__ inst_rows,
               const float* __restrict__ od, const float* __restrict__ tm,
               int rp, int rb, float t_min,
               unsigned char* __restrict__ out_occ) {
  using Smem = std::conditional_t<kInst, InstWarpSmem, WarpSmem>;
  __shared__ Smem smem[kGroupWarps];
  const int i = warp_ray(rb);
  if (i < 0) return;
  ItemScan sc = item_scan(seg);
  if (sc.next == sc.end) {   // a ray block without items: nothing to read
    out_occ[i] = 0;
    return;
  }
  Smem& sm = smem[threadIdx.x >> 5];
  const RayInv q = load_od(od, rp, i);
  stage_ray(sm, q);
  // the world ray's test setup (instanced tables: per item, local ray)
  const typename Tri::Pre pre = Tri::prepare(q.r);
  const float t_max = tm[i];
  bool occ = false, done = !(t_max > t_min);
  Item it;
  bool have = !__all_sync(kFull, done) &&
              next_item<false, kInst>(sc, sm, item_sup, nullptr, abox,
                                      done ? -kBig : t_max, t_min, it,
                                      isup_local, isup_inst);
  if (have) prefetch_item<kInst>(sm, 0, abox, cbox, inst_rows, it);
  cp_async_commit();
  // stop once every lane of the warp is done
  for (int st = 0; have && !__all_sync(kFull, done); st ^= 1) {
    Item it2;
    const bool have2 = next_item<false, kInst>(
        sc, sm, item_sup, nullptr, abox, done ? -kBig : t_max, t_min, it2,
        isup_local, isup_inst);
    if (have2) prefetch_item<kInst>(sm, st ^ 1, abox, cbox, inst_rows, it2);
    cp_async_commit();
    cp_async_wait<1>();   // this item's stage has landed
    __syncwarp();
    const float* xf = nullptr;
    if constexpr (kInst) xf = reinterpret_cast<const float*>(sm.xf[st]);
    any_ray_item<Tri, kInst>(q, pre, sm.stage[st], xf, it, tab, t_max,
                             t_min, done, occ);
    __syncwarp();         // the stage is read before it is refilled
    have = have2;
    it = it2;
  }
  cp_async_wait<0>();     // no copy in flight into a finished warp's ring
  out_occ[i] = occ;
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t; `rb` is the ray block size (rays per block, a multiple of
// 32, at most 1024) and divides `rp`; the culls launch (rp / rb) x split
// blocks of kCullThreads (cull_shape), the sweeps (rp / rb) x
// ceil(rb / kGroupThreads) blocks of kGroupThreads. Each returns
// cudaGetLastError() after the launch.

extern "C" int dcrt_wl_cull(const float* boxes, int n_boxes, const float* od,
                            const float* tm, int rp, int rb, float* out,
                            void* stream) {
  if (rp > 0 && n_boxes > 0) {
    const int nb = rp / rb;
    int g_max, k_max, split;
    cull_shape(nb, n_boxes, g_max, k_max, split);
    cull_kernel<<<dim3(nb, split), kCullThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        boxes, n_boxes, od, tm, rp, rb, g_max, k_max, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The refine takes the items' hypers (n_items,) and, per ray block, the
// offset of its first item in the block-sorted item list (seg, nb + 1
// int32); n_hyper bounds the items of one ray block.
extern "C" int dcrt_wl_refine(const float* hsup, int hs, int n_hyper,
                              const int* seg, const int* item_hyp,
                              int n_items, const float* od, const float* tm,
                              int rp, int rb, float* out, void* stream) {
  if (n_items > 0 && rp > 0) {
    const int nb = rp / rb;
    int g_max, k_max, split;
    cull_shape(nb, min(n_items, n_hyper) * hs, g_max, k_max, split);
    refine_kernel<<<dim3(nb, split), kCullThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        hsup, hs, seg, item_hyp, od, tm, rp, rb, g_max, k_max, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The culls' resources, for the report: per kernel (cull, refine) 5 ints,
// as dcrt_wl_warp_resources gives them.
extern "C" int dcrt_wl_cull_resources(int* out) {
  const void* fns[2] = {reinterpret_cast<const void*>(cull_kernel),
                        reinterpret_cast<const void*>(refine_kernel)};
  for (int f = 0; f < 2; ++f) {
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, fns[f]);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5 * f, fns[f],
                                                  kCullThreads, 0);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = kCullThreads;
  }
  return static_cast<int>(cudaGetLastError());
}

// The sweeps take the (Cs, 8) admission boxes (Tables.abox) before the
// (Cs, 32, 8) child boxes, both 16-byte aligned.
extern "C" int dcrt_wl_closest(const int* seg, const int* item_sup,
                               const float* item_t, int nb,
                               const float* abox, const float* cbox,
                               const float* tab, int watertight,
                               const float* od, const float* texp, int rp,
                               int rb, float t_min, int* best, float* t,
                               float* u, float* v, int* tri, int* inst,
                               unsigned char* back, int* iters,
                               void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      closest_ray_kernel<RawWatertight, false><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, nullptr, nullptr, nullptr,
          od, texp, rp, rb, t_min, out);
    else
      closest_ray_kernel<BaldwinWeber, false><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, nullptr, nullptr, nullptr,
          od, texp, rp, rb, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any(const int* seg, const int* item_sup, int nb,
                           const float* abox, const float* cbox,
                           const float* tab, int watertight, const float* od,
                           const float* tm, int rp, int rb, float t_min,
                           unsigned char* occ, void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      any_ray_kernel<RawWatertight, false><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, nullptr, nullptr, nullptr, od, tm,
          rp, rb, t_min, occ);
    else
      any_ray_kernel<BaldwinWeber, false><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, nullptr, nullptr, nullptr, od, tm,
          rp, rb, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_closest_grouped(
    const int* seg, const int* item_sup, const float* item_t, int nb,
    const float* abox, const float* cbox, const float* tab, int watertight,
    const float* od, const float* texp, int rp, int rb, float t_min,
    int* best, float* t, float* u, float* v, int* tri, int* inst,
    unsigned char* back, int* iters, void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      closest_grouped_kernel<RawWatertight><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, od, texp, rp, rb, t_min,
          out);
    else
      closest_grouped_kernel<BaldwinWeber><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, od, texp, rp, rb, t_min,
          out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any_grouped(const int* seg, const int* item_sup,
                                   int nb, const float* abox,
                                   const float* cbox, const float* tab,
                                   int watertight, const float* od,
                                   const float* tm, int rp, int rb,
                                   float t_min, unsigned char* occ,
                                   void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      any_grouped_kernel<RawWatertight><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, od, tm, rp, rb, t_min, occ);
    else
      any_grouped_kernel<BaldwinWeber><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, od, tm, rp, rb, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// The warp-walk kernels' resources, for the report: per kernel (grouped
// closest, grouped any-hit, per-ray closest, instanced closest, per-ray
// any-hit, instanced any-hit; each Baldwin-Weber, then watertight) 5 ints:
// resident blocks per SM, registers, static shared bytes, local (spill)
// bytes per thread, threads per block.
extern "C" int dcrt_wl_warp_resources(int* out) {
  constexpr int kFns = 12;
  const void* fns[kFns] = {
      reinterpret_cast<const void*>(closest_grouped_kernel<BaldwinWeber>),
      reinterpret_cast<const void*>(closest_grouped_kernel<RawWatertight>),
      reinterpret_cast<const void*>(any_grouped_kernel<BaldwinWeber>),
      reinterpret_cast<const void*>(any_grouped_kernel<RawWatertight>),
      reinterpret_cast<const void*>(closest_ray_kernel<BaldwinWeber, false>),
      reinterpret_cast<const void*>(closest_ray_kernel<RawWatertight, false>),
      reinterpret_cast<const void*>(closest_ray_kernel<BaldwinWeber, true>),
      reinterpret_cast<const void*>(closest_ray_kernel<RawWatertight, true>),
      reinterpret_cast<const void*>(any_ray_kernel<BaldwinWeber, false>),
      reinterpret_cast<const void*>(any_ray_kernel<RawWatertight, false>),
      reinterpret_cast<const void*>(any_ray_kernel<BaldwinWeber, true>),
      reinterpret_cast<const void*>(any_ray_kernel<RawWatertight, true>)};
  for (int f = 0; f < kFns; ++f) {
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, fns[f]);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5 * f, fns[f],
                                                  kGroupThreads, 0);
    out[5 * f + 1] = a.numRegs;
    out[5 * f + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * f + 3] = static_cast<int>(a.localSizeBytes);
    out[5 * f + 4] = kGroupThreads;
  }
  return static_cast<int>(cudaGetLastError());
}

// The instanced sweeps take dcrt_wl_closest's and dcrt_wl_any's arguments
// with three more after the slab: the (NS,) local super and instance of
// each super and the (I, 16) instance rows (16-byte aligned).
extern "C" int dcrt_wl_closest_inst(
    const int* seg, const int* item_sup, const float* item_t, int nb,
    const float* abox, const float* cbox, const float* tab,
    const int* isup_local, const int* isup_inst, const float* inst_rows,
    int watertight, const float* od, const float* texp, int rp, int rb,
    float t_min, int* best, float* t, float* u, float* v, int* tri,
    int* inst, unsigned char* back, int* iters, void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      closest_ray_kernel<RawWatertight, true><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, isup_local, isup_inst,
          inst_rows, od, texp, rp, rb, t_min, out);
    else
      closest_ray_kernel<BaldwinWeber, true><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, item_t, abox, cbox, tab, isup_local, isup_inst,
          inst_rows, od, texp, rp, rb, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any_inst(const int* seg, const int* item_sup, int nb,
                                const float* abox, const float* cbox,
                                const float* tab, const int* isup_local,
                                const int* isup_inst, const float* inst_rows,
                                int watertight, const float* od,
                                const float* tm, int rp, int rb, float t_min,
                                unsigned char* occ, void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(nb, (rb + kGroupThreads - 1) / kGroupThreads);
    if (watertight)
      any_ray_kernel<RawWatertight, true><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, isup_local, isup_inst, inst_rows,
          od, tm, rp, rb, t_min, occ);
    else
      any_ray_kernel<BaldwinWeber, true><<<grid, kGroupThreads, 0, s>>>(
          seg, item_sup, abox, cbox, tab, isup_local, isup_inst, inst_rows,
          od, tm, rp, rb, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
