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
//                     hyper's member supers;
//   closest_kernel <- _wl_closest_kernel (:678, launched by _closest_impl
//                     :1750): closest hit, a bit-packed argmin;
//   any_kernel     <- _wl_any_kernel (:866, launched by _any_impl :1916):
//                     occlusion within a per-ray t_max;
//   closest_grouped_kernel <- _wlg_closest_kernel (:1000): the closest hit
//                     by a per-warp cluster walk (see its section below);
//   any_grouped_kernel     <- _wlg_any_kernel (:1113): occlusion, the same;
//   closest_inst_kernel    <- _wl_closest_inst_kernel (:1208): closest_kernel
//                     on instanced tables (see its section below);
//   any_inst_kernel        <- _wl_any_inst_kernel (:1349): any_kernel, the
//                     same.
// Rays are the (9, Rp) rows [o; d; 1/d] of prep_rays, Rp a multiple of
// the block size RB (one thread per ray, one block per RB rays).
//
// What bounds them. The culls: FP32 ALU, ~20 operations per (ray, box),
// and one block-wide min per box (warp shuffles, then 32 partials in
// shared memory, so one barrier per 32 boxes). The sweeps: FP32 ALU in
// the per-ray fine cull (32 slab tests per item) and the triangle tests,
// and the latency of reading 64-byte triangle rows from L2; rays of one
// warp that pick different clusters diverge. At 1024 threads a block may
// hold 64 registers a thread.
//
// Design. The TPU grid walked (block, super) items in order and carried
// the best hit across them in the output block and a termination bound in
// an SMEM scalar. Here one CUDA block owns one ray block and loops over
// its own item segment, front to back; each thread keeps its ray's packed
// best hit in registers. A block-wide vote (__syncthreads_or) skips an
// item once no ray's best lies beyond its entry distance. The item's 32
// child boxes (1 KB) are staged in shared memory; each thread tests them
// against its own ray and its current best (the fine cull) and sweeps the
// entered clusters nearest first, stopping at the first that starts
// beyond its window. The packed key is (bits(t) & ~kLowM) | (child << 4)
// | row, as in the reference, and a cluster's smallest key replaces the
// best only if strictly smaller; a candidate needs t inside the best's
// whole truncation quantum (window(), where the reference takes t < the
// best read as a float), so the result does not depend on the visiting
// order. Built with -fmad=false: kernels and twins agree bit for bit.
// The per-ray walk (fine cull, nearest-first cluster walk, occlusion
// walk) lives in worklist.cuh, shared with the pair sweep (pairsweep.cu).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "worklist.cuh"

namespace {

using dcrt::BaldwinWeber;
using dcrt::Best;
using dcrt::child_enter;
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
using dcrt::stage_boxes;
using dcrt::start_best;
using dcrt::window;

constexpr int kBoxChunk = 32;              // boxes per block-wide min pass

// out[j] = min over the block's rays of the clamped entry distance into
// boxes[j] (8 floats each), j < n <= kBoxChunk; kBig where no ray enters
// within its t_max. A min is order-free, so this equals the twin exactly.
__device__ void block_entry_min(const RayInv& q, float tm, const float* boxes,
                                int n, float* out) {
  __shared__ float part[32][kBoxChunk + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    const float* b = boxes + 8 * j;
    float t_lo, t_hi;
    slab(q, b[0], b[1], b[2], b[3], b[4], b[5], t_lo, t_hi);
    float v = (t_hi >= t_lo && t_hi >= 0.f && t_lo <= tm) ? fmaxf(t_lo, 0.f)
                                                           : kBig;
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    float m = part[0][threadIdx.x];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      m = fminf(m, part[w][threadIdx.x]);
    out[threadIdx.x] = m;
  }
}

__global__ void __launch_bounds__(1024)
cull_kernel(const float* __restrict__ boxes, int n_boxes,
            const float* __restrict__ od, const float* __restrict__ tm,
            int rp, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j0 = blockIdx.y * kBoxChunk;
  block_entry_min(load_od(od, rp, i), tm[i], boxes + 8 * j0,
                  min(kBoxChunk, n_boxes - j0),
                  out + static_cast<size_t>(blockIdx.x) * n_boxes + j0);
}

__global__ void __launch_bounds__(1024)
refine_kernel(const float* __restrict__ hsup, int hs,
              const int* __restrict__ item_blk,
              const int* __restrict__ item_hyp,
              const float* __restrict__ od, const float* __restrict__ tm,
              int rp, float* __restrict__ out) {
  const int item = blockIdx.x;
  const int i = item_blk[item] * blockDim.x + threadIdx.x;
  block_entry_min(load_od(od, rp, i), tm[i],
                  hsup + static_cast<size_t>(item_hyp[item]) * hs * 8, hs,
                  out + static_cast<size_t>(item) * hs);
}

template <class Tri>
__global__ void __launch_bounds__(1024)
closest_kernel(const int* __restrict__ seg, const int* __restrict__ item_sup,
               const float* __restrict__ item_t,
               const float* __restrict__ cbox, const float* __restrict__ tab,
               const float* __restrict__ od, const float* __restrict__ texp,
               int rp, float t_min, dcrt::ClosestOut out) {
  __shared__ float4 boxes[2 * kSuper];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  Best s = start_best(texp[i]);
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    // skip an item that starts beyond every ray's best (the vote is also
    // the barrier before the boxes are restaged)
    if (!__syncthreads_or(window(s.best) > item_t[k])) continue;
    const int sup = item_sup[k];
    stage_boxes(cbox, sup, boxes);
    __syncthreads();
    float tl[kSuper];
    const unsigned mask = dcrt::fine_cull(q, boxes, window(s.best), t_min,
                                          tl);
    dcrt::walk_closest<Tri, true>(q.r, pre, tab, sup * kSuperRows, t_min, tl,
                                  mask, s);
  }
  dcrt::store_soup<Tri>(out, i, tab, s, s.row);
}

template <class Tri>
__global__ void __launch_bounds__(1024)
any_kernel(const int* __restrict__ seg, const int* __restrict__ item_sup,
           const float* __restrict__ cbox, const float* __restrict__ tab,
           const float* __restrict__ od, const float* __restrict__ tm,
           int rp, float t_min, unsigned char* __restrict__ out_occ) {
  __shared__ float4 boxes[2 * kSuper];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  const float t_max = tm[i];
  bool occ = false;
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    // stop once every ray of the block is occluded (also the barrier
    // before the boxes are restaged)
    if (__syncthreads_and(occ)) break;
    const int sup = item_sup[k];
    stage_boxes(cbox, sup, boxes);
    __syncthreads();
    if (!occ)
      occ = dcrt::walk_any<Tri, true>(q, q.r, pre, boxes, tab,
                                      sup * kSuperRows, t_max, t_min);
  }
  out_occ[i] = occ;
}

// ---------------------------------------------------------------------------
// Grouped sweeps <- _wlg_closest_kernel (:1000) and _wlg_any_kernel (:1113)
// (launched by _closest_impl :1750 and _any_impl :1916 with grouped=True).
//
// The TPU kernels gave each 128-lane group its own front-to-back cluster
// list; here the group is one warp (GL = 32). Per item, each lane runs its
// fine cull of the 32 child boxes against its own best (closest) or t_max
// (any-hit; an occluded lane enters nothing). A warp-wide min per child
// gives the warp's pick key for that child, held by lane `child`:
// (bits(t_g) & ~kKeyM) | child, INT_MAX where no lane entered it. Each
// step pops the two nearest keys with two __reduce_min_sync; every lane
// then sweeps the same cluster pair (uniform triangle loads), masked by
// its own fine cull. The closest walk stops once the nearest key, its low
// kKeyM bits cleared, starts beyond every lane's window (the group bound);
// the any-hit walk once every lane is occluded. Both clusters of a step
// are tested against the lane's window before the step, and the smallest
// candidate key replaces the best only if strictly smaller: the same hit
// as closest_kernel's, bit for bit. No per-thread cluster order or entry
// distances are kept, which is what spills in closest_kernel. `iters`
// adds the step's clusters (1 or 2) for every lane that entered something
// in the item.
// ---------------------------------------------------------------------------

constexpr int kKeyM = 63;   // pick-key low bits: the child id
constexpr unsigned kFull = 0xffffffffu;

// The warp's pick keys for the staged item; returns the lane's mask of
// entered children. `cap` is the lane's fine-cull ceiling.
__device__ __forceinline__ unsigned group_keys(const RayInv& q,
                                               const float4* boxes,
                                               float cap, float t_min,
                                               int& key) {
  const int lane = threadIdx.x & 31;
  const int big = __float_as_int(kBig);
  unsigned mask = 0u;
  key = INT_MAX;
  for (int c = 0; c < kSuper; ++c) {
    float t_lo;
    const bool e = child_enter(q, boxes, c, cap, t_min, t_lo);
    if (e) mask |= 1u << c;
    // entry distances are >= 0 (the sign bit is masked for -0.0), so
    // their bits order like their values
    const int m = __reduce_min_sync(
        kFull, e ? __float_as_int(fmaxf(t_lo, 0.f)) & INT_MAX : big);
    if (lane == c && m < big) key = (m & ~kKeyM) | c;
  }
  return mask;
}

// Pop the warp's nearest key; INT_MAX when none is left.
__device__ __forceinline__ int pop_key(int& key) {
  const int k = __reduce_min_sync(kFull, key);
  if (k != INT_MAX && (threadIdx.x & 31) == (k & kKeyM)) key = INT_MAX;
  return k;
}

template <class Tri>
__global__ void __launch_bounds__(1024)
closest_grouped_kernel(const int* __restrict__ seg,
                       const int* __restrict__ item_sup,
                       const float* __restrict__ item_t,
                       const float* __restrict__ cbox,
                       const float* __restrict__ tab,
                       const float* __restrict__ od,
                       const float* __restrict__ texp, int rp, float t_min,
                       dcrt::ClosestOut out) {
  __shared__ float4 boxes[2 * kSuper];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  Best s = start_best(texp[i]);
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    // the block vote of closest_kernel (also the barrier before restaging)
    if (!__syncthreads_or(window(s.best) > item_t[k])) continue;
    const int sup = item_sup[k];
    stage_boxes(cbox, sup, boxes);
    __syncthreads();
    int key;
    const unsigned mask = group_keys(q, boxes, window(s.best), t_min, key);
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
  dcrt::store_soup<Tri>(out, i, tab, s, s.row);
}

template <class Tri>
__global__ void __launch_bounds__(1024)
any_grouped_kernel(const int* __restrict__ seg,
                   const int* __restrict__ item_sup,
                   const float* __restrict__ cbox,
                   const float* __restrict__ tab,
                   const float* __restrict__ od, const float* __restrict__ tm,
                   int rp, float t_min, unsigned char* __restrict__ out_occ) {
  __shared__ float4 boxes[2 * kSuper];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  const float t_max = tm[i];
  bool occ = false;
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    if (__syncthreads_and(occ)) break;
    const int sup = item_sup[k];
    stage_boxes(cbox, sup, boxes);
    __syncthreads();
    int key;
    const unsigned mask = group_keys(q, boxes, occ ? -kBig : t_max, t_min,
                                     key);
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
  out_occ[i] = occ;
}

// ---------------------------------------------------------------------------
// Instanced sweeps <- _wl_closest_inst_kernel (:1208) and _wl_any_inst_kernel
// (:1349) (launched by _closest_impl :1722 and _any_impl :1889 on scenes
// with instanced tables).
//
// The tables share each mesh's triangles: the slab rows are mesh-local,
// stored once, and a super is an (instance, local super) pair with world
// child boxes (isup_cbox). Items, the block vote and the per-ray fine cull
// are closest_kernel's and any_kernel's, in world space with the world ray,
// so entry distances compare across items. The item's super gives its
// local super (isup_local) and its instance (isup_inst); the instance's
// world->local transform (12 floats of its inst_rows row) is staged beside
// the child boxes, and the ray is moved to local space once per item that
// its fine cull entered (to_local, the reference's _local_rays: the
// direction is not normalised, so t stays the world ray's parameter and
// the packed keys compare across instances; Tri::prepare runs on the local
// ray, since the watertight permutation follows the direction). The rows
// swept are (loc * kSuper + c) * kCluster + r. The closest kernel keeps the
// winning item's instance: the hit's instance is it, tri is the slab row's
// global id, and the back-face flag is the local test's as it is (a
// mirroring instance turns the world normal, and the soup's flip column
// turns it back; the reference's kernel XORs the flip in again, :1323).
//
// What bounds them: as closest_kernel and any_kernel, FP32 ALU in the fine
// cull (32 ray-box tests of ~20 operations per item) and in the triangle
// tests (31 operations Baldwin-Weber, ~45 watertight, 16 per swept
// cluster), plus 27 operations per entered item for the local ray, and
// the latency of reading triangle rows from L2. Instanced supers are many
// and overlap, so a block walks more items than on the soup (the TPU's
// census: 44.3 clusters swept per ray against 8.0). The design keeps
// closest_kernel's answer to that, per-ray skipping of clusters and items
// beyond the ray's own best; a faster walk is later work. Built with
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

// Stage the item's child boxes and its instance's transform.
__device__ __forceinline__ void stage_inst_item(const float* cbox,
                                                const float* inst_rows,
                                                int sup, int ins,
                                                float4* boxes, float* row) {
  stage_boxes(cbox, sup, boxes);
  if (threadIdx.x < kInstXf)
    row[threadIdx.x] = __ldg(inst_rows + static_cast<size_t>(ins) *
                                             kInstCols + threadIdx.x);
}

template <class Tri>
__global__ void __launch_bounds__(1024)
closest_inst_kernel(const int* __restrict__ seg,
                    const int* __restrict__ item_sup,
                    const float* __restrict__ item_t,
                    const float* __restrict__ cbox,
                    const float* __restrict__ tab,
                    const int* __restrict__ isup_local,
                    const int* __restrict__ isup_inst,
                    const float* __restrict__ inst_rows,
                    const float* __restrict__ od,
                    const float* __restrict__ texp, int rp, float t_min,
                    dcrt::ClosestOut out) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ float row[kInstXf];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  Best s = start_best(texp[i]);
  int binst = 0;
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    // the block vote of closest_kernel (also the barrier before restaging)
    if (!__syncthreads_or(window(s.best) > item_t[k])) continue;
    const int sup = item_sup[k];
    const int loc = isup_local[sup], ins = isup_inst[sup];
    stage_inst_item(cbox, inst_rows, sup, ins, boxes, row);
    __syncthreads();
    float tl[kSuper];
    const unsigned mask = dcrt::fine_cull(q, boxes, window(s.best), t_min,
                                          tl);
    if (!mask) continue;
    const Ray rl = to_local(q.r, row);
    const typename Tri::Pre pre = Tri::prepare(rl);
    if (dcrt::walk_closest<Tri, true>(rl, pre, tab, loc * kSuperRows, t_min,
                                      tl, mask, s))
      binst = ins;
  }
  const float tri =
      s.row >= 0 ? tab[static_cast<size_t>(s.row) * Tri::kCols + Tri::kMeta]
                 : 0.f;
  out.store(i, s, static_cast<int>(tri), s.row >= 0 ? binst : 0,
            s.row >= 0 && s.back);
}

template <class Tri>
__global__ void __launch_bounds__(1024)
any_inst_kernel(const int* __restrict__ seg, const int* __restrict__ item_sup,
                const float* __restrict__ cbox, const float* __restrict__ tab,
                const int* __restrict__ isup_local,
                const int* __restrict__ isup_inst,
                const float* __restrict__ inst_rows,
                const float* __restrict__ od, const float* __restrict__ tm,
                int rp, float t_min, unsigned char* __restrict__ out_occ) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ float row[kInstXf];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const RayInv q = load_od(od, rp, i);
  const float t_max = tm[i];
  bool occ = false;
  const int k1 = seg[b + 1];
  for (int k = seg[b]; k < k1; ++k) {
    // any_kernel's stop (also the barrier before restaging)
    if (__syncthreads_and(occ)) break;
    const int sup = item_sup[k];
    const int loc = isup_local[sup];
    stage_inst_item(cbox, inst_rows, sup, isup_inst[sup], boxes, row);
    __syncthreads();
    if (occ) continue;
    const Ray rl = to_local(q.r, row);
    occ = dcrt::walk_any<Tri, true>(q, rl, Tri::prepare(rl), boxes, tab,
                                    loc * kSuperRows, t_max, t_min);
  }
  out_occ[i] = occ;
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t; `rb` is the block size (rays per block, a multiple of 32,
// at most 1024) and divides `rp`. Each returns cudaGetLastError() after
// the launch.

extern "C" int dcrt_wl_cull(const float* boxes, int n_boxes, const float* od,
                            const float* tm, int rp, int rb, float* out,
                            void* stream) {
  if (rp > 0 && n_boxes > 0) {
    const dim3 grid(rp / rb, (n_boxes + kBoxChunk - 1) / kBoxChunk);
    cull_kernel<<<grid, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        boxes, n_boxes, od, tm, rp, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_refine(const float* hsup, int hs, const int* item_blk,
                              const int* item_hyp, int n_items,
                              const float* od, const float* tm, int rp,
                              int rb, float* out, void* stream) {
  if (n_items > 0) {
    refine_kernel<<<n_items, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        hsup, hs, item_blk, item_hyp, od, tm, rp, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_closest(const int* seg, const int* item_sup,
                               const float* item_t, int nb, const float* cbox,
                               const float* tab, int watertight,
                               const float* od, const float* texp, int rp,
                               int rb, float t_min, int* best, float* t,
                               float* u, float* v, int* tri, int* inst,
                               unsigned char* back, int* iters,
                               void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    if (watertight)
      closest_kernel<RawWatertight><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, od, texp, rp, t_min, out);
    else
      closest_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, od, texp, rp, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any(const int* seg, const int* item_sup, int nb,
                           const float* cbox, const float* tab,
                           int watertight, const float* od, const float* tm,
                           int rp, int rb, float t_min, unsigned char* occ,
                           void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_kernel<RawWatertight><<<nb, rb, 0, s>>>(seg, item_sup, cbox, tab,
                                                  od, tm, rp, t_min, occ);
    else
      any_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(seg, item_sup, cbox, tab, od,
                                                 tm, rp, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_closest_grouped(
    const int* seg, const int* item_sup, const float* item_t, int nb,
    const float* cbox, const float* tab, int watertight, const float* od,
    const float* texp, int rp, int rb, float t_min, int* best, float* t,
    float* u, float* v, int* tri, int* inst, unsigned char* back, int* iters,
    void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    if (watertight)
      closest_grouped_kernel<RawWatertight><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, od, texp, rp, t_min, out);
    else
      closest_grouped_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, od, texp, rp, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any_grouped(const int* seg, const int* item_sup,
                                   int nb, const float* cbox,
                                   const float* tab, int watertight,
                                   const float* od, const float* tm, int rp,
                                   int rb, float t_min, unsigned char* occ,
                                   void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_grouped_kernel<RawWatertight><<<nb, rb, 0, s>>>(
          seg, item_sup, cbox, tab, od, tm, rp, t_min, occ);
    else
      any_grouped_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(
          seg, item_sup, cbox, tab, od, tm, rp, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instanced sweeps take dcrt_wl_closest's and dcrt_wl_any's arguments
// with three more after the slab: the (NS,) local super and instance of
// each super and the (I, 16) instance rows.
extern "C" int dcrt_wl_closest_inst(
    const int* seg, const int* item_sup, const float* item_t, int nb,
    const float* cbox, const float* tab, const int* isup_local,
    const int* isup_inst, const float* inst_rows, int watertight,
    const float* od, const float* texp, int rp, int rb, float t_min,
    int* best, float* t, float* u, float* v, int* tri, int* inst,
    unsigned char* back, int* iters, void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    if (watertight)
      closest_inst_kernel<RawWatertight><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, isup_local, isup_inst, inst_rows,
          od, texp, rp, t_min, out);
    else
      closest_inst_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(
          seg, item_sup, item_t, cbox, tab, isup_local, isup_inst, inst_rows,
          od, texp, rp, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_wl_any_inst(const int* seg, const int* item_sup, int nb,
                                const float* cbox, const float* tab,
                                const int* isup_local, const int* isup_inst,
                                const float* inst_rows, int watertight,
                                const float* od, const float* tm, int rp,
                                int rb, float t_min, unsigned char* occ,
                                void* stream) {
  if (nb > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      any_inst_kernel<RawWatertight><<<nb, rb, 0, s>>>(
          seg, item_sup, cbox, tab, isup_local, isup_inst, inst_rows, od, tm,
          rp, t_min, occ);
    else
      any_inst_kernel<BaldwinWeber><<<nb, rb, 0, s>>>(
          seg, item_sup, cbox, tab, isup_local, isup_inst, inst_rows, od, tm,
          rp, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
