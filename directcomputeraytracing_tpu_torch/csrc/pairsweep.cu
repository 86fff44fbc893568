// Pair-expanded sweep of clustered scenes, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of directcomputeraytracing_tpu/accel/
// pairsweep.py and keeps their per-pair contracts (accel/pairsweep.py in
// the port holds the glue and the PyTorch twins):
//   emit_kernel         <- _emit_kernel (:78, launched by _emit_pairs
//                          :112): per (item, lane), one slab test of the
//                          item's super box under the ray's window cap and
//                          floor -> one enter byte;
//   pair_closest_kernel <- _pair_closest_kernel (:274, launched by
//                          _run_pair_sweep :399): per (ray, super) pair,
//                          the fine cull of the super's 32 child boxes and
//                          the nearest-first cluster walk, a packed argmin
//                          with no state across supers -> packed best, t,
//                          u, v, tri, inst, back, clusters swept;
//   pair_any_kernel     <- _pair_any_kernel (:359, same launcher): the
//                          same walk for occlusion under the ray's t_max
//                          -> one byte.
// Rays are the (9, Rp) rows [o; d; 1/d] of prep_rays; a pair names its
// ray by index, so no per-pair ray table is gathered (the TPU kernels read
// a (p_cap, 16) one).
//
// Design. On the TPU the pair expansion bought lane occupancy: a 1024-lane
// vector op is full only when every lane holds a ray that entered the
// super being swept. On Hopper a thread walks its own ray, so occupancy
// comes from per-thread walks; what grouping the pairs by super buys here
// is reuse. The glue sorts the pairs by super and cuts each super's run
// into chunks of at most blockDim pairs; one CUDA block sweeps one chunk,
// one pair per thread. The block stages the super's 32 child boxes (1 KiB)
// and, when the chunk holds at least kStageMin pairs, its 512 slab rows
// (32 KiB Baldwin-Weber, 26 KiB raw vertices) in shared memory, so that
// one load of the super's tables serves the whole chunk; smaller chunks
// read the rows through the read-only cache. Each thread then runs the
// work list's per-ray walk (worklist.cuh, shared with worklist.cu) from
// its own best, bits(texp) | kLowM: the fine cull and the walk use the
// candidate window of that best, so that the least packed key over a
// ray's pairs is the work list's hit bit for bit (accel/pairsweep.py).
//
// What bounds them. The emission: 20 operations and 41 bytes per cell
// (the block's rays are read again for each of its items; they come from
// L2). The sweeps: FP32 ALU in the fine cull (32 slab tests of ~20
// operations a pair) and the triangle tests (16 a swept cluster, 31
// operations Baldwin-Weber, ~45 watertight), and the latency of the
// rows; the pairs of a warp come from rays of like origin (the pair list
// keeps grid order within a super), so their walks diverge little on
// coherent sets. Built with -fmad=false: kernels and twins agree bit for
// bit.

#include <cuda_runtime.h>

#include "worklist.cuh"

namespace {

using dcrt::Best;
using dcrt::kSuper;
using dcrt::kSuperRows;
using dcrt::RayInv;

constexpr int kPairThreads = 256;   // the largest chunk: pairs per block
constexpr int kStageMin = 32;       // pairs from which a chunk stages rows

__global__ void __launch_bounds__(1024)
emit_kernel(const int* __restrict__ item_blk, const int* __restrict__ item_sup,
            const float* __restrict__ sbox, const float* __restrict__ od,
            const float* __restrict__ cap, int rp, float t_min,
            unsigned char* __restrict__ out) {
  const int item = blockIdx.x;
  const int i = item_blk[item] * blockDim.x + threadIdx.x;
  const float* b = sbox + static_cast<size_t>(item_sup[item]) * 8;
  const RayInv q = dcrt::load_od(od, rp, i);
  float t_lo, t_hi;
  dcrt::slab(q, __ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
             __ldg(b + 4), __ldg(b + 5), t_lo, t_hi);
  out[static_cast<size_t>(item) * blockDim.x + threadIdx.x] =
      dcrt::enters(t_lo, t_hi, cap[i], t_min);
}

// The chunk's super tables: its child boxes always, its slab rows when
// the chunk has at least kStageMin pairs (returns whether it staged them).
template <class Tri>
__device__ __forceinline__ bool stage_super(const float* cbox,
                                            const float* stab, int sup,
                                            int n, float4* boxes,
                                            float4* rows) {
  constexpr int kRow4 = kSuperRows * Tri::kCols / 4;
  dcrt::stage_boxes(cbox, sup, boxes);
  const bool staged = n >= kStageMin;
  if (staged)
    for (int k = threadIdx.x; k < kRow4; k += blockDim.x)
      rows[k] = __ldg(reinterpret_cast<const float4*>(stab) + k);
  __syncthreads();
  return staged;
}

template <class Tri>
__global__ void __launch_bounds__(kPairThreads)
pair_closest_kernel(const int* __restrict__ chunk_sup,
                    const int* __restrict__ chunk_first,
                    const int* __restrict__ chunk_count,
                    const int* __restrict__ pair_ray,
                    const float* __restrict__ cbox,
                    const float* __restrict__ tab,
                    const float* __restrict__ od,
                    const float* __restrict__ texp, int rp, float t_min,
                    dcrt::ClosestOut out) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ float4 rows[kSuperRows * Tri::kCols / 4];
  const int n = chunk_count[blockIdx.x];
  if (n == 0) return;   // a spare entry of the launch list (whole block)
  const int sup = chunk_sup[blockIdx.x];
  const float* stab = tab + static_cast<size_t>(sup) * kSuperRows * Tri::kCols;
  const bool staged = stage_super<Tri>(cbox, stab, sup, n, boxes, rows);
  if (static_cast<int>(threadIdx.x) >= n) return;
  const size_t p = static_cast<size_t>(chunk_first[blockIdx.x]) + threadIdx.x;
  const int ray = pair_ray[p];
  const RayInv q = dcrt::load_od(od, rp, ray);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  Best s = dcrt::start_best(texp[ray]);
  float tl[kSuper];
  const unsigned mask = dcrt::fine_cull(q, boxes, dcrt::window(s.best),
                                        t_min, tl);
  if (staged)
    dcrt::walk_closest<Tri, false>(q.r, pre,
                                   reinterpret_cast<const float*>(rows), 0,
                                   t_min, tl, mask, s);
  else
    dcrt::walk_closest<Tri, true>(q.r, pre, stab, 0, t_min, tl, mask, s);
  dcrt::store_soup<Tri>(out, p, stab, s, s.row);
}

template <class Tri>
__global__ void __launch_bounds__(kPairThreads)
pair_any_kernel(const int* __restrict__ chunk_sup,
                const int* __restrict__ chunk_first,
                const int* __restrict__ chunk_count,
                const int* __restrict__ pair_ray,
                const float* __restrict__ cbox, const float* __restrict__ tab,
                const float* __restrict__ od, const float* __restrict__ tm,
                int rp, float t_min, unsigned char* __restrict__ out_occ) {
  __shared__ float4 boxes[2 * kSuper];
  __shared__ float4 rows[kSuperRows * Tri::kCols / 4];
  const int n = chunk_count[blockIdx.x];
  if (n == 0) return;
  const int sup = chunk_sup[blockIdx.x];
  const float* stab = tab + static_cast<size_t>(sup) * kSuperRows * Tri::kCols;
  const bool staged = stage_super<Tri>(cbox, stab, sup, n, boxes, rows);
  if (static_cast<int>(threadIdx.x) >= n) return;
  const size_t p = static_cast<size_t>(chunk_first[blockIdx.x]) + threadIdx.x;
  const int ray = pair_ray[p];
  const RayInv q = dcrt::load_od(od, rp, ray);
  const typename Tri::Pre pre = Tri::prepare(q.r);
  const float t_max = tm[ray];
  out_occ[p] =
      staged ? dcrt::walk_any<Tri, false>(q, q.r, pre, boxes,
                                          reinterpret_cast<const float*>(rows),
                                          0, t_max, t_min)
             : dcrt::walk_any<Tri, true>(q, q.r, pre, boxes, stab, 0, t_max,
                                         t_min);
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after the launch.

// The largest chunk the sweeps take (their block size).
extern "C" int dcrt_pair_chunk() { return kPairThreads; }

// `rb` rays per block (at most 1024) divides `rp`; out is (n_items, rb).
extern "C" int dcrt_pair_emit(const int* item_blk, const int* item_sup,
                              int n_items, const float* sbox, const float* od,
                              const float* cap, int rp, int rb, float t_min,
                              unsigned char* out, void* stream) {
  if (n_items > 0)
    emit_kernel<<<n_items, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        item_blk, item_sup, sbox, od, cap, rp, t_min, out);
  return static_cast<int>(cudaGetLastError());
}

// The launch list: chunk j sweeps pairs [first[j], first[j] + count[j])
// of super sup[j] (count 0: nothing); count <= kPairThreads.
extern "C" int dcrt_pair_closest(const int* chunk_sup, const int* chunk_first,
                                 const int* chunk_count, int n_chunks,
                                 const int* pair_ray, const float* cbox,
                                 const float* tab, int watertight,
                                 const float* od, const float* texp, int rp,
                                 float t_min, int* best, float* t, float* u,
                                 float* v, int* tri, int* inst,
                                 unsigned char* back, int* iters,
                                 void* stream) {
  if (n_chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dcrt::ClosestOut out{best, t, u, v, tri, inst, back, iters};
    if (watertight)
      pair_closest_kernel<dcrt::RawWatertight><<<n_chunks, kPairThreads, 0,
                                                 s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, texp,
          rp, t_min, out);
    else
      pair_closest_kernel<dcrt::BaldwinWeber><<<n_chunks, kPairThreads, 0,
                                                s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, texp,
          rp, t_min, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcrt_pair_any(const int* chunk_sup, const int* chunk_first,
                             const int* chunk_count, int n_chunks,
                             const int* pair_ray, const float* cbox,
                             const float* tab, int watertight,
                             const float* od, const float* tm, int rp,
                             float t_min, unsigned char* occ, void* stream) {
  if (n_chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (watertight)
      pair_any_kernel<dcrt::RawWatertight><<<n_chunks, kPairThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, tm,
          rp, t_min, occ);
    else
      pair_any_kernel<dcrt::BaldwinWeber><<<n_chunks, kPairThreads, 0, s>>>(
          chunk_sup, chunk_first, chunk_count, pair_ray, cbox, tab, od, tm,
          rp, t_min, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
