// The two probe kernels of the reference's experiments, for Hopper (sm_90a).
// The port's tools/probe_worklist.py and tools/prof_prep.py hold the
// wrappers and the PyTorch twins.
//
// item_list_kernel <- kernel of directcomputeraytracing_tpu's
//   experiments/probe_worklist.py (:23, launched by run :57): a
//   data-driven item list. Item i32 = (block << 18) | (slab << 2) |
//   (first << 1) | valid, items sorted by block. For each valid item, per
//   lane x of the block's RB rays and per row r of the item's (64, 12)
//   slab: s(r, x) = sum over c of slab[r][c] * o[x] (o: the origin-x row;
//   c = 0 a product, then adds in c order), red(x) = min over r; a running
//   min into the block's output, reset to 3e38 at a valid item whose
//   first bit is set. Invalid items are skipped. Where the TPU never
//   writes a block that has no valid item (its output stays unset), this
//   kernel writes 3e38.
//   The min is the reference's (jnp.minimum / jnp.min under XLA): a NaN
//   on either side gives NaN, and -0 is below +0. That is a total order,
//   so the min of a set comes out the same in any order and any split,
//   which the design below relies on. `min.NaN.f32` gives it: it returns
//   NaN when either side is NaN and otherwise the smaller value, and on
//   the H100 it puts -0 below +0 in either order (the `cuda` test's
//   `pairs_*` and `crafted` cases hold it bit for bit to the twin).
//   What bounds it: FP32 issue. Each (row, lane) of an item takes 12
//   FMUL, 11 FADD and one FMNMX (built with -fmad=false, so no product
//   fuses into a sum): 24 instructions at 132 SMs x 128 lanes a clock.
//   Design:
//   - a ray block's 1024 lanes go to kSplit = 4 CUDA blocks of 256 lanes
//     (64 ray blocks fill 256 CUDA blocks, two an SM; lanes are
//     independent, so the split is exact);
//   - a thread takes kThreadLanes = 8 adjacent lanes, and each of the
//     block's kGroups = 8 row groups (one warp each) 8 of the 64 rows; a
//     row is read as three float4 broadcasts from shared memory that
//     serve all eight lanes (0.375 loads a (row, lane)), and the eight
//     lanes' sums are independent chains (4 lanes a thread and 4 groups
//     of two warps took 3 % longer, 8 groups of 128 lanes 6 %: PERF.md);
//   - each thread keeps the running min of its lanes over its rows; the
//     row groups' minima are combined once, at the end;
//   - the block first finds its segment's last valid first-flagged item
//     (the running min's last restart: everything before it is
//     discarded), then walks the items from there in chunks of 256,
//     compacts each chunk's valid slabs into a list (one ballot a warp),
//     and streams those slabs through a ring of kStages stages of kPer
//     slabs by cp.async: stage j + 2 is copied while stage j is swept,
//     one barrier a stage.
//
// transpose16_kernel <- _tr_kernel of experiments/prof_prep.py (:56,
//   launched by pallas_t :65): an (R, 16) -> (16, R) f32 transpose. What
//   bounds it: bytes, 64 read and 64 written a row. Design: a 32 x 33
//   shared-memory tile (the padding column keeps the transposed reads free
//   of bank conflicts): a block reads 32 rows of 16 columns coalesced and
//   writes 16 output rows of 32 contiguous floats.
//
// Built with -fmad=false, so the products and sums round as the twins'.

#include <cuda_runtime.h>

namespace {

constexpr int kRB = 1024;          // lanes of a ray block
constexpr int kRows = 64;          // rows of a slab
constexpr int kCols = 12;          // columns of a slab
constexpr int kSlab = kRows * kCols;
constexpr int kSlab4 = kSlab / 4;  // float4 chunks of a slab
constexpr float kInit = 3e38f;

constexpr int kThreads = 256;      // threads of a CUDA block
constexpr int kThreadLanes = 8;    // lanes a thread (a multiple of 4)
constexpr int kGroups = 8;         // row groups of a block
constexpr int kGroupRows = kRows / kGroups;
constexpr int kGroupThreads = kThreads / kGroups;    // threads a row group
constexpr int kLanes = kGroupThreads * kThreadLanes;  // lanes a CUDA block
constexpr int kSplit = kRB / kLanes;                 // CUDA blocks a ray block
constexpr int kPer = 4;            // slabs a stage
constexpr int kStages = 3;         // stages of the ring
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;      // resident blocks an SM, at least

static_assert(kLanes * kSplit == kRB && kGroupRows * kGroups == kRows);
static_assert(kGroupThreads % 32 == 0 && kLanes <= kThreads);

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

// The reference's min: NaN if either side is NaN, -0 below +0.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct ItemSmem {
  float4 ring[kStages][kPer * kSlab4];   // the staged slabs
  float part[kGroups][kLanes];           // the row groups' minima
  int ids[kThreads];                     // a chunk's valid slabs
  int warp_valid[kWarps];
  int start;
};

// Copy stage j's slabs (ids[j * kPer ...], at most n in all) into its
// ring slot: 16 bytes a cp.async, spread over the block's threads.
__device__ __forceinline__ void stage_slabs(ItemSmem& sm,
                                            const float4* __restrict__ tab4,
                                            int j, int n) {
  const int first = j * kPer;
  const int count = min(kPer, n - first) * kSlab4;
  float4* slot = sm.ring[j % kStages];
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int slab = sm.ids[first + e / kSlab4];
    cp_async16(slot + e, tab4 + static_cast<size_t>(slab) * kSlab4 +
                             e % kSlab4);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
item_list_kernel(const int* __restrict__ items, const int* __restrict__ seg,
                 const float* __restrict__ tab, const float* __restrict__ o,
                 float* __restrict__ out) {
  __shared__ __align__(16) ItemSmem sm;
  const int b = blockIdx.x / kSplit;
  const size_t lane0 = static_cast<size_t>(b) * kRB
      + blockIdx.x % kSplit * kLanes;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int g = t / kGroupThreads;                     // row group
  const int q = t % kGroupThreads;     // lanes from kThreadLanes * q on
  const int end = seg[b + 1];
  const float4* tab4 = reinterpret_cast<const float4*>(tab);

  // the running min's last restart: the last valid first-flagged item
  if (t == 0) sm.start = seg[b];
  __syncthreads();
  int last = -1;
  for (int k = seg[b] + t; k < end; k += kThreads)
    if ((items[k] & 3) == 3) last = k;
  if (last >= 0) atomicMax(&sm.start, last);
  __syncthreads();
  const int start = sm.start;

  float x[kThreadLanes], cur[kThreadLanes];
  const float4* x4 = reinterpret_cast<const float4*>(o + lane0) +
                     kThreadLanes / 4 * q;
#pragma unroll
  for (int m = 0; m < kThreadLanes; m += 4) {
    const float4 v = x4[m / 4];
    x[m] = v.x, x[m + 1] = v.y, x[m + 2] = v.z, x[m + 3] = v.w;
    cur[m] = cur[m + 1] = cur[m + 2] = cur[m + 3] = kInit;
  }

  for (int base = start; base < end; base += kThreads) {
    // compact the chunk's valid slabs, in item order
    const int k = base + t;
    const int item = k < end ? items[k] : 0;
    const unsigned valid = __ballot_sync(0xffffffffu, item & 1);
    if (l == 0) sm.warp_valid[w] = __popc(valid);
    __syncthreads();               // the last chunk's slabs are consumed
    int off = 0, n = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      off += i < w ? sm.warp_valid[i] : 0;
      n += sm.warp_valid[i];
    }
    if (item & 1)
      sm.ids[off + __popc(valid & ((1u << l) - 1u))] = (item >> 2) & 0xFFFF;
    __syncthreads();
    const int n_stages = (n + kPer - 1) / kPer;
    if (n_stages > 0) stage_slabs(sm, tab4, 0, n);
    cp_async_commit();
    if (n_stages > 1) stage_slabs(sm, tab4, 1, n);
    cp_async_commit();
    for (int j = 0; j < n_stages; ++j) {
      cp_async_wait<1>();          // this thread's copies of stage j
      __syncthreads();             // everyone's; stage j - 1 is swept
      if (j + 2 < n_stages) stage_slabs(sm, tab4, j + 2, n);
      cp_async_commit();
      const float4* slot = sm.ring[j % kStages];
      const int cnt = min(kPer, n - j * kPer);
      for (int i = 0; i < cnt; ++i) {
        const float4* rows = slot + i * kSlab4 + g * kGroupRows * 3;
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          const float4 a = rows[3 * r], c = rows[3 * r + 1],
                       d = rows[3 * r + 2];
#pragma unroll
          for (int m = 0; m < kThreadLanes; ++m) {
            float s = a.x * x[m];
            s = s + a.y * x[m];
            s = s + a.z * x[m];
            s = s + a.w * x[m];
            s = s + c.x * x[m];
            s = s + c.y * x[m];
            s = s + c.z * x[m];
            s = s + c.w * x[m];
            s = s + d.x * x[m];
            s = s + d.y * x[m];
            s = s + d.z * x[m];
            s = s + d.w * x[m];
            cur[m] = min_nan(cur[m], s);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kThreadLanes; ++m)
    sm.part[g][kThreadLanes * q + m] = cur[m];
  __syncthreads();
  if (t < kLanes) {
    float v = sm.part[0][t];
#pragma unroll
    for (int i = 1; i < kGroups; ++i) v = min_nan(v, sm.part[i][t]);
    out[lane0 + t] = v;
  }
}

constexpr int kTile = 32;

__global__ void __launch_bounds__(kTile * 16)
transpose16_kernel(const float* __restrict__ in, int r,
                   float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int row0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;   // 16 x 32
  // read: thread (ty, tx) takes in[row0 + ty][tx]
  if (row0 + ty < r)
    tile[ty][tx] = in[static_cast<size_t>(row0 + ty) * 16 + tx];
  __syncthreads();
  // write: out[c][row0 + l] for c < 16, l < 32; thread -> (c, l)
  const int l = threadIdx.x & 31, c = threadIdx.x >> 5;
  if (row0 + l < r)
    out[static_cast<size_t>(c) * r + row0 + l] = tile[l][c];
}

}  // namespace

// Host entries, loaded with ctypes. Each returns cudaGetLastError() after
// the launch.

// items (n_items,) sorted by block, seg (n_blocks + 1,) the items' offsets
// per block, tab (n_slabs * 64, 12), o (n_blocks * 1024,) the origin-x
// row, out (n_blocks * 1024,); tab and o 16-byte aligned.
extern "C" int dcrt_probe_item_list(const int* items, const int* seg,
                                    int n_blocks, const float* tab,
                                    const float* o, float* out,
                                    void* stream) {
  if (n_blocks > 0) {
    item_list_kernel<<<n_blocks * kSplit, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(items, seg, tab,
                                                            o, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The item-list kernel on this card: resident blocks per SM, registers,
// static shared bytes, local (spill) bytes per thread, threads per block,
// CUDA blocks per ray block.
extern "C" int dcrt_probe_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  const void* fn = reinterpret_cast<const void*>(item_list_kernel);
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                           0)) != cudaSuccess)
    return static_cast<int>(err);
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = kThreads;
  out[5] = kSplit;
  return 0;
}

// in (r, 16), out (16, r).
extern "C" int dcrt_transpose16(const float* in, int r, float* out,
                                void* stream) {
  if (r > 0) {
    transpose16_kernel<<<(r + kTile - 1) / kTile, kTile * 16, 0,
                         static_cast<cudaStream_t>(stream)>>>(in, r, out);
  }
  return static_cast<int>(cudaGetLastError());
}
