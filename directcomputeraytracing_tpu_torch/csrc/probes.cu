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
//   kernel writes 3e38. What bounds it: FP32 ALU, 23 operations a (row,
//   lane) of an item (the slab reads are shared-memory broadcasts).
//   Design: one CUDA block a ray block, one thread a lane; the block walks
//   its own item segment (offsets from a searchsorted over the items'
//   blocks) in order, staging each 3 KiB slab in shared memory, and keeps
//   the running min in a register (the TPU carried it in the revisited
//   output block from one grid step to the next).
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

constexpr int kRB = 1024;          // lanes of a ray block (threads a block)
constexpr int kRows = 64;          // rows of a slab
constexpr int kCols = 12;          // columns of a slab
constexpr float kInit = 3e38f;

__global__ void __launch_bounds__(kRB)
item_list_kernel(const int* __restrict__ items, const int* __restrict__ seg,
                 const float* __restrict__ tab, const float* __restrict__ o,
                 float* __restrict__ out) {
  __shared__ float slab[kRows * kCols];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float x = o[static_cast<size_t>(b) * kRB + lane];
  float cur = kInit;
  for (int k = seg[b]; k < seg[b + 1]; ++k) {
    const int item = items[k];
    if (!(item & 1)) continue;             // uniform over the block
    const float* src = tab + static_cast<size_t>((item >> 2) & 0xFFFF)
        * (kRows * kCols);
    __syncthreads();                       // the previous slab is consumed
    for (int e = lane; e < kRows * kCols; e += kRB) slab[e] = src[e];
    __syncthreads();
    float red = kInit;
    for (int r = 0; r < kRows; ++r) {
      const float* row = slab + r * kCols;
      float s = row[0] * x;
      for (int c = 1; c < kCols; ++c) s = s + row[c] * x;
      red = fminf(red, s);
    }
    cur = fminf((item & 2) ? kInit : cur, red);
  }
  out[static_cast<size_t>(b) * kRB + lane] = cur;
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
// row, out (n_blocks * 1024,).
extern "C" int dcrt_probe_item_list(const int* items, const int* seg,
                                    int n_blocks, const float* tab,
                                    const float* o, float* out,
                                    void* stream) {
  if (n_blocks > 0) {
    item_list_kernel<<<n_blocks, kRB, 0, static_cast<cudaStream_t>(stream)>>>(
        items, seg, tab, o, out);
  }
  return static_cast<int>(cudaGetLastError());
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
