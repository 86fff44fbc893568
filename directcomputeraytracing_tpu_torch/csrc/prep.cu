// Ray preparation of the work-list and pair casts, for Hopper (sm_90a).
//
// Replaces the TPU kernel _prep_od_kernel of directcomputeraytracing_tpu/
// accel/worklist.py (:205, launched by _prep_od_pallas :221), together
// with the XLA steps around it (_prep_rays_wl :126-169: sanitise, pad,
// t_max row): one launch computes the whole contract of prep_rays in
// accel/worklist.py of the port, whose plain version is prep_rays_torch.
//   in:  origin, direction (R, 3) f32 row-major; t_max a scalar (BIG for a
//        closest cast) or per ray (R,) (stride 1) or one value (stride 0)
//   out: od (9, Rp) f32 rows [o; d; 1/d], tm (Rp,) f32, Rp a multiple of
//        the work list's ray block.
// A real ray with a non-finite component or d.d == 0 is parked at `far`
// along +x (it enters no box); so is a padding ray, whose t_max is 0. A
// reciprocal of |d| < 1e-30 is taken of +-1e-30, the sign from d >= 0 (so
// -0.0 gives +1e30), as in the twin. A denormal counts as zero, as in the
// reference's flush-to-zero arithmetic (this kernel itself keeps
// denormals): d.d == 0 where every squared component is below FLT_MIN,
// and a negative denormal component gets +1e-30.
//
// What bounds it: bytes. 24 bytes read and 40 written a ray (28 with a per
// ray t_max), three divisions a ray. Design: one thread a padded ray, a
// block of kThreads rays. The block stages its rays' (kThreads, 3) origin
// and direction rows in shared memory with coalesced reads of the
// contiguous 3 * kThreads floats, and each of the nine output rows is
// written coalesced. Built with -fmad=false and IEEE division, so od and
// tm are bit-equal to the twin's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltMin = 1.17549435e-38f;   // 2^-126

__device__ __forceinline__ float safe_inv(float d) {
  return 1.f / (fabsf(d) < 1e-30f ? (d > -kFltMin ? 1e-30f : -1e-30f) : d);
}

__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ origin,
            const float* __restrict__ direction, int r,
            const float* __restrict__ t_max, int t_stride, float t_value,
            float far, int rp, float* __restrict__ od,
            float* __restrict__ tm) {
  __shared__ float so[3 * kThreads];
  __shared__ float sd[3 * kThreads];
  const int base = blockIdx.x * kThreads;
  const int n = min(kThreads, max(r - base, 0));   // real rays of the block
  for (int k = threadIdx.x; k < 3 * n; k += kThreads) {
    so[k] = origin[3 * static_cast<size_t>(base) + k];
    sd[k] = direction[3 * static_cast<size_t>(base) + k];
  }
  __syncthreads();
  const int j = threadIdx.x;
  const int i = base + j;
  if (i >= rp) return;
  float o[3] = {far, far, far}, d[3] = {1.f, 0.f, 0.f};
  float t = 0.f;
  if (j < n) {
    const float ox = so[3 * j], oy = so[3 * j + 1], oz = so[3 * j + 2];
    const float dx = sd[3 * j], dy = sd[3 * j + 1], dz = sd[3 * j + 2];
    const bool ok = isfinite(ox) && isfinite(oy) && isfinite(oz)
        && isfinite(dx) && isfinite(dy) && isfinite(dz)
        && (dx * dx >= kFltMin || dy * dy >= kFltMin || dz * dz >= kFltMin);
    if (ok) {
      o[0] = ox; o[1] = oy; o[2] = oz;
      d[0] = dx; d[1] = dy; d[2] = dz;
    }
    t = t_max ? t_max[static_cast<size_t>(i) * t_stride] : t_value;
  }
  const size_t stride = static_cast<size_t>(rp);
  for (int k = 0; k < 3; ++k) {
    od[k * stride + i] = o[k];
    od[(3 + k) * stride + i] = d[k];
    od[(6 + k) * stride + i] = safe_inv(d[k]);
  }
  tm[i] = t;
}

}  // namespace

// Host entry, loaded with ctypes. t_max may be null (every real ray gets
// t_value); rp is a multiple of kThreads. Returns cudaGetLastError() after
// the launch.
extern "C" int dcrt_prep_rays(const float* origin, const float* direction,
                              int r, const float* t_max, int t_stride,
                              float t_value, float far, int rp, float* od,
                              float* tm, void* stream) {
  if (rp > 0) {
    prep_kernel<<<rp / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        origin, direction, r, t_max, t_stride, t_value, far, rp, od, tm);
  }
  return static_cast<int>(cudaGetLastError());
}
