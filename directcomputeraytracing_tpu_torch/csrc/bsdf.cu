// BSDF evaluation and sampling over a mixed batch of shaded lanes, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference evaluates its BSDFs in XLA, and the
// port first ran them as plain PyTorch (bsdf/dispatch.py), which computes
// every lobe of every material type for the whole batch and blends the
// results with masks, a few hundred tensor ops a call. Two kernels take
// their place on CUDA tensors (bsdf/fused.py holds the wrappers; the
// dispatch stays as the CPU path and the kernels' twin):
//   bsdf_eval_kernel   <- dispatch.evaluate_bsdf and evaluate_bsdf_pdf on
//                         the same (wi, wo, itx): value (R, 3), pdf (R,);
//   bsdf_sample_kernel <- dispatch.sample_bsdf: (wi_w (R, 3), value
//                         (R, 3), pdf (R,), is_delta (R,) bool), consuming
//                         exactly (u_sel, u2), as the twin does.
// Inputs: world-space wo (and wi) (R, 3), u2 (R, 2), u_sel (R,) and the
// Intersection fields that the BSDFs read, in the dtypes shade_hit makes
// (f32; bool as bytes; internal_mode and material_type i64), each with its
// own row stride (ior is a strided view of the material rows); the six
// Kulla-Conty tables (lut/textures.py), contiguous f32 with their shapes.
//
// What bounds it: bytes. A lane reads about 90-110 bytes and writes 16-29;
// the work is a few hundred float operations and a few table lookups, far
// below the card's operations per byte. The twin's cost was the host's:
// each of its ops a launch, and its intermediates through device memory.
// Design: one thread a lane, which computes the tangent frame and the
// hemisphere flip once, branches on the material type (Diffuse, Plastic and
// Conductor share the reflection lobes; a rough Dielectric has the
// refractive BSDF; a smooth Dielectric and the ThinDielectric are delta
// lobes) and evaluates only that type's lobes, so that nothing but the
// outputs goes to device memory. The shaded lanes of a pass lie in pixel
// order, so a warp mostly holds one material and its branches agree. The
// tables (64 KB in all) are read through the read-only path with the
// twin's clamped lerps, in its (z, y, x) order.
//
// Numbers: the twin's formulas in its order, float32 throughout, IEEE
// division and square root, built with -fmad=false, so every product and
// sum rounds as the twin's separate tensor ops do; constants are the
// twin's double literals rounded to float, as PyTorch rounds a Python
// scalar. NaN passes through the clamps as torch.clamp passes it. Only
// sinf, cosf and atanf can differ from the twin's (by an ulp).
//
// Compiled as C++ without CUDA (g++ -x c++), the same lane functions run
// on the host through entries of the same names, so that the CPU tests can
// hold this arithmetic to the twin's without a card.

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DCRT_FN __device__ __forceinline__
#define DCRT_LDG(p) __ldg(p)
#else
#define DCRT_FN static inline
#define DCRT_LDG(p) (*(p))
#endif

namespace {

constexpr int kThreads = 256;

// the twin's Python doubles, rounded to float as PyTorch rounds a scalar
#define F(x) static_cast<float>(x)
constexpr double kPi = 3.141592653589793;
constexpr float kPiF = F(kPi);
constexpr float kInvPiF = F(1.0 / kPi);
constexpr float kTwoPiF = F(2.0 * kPi);
constexpr float kQuarterPiF = F(kPi / 4.0);
constexpr float kTiny = F(1e-20);
constexpr float kAlphaThreshold = F(0.00052441);   // core/constants.py

constexpr int kDiffuse = 0, kPlastic = 1, kConductor = 2, kDielectric = 3,
              kThinDielectric = 4;
constexpr long long kModeIgnore = 0, kModeMultiple = 2;

// the per-lane inputs, in `bsdf/fused.py` FIELDS order, with row strides
// in elements
enum Field { kWo, kWi, kU2, kUSel, kTangent, kNormal, kAlbedo, kAlpha, kIor,
             kTwoSided, kMultiscattering, kInternalMode, kMaterialType,
             kFields };
// the six tables, in BxDFLuts order, and their shapes
enum Table { kBrdf, kBrdfAvg, kBrdfDiel, kBrdfDielAvg, kBsdf, kBsdfAvg,
             kTables };
constexpr int kDims = 13;   // brdf (A, C), brdf_avg (A), brdf_dielectric
                            // (E, A, C), its avg (E, A), bsdf (E, A, C),
                            // bsdf_avg (E, A); the side axis is 2

struct Args {
  const void* p[kFields];
  long long s[kFields];
  const float* tab[kTables];
  int dim[kDims];
  int n;
  int use_vndf;
};

struct V3 {
  float x, y, z;
};

DCRT_FN V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
DCRT_FN V3 splat(float a) { return v3(a, a, a); }
DCRT_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
DCRT_FN V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
DCRT_FN V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
DCRT_FN V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
DCRT_FN V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
DCRT_FN V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }

// torch.clamp: NaN passes through
DCRT_FN float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
DCRT_FN float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
DCRT_FN float safe_sqrt(float v) { return sqrtf(clamp_min(v, 0.f)); }
DCRT_FN int imin(int a, int b) { return a < b ? a : b; }

// v / max(|v|, 1e-20): montecarlo.normalize and ggx._unit
DCRT_FN V3 unit(V3 v) {
  const float d = clamp_min(sqrtf(dot(v, v)), kTiny);
  return v3(v.x / d, v.y / d, v.z / d);
}

// ---- lane inputs ----------------------------------------------------------

DCRT_FN const float* fptr(const Args& a, Field f, int i) {
  return static_cast<const float*>(a.p[f]) + a.s[f] * i;
}
DCRT_FN float load1(const Args& a, Field f, int i) {
  return DCRT_LDG(fptr(a, f, i));
}
DCRT_FN V3 load3(const Args& a, Field f, int i) {
  const float* q = fptr(a, f, i);
  return v3(DCRT_LDG(q), DCRT_LDG(q + 1), DCRT_LDG(q + 2));
}
DCRT_FN bool load_bool(const Args& a, Field f, int i) {
  return DCRT_LDG(static_cast<const unsigned char*>(a.p[f]) + a.s[f] * i)
      != 0;
}
DCRT_FN long long load_i64(const Args& a, Field f, int i) {
  return DCRT_LDG(static_cast<const long long*>(a.p[f]) + a.s[f] * i);
}

// ---- Kulla-Conty tables (lut/textures.py) --------------------------------

// neighbour indices and blend weight of coordinate u on an axis of dim
DCRT_FN void axis(float u, int dim, int* i0, int* i1, float* f) {
  float c = clamp(u, 0.f, 1.f);
  c = c != c ? 0.f : c;                       // nan_to_num
  const float pos = c * static_cast<float>(dim - 1);
  const float i0f = floorf(pos);
  *f = pos - i0f;
  *i0 = static_cast<int>(i0f);
  *i1 = imin(*i0 + 1, dim - 1);
}

DCRT_FN float lerp(float a, float b, float f) {
  return a * (1.f - f) + b * f;
}

DCRT_FN float tex_1d(const float* t, int nx, float ux) {
  int x0, x1;
  float fx;
  axis(ux, nx, &x0, &x1, &fx);
  return lerp(DCRT_LDG(t + x0), DCRT_LDG(t + x1), fx);
}

// t (Y, X): uy indexes Y, ux indexes X
DCRT_FN float tex_2d(const float* t, int ny, int nx, float uy, float ux) {
  int y0, y1, x0, x1;
  float fy, fx;
  axis(uy, ny, &y0, &y1, &fy);
  axis(ux, nx, &x0, &x1, &fx);
  const float r0 = lerp(DCRT_LDG(t + y0 * nx + x0), DCRT_LDG(t + y1 * nx + x0),
                        fy);
  const float r1 = lerp(DCRT_LDG(t + y0 * nx + x1), DCRT_LDG(t + y1 * nx + x1),
                        fy);
  return lerp(r0, r1, fx);
}

// t (Z, Y, X) of one side
DCRT_FN float tex_3d(const float* t, int nz, int ny, int nx, float uz,
                     float uy, float ux) {
  int z0, z1, y0, y1, x0, x1;
  float fz, fy, fx;
  axis(uz, nz, &z0, &z1, &fz);
  axis(uy, ny, &y0, &y1, &fy);
  axis(ux, nx, &x0, &x1, &fx);
  const int sz = ny * nx;
#define DCRT_ZLERP(y, x) \
  lerp(DCRT_LDG(t + z0 * sz + (y) * nx + (x)), \
       DCRT_LDG(t + z1 * sz + (y) * nx + (x)), fz)
  const float r0 = lerp(DCRT_ZLERP(y0, x0), DCRT_ZLERP(y1, x0), fy);
  const float r1 = lerp(DCRT_ZLERP(y0, x1), DCRT_ZLERP(y1, x1), fy);
#undef DCRT_ZLERP
  return lerp(r0, r1, fx);
}

DCRT_FN float eta_coord(float eta) { return (eta - 1.f) * 0.5f; }

// E(cosTheta, alpha) of the Cook-Torrance BRDF
DCRT_FN float brdf_energy(const Args& a, float cos_theta, float alpha) {
  return tex_2d(a.tab[kBrdf], a.dim[0], a.dim[1], alpha, cos_theta);
}
DCRT_FN float brdf_energy_avg(const Args& a, float alpha) {
  return tex_1d(a.tab[kBrdfAvg], a.dim[2], alpha);
}
DCRT_FN float brdf_dielectric_energy(const Args& a, float cos_theta,
                                     float alpha, float eta, bool entering) {
  const int nz = a.dim[3], ny = a.dim[4], nx = a.dim[5];
  return tex_3d(a.tab[kBrdfDiel] + (entering ? nz * ny * nx : 0), nz, ny, nx,
                eta_coord(eta), alpha, cos_theta);
}
DCRT_FN float brdf_dielectric_energy_avg(const Args& a, float alpha,
                                         float eta, bool entering) {
  const int ny = a.dim[6], nx = a.dim[7];
  return tex_2d(a.tab[kBrdfDielAvg] + (entering ? ny * nx : 0), ny, nx,
                eta_coord(eta), alpha);
}
DCRT_FN float bsdf_energy(const Args& a, float cos_theta, float alpha,
                          float eta, bool entering) {
  const int nz = a.dim[8], ny = a.dim[9], nx = a.dim[10];
  return tex_3d(a.tab[kBsdf] + (entering ? nz * ny * nx : 0), nz, ny, nx,
                eta_coord(eta), alpha, cos_theta);
}
DCRT_FN float bsdf_energy_avg(const Args& a, float alpha, float eta,
                              bool entering) {
  const int ny = a.dim[11], nx = a.dim[12];
  return tex_2d(a.tab[kBsdfAvg] + (entering ? ny * nx : 0), ny, nx,
                eta_coord(eta), alpha);
}

// ---- Fresnel (bsdf/fresnel.py) -------------------------------------------

DCRT_FN float fresnel_dielectric(float cos_theta_i, float eta_o,
                                 float eta_i) {
  float cos_i = clamp(cos_theta_i, -1.f, 1.f);
  const bool swap = cos_i < 0.f;
  const float e_o = swap ? eta_i : eta_o;
  const float e_i = swap ? eta_o : eta_i;
  cos_i = fabsf(cos_i);
  const float sin_i = sqrtf(clamp_min(1.f - cos_i * cos_i, 0.f));
  const float sin_t = e_o / e_i * sin_i;
  const float cos_t = sqrtf(clamp_min(1.f - sin_t * sin_t, 0.f));
  const float r_parl = (e_i * cos_i - e_o * cos_t)
      / clamp_min(e_i * cos_i + e_o * cos_t, kTiny);
  const float r_perp = (e_o * cos_i - e_i * cos_t)
      / clamp_min(e_o * cos_i + e_i * cos_t, kTiny);
  const float f = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return sin_t >= 1.f ? 1.f : f;
}

// one channel of the exact conductor Fresnel, eta_o = 1
DCRT_FN float fresnel_conductor(float cos_theta_i, float eta, float etak) {
  const float cos_i = clamp(cos_theta_i, -1.f, 1.f);
  const float cos2 = cos_i * cos_i;
  const float sin2 = 1.f - cos2;
  const float eta2 = eta * eta;
  const float etak2 = etak * etak;
  const float t0 = eta2 - etak2 - sin2;
  const float a2b2 = safe_sqrt(t0 * t0 + 4.f * eta2 * etak2);
  const float t1 = a2b2 + cos2;
  const float a = safe_sqrt(0.5f * (a2b2 + t0));
  const float t2 = 2.f * cos_i * a;
  const float rs = (t1 - t2) / clamp_min(t1 + t2, kTiny);
  const float t3 = cos2 * a2b2 + sin2 * sin2;
  const float t4 = t2 * sin2;
  const float rp = rs * (t3 - t4) / clamp_min(t3 + t4, kTiny);
  return 0.5f * (rp + rs);
}

// dispatch._ct_fresnel: dielectric (plastic) or conductor, RGB
DCRT_FN V3 ct_fresnel(float wo_dot_h, bool dielectric, V3 ior, V3 k) {
  if (dielectric) return splat(fresnel_dielectric(wo_dot_h, 1.f, ior.x));
  return v3(fresnel_conductor(wo_dot_h, ior.x, k.x),
            fresnel_conductor(wo_dot_h, ior.y, k.y),
            fresnel_conductor(wo_dot_h, ior.z, k.z));
}

// ---- GGX (bsdf/ggx.py) ---------------------------------------------------

DCRT_FN float g1(float alpha2, V3 m, V3 w) {
  const bool consistent = dot(w, m) * w.z > 0.f;
  const float ndw = fabsf(w.z);
  const float denom = sqrtf(alpha2 + (1.f - alpha2) * ndw * ndw) + ndw;
  return consistent ? 2.f * ndw / clamp_min(denom, kTiny) : 0.f;
}

DCRT_FN float ggx_shadowing(V3 wi, V3 wo, V3 m, float alpha) {
  const float a2 = alpha * alpha;
  return g1(a2, m, wi) * g1(a2, m, wo);
}

DCRT_FN float ggx_d(V3 m, float alpha) {
  const float a2 = alpha * alpha;
  const float ndm = m.z;
  const float f = ndm * ndm * (a2 - 1.f) + 1.f;
  return a2 / clamp_min(f * f * kPiF, kTiny);
}

DCRT_FN V3 sample_ggx_ndf(float u0, float u1, float alpha) {
  const float theta = atanf(alpha * sqrtf(u0 / clamp_min(1.f - u0, kTiny)));
  const float phi = kTwoPiF * u1;
  const float s = sinf(theta);
  return v3(cosf(phi) * s, sinf(phi) * s, cosf(theta));
}

// Heitz 2018 visible-normal sampling
DCRT_FN V3 sample_ggx_vndf(V3 wo, float u0, float u1, float alpha) {
  const V3 vh = unit(v3(alpha * wo.x, alpha * wo.y, wo.z));
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = 1.f / sqrtf(clamp_min(lensq, kTiny));
  const V3 t1 = lensq > 0.f ? v3(-vh.y * inv_len, vh.x * inv_len, 0.f)
                            : v3(1.f, 0.f, 0.f);
  const V3 t2 = cross(vh, t1);
  const float r = sqrtf(u0);
  const float phi = kTwoPiF * u1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.f + vh.z);
  p2 = (1.f - s) * sqrtf(clamp_min(1.f - p1 * p1, 0.f)) + s * p2;
  const float q = sqrtf(clamp_min(1.f - p1 * p1 - p2 * p2, 0.f));
  const V3 nh = v3(p1 * t1.x + p2 * t2.x + q * vh.x,
                   p1 * t1.y + p2 * t2.y + q * vh.y,
                   p1 * t1.z + p2 * t2.z + q * vh.z);
  return unit(v3(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.f)));
}

DCRT_FN float ggx_pdf_m(V3 wo, V3 m, float alpha, bool use_vndf) {
  if (use_vndf) {
    return ggx_d(m, alpha) * g1(alpha * alpha, m, wo)
        * clamp_min(dot(wo, m), 0.f) / clamp_min(wo.z, kTiny);
  }
  return ggx_d(m, alpha) * fabsf(m.z);
}

DCRT_FN V3 sample_ggx_m(V3 wo, float u0, float u1, float alpha,
                        bool use_vndf) {
  return use_vndf ? sample_ggx_vndf(wo, u0, u1, alpha)
                  : sample_ggx_ndf(u0, u1, alpha);
}

// Cook-Torrance BRDF without Fresnel
DCRT_FN float eval_ct_brdf(V3 wi, V3 wo, float alpha, V3 m, float wo_dot_m) {
  const bool valid = wi.z > 0.f && wo.z > 0.f && wo_dot_m > 0.f
      && fabsf(m.x) + fabsf(m.y) + fabsf(m.z) > 0.f;
  const float v = ggx_d(m, alpha) * ggx_shadowing(wi, wo, m, alpha)
      / clamp_min(4.f * wi.z * wo.z, kTiny);
  return valid ? v : 0.f;
}

DCRT_FN float pdf_ct_brdf(V3 wi, V3 wo, float alpha, V3 m, float wo_dot_m,
                          bool use_vndf) {
  const bool valid = wi.z > 0.f && wo.z > 0.f && wo_dot_m > 0.f;
  const float pdf = ggx_pdf_m(wo, m, alpha, use_vndf)
      / clamp_min(4.f * wo_dot_m, kTiny);
  return valid ? pdf : 0.f;
}

// the refractive BSDF's half vector, in the upper hemisphere
DCRT_FN V3 half_vector(V3 wi, V3 wo, float eta_o, float eta_i,
                       bool* reflect) {
  *reflect = wi.z * wo.z > 0.f;
  const float so = *reflect ? 1.f : eta_o;
  const float si = *reflect ? 1.f : eta_i;
  const V3 m = unit(v3(wo.x * so + wi.x * si, wo.y * so + wi.y * si,
                       wo.z * so + wi.z * si));
  return m.z < 0.f ? neg(m) : m;
}

DCRT_FN float eval_ct_bsdf(V3 wi, V3 wo, float alpha, float eta_o,
                           float eta_i) {
  const bool active = wo.z != 0.f && wi.z != 0.f;
  bool reflect;
  const V3 m = half_vector(wi, wo, eta_o, eta_i, &reflect);
  const float wi_dot_m = dot(wi, m);
  const float wo_dot_m = dot(wo, m);
  const float d = ggx_d(m, alpha);
  const float f = fresnel_dielectric(wo_dot_m, eta_o, eta_i);
  const float g = ggx_shadowing(wi, wo, m, alpha);
  float v;
  if (reflect) {
    v = f * d * g / clamp_min(4.f * fabsf(wi.z) * fabsf(wo.z), kTiny);
  } else {
    const float sd = eta_o * wo_dot_m + eta_i * wi_dot_m;
    v = (1.f - f) * fabsf(d * g * fabsf(wi_dot_m) * fabsf(wo_dot_m)
                          * (eta_o * eta_o)
                          / clamp_min(fabsf(wi.z * wo.z * sd * sd), kTiny));
  }
  return active ? v : 0.f;
}

DCRT_FN float pdf_ct_bsdf(V3 wi, V3 wo, float alpha, float eta_o,
                          float eta_i, bool use_vndf) {
  bool reflect;
  const V3 m = half_vector(wi, wo, eta_o, eta_i, &reflect);
  const float wi_dot_m = dot(wi, m);
  const float wo_dot_m = dot(wo, m);
  const bool active = wo.z != 0.f && wi.z != 0.f && wi_dot_m * wi.z > 0.f
      && wo_dot_m * wo.z > 0.f;
  const float sd = eta_o * wo_dot_m + eta_i * wi_dot_m;
  const float dwh_dwi = reflect
      ? 1.f / clamp_min(4.f * fabsf(wi_dot_m), kTiny)
      : fabsf(eta_i * eta_i * wi_dot_m) / clamp_min(sd * sd, kTiny);
  const float f = fresnel_dielectric(wo_dot_m, eta_o, eta_i);
  const float pdf = ggx_pdf_m(wo, m, alpha, use_vndf)
      * (reflect ? f : 1.f - f) * dwh_dwi;
  return active ? pdf : 0.f;
}

// refract -w about m, eta_rel = eta_o / eta_i (HLSL refract)
DCRT_FN V3 refract(V3 w, V3 m, float eta_rel) {
  const V3 i = neg(w);
  const float cos_i = -dot(i, m);
  const float sin2_t = eta_rel * eta_rel * clamp_min(1.f - cos_i * cos_i, 0.f);
  const float cos_t = sqrtf(clamp_min(1.f - sin2_t, 0.f));
  const float k = eta_rel * cos_i - cos_t;
  const V3 t = v3(eta_rel * i.x + k * m.x, eta_rel * i.y + k * m.y,
                  eta_rel * i.z + k * m.z);
  return sin2_t > 1.f ? splat(0.f) : t;
}

// wi of the rough dielectric BSDF: Fresnel picks reflection or refraction
DCRT_FN V3 sample_ct_bsdf(V3 wo, float u_sel, float u0, float u1,
                          float alpha, float eta_o, float eta_i,
                          bool use_vndf) {
  const V3 m = sample_ggx_m(wo, u0, u1, alpha, use_vndf);
  const float wo_dot_m = dot(wo, m);
  const float f = fresnel_dielectric(wo_dot_m, eta_o, eta_i);
  const float k = 2.f * wo_dot_m;
  V3 wi = u_sel < f ? v3(k * m.x - wo.x, k * m.y - wo.y, k * m.z - wo.z)
                    : refract(wo, m, eta_o / eta_i);
  if (wo.z == 0.f || wo_dot_m <= 0.f) wi = splat(0.f);
  if (eta_o == eta_i) wi = neg(wo);
  return wi;
}

// ---- sampling primitives (sampling/montecarlo.py) ------------------------

DCRT_FN V3 cosine_sample_hemisphere(float u0, float u1) {
  const float sx = 2.f * u0 - 1.f;
  const float sy = 2.f * u1 - 1.f;
  const bool c_right = sx >= -sy;
  const bool c_rt = sx > sy;
  const bool c_lb = sx <= sy;
  const float r = c_right ? (c_rt ? sx : sy) : (c_lb ? -sx : -sy);
  const float rs = r == 0.f ? 1.f : r;
  float theta = c_right
      ? (c_rt ? (sy > 0.f ? sy / rs : 8.f + sy / rs) : 2.f - sx / rs)
      : (c_lb ? 4.f - sy / rs : 6.f + sx / rs);
  theta = theta * kQuarterPiF;
  float dx = r * cosf(theta), dy = r * sinf(theta);
  if (sx == 0.f && sy == 0.f) dx = dy = 0.f;
  return v3(dx, dy, safe_sqrt(1.f - (dx * dx + dy * dy)));
}

// ---- Kulla-Conty lobes (bsdf/kullaconty.py) ------------------------------

DCRT_FN float favg_dielectric(float eta) {
  const float eta2 = eta * eta;
  return eta >= 1.f
      ? (eta - 1.f) / (F(4.08567) + F(1.00071) * eta)
      : F(0.997118) + F(0.1014) * eta - F(0.965241) * eta2
          - F(0.130607) * eta2 * eta;
}

// one channel of the conductor's average Fresnel fit
DCRT_FN float favg_conductor(float eta, float k) {
  const float num = eta * (F(133.736) - F(98.9833) * eta)
      + k * (eta * (F(59.5617) - F(3.98288) * eta) - F(182.37))
      + ((F(0.30818) * eta - F(13.1093)) * eta - F(62.5919)) * k * k
      - F(8.21474);
  const float den = k * (eta * (F(94.6517) - F(15.8558) * eta) - F(187.166))
      + (F(-78.476) * eta - F(395.268)) * eta
      + (eta * (eta - F(15.4387)) - F(62.0752)) * k * k;
  return clamp(num / (fabsf(den) < kTiny ? kTiny : den), 0.f, 1.f);
}

DCRT_FN float multiscatter_fresnel(float e_avg, float f_avg) {
  return f_avg * f_avg * e_avg
      / clamp_min(1.f - f_avg * (1.f - e_avg), kTiny);
}

DCRT_FN float multiscatter_bxdf(float e_i, float e_o, float e_avg) {
  return e_avg < 1.f
      ? (1.f - e_i) * (1.f - e_o) / clamp_min(kPiF * (1.f - e_avg), kTiny)
      : 0.f;
}

DCRT_FN float pdf_cos_upper(V3 wi, V3 wo) {   // pdf_lambert, pdf_ms_brdf
  return wi.z > 0.f && wo.z > 0.f ? wi.z * kInvPiF : 0.f;
}

struct DielectricMs {   // dispatch._dielectric_ms_terms
  float e, e_avg, e_inv_avg, ratio;
};

DCRT_FN DielectricMs dielectric_ms_terms(const Args& a, float alpha,
                                         float ior, float cos_o,
                                         bool inverted) {
  const float e_avg_enter = bsdf_energy_avg(a, alpha, ior, true);
  const float f_avg_enter = favg_dielectric(1.f / ior);
  const float e_avg_leave = bsdf_energy_avg(a, alpha, ior, false);
  const float f_avg_leave = favg_dielectric(ior);
  // kullaconty.reciprocal_factor
  const float inv_eta = 1.f / ior;
  const float factor = (1.f - f_avg_leave) * (1.f - e_avg_leave);
  const float factor1 = (1.f - f_avg_enter) * (1.f - e_avg_enter) * inv_eta
      * inv_eta;
  const float recip = factor1 / clamp_min(factor + factor1, F(1e-5));
  DielectricMs d;
  d.e = bsdf_energy(a, cos_o, alpha, ior, inverted);
  const float f_avg = inverted ? f_avg_enter : f_avg_leave;
  d.e_avg = inverted ? e_avg_enter : e_avg_leave;
  d.e_inv_avg = inverted ? e_avg_leave : e_avg_enter;
  d.ratio = (inverted ? 1.f - recip : recip) * (1.f - f_avg);
  return d;
}

DCRT_FN float eval_ms_bsdf(const Args& a, V3 wi, float alpha,
                           const DielectricMs& d, float eta,
                           bool is_entering) {
  const float cos_i = fabsf(wi.z);
  const bool refl = wi.z > 0.f;
  const float e_i = bsdf_energy(a, cos_i, alpha, eta,
                                refl ? is_entering : !is_entering);
  const float factor = refl ? 1.f - d.ratio : d.ratio;
  const float v = multiscatter_bxdf(e_i, d.e, refl ? d.e_avg : d.e_inv_avg)
      * factor;
  return cos_i > 0.f ? v : 0.f;
}

DCRT_FN float pdf_ms_bsdf(V3 wi, float ratio) {
  const float cos_i = fabsf(wi.z);
  const float pdf = cos_i * kInvPiF * (wi.z > 0.f ? 1.f - ratio : ratio);
  return cos_i > 0.f ? pdf : 0.f;
}

// ---- the lane ------------------------------------------------------------

struct Lane {
  V3 t, b, n;        // tangent frame
  V3 wo;             // tangent-space wo, flipped into the upper hemisphere
  bool inverted;     // wo below the shading normal
  float flip;
  int type;
  float alpha;
  V3 albedo, ior;
  bool two_sided, ms, smooth;
  long long internal_mode;
};

DCRT_FN V3 to_tbn(const Lane& l, V3 v) {
  return v3(dot(v, l.t), dot(v, l.b), dot(v, l.n));
}

DCRT_FN Lane load_lane(const Args& a, int i) {
  Lane l;
  l.t = load3(a, kTangent, i);
  l.n = load3(a, kNormal, i);
  l.b = cross(l.n, l.t);
  const V3 wo = to_tbn(l, load3(a, kWo, i));
  l.inverted = wo.z < 0.f;
  l.flip = l.inverted ? -1.f : 1.f;
  l.wo = v3(wo.x, wo.y, wo.z * l.flip);
  const long long mt = load_i64(a, kMaterialType, i);
  l.type = mt >= 0 && mt <= kThinDielectric ? static_cast<int>(mt) : -1;
  l.alpha = load1(a, kAlpha, i);
  l.albedo = load3(a, kAlbedo, i);
  l.ior = load3(a, kIor, i);
  l.two_sided = load_bool(a, kTwoSided, i);
  l.ms = load_bool(a, kMultiscattering, i);
  l.smooth = l.alpha < kAlphaThreshold;
  l.internal_mode = load_i64(a, kInternalMode, i);
  return l;
}

// dispatch._category_a_lobes, for the lane's own type only
struct LobesA {
  bool is_diffuse, is_plastic, is_conductor, has_any, ms_lobe;
  float e, e_avg;   // E(cos_o, alpha) and Eavg(alpha), where ms_lobe
  V3 f_ms;          // F_ms, where ms_lobe
  float w_l, w_ct, w_ms;
};

DCRT_FN LobesA lobes_a(const Args& a, const Lane& l) {
  LobesA o;
  o.is_diffuse = l.type == kDiffuse;
  o.is_plastic = l.type == kPlastic;
  o.is_conductor = l.type == kConductor;
  o.has_any = !l.inverted || l.two_sided;
  o.ms_lobe = l.ms && (o.is_plastic || o.is_conductor) && o.has_any
      && !l.smooth;
  o.e = o.e_avg = 0.f;
  o.f_ms = splat(0.f);
  if (o.ms_lobe) {
    o.e = brdf_energy(a, l.wo.z, l.alpha);
    o.e_avg = brdf_energy_avg(a, l.alpha);
    o.f_ms = o.is_plastic
        ? splat(multiscatter_fresnel(o.e_avg, favg_dielectric(l.ior.x)))
        : v3(multiscatter_fresnel(o.e_avg, favg_conductor(l.ior.x, l.albedo.x)),
             multiscatter_fresnel(o.e_avg, favg_conductor(l.ior.y, l.albedo.y)),
             multiscatter_fresnel(o.e_avg,
                                  favg_conductor(l.ior.z, l.albedo.z)));
  }
  if (o.is_plastic) {
    o.w_ct = brdf_dielectric_energy(a, l.wo.z, l.alpha, l.ior.x, false);
    o.w_ms = o.ms_lobe ? o.f_ms.x * (1.f - o.e) : 0.f;
    o.w_l = clamp_min(1.f - o.w_ct - o.w_ms, 0.f);
  } else {
    o.w_ct = o.is_conductor ? (o.ms_lobe ? 0.5f : 1.f) : 0.f;
    o.w_ms = o.ms_lobe ? 0.5f : 0.f;
    o.w_l = o.is_diffuse ? 1.f : 0.f;
  }
  return o;
}

// dispatch._internal_scattering_factor of a plastic's substrate
DCRT_FN V3 internal_scattering(const Args& a, const Lane& l) {
  if (l.internal_mode == kModeIgnore) return splat(1.f);
  const float avg_r = brdf_dielectric_energy_avg(a, l.alpha, l.ior.x, true);
  const float num = 1.f - avg_r;                // over 1 but for Multiple
  if (l.internal_mode != kModeMultiple) return splat(num);
  return v3(num / clamp_min(1.f - l.albedo.x * avg_r, kTiny),
            num / clamp_min(1.f - l.albedo.y * avg_r, kTiny),
            num / clamp_min(1.f - l.albedo.z * avg_r, kTiny));
}

// dispatch._half: normalized wo + wi, 0 where it is 0
DCRT_FN V3 half_dir(V3 wo, V3 wi) {
  const V3 h = add(wo, wi);
  if (fabsf(h.x) + fabsf(h.y) + fabsf(h.z) == 0.f) return splat(0.f);
  return unit(h);
}

// the lobes of category A at wi and h: value (RGB) and pdf, each the sum
// of the lobes that are on, in the twin's order (Lambert, CT, multiscatter)
DCRT_FN void category_a(const Args& a, const Lane& l, const LobesA& o, V3 wi,
                        V3 h, float wo_dot_h, bool lambert_on, bool ct_on,
                        bool ms_on, float w_lambert_value, V3 fres,
                        V3* value, float* pdf) {
  const V3 zero = splat(0.f);
  V3 v_l = zero, v_ct = zero, v_ms = zero;
  float p_l = 0.f, p_ct = 0.f, p_ms = 0.f;
  if (lambert_on) {
    const bool upper = wi.z > 0.f && l.wo.z > 0.f;
    const float lr = (upper ? kInvPiF : 0.f) * w_lambert_value;
    v_l = scale(l.albedo, lr);
    if (o.is_plastic) v_l = mul(v_l, internal_scattering(a, l));
    p_l = pdf_cos_upper(wi, l.wo) * o.w_l;
  }
  if (ct_on) {
    const float ct = eval_ct_brdf(wi, l.wo, l.alpha, h, wo_dot_h);
    v_ct = scale(fres, ct);
    p_ct = pdf_ct_brdf(wi, l.wo, l.alpha, h, wo_dot_h, a.use_vndf)
        * o.w_ct;
  }
  if (ms_on) {                                  // kc.eval_ms_brdf
    if (wi.z > 0.f && l.wo.z > 0.f) {
      v_ms = scale(o.f_ms, multiscatter_bxdf(brdf_energy(a, wi.z, l.alpha),
                                             o.e, o.e_avg));
    }
    p_ms = pdf_cos_upper(wi, l.wo) * o.w_ms;
  }
  *value = add(add(add(zero, v_l), v_ct), v_ms);
  *pdf = 0.f + p_l + p_ct + p_ms;
}

// NEE: f(wi, wo) and the pdf of sampling wi, in tangent space
DCRT_FN void eval_lane(const Args& a, const Lane& l, V3 wi, V3* value,
                       float* pdf) {
  *value = splat(0.f);
  *pdf = 0.f;
  if (l.type != kDielectric && l.type != kThinDielectric) {
    const LobesA o = lobes_a(a, l);
    const V3 h = half_dir(l.wo, wi);
    const float wo_dot_h = dot(h, l.wo);
    const bool ct_on = (o.is_plastic || o.is_conductor) && o.has_any
        && !l.smooth;
    const V3 fres = ct_on ? ct_fresnel(wo_dot_h, o.is_plastic, l.ior, l.albedo)
                          : splat(0.f);
    category_a(a, l, o, wi, h, wo_dot_h,
               (o.is_diffuse || o.is_plastic) && o.has_any, ct_on, o.ms_lobe,
               o.is_diffuse ? 1.f : o.w_l, fres, value, pdf);
  } else if (l.type == kDielectric && !l.smooth) {
    const float ior = l.ior.x;
    const float eta_o = l.inverted ? ior : 1.f;
    const float eta_i = l.inverted ? 1.f : ior;
    const DielectricMs d = dielectric_ms_terms(a, l.alpha, ior, l.wo.z,
                                               l.inverted);
    float v = eval_ct_bsdf(wi, l.wo, l.alpha, eta_o, eta_i);
    v = v + (l.ms ? eval_ms_bsdf(a, wi, l.alpha, d, ior, l.inverted) : 0.f);
    *value = splat(v);
    const float w_bsdf = l.ms ? d.e : 1.f;
    const float w_ms = l.ms ? 1.f - d.e : 0.f;
    *pdf = pdf_ct_bsdf(wi, l.wo, l.alpha, eta_o, eta_i, a.use_vndf) * w_bsdf
        + pdf_ms_bsdf(wi, d.ratio) * w_ms;
  }
}

// specular.sample_specular_bsdf: the smooth dielectric's delta lobes
DCRT_FN void sample_specular_bsdf(V3 wo, float u_sel, float eta_o,
                                  float eta_i, bool is_thin, V3* wi,
                                  float* value, float* pdf) {
  float f = fresnel_dielectric(wo.z, eta_o, eta_i);
  float t = 1.f - f;
  if (is_thin) {
    f = f < 1.f ? f + t * t * f / clamp_min(1.f - f * f, kTiny) : f;
    t = 1.f - f;
  }
  const bool reflect = u_sel < f;
  const V3 wi_refl = v3(-wo.x, -wo.y, wo.z);
  const float eta_rel = eta_o / eta_i;
  const float cos_i = wo.z;
  const float sin2_t = eta_rel * eta_rel * clamp_min(1.f - cos_i * cos_i, 0.f);
  const float cos_t = sqrtf(clamp_min(1.f - sin2_t, 0.f));
  const V3 wi_refr = is_thin ? neg(wo)
                             : v3(-eta_rel * wo.x, -eta_rel * wo.y, -cos_t);
  V3 w = reflect ? wi_refl : wi_refr;
  float v, p;
  if (reflect) {
    v = f / clamp_min(wi_refl.z, kTiny);
    p = f;
  } else {
    const float s = is_thin ? 1.f : eta_o * eta_o / (eta_i * eta_i);
    v = t * s / clamp_min(-wi_refr.z, kTiny);
    p = t;
  }
  if (wo.z <= 0.f || (!reflect && w.z == 0.f)) {
    w = splat(0.f);
    v = p = 0.f;
  }
  if (eta_o == eta_i) {
    w = neg(wo);
    v = 1.f / clamp_min(wo.z, kTiny);
    p = 1.f;
  }
  *wi = w;
  *value = v;
  *pdf = p;
}

// a BSDF sample: tangent-space wi, value, pdf, is_delta
DCRT_FN bool sample_lane(const Args& a, const Lane& l, float u_sel, float u0,
                         float u1, V3* wi, V3* value, float* pdf) {
  const bool is_thin = l.type == kThinDielectric;
  const bool is_dielectric = l.type == kDielectric;
  if (!is_dielectric && !is_thin) {                 // category A
    const LobesA o = lobes_a(a, l);
    const bool pick_l = u_sel < o.w_l;
    const bool pick_ct = !pick_l && u_sel < o.w_l + o.w_ct;
    const bool delta = pick_ct && l.smooth;
    V3 h;
    if (pick_ct && l.smooth) {
      *wi = v3(-l.wo.x, -l.wo.y, l.wo.z);           // mirror
    } else if (pick_ct) {
      h = sample_ggx_m(l.wo, u0, u1, l.alpha, a.use_vndf);
      const float k = 2.f * dot(l.wo, h);
      *wi = v3(k * h.x - l.wo.x, k * h.y - l.wo.y, k * h.z - l.wo.z);
    } else {
      *wi = cosine_sample_hemisphere(u0, u1);        // Lambert or ms
      h = half_dir(l.wo, *wi);
    }
    if (delta) h = v3(0.f, 0.f, 1.f);
    const float wo_dot_h = delta ? l.wo.z : dot(h, l.wo);
    const bool ct_on = (o.is_plastic || o.is_conductor) && o.has_any
        && !l.smooth;
    const V3 fres = ct_on || delta
        ? ct_fresnel(wo_dot_h, o.is_plastic, l.ior, l.albedo) : splat(0.f);
    if (delta) {
      // specular.sample_specular_brdf's value and pdf
      const bool ok = l.wo.z > 0.f;
      const float v_spec = ok ? 1.f / clamp_min(wi->z, kTiny) : 0.f;
      *value = scale(fres, v_spec);
      *pdf = (ok ? 1.f : 0.f) * o.w_ct;
      return true;
    }
    category_a(a, l, o, *wi, h, wo_dot_h,
               (o.is_diffuse || o.is_plastic) && o.has_any, ct_on, o.ms_lobe,
               o.w_l, fres, value, pdf);
    return false;
  }
  const float ior = l.ior.x;
  if (is_thin || l.smooth) {                        // category C: delta
    const bool entering = l.inverted && !is_thin;
    float v;
    sample_specular_bsdf(l.wo, u_sel, entering ? ior : 1.f,
                         entering ? 1.f : ior, is_thin, wi, &v, pdf);
    *value = splat(v);
    return true;
  }
  // category B: the rough dielectric
  const float eta_o = l.inverted ? ior : 1.f;
  const float eta_i = l.inverted ? 1.f : ior;
  const DielectricMs d = dielectric_ms_terms(a, l.alpha, ior, l.wo.z,
                                             l.inverted);
  const float w_bsdf = l.ms ? d.e : 1.f;
  const float w_msb = l.ms ? 1.f - d.e : 0.f;
  if (u_sel < w_bsdf) {
    *wi = sample_ct_bsdf(l.wo, u_sel, u0, u1, l.alpha, eta_o, eta_i,
                         a.use_vndf);
  } else {
    // kullaconty.sample_ms_bsdf: flipped below with probability ratio
    *wi = cosine_sample_hemisphere(u0, u1);
    if (u_sel < d.ratio) wi->z = -wi->z;
  }
  float v = eval_ct_bsdf(*wi, l.wo, l.alpha, eta_o, eta_i);
  v = v + (l.ms ? eval_ms_bsdf(a, *wi, l.alpha, d, ior, l.inverted) : 0.f);
  *value = splat(v);
  *pdf = pdf_ct_bsdf(*wi, l.wo, l.alpha, eta_o, eta_i, a.use_vndf) * w_bsdf
      + (l.ms ? pdf_ms_bsdf(*wi, d.ratio) * w_msb : 0.f);
  return false;
}

DCRT_FN void eval_one(const Args& a, int i, float* value, float* pdf) {
  const Lane l = load_lane(a, i);
  const V3 wi_w = load3(a, kWi, i);
  const V3 wi_t = to_tbn(l, wi_w);
  const V3 wi = v3(wi_t.x, wi_t.y, wi_t.z * l.flip);
  V3 v;
  float p;
  eval_lane(a, l, wi, &v, &p);
  value[3 * static_cast<long long>(i)] = v.x;
  value[3 * static_cast<long long>(i) + 1] = v.y;
  value[3 * static_cast<long long>(i) + 2] = v.z;
  pdf[i] = p;
}

DCRT_FN void sample_one(const Args& a, int i, float* wi_w, float* value,
                        float* pdf, unsigned char* is_delta) {
  const Lane l = load_lane(a, i);
  const float* u2 = fptr(a, kU2, i);
  V3 wi, v;
  float p;
  const bool delta = sample_lane(a, l, load1(a, kUSel, i), DCRT_LDG(u2),
                                 DCRT_LDG(u2 + 1), &wi, &v, &p);
  // back to world space: flip z, then the frame (dispatch._from_tbn)
  const float wz = wi.z * l.flip;
  const long long k = 3 * static_cast<long long>(i);
  wi_w[k] = wi.x * l.t.x + wi.y * l.b.x + wz * l.n.x;
  wi_w[k + 1] = wi.x * l.t.y + wi.y * l.b.y + wz * l.n.y;
  wi_w[k + 2] = wi.x * l.t.z + wi.y * l.b.z + wz * l.n.z;
  value[k] = v.x;
  value[k + 1] = v.y;
  value[k + 2] = v.z;
  pdf[i] = p;
  is_delta[i] = delta ? 1 : 0;
}

Args make_args(const void* const* ptrs, const long long* strides,
               const void* const* tables, const int* dims, int n,
               int use_vndf) {
  Args a;
  for (int f = 0; f < kFields; ++f) {
    a.p[f] = ptrs[f];
    a.s[f] = strides[f];
  }
  for (int t = 0; t < kTables; ++t) {
    a.tab[t] = static_cast<const float*>(tables[t]);
  }
  for (int d = 0; d < kDims; ++d) a.dim[d] = dims[d];
  a.n = n;
  a.use_vndf = use_vndf;
  return a;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads)
bsdf_eval_kernel(const Args a, float* __restrict__ value,
                 float* __restrict__ pdf) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) eval_one(a, i, value, pdf);
}

__global__ void __launch_bounds__(kThreads)
bsdf_sample_kernel(const Args a, float* __restrict__ wi,
                   float* __restrict__ value, float* __restrict__ pdf,
                   unsigned char* __restrict__ is_delta) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) sample_one(a, i, wi, value, pdf, is_delta);
}

#endif

}  // namespace

// Host entries, loaded with ctypes. ptrs and strides: the kFields inputs
// in Field order (a null pointer for an input the call does not read),
// row strides in elements; tables and dims: the six tables in Table order
// and their kDims sizes. Outputs are contiguous. Each returns 0 or the
// first CUDA error (cudaGetLastError() after the launch); the host build
// runs the lanes in a loop and returns 0.
extern "C" int dcrt_bsdf_eval(const void* const* ptrs,
                              const long long* strides,
                              const void* const* tables, const int* dims,
                              int n, int use_vndf, float* value, float* pdf,
                              void* stream) {
  const Args a = make_args(ptrs, strides, tables, dims, n, use_vndf);
#ifdef __CUDACC__
  if (n > 0) {
    bsdf_eval_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, value, pdf);
  }
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (int i = 0; i < n; ++i) eval_one(a, i, value, pdf);
  return 0;
#endif
}

extern "C" int dcrt_bsdf_sample(const void* const* ptrs,
                                const long long* strides,
                                const void* const* tables, const int* dims,
                                int n, int use_vndf, float* wi, float* value,
                                float* pdf, unsigned char* is_delta,
                                void* stream) {
  const Args a = make_args(ptrs, strides, tables, dims, n, use_vndf);
#ifdef __CUDACC__
  if (n > 0) {
    bsdf_sample_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        a, wi, value, pdf, is_delta);
  }
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (int i = 0; i < n; ++i) sample_one(a, i, wi, value, pdf, is_delta);
  return 0;
#endif
}
