// The material lobes for Hopper (sm_90a): M1, each lane's scatter sample
// (its three random numbers, then its own lobe's direction, bsdf and pdf),
// and M2, each lane's bsdf and pdf at a given direction (the light's, in
// NEE).  One thread per lane.
//
// Replaces no TPU kernel.  The JAX package shades in plain jnp
// (pathtracer_tpu/ops/materials.py scatter_sample, bsdf_eval, pdf_eval,
// and utils/rng.py pixel_uniforms), which XLA fuses.  The port's plain
// PyTorch version of the same code (ops/materials.py, utils/rng.py) runs on
// the card as one elementwise kernel per operation over (N,) columns: a
// scatter draw is about 354 of them, the lobes of cornell_spheres' five
// materials about 842 and the evaluation at the light 329, each a pass over
// device memory.  These kernels keep a lane's values in registers from its
// inputs to its outputs, and a lane runs only its own material's lobe.
//
// What bounds them on this card: bytes.  M1 reads a lane's material (type,
// albedo, roughness, metallic, ior, emission: 40 bytes), its normal and ray
// direction (24) and its lane id (4), and writes bsdf, pdf and direction (28
// bytes); M2 reads the material but ior and emission (24), the normal, the
// ray and the light direction (36), and writes bsdf and pdf (16).  At
// 640,000 lanes: 61 MB and 49 MB, 18 us and 15 us at 3.35 TB/s.  A lane's
// operations (chip_smoke.py SHADE_OPS: threefry's 20 rounds twice, about
// 240, then at most about 330 for a lobe) take at most 11 us at one
// operation a lane a clock.
//
// Built with -fmad=false and without fast math, every operation in the
// order of the plain version, so the results are its results bit for bit on
// the card: IEEE division and square root; sinf and cosf, as torch.sin and
// torch.cos call them; each Python float constant rounded to float32, as
// PyTorch rounds a scalar for a float32 kernel; `1.0 / x` a division (PyTorch
// computes it as reciprocal(x) * 1); `x / 2.0` a multiplication by 0.5 (a
// tensor divided by a Python scalar is multiplied by its reciprocal);
// torch.clamp(x, min=lo) as a NaN-propagating max; ops/math.py dot as
// x*x + y*y + z*z left to right and mix as a*(1-t) + b*t.  The plain
// version evaluates every lobe on every lane and selects; a lane's own lobe
// gives the same bits, since every operation is elementwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_math.cuh"

namespace {

constexpr int SHADE_THREADS = 128;  // lanes per CTA
// scene/parser.py material types; any other type takes the Light default
constexpr int kLambertian = 0;
constexpr int kMetallicWorkflow = 1;
constexpr int kDielectric = 2;
constexpr int kMicrofacet = 3;

// ops/math.py sample_hemisphere_cosine
__device__ __forceinline__ float3 sample_hemisphere_cosine(float3 n, float r1, float r2) {
  float3 t, b;
  onb_pixar(n, t, b);
  const float sin_t = sqrtf(r1);
  const float cos_t = sqrtf(clamp_min(1.0f - r1, 0.0f));
  const float phi = kTwoPi * r2;
  const float x = sin_t * cosf(phi);
  const float y = sin_t * sinf(phi);
  return f3(x * t.x + y * b.x + cos_t * n.x, x * t.y + y * b.y + cos_t * n.y,
            x * t.z + y * b.z + cos_t * n.z);
}

// ops/math.py reflect_dir: wo about the wo-facing side of n.
__device__ __forceinline__ float3 reflect_dir(float3 n, float3 wo) {
  const float3 nf = dot(wo, n) < 0.0f ? n : neg(n);
  const float d = dot(wo, nf);
  return f3(wo.x - 2.0f * nf.x * d, wo.y - 2.0f * nf.y * d, wo.z - 2.0f * nf.z * d);
}

// ops/math.py reflect (glm::reflect): i - 2 * dot(n, i) * n.
__device__ __forceinline__ float3 reflect(float3 i, float3 n) {
  const float d2 = 2.0f * dot(n, i);
  return f3(i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z);
}

// ops/math.py refract_dir: from ior1 into ior2, the radicand clamped at 0.
__device__ __forceinline__ float3 refract_dir(float3 n, float3 wo, float ior1, float ior2) {
  const float3 nf = dot(wo, n) < 0.0f ? n : neg(n);
  const float eta = ior1 / ior2;
  const float d = dot(wo, nf);
  const float3 rp = f3((wo.x - d * nf.x) * eta, (wo.y - d * nf.y) * eta, (wo.z - d * nf.z) * eta);
  const float s = -sqrtf(clamp_min(1.0f - dot(rp, rp), 0.0f));
  return f3(rp.x + s * nf.x, rp.y + s * nf.y, rp.z + s * nf.z);
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// ops/math.py fresnel_schlick with a (3,) f0
__device__ __forceinline__ float3 fresnel_schlick(float3 f0, float cos_theta) {
  const float w = pow5(1.0f - cos_theta);
  return f3(f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w, f0.z + (1.0f - f0.z) * w);
}

// ops/math.py fresnel_maxwell: 1 at total internal reflection.
__device__ __forceinline__ float fresnel_maxwell(float c1, float ior1, float ior2) {
  const float sin1 = sqrtf(clamp_min(1.0f - c1 * c1, 0.0f));
  const float sin2 = sin1 * ior1 / ior2;
  const float cos2 = sqrtf(clamp_min(1.0f - sin2 * sin2, 0.0f));
  const float r_para = (ior1 * cos2 - ior2 * c1) / (ior1 * cos2 + ior2 * c1);
  const float r_perp = (ior1 * c1 - ior2 * cos2) / (ior1 * c1 + ior2 * cos2);
  const float f = 0.5f * (r_para * r_para + r_perp * r_perp);
  return sin2 > 1.0f ? 1.0f : f;
}

// ops/math.py ndf_ggx, smith_g1, smith_g2 (callers pass roughness as a2)
__device__ __forceinline__ float ndf_ggx(float c, float a2) {
  float denom = c * c * (a2 - 1.0f) + 1.0f;
  denom = denom * denom * kPi;
  const float d = a2 / clamp_min(denom, F32(1e-38));
  return c < F32(1e-6) ? 0.0f : d;
}

__device__ __forceinline__ float smith_g1(float a2, float nov) {
  const float denom = sqrtf(clamp_min(nov * nov * (1.0f - a2) + a2, 0.0f)) + nov;
  return 2.0f * nov / (denom == 0.0f ? F32(1e-38) : denom);
}

__device__ __forceinline__ float smith_g2(float a2, float nov, float nol) {
  const float denom = nol * sqrtf(clamp_min(nov * nov * (1.0f - a2) + a2, 0.0f)) +
                      nov * sqrtf(clamp_min(nol * nol * (1.0f - a2) + a2, 0.0f));
  return 2.0f * nov * nol / (denom == 0.0f ? F32(1e-38) : denom);
}

// ops/math.py sample_normal_ggx: a visible GGX half-vector (Heitz 2018);
// wo points AWAY from the surface.
__device__ __forceinline__ float3 sample_normal_ggx(float3 n, float3 wo, float alpha, float r1,
                                                    float r2) {
  float3 t, b;
  onb_pixar(n, t, b);
  const float3 wol = f3(dot(wo, t), dot(wo, b), dot(wo, n));
  float3 wh = normalize(f3(wol.x * alpha, wol.y * alpha, wol.z));
  if (wh.z < 0.0f) wh = neg(wh);
  const float3 t1 = wh.z < F32(0.99999) ? normalize(cross(f3(0.0f, 0.0f, 1.0f), wh))
                                        : f3(1.0f, 0.0f, 0.0f);
  const float3 t2 = cross(wh, t1);
  // ops/math.py sample_uniform_disc
  const float rad = sqrtf(r1);
  const float th = kTwoPi * r2;
  const float px = rad * cosf(th), py0 = rad * sinf(th);
  const float h = sqrtf(clamp_min(1.0f - px * px, 0.0f));
  const float lerp_t = (1.0f + wh.z) * 0.5f;  // `/ 2.0`: times the reciprocal
  const float py = (1.0f - lerp_t) * h + lerp_t * py0;
  const float pz = sqrtf(clamp_min(1.0f - (px * px + py * py), 0.0f));
  const float3 nh = f3(px * t1.x + py * t2.x + pz * wh.x, px * t1.y + py * t2.y + pz * wh.y,
                       px * t1.z + py * t2.z + pz * wh.z);
  const float lx = nh.x * alpha, ly = nh.y * alpha, lz = clamp_min(nh.z, F32(1e-6));
  return normalize(f3(lx * t.x + ly * b.x + lz * n.x, lx * t.y + ly * b.y + lz * n.y,
                      lx * t.z + ly * b.z + lz * n.z));
}

// What ops/materials.py microfacet_bsdf / microfacet_pdf and metallic_bsdf
// / metallic_pdf share: a2, the cosines, the half vector's NDF.
struct Ggx {
  float cos_o, cos_i, d, f_cos;  // f_cos: dot(wo_out, wm), the Fresnel cosine
};

__device__ __forceinline__ Ggx ggx(float3 n, float3 wo_out, float3 wi, float rough) {
  const float a2 = rough * rough;
  Ggx g;
  g.cos_o = dot(n, wo_out);
  g.cos_i = dot(n, wi);
  const float3 wm = normalize(add(wo_out, wi));
  g.d = ndf_ggx(dot(wm, n), a2);
  g.f_cos = dot(wo_out, wm);
  return g;
}

// microfacet_bsdf (wo_out points AWAY from the surface)
__device__ __forceinline__ float3 microfacet_bsdf(const Ggx& g, float3 albedo, float rough) {
  const float g2 = smith_g2(rough, g.cos_o, g.cos_i);  // quirk: roughness, not alpha^2
  const float3 f = fresnel_schlick(albedo, g.f_cos);
  const float s = g.d * g2 / clamp_min(4.0f * g.cos_o * g.cos_i, F32(1e-8));
  if (g.cos_o * g.cos_i < F32(1e-7)) return f3(0.0f, 0.0f, 0.0f);
  return scale(f, s);
}

// microfacet_pdf
__device__ __forceinline__ float microfacet_pdf(const Ggx& g, float rough) {
  const float g1 = smith_g1(rough, g.cos_o);  // quirk: roughness, not alpha^2
  return g1 * g.d / clamp_min(4.0f * g.cos_o, F32(1e-8));
}

// metallic_bsdf
__device__ __forceinline__ float3 metallic_bsdf(const Ggx& g, float3 albedo, float rough,
                                                float metal) {
  const float g2 = smith_g2(rough, g.cos_o, g.cos_i);  // quirk: roughness as a2
  const float om = 1.0f - metal;
  const float3 f0 = f3(F32(0.08) * om + albedo.x * metal, F32(0.08) * om + albedo.y * metal,
                       F32(0.08) * om + albedo.z * metal);
  const float3 f = fresnel_schlick(f0, g.f_cos);
  const float3 diff = f3(om * albedo.x * kInvPi, om * albedo.y * kInvPi, om * albedo.z * kInvPi);
  const float spec = g.d * g2 / clamp_min(4.0f * g.cos_o * g.cos_i, F32(1e-8));
  if (g.cos_o * g.cos_i < F32(1e-7)) return f3(0.0f, 0.0f, 0.0f);
  return f3(diff.x * (1.0f - f.x) + spec * f.x, diff.y * (1.0f - f.y) + spec * f.y,
            diff.z * (1.0f - f.z) + spec * f.z);
}

// metallic_pdf: diffuse and specular mixed by 1 / (2 - metallic)
__device__ __forceinline__ float metallic_pdf(const Ggx& g, float rough, float metal) {
  const float g1 = smith_g1(rough, g.cos_o);  // quirk
  const float spec_pdf = g1 * g.d / clamp_min(4.0f * g.cos_o, F32(1e-8));
  const float diff_pdf = g.cos_i * kInvPi;
  const float w = 1.0f / (2.0f - metal);
  return diff_pdf * (1.0f - w) + spec_pdf * w;
}

// M1: ops/materials.py scatter_sample on the draw of utils/rng.py
// pixel_uniforms, each lane's own lobe: bsdf (N, 3), pdf (N,), dir (N, 3).
__global__ void __launch_bounds__(SHADE_THREADS)
scatter_lobes_kernel(Col<int> type, Col<float> albedo, Col<float> rough, Col<float> metal,
                     Col<float> ior, Col<float> emit, Col<float> nrm, Col<float> wo_col,
                     Draw draw, float* __restrict__ bsdf_out, float* __restrict__ pdf_out,
                     float* __restrict__ dir_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = type.at(i);
  float3 bsdf, d;
  float pdf;
  if (t == kLambertian || t == kDielectric || t == kMicrofacet || t == kMetallicWorkflow) {
    const float3 r = draw.at3(i, kStageScatter);
    const float3 nv = nrm.at3(i), wo = wo_col.at3(i), alb = albedo.at3(i);
    if (t == kLambertian) {
      bsdf = scale(alb, kInvPi);
      d = sample_hemisphere_cosine(nv, r.x, r.y);
      pdf = dot(d, nv) * kInvPi;
    } else if (t == kDielectric) {
      const float io = ior.at(i);
      const float wn = dot(wo, nv);
      const bool entering = wn < 0.0f;
      const float ior1 = entering ? 1.0f : io, ior2 = entering ? io : 1.0f;
      const float fres = fresnel_maxwell(fabsf(wn), ior1, ior2);
      const bool reflectp = r.z < fres;
      d = reflectp ? reflect_dir(nv, wo) : refract_dir(nv, wo, ior1, ior2);
      const float s = reflectp ? 1.0f : (ior2 * ior2) / (ior1 * ior1);
      const float c = clamp_min(fabsf(dot(d, nv)), F32(1e-38));
      bsdf = f3(alb.x * s / c, alb.y * s / c, alb.z * s / c);
      pdf = 1.0f;
    } else {
      const float ro = rough.at(i);
      const float3 wo_out = neg(wo);
      float3 b;
      float p;
      bool bad;
      if (t == kMicrofacet) {
        d = reflect(wo, sample_normal_ggx(nv, wo_out, ro, r.x, r.y));
        const Ggx g = ggx(nv, wo_out, d, ro);
        bad = g.cos_i * g.cos_o < 0.0f;
        b = microfacet_bsdf(g, alb, ro);
        p = microfacet_pdf(g, ro);
      } else {  // MetallicWorkflow: VNDF alpha = roughness^2, specular with 1 / (2 - metallic)
        const float me = metal.at(i);
        const float spec_prob = 1.0f / (2.0f - me);
        d = r.z < spec_prob ? reflect(wo, sample_normal_ggx(nv, wo_out, ro * ro, r.x, r.y))
                            : sample_hemisphere_cosine(nv, r.x, r.y);
        const Ggx g = ggx(nv, wo_out, d, ro);
        bad = (g.cos_o < 0.0f) || (g.cos_i < 0.0f);
        b = metallic_bsdf(g, alb, ro, me);
        p = metallic_pdf(g, ro, me);
      }
      bsdf = bad ? f3(0.0f, 0.0f, 0.0f) : b;
      pdf = bad ? 0.0f : p;
    }
  } else {  // Light: the constant albedo, pdf 1, no direction
    bsdf = emit.at3(i);
    pdf = 1.0f;
    d = f3(0.0f, 0.0f, 0.0f);
  }
  bsdf_out[3 * i] = bsdf.x, bsdf_out[3 * i + 1] = bsdf.y, bsdf_out[3 * i + 2] = bsdf.z;
  pdf_out[i] = pdf;
  dir_out[3 * i] = d.x, dir_out[3 * i + 1] = d.y, dir_out[3 * i + 2] = d.z;
}

// M2: ops/materials.py bsdf_eval and pdf_eval at wi, each lane's own lobe:
// bsdf (N, 3), pdf (N,); 0 for Dielectric, Light and any other type.
__global__ void __launch_bounds__(SHADE_THREADS)
eval_lobes_kernel(Col<int> type, Col<float> albedo, Col<float> rough, Col<float> metal,
                  Col<float> nrm, Col<float> wo_col, Col<float> wi_col,
                  float* __restrict__ bsdf_out, float* __restrict__ pdf_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = type.at(i);
  float3 bsdf = f3(0.0f, 0.0f, 0.0f);
  float pdf = 0.0f;
  if (t == kLambertian) {
    bsdf = scale(albedo.at3(i), kInvPi);
    pdf = dot(wi_col.at3(i), nrm.at3(i)) * kInvPi;
  } else if (t == kMicrofacet || t == kMetallicWorkflow) {
    const float3 nv = nrm.at3(i), alb = albedo.at3(i);
    const float ro = rough.at(i);
    const Ggx g = ggx(nv, neg(wo_col.at3(i)), wi_col.at3(i), ro);
    if (t == kMicrofacet) {
      bsdf = microfacet_bsdf(g, alb, ro);
      pdf = microfacet_pdf(g, ro);
    } else {
      const float me = metal.at(i);
      bsdf = metallic_bsdf(g, alb, ro, me);
      pdf = metallic_pdf(g, ro, me);
    }
  }
  bsdf_out[3 * i] = bsdf.x, bsdf_out[3 * i + 1] = bsdf.y, bsdf_out[3 * i + 2] = bsdf.z;
  pdf_out[i] = pdf;
}

// M1's draw alone, (N, 3): what the tests hold to utils/rng.py word for word.
__global__ void __launch_bounds__(SHADE_THREADS)
scatter_draw_kernel(Draw draw, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 r = draw.at3(i, kStageScatter);
  out[3 * i] = r.x, out[3 * i + 1] = r.y, out[3 * i + 2] = r.z;
}

inline dim3 shade_grid(int n) {
  return dim3((unsigned)((n + SHADE_THREADS - 1) / SHADE_THREADS));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().  Every input column
// comes with its stride in elements between lanes ((N, 3) columns: the row
// stride, the three floats of a row adjacent).  A counter field (iteration,
// depth) is a device pointer with a stride of 0 (one word) or 1 (per lane),
// or a null pointer and its immediate value.

extern "C" int pt_scatter_lobes(const int* type, int type_s, const float* albedo, int albedo_s,
                                const float* rough, int rough_s, const float* metal, int metal_s,
                                const float* ior, int ior_s, const float* emit, int emit_s,
                                const float* nrm, int nrm_s, const float* wo, int wo_s,
                                const int* lane, int lane_s, uint32_t pixel0, uint32_t k0,
                                uint32_t k1, const int* it, int it_s, uint32_t it_imm,
                                const int* dp, int dp_s, uint32_t dp_imm, float* bsdf_out,
                                float* pdf_out, float* dir_out, int n, void* stream) {
  if (n > 0)
    scatter_lobes_kernel<<<shade_grid(n), SHADE_THREADS, 0, (cudaStream_t)stream>>>(
        Col<int>{type, type_s}, Col<float>{albedo, albedo_s}, Col<float>{rough, rough_s},
        Col<float>{metal, metal_s}, Col<float>{ior, ior_s}, Col<float>{emit, emit_s},
        Col<float>{nrm, nrm_s}, Col<float>{wo, wo_s},
        make_draw(lane, lane_s, pixel0, k0, k1, it, it_s, it_imm, dp, dp_s, dp_imm), bsdf_out,
        pdf_out, dir_out, n);
  return (int)cudaGetLastError();
}

extern "C" int pt_eval_lobes(const int* type, int type_s, const float* albedo, int albedo_s,
                             const float* rough, int rough_s, const float* metal, int metal_s,
                             const float* nrm, int nrm_s, const float* wo, int wo_s,
                             const float* wi, int wi_s, float* bsdf_out, float* pdf_out, int n,
                             void* stream) {
  if (n > 0)
    eval_lobes_kernel<<<shade_grid(n), SHADE_THREADS, 0, (cudaStream_t)stream>>>(
        Col<int>{type, type_s}, Col<float>{albedo, albedo_s}, Col<float>{rough, rough_s},
        Col<float>{metal, metal_s}, Col<float>{nrm, nrm_s}, Col<float>{wo, wo_s},
        Col<float>{wi, wi_s}, bsdf_out, pdf_out, n);
  return (int)cudaGetLastError();
}

extern "C" int pt_scatter_draw(const int* lane, int lane_s, uint32_t pixel0, uint32_t k0,
                               uint32_t k1, const int* it, int it_s, uint32_t it_imm,
                               const int* dp, int dp_s, uint32_t dp_imm, float* out, int n,
                               void* stream) {
  if (n > 0)
    scatter_draw_kernel<<<shade_grid(n), SHADE_THREADS, 0, (cudaStream_t)stream>>>(
        make_draw(lane, lane_s, pixel0, k0, k1, it, it_s, it_imm, dp, dp_s, dp_imm), out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
