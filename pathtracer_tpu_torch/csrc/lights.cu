// The light side of next-event estimation for Hopper (sm_90a): L1, each
// lane's light sample (its STAGE_LIGHT random numbers, its pick among the
// scene's lights, then its own light's branch and the shadow ray toward it),
// and L2, each lane's light pdf at the hit of its BSDF-sampled ray (the MIS
// weight of the light-hit term).  One thread per lane.
//
// Replaces no TPU kernel.  The JAX package samples lights in plain jnp
// (pathtracer_tpu/ops/lights.py light_sample, light_pdf, and utils/rng.py
// pixel_uniforms), which XLA fuses.  The port's plain PyTorch version of the
// same code (ops/lights.py light_samples, light_pdf; utils/rng.py) runs on
// the card as one elementwise kernel per operation over (N,) columns, with
// one branch per sphere light in the sample and one per sphere geom in the
// pdf, every branch over every lane: on cornell_spheres about 520 of them a
// MIS lap for the sample and its draw and 240 for the pdf.  These kernels
// keep a lane's values in registers from its inputs to its outputs, and a
// lane runs only its own light's branch (a triangle, a sphere; a cube has
// none) or, in L2, its own hit's, so their cost does not grow with the
// number of lights or spheres.
//
// What bounds them on this card: bytes.  L1 reads a lane's view point (12
// bytes), lane id (4) and NEE mask (1), and writes the light point, emission,
// pdf, shadow-ray origin and direction and the shadow test's mask (53); L2
// reads the ray origin, hit point, normal, triangle and geom (44) and writes
// the pdf (4).  The scene's small tables (lights, geoms, materials, a
// triangle light's row) are read by many lanes and stay in cache.  At 640,000
// lanes: 45 MB and 31 MB, 13 us and 9 us at 3.35 TB/s.  A lane's operations
// (chip_smoke.py LIGHT_OPS) take at most about 10 us at one operation a lane
// a clock.
//
// Built with -fmad=false and without fast math, every operation in the
// order of the plain version (lane_math.cuh's conventions), so the results
// are its results bit for bit on the card.  The plain version evaluates
// every light's branch on every lane and selects; a lane's own branch gives
// the same bits, since every operation is elementwise.  The environment, a
// light of its own with `include_env`, is not sampled here: L1 writes the
// lane's four uniforms and ops/lights.py env_lights fills the environment's
// lanes after it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_math.cuh"

namespace {

constexpr int LIGHT_THREADS = 128;  // lanes per CTA
constexpr int kSphere = 0;          // scene/parser.py SPHERE

// The scene's tables that L1 and L2 read (scene/flatscene.py FlatScene).
struct Lights {
  const int* light_geom;  // (rows,) each light's geom
  const int* light_tri;   // (rows,) each light's triangle, -1 for an analytic geom
  int rows;               // max(L, 1)
  int num;                // L, the scene's lights (the environment not counted)
  float fl;               // L_eff as a float: the lights sampled (L, or L + 1 with the env)
  float inv_l;            // 1 / L_eff rounded to float32 (0 when L_eff is 0)
  const int* geom_type;   // (G,)
  const int* geom_mat;    // (G,)
  const bool* light_geoms;  // (G,) the geom's material is a LIGHT
  int num_geoms;          // G
  const float* mat;       // (8, M): albedo rows 0-2
  int mat_s;              // M
  const float* xf;        // (G, 4, 4) geom_transform
  const float* inv;       // (G, 4, 4) geom_inv
  const float* tri;       // (T, tri_s) tri_data: v0 v1 v2 n0 n1 n2 first
  int tri_s;
};

// ops/intersect.py xform_point: geom g's matrix m @ [p, 1].
__device__ __forceinline__ float3 xform_point(const float* __restrict__ m, int g, float3 p) {
  const float* r = m + 16 * (size_t)g;
  return f3(r[0] * p.x + r[1] * p.y + r[2] * p.z + r[3],
            r[4] * p.x + r[5] * p.y + r[6] * p.z + r[7],
            r[8] * p.x + r[9] * p.y + r[10] * p.z + r[11]);
}

__device__ __forceinline__ float3 row3(const float* __restrict__ r, int k) {
  return f3(r[3 * k], r[3 * k + 1], r[3 * k + 2]);
}

// A triangle's area: length(cross(v1 - v0, v2 - v0)) / 2.0.
__device__ __forceinline__ float tri_area(float3 v0, float3 v1, float3 v2) {
  const float3 c = cross(sub(v1, v0), sub(v2, v0));
  return sqrtf(clamp_min(dot(c, c), 0.0f)) * 0.5f;
}

// The solid-angle pdf of a point `lp` with normal `nl` on a triangle of
// area `area` seen from `vp`: inv_l * d^2 / (area * |cos|), two-sided.
__device__ __forceinline__ float tri_pdf(float inv_l, float3 vp, float3 lp, float3 nl,
                                         float area) {
  const float3 e = sub(lp, vp);
  const float d2 = dot(e, e);
  const float cos_l = fabsf(dot(normalize(sub(vp, lp)), nl));
  return inv_l * d2 / clamp_min(area * cos_l, F32(1e-38));
}

// cos(theta_max) of the cone that a sphere of radius 0.5 at the object
// origin subtends from object-space point `view_l`; d2 out, |view_l|^2.
__device__ __forceinline__ float cone_cos(float3 view_l, float& d2) {
  d2 = dot(view_l, view_l);
  const float sin_tm2 = (1.0f / clamp_min(d2, F32(1e-12))) * 0.25f;  // 0.25 / x
  return sqrtf(clamp_min(1.0f - sin_tm2, 0.0f));
}

// ops/lights.py _sphere_cone_sample toward geom g: the light point; pdf out.
__device__ __forceinline__ float3 sphere_cone_sample(const Lights& lt, int g, float3 vp,
                                                     float x0, float x1, float& pdf) {
  const float3 view_l = xform_point(lt.inv, g, vp);
  const float3 c2r = normalize(neg(view_l));
  float3 tan, bit;
  onb_pixar(c2r, tan, bit);
  float d2;
  const float cos_tm = cone_cos(view_l, d2);
  const float cos_t = (1.0f - x0) + x0 * cos_tm;
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float phi = x1 * kTwoPi;
  const float dc = sqrtf(clamp_min(d2, 0.0f));
  const float ds = dc * cos_t - sqrtf(clamp_min(0.25f - dc * dc * sin_t * sin_t, 0.0f));
  const float sin_a = ds * sin_t * 2.0f;  // `/ 0.5`: times the reciprocal
  const float cos_a = sqrtf(clamp_min(1.0f - sin_a * sin_a, 0.0f));
  const float a = sin_a * cosf(phi), b = sin_a * sinf(phi);
  const float3 nc = neg(c2r);
  const float3 n_obj = f3(a * tan.x + b * bit.x + cos_a * nc.x,
                          a * tan.y + b * bit.y + cos_a * nc.y,
                          a * tan.z + b * bit.z + cos_a * nc.z);
  pdf = 1.0f / (kTwoPi * (1.0f - cos_tm)) * lt.inv_l;
  return xform_point(lt.xf, g, scale(n_obj, 0.5f));
}

// L1: ops/lights.py light_samples on the draw of utils/rng.py pixel_uniforms
// (STAGE_LIGHT), each lane's own light: the light point, emission, pdf (0 for
// a cube light, -1 when the scene has no light), the shadow ray's origin and
// direction, and the mask of lanes whose shadow ray is traced (pdf > 0 and
// `enabled`, every lane without a mask); with `rands_out`, its four uniforms.
__global__ void __launch_bounds__(LIGHT_THREADS)
sample_lights_kernel(Col<float> view, Col<bool> enabled, Draw draw, Lights lt,
                     float* __restrict__ pos_out, float* __restrict__ emit_out,
                     float* __restrict__ pdf_out, float* __restrict__ org_out,
                     float* __restrict__ dir_out, bool* __restrict__ occ_out,
                     float* __restrict__ rands_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 vp = view.at3(i);
  const float4 r = draw.at4(i, kStageLight);
  float3 pos = f3(0.0f, 0.0f, 0.0f), emit = f3(0.0f, 0.0f, 0.0f);
  float pdf = -1.0f;
  if (lt.fl > 0.0f) {
    pdf = 0.0f;
    const int light_id = (int)nan_min(r.x * lt.fl, lt.fl - 1.0f);
    const bool is_env = light_id >= lt.num;
    const int lid = min(max(light_id, 0), lt.rows - 1);
    const int g = lt.light_geom[lid];
    const int tri_id = is_env ? -1 : lt.light_tri[lid];
    if (lt.light_geoms[g]) {
      const float* a = lt.mat + lt.geom_mat[g];
      emit = f3(a[0], a[lt.mat_s], a[2 * lt.mat_s]);
    }
    if (tri_id >= 0) {  // uniform-area sample
      const float t = sqrtf(r.y);
      const float u = 1.0f - t, v = t * (1.0f - r.z);
      const float* row = lt.tri + (size_t)tri_id * lt.tri_s;
      const float3 v0 = row3(row, 0), v1 = row3(row, 1), v2 = row3(row, 2);
      const float3 n0 = row3(row, 3), n1 = row3(row, 4), n2 = row3(row, 5);
      const float w = 1.0f - u - v;
      pos = f3(u * v0.x + v * v1.x + w * v2.x, u * v0.y + v * v1.y + w * v2.y,
               u * v0.z + v * v1.z + w * v2.z);
      const float3 nl = normalize(f3(u * n0.x + v * n1.x + w * n2.x,
                                     u * n0.y + v * n1.y + w * n2.y,
                                     u * n0.z + v * n1.z + w * n2.z));
      pdf = tri_pdf(lt.inv_l, vp, pos, nl, tri_area(v0, v1, v2));
    } else if (!is_env && lt.geom_type[g] == kSphere) {
      pos = sphere_cone_sample(lt, g, vp, r.y, r.z, pdf);
    }
  }
  const float3 d = normalize(sub(pos, vp));
  const float eps = F32(1e-5);
  pos_out[3 * i] = pos.x, pos_out[3 * i + 1] = pos.y, pos_out[3 * i + 2] = pos.z;
  emit_out[3 * i] = emit.x, emit_out[3 * i + 1] = emit.y, emit_out[3 * i + 2] = emit.z;
  pdf_out[i] = pdf;
  org_out[3 * i] = vp.x + eps * d.x, org_out[3 * i + 1] = vp.y + eps * d.y,
  org_out[3 * i + 2] = vp.z + eps * d.z;
  dir_out[3 * i] = d.x, dir_out[3 * i + 1] = d.y, dir_out[3 * i + 2] = d.z;
  occ_out[i] = pdf > 0.0f && (enabled.p == nullptr || enabled.at(i));
  if (rands_out) {
    rands_out[4 * i] = r.x, rands_out[4 * i + 1] = r.y, rands_out[4 * i + 2] = r.z,
    rands_out[4 * i + 3] = r.w;
  }
}

// L2: ops/lights.py light_pdf, each lane's own hit: the cone pdf of a
// sphere geom (any sphere, lit or not, as the reference), the area pdf of a
// triangle, else -1.
__global__ void __launch_bounds__(LIGHT_THREADS)
light_pdf_kernel(Col<float> view, Col<float> lpos, Col<float> nrm, Col<int> tri, Col<int> geom,
                 Lights lt, float* __restrict__ pdf_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float pdf = -1.0f;
  if (lt.fl > 0.0f) {
    const int g = geom.at(i);
    const int t = tri.at(i);
    if (g >= 0 && g < lt.num_geoms && lt.geom_type[g] == kSphere) {
      float d2;
      const float cos_tm = cone_cos(xform_point(lt.inv, g, view.at3(i)), d2);
      pdf = 1.0f / (kTwoPi * (1.0f - cos_tm)) * lt.inv_l;
    } else if (t >= 0) {
      const float* row = lt.tri + (size_t)t * lt.tri_s;
      pdf = tri_pdf(lt.inv_l, view.at3(i), lpos.at3(i), nrm.at3(i),
                    tri_area(row3(row, 0), row3(row, 1), row3(row, 2)));
    }
  }
  pdf_out[i] = pdf;
}

inline dim3 light_grid(int n) {
  return dim3((unsigned)((n + LIGHT_THREADS - 1) / LIGHT_THREADS));
}

inline Lights make_lights(const int* light_geom, const int* light_tri, int rows, int num, float fl,
                          float inv_l, const int* geom_type, const int* geom_mat,
                          const bool* light_geoms, int num_geoms, const float* mat, int mat_s,
                          const float* xf, const float* inv, const float* tri, int tri_s) {
  return Lights{light_geom, light_tri, rows, num, fl, inv_l, geom_type, geom_mat, light_geoms,
                num_geoms, mat, mat_s, xf, inv, tri, tri_s};
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().  Every input column
// comes with its stride in elements between lanes ((N, 3) columns: the row
// stride, the three floats of a row adjacent).  A counter field (iteration,
// depth) is a device pointer with a stride of 0 (one word) or 1 (per lane),
// or a null pointer and its immediate value.  The scene's tables follow the
// columns, in the order of `Lights`.

#define LIGHT_TABLE_PARAMS                                                                  \
  const int *light_geom, const int *light_tri, int rows, int num, float fl, float inv_l,    \
      const int *geom_type, const int *geom_mat, const bool *light_geoms, int num_geoms,    \
      const float *mat, int mat_s, const float *xf, const float *inv, const float *tri_rows, \
      int tri_s
#define LIGHT_TABLE_ARGS                                                                    \
  make_lights(light_geom, light_tri, rows, num, fl, inv_l, geom_type, geom_mat, light_geoms, \
              num_geoms, mat, mat_s, xf, inv, tri_rows, tri_s)

extern "C" int pt_sample_lights(const float* view, int view_s, const bool* enabled,
                                int enabled_s, const int* lane, int lane_s, uint32_t pixel0,
                                uint32_t k0, uint32_t k1, const int* it, int it_s, uint32_t it_imm,
                                const int* dp, int dp_s, uint32_t dp_imm, LIGHT_TABLE_PARAMS,
                                float* pos_out, float* emit_out, float* pdf_out, float* org_out,
                                float* dir_out, bool* occ_out, float* rands_out, int n,
                                void* stream) {
  if (n > 0)
    sample_lights_kernel<<<light_grid(n), LIGHT_THREADS, 0, (cudaStream_t)stream>>>(
        Col<float>{view, view_s}, Col<bool>{enabled, enabled_s},
        make_draw(lane, lane_s, pixel0, k0, k1, it, it_s, it_imm, dp, dp_s, dp_imm),
        LIGHT_TABLE_ARGS, pos_out, emit_out, pdf_out, org_out, dir_out, occ_out, rands_out, n);
  return (int)cudaGetLastError();
}

extern "C" int pt_light_pdf(const float* view, int view_s, const float* lpos, int lpos_s,
                            const float* nrm, int nrm_s, const int* tri_id, int tri_id_s,
                            const int* geom_id, int geom_id_s, LIGHT_TABLE_PARAMS,
                            float* pdf_out, int n, void* stream) {
  if (n > 0)
    light_pdf_kernel<<<light_grid(n), LIGHT_THREADS, 0, (cudaStream_t)stream>>>(
        Col<float>{view, view_s}, Col<float>{lpos, lpos_s}, Col<float>{nrm, nrm_s},
        Col<int>{tri_id, tri_id_s}, Col<int>{geom_id, geom_id_s}, LIGHT_TABLE_ARGS, pdf_out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
