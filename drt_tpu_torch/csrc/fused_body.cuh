// Shared device code of the fused (scene-table) kernels: the scene tables
// in shared memory and the bounce loop of one ray slot over one spp chunk
// (trace_chunk) with a per-bounce residual hook, over the camera, hash and
// shading routines of drt_common.cuh.
//
// The forward tracer, the collect tracer (fused_tracer.cu) and the
// retrace adjoint (fused_adjoint.cu) all run this one body, so their
// radiance and residuals are the same f32 values bit for bit: the library
// is built with -fmad=false, so no a*b+c is contracted differently from
// one instantiation to the next. The hook sees, per bounce, what the
// adjoint of drt_tpu/ops/megakernel.py:_wavefront_body sees at :551-552:
// P before the albedo multiply, sc after the dead-lane zeroing, the gate,
// and best = hit shape + 1 (0 for a dead lane).

#pragma once

#include "drt_common.cuh"

#define DRT_MAX_SHAPES 64
#define DRT_MAX_ROWS 64
#define DRT_REC 32

// Shape record layout (floats), written by scene_table() in
// drt_tpu_torch/ops/megakernel.py.
enum {
  R_TYPE = 0, R_MAT = 1, R_ALB = 2, R_EMI = 3, R_GEO = 4,
  R_E1 = 16, R_E2 = 19, R_TRI_N = 22, R_R2 = 25, R_EXPO = 26,
  R_INV_E2 = 27, R_POW_MODE = 28
};

// The block's copy of the scene, albedo and emission tables.
struct DrtTables {
  float scene[DRT_MAX_SHAPES * DRT_REC];
  float alb[DRT_MAX_ROWS * 3];
  float emi[DRT_MAX_ROWS * 3];
};

// Every thread of the block calls this (it ends in a barrier).
static __device__ __forceinline__ void stage_tables(
    const DrtTrace& cfg, const float* __restrict__ scene,
    const float* __restrict__ alb, const float* __restrict__ emi,
    DrtTables& t) {
  for (int k = threadIdx.x; k < cfg.n_shapes * DRT_REC; k += blockDim.x)
    t.scene[k] = scene[k];
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    t.alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    t.emi[k] = emi[k];
  __syncthreads();
}

// The specular exponent of a shape record and what the table precomputes
// from it (drt_common.cuh:shade).
struct TableSpecular {
  const float* r;
  __device__ __forceinline__ float expo() const { return r[R_EXPO]; }
  __device__ __forceinline__ float inv_e2() const { return r[R_INV_E2]; }
  __device__ __forceinline__ int pow_mode() const {
    return (int)r[R_POW_MODE];
  }
};

// The hook of the forward tracer: keeps nothing.
struct NoResidual {
  __device__ __forceinline__ void operator()(int, float, float, float,
                                             float, float, int) const {}
};

// Radiance (lx, ly, lz) of ray slot i in spp chunk c, all max_depth
// bounces. hook(b, Px, Py, Pz, sc, gate, best) is called once per bounce.
template <bool FAST, bool INTERNAL, class Hook>
static __device__ __forceinline__ void trace_chunk(
    const DrtTrace& cfg, const DrtCamera& cam, const DrtTables& tab,
    const float* __restrict__ cam_u, const float* __restrict__ tape,
    int i, int c, Hook& hook, float& lx, float& ly, float& lz) {
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;

  int pix;
  uint32_t smp;
  float dx, dy, dz;
  primary_ray<FAST, INTERNAL>(cfg, cam, cam_u, i, c, pix, smp, dx, dy, dz);
  float ox = cam.eye[0], oy = cam.eye[1], oz = cam.eye[2];
  float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
  lx = 0.0f; ly = 0.0f; lz = 0.0f;
  bool alive = true;

  for (int bnc = 0; bnc < cfg.max_depth; ++bnc) {
    float u_rr, u1, u2;
    bounce_uniforms<INTERNAL>(cfg, tape, i, pix, smp, bnc, u_rr, u1, u2);
    float rr_scale = 1.0f;
    if (bnc >= cfg.min_bounces) {
      alive = alive && !(u_rr < cfg.absorb);
      rr_scale = cfg.inv_keep;
    }

    // Nearest hit (megakernel.py:_intersect_static; strict < keeps the
    // first of tied shapes, pathtracer.hpp:79).
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best_i = 0;
    for (int k = 0; k < cfg.n_shapes; ++k) {
      const float* r = s_scene + k * DRT_REC;
      const int st = (int)r[R_TYPE];
      const float* g = r + R_GEO;
      float tk;
      bool valid;
      if (st == PLANE) {
        float h = (ox * g[0] + oy * g[1]) + oz * g[2];
        h = h - g[3];
        float denom = (dx * (-g[0]) + dy * (-g[1])) + dz * (-g[2]);
        tk = h / denom;
        valid = tk > 0.0f;
      } else if (st == SPHERE) {
        float ocx = ox - g[0], ocy = oy - g[1], ocz = oz - g[2];
        float b2 = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
        float cc = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r[R_R2];
        float disc = b2 * b2 - 4.0f * cc;
        float sq = sqrtf(max0(disc));
        float t1 = (-b2 - sq) / 2.0f;
        float t2 = (-b2 + sq) / 2.0f;
        tk = t1 > 0.0f ? t1 : t2;
        valid = (disc >= 0.0f) && (tk > 0.0f);
      } else {  // TRIANGLE (Moller-Trumbore)
        const float* e1 = r + R_E1;
        const float* e2 = r + R_E2;
        float pxv = dy * e2[2] - dz * e2[1];
        float pyv = dz * e2[0] - dx * e2[2];
        float pzv = dx * e2[1] - dy * e2[0];
        float det = (pxv * e1[0] + pyv * e1[1]) + pzv * e1[2];
        float tvx = ox - g[0], tvy = oy - g[1], tvz = oz - g[2];
        float u_raw = dot3(tvx, tvy, tvz, pxv, pyv, pzv);
        float qx = tvy * e1[2] - tvz * e1[1];
        float qy = tvz * e1[0] - tvx * e1[2];
        float qz = tvx * e1[1] - tvy * e1[0];
        float v_raw = dot3(dx, dy, dz, qx, qy, qz);
        float t_raw = (qx * e2[0] + qy * e2[1]) + qz * e2[2];
        float inv = 1.0f / det;
        float uu = u_raw * inv;
        float vv = v_raw * inv;
        tk = t_raw * inv;
        valid = (fabsf(det) > 1e-9f) && (uu >= 0.0f) && (vv >= 0.0f) &&
                (uu + vv <= 1.0f) && (tk > 0.0f);
      }
      if (valid && tk < best_t) {
        best_t = tk;
        best_i = k;
      }
    }
    alive = alive && isfinite(best_t);
    const float gate = alive ? rr_scale : 0.0f;
    // Bounce 0 multiplies by a literal 1 in the TPU kernel; x * 1 == x.
    const float Px = Tx * gate, Py = Ty * gate, Pz = Tz * gate;

    const float* r = s_scene + best_i * DRT_REC;
    // Emission (sentinel row and dead lanes read 0).
    float ex = 0.0f, ey = 0.0f, ez = 0.0f;
    const int erow = (int)r[R_EMI];
    if (alive && erow < cfg.n_emi - 1) {
      ex = s_emi[erow * 3 + 0];
      ey = s_emi[erow * 3 + 1];
      ez = s_emi[erow * 3 + 2];
    }
    lx = lx + Px * ex;
    ly = ly + Py * ey;
    lz = lz + Pz * ez;

    float pxh = 0.0f, pyh = 0.0f, pzh = 0.0f;
    if (alive) {
      pxh = ox + dx * best_t;
      pyh = oy + dy * best_t;
      pzh = oz + dz * best_t;
    }
    // Hit normal: raw plane normal, normalize(p - c), precomputed
    // triangle normal; 0 for dead lanes.
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    const int st = (int)r[R_TYPE];
    if (alive) {
      const float* g = r + R_GEO;
      if (st == PLANE) {
        nx = g[0]; ny = g[1]; nz = g[2];
      } else if (st == SPHERE) {
        float sx = pxh - g[0], sy = pyh - g[1], sz = pzh - g[2];
        float inv = inv_sqrt<FAST>(dot3(sx, sy, sz, sx, sy, sz));
        nx = sx * inv; ny = sy * inv; nz = sz * inv;
      } else {
        nx = r[R_TRI_N]; ny = r[R_TRI_N + 1]; nz = r[R_TRI_N + 2];
      }
    }

    // Sample dir_out and sc = s*cos/pdf; NULL_BXDF and dead lanes keep
    // dir_out = 0, sc = 0.
    float wx, wy, wz, sc;
    shade<FAST>(alive ? (int)r[R_MAT] : -1, TableSpecular{r}, nx, ny, nz,
                -dx, -dy, -dz, u1, u2, wx, wy, wz, sc);

    hook(bnc, Px, Py, Pz, sc, gate, alive ? best_i + 1 : 0);

    // Albedo (sentinel row and dead lanes read 1).
    float ax = 1.0f, ay = 1.0f, az = 1.0f;
    const int arow = (int)r[R_ALB];
    if (alive && arow < cfg.n_alb - 1) {
      ax = s_alb[arow * 3 + 0];
      ay = s_alb[arow * 3 + 1];
      az = s_alb[arow * 3 + 2];
    }
    Tx = Px * ax * sc;
    Ty = Py * ay * sc;
    Tz = Pz * az * sc;
    if (alive) {
      ox = pxh + wx * RAY_EPS_F;
      oy = pyh + wy * RAY_EPS_F;
      oz = pzh + wz * RAY_EPS_F;
      dx = wx; dy = wy; dz = wz;
    } else {
      ox = oy = oz = 0.0f;
      dx = dy = dz = 0.0f;
    }
  }
}

static inline bool drt_cfg_ok(const DrtTrace* cfg) {
  return cfg->n_shapes >= 1 && cfg->n_shapes <= DRT_MAX_SHAPES &&
         cfg->n_alb >= 1 && cfg->n_alb <= DRT_MAX_ROWS &&
         cfg->n_emi >= 1 && cfg->n_emi <= DRT_MAX_ROWS && cfg->n_rays > 0;
}
