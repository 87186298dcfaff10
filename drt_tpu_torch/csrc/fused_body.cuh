// Shared device code of the fused kernels: the scene tables in shared
// memory, the keyed hash, and the bounce loop of one ray slot over one
// spp chunk (trace_chunk) with a per-bounce residual hook.
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

#include <cuda_runtime.h>
#include <stdint.h>

#define DRT_MAX_SHAPES 64
#define DRT_MAX_ROWS 64
#define DRT_REC 32
#define DRT_BLOCK 128

// Shape record layout (floats), written by scene_table() in
// drt_tpu_torch/ops/megakernel.py.
enum {
  R_TYPE = 0, R_MAT = 1, R_ALB = 2, R_EMI = 3, R_GEO = 4,
  R_E1 = 16, R_E2 = 19, R_TRI_N = 22, R_R2 = 25, R_EXPO = 26,
  R_INV_E2 = 27, R_POW_MODE = 28
};
enum { PLANE = 0, SPHERE = 1, TRIANGLE = 2 };
enum { DIFFUSE = 0, SPECULAR = 1, MIRROR = 2 };
enum { POW_NONINT = 0, POW_EVEN = 1, POW_ODD = 2 };

struct DrtCamera {
  float eye[3], fwd[3], right[3], up[3];
  float aspect_half, half;
};

struct DrtTrace {
  int width, height, n_rays, spp_c, n_chunks, max_depth, min_bounces;
  int n_shapes, n_alb, n_emi, internal_rng, fast;
  float absorb, inv_keep;
  uint32_t seed0, seed1;
};

static __device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// drt_tpu/ops/regen.py:_hash_bits + _bits_to_open_unit.
static __device__ __forceinline__ float hash_uniform(
    uint32_t seed, uint32_t pix, uint32_t s, uint32_t b, uint32_t dim) {
  uint32_t h = fmix(pix * 0x9E3779B9u + seed);
  h = fmix(h ^ (s * 0x85EBCA6Bu) ^ (b * 0xC2B2AE35u) ^ (dim * 0x27D4EB2Fu));
  int i23 = (int)(h >> 9);
  return ((float)i23 + 0.5f) * (1.0f / 8388608.0f);
}

// max(x, 0) that keeps NaN, as jnp.maximum and torch.clamp do (fmaxf
// would turn NaN into 0).
static __device__ __forceinline__ float max0(float x) {
  return x < 0.0f ? 0.0f : x;
}

template <bool FAST>
static __device__ __forceinline__ float inv_sqrt(float x) {
  return FAST ? rsqrtf(x) : 1.0f / sqrtf(x);
}

static __device__ __forceinline__ float dot3(float ax, float ay, float az,
                                             float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

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
  const int N = cfg.n_rays;
  const int npix = cfg.width * cfg.height;
  const int pix = i % npix;
  const int py = pix / cfg.width;
  const int px = pix - py * cfg.width;
  const float PI_F = 3.14159265358979323846f;
  const float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
  const float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;

  const uint32_t smp = (uint32_t)(c * cfg.spp_c + i / npix);
  float us, ut;
  if (INTERNAL) {
    us = hash_uniform(cfg.seed0, (uint32_t)pix, smp, 0u, 0u);
    ut = hash_uniform(cfg.seed0, (uint32_t)pix, smp, 0u, 1u);
  } else {
    us = cam_u[i];
    ut = cam_u[N + i];
  }
  // Camera ray (megakernel.py:_camera_ray_from_pix; camera.hpp:51-60).
  float s = ((float)px + us) / (float)cfg.width;
  float t = ((float)py + ut) / (float)cfg.height;
  float a = (2.0f * s - 1.0f) * cam.aspect_half;
  float b = (2.0f * t - 1.0f) * cam.half;
  float dx = (cam.fwd[0] + a * cam.right[0]) + b * (-cam.up[0]);
  float dy = (cam.fwd[1] + a * cam.right[1]) + b * (-cam.up[1]);
  float dz = (cam.fwd[2] + a * cam.right[2]) + b * (-cam.up[2]);
  {
    float inv = inv_sqrt<FAST>(dx * dx + dy * dy + dz * dz);
    dx = dx * inv; dy = dy * inv; dz = dz * inv;
  }
  float ox = cam.eye[0], oy = cam.eye[1], oz = cam.eye[2];
  float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
  lx = 0.0f; ly = 0.0f; lz = 0.0f;
  bool alive = true;

  for (int bnc = 0; bnc < cfg.max_depth; ++bnc) {
    float u_rr, u1, u2;
    if (INTERNAL) {
      u_rr = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 0u);
      u1 = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 1u);
      u2 = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 2u);
    } else {
      const float* ub = tape + (size_t)bnc * 3 * N;
      u_rr = ub[i];
      u1 = ub[N + i];
      u2 = ub[2 * N + i];
    }
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

    // Shade (megakernel.py:_shade): sample dir_out and sc = s*cos/pdf.
    const float dinx = -dx, diny = -dy, dinz = -dz;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f, sc = 0.0f;
    const int mt = alive ? (int)r[R_MAT] : -1;
    if (mt == DIFFUSE || mt == SPECULAR) {
      // Frame about the raw normal (bxdf.hpp:29-41).
      const bool use_e1 = fabsf(nx) < fabsf(ny);
      const float tvx = use_e1 ? 1.0f - nx * nx : -nx * ny;
      const float tvy = use_e1 ? -ny * nx : 1.0f - ny * ny;
      const float tvz = use_e1 ? -nz * nx : -nz * ny;
      const float tinv = inv_sqrt<FAST>(dot3(tvx, tvy, tvz, tvx, tvy, tvz));
      const float tx = tvx * tinv, ty = tvy * tinv, tz = tvz * tinv;
      float bx = ny * tz - nz * ty;
      float by = nz * tx - nx * tz;
      float bz = nx * ty - ny * tx;
      const float binv = inv_sqrt<FAST>(dot3(bx, by, bz, bx, by, bz));
      bx = bx * binv; by = by * binv; bz = bz * binv;
      const float cos_phi = cosf(TWO_PI_F * u2);
      const float sin_phi = sinf(TWO_PI_F * u2);
      if (mt == DIFFUSE) {
        // theta = asin(sqrt(u1)): cos = sqrt(1-u1), sin = sqrt(u1).
        const float cos_t = sqrtf(max0(1.0f - u1));
        const float sin_t = sqrtf(u1);
        const float fx = cos_phi * sin_t, fy = sin_phi * sin_t;
        wx = (tx * fx + bx * fy) + nx * cos_t;
        wy = (ty * fx + by * fy) + ny * cos_t;
        wz = (tz * fx + bz * fy) + nz * cos_t;
        const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
        if (FAST) {
          sc = u1 < 1.0f ? cos_geom * rsqrtf(1.0f - u1) : 0.0f;
        } else {
          const float pdf = cos_t / PI_F;
          sc = pdf > 0.0f ? INV_PI_F * cos_geom / pdf : 0.0f;
        }
      } else {
        // Half-vector sampling (bxdf.hpp:106-120): cos_h = u1^(1/(e+2)).
        const float e = r[R_EXPO];
        const float cos_h = powf(u1, r[R_INV_E2]);
        const float sin_h = sqrtf(max0(1.0f - cos_h * cos_h));
        const float fx = cos_phi * sin_h, fy = sin_phi * sin_h;
        float hx = (tx * fx + bx * fy) + nx * cos_h;
        float hy = (ty * fx + by * fy) + ny * cos_h;
        float hz = (tz * fx + bz * fy) + nz * cos_h;
        if (dot3(hx, hy, hz, dinx, diny, dinz) < 0.0f) {
          const float k = 2.0f * dot3(nx, ny, nz, hx, hy, hz);
          hx = -hx + k * nx; hy = -hy + k * ny; hz = -hz + k * nz;
        }
        const float k = 2.0f * dot3(hx, hy, hz, dinx, diny, dinz);
        wx = -dinx + k * hx; wy = -diny + k * hy; wz = -dinz + k * hz;
        // eval (bxdf.hpp:93-104) with the halfway vector recomputed
        // from dir_in and dir_out.
        float hwx = dinx + wx, hwy = diny + wy, hwz = dinz + wz;
        const float hw2 = dot3(hwx, hwy, hwz, hwx, hwy, hwz);
        const float hinv = inv_sqrt<FAST>(hw2);
        hwx = hwx * hinv; hwy = hwy * hinv; hwz = hwz * hinv;
        const float cos_he = dot3(nx, ny, nz, hwx, hwy, hwz);
        const float sin_he = sqrtf(max0(1.0f - cos_he * cos_he));
        // C++ pow for a negative base (ops/bxdf.py:_pow_cpp).
        const float mag = powf(fabsf(cos_he), e);
        const int mode = (int)r[R_POW_MODE];
        float powv;
        if (mode == POW_NONINT)
          powv = cos_he < 0.0f ? __int_as_float(0x7fffffff) : mag;
        else if (mode == POW_ODD)
          powv = mag * (cos_he < 0.0f ? -1.0f : 1.0f);
        else
          powv = mag;
        const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
        if (FAST) {
          const float denom = powf(cos_h, e + 1.0f) * sin_h;
          sc = (denom > 0.0f && hw2 > 0.0f)
                   ? powv * sin_he * cos_geom / denom : 0.0f;
        } else {
          const float norm = (e + 2.0f) / TWO_PI_F;
          const float pdf = norm * powf(cos_h, e + 1.0f) * sin_h;
          float s_val = norm * powv * sin_he;
          s_val = hw2 > 0.0f ? s_val : 0.0f;
          sc = pdf > 0.0f ? s_val * cos_geom / pdf : 0.0f;
        }
      }
    } else if (mt == MIRROR) {
      const float k = 2.0f * dot3(nx, ny, nz, dinx, diny, dinz);
      wx = -dinx + k * nx; wy = -diny + k * ny; wz = -dinz + k * nz;
      const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
      if (FAST)
        sc = cos_geom != 0.0f ? 1.0f : 0.0f;
      else
        sc = cos_geom != 0.0f ? (1.0f / cos_geom) * cos_geom : 0.0f;
    }
    // NULL_BXDF and dead lanes keep dir_out = 0, sc = 0.

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
