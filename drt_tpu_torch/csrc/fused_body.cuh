// Shared device code of the fused (scene-table) kernels: the scene tables
// in shared memory and the bounce loop of one ray slot over one spp chunk
// (trace_chunk) with a per-bounce residual hook, over the camera, hash and
// shading routines of drt_common.cuh. The bounce itself is the text of
// fused_bounce.inc, which fused_bounce also wraps for the regeneration
// tracer (regen_tracer.cu).
//
// The forward tracer, the collect tracer, the wavefront tracer
// (fused_tracer.cu), the retrace and the wavefront adjoint
// (fused_adjoint.cu) all run this one body, so their
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

// DRT_MARK(k) in fused_bounce.inc ends section k (drt_common.cuh). It is
// nothing, except around the includes of the loops that take a marks
// object (trace_chunk, fused_bounce, the queue of fused_tracer.cu), where
// it is `marks.at(k, bnc, alive)`: nothing again with NoMarks, so every
// kernel but a checking build compiles the bounce as it always did.
#define DRT_MARK(k)

// Radiance (lx, ly, lz) of ray slot i in spp chunk c, all max_depth
// bounces. hook(b, Px, Py, Pz, sc, gate, best) is called once per bounce.
// `marks` is NoMarks, or the SectionClock of a checking build, which times
// each section of a bounce and counts the bounces.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, class Hook, class Marks>
static __device__ __forceinline__ void trace_chunk(
    const DrtTrace& cfg, const DrtCamera& cam, const DrtTables& tab,
    const float* __restrict__ cam_u, const float* __restrict__ tape,
    int i, int c, Hook& hook, float& lx, float& ly, float& lz,
    Marks& marks) {
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
  marks.at(SEC_CAMERA, 0, alive);

  for (int bnc = 0; bnc < cfg.max_depth; ++bnc) {
#include "fused_bounce.inc"
    marks.step(true, alive);
    marks.at(SEC_LOOP, bnc, alive);
  }
}
#undef DRT_MARK
#define DRT_MARK(k)

// trace_chunk in a kernel that counts and times nothing.
template <bool FAST, bool INTERNAL, class Hook>
static __device__ __forceinline__ void trace_chunk(
    const DrtTrace& cfg, const DrtCamera& cam, const DrtTables& tab,
    const float* __restrict__ cam_u, const float* __restrict__ tape,
    int i, int c, Hook& hook, float& lx, float& ly, float& lz) {
  NoMarks marks;
  trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook, lx,
                              ly, lz, marks);
}

// Radiance (lx, ly, lz) of ray i of a wavefront whose primary rays are
// inputs: origin o and direction d (f32[3, n_rays] each) and the tape
// (f32[D, 3, n_rays], ray index fastest), all max_depth bounces. The loop
// of trace_chunk with the ray read from (o, d) where trace_chunk calls
// primary_ray; the exact variant, tape mode: bounce_uniforms<false> reads
// slot i of the tape.
template <class Hook>
static __device__ __forceinline__ void trace_ray(
    const DrtTrace& cfg, const DrtTables& tab, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tape, int i,
    Hook& hook, float& lx, float& ly, float& lz) {
  constexpr bool FAST = false, INTERNAL = false;
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;

  const int n = cfg.n_rays;
  const int pix = i;  // read only by the keyed draws, which tape mode skips
  const uint32_t smp = 0u;
  float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
  float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
  float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
  lx = 0.0f; ly = 0.0f; lz = 0.0f;
  bool alive = true;

  for (int bnc = 0; bnc < cfg.max_depth; ++bnc) {
#include "fused_bounce.inc"
  }
}

// The tape of a segment [b0, b1): f32[b1 - b0, 3, n_rays], row bnc - b0 at
// bounce bnc. Inside trace_segment the bounce text's bounce_uniforms call
// resolves to the overload below by the type of `tape`.
struct SegmentTape {
  const float* p;
  int b0;
};

template <bool INTERNAL>
static __device__ __forceinline__ void bounce_uniforms(
    const DrtTrace& cfg, const SegmentTape& tape, int i, int pix,
    uint32_t smp, int bnc, float& u_rr, float& u1, float& u2) {
  const float* rows =
      INTERNAL ? nullptr : tape.p + (size_t)(bnc - tape.b0) * 3 * cfg.n_rays;
  bounce_uniforms<INTERNAL>(cfg, rows, i, pix, smp, INTERNAL ? bnc : 0,
                            u_rr, u1, u2);
}

// Bounces [tape.b0, b1) of lane i of one chunk c: the segment forms of
// trace_chunk (megakernel.py:_wavefront_body(b_start, b_end, T, alive,
// full_output=True)). At b0 == 0 the lane is ray slot i and starts from
// the camera as in trace_chunk; past it the lane reads its state from ray
// f32[9, n_rays] (o, d, T rows) and alive i32[n_rays], and with the
// internal RNG its ray slot from ray_idx. Russian roulette and the keyed
// draws take the absolute bounce, the tape and the hook's residual row the
// segment's own. p holds the segment's radiance and the exit state.
template <bool FAST, bool INTERNAL, class Hook>
static __device__ __forceinline__ void trace_segment(
    const DrtTrace& cfg, const DrtCamera& cam, const DrtTables& tab,
    const float* __restrict__ cam_u, const SegmentTape& tape,
    const float* __restrict__ ray, const int* __restrict__ alive_in,
    const int* __restrict__ ray_idx, int b1, int i, int c, Hook& hook,
    PathState& p) {
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;
  float &ox = p.ox, &oy = p.oy, &oz = p.oz;
  float &dx = p.dx, &dy = p.dy, &dz = p.dz;
  float &Tx = p.Tx, &Ty = p.Ty, &Tz = p.Tz;
  float &lx = p.lx, &ly = p.ly, &lz = p.lz;
  bool& alive = p.alive;

  int pix = 0;
  uint32_t smp = 0u;
  if (tape.b0 == 0) {
    primary_ray<FAST, INTERNAL>(cfg, cam, cam_u, i, c, pix, smp, dx, dy,
                                dz);
    ox = cam.eye[0]; oy = cam.eye[1]; oz = cam.eye[2];
    Tx = 1.0f; Ty = 1.0f; Tz = 1.0f;
    alive = true;
  } else {
    const size_t n = (size_t)cfg.n_rays;
    ox = ray[i]; oy = ray[n + i]; oz = ray[2 * n + i];
    dx = ray[3 * n + i]; dy = ray[4 * n + i]; dz = ray[5 * n + i];
    Tx = ray[6 * n + i]; Ty = ray[7 * n + i]; Tz = ray[8 * n + i];
    alive = alive_in[i] > 0;
    if (INTERNAL) {
      const int npix = cfg.width * cfg.height;
      const int r = ray_idx[i];
      pix = r % npix;
      smp = (uint32_t)(c * cfg.spp_c + r / npix);
    }
  }
  lx = 0.0f; ly = 0.0f; lz = 0.0f;

  for (int bnc = tape.b0; bnc < b1; ++bnc) {
#include "fused_bounce.inc"
  }
}

// fused_bounce.inc as a routine on a PathState, with the keyed hash: one
// bounce of sample smp of pixel pix at depth bnc. The regeneration kernels
// (regen_tracer.cu) call it at each thread's own depth, with NoMarks, or
// with the SectionClock of their timing build.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, class Hook, class Marks>
static __device__ __forceinline__ void fused_bounce(
    const DrtTrace& cfg, const DrtTables& tab, int pix, uint32_t smp,
    int bnc, Hook& hook, PathState& p, Marks& marks) {
  constexpr bool INTERNAL = true;
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;
  const float* tape = nullptr;
  const int i = pix;
  float &ox = p.ox, &oy = p.oy, &oz = p.oz;
  float &dx = p.dx, &dy = p.dy, &dz = p.dz;
  float &Tx = p.Tx, &Ty = p.Ty, &Tz = p.Tz;
  float &lx = p.lx, &ly = p.ly, &lz = p.lz;
  bool& alive = p.alive;
  {
#include "fused_bounce.inc"
  }
}
#undef DRT_MARK
#define DRT_MARK(k)

static inline bool drt_cfg_ok(const DrtTrace* cfg) {
  return cfg->n_shapes >= 1 && cfg->n_shapes <= DRT_MAX_SHAPES &&
         cfg->n_alb >= 1 && cfg->n_alb <= DRT_MAX_ROWS &&
         cfg->n_emi >= 1 && cfg->n_emi <= DRT_MAX_ROWS && cfg->n_rays > 0 &&
         cfg->ray_base >= 0;
}
