// The pieces of the queue of (ray slot, chunk) paths that the scene-table
// tracers (fused_tracer.cu: queue_trace_kernel) and adjoints
// (fused_adjoint.cu: queue_adjoint_kernel, segment_queue_kernel) share:
// the uniforms of a queue's step and the roulette draw of the next bounce
// (the persistent grid, queue_grid, is in drt_common.cuh).

#pragma once

#include "fused_body.cuh"

// The uniforms of a step of the queue: the roulette draw of its bounce was
// taken at the end of the step before (or with the camera ray), so only
// u1 and u2 are drawn here, from the path's key (drt_common.cuh:path_key).
// Inside the queue kernels the bounce text's bounce_uniforms call resolves
// to this overload by the type of `tape`.
struct QueueTape {
  const float* p;  // the tape f32[D, 3, n_rays] (tape mode)
  uint32_t key;    // path_key(seed1, pix, smp) (internal RNG)
  float u_rr;      // the roulette draw of the step's bounce
};

template <bool INTERNAL>
static __device__ __forceinline__ void bounce_uniforms(
    const DrtTrace& cfg, const QueueTape& tape, int i, int, uint32_t,
    int bnc, float& u_rr, float& u1, float& u2) {
  u_rr = tape.u_rr;
  if (INTERNAL) {
    u1 = keyed_uniform(tape.key, (uint32_t)bnc, 1u);
    u2 = keyed_uniform(tape.key, (uint32_t)bnc, 2u);
  } else {
    const int N = cfg.n_rays;
    const float* ub = tape.p + (size_t)bnc * 3 * N;
    u1 = ub[N + i];
    u2 = ub[2 * N + i];
  }
}

// bounce_uniforms' u_rr of bounce bnc alone.
template <bool INTERNAL>
static __device__ __forceinline__ float roulette_draw(const DrtTrace& cfg,
                                                      const QueueTape& t,
                                                      int i, int bnc) {
  if (INTERNAL) return keyed_uniform(t.key, (uint32_t)bnc, 0u);
  return t.p[(size_t)bnc * 3 * cfg.n_rays + i];
}

// The uniforms of a step of a segment's queue (fused_adjoint.cu:
// segment_queue_kernel): QueueTape's, with the segment tape f32[b1 - b0,
// 3, n_rays] holding bounce bnc at row bnc - b0 (fused_body.cuh:
// SegmentTape's rows). The keyed draws take the absolute bounce.
struct SegmentQueueTape {
  const float* p;
  uint32_t key;
  float u_rr;
  int b0;
};

template <bool INTERNAL>
static __device__ __forceinline__ void bounce_uniforms(
    const DrtTrace& cfg, const SegmentQueueTape& tape, int i, int, uint32_t,
    int bnc, float& u_rr, float& u1, float& u2) {
  u_rr = tape.u_rr;
  if (INTERNAL) {
    u1 = keyed_uniform(tape.key, (uint32_t)bnc, 1u);
    u2 = keyed_uniform(tape.key, (uint32_t)bnc, 2u);
  } else {
    const int N = cfg.n_rays;
    const float* ub = tape.p + (size_t)(bnc - tape.b0) * 3 * N;
    u1 = ub[N + i];
    u2 = ub[2 * N + i];
  }
}

template <bool INTERNAL>
static __device__ __forceinline__ float roulette_draw(
    const DrtTrace& cfg, const SegmentQueueTape& t, int i, int bnc) {
  if (INTERNAL) return keyed_uniform(t.key, (uint32_t)bnc, 0u);
  return t.p[(size_t)(bnc - t.b0) * 3 * cfg.n_rays + i];
}
