// Shared device code of the path-regeneration kernels of both families
// (regen_tracer.cu and regen_adjoint.cu over the scene table,
// dyn_regen_tracer.cu and dyn_regen_adjoint.cu over a memory-resident
// scene): the replay and reverse sweep of one pixel's stored rows
// (regen_sweep_chunk) and the counters of the checking builds.
//
// What they compute is drt_tpu/ops/regen.py and drt_tpu/ops/dynregen.py:
// the samples of a pixel's chunk are rendered one after the other by one
// lane. A trip is one bounce; a lane whose path has died starts its next
// sample's camera ray in the same trip (`want`) and bounces it at once. A
// path that dies in a trip (Russian roulette, a miss) still stores that
// trip's row, with gate 0, and the depth bound ends a path without one, so
// a sample takes its live bounces + 1 trips, or max_depth.
//
// How the TPU design maps here: on the TPU the lanes of a (tile_rows, 128)
// tile share one trip counter, finished lanes write dead rows until the
// tile's slowest lane is done, and `trips` is per tile. Here each lane
// keeps its own trip counter and writes exactly its own rows, `trips` is
// per pixel and chunk (i32[C, n_pix]), and rows past a pixel's count are
// never written nor read. Both tracers step their warp through one trip
// loop together (the tile's counter carried to the warp): the
// memory-resident one because its leaves are tested by the whole warp,
// the scene-table one on a persistent grid whose lanes take (pixel,
// chunk) units as they free up. The checking builds count how many lanes
// were at work.
//
// Every draw is the keyed hash of (seed, pixel, sample, bounce, dim) with
// chunk c starting at sample sample_base + c * spp_c, the stream of the
// lockstep kernels: sample s of a pixel is the same path here and there,
// bit for bit (the bounce is the lockstep kernels' own routine).

#pragma once

#include "drt_common.cuh"

// Counters of a checking build, after the four of dyn_body.cuh: lane-trips
// run and the warp-trips that ran them, and of those the trips that ended
// live (gate > 0). The scene-table tracer writes a dying trip's row
// without its bounce: its lane-trips count every trip, and the first of
// dyn_body.cuh's four (lane_bounces) the lane-trips that ran the bounce
// (regen_tracer.cu: STAT_BOUNCE_LANES).
enum { STAT_LANE_TRIPS = 4, STAT_GROUP_TRIPS = 5, STAT_LIVE_TRIPS = 6,
       STAT_LIVE_GROUPS = 7, REGEN_N_STATS = 8 };

// One stored row, decoded: the sampling weight, the real table rows (or -1
// for a sentinel row), whether the trip ended live and whether Russian
// roulette was on at its depth.
struct RegenRow {
  int arow, erow;
  bool live, rr_on;
};

// Replay and reverse sweep of one pixel's rows of one chunk into the
// thread's accumulator column `acc`. rsc and rmeta point at the pixel's
// row 0 of the chunk, rows are `n` apart, and only the pixel's own t_act
// rows are read. decode.want(meta) says whether a row starts a sample and
// decode.row(meta) gives its RegenRow.
//
// The rows of one sample are a segment of at most max_depth rows that
// starts at a want row. The throughput is 1 at a sample's start and the
// suffix radiance S is 0 at its end (regen.py:485-556), so the segments
// are independent: each is replayed forward (gate = rr [live], P = T gate,
// T = P a sc, the forward's op order) into DMAX per-thread slots, then
// swept in reverse by sweep_bounce, and the next one follows. The TPU
// kernel keeps P of all spp_c * max_depth trips in VMEM scratch instead
// and adds the terms in another order.
template <int DMAX, class Tables, class Decode>
static __device__ __forceinline__ void regen_sweep_chunk(
    const DrtTrace& cfg, const Tables& tab, const Decode& decode,
    const float* __restrict__ rsc, const int* __restrict__ rmeta, size_t n,
    int t_act, const float g[3], float* acc) {
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  int t = 0;
  int meta = t_act > 0 ? rmeta[0] : 0;  // of row t + k below
  while (t < t_act) {
    float P[DMAX][3], sc[DMAX], gate[DMAX];
    int arow[DMAX], erow[DMAX];
    float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
    int len = 0;
    bool open = true;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (!open) continue;
      const RegenRow r = decode.row(meta);
      const float sc_k = rsc[(size_t)(t + k) * n];
      const float rr = r.rr_on ? cfg.inv_keep : 1.0f;
      const float gate_k = r.live ? rr : 0.0f;
      const float Px = Tx * gate_k, Py = Ty * gate_k, Pz = Tz * gate_k;
      float ax = 1.0f, ay = 1.0f, az = 1.0f;
      if (r.arow >= 0) {
        ax = tab.alb[r.arow * 3 + 0];
        ay = tab.alb[r.arow * 3 + 1];
        az = tab.alb[r.arow * 3 + 2];
      }
      Tx = Px * ax * sc_k;
      Ty = Py * ay * sc_k;
      Tz = Pz * az * sc_k;
      P[k][0] = Px; P[k][1] = Py; P[k][2] = Pz;
      sc[k] = sc_k;
      gate[k] = gate_k;
      arow[k] = r.arow;
      erow[k] = r.erow;
      len = k + 1;
      // The segment ends before the next want row, or with the rows.
      open = false;
      if (t + k + 1 < t_act) {
        meta = rmeta[(size_t)(t + k + 1) * n];
        open = !decode.want(meta);
      }
    }
    float S[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = DMAX - 1; k >= 0; --k) {
      if (k >= len) continue;
      float e[3] = {0.0f, 0.0f, 0.0f};
      float a[3] = {1.0f, 1.0f, 1.0f};
      if (erow[k] >= 0) {
        e[0] = tab.emi[erow[k] * 3 + 0];
        e[1] = tab.emi[erow[k] * 3 + 1];
        e[2] = tab.emi[erow[k] * 3 + 2];
      }
      if (arow[k] >= 0) {
        a[0] = tab.alb[arow[k] * 3 + 0];
        a[1] = tab.alb[arow[k] * 3 + 1];
        a[2] = tab.alb[arow[k] * 3 + 2];
      }
      sweep_bounce(acc, acc_e, arow[k], erow[k], a, e, P[k], sc[k], gate[k],
                   g, S);
    }
    t += len;
  }
}
