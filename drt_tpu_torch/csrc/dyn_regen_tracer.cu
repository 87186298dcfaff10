// Path-regeneration forward tracer over a memory-resident scene for Hopper
// (sm_90a): the trip loop of regen_tracer.cu, stepped through by the warp
// together, over the bounce of dyn_body.cuh, for scenes of up to 2048
// shapes read from device memory at run time. It replaces
// drt_tpu/ops/dynregen.py:make_dyn_regen_tracer (pallas_call at
// dynregen.py:294) in both of its forms:
//  - drt_dyn_regen_trace: per-pixel radiance SUMS f32[3, n_pix] over all
//    chunks and the trips each pixel ran, i32[C, n_pix];
//  - drt_dyn_regen_collect: the same, and one residual row per trip for
//    the sweep adjoint of dyn_regen_adjoint.cu: rsc f32[C, t_cap, n_pix]
//    and rrow i32[C, t_cap, n_pix] = albedo row | emission row << 8 | live
//    << 16 | want << 17 | rr_on << 18, t_cap = spp_c * max_depth. A pixel
//    writes only its own `trips` rows. Its radiance is the tracer's bit
//    for bit;
//  - drt_dyn_regen_stats: the tracer in a checking build that counts the
//    lane-trips, the warp-trips that ran them and, as dyn_tracer.cu's,
//    the leaves the warps tested.
//
// Sample s of a pixel is the path of dyn_tracer.cu's ray slot for that
// sample bit for bit (the same bounce routine, the same keyed hash), and
// on a scene that both families take, of regen_tracer.cu's.
//
// The schedule. The leaves are tested by the whole warp
// (dyn_body.cuh:dyn_intersect_warp), which needs every lane of the warp at
// its shuffles and ballots in every trip. So the warp steps through one
// trip loop over all of its pixels' chunks together: the loop runs while
// any lane has work (a live path, or samples or chunks left), and each
// lane carries its own chunk, sample, depth, trip counter and radiance.
// A lane that ends a chunk writes its trips and adds the chunk's radiance
// to its sum (in chunk order), and starts the next chunk's first sample in
// its next trip, without waiting for the other lanes. A lane with no work
// (its pixel done, or a thread past the last pixel, which runs pixel
// n - 1) takes part with no ray and writes nothing. So a warp runs as many
// trips as its slowest pixel takes over all chunks (ops/regen.py:
// stats_dict's warp_trips). This is the TPU kernel's tile-wide trip
// counter carried to the warp, with `trips` kept per pixel.
//
// What bounds it: operations, as dyn_tracer.cu: the triangle tests of the
// leaves a ray enters, one entered ray at a time across the warp's lanes.
// A lane spends live bounces + 1 trips on a sample, so most lanes have a
// ray in most trips (what regeneration buys); the lanes are at different
// depths of different samples, so they enter different leaves and take
// different material branches.

#include "dyn_body.cuh"
#include "regen_body.cuh"

// The hook of the collect form: the row of the lane's trip, at sc and row.
// A lane with no work stores nothing.
struct DynRegenStore {
  float* sc;
  int* row;
  int min_bounces;
  int want;
  bool work;
  __device__ __forceinline__ void operator()(int b, float, float, float,
                                             float sc_b, float, int arow,
                                             int erow, bool alive) const {
    if (!work) return;
    *sc = sc_b;
    *row = arow + (erow << DYN_ROW_BITS) +
           ((alive ? 1 : 0) << (2 * DYN_ROW_BITS)) +
           (want << (2 * DYN_ROW_BITS + 1)) +
           ((b >= min_bounces ? 1 : 0) << (2 * DYN_ROW_BITS + 2));
  }
};

// In a checking build: the lanes for which `pred` holds are added to
// stats[per_lane], and one to stats[per_group] if there are any.
static __device__ __forceinline__ void count_ballot(unsigned long long* stats,
                                                    bool pred, int per_lane,
                                                    int per_group) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (m && (threadIdx.x & 31) == 0) {
    atomicAdd(stats + per_lane, (unsigned long long)__popc(m));
    atomicAdd(stats + per_group, 1ull);
  }
}

template <bool FAST, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_regen_trace_kernel(DrtTrace cfg, DynLayout lay, DrtCamera cam,
                       DynOperands scn, const float* __restrict__ alb,
                       const float* __restrict__ emi, int sample_base,
                       float* __restrict__ out, int* __restrict__ trips,
                       float* __restrict__ rsc, int* __restrict__ rrow,
                       unsigned long long* stats) {
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);

  const int n = cfg.n_rays;  // pixels
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = slot < n;
  const int pix = lane ? slot : n - 1;
  // The slot's pixel in the image: a shard's pixels start at ray_base.
  const int gpix = cfg.ray_base + pix;
  const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;

  PathState p;
  p.ox = p.oy = p.oz = 0.0f;
  p.dx = p.dy = p.dz = 0.0f;
  p.Tx = p.Ty = p.Tz = 0.0f;
  p.lx = p.ly = p.lz = 0.0f;  // the radiance of the lane's chunk
  p.alive = false;
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  // The lane's chunk, sample in it, depth and trip in it.
  int c = 0, s = -1, b = 0, trip = 0;
  bool work = lane;
  while (__any_sync(0xffffffffu, work)) {
    const uint32_t sbase = (uint32_t)(sample_base + c * cfg.spp_c);
    // A lane with work whose path has died starts its next sample in this
    // trip.
    const bool want = work && !p.alive;
    if (want) {
      ++s;
      float us, ut;
      camera_uniforms(cfg, gpix, sbase + (uint32_t)s, us, ut);
      primary_dir<FAST>(cfg, cam, gpix, us, ut, p.dx, p.dy, p.dz);
      p.ox = cam.eye[0]; p.oy = cam.eye[1]; p.oz = cam.eye[2];
      p.Tx = 1.0f; p.Ty = 1.0f; p.Tz = 1.0f;
      p.alive = true;
      b = 0;
    }
    if (COUNT) count_ballot(stats, work, STAT_LANE_TRIPS, STAT_GROUP_TRIPS);
    const uint32_t smp = sbase + (uint32_t)s;
    if constexpr (COLLECT) {
      const size_t k = ((size_t)c * t_cap + trip) * n + pix;
      DynRegenStore hook{rsc + k, rrow + k, cfg.min_bounces, want ? 1 : 0,
                         work};
      dyn_bounce<FAST, COUNT>(cfg, lay, scn, tab, gpix, smp, b, hook, p,
                              stats);
    } else {
      DynNoResidual hook;
      dyn_bounce<FAST, COUNT>(cfg, lay, scn, tab, gpix, smp, b, hook, p,
                              stats);
    }
    if (COUNT)
      count_ballot(stats, work && p.alive, STAT_LIVE_TRIPS,
                   STAT_LIVE_GROUPS);
    if (!work) continue;
    ++b;
    // The static depth bound, per lane.
    p.alive = p.alive && b < cfg.max_depth;
    ++trip;
    if (!p.alive && s == cfg.spp_c - 1) {  // the chunk is done
      trips[(size_t)c * n + pix] = trip;
      Lx = Lx + p.lx;
      Ly = Ly + p.ly;
      Lz = Lz + p.lz;
      p.lx = p.ly = p.lz = 0.0f;
      s = -1;
      trip = 0;
      work = ++c < cfg.n_chunks;
    }
  }
  if (!lane) return;
  out[pix] = Lx;
  out[n + pix] = Ly;
  out[2 * n + pix] = Lz;
}

template <bool COLLECT, bool COUNT>
static int launch(const DrtTrace* cfg, const DynLayout* lay,
                  const DrtCamera* cam, const DynOperands* scn,
                  const float* alb, const float* emi, int sample_base,
                  float* out, int* trips, float* rsc, int* rrow,
                  unsigned long long* stats, void* stream) {
  if (!dyn_cfg_ok(cfg, lay) || !cfg->internal_rng || cfg->spp_c < 1 ||
      cfg->n_chunks < 1 || sample_base < 0 ||
      cfg->ray_base < 0 ||
      cfg->n_rays > cfg->width * cfg->height - cfg->ray_base)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  if (cfg->fast)
    dyn_regen_trace_kernel<true, COLLECT, COUNT><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *lay, *cam, *scn, alb, emi, sample_base, out, trips, rsc, rrow,
        stats);
  else
    dyn_regen_trace_kernel<false, COLLECT, COUNT><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *lay, *cam, *scn, alb, emi, sample_base, out, trips, rsc, rrow,
        stats);
  return (int)cudaGetLastError();
}

extern "C" {

int drt_dyn_regen_limits(int* max_rows, int* n_stats, int* block) {
  *max_rows = DYN_MAX_ROWS;
  *n_stats = REGEN_N_STATS;
  *block = DRT_BLOCK;
  return 0;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). cfg->n_rays is the number of pixels. Shapes and types
// are checked by the Python wrappers.
int drt_dyn_regen_trace(const DrtTrace* cfg, const DynLayout* lay,
                        const DrtCamera* cam, const DynOperands* scn,
                        const float* alb, const float* emi, int sample_base,
                        float* out, int* trips, void* stream) {
  return launch<false, false>(cfg, lay, cam, scn, alb, emi, sample_base, out,
                              trips, nullptr, nullptr, nullptr, stream);
}

int drt_dyn_regen_collect(const DrtTrace* cfg, const DynLayout* lay,
                          const DrtCamera* cam, const DynOperands* scn,
                          const float* alb, const float* emi, int sample_base,
                          float* out, int* trips, float* rsc, int* rrow,
                          void* stream) {
  return launch<true, false>(cfg, lay, cam, scn, alb, emi, sample_base, out,
                             trips, rsc, rrow, nullptr, stream);
}

// The tracer with the counters of dyn_body.cuh and regen_body.cuh added
// into stats u64[REGEN_N_STATS] (which the caller zeroes).
int drt_dyn_regen_stats(const DrtTrace* cfg, const DynLayout* lay,
                        const DrtCamera* cam, const DynOperands* scn,
                        const float* alb, const float* emi, int sample_base,
                        float* out, int* trips, unsigned long long* stats,
                        void* stream) {
  return launch<false, true>(cfg, lay, cam, scn, alb, emi, sample_base, out,
                             trips, nullptr, nullptr, stats, stream);
}

const char* drt_dyn_regen_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
