// Path-regeneration forward tracer over a memory-resident scene for Hopper
// (sm_90a): regen_tracer.cu's trip loop (regen_body.cuh) over the bounce
// of dyn_body.cuh, for scenes of up to 2048 shapes read from device memory
// at run time. It replaces drt_tpu/ops/dynregen.py:make_dyn_regen_tracer
// (pallas_call at dynregen.py:294) in both of its forms:
//  - drt_dyn_regen_trace: per-pixel radiance SUMS f32[3, n_pix] over all
//    chunks and the trips each pixel ran, i32[C, n_pix];
//  - drt_dyn_regen_collect: the same, and one residual row per trip for
//    the sweep adjoint of dyn_regen_adjoint.cu: rsc f32[C, t_cap, n_pix]
//    and rrow i32[C, t_cap, n_pix] = albedo row | emission row << 8 | live
//    << 16 | want << 17 | rr_on << 18, t_cap = spp_c * max_depth. A pixel
//    writes only its own `trips` rows. Its radiance is the tracer's bit
//    for bit;
//  - drt_dyn_regen_stats: the tracer in a checking build that counts the
//    lane-trips, the lane groups that ran them and, as dyn_tracer.cu's,
//    the leaf triangle loops.
//
// Sample s of a pixel is the path of dyn_tracer.cu's ray slot for that
// sample bit for bit (the same bounce routine, the same keyed hash), and
// on a scene that both families take, of regen_tracer.cu's.
//
// What bounds it: operations, as dyn_tracer.cu: the triangle tests of the
// leaves a ray enters. A thread whose path is dead skips the nearest-hit
// loop, so in the lockstep tracer a dead lane costs a warp little once all
// of its lanes are dead, and much while one lives; here every thread has a
// ray in (almost) every trip, which is what regeneration buys, against
// lanes that are at different depths of different samples and so enter
// different leaves.

#include "dyn_body.cuh"
#include "regen_body.cuh"

// The hook of the collect form: one row at the thread's trip.
struct DynRegenStore {
  float* sc;  // rsc + (c * t_cap) * n + pix
  int* row;   // rrow likewise
  size_t n;
  int min_bounces;
  int trip, want;
  __device__ __forceinline__ void operator()(int b, float, float, float,
                                             float sc_b, float, int arow,
                                             int erow, bool alive) const {
    sc[(size_t)trip * n] = sc_b;
    row[(size_t)trip * n] =
        arow + (erow << DYN_ROW_BITS) +
        ((alive ? 1 : 0) << (2 * DYN_ROW_BITS)) +
        (want << (2 * DYN_ROW_BITS + 1)) +
        ((b >= min_bounces ? 1 : 0) << (2 * DYN_ROW_BITS + 2));
  }
};

// One bounce of sample smp at depth b: the lockstep kernels' own.
template <bool FAST, bool COUNT>
struct DynRegenBounce {
  const DrtTrace& cfg;
  const DynLayout& lay;
  const DynOperands& scn;
  const DynTables& tab;
  int pix;
  unsigned long long* stats;
  template <class Hook>
  __device__ __forceinline__ void operator()(uint32_t smp, int b, Hook& hook,
                                             PathState& p) const {
    dyn_bounce<FAST, COUNT>(cfg, lay, scn, tab, pix, smp, b, hook, p, stats);
  }
};

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

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = cfg.n_rays;  // pixels
  if (pix >= n) return;

  const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;
  const DynRegenBounce<FAST, COUNT> bounce{cfg, lay, scn, tab, pix, stats};
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    const uint32_t sbase = (uint32_t)(sample_base + c * cfg.spp_c);
    PathState p;
    p.lx = 0.0f; p.ly = 0.0f; p.lz = 0.0f;
    int t;
    if constexpr (COLLECT) {
      const size_t base = (size_t)c * t_cap * n + pix;
      DynRegenStore hook{rsc + base, rrow + base, (size_t)n,
                         cfg.min_bounces, 0, 0};
      t = regen_chunk<FAST, COUNT>(cfg, cam, pix, sbase, bounce, hook, p,
                                   stats);
    } else {
      RegenNoStore hook{0, 0};
      t = regen_chunk<FAST, COUNT>(cfg, cam, pix, sbase, bounce, hook, p,
                                   stats);
    }
    trips[(size_t)c * n + pix] = t;
    Lx = Lx + p.lx;
    Ly = Ly + p.ly;
    Lz = Lz + p.lz;
  }
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
      cfg->n_rays != cfg->width * cfg->height)
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
