// Path-regeneration forward tracer over the scene table for Hopper
// (sm_90a): one thread per PIXEL renders the pixel's samples one after the
// other, starting the next sample's camera ray in the trip after its path
// died (regen_body.cuh). It replaces drt_tpu/ops/regen.py:make_regen_tracer
// (pallas_call at regen.py:399) in both of its forms:
//  - drt_regen_trace: per-pixel radiance SUMS f32[3, n_pix] over all chunks
//    and the trips each pixel ran, i32[C, n_pix];
//  - drt_regen_collect: the same, and one residual row per trip for the
//    sweep adjoint of regen_adjoint.cu: rsc f32[C, t_cap, n_pix] (the
//    sampling weight) and rmeta i32[C, t_cap, n_pix] = best | want << 8 |
//    rr_on << 9 (best = hit shape + 1, 0 for a trip that ended dead), with
//    t_cap = spp_c * max_depth. A pixel writes only its own `trips` rows;
//    the rest of the buffer stays as it was allocated. Its radiance is the
//    tracer's bit for bit;
//  - drt_regen_stats: the tracer in a checking build that counts the
//    lane-trips and the lane groups that ran them;
//  - drt_regen_sections: the tracer (fast) in a timing build that adds up
//    the clock64() cycles of each section of a trip (drt_common.cuh:
//    SectionClock), as drt_fused_trace_stats does for the fused tracers.
//
// The bounce is fused_body.cuh:fused_bounce, the lockstep tracer's own, at
// the thread's own depth, and the draws are the same keyed hash: sample s
// of a pixel gives the radiance of fused_tracer.cu's ray slot for that
// sample bit for bit. The per-pixel sum is taken in the thread, sample
// after sample (and bounce after bounce within the chunk, as the TPU
// kernel's carry does), so an image differs from the lockstep one only by
// the order of that sum.
//
// What bounds it: operations, as the lockstep tracer (about 300 f32
// operations and 3 sin/cos/pow per trip on the 9 shapes of the Cornell
// box); it moves 12 bytes per pixel plus 4 per pixel and chunk, and the
// collect form 8 bytes per trip run. The pixel is the fastest index of the
// residuals, so the lanes of a warp that are on the same trip write one
// 128-byte line. What regeneration buys is lanes: a lockstep warp runs
// max_depth bounces per sample however few of its rays live; here a thread
// spends live bounces + 1 trips on a sample, and a warp runs until the
// thread with the most trips is done. The threads of a warp are at
// different depths of different samples, so their material branches
// diverge more than in lockstep.

#include "fused_body.cuh"
#include "regen_body.cuh"

// The hook of the collect form: one row at the thread's trip.
struct RegenStore {
  float* sc;  // rsc + (c * t_cap) * n + pix
  int* meta;  // rmeta likewise
  size_t n;
  int min_bounces;
  int trip, want;
  __device__ __forceinline__ void operator()(int b, float, float, float,
                                             float sc_b, float,
                                             int best) const {
    sc[(size_t)trip * n] = sc_b;
    meta[(size_t)trip * n] =
        best | (want << 8) | ((b >= min_bounces ? 1 : 0) << 9);
  }
};

// One bounce of sample smp at depth b: the lockstep kernels' own.
template <bool FAST>
struct FusedRegenBounce {
  const DrtTrace& cfg;
  const DrtTables& tab;
  int pix;
  template <class Hook, class Marks>
  __device__ __forceinline__ void operator()(uint32_t smp, int b, Hook& hook,
                                             PathState& p,
                                             Marks& marks) const {
    fused_bounce<FAST>(cfg, tab, pix, smp, b, hook, p, marks);
  }
};

template <bool FAST, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
regen_trace_kernel(DrtTrace cfg, DrtCamera cam,
                   const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi, int sample_base,
                   float* __restrict__ out, int* __restrict__ trips,
                   float* __restrict__ rsc, int* __restrict__ rmeta,
                   unsigned long long* stats) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = cfg.n_rays;  // pixels
  if (pix >= n) return;

  const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;
  const FusedRegenBounce<FAST> bounce{cfg, tab, pix};
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    const uint32_t sbase = (uint32_t)(sample_base + c * cfg.spp_c);
    PathState p;
    p.lx = 0.0f; p.ly = 0.0f; p.lz = 0.0f;
    NoMarks marks;
    int t;
    if constexpr (COLLECT) {
      const size_t base = (size_t)c * t_cap * n + pix;
      RegenStore hook{rsc + base, rmeta + base, (size_t)n, cfg.min_bounces,
                      0, 0};
      t = regen_chunk<FAST, COUNT>(cfg, cam, pix, sbase, bounce, hook, p,
                                   stats, marks);
    } else {
      RegenNoStore hook{0, 0};
      t = regen_chunk<FAST, COUNT>(cfg, cam, pix, sbase, bounce, hook, p,
                                   stats, marks);
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

// The tracer's timing build (fast variant): regen_trace_kernel's trips
// with a SectionClock, whose per-section cycles it adds into
// stats[0 .. N_SECT). B10's lanes split into groups by trip, so a section
// is timed by the first active lane of each group that runs it.
__global__ void __launch_bounds__(DRT_BLOCK)
regen_sections_kernel(DrtTrace cfg, DrtCamera cam,
                      const float* __restrict__ scene,
                      const float* __restrict__ alb,
                      const float* __restrict__ emi, int sample_base,
                      float* __restrict__ out, int* __restrict__ trips,
                      unsigned long long* stats) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = cfg.n_rays;  // pixels
  if (pix >= n) return;

  const FusedRegenBounce<true> bounce{cfg, tab, pix};
  SectionClock marks;
  marks.start(nullptr);
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;
  for (int c = 0; c < cfg.n_chunks; ++c) {
    const uint32_t sbase = (uint32_t)(sample_base + c * cfg.spp_c);
    PathState p;
    p.lx = 0.0f; p.ly = 0.0f; p.lz = 0.0f;
    RegenNoStore hook{0, 0};
    trips[(size_t)c * n + pix] = regen_chunk<true, false>(
        cfg, cam, pix, sbase, bounce, hook, p, nullptr, marks);
    Lx = Lx + p.lx;
    Ly = Ly + p.ly;
    Lz = Lz + p.lz;
  }
  out[pix] = Lx;
  out[n + pix] = Ly;
  out[2 * n + pix] = Lz;
  marks.flush(stats);
}

static bool regen_cfg_ok(const DrtTrace* cfg, int sample_base) {
  return drt_cfg_ok(cfg) && cfg->internal_rng && cfg->spp_c >= 1 &&
         cfg->n_chunks >= 1 && cfg->max_depth >= 1 && sample_base >= 0 &&
         cfg->n_rays == cfg->width * cfg->height;
}

template <bool COLLECT, bool COUNT>
static int launch(const DrtTrace* cfg, const DrtCamera* cam,
                  const float* scene, const float* alb, const float* emi,
                  int sample_base, float* out, int* trips, float* rsc,
                  int* rmeta, unsigned long long* stats, void* stream) {
  if (!regen_cfg_ok(cfg, sample_base)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  if (cfg->fast)
    regen_trace_kernel<true, COLLECT, COUNT><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *cam, scene, alb, emi, sample_base, out, trips, rsc, rmeta,
        stats);
  else
    regen_trace_kernel<false, COLLECT, COUNT><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *cam, scene, alb, emi, sample_base, out, trips, rsc, rmeta,
        stats);
  return (int)cudaGetLastError();
}

extern "C" {

int drt_regen_limits(int* max_shapes, int* max_rows, int* rec, int* n_stats,
                     int* block) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *n_stats = REGEN_N_STATS;
  *block = DRT_BLOCK;
  return 0;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). cfg->n_rays is the number of pixels. Shapes and types
// are checked by the Python wrappers.
int drt_regen_trace(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    int sample_base, float* out, int* trips, void* stream) {
  return launch<false, false>(cfg, cam, scene, alb, emi, sample_base, out,
                              trips, nullptr, nullptr, nullptr, stream);
}

int drt_regen_collect(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      int sample_base, float* out, int* trips, float* rsc,
                      int* rmeta, void* stream) {
  return launch<true, false>(cfg, cam, scene, alb, emi, sample_base, out,
                             trips, rsc, rmeta, nullptr, stream);
}

// The tracer with the counters of regen_body.cuh added into stats
// u64[REGEN_N_STATS] (which the caller zeroes).
int drt_regen_stats(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    int sample_base, float* out, int* trips,
                    unsigned long long* stats, void* stream) {
  return launch<false, true>(cfg, cam, scene, alb, emi, sample_base, out,
                             trips, nullptr, nullptr, stats, stream);
}

// The timing build, fast variant: cycles per section (SEC_* of
// drt_common.cuh) added into stats u64[N_SECT] (which the caller zeroes).
int drt_regen_sections(const DrtTrace* cfg, const DrtCamera* cam,
                       const float* scene, const float* alb, const float* emi,
                       int sample_base, float* out, int* trips,
                       unsigned long long* stats, void* stream) {
  if (!regen_cfg_ok(cfg, sample_base) || !cfg->fast)
    return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  regen_sections_kernel<<<grid, DRT_BLOCK, 0, (cudaStream_t)stream>>>(
      *cfg, *cam, scene, alb, emi, sample_base, out, trips, stats);
  return (int)cudaGetLastError();
}

const char* drt_regen_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
