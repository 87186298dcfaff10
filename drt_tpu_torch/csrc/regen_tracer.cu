// Path-regeneration forward tracer over the scene table for Hopper
// (sm_90a): a lane renders the samples of a (pixel, chunk) unit one after
// the other, starting the next sample's camera ray in the trip its path
// died in, or the next (regen_body.cuh). It replaces drt_tpu/ops/regen.py:
// make_regen_tracer (pallas_call at regen.py:399) in both of its forms:
//  - drt_regen_trace: per-pixel radiance SUMS f32[3, n_pix] over all chunks
//    and the trips each pixel ran in each chunk, i32[C, n_pix];
//  - drt_regen_collect: the same, and one residual row per trip for the
//    sweep adjoint of regen_adjoint.cu: rsc f32[C, t_cap, n_pix] (the
//    sampling weight) and rmeta i32[C, t_cap, n_pix] = best | want << 8 |
//    rr_on << 9 (best = hit shape + 1, 0 for a trip that ended dead), with
//    t_cap = spp_c * max_depth. A pixel writes only its own `trips` rows;
//    the rest of the buffer stays as it was allocated. Its radiance is the
//    tracer's bit for bit;
//  - drt_regen_stats: the tracer in a checking build that counts the
//    trips, the lanes that ran a bounce and the warp-trips that ran them,
//    and times each section of a warp-trip with clock64() (drt_common.cuh:
//    SectionClock), as drt_fused_trace_stats does for the fused tracers.
//
// The schedule: the trip loop of dyn_regen_tracer.cu (B12), one loop of
// the warp that every lane steps through together, on a persistent grid
// (drt_common.cuh:queue_grid). Each lane carries its own unit (a pixel's
// chunk), sample, depth, trip counter and radiance. In a trip the lanes
// without a unit take the warp's next units, the lanes whose path has
// died draw their unit's next camera ray (`want`), and every lane with a
// path runs one bounce at its own depth (fused_body.cuh:fused_bounce, the
// lockstep kernels' own). Units come to a warp in batches of 32 (32
// consecutive pixels of one chunk): its first batch is its own warp
// index, the next ones from a counter in device memory, so that the warps
// of the card end together whatever their pixels cost. A unit writes its
// trips and, over more than one chunk, its radiance to scratch sums
// f32[C, 3, n_pix]; regen_sum_kernel adds a pixel's chunks in chunk order
// from +0, the per-pixel loop's sum bit for bit (with one chunk the unit
// writes +0 + its radiance itself). A unit is a chunk, not a pixel: the
// card holds 2.02 of the main shape's pixels a lane, so a lane that ran
// whole pixels left a third one to 2% of the lanes at the end (PERF.md
// section 6 has both timed).
//
// The collect form takes a warp's next batch only when all its lanes wait
// for one (REFILL_COLLECT), the tracer as soon as one lane does. The rows
// of a batch's trips fill 128-byte lines, 32 pixels to a line; with the
// 32 units of a batch started together each line is filled within a few
// trips, while units that start as lanes free up spread a line's stores
// over a unit's length and L2 evicts it partly written (2.8 times the
// collect form's time on the first design, PERF.md section 6).
//
// The dying trip. A path that dies in a trip (Russian roulette, a miss)
// stores that trip's row with gate 0, and the depth bound ends a path
// without one, so a sample takes its live bounces + 1 trips, or max_depth.
// After each bounce the lane draws the roulette of the next one (the draw
// is keyed, the same number whenever it is drawn); if it kills the path,
// the lane writes the dying trip's row (sc 0, best 0, rr_on) and adds its
// P e = (T 0) 0 to the radiance (the bounce's own arithmetic on a dead
// lane) at once, without its nearest-hit loop, and starts its next sample
// in the next trip. So a warp-trip runs a bounce only on paths that enter
// it alive, as the queue of fused_tracer.cu does, and the rows, trips and
// radiance stay the per-pixel loop's bit for bit. (With min_bounces == 0
// a camera trip's own roulette is decided in its bounce.)
//
// What bounds it: operations, as the lockstep tracer (about 300 f32
// operations and 3 sin/cos/pow per live bounce on the 9 shapes of the
// Cornell box); it moves 12 bytes per pixel plus 4 per pixel and chunk
// (and the scratch sums, 24 per pixel and chunk), and the collect form 8
// bytes per trip.

#include "fused_body.cuh"
#include "regen_body.cuh"

// The counter of the lane-trips that ran the bounce, in the first slot of
// the dyn family's four (regen_body.cuh).
enum { STAT_BOUNCE_LANES = 0 };

// The hook of the collect form: one row at the lane's trip.
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

// The collect form's hook, or none.
template <bool COLLECT>
static __device__ __forceinline__ auto regen_hook(float* rsc, int* rmeta,
                                                  size_t base, size_t n,
                                                  int min_bounces, int trip,
                                                  int want) {
  if constexpr (COLLECT)
    return RegenStore{rsc + base, rmeta + base, n, min_bounces, trip, want};
  else
    return NoResidual{};
}

// The idle lanes a warp of the collect form waits for before it takes its
// next batch (the tracer's: 1).
#define REFILL_COLLECT 32

// The trip loop of every form: the (pixel, chunk) units of the launch,
// their radiance written to out (one chunk) or to sums f32[C, 3, n_pix]
// (regen_sum_kernel adds them); next_batch is the counter of the batches
// handed out after each warp's first, zeroed by the launch. COUNT: the
// checking build, whose `marks` (a SectionClock) time the sections of a
// warp-trip and count its lanes, and which adds its counters into stats
// (STAT_* of regen_body.cuh).
template <bool FAST, bool COLLECT, bool COUNT, class Marks>
static __device__ __forceinline__ void regen_trips(
    const DrtTrace& cfg, const DrtCamera& cam, const DrtTables& tab,
    int sample_base, float* __restrict__ out, float* __restrict__ sums,
    int* __restrict__ trips, float* __restrict__ rsc,
    int* __restrict__ rmeta, int* next_batch, unsigned long long* stats,
    Marks& marks) {
  constexpr int REFILL_AT = COLLECT ? REFILL_COLLECT : 1;
  const int n = cfg.n_rays;  // pixels
  const int C = cfg.n_chunks, D = cfg.max_depth;
  const size_t t_cap = (size_t)cfg.spp_c * D;
  const int n_batches = ((n + 31) >> 5) * C;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int W = (gridDim.x * blockDim.x) >> 5;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  // The warp's units not yet handed out: [pool, pool_end). Unit j is
  // pixel (j / 32 / C) 32 + j % 32 of chunk j / 32 % C.
  int pool = warp << 5, pool_end = (warp + 1) << 5;
  bool dry = warp >= n_batches;  // no batch left
  if (dry) pool = pool_end = 0;

  // The lane's unit (pixel, chunk), its sample, depth and trip.
  int pix = 0, c = 0, s = -1, bnc = 0, trip = 0;
  uint32_t key = 0u;  // path_key of the path
  bool work = false;
  PathState p;
  p.ox = p.oy = p.oz = 0.0f;
  p.dx = p.dy = p.dz = 0.0f;
  p.Tx = p.Ty = p.Tz = 0.0f;
  p.lx = p.ly = p.lz = 0.0f;  // the radiance of the lane's unit
  p.alive = false;
  bool& alive = p.alive;
  unsigned long long n_trips = 0ull;

  while (true) {
    marks.at(SEC_LOOP, bnc, alive);
    // The warp's next units to the lanes without one, in lane order.
    const unsigned idle = __ballot_sync(0xffffffffu, !work);
    if (idle != 0u) {
      const int k = __popc(idle), rank = __popc(idle & below);
      const int left = pool_end - pool;
      int fresh = 0;  // the first unit of a batch taken now
      const bool refill = left < k && !dry && k >= REFILL_AT;
      if (refill) {
        int b = 0;
        if (lane == 0) b = atomicAdd(next_batch, 1);
        b = W + __shfl_sync(0xffffffffu, b, 0);
        dry = b >= n_batches;
        fresh = b << 5;
      }
      if (!work) {
        int j = -1;
        if (rank < left)
          j = pool + rank;
        else if (refill && !dry)
          j = fresh + rank - left;
        if (j >= 0) {
          const int batch = j >> 5;
          pix = ((batch / C) << 5) + (j & 31);
          c = batch % C;
          work = pix < n;
          s = -1;
          trip = 0;
        }
      }
      if (left >= k) {
        pool += k;
      } else if (refill && !dry) {
        pool = fresh + k - left;
        pool_end = fresh + 32;
      } else {
        pool = pool_end;
      }
    }
    if (!__any_sync(0xffffffffu, work)) {
      if (dry && pool == pool_end) break;
      continue;
    }
    // A lane with a unit whose path has died starts its next sample in
    // this trip.
    const uint32_t sbase = (uint32_t)(sample_base + c * cfg.spp_c);
    // The unit's pixel in the image: a shard's pixels start at ray_base.
    const int gpix = cfg.ray_base + pix;
    const bool want = work && !alive;
    if (want) {
      ++s;
      float us, ut;
      camera_uniforms(cfg, gpix, sbase + (uint32_t)s, us, ut);
      primary_dir<FAST>(cfg, cam, gpix, us, ut, p.dx, p.dy, p.dz);
      p.ox = cam.eye[0]; p.oy = cam.eye[1]; p.oz = cam.eye[2];
      p.Tx = 1.0f; p.Ty = 1.0f; p.Tz = 1.0f;
      alive = true;
      bnc = 0;
      key = path_key(cfg.seed1, (uint32_t)gpix, sbase + (uint32_t)s);
    }
    marks.at(SEC_CAMERA, bnc, alive);
    const size_t base = (size_t)c * t_cap * n + pix;
    if (work) {
      auto hook = regen_hook<COLLECT>(rsc, rmeta, base, (size_t)n,
                                      cfg.min_bounces, trip, want ? 1 : 0);
      fused_bounce<FAST>(cfg, tab, gpix, sbase + (uint32_t)s, bnc, hook, p,
                         marks);
    }
    marks.step(work, alive);
    if (!work) continue;
    ++bnc;
    ++trip;
    alive = alive && bnc < D;  // the static depth bound
    // The roulette of the next bounce, decided now: the trip it kills
    // keeps its row and its P e, without the bounce.
    if (alive && bnc >= cfg.min_bounces &&
        keyed_uniform(key, (uint32_t)bnc, 0u) < cfg.absorb) {
      if (COLLECT) {
        rsc[base + (size_t)trip * n] = 0.0f;
        rmeta[base + (size_t)trip * n] = 1 << 9;
      }
      p.lx = p.lx + (p.Tx * 0.0f) * 0.0f;
      p.ly = p.ly + (p.Ty * 0.0f) * 0.0f;
      p.lz = p.lz + (p.Tz * 0.0f) * 0.0f;
      ++trip;
      alive = false;
    }
    if (alive || s < cfg.spp_c - 1) continue;
    // The unit is done: its trips, and its radiance (one chunk: the
    // pixel's sum from +0, as a lane adds its chunks).
    trips[(size_t)c * n + pix] = trip;
    if (COUNT) n_trips += (unsigned long long)trip;
    if (C > 1) {
      float* l = sums + (size_t)c * 3 * n + pix;
      l[0] = p.lx;
      l[n] = p.ly;
      l[2 * n] = p.lz;
    } else {
      out[pix] = 0.0f + p.lx;
      out[n + pix] = 0.0f + p.ly;
      out[2 * n + pix] = 0.0f + p.lz;
    }
    p.lx = p.ly = p.lz = 0.0f;
    work = false;
  }
  if constexpr (COUNT) {
    // marks.steps: the lanes that ran a bounce, the warp-trips, of those
    // the lanes alive after it and the warp-trips with any (the lead
    // lane's counts; the others hold zeros).
    const unsigned long long* st = marks.steps;
    const int at[5] = {STAT_LANE_TRIPS, STAT_BOUNCE_LANES, STAT_GROUP_TRIPS,
                       STAT_LIVE_TRIPS, STAT_LIVE_GROUPS};
    const unsigned long long v[5] = {n_trips, st[0], st[1], st[2], st[3]};
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (v[k] != 0ull) atomicAdd(stats + at[k], v[k]);
  }
}

template <bool FAST, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
regen_trace_kernel(DrtTrace cfg, DrtCamera cam,
                   const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi, int sample_base,
                   float* __restrict__ out, float* __restrict__ sums,
                   int* __restrict__ trips, float* __restrict__ rsc,
                   int* __restrict__ rmeta, int* next_batch,
                   unsigned long long* stats) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  if constexpr (COUNT) {
    SectionClock marks;
    marks.start(nullptr);
    regen_trips<FAST, COLLECT, true>(cfg, cam, tab, sample_base, out, sums,
                                     trips, rsc, rmeta, next_batch, stats,
                                     marks);
    marks.flush(stats + REGEN_N_STATS);
  } else {
    NoMarks marks;
    regen_trips<FAST, COLLECT, false>(cfg, cam, tab, sample_base, out,
                                      sums, trips, rsc, rmeta, next_batch,
                                      stats, marks);
  }
}

// out[:, pix] = +0 + sums[0, :, pix] + ... + sums[C - 1, :, pix], in chunk
// order: the (pixel, chunk) units' sum, as a lane adds its chunks.
__global__ void __launch_bounds__(DRT_BLOCK)
regen_sum_kernel(int n, int C, const float* __restrict__ sums,
                 float* __restrict__ out) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < 3 * n;
       k += gridDim.x * blockDim.x) {
    const int ch = k / n, pix = k - ch * n;
    float L = 0.0f;
    for (int c = 0; c < C; ++c)
      L = L + __ldcg(sums + ((size_t)c * 3 + ch) * n + pix);
    out[k] = L;
  }
}

static bool regen_cfg_ok(const DrtTrace* cfg, int sample_base) {
  return drt_cfg_ok(cfg) && cfg->internal_rng && cfg->spp_c >= 1 &&
         cfg->n_chunks >= 1 && cfg->max_depth >= 1 && sample_base >= 0 &&
         cfg->ray_base >= 0 &&
         cfg->n_rays <= cfg->width * cfg->height - cfg->ray_base;
}

// The kernel of a form and the grid it launches on.
template <bool COLLECT, bool COUNT>
static cudaError_t regen_grid(bool fast, int n_pix, int n_chunks,
                              int* grid) {
  const int threads = ((n_pix + 31) >> 5) * 32 * n_chunks;
  if (fast)
    return queue_grid(regen_trace_kernel<true, COLLECT, COUNT>, threads,
                      grid);
  return queue_grid(regen_trace_kernel<false, COLLECT, COUNT>, threads,
                    grid);
}

// scratch: the batch counter (an int) and, for C > 1, the units' radiance
// f32[C, 3, n_pix] after it (16-byte aligned).
template <bool COLLECT, bool COUNT>
static int launch(const DrtTrace* cfg, const DrtCamera* cam,
                  const float* scene, const float* alb, const float* emi,
                  int sample_base, float* out, int* trips, float* rsc,
                  int* rmeta, void* scratch, unsigned long long* stats,
                  void* stream) {
  if (!regen_cfg_ok(cfg, sample_base) || !scratch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int grid = 0;
  cudaError_t e = regen_grid<COLLECT, COUNT>(cfg->fast, cfg->n_rays,
                                             cfg->n_chunks, &grid);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  int* next_batch = (int*)scratch;
  float* sums = (float*)scratch + 4;
#define DRT_LAUNCH(F)                                                     \
  regen_trace_kernel<F, COLLECT, COUNT><<<grid, DRT_BLOCK, 0, s>>>(       \
      *cfg, *cam, scene, alb, emi, sample_base, out, sums, trips, rsc,    \
      rmeta, next_batch, stats)
  if (cfg->fast) DRT_LAUNCH(true);
  else DRT_LAUNCH(false);
#undef DRT_LAUNCH
  if (cfg->n_chunks > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int blocks = (3 * cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
    regen_sum_kernel<<<blocks, DRT_BLOCK, 0, s>>>(cfg->n_rays, cfg->n_chunks,
                                                  sums, out);
  }
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

// The persistent grid of a form (collect != 0: the collect form) at n_pix
// pixels and n_chunks chunks: the blocks an SM holds (the occupancy API)
// and the blocks launched.
int drt_regen_grid(int fast, int collect, int n_pix, int n_chunks,
                   int* per_sm, int* grid) {
  cudaError_t e = fast
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, collect ? regen_trace_kernel<true, true, false>
                            : regen_trace_kernel<true, false, false>,
            DRT_BLOCK, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, collect ? regen_trace_kernel<false, true, false>
                            : regen_trace_kernel<false, false, false>,
            DRT_BLOCK, 0);
  if (e != cudaSuccess) return (int)e;
  e = collect ? regen_grid<true, false>(fast, n_pix, n_chunks, grid)
              : regen_grid<false, false>(fast, n_pix, n_chunks, grid);
  return (int)e;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). cfg->n_rays is the number of pixels; scratch holds 16
// bytes, and 12 C n_pix more for C > 1 chunks. Shapes and types are
// checked by the Python wrappers.
int drt_regen_trace(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    int sample_base, float* out, int* trips, void* scratch,
                    void* stream) {
  return launch<false, false>(cfg, cam, scene, alb, emi, sample_base, out,
                              trips, nullptr, nullptr, scratch, nullptr,
                              stream);
}

int drt_regen_collect(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      int sample_base, float* out, int* trips, float* rsc,
                      int* rmeta, void* scratch, void* stream) {
  return launch<true, false>(cfg, cam, scene, alb, emi, sample_base, out,
                             trips, rsc, rmeta, scratch, nullptr, stream);
}

// The tracer's checking build: its counters (STAT_* of regen_body.cuh)
// added into stats u64[REGEN_N_STATS + N_SECT], the cycles of each section
// of a warp-trip (SEC_* of drt_common.cuh) after them; the caller zeroes
// stats.
int drt_regen_stats(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    int sample_base, float* out, int* trips, void* scratch,
                    unsigned long long* stats, void* stream) {
  if (!stats) return (int)cudaErrorInvalidValue;
  return launch<false, true>(cfg, cam, scene, alb, emi, sample_base, out,
                             trips, nullptr, nullptr, scratch, stats,
                             stream);
}

const char* drt_regen_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
