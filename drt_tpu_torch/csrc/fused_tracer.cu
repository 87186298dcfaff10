// Fused forward path tracers for Hopper (sm_90a): camera ray, sampling and
// the whole max_depth bounce loop of one ray per thread, in one launch.
// Three entry points over the bounce body of fused_body.cuh:
//  - drt_fused_trace replaces drt_tpu/ops/megakernel.py:
//    make_fused_segment_tracer (the Pallas kernel behind make_fused_tracer,
//    pallas_call at megakernel.py:1194) at b_start = 0, b_end = max_depth;
//  - drt_fused_collect replaces megakernel.py:make_fused_collect_tracer
//    (pallas_call at :1366): the same trace, which also writes the adjoint's
//    residuals rsc f32[C, D, n] and rbest i32[C, D, n] (hit shape + 1, 0 for
//    a dead lane), 8 bytes per bounce-ray, for the sweep adjoint of
//    fused_adjoint.cu. Its radiance is the tracer's bit for bit;
//  - drt_ray_trace replaces megakernel.py:make_pallas_tracer (pallas_call
//    at :723), the forward of the key-driven wavefront: the same loop on
//    primary rays o, d f32[3, N] and a tape f32[D, 3, N] that are inputs
//    (no camera, no RNG), radiance f32[3, N] out; trace_rays(tape=u) as
//    one kernel. Exact variant only. On the fused tracer's own primary
//    rays and tape its radiance is the fused tracer's bit for bit. It reads
//    84 bytes per ray at depth 5 where the fused tracer reads none, which
//    at the main shape (4.9 M rays a launch) is 0.14 ms of the card's
//    memory rate against ~0.7 ms of bounce work: bound like the fused
//    tracer, by issue and divergence, and every read is a coalesced line;
//  - drt_fused_segment_trace replaces make_fused_segment_tracer (pallas_call
//    at :1194) at any [b_start, b_end): bounces b_start..b_end-1 of one
//    chunk, entered from the camera (b_start == 0) or from a state (o, d,
//    T rows f32[9, K], alive i32[K]) and, unless b_end == max_depth, left
//    into the same; with the internal RNG each lane draws from the keyed
//    hash at its ray slot ray_idx i32[K] and the absolute bounce, where the
//    TPU kernel reseeds its PRNG per compacted tile, so that a compacted
//    wavefront follows the lockstep tracer's paths. Radiance f32[3, K] of
//    the segment. At [0, max_depth) it is the tracer's on one chunk bit for
//    bit. Bound like the tracer (the state costs 44 bytes per lane in and
//    52 out, 0.08 ms per 4.9 M lanes at the card's memory rate, against
//    0.25 ms or more of bounce work); the compaction between segments is
//    the caller's (fused.make_compacted_image_renderer);
//  - drt_earlyexit_trace replaces drt_tpu/ops/earlyexit.py:
//    make_earlyexit_tracer (pallas_call at :170): the tracer with a warp
//    vote before each bounce, so that a warp whose 32 lanes are all dead
//    leaves the chunk's bounce loop (the TPU kernel skips a tile of 128 or
//    more lanes with pl.when). Exact variant; its radiance is the exact
//    tracer's bit for bit. It saves the bounces after a warp's last lane
//    dies, which at depth 5 are few (Russian roulette starts at
//    min_bounces) and at depth 16 most.
//
// What the body computes is the TPU kernel's
// _camera_ray_from_pix + _wavefront_body: the same op order, the same
// quirks (spp-outer ray order, keep-first ties with strict <, the RR gate
// 1/(1-absorb) from min_bounces on, the pdf > 0 guards, dead-lane hit
// data zeroed before use, C++ pow for a negative base, the RAY_EPS
// offset, the x-mirrored camera with the -up t-axis).
//
// How the TPU design maps here:
//  - The TPU kernel bakes the scene into the kernel as literals. Here the
//    scene is a small f32 table (drt_tpu_torch/ops/megakernel.py,
//    scene_table) that each block copies into shared memory once; every
//    thread of a warp then reads the same shape record at the same time,
//    which shared memory serves as a broadcast. The albedo and emission
//    tables (the differentiable inputs) are staged the same way.
//  - The TPU kernel draws from the per-core hardware PRNG, which has no
//    counterpart. Here the internal-RNG mode draws the keyed hash of
//    drt_tpu/ops/regen.py (hash_uniform): each draw is a pure function of
//    (seed, pixel, sample, bounce, dim), so drt_tpu.ops.regen.hash_tapes
//    rebuilds the exact samples and tests compare sample for sample.
//  - The TPU runs its chunk grid in order and accumulates into an output
//    tile resident across grid steps. Blocks here run in no order, so the
//    spp-chunk loop runs inside the thread and the per-ray sum is written
//    once at the end.
//
// What bounds it: nothing in device memory. Per ray it reads the tape
// (tape mode) or nothing (internal RNG) and writes 12 bytes; the work is
// about (9 shapes x ~25 + ~150 shading) f32 operations and 3 sin/cos/pow
// per bounce, so it is bound by the SM's f32 and special-function issue
// rate and by warp divergence: a warp runs each bounce while any of its
// lanes lives, and its lanes hit different materials. On an H100 the
// bounces after the first cost the same whatever share of rays Russian
// roulette has killed (PERF.md). This first version is simple and
// exact; path regeneration or lane compaction for the dead lanes, and
// occupancy (128-thread blocks), are later work. The collect tracer does
// the same work and adds its residual stores: the ray slot is the fastest
// index of rsc and rbest, so a warp's 32 stores of one bounce are one
// 128-byte line each. At the main shape that is 3.15 GB written once, about
// 1 ms at the card's memory rate, a tenth of the trace itself.
//
// Variants: FAST = false keeps the reference forms and is built with
// -fmad=false (no a*b+c contraction), so it follows the plain PyTorch
// version's rounding step for step. FAST = true takes, as the TPU kernel's
// fastmath does: rsqrtf for 1/sqrt (camera direction, sphere normal,
// frame tangent and bitangent, halfway vector), the diffuse quotient
// s*cos/pdf cancelled to cos_geom * rsqrt(1 - u1), the mirror quotient
// (1/c)*c cancelled to 1, and the specular quotient with the shared
// (e+2)/(2 pi) cancelled. The intersection keeps its divides in both.

#include "fused_body.cuh"

// The hook of the collect tracer: bounce b of this ray slot and chunk.
struct StoreResidual {
  float* sc;  // rsc + (c * D) * N + i
  int* best;  // rbest likewise
  size_t n;
  __device__ __forceinline__ void operator()(int b, float, float, float,
                                             float sc_b, float,
                                             int best_b) const {
    sc[(size_t)b * n] = sc_b;
    best[(size_t)b * n] = best_b;
  }
};

template <bool FAST, bool INTERNAL, bool COLLECT>
__global__ void __launch_bounds__(DRT_BLOCK)
fused_trace_kernel(DrtTrace cfg, DrtCamera cam,
                   const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ cam_u,
                   const float* __restrict__ tape,
                   float* __restrict__ out,
                   float* __restrict__ rsc, int* __restrict__ rbest) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.n_rays;
  if (i >= N) return;

  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    float lx, ly, lz;
    if constexpr (COLLECT) {
      const size_t base = (size_t)c * cfg.max_depth * N + i;
      StoreResidual hook{rsc + base, rbest + base, (size_t)N};
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz);
    } else {
      NoResidual hook;
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz);
    }
    Lx = Lx + lx;
    Ly = Ly + ly;
    Lz = Lz + lz;
  }
  out[i] = Lx;
  out[N + i] = Ly;
  out[2 * N + i] = Lz;
}

__global__ void __launch_bounds__(DRT_BLOCK)
ray_trace_kernel(DrtTrace cfg, const float* __restrict__ scene,
                 const float* __restrict__ alb,
                 const float* __restrict__ emi,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tape, float* __restrict__ out) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.n_rays;
  if (i >= N) return;
  NoResidual hook;
  float lx, ly, lz;
  trace_ray(cfg, tab, o, d, tape, i, hook, lx, ly, lz);
  out[i] = lx;
  out[N + i] = ly;
  out[2 * N + i] = lz;
}

// The early-exit tracer: every thread of the grid stays in the bounce loop
// up to the warp's vote (a thread past the last ray slot as a dead path),
// so the vote always sees the whole warp.
template <bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
earlyexit_trace_kernel(DrtTrace cfg, DrtCamera cam,
                       const float* __restrict__ scene,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const float* __restrict__ cam_u,
                       const float* __restrict__ tape,
                       float* __restrict__ out) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int N = cfg.n_rays;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = slot < N;
  const int i = lane ? slot : N - 1;
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    NoResidual hook;
    float lx, ly, lz;
    trace_chunk_vote<false, INTERNAL>(cfg, cam, tab, cam_u, tape, i, lane,
                                      c, hook, lx, ly, lz);
    Lx = Lx + lx;
    Ly = Ly + ly;
    Lz = Lz + lz;
  }
  if (!lane) return;
  out[i] = Lx;
  out[N + i] = Ly;
  out[2 * N + i] = Lz;
}

template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_trace_kernel(DrtTrace cfg, DrtCamera cam, int b0, int b1, int chunk,
                     const float* __restrict__ scene,
                     const float* __restrict__ alb,
                     const float* __restrict__ emi,
                     const float* __restrict__ cam_u,
                     const float* __restrict__ tape,
                     const float* __restrict__ ray,
                     const int* __restrict__ alive_in,
                     const int* __restrict__ ray_idx,
                     float* __restrict__ out, float* __restrict__ ray_out,
                     int* __restrict__ alive_out) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int K = cfg.n_rays;
  if (i >= K) return;
  NoResidual hook;
  PathState p;
  trace_segment<FAST, INTERNAL>(cfg, cam, tab, cam_u, SegmentTape{tape, b0},
                                ray, alive_in, ray_idx, b1, i, chunk, hook,
                                p);
  out[i] = p.lx;
  out[K + i] = p.ly;
  out[2 * K + i] = p.lz;
  if (ray_out == nullptr) return;
  const size_t n = (size_t)K;
  ray_out[i] = p.ox; ray_out[n + i] = p.oy; ray_out[2 * n + i] = p.oz;
  ray_out[3 * n + i] = p.dx; ray_out[4 * n + i] = p.dy;
  ray_out[5 * n + i] = p.dz;
  ray_out[6 * n + i] = p.Tx; ray_out[7 * n + i] = p.Ty;
  ray_out[8 * n + i] = p.Tz;
  alive_out[i] = p.alive ? 1 : 0;
}

template <bool COLLECT>
static int launch(const DrtTrace* cfg, const DrtCamera* cam,
                  const float* scene, const float* alb, const float* emi,
                  const float* cam_u, const float* tape, float* out,
                  float* rsc, int* rbest, void* stream) {
  if (!drt_cfg_ok(cfg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, I)                                                  \
  fused_trace_kernel<F, I, COLLECT><<<grid, DRT_BLOCK, 0, s>>>(           \
      *cfg, *cam, scene, alb, emi, cam_u, tape, out, rsc, rbest)
  if (cfg->fast) {
    if (cfg->internal_rng) DRT_LAUNCH(true, true);
    else DRT_LAUNCH(true, false);
  } else {
    if (cfg->internal_rng) DRT_LAUNCH(false, true);
    else DRT_LAUNCH(false, false);
  }
#undef DRT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" {

int drt_limits(int* max_shapes, int* max_rows, int* rec) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  return 0;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). Shapes and types are checked by the Python wrappers.
int drt_fused_trace(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    const float* cam_u, const float* tape, float* out,
                    void* stream) {
  return launch<false>(cfg, cam, scene, alb, emi, cam_u, tape, out, nullptr,
                       nullptr, stream);
}

int drt_fused_collect(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      const float* cam_u, const float* tape, float* out,
                      float* rsc, int* rbest, void* stream) {
  return launch<true>(cfg, cam, scene, alb, emi, cam_u, tape, out, rsc,
                      rbest, stream);
}

// The wavefront tracer takes one chunk of rays, the exact variant and a
// tape: a config asking for anything else is refused.
int drt_ray_trace(const DrtTrace* cfg, const float* scene, const float* alb,
                  const float* emi, const float* o, const float* d,
                  const float* tape, float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || cfg->internal_rng ||
      cfg->fast)
    return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  ray_trace_kernel<<<grid, DRT_BLOCK, 0, (cudaStream_t)stream>>>(
      *cfg, scene, alb, emi, o, d, tape, out);
  return (int)cudaGetLastError();
}

// Bounces [b_start, b_end) of chunk `chunk` over cfg->n_rays lanes. The
// camera's uniforms (tape mode) are read iff b_start == 0, the state
// (ray, alive) iff b_start > 0, ray_idx iff b_start > 0 with the internal
// RNG; the exit state is written iff b_end < max_depth. The tape is
// f32[b_end - b_start, 3, n_rays].
int drt_fused_segment_trace(const DrtTrace* cfg, const DrtCamera* cam,
                            int b_start, int b_end, int chunk,
                            const float* scene, const float* alb,
                            const float* emi, const float* cam_u,
                            const float* tape, const float* ray,
                            const int* alive, const int* ray_idx, float* out,
                            float* ray_out, int* alive_out, void* stream) {
  const bool entry = b_start == 0, final = b_end == cfg->max_depth;
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || b_start < 0 ||
      b_end <= b_start || b_end > cfg->max_depth || chunk < 0 ||
      (!cfg->internal_rng && (tape == nullptr || (entry && !cam_u))) ||
      (!entry && (!ray || !alive || (cfg->internal_rng && !ray_idx))) ||
      (!final && (!ray_out || !alive_out)))
    return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  float* ro = final ? nullptr : ray_out;
#define DRT_LAUNCH(F, I)                                                  \
  segment_trace_kernel<F, I><<<grid, DRT_BLOCK, 0, s>>>(                  \
      *cfg, *cam, b_start, b_end, chunk, scene, alb, emi, cam_u, tape,    \
      ray, alive, ray_idx, out, ro, alive_out)
  if (cfg->fast) {
    if (cfg->internal_rng) DRT_LAUNCH(true, true);
    else DRT_LAUNCH(true, false);
  } else {
    if (cfg->internal_rng) DRT_LAUNCH(false, true);
    else DRT_LAUNCH(false, false);
  }
#undef DRT_LAUNCH
  return (int)cudaGetLastError();
}

// The early-exit tracer: drt_fused_trace's call, exact variant only.
int drt_earlyexit_trace(const DrtTrace* cfg, const DrtCamera* cam,
                        const float* scene, const float* alb,
                        const float* emi, const float* cam_u,
                        const float* tape, float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->fast) return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (cfg->internal_rng)
    earlyexit_trace_kernel<true><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *cam, scene, alb, emi, cam_u, tape, out);
  else
    earlyexit_trace_kernel<false><<<grid, DRT_BLOCK, 0, s>>>(
        *cfg, *cam, scene, alb, emi, cam_u, tape, out);
  return (int)cudaGetLastError();
}

const char* drt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
