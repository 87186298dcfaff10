// Fused forward path tracers for Hopper (sm_90a): camera ray, sampling and
// the bounce loop of every path, in one launch, over the bounce body of
// fused_body.cuh. The entry points:
//  - drt_fused_trace replaces drt_tpu/ops/megakernel.py:
//    make_fused_segment_tracer (the Pallas kernel behind make_fused_tracer,
//    pallas_call at megakernel.py:1194) at b_start = 0, b_end = max_depth;
//  - drt_fused_collect replaces megakernel.py:make_fused_collect_tracer
//    (pallas_call at :1366): the same trace, which also writes the adjoint's
//    residuals rsc f32[C, D, n] and rbest i32[C, D, n] (hit shape + 1, 0 for
//    a dead lane), 8 bytes per bounce-ray, for the sweep adjoint of
//    fused_adjoint.cu. Its radiance is the tracer's bit for bit.
//    Both run the queue of (ray slot, chunk) paths (queue_trace_kernel),
//    one live bounce a trip; their checking builds drt_fused_trace_lockstep
//    and drt_fused_collect_lockstep run the lockstep loop (fused_trace_kernel:
//    one thread per ray slot, all max_depth bounces of each chunk) and are
//    their bit reference; drt_fused_trace_stats counts and times either
//    loop (clock64() per section of a step);
//  - drt_ray_trace replaces megakernel.py:make_pallas_tracer (pallas_call
//    at :723), the forward of the key-driven wavefront: the tracer's queue
//    (ray_queue_kernel over queue_trace.inc) with one chunk, each path
//    started at its input ray o, d f32[3, N] (no camera), radiance
//    f32[3, N] out, exact variant only. Its tape form reads the draws
//    from a tape f32[D, 3, N], trace_rays(tape=u) as one kernel; its keyed
//    form, drt_ray_trace_keyed, draws them in the kernel from the keyed
//    hash of (seed1, pix[i], smp[i], bounce) for the pixel and sample
//    i32[N] of each ray, which is the tape form fed bounce_tape(seed1,
//    pix, smp, D) bit for bit and needs no tape at all (the wavefront
//    renderer's form). drt_ray_trace_lockstep, the checking build, runs
//    the lockstep loop on a tape, the bit reference of both. On the fused
//    tracer's own primary rays and tape its radiance is the fused
//    tracer's bit for bit. Bound like the tracer, by the issue of its
//    bounces: the keyed form moves 32 bytes in and 12 out a ray (0.06 ms
//    at the main shape's 4.9 M rays a launch), the tape form 12 D bytes
//    more, read in the order its paths take their bounces, scattered;
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
//    the caller's (fused.make_compacted_image_renderer). Past the camera,
//    where lanes enter dead (a compacted chain's [2, 5) runs 25.5% of its
//    lane-bounces live), it runs the tracer's queue with each path started
//    at its lane's state (segment_queue_trace_kernel), from the camera the
//    lockstep loop (segment_trace_kernel), the faster there;
//    drt_fused_segment_trace_lockstep, the checking build, runs the
//    lockstep loop at every launch, the bit reference;
//  - drt_earlyexit_trace replaces drt_tpu/ops/earlyexit.py:
//    make_earlyexit_tracer (pallas_call at :170), which skips the bounces
//    of a ray tile none of whose rays lives (pl.when on the tile's count).
//    Here the unit of early exit is the path: the entry point launches the
//    exact instance of drt_fused_trace's queue, which spends a trip only on
//    a live bounce, so no lane and no warp runs a bounce that no path
//    enters. Exact variant only; its radiance is the exact tracer's (and
//    the lockstep loop's) bit for bit.
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
//    tile resident across grid steps. Blocks here run in no order, so a
//    slot's chunks are summed in chunk order inside the warp that traces
//    them and the per-ray sum is written once.
//
// What bounds it: the issue rate of the SM, not device memory. Per ray it
// reads the tape (tape mode) or nothing (internal RNG) and writes 12 bytes;
// a bounce is about (9 shapes x ~25 + ~150 shading) f32 operations and 3
// sin/cos/pow, and Step 1 of PERF.md section 6 measured where a warp's
// cycles go: 69% to the nearest-hit loop (its latency-bound chain of
// shared loads, a division and a compare per shape), 18% to shade, and a
// bounce costs a warp as much whatever share of its lanes lives. The
// lockstep loop ran all max_depth bounces of every chunk for 1.94 live
// ones on the Cornell box (38.6% of its lane-bounces live); the queue
// spends a trip only on a live bounce, so its warps run 4.80 M trips
// where the lockstep loop ran 12.29 M warp-bounces at the main shape, at
// about 1.05x the cycles each (the camera ray is drawn in nearly every
// trip): 0.58x the time, and 0.11x at the CLI's default depth of 32
// (PERF.md). The collect tracer stores 8 bytes per live bounce-row after
// cudaMemsetAsync zeroes both row buffers (3.15 GB at the main shape,
// about 1 ms, which writing every row from its lane costs more than);
// its path-major rounds keep each 128-byte line's stores close in time.
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
#include "fused_queue.cuh"

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

// The hook of a step of the queue at rsc/rbest + base: StoreResidual for
// the collect tracer, NoResidual for the tracer.
template <bool COLLECT>
static __device__ __forceinline__ auto queue_hook(float* rsc, int* rbest,
                                                  size_t base, size_t n) {
  if constexpr (COLLECT)
    return StoreResidual{rsc + base, rbest + base, n};
  else
    return NoResidual{};
}

// The counters of drt_fused_trace_stats, u64: steps run by lanes and by
// warps (lockstep: every lane's bounces, warp-bounces; queue: lane-trips,
// warp-trips), of those the lanes alive after the step and the warp-steps
// with any (SectionClock::step), the cycles of each section (SEC_*), and
// (lockstep) the live lanes per warp-bounce by bounce, [max_depth][33].
enum { FS_LANE_STEPS = 0, FS_WARP_STEPS = 1, FS_LIVE_LANES = 2,
       FS_LIVE_WARPS = 3, FS_CYCLES = 4, FS_HIST = FS_CYCLES + N_SECT };

template <bool COUNT> struct MarksOf { using type = NoMarks; };
template <> struct MarksOf<true> { using type = SectionClock; };

// log2 of the ray slots a warp of the collect tracer takes per round:
// S = 2^k >= 32 slots and at least 1024 (slot, chunk) paths a round, so
// that the few paths still running when a round's last path has been
// handed out cost little.
static __host__ __device__ __forceinline__ int queue_log2_slots(int n_chunks) {
  int k = 5;
  while ((n_chunks << k) < 1024) ++k;
  return k;
}

// Words of a segment lane's entry that a warp stages (queue_trace.inc,
// DRT_QUEUE_RAYS 2): the ray and throughput, the path key and the
// roulette draw of bounce b0.
#define SEGMENT_STAGE 11

// The entry of lane i of a segment [b0, b1) of chunk `chunk` (queue_trace.inc,
// DRT_QUEUE_RAYS 2): trace_segment's (fused_body.cuh), at the camera
// (b0 == 0) or at the lane's state, with the path key of its ray slot
// (INTERNAL) and the roulette of bounce b0 decided here, where the
// lockstep loop decides it in the bounce. live: the path takes a trip;
// st (o, d, T) is read only for a live lane.
template <bool FAST, bool INTERNAL>
static __device__ __forceinline__ void segment_entry(
    const DrtTrace& cfg, const DrtCamera& cam,
    const float* __restrict__ cam_u, const float* __restrict__ ray,
    const int* __restrict__ alive_in, const int* __restrict__ ray_idx,
    int b0, int chunk, int i, SegmentQueueTape& e, float st[9],
    bool& live) {
  int pix = 0;
  uint32_t smp = 0u;
  if (b0 == 0) {
    primary_ray<FAST, INTERNAL>(cfg, cam, cam_u, i, chunk, pix, smp, st[3],
                                st[4], st[5]);
    st[0] = cam.eye[0]; st[1] = cam.eye[1]; st[2] = cam.eye[2];
    st[6] = 1.0f; st[7] = 1.0f; st[8] = 1.0f;
    live = true;
  } else {
    live = alive_in[i] > 0;
    if (!live) return;
    if (INTERNAL) {
      const int npix = cfg.width * cfg.height;
      const int r = ray_idx[i];
      pix = r % npix;
      smp = (uint32_t)(chunk * cfg.spp_c + r / npix);
    }
  }
  if (INTERNAL) e.key = path_key(cfg.seed1, (uint32_t)pix, smp);
  if (b0 >= cfg.min_bounces) {
    e.u_rr = roulette_draw<INTERNAL>(cfg, e, i, b0);
    live = !(e.u_rr < cfg.absorb);
  }
  if (!live || b0 == 0) return;
  const size_t n = (size_t)cfg.n_rays;
  for (int w = 0; w < 9; ++w) st[w] = ray[w * n + i];
}

// The end of lane i's path in a segment: its radiance and, unless the
// segment ends at max_depth (ray_out == nullptr), its exit state. A lane
// alive at b1 writes its ray and throughput st (o, d, T); a lane that
// entered dead or died before b1 writes +0 for all nine, which is what
// the lockstep loop leaves there for a finite throughput (a dead bounce
// sets o = d = 0 and T = (T 0) 1 0) and what no reader reads (compaction
// drops the lane, and the next segment's dead entry reads its alive
// alone).
static __device__ __forceinline__ void segment_exit(
    int i, int K, bool alive, float lx, float ly, float lz,
    const float st[9], float* __restrict__ out,
    float* __restrict__ ray_out, int* __restrict__ alive_out) {
  out[i] = lx;
  out[K + i] = ly;
  out[2 * K + i] = lz;
  if (ray_out == nullptr) return;
  const size_t n = (size_t)K;
  for (int w = 0; w < 9; ++w) ray_out[w * n + i] = alive ? st[w] : 0.0f;
  alive_out[i] = alive ? 1 : 0;
}

// The queue of (ray slot, chunk) paths: the loop of drt_fused_trace,
// drt_fused_collect (COLLECT), drt_earlyexit_trace and of the checking
// build drt_fused_trace_stats (COUNT), as the text of queue_trace.inc,
// which the wavefront tracer's ray_queue_kernel includes too. The grid is
// persistent, and a trip is one live bounce of every lane that has a path.
//
// A trip: the lanes whose last path has ended take their next path and
// draw its camera ray; then every lane with a path runs one bounce of it
// at its own depth, and the warp reconverges (B12's order: Step 1 in
// PERF.md section 6 found that the camera branch costs the same wherever
// a trip takes it). After the bounce the lane decides the Russian
// roulette of its next bounce (the draw is keyed, so it is the same
// number whenever it is drawn): a path ends after its last live bounce,
// by roulette, a miss or the depth bound, and the bounce it would enter
// dead, which would add P e = 0 to the radiance and store the row (0.0f,
// 0), takes no trip. A ray that hit the light stays alive with a zero
// direction (ROADMAP C.4) and takes its trips as in the lockstep loop.
//
// Who takes which path. The tracer (BY_SLOT): the lanes take the warp's
// slots in order, 32 at a time ((w + r W) 32 + [0, 32) for warp w of W),
// and a lane runs its slot's chunks itself, in chunk order, adding their
// radiance as the lockstep loop does and writing the slot's once. The
// collect tracer: its rows of one 128-byte line (32 consecutive slots of
// one chunk and bounce) must be written close together in time to fill
// in L2, and lanes that each run a slot's chunks drift apart by whole
// chunks (a lane that owned slots t, t + G, ... took B2 to 1.66x the
// lockstep loop, PERF.md section 6). So warp w takes rounds of S
// consecutive slots, w S, (w + W) S, ..., and hands a round's C S paths
// out in chunk-major order (path j is chunk j / S of slot j % S) to the
// lanes as they free up. A path's radiance goes to sums f32[C, 3,
// n_rays], and when all of a round's paths have ended the lanes add each
// slot's chunks in chunk order from 0 and write the slot's radiance (with
// one chunk the path writes 0 + l itself).
//
// The bits: a path runs the statements of fused_bounce.inc in the order of
// its bounces, and a slot's radiance is the lockstep loop's sum, so every
// output is the lockstep loop's bit for bit.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
queue_trace_kernel(DrtTrace cfg, DrtCamera cam,
                   const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ cam_u,
                   const float* __restrict__ tape, float* __restrict__ out,
                   float* __restrict__ sums, float* __restrict__ rsc,
                   int* __restrict__ rbest, int* __restrict__ trips,
                   unsigned long long* stats) {
#define DRT_QUEUE_RAYS 0
#include "queue_trace.inc"
#undef DRT_QUEUE_RAYS
}
#undef DRT_MARK
#define DRT_MARK(k)

// The lockstep loop: one thread per ray slot runs all max_depth bounces of
// each of its chunks, live or not. The checking builds
// drt_fused_trace_lockstep and drt_fused_collect_lockstep (COLLECT), and,
// with COUNT, drt_fused_trace_stats's lockstep form, which times each
// section of a bounce (SectionClock), counts the bounces into stats and
// the live lanes per warp-bounce by bounce into stats + FS_HIST.
template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
fused_trace_kernel(DrtTrace cfg, DrtCamera cam,
                   const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ cam_u,
                   const float* __restrict__ tape,
                   float* __restrict__ out,
                   float* __restrict__ rsc, int* __restrict__ rbest,
                   unsigned long long* stats) {
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.n_rays;
  if (i >= N) return;
  typename MarksOf<COUNT>::type marks;
  if constexpr (COUNT) marks.start(stats + FS_HIST);

  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    float lx, ly, lz;
    if constexpr (COLLECT) {
      const size_t base = (size_t)c * cfg.max_depth * N + i;
      StoreResidual hook{rsc + base, rbest + base, (size_t)N};
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz, marks);
    } else {
      NoResidual hook;
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz, marks);
    }
    Lx = Lx + lx;
    Ly = Ly + ly;
    Lz = Lz + lz;
  }
  out[i] = Lx;
  out[N + i] = Ly;
  out[2 * N + i] = Lz;
  if constexpr (COUNT) {
    marks.flush(stats + FS_CYCLES);
    marks.flush_steps(stats + FS_LANE_STEPS);
  }
}

// The wavefront tracer B5a on the queue (drt_ray_trace and
// drt_ray_trace_keyed): the loop of queue_trace_kernel with one chunk, the
// per-slot hand-out and each path started at its input ray
// (DRT_QUEUE_RAYS). Instantiated with FAST = COLLECT = COUNT = false
// only.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
ray_queue_kernel(DrtTrace cfg, const float* __restrict__ scene,
                 const float* __restrict__ alb,
                 const float* __restrict__ emi,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const int* __restrict__ pix_in,
                 const int* __restrict__ smp_in,
                 const float* __restrict__ tape, float* __restrict__ out) {
  float* sums = nullptr;
  float* rsc = nullptr;
  int* rbest = nullptr;
  int* trips = nullptr;
  unsigned long long* stats = nullptr;
#define DRT_QUEUE_RAYS 1
#include "queue_trace.inc"
#undef DRT_QUEUE_RAYS
}
#undef DRT_MARK
#define DRT_MARK(k)

// The wavefront tracer's lockstep loop, the checking build
// drt_ray_trace_lockstep: one thread per ray runs all max_depth bounces.
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

// The segment tracer B1-seg on the queue (drt_fused_segment_trace where
// segment_trace_takes_queue): the loop of queue_trace_kernel with one
// chunk, each path started at bounce b0 of its lane and stopped at b1, the
// lanes read 32 at a time by a warp and their live entries staged in
// seg_stage and dealt to its idle threads (DRT_QUEUE_RAYS 2).
// Instantiated with COLLECT = COUNT = false only.
//
// The bits: a live path runs the statements of fused_bounce.inc in the
// order of its bounces, from the entry the lockstep loop (trace_segment)
// starts from, with the same draws; the bounces it does not run are those
// the lockstep loop runs dead, which add P e = +0 to a radiance that is
// never -0 and leave the state at +0 (segment_exit). So the radiance, the
// alive flag and the exit state of every lane alive at b1 are the lockstep
// loop's bit for bit, and so is the rest for any finite throughput.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_queue_trace_kernel(DrtTrace cfg, DrtCamera cam, int b0, int b1,
                           int chunk, const float* __restrict__ scene,
                           const float* __restrict__ alb,
                           const float* __restrict__ emi,
                           const float* __restrict__ cam_u,
                           const float* __restrict__ tape,
                           const float* __restrict__ ray,
                           const int* __restrict__ alive_in,
                           const int* __restrict__ ray_idx,
                           float* __restrict__ out,
                           float* __restrict__ ray_out,
                           int* __restrict__ alive_out) {
  __shared__ float seg_stage[(DRT_BLOCK / 32) * SEGMENT_STAGE * 32];
  float* sums = nullptr;
  float* rsc = nullptr;
  int* rbest = nullptr;
  int* trips = nullptr;
  unsigned long long* stats = nullptr;
#define DRT_QUEUE_RAYS 2
#include "queue_trace.inc"
#undef DRT_QUEUE_RAYS
}
#undef DRT_MARK
#define DRT_MARK(k)

// Whether drt_fused_segment_trace runs the queue for a segment from
// b_start, else the lockstep loop (segment_trace_kernel). From the camera
// every lane enters live, and there the queue took 1.7x the lockstep
// loop's time on a chunk of the main shape (PERF.md section 6).
static bool segment_trace_takes_queue(int b_start) { return b_start > 0; }

template <bool COLLECT>
static int launch_lockstep(const DrtTrace* cfg, const DrtCamera* cam,
                  const float* scene, const float* alb, const float* emi,
                  const float* cam_u, const float* tape, float* out,
                  float* rsc, int* rbest, void* stream) {
  if (!drt_cfg_ok(cfg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, I)                                                  \
  fused_trace_kernel<F, I, COLLECT, false><<<grid, DRT_BLOCK, 0, s>>>(    \
      *cfg, *cam, scene, alb, emi, cam_u, tape, out, rsc, rbest, nullptr)
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

template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
static int launch_queue(const DrtTrace* cfg, const DrtCamera* cam,
                        const float* scene, const float* alb,
                        const float* emi, const float* cam_u,
                        const float* tape, float* out, float* sums,
                        float* rsc, int* rbest, int* trips,
                        unsigned long long* stats, cudaStream_t s) {
  if (COLLECT && cfg->n_chunks > 1 && sums == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kernel = queue_trace_kernel<FAST, INTERNAL, COLLECT, COUNT>;
  const int S = COLLECT ? 1 << queue_log2_slots(cfg->n_chunks) : 32;
  int grid = 0;
  cudaError_t e = queue_grid(kernel, (cfg->n_rays + S - 1) / S * 32, &grid);
  if (e != cudaSuccess) return (int)e;
  if (COLLECT) {  // the rows of the bounces no path enters
    const size_t bytes = (size_t)cfg->n_chunks * cfg->max_depth *
                         cfg->n_rays * sizeof(float);
    e = cudaMemsetAsync(rsc, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(rbest, 0, bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, DRT_BLOCK, 0, s>>>(*cfg, *cam, scene, alb, emi, cam_u, tape,
                                    out, sums, rsc, rbest, trips, stats);
  return (int)cudaGetLastError();
}

template <bool INTERNAL>
static int launch_rays(const DrtTrace* cfg, const float* scene,
                       const float* alb, const float* emi, const float* o,
                       const float* d, const int* pix, const int* smp,
                       const float* tape, float* out, cudaStream_t s) {
  auto kernel = ray_queue_kernel<false, INTERNAL, false, false>;
  int grid = 0;
  cudaError_t e = queue_grid(kernel, (cfg->n_rays + 31) / 32 * 32, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, DRT_BLOCK, 0, s>>>(*cfg, scene, alb, emi, o, d, pix, smp,
                                    tape, out);
  return (int)cudaGetLastError();
}

template <bool COLLECT>
static int launch(const DrtTrace* cfg, const DrtCamera* cam,
                  const float* scene, const float* alb, const float* emi,
                  const float* cam_u, const float* tape, float* out,
                  float* sums, float* rsc, int* rbest, void* stream) {
  if (!drt_cfg_ok(cfg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DRT_LAUNCH(F, I)                                                  \
  return launch_queue<F, I, COLLECT, false>(cfg, cam, scene, alb, emi,     \
                                            cam_u, tape, out, sums, rsc,   \
                                            rbest, nullptr, nullptr, s)
  if (cfg->fast) {
    if (cfg->internal_rng) DRT_LAUNCH(true, true);
    else DRT_LAUNCH(true, false);
  } else {
    if (cfg->internal_rng) DRT_LAUNCH(false, true);
    else DRT_LAUNCH(false, false);
  }
#undef DRT_LAUNCH
}

extern "C" {

int drt_limits(int* max_shapes, int* max_rows, int* rec, int* n_stats) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *n_stats = FS_HIST;
  return 0;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). Shapes and types are checked by the Python wrappers.
int drt_fused_trace(const DrtTrace* cfg, const DrtCamera* cam,
                    const float* scene, const float* alb, const float* emi,
                    const float* cam_u, const float* tape, float* out,
                    void* stream) {
  return launch<false>(cfg, cam, scene, alb, emi, cam_u, tape, out, nullptr,
                   nullptr, nullptr, stream);
}

// The collect tracer's queue needs sums f32[n_chunks, 3, n_rays] as
// scratch when n_chunks > 1 (nullptr otherwise).

int drt_fused_collect(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      const float* cam_u, const float* tape, float* out,
                      float* sums, float* rsc, int* rbest, void* stream) {
  return launch<true>(cfg, cam, scene, alb, emi, cam_u, tape, out, sums, rsc,
                   rbest, stream);
}

// The checking builds of the lockstep loop (one thread per ray slot, all
// max_depth bounces of each chunk), the bit reference of the two above.
int drt_fused_trace_lockstep(const DrtTrace* cfg, const DrtCamera* cam,
                             const float* scene, const float* alb,
                             const float* emi, const float* cam_u,
                             const float* tape, float* out, void* stream) {
  return launch_lockstep<false>(cfg, cam, scene, alb, emi, cam_u, tape, out,
                                nullptr, nullptr, stream);
}

int drt_fused_collect_lockstep(const DrtTrace* cfg, const DrtCamera* cam,
                               const float* scene, const float* alb,
                               const float* emi, const float* cam_u,
                               const float* tape, float* out, float* rsc,
                               int* rbest, void* stream) {
  return launch_lockstep<true>(cfg, cam, scene, alb, emi, cam_u, tape, out,
                               rsc, rbest, stream);
}

// The timing and counting build, internal RNG: the queue (queue != 0),
// which also adds each slot's lane-trips into trips i32[n_rays], or the
// lockstep loop (trips and sums unused); the collect tracer's stores when
// rsc and rbest are given. Adds its counters (FS_*) into stats
// u64[FS_HIST + 33 * max_depth]; the caller zeroes trips and stats.
int drt_fused_trace_stats(const DrtTrace* cfg, const DrtCamera* cam,
                          const float* scene, const float* alb,
                          const float* emi, float* out, float* sums,
                          float* rsc, int* rbest, int* trips,
                          unsigned long long* stats, int queue,
                          void* stream) {
  if (!drt_cfg_ok(cfg) || !cfg->internal_rng || (queue && !trips) ||
      !stats || (rsc == nullptr) != (rbest == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool collect = rsc != nullptr;
  if (queue) {
#define DRT_LAUNCH(F, C)                                                  \
  return launch_queue<F, true, C, true>(cfg, cam, scene, alb, emi, nullptr, \
                                        nullptr, out, sums, rsc, rbest,   \
                                        trips, stats, s)
    if (cfg->fast) {
      if (collect) DRT_LAUNCH(true, true);
      DRT_LAUNCH(true, false);
    }
    if (collect) DRT_LAUNCH(false, true);
    DRT_LAUNCH(false, false);
#undef DRT_LAUNCH
  }
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, C)                                                  \
  fused_trace_kernel<F, true, C, true><<<grid, DRT_BLOCK, 0, s>>>(        \
      *cfg, *cam, scene, alb, emi, nullptr, nullptr, out, rsc, rbest, stats)
  if (cfg->fast) {
    if (collect) DRT_LAUNCH(true, true);
    else DRT_LAUNCH(true, false);
  } else {
    if (collect) DRT_LAUNCH(false, true);
    else DRT_LAUNCH(false, false);
  }
#undef DRT_LAUNCH
  return (int)cudaGetLastError();
}

// The wavefront tracer takes one chunk of rays and the exact variant, and
// its tape form a tape (cfg->internal_rng == 0), its keyed form the pixel
// and sample i32[n_rays] of each ray (cfg->internal_rng == 1, seed1 the
// bounce seed): a config asking for anything else is refused.
int drt_ray_trace(const DrtTrace* cfg, const float* scene, const float* alb,
                  const float* emi, const float* o, const float* d,
                  const float* tape, float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || cfg->internal_rng ||
      cfg->fast)
    return (int)cudaErrorInvalidValue;
  return launch_rays<false>(cfg, scene, alb, emi, o, d, nullptr, nullptr,
                            tape, out, (cudaStream_t)stream);
}

int drt_ray_trace_keyed(const DrtTrace* cfg, const float* scene,
                        const float* alb, const float* emi, const float* o,
                        const float* d, const int* pix, const int* smp,
                        float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || !cfg->internal_rng ||
      cfg->fast || !pix || !smp)
    return (int)cudaErrorInvalidValue;
  return launch_rays<true>(cfg, scene, alb, emi, o, d, pix, smp, nullptr,
                           out, (cudaStream_t)stream);
}

// The checking build of the wavefront tracer's lockstep loop (tape form),
// the bit reference of both forms above.
int drt_ray_trace_lockstep(const DrtTrace* cfg, const float* scene,
                           const float* alb, const float* emi,
                           const float* o, const float* d, const float* tape,
                           float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || cfg->internal_rng ||
      cfg->fast)
    return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  ray_trace_kernel<<<grid, DRT_BLOCK, 0, (cudaStream_t)stream>>>(
      *cfg, scene, alb, emi, o, d, tape, out);
  return (int)cudaGetLastError();
}

// Bounces [b_start, b_end) of chunk `chunk` over cfg->n_rays lanes, in
// the loop segment_trace_takes_queue picks (lockstep != 0: the lockstep
// loop). The camera's uniforms (tape mode) are read iff b_start == 0, the
// state (ray, alive) iff b_start > 0, ray_idx iff b_start > 0 with the
// internal RNG; the exit state is written iff b_end < max_depth. The tape
// is f32[b_end - b_start, 3, n_rays].
static int segment_trace(const DrtTrace* cfg, const DrtCamera* cam,
                         int b_start, int b_end, int chunk,
                         const float* scene, const float* alb,
                         const float* emi, const float* cam_u,
                         const float* tape, const float* ray,
                         const int* alive, const int* ray_idx, float* out,
                         float* ray_out, int* alive_out, int lockstep,
                         void* stream) {
  const bool entry = b_start == 0, final = b_end == cfg->max_depth;
  if (!drt_cfg_ok(cfg) || cfg->n_chunks != 1 || b_start < 0 ||
      b_end <= b_start || b_end > cfg->max_depth || chunk < 0 ||
      (!cfg->internal_rng && (tape == nullptr || (entry && !cam_u))) ||
      (!entry && (!ray || !alive || (cfg->internal_rng && !ray_idx))) ||
      (!final && (!ray_out || !alive_out)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* ro = final ? nullptr : ray_out;
  const bool queue = !lockstep && segment_trace_takes_queue(b_start);
  int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, I)                                                  \
  if (queue) {                                                            \
    auto kernel = segment_queue_trace_kernel<F, I, false, false>;         \
    const cudaError_t e =                                                 \
        queue_grid(kernel, (cfg->n_rays + 31) / 32 * 32, &grid);          \
    if (e != cudaSuccess) return (int)e;                                  \
    kernel<<<grid, DRT_BLOCK, 0, s>>>(                                    \
        *cfg, *cam, b_start, b_end, chunk, scene, alb, emi, cam_u, tape,  \
        ray, alive, ray_idx, out, ro, alive_out);                         \
  } else {                                                                \
    segment_trace_kernel<F, I><<<grid, DRT_BLOCK, 0, s>>>(                \
        *cfg, *cam, b_start, b_end, chunk, scene, alb, emi, cam_u, tape,  \
        ray, alive, ray_idx, out, ro, alive_out);                         \
  }
  if (cfg->fast) {
    if (cfg->internal_rng) { DRT_LAUNCH(true, true) }
    else { DRT_LAUNCH(true, false) }
  } else {
    if (cfg->internal_rng) { DRT_LAUNCH(false, true) }
    else { DRT_LAUNCH(false, false) }
  }
#undef DRT_LAUNCH
  return (int)cudaGetLastError();
}

int drt_fused_segment_trace(const DrtTrace* cfg, const DrtCamera* cam,
                            int b_start, int b_end, int chunk,
                            const float* scene, const float* alb,
                            const float* emi, const float* cam_u,
                            const float* tape, const float* ray,
                            const int* alive, const int* ray_idx, float* out,
                            float* ray_out, int* alive_out, void* stream) {
  return segment_trace(cfg, cam, b_start, b_end, chunk, scene, alb, emi,
                       cam_u, tape, ray, alive, ray_idx, out, ray_out,
                       alive_out, 0, stream);
}

// The checking build of the lockstep loop at every launch (one thread per
// lane, every bounce of the segment), the bit reference of
// drt_fused_segment_trace's queue.
int drt_fused_segment_trace_lockstep(const DrtTrace* cfg,
                                     const DrtCamera* cam, int b_start,
                                     int b_end, int chunk, const float* scene,
                                     const float* alb, const float* emi,
                                     const float* cam_u, const float* tape,
                                     const float* ray, const int* alive,
                                     const int* ray_idx, float* out,
                                     float* ray_out, int* alive_out,
                                     void* stream) {
  return segment_trace(cfg, cam, b_start, b_end, chunk, scene, alb, emi,
                       cam_u, tape, ray, alive, ray_idx, out, ray_out,
                       alive_out, 1, stream);
}

// Whether drt_fused_segment_trace runs the queue (*queue = 1) or the
// lockstep loop (0) for a segment from b_start, for its checks.
int drt_fused_segment_trace_form(int b_start, int* queue) {
  *queue = segment_trace_takes_queue(b_start) ? 1 : 0;
  return 0;
}

// The early-exit tracer: drt_fused_trace's call, exact variant only, on
// the queue (the unit of early exit is the path).
int drt_earlyexit_trace(const DrtTrace* cfg, const DrtCamera* cam,
                        const float* scene, const float* alb,
                        const float* emi, const float* cam_u,
                        const float* tape, float* out, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->fast) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cfg->internal_rng)
    return launch_queue<false, true, false, false>(
        cfg, cam, scene, alb, emi, cam_u, tape, out, nullptr, nullptr,
        nullptr, nullptr, nullptr, s);
  return launch_queue<false, false, false, false>(
      cfg, cam, scene, alb, emi, cam_u, tape, out, nullptr, nullptr, nullptr,
      nullptr, nullptr, s);
}

const char* drt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
