// Radiative-backprop adjoints of the fused tracer for Hopper (sm_90a):
// parameter gradients (d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of
// sum_rays g . L from a per-ray (or per-pixel) cotangent g.
//
//  - drt_fused_sweep replaces drt_tpu/ops/megakernel.py:
//    make_fused_sweep_adjoint (pallas_call at :1483): from the residuals
//    (rsc, rbest) that the collect tracer of fused_tracer.cu stored, it
//    replays gate_b = rr_b [best_b > 0], P_b = T_{b-1} gate_b,
//    T_b = P_b a_b sc_b in the forward's op order (megakernel.py:1421-1440)
//    and runs the reverse sweep, over each slot's rows up to its first
//    dead row. No geometry is touched. Its body, a persistent grid with a
//    ring of rows in shared memory, is sweep_rows.cuh, shared with the dyn
//    family's sweep.
//  - drt_fused_adjoint replaces megakernel.py:make_fused_segment_adjoint
//    (pallas_call at :1672, behind make_fused_adjoint) at b_start = 0,
//    b_end = max_depth: it retraces the forward with the bounce body of
//    fused_body.cuh on the queue of (ray slot, chunk) paths, keeping P, sc,
//    gate and best of every live bounce in the thread, and sweeps each
//    path back when it ends (queue_adjoint_kernel below). Unbiased mode
//    calls it with a salted bounce seed. Its checking build
//    drt_fused_adjoint_lockstep runs the lockstep loop (one thread per ray
//    slot, all max_depth bounces of each chunk, then the 32-row sweep) and
//    is its bit reference; drt_fused_adjoint_stats times either loop.
//  - drt_ray_adjoint replaces megakernel.py:make_pallas_adjoint
//    (pallas_call at :966), the backward of the key-driven wavefront: the
//    retrace of drt_ray_trace (fused_tracer.cu) on the input rays o, d and
//    tape, the reverse sweep with a per-ray cotangent g f32[3, N] and the
//    reduction; trace_rays(collect=True) + adjoint._param_grads as one
//    kernel. It runs B4's queue, sweep and accumulation on a ray read
//    from memory where B4 makes it from the camera, so on B4's own rays,
//    tape and cotangent its tables are B4's bit for bit. Exact variant,
//    built for 32 bounces like B4; bound like B4 (it reads 96 bytes per
//    ray at depth 5, 0.14 ms of the card's memory rate at 4.9 M rays).
//    drt_ray_adjoint_lockstep is its lockstep checking build.
//  - drt_fused_segment_adjoint replaces make_fused_segment_adjoint at any
//    [b_start, b_end): the segment of drt_fused_segment_trace
//    (fused_tracer.cu) retraced from the camera or its entry state, its
//    bounces kept per thread by segment-local bounce, then the reverse
//    sweep seeded by the next segment's S at its entry (S_end, zero for
//    the last segment), which writes S at this segment's entry (S_start)
//    when b_start > 0: S_b = gate_b (e_b + w_b S_{b+1})
//    (megakernel.py:_reverse_sweep). The gradients go through the same
//    accumulator routines as B4's. Bound like B4; the state, g, S_end and
//    S_start add 68 bytes per lane at most.
//
// The reverse sweep (megakernel.py:_reverse_sweep, :611-637), per ray slot
// and chunk, from the last bounce to the first, with S = 0 to start:
//   d_emission[erow_b] += g P_b            (real rows only)
//   d_albedo[arow_b]   += (g P_b) sc_b S   (real rows only)
//   S = (e_b + a_b sc_b S) gate_b
//
// How the TPU design maps here:
//  - The gradient tables are accumulated without float atomics, by the
//    routines of grad_accum.cuh (one shared-memory column per thread, a
//    fixed-order block reduction, per-block partials, a second kernel).
//    Both adjoint kernels use the same block size, the same ray -> block
//    map, the same chunk order and these same routines, so for equal
//    residuals their gradients are equal bit for bit.
//  - The accumulator takes (K + L) x 3 x 512 bytes: 6 KB for the Cornell
//    box, 189 KB at the 63 + 63 real rows the tables can hold, which fits
//    a block's 227 KB beside the 10 KB of tables (one block per SM then).
//  - The queue (B4, B5b). The lockstep loop ran every bounce of every
//    chunk, live or not, and swept all 32 rows (PERF.md section 6: at the
//    Cornell box's 1.93 live bounces of 5, a warp-bounce cost 9205
//    cycles, 1277 of them the sweep). The queue hands out slots as the
//    tracer's queue does (fused_tracer.cu: queue_trace_kernel, BY_SLOT),
//    spends a trip only on a live bounce, and sweeps only the rows of the
//    trips a path took. A lane holds many slots in turn, so it cannot sum
//    them all into its column and keep the lockstep loop's order: after a
//    slot's last chunk it writes its column to the slot's row of slot_acc
//    f32[n_rays, E'] (E = n_entries, E' = E rounded up to 4, so that a
//    row goes out in 16-byte stores) and zeroes it, and
//    slot_reduce_kernel sums each 128 slots with block_reduce_write into
//    the lockstep loop's partials. slot_acc takes 4 E' n_rays bytes: 236
//    MB at the Cornell box's main shape (E = 12, 4,915,200 slots),
//    written once and read once (about 0.14 ms at 3.35 TB/s); 7.5 GB at
//    the 63 + 63 rows the tables can hold (E = 378, E' = 380). With one
//    chunk (B5b, the CLI's shape) a slot's column is one path's and
//    mostly +0: the scratch is zeroed first (one coalesced pass) and the
//    flush skips a 16-byte word of +0, which took B5b from 1.34 to 0.91
//    ms a chunk (PERF.md section 6); with more the column is dense and
//    written whole.
//    The bits: a path's live rows are the lockstep loop's rows, made by
//    the same statements in the same order. The rows the queue skips are
//    dead (best = 0, gate = 0, sc = 0), add nothing to a column and leave
//    S at +0 from +0, so the sweep from the last trip's row with S = +0
//    adds what the lockstep sweep adds, in its order; each slot's column
//    starts at +0 and takes its chunks in chunk order; and the group and
//    final sums keep their order. So B4 is its lockstep build, and
//    fused_sweep of the collect tracer's rows, bit for bit.
//    The queue's loop is its own, not the tracer's kernel made generic:
//    that kernel keeps its text, so B1's and B2's ptxas reports and bits
//    stay as they are (a routine boundary in that loop once cost B1 3%,
//    PERF.md section 6); the pieces they share are in fused_queue.cuh.
//  - max_depth is a run-time value. The sweep adjoint keeps the first 8
//    rows of a slot's chunk in registers and reads later rows one by one
//    into local memory (built once for max_depth <= 8, once beyond). The
//    retrace adjoint indexes its arrays by the bounce counter of the
//    shared body, so they live in local memory and it is built for
//    DRT_MAX_DEPTH = 32. Deeper paths are refused.
//
// What bounds them: the sweep adjoint is bound by device memory. It reads
// at most 8 bytes per bounce-ray once (3.15 GB at 640x480x256 spp, depth
// 5; the rows before each slot's first dead row, 1.50 GB of them, are
// what it needs) and does about 20 f32 operations per live bounce-ray, an
// order of magnitude below what the card can do in the time the read
// takes; the ray slot is the fastest index, so a warp reads whole
// 128-byte lines (sweep_rows.cuh says how it keeps them in flight). The
// retrace adjoint
// is bound like the tracer, by f32 and special-function issue and warp
// divergence; the sweep adds a few percent to its work.

#include "fused_body.cuh"
#include "fused_queue.cuh"
#include "grad_accum.cuh"
#include "sweep_rows.cuh"

#define DRT_MAX_DEPTH 32

// Per-bounce values of one ray slot in one chunk.
struct Residuals {
  float P[DRT_MAX_DEPTH][3];
  float sc[DRT_MAX_DEPTH];
  float gate[DRT_MAX_DEPTH];
  int best[DRT_MAX_DEPTH];
};

// The hook of the retrace adjoint.
struct KeepResidual {
  Residuals& r;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float gate,
                                             int best) const {
    r.P[b][0] = Px; r.P[b][1] = Py; r.P[b][2] = Pz;
    r.sc[b] = sc;
    r.gate[b] = gate;
    r.best[b] = best;
  }
};

// Reverse sweep of one ray slot's chunk into the thread's accumulator
// column `acc` (entry e lives at acc[e * DRT_BLOCK]).
static __device__ __forceinline__ void reverse_sweep(
    const DrtTrace& cfg, const DrtTables& tab, const Residuals& r,
    float gx, float gy, float gz, float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  const float g[3] = {gx, gy, gz};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
#pragma unroll
  for (int b = DRT_MAX_DEPTH - 1; b >= 0; --b) {
    if (b >= cfg.max_depth) continue;
    const int best = r.best[b];
    float e[3] = {0.0f, 0.0f, 0.0f};
    float a[3] = {1.0f, 1.0f, 1.0f};
    int erow = -1, arow = -1;
    if (best > 0) {
      const float* rec = tab.scene + (best - 1) * DRT_REC;
      const int er = (int)rec[R_EMI];
      if (er < cfg.n_emi - 1) {
        erow = er;
        e[0] = tab.emi[er * 3 + 0];
        e[1] = tab.emi[er * 3 + 1];
        e[2] = tab.emi[er * 3 + 2];
      }
      const int ar = (int)rec[R_ALB];
      if (ar < cfg.n_alb - 1) {
        arow = ar;
        a[0] = tab.alb[ar * 3 + 0];
        a[1] = tab.alb[ar * 3 + 1];
        a[2] = tab.alb[ar * 3 + 2];
      }
    }
    sweep_bounce(acc, acc_e, arow, erow, a, e, r.P[b], r.sc[b], r.gate[b],
                 g, S);
  }
}

// The sections of the adjoints' timing build beyond those of a bounce
// (SEC_*, drt_common.cuh): the reverse sweep of a path's rows into the
// accumulator column, and the block reduction into the partials.
enum { SEC_SWEEP = N_SECT, SEC_REDUCE = N_SECT + 1, N_ADJ_SECT = N_SECT + 2 };
using AdjointClock = SectionClockOf<N_ADJ_SECT>;
// Its counters, u64: the step counts of SectionClock::step (lane- and
// warp-bounces, the lanes alive after them, the warp-bounces with any),
// then the cycles of each section.
enum { AS_STEPS = 0, AS_CYCLES = 4, AS_END = AS_CYCLES + N_ADJ_SECT };

template <bool COUNT> struct AdjointMarksOf { using type = NoMarks; };
template <> struct AdjointMarksOf<true> { using type = AdjointClock; };

// The sweep's tables: the row code (sweep_rows.cuh:sweep_code) of each
// shape by best = shape + 1, 0 for best = 0 (a dead lane), and the albedo
// and emission tables.
struct FusedSweepTables {
  int code[DRT_MAX_SHAPES + 1];
  float alb[DRT_MAX_ROWS * 3];
  float emi[DRT_MAX_ROWS * 3];
};

struct FusedSweepDecode {
  const int* code;
  __device__ __forceinline__ int operator()(int best) const {
    return code[best];
  }
};

// B3: the body of sweep_rows.cuh on the scene-table residuals (rsc,
// rbest). TAIL: max_depth > SWEEP_HEAD; RING: the rows come through the
// ring of `stages` items, else through registers (launch_sweep chooses).
template <bool TAIL, bool RING>
__global__ void __launch_bounds__(DRT_BLOCK, SWEEP_MIN_BLOCKS)
fused_sweep_kernel(DrtTrace cfg, const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ rsc,
                   const int* __restrict__ rbest,
                   const float* __restrict__ g, int g_n, int stages,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ FusedSweepTables tab;
  for (int k = threadIdx.x; k <= cfg.n_shapes; k += blockDim.x) {
    int code = 0;
    if (k > 0) {
      const float* rec = scene + (k - 1) * DRT_REC;
      code = sweep_code((int)rec[R_ALB], (int)rec[R_EMI], cfg.n_alb,
                        cfg.n_emi);
    }
    tab.code[k] = code;
  }
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    tab.alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    tab.emi[k] = emi[k];
  __syncthreads();
  sweep_groups<TAIL, RING>(
      cfg, FusedSweepDecode{tab.code}, tab.alb, tab.emi, rsc, rbest, g, g_n,
      stages, s_acc, partials);
}

// The lockstep loop: one thread per ray slot runs all max_depth bounces
// of each of its chunks, live or not, then the 32-row sweep. The checking
// build drt_fused_adjoint_lockstep and, with COUNT, the lockstep form of
// drt_fused_adjoint_stats, which times each section of a bounce, the
// sweep after each chunk and the block reduction (AdjointClock).
template <bool FAST, bool INTERNAL, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
fused_adjoint_kernel(DrtTrace cfg, DrtCamera cam,
                     const float* __restrict__ scene,
                     const float* __restrict__ alb,
                     const float* __restrict__ emi,
                     const float* __restrict__ cam_u,
                     const float* __restrict__ tape,
                     const float* __restrict__ g, int g_n,
                     float* __restrict__ partials,
                     unsigned long long* stats) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);
  typename AdjointMarksOf<COUNT>::type marks;
  if constexpr (COUNT) marks.start(nullptr);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cfg.n_rays) {
    const int gi = i % g_n;
    const float gx = g[gi], gy = g[g_n + gi], gz = g[2 * g_n + gi];
    for (int c = 0; c < cfg.n_chunks; ++c) {
      Residuals r;
      KeepResidual hook{r};
      float lx, ly, lz;
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz, marks);
      reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);
      marks.at(SEC_SWEEP, 0, true);
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
  marks.at(SEC_REDUCE, 0, true);
  if constexpr (COUNT) {
    marks.flush(stats + AS_CYCLES);
    marks.flush_steps(stats + AS_STEPS);
  }
}

__global__ void __launch_bounds__(DRT_BLOCK)
ray_adjoint_kernel(DrtTrace cfg, const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tape,
                   const float* __restrict__ g,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.n_rays;
  if (i < N) {
    Residuals r;
    KeepResidual hook{r};
    float lx, ly, lz;
    trace_ray(cfg, tab, o, d, tape, i, hook, lx, ly, lz);
    reverse_sweep(cfg, tab, r, g[i], g[N + i], g[2 * N + i],
                  s_acc + threadIdx.x);
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

// The rows of a queue lane's path: P and sc of bounce b in one 16-byte
// word of local memory and best beside it, written by the bounce's hook;
// the sweep derives gate, which the bounce set to its roulette scale where
// best > 0 and to 0 elsewhere.
struct PathRows {
  float4 Psc[DRT_MAX_DEPTH];
  int best[DRT_MAX_DEPTH];
};

struct KeepPathRow {
  PathRows& r;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float,
                                             int best) const {
    r.Psc[b] = make_float4(Px, Py, Pz, sc);
    r.best[b] = best;
  }
};

// reverse_sweep over the n rows of a path, from its last with S = 0, with
// a run-time loop: the same statements on the same values, row for row.
static __device__ __forceinline__ void sweep_path(const DrtTrace& cfg,
                                                  const DrtTables& tab,
                                                  const PathRows& r, int n,
                                                  const float g[3],
                                                  float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  for (int b = n - 1; b >= 0; --b) {
    const float4 Psc = r.Psc[b];
    const int best = r.best[b];
    float e[3] = {0.0f, 0.0f, 0.0f};
    float a[3] = {1.0f, 1.0f, 1.0f};
    int erow = -1, arow = -1;
    if (best > 0) {
      const float* rec = tab.scene + (best - 1) * DRT_REC;
      const int er = (int)rec[R_EMI];
      if (er < cfg.n_emi - 1) {
        erow = er;
        e[0] = tab.emi[er * 3 + 0];
        e[1] = tab.emi[er * 3 + 1];
        e[2] = tab.emi[er * 3 + 2];
      }
      const int ar = (int)rec[R_ALB];
      if (ar < cfg.n_alb - 1) {
        arow = ar;
        a[0] = tab.alb[ar * 3 + 0];
        a[1] = tab.alb[ar * 3 + 1];
        a[2] = tab.alb[ar * 3 + 2];
      }
    }
    const float gate =
        best > 0 ? (b >= cfg.min_bounces ? cfg.inv_keep : 1.0f) : 0.0f;
    const float P[3] = {Psc.x, Psc.y, Psc.z};
    sweep_bounce(acc, acc_e, arow, erow, a, e, P, Psc.w, gate, g, S);
  }
}

// The queue's scratch slot_acc f32[n_rays, slot_stride(E)]: a row per ray
// slot of its E accumulator entries, padded to a multiple of 4 floats so
// that a lane writes its slot's row in 16-byte stores.
static __host__ __device__ __forceinline__ int slot_stride(int E) {
  return (E + 3) & ~3;
}

// The queue of the retrace adjoint (drt_fused_adjoint), of the wavefront
// adjoint (drt_ray_adjoint, RAYS: the path starts from o, d at its slot
// where B4's draws a camera ray) and, with COUNT, of the timing build. The
// slots are handed out as in the tracer's queue (queue_trace_kernel,
// BY_SLOT): a persistent grid, the warp's slots to its lanes in order, 32
// at a time ((w + r W) 32 + [0, 32) for warp w of W), and each lane runs
// its slot's chunks in chunk order, one live bounce a trip, deciding the
// roulette of the next bounce after each trip. The lane keeps its path's
// rows (P, sc, best at row bnc, KeepPathRow) in local memory; when the
// path ends it sweeps them from its last trip down to row 0 into its
// accumulator column (sweep_path), and after the slot's last chunk it
// writes the column to the slot's row of slot_acc and zeroes it.
// slot_reduce_kernel then sums each 128 slots with block_reduce_write
// into the partials of the lockstep loop's ray -> block map.
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, bool RAYS, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
queue_adjoint_kernel(DrtTrace cfg, DrtCamera cam,
                     const float* __restrict__ scene,
                     const float* __restrict__ alb,
                     const float* __restrict__ emi,
                     const float* __restrict__ cam_u,
                     const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tape,
                     const float* __restrict__ g, int g_n,
                     float* __restrict__ slot_acc,
                     unsigned long long* stats) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);
  float* acc = s_acc + threadIdx.x;
  const float RAY_EPS_F = 1e-3f;
  const float* s_scene = tab.scene;
  const float* s_alb = tab.alb;
  const float* s_emi = tab.emi;

  const int N = cfg.n_rays, D = cfg.max_depth, C = cfg.n_chunks;
  const int E = n_entries(cfg.n_alb, cfg.n_emi);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int W = (gridDim.x * blockDim.x) >> 5;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int next = 0;  // the warp's slots handed out
  int i = 0, c = 0, bnc = 0, pix = 0;
  uint32_t smp = 0u;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float Tx = 0.0f, Ty = 0.0f, Tz = 0.0f;
  float lx = 0.0f, ly = 0.0f, lz = 0.0f;
  float gv[3] = {0.0f, 0.0f, 0.0f};  // the slot's cotangent
  bool work = false, alive = false;
  bool open = false;  // the lane holds a slot with chunks left
  QueueTape qt{tape, 0u, 0.0f};
  PathRows rows;  // the rows of the lane's path
  KeepPathRow hook{rows};
  typename AdjointMarksOf<COUNT>::type marks;
  if constexpr (COUNT) marks.start(nullptr);

  while (true) {
    marks.at(SEC_LOOP, bnc, alive);
    // The warp's next slot to each lane that has finished its slot.
    const unsigned idle = __ballot_sync(0xffffffffu, !open);
    const int q = next + __popc(idle & below);
    next += __popc(idle);
    if (!open) {
      i = (((q >> 5) * W + warp) << 5) + (q & 31);
      open = i < N;
      c = 0;
      if (open) {
        const int gi = i % g_n;
        gv[0] = g[gi]; gv[1] = g[g_n + gi]; gv[2] = g[2 * g_n + gi];
      }
    }
    if (!__any_sync(0xffffffffu, open)) break;
    if (open && !work) {  // the lane's next path starts
      if constexpr (RAYS) {
        pix = i;  // read only by the keyed draws, which tape mode skips
        smp = 0u;
        ox = o[i]; oy = o[N + i]; oz = o[2 * N + i];
        dx = d[i]; dy = d[N + i]; dz = d[2 * N + i];
      } else {
        primary_ray<FAST, INTERNAL>(cfg, cam, cam_u, i, c, pix, smp, dx, dy,
                                    dz);
        ox = cam.eye[0]; oy = cam.eye[1]; oz = cam.eye[2];
      }
      Tx = 1.0f; Ty = 1.0f; Tz = 1.0f;
      lx = 0.0f; ly = 0.0f; lz = 0.0f;
      work = alive = true;
      bnc = 0;
      if (INTERNAL) qt.key = path_key(cfg.seed1, (uint32_t)pix, smp);
      if (cfg.min_bounces <= 0)
        qt.u_rr = roulette_draw<INTERNAL>(cfg, qt, i, 0);
    }
    marks.at(SEC_CAMERA, bnc, alive);
    if (work) {
      const QueueTape& tape = qt;
#include "fused_bounce.inc"
    }
    marks.step(work, alive);
    if (!work) continue;
    ++bnc;
    // Russian roulette of the next bounce, decided now.
    if (alive && bnc < D && bnc >= cfg.min_bounces) {
      qt.u_rr = roulette_draw<INTERNAL>(cfg, qt, i, bnc);
      alive = !(qt.u_rr < cfg.absorb);
    }
    alive = alive && bnc < D;
    if (alive) continue;
    // The path has ended: its rows, from the last trip's down.
    work = false;
    sweep_path(cfg, tab, rows, bnc, gv, acc);
    marks.at(SEC_SWEEP, bnc, alive);
    if (++c < C) continue;
    // The slot's last chunk: its column out as one row of slot_acc, in
    // 16-byte stores, and zeroed for the next slot. With one chunk the
    // scratch starts zeroed and a store of four +0 entries is skipped.
    float* row = slot_acc + (size_t)i * slot_stride(E);
    for (int e = 0; e < E; e += 4) {
      float4 v;
      v.x = acc[e * DRT_BLOCK];
      v.y = e + 1 < E ? acc[(e + 1) * DRT_BLOCK] : 0.0f;
      v.z = e + 2 < E ? acc[(e + 2) * DRT_BLOCK] : 0.0f;
      v.w = e + 3 < E ? acc[(e + 3) * DRT_BLOCK] : 0.0f;
      if (C > 1 || (__float_as_uint(v.x) | __float_as_uint(v.y) |
                    __float_as_uint(v.z) | __float_as_uint(v.w)) != 0u)
        __stcs(reinterpret_cast<float4*>(row + e), v);
    }
    for (int e = 0; e < E; ++e) acc[e * DRT_BLOCK] = 0.0f;
    open = false;
    marks.at(SEC_REDUCE, bnc, alive);
  }
  if constexpr (COUNT) {
    marks.flush(stats + AS_CYCLES);
    marks.flush_steps(stats + AS_STEPS);
  }
}
#undef DRT_MARK
#define DRT_MARK(k)

// Block b of the second kernel copies the rows of slots [128 b, 128 b +
// 128) of slot_acc into the block's accumulator columns (zeros past
// n_rays, as a thread with no slot leaves its column in the lockstep
// loop) and reduces them with block_reduce_write into row b of partials:
// the lockstep loop's sums, in its order, by its code.
__global__ void __launch_bounds__(DRT_BLOCK)
slot_reduce_kernel(int n_alb, int n_emi, int n_rays,
                   const float* __restrict__ slot_acc,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  const int E = n_entries(n_alb, n_emi), stride = slot_stride(E);
  const int base = blockIdx.x * DRT_BLOCK;
  const int n = min(DRT_BLOCK, n_rays - base);
  const float* rows = slot_acc + (size_t)base * stride;
  const int slot = threadIdx.x;
  for (int e = 0; e < E; ++e)
    s_acc[e * DRT_BLOCK + slot] =
        slot < n ? __ldg(rows + (size_t)slot * stride + e) : 0.0f;
  block_reduce_write(n_alb, n_emi, s_acc, partials);
}

// The hook of the segment adjoint: bounce b of a segment that starts at
// b0 is row b - b0.
struct KeepSegmentResidual {
  Residuals& r;
  int b0;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float gate,
                                             int best) const {
    const int k = b - b0;
    r.P[k][0] = Px; r.P[k][1] = Py; r.P[k][2] = Pz;
    r.sc[k] = sc;
    r.gate[k] = gate;
    r.best[k] = best;
  }
};

// reverse_sweep over the n rows of a segment, from the suffix radiance S
// after its last bounce; leaves S at its first bounce in S.
static __device__ __forceinline__ void segment_sweep(
    const DrtTrace& cfg, const DrtTables& tab,
    const Residuals& r, int n, const float g[3], float S[3],
    float* acc) {
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  for (int b = n - 1; b >= 0; --b) {
    const int best = r.best[b];
    float e[3] = {0.0f, 0.0f, 0.0f};
    float a[3] = {1.0f, 1.0f, 1.0f};
    int erow = -1, arow = -1;
    if (best > 0) {
      const float* rec = tab.scene + (best - 1) * DRT_REC;
      const int er = (int)rec[R_EMI];
      if (er < cfg.n_emi - 1) {
        erow = er;
        e[0] = tab.emi[er * 3 + 0];
        e[1] = tab.emi[er * 3 + 1];
        e[2] = tab.emi[er * 3 + 2];
      }
      const int ar = (int)rec[R_ALB];
      if (ar < cfg.n_alb - 1) {
        arow = ar;
        a[0] = tab.alb[ar * 3 + 0];
        a[1] = tab.alb[ar * 3 + 1];
        a[2] = tab.alb[ar * 3 + 2];
      }
    }
    sweep_bounce(acc, acc_e, arow, erow, a, e, r.P[b], r.sc[b], r.gate[b],
                 g, S);
  }
}

template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_adjoint_kernel(DrtTrace cfg, DrtCamera cam, int b0, int b1,
                       int chunk, const float* __restrict__ scene,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const float* __restrict__ cam_u,
                       const float* __restrict__ tape,
                       const float* __restrict__ ray,
                       const int* __restrict__ alive_in,
                       const int* __restrict__ ray_idx,
                       const float* __restrict__ g, int g_n,
                       const float* __restrict__ s_end,
                       float* __restrict__ partials,
                       float* __restrict__ s_start) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int K = cfg.n_rays;
  if (i < K) {
    Residuals r;
    KeepSegmentResidual hook{r, b0};
    PathState p;
    trace_segment<FAST, INTERNAL>(cfg, cam, tab, cam_u,
                                  SegmentTape{tape, b0}, ray, alive_in,
                                  ray_idx, b1, i, chunk, hook, p);
    const int gi = i % g_n;
    const float gv[3] = {g[gi], g[g_n + gi], g[2 * g_n + gi]};
    float S[3] = {0.0f, 0.0f, 0.0f};
    if (s_end != nullptr) {
      S[0] = s_end[i]; S[1] = s_end[K + i]; S[2] = s_end[2 * K + i];
    }
    segment_sweep(cfg, tab, r, b1 - b0, gv, S, s_acc + threadIdx.x);
    if (s_start != nullptr) {
      s_start[i] = S[0]; s_start[K + i] = S[1]; s_start[2 * K + i] = S[2];
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

static bool adjoint_cfg_ok(const DrtTrace* cfg, int g_n) {
  return drt_cfg_ok(cfg) && cfg->max_depth >= 1 &&
         cfg->max_depth <= DRT_MAX_DEPTH && g_n > 0;
}

// The queue kernel, then the sum of each 128 slots' columns into the
// partials, then reduce_partials.
template <bool FAST, bool INTERNAL, bool RAYS, bool COUNT>
static int launch_queue(const DrtTrace* cfg, const DrtCamera& cam,
                        const float* scene, const float* alb,
                        const float* emi, const float* cam_u, const float* o,
                        const float* d, const float* tape, const float* g,
                        int g_n, float* slot_acc, float* partials, float* da,
                        float* de, unsigned long long* stats,
                        cudaStream_t s) {
  if (!slot_acc && n_entries(cfg->n_alb, cfg->n_emi) > 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = queue_adjoint_kernel<FAST, INTERNAL, RAYS, COUNT>;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc = allow_shared(kernel, bytes);
  if (rc) return rc;
  int grid = 0;
  rc = (int)queue_grid(kernel, cfg->n_rays, &grid, bytes);
  if (rc) return rc;
  if (cfg->n_chunks == 1 && slot_acc) {  // mostly +0: see the flush
    const int E = n_entries(cfg->n_alb, cfg->n_emi);
    rc = (int)cudaMemsetAsync(
        slot_acc, 0, (size_t)cfg->n_rays * slot_stride(E) * sizeof(float),
        s);
    if (rc) return rc;
  }
  kernel<<<grid, DRT_BLOCK, bytes, s>>>(*cfg, cam, scene, alb, emi, cam_u, o,
                                        d, tape, g, g_n, slot_acc, stats);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = allow_shared(slot_reduce_kernel, bytes);
  if (rc) return rc;
  const int groups = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  slot_reduce_kernel<<<groups, DRT_BLOCK, bytes, s>>>(
      cfg->n_alb, cfg->n_emi, cfg->n_rays, slot_acc, partials);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

extern "C" {

int drt_adjoint_limits(int* max_shapes, int* max_rows, int* rec,
                       int* max_depth, int* block, int* n_stats) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  *n_stats = AS_END;
  return 0;
}

// The ring stages drt_fused_sweep launches with for these table rows and
// depth on the current card (sweep_rows.cuh:sweep_stages; 0: the rows
// through registers).
int drt_fused_sweep_stages(int n_alb, int n_emi, int max_depth,
                           int* stages) {
  if (max_depth > SWEEP_HEAD)
    return sweep_stages(fused_sweep_kernel<true, true>, n_alb, n_emi,
                        max_depth, stages);
  return sweep_stages(fused_sweep_kernel<false, true>, n_alb, n_emi,
                      max_depth, stages);
}

// Each entry point launches its adjoint kernel and the reduction of the
// partials on `stream` and returns the first CUDA error (0 on success).
// `partials` is scratch of ceil(n_rays / block) x entries floats; g is
// f32[3, g_n] with g_n = n_rays (per ray) or width * height (per pixel).
int drt_fused_sweep(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* rsc, const int* rbest,
                    const float* g, int g_n, float* partials, float* da,
                    float* de, void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cfg->max_depth > SWEEP_HEAD)
    return launch_sweep(fused_sweep_kernel<true, true>,
                        fused_sweep_kernel<true, false>, cfg, partials, da,
                        de, s, scene, alb, emi, rsc, rbest, g, g_n);
  return launch_sweep(fused_sweep_kernel<false, true>,
                      fused_sweep_kernel<false, false>, cfg, partials, da, de,
                      s, scene, alb, emi, rsc, rbest, g, g_n);
}

// The queue needs slot_acc f32[n_rays, slot_stride(E)] as scratch, E =
// n_entries.
int drt_fused_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      const float* cam_u, const float* tape, const float* g,
                      int g_n, float* slot_acc, float* partials, float* da,
                      float* de, void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DRT_LAUNCH(F, I)                                                   \
  return launch_queue<F, I, false, false>(cfg, *cam, scene, alb, emi, cam_u, \
                                          nullptr, nullptr, tape, g, g_n,  \
                                          slot_acc, partials, da, de,      \
                                          nullptr, s)
  if (cfg->fast) {
    if (cfg->internal_rng) DRT_LAUNCH(true, true);
    DRT_LAUNCH(true, false);
  }
  if (cfg->internal_rng) DRT_LAUNCH(false, true);
  DRT_LAUNCH(false, false);
#undef DRT_LAUNCH
}

// The checking build of the lockstep loop (one thread per ray slot, all
// max_depth bounces of each chunk, then the 32-row reverse sweep), the bit
// reference of drt_fused_adjoint.
int drt_fused_adjoint_lockstep(const DrtTrace* cfg, const DrtCamera* cam,
                               const float* scene, const float* alb,
                               const float* emi, const float* cam_u,
                               const float* tape, const float* g, int g_n,
                               float* partials, float* da, float* de,
                               void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(F, I)                                                   \
  rc = allow_shared(fused_adjoint_kernel<F, I, false>, bytes);             \
  if (rc) return rc;                                                       \
  fused_adjoint_kernel<F, I, false><<<grid, DRT_BLOCK, bytes, s>>>(        \
      *cfg, *cam, scene, alb, emi, cam_u, tape, g, g_n, partials, nullptr)
  if (cfg->fast) {
    if (cfg->internal_rng) { DRT_LAUNCH(true, true); }
    else { DRT_LAUNCH(true, false); }
  } else {
    if (cfg->internal_rng) { DRT_LAUNCH(false, true); }
    else { DRT_LAUNCH(false, false); }
  }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

// The timing build of the retrace adjoint, internal RNG: the queue (queue
// != 0, slot_acc as drt_fused_adjoint's) or the lockstep loop (slot_acc
// unused). Adds its counters (AS_*) into stats u64[AS_END], which the
// caller zeroes, and writes the gradients as drt_fused_adjoint does.
int drt_fused_adjoint_stats(const DrtTrace* cfg, const DrtCamera* cam,
                            const float* scene, const float* alb,
                            const float* emi, const float* g, int g_n,
                            float* slot_acc, float* partials, float* da,
                            float* de, unsigned long long* stats, int queue,
                            void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n) || !cfg->internal_rng || !stats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (queue) {
    if (cfg->fast)
      return launch_queue<true, true, false, true>(
          cfg, *cam, scene, alb, emi, nullptr, nullptr, nullptr, nullptr, g,
          g_n, slot_acc, partials, da, de, stats, s);
    return launch_queue<false, true, false, true>(
        cfg, *cam, scene, alb, emi, nullptr, nullptr, nullptr, nullptr, g,
        g_n, slot_acc, partials, da, de, stats, s);
  }
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(F)                                                      \
  rc = allow_shared(fused_adjoint_kernel<F, true, true>, bytes);           \
  if (rc) return rc;                                                       \
  fused_adjoint_kernel<F, true, true><<<grid, DRT_BLOCK, bytes, s>>>(      \
      *cfg, *cam, scene, alb, emi, nullptr, nullptr, g, g_n, partials,     \
      stats)
  if (cfg->fast) { DRT_LAUNCH(true); }
  else { DRT_LAUNCH(false); }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

// g is f32[3, n_rays], one cotangent per ray; one chunk, exact variant,
// tape mode only; slot_acc as drt_fused_adjoint's.
int drt_ray_adjoint(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* o, const float* d,
                    const float* tape, const float* g, float* slot_acc,
                    float* partials, float* da, float* de, void* stream) {
  if (!adjoint_cfg_ok(cfg, cfg->n_rays) || cfg->n_chunks != 1 ||
      cfg->internal_rng || cfg->fast)
    return (int)cudaErrorInvalidValue;
  const DrtCamera cam{};  // unread: the paths start from o, d
  return launch_queue<false, false, true, false>(
      cfg, cam, scene, alb, emi, nullptr, o, d, tape, g, cfg->n_rays,
      slot_acc, partials, da, de, nullptr, (cudaStream_t)stream);
}

// The checking build of the lockstep loop, the bit reference of
// drt_ray_adjoint.
int drt_ray_adjoint_lockstep(const DrtTrace* cfg, const float* scene,
                             const float* alb, const float* emi,
                             const float* o, const float* d,
                             const float* tape, const float* g,
                             float* partials, float* da, float* de,
                             void* stream) {
  if (!adjoint_cfg_ok(cfg, cfg->n_rays) || cfg->n_chunks != 1 ||
      cfg->internal_rng || cfg->fast)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc = allow_shared(ray_adjoint_kernel, bytes);
  if (rc) return rc;
  ray_adjoint_kernel<<<grid, DRT_BLOCK, bytes, s>>>(
      *cfg, scene, alb, emi, o, d, tape, g, partials);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

// Bounces [b_start, b_end) of chunk `chunk`, inputs as
// drt_fused_segment_trace's; g is f32[3, g_n], read at lane % g_n (g_n =
// n_rays per lane, or W*H per pixel when b_start == 0); s_end f32[3,
// n_rays] is read iff b_end < max_depth and s_start written iff
// b_start > 0.
int drt_fused_segment_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                              int b_start, int b_end, int chunk,
                              const float* scene, const float* alb,
                              const float* emi, const float* cam_u,
                              const float* tape, const float* ray,
                              const int* alive, const int* ray_idx,
                              const float* g, int g_n, const float* s_end,
                              float* partials, float* da, float* de,
                              float* s_start, void* stream) {
  const bool entry = b_start == 0, final = b_end == cfg->max_depth;
  if (!adjoint_cfg_ok(cfg, g_n) || cfg->n_chunks != 1 || b_start < 0 ||
      b_end <= b_start || b_end > cfg->max_depth || chunk < 0 ||
      (!cfg->internal_rng && (tape == nullptr || (entry && !cam_u))) ||
      (!entry && (!ray || !alive || (cfg->internal_rng && !ray_idx) ||
                  !s_start || g_n != cfg->n_rays)) ||
      (!final && !s_end))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  const float* se = final ? nullptr : s_end;
  float* ss = entry ? nullptr : s_start;
  int rc;
#define DRT_LAUNCH(F, I)                                                   \
  rc = allow_shared(segment_adjoint_kernel<F, I>, bytes);                  \
  if (rc) return rc;                                                       \
  segment_adjoint_kernel<F, I><<<grid, DRT_BLOCK, bytes, s>>>(             \
      *cfg, *cam, b_start, b_end, chunk, scene, alb, emi, cam_u, tape,     \
      ray, alive, ray_idx, g, g_n, se, partials, ss)
  if (cfg->fast) {
    if (cfg->internal_rng) { DRT_LAUNCH(true, true); }
    else { DRT_LAUNCH(true, false); }
  } else {
    if (cfg->internal_rng) { DRT_LAUNCH(false, true); }
    else { DRT_LAUNCH(false, false); }
  }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

const char* drt_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
