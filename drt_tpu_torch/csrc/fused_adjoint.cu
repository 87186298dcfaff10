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
//    (fused_tracer.cu) retraced, then the reverse sweep seeded by the next
//    segment's S at its entry (S_end, zero for the last segment), which
//    writes S at this segment's entry (S_start) when b_start > 0:
//    S_b = gate_b (e_b + w_b S_{b+1}) (megakernel.py:_reverse_sweep). Two
//    loops, chosen at launch (segment_takes_queue): where lanes can enter
//    dead (b_start > 0), a queue of the segment's lanes from their entry
//    state, one live bounce a trip, each path's rows kept per thread by
//    segment-local bounce (segment_queue_kernel, which says how it keeps
//    the lockstep loop's bits); from the camera, where every lane enters
//    live, or where the queue's sums do not fit in a block's shared
//    memory, the lockstep loop (segment_adjoint_kernel: one thread per
//    lane, every bounce, all b_end - b_start rows swept), which is the
//    faster there (PERF.md section 6). drt_fused_segment_adjoint_lockstep
//    runs the lockstep loop at every launch, the queue's bit reference.
//    Bound like B4; the state, g, S_end and S_start add 68 bytes per lane
//    at most.
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
//    DRT_MAX_DEPTH = 32 rows a path. Deeper paths (a segment's rows, for
//    the segment adjoint) take the deep forms (grad_accum.cuh): instances
//    that keep rows DEEP_WINDOW = 32 on in device memory, a scratch buffer
//    the caller passes (drt_deep_bytes), on a grid of at most the threads
//    the card holds at once; B3's through sweep_rows.cuh with the rows in
//    registers (fused_sweep_deep_kernel), B4's and B5b's queue
//    (queue_adjoint_deep_kernel) and both loops of the segment adjoint
//    (segment_queue_deep_kernel, segment_adjoint_deep_kernel) on the
//    bodies of the in-thread kernels with DeepPathRows. The launch takes
//    them only beyond 32 rows, so up to 32 the kernels and bits are as
//    they were; they run the same statements on the same values in the
//    same order, so retrace = sweep(collect) and queue = lockstep build
//    hold bit for bit at every depth. The lockstep checking builds of B4
//    and B5b keep 32 rows and refuse deeper paths.
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

// The block's sweep tables, then a barrier.
static __device__ __forceinline__ void stage_sweep_tables(
    const DrtTrace& cfg, const float* __restrict__ scene,
    const float* __restrict__ alb, const float* __restrict__ emi,
    FusedSweepTables& tab) {
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
}

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
  stage_sweep_tables(cfg, scene, alb, emi, tab);
  sweep_groups<TAIL, RING>(
      cfg, FusedSweepDecode{tab.code}, tab.alb, tab.emi, rsc, rbest, g, g_n,
      stages, s_acc, partials);
}

// B3's deep form, taken beyond DEEP_WINDOW bounces (launch_sweep_deep):
// the rows through registers, those past DEEP_WINDOW in device memory.
__global__ void __launch_bounds__(DRT_BLOCK, SWEEP_MIN_BLOCKS)
fused_sweep_deep_kernel(DrtTrace cfg, const float* __restrict__ scene,
                        const float* __restrict__ alb,
                        const float* __restrict__ emi,
                        const float* __restrict__ rsc,
                        const int* __restrict__ rbest,
                        const float* __restrict__ g, int g_n,
                        DeepScratch deep, float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ FusedSweepTables tab;
  stage_sweep_tables(cfg, scene, alb, emi, tab);
  sweep_groups<true, false, true>(
      cfg, FusedSweepDecode{tab.code}, tab.alb, tab.emi, rsc, rbest, g, g_n,
      0, deep.block_acc(n_entries(cfg.n_alb, cfg.n_emi), s_acc), partials,
      deep.rows);
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
  __device__ __forceinline__ float4 psc_of(int b) const { return Psc[b]; }
  __device__ __forceinline__ int best_of(int b) const { return best[b]; }
  __device__ __forceinline__ void put(int b, float4 v, int w) {
    Psc[b] = v;
    best[b] = w;
  }
};

// The rows of a path in a deep form (grad_accum.cuh): rows below
// DEEP_WINDOW in the thread as PathRows, the rest in device memory.
struct DeepPathRows {
  PathRows head;
  DeepRows tail;
  __device__ __forceinline__ explicit DeepPathRows(const DeepRows& t)
      : tail(t) {}
  __device__ __forceinline__ float4 psc_of(int b) const {
    return b < DEEP_WINDOW ? head.Psc[b] : tail.psc[tail.at(b)];
  }
  __device__ __forceinline__ int best_of(int b) const {
    return b < DEEP_WINDOW ? head.best[b] : tail.word[tail.at(b)];
  }
  __device__ __forceinline__ void put(int b, float4 v, int w) {
    if (b < DEEP_WINDOW)
      head.put(b, v, w);
    else
      tail.put(b, v, w);
  }
};
static_assert(DRT_MAX_DEPTH == DEEP_WINDOW,
              "a deep form keeps the rows past the thread's in memory");

template <class Rows>
struct KeepPathRow {
  Rows& r;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float,
                                             int best) const {
    r.put(b, make_float4(Px, Py, Pz, sc), best);
  }
};

// reverse_sweep over the n rows of a path, from its last with S = 0, with
// a run-time loop: the same statements on the same values, row for row.
template <class Rows>
static __device__ __forceinline__ void sweep_path(const DrtTrace& cfg,
                                                  const DrtTables& tab,
                                                  const Rows& r, int n,
                                                  const float g[3],
                                                  float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  for (int b = n - 1; b >= 0; --b) {
    const float4 Psc = r.psc_of(b);
    const int best = r.best_of(b);
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
// The kernels' body, on the lane's rows `rows` (PathRows, or
// DeepPathRows in the deep form).
#undef DRT_MARK
#define DRT_MARK(k) marks.at(k, bnc, alive)
template <bool FAST, bool INTERNAL, bool RAYS, bool COUNT, class Rows>
static __device__ __forceinline__ void queue_adjoint_body(
    const DrtTrace& cfg, const DrtCamera& cam,
    const float* __restrict__ scene, const float* __restrict__ alb,
    const float* __restrict__ emi, const float* __restrict__ cam_u,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tape, const float* __restrict__ g, int g_n,
    float* __restrict__ slot_acc, unsigned long long* stats, Rows& rows) {
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
  KeepPathRow<Rows> hook{rows};  // the rows of the lane's path
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
  PathRows rows;
  queue_adjoint_body<FAST, INTERNAL, RAYS, COUNT>(
      cfg, cam, scene, alb, emi, cam_u, o, d, tape, g, g_n, slot_acc, stats,
      rows);
}

// The deep form of B4 and B5b (grad_accum.cuh), taken beyond DEEP_WINDOW
// bounces: a path's rows from DEEP_WINDOW on in device memory. Its grid is
// at most deep_blocks, so every thread has its rows there.
template <bool FAST, bool INTERNAL, bool RAYS>
__global__ void __launch_bounds__(DRT_BLOCK)
queue_adjoint_deep_kernel(DrtTrace cfg, DrtCamera cam,
                          const float* __restrict__ scene,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const float* __restrict__ cam_u,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tape,
                          const float* __restrict__ g, int g_n,
                          float* __restrict__ slot_acc, DeepRows deep) {
  DeepPathRows rows(deep);
  queue_adjoint_body<FAST, INTERNAL, RAYS, false>(
      cfg, cam, scene, alb, emi, cam_u, o, d, tape, g, g_n, slot_acc,
      nullptr, rows);
}

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

// The rows of a segment's path in a queue lane: bounce b of a segment that
// starts at b0 is row b - b0 (KeepPathRow's words).
template <class Rows>
struct KeepSegmentPathRow {
  Rows& r;
  int b0;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float,
                                             int best) const {
    r.put(b - b0, make_float4(Px, Py, Pz, sc), best);
  }
};

// The scene, albedo and emission tables of the segment queue, in its
// dynamic shared memory at the sizes of the call.
struct TableRows {
  const float* scene;
  const float* alb;
  const float* emi;
};

// sweep_path over the n rows of a segment's path that starts at bounce
// b0, from the seed S; leaves S at the segment's entry in S. The gate of
// row k is that of the absolute bounce b0 + k.
template <class Rows>
static __device__ __forceinline__ void sweep_segment_path(
    const DrtTrace& cfg, const TableRows& tab, const Rows& r, int b0,
    int n, const float g[3], float S[3], float* acc) {
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  for (int k = n - 1; k >= 0; --k) {
    const float4 Psc = r.psc_of(k);
    const int best = r.best_of(k);
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
        best > 0 ? (b0 + k >= cfg.min_bounces ? cfg.inv_keep : 1.0f) : 0.0f;
    const float P[3] = {Psc.x, Psc.y, Psc.z};
    sweep_bounce(acc, acc_e, arow, erow, a, e, P, Psc.w, gate, g, S);
  }
}

// The groups of 128 lanes a warp of the segment queue holds open.
#define SEGMENT_RING 2
#define SEGMENT_WARPS (DRT_BLOCK / 32)
// Words of a lane's entry that a warp stages for the chunk it deals: the
// ray (o, d, T), the path key and the roulette draw of bounce b0.
#define SEGMENT_STAGE 11

// Floats of the segment queue's dynamic shared memory: the tables, the
// threads' accumulator columns and each warp's open groups, E columns of
// 32 partial sums and a word of open lanes per l' each.
static __host__ __device__ __forceinline__ int segment_floats(int n_shapes,
                                                              int n_alb,
                                                              int n_emi) {
  const int E = n_entries(n_alb, n_emi);
  return n_shapes * DRT_REC + (n_alb + n_emi) * 3 + E * DRT_BLOCK +
         SEGMENT_WARPS *
             (SEGMENT_STAGE * 32 + SEGMENT_RING * (1 + (E + 1) * 32));
}

// The queue of the segment adjoint (drt_fused_segment_adjoint): bounces
// [b0, b1) of one chunk from the entry state (b0 > 0), a lane of the
// segment one path.
//
// Hand-out. Each warp takes the next group of 128 lanes from next_group
// (zeroed by the launch) when it needs one, and its four chunks of 32
// lanes in order. It reads a chunk's entries together and stages the
// live ones in shared memory (the roulette of bounce b0 is decided
// here): a lane that enters dead takes no trip, and the warp writes its
// S_start at once; the live lanes go, in lane order, to the warp's
// threads that have no path. A path
// takes one live bounce a trip, and the roulette of the next bounce is
// decided after each trip while bnc + 1 < b1 (the draw at b1 is the next
// segment's). Its rows go into PathRows by segment-local bounce.
//
// The end of a path, and the bits. The lockstep loop (segment_adjoint_
// kernel) sweeps all b1 - b0 rows from S_end. The rows after a path's
// last trip are dead (best = 0, gate = 0, sc = +0: no real row, and S <-
// (0 + 1 * +0 * S) * +0, which is +0 for a finite S and NaN otherwise and
// which a second dead row leaves as it is). So the seed is S_end where the
// last trip ran bounce b1 - 1, and what one dead row makes of S_end where
// it came earlier or there was none (sweep_bounce on that row: the
// parent's statements on the parent's values, the sign of a zero and a
// NaN included); +0 with no S_end (b1 == max_depth). The sweep runs from
// the last trip's row down into the thread's column (which starts at +0)
// and writes S_start.
//
// The sums. block_reduce_row sums entry e of a group as ((c_l +
// c_l+32) + c_l+64) + c_l+96 in lane l of a warp, then a shuffle tree
// over l. A column is never -0 (it starts at +0, and no sum of values that
// are not -0 is -0) and its NaN are the card's canonical NaN, so +0 + c is
// c and adding the +0 column of a dead lane changes no bits. So each warp
// keeps, per open group and l, the partial sum from +0 of the live lanes
// l + 32 k in k order: a thread whose path has ended adds its column there
// once no lane of a lower k of the same l is open (and waits, holding its
// column, until then), and the warp reduces a group by the shuffle tree
// once all its lanes are dealt and added, into its row of partials: the
// lockstep loop's sums, bit for bit. A warp holds SEGMENT_RING groups open.
// g is per lane (g_n = n_rays when b0 > 0).
// The segment queue's body, on the lane's rows `rows` (PathRows, or
// DeepPathRows in the deep form).
template <bool FAST, bool INTERNAL, class Rows>
static __device__ __forceinline__ void segment_queue_body(
    const DrtTrace& cfg, int b0, int b1, int chunk,
    const float* __restrict__ scene, const float* __restrict__ alb,
    const float* __restrict__ emi, const float* __restrict__ tape,
    const float* __restrict__ ray, const int* __restrict__ alive_in,
    const int* __restrict__ ray_idx, const float* __restrict__ g,
    const float* __restrict__ s_end, int* __restrict__ next_group,
    float* __restrict__ partials, float* __restrict__ s_start, Rows& rows) {
  extern __shared__ float s_dyn[];
  const int E = n_entries(cfg.n_alb, cfg.n_emi);
  float* const s_scene = s_dyn;
  float* const s_alb = s_scene + cfg.n_shapes * DRT_REC;
  float* const s_emi = s_alb + cfg.n_alb * 3;
  float* const s_acc = s_emi + cfg.n_emi * 3;
  float* const s_ring = s_acc + E * DRT_BLOCK;
  for (int k = threadIdx.x; k < cfg.n_shapes * DRT_REC; k += blockDim.x)
    s_scene[k] = scene[k];
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    s_alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    s_emi[k] = emi[k];
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);
  for (int k = threadIdx.x; k < SEGMENT_WARPS * SEGMENT_RING * (E + 1) * 32;
       k += blockDim.x)
    s_ring[k] = 0.0f;  // the sums +0, the open words 0
  __syncthreads();
  float* const s_stage = s_ring + SEGMENT_WARPS * SEGMENT_RING * (E + 1) * 32;
  int* const s_gid =
      reinterpret_cast<int*>(s_stage + SEGMENT_WARPS * SEGMENT_STAGE * 32);
  const TableRows tab{s_scene, s_alb, s_emi};
  const float RAY_EPS_F = 1e-3f;

  const int K = cfg.n_rays;
  const size_t n = (size_t)K;
  const int npix = cfg.width * cfg.height;
  const int n_groups = (K + DRT_BLOCK - 1) / DRT_BLOCK;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // This warp's open groups, slot m % SEGMENT_RING of its m-th
  // group: E x 32 partial sums, then 32 words of open lanes (bit k: lane
  // l + 32 k dealt live, its column not yet added).
  float* const ring = s_ring + (threadIdx.x >> 5) * SEGMENT_RING * (E + 1) * 32;
  int* const open_w = reinterpret_cast<int*>(ring + SEGMENT_RING * E * 32);
  // The group of each slot, taken from next_group in turn by the warps.
  int* const gid = s_gid + (threadIdx.x >> 5) * SEGMENT_RING;
  // The entries of the live lanes of the chunk the warp deals, word w of
  // lane l at stage[w * 32 + l].
  float* const stage = s_stage + (threadIdx.x >> 5) * SEGMENT_STAGE * 32;
  int cm = 0;          // the warp's chunks fetched
  unsigned pend = 0u;  // live lanes of chunk cm - 1 not yet dealt
  int oldest = 0;      // the warp's oldest group not yet reduced
  bool spent = false;  // no group is left to take
  int i = 0, bnc = 0;
  const int pix = 0;       // the keyed draws take qt.key
  const uint32_t smp = 0u;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float Tx = 0.0f, Ty = 0.0f, Tz = 0.0f;
  float lx = 0.0f, ly = 0.0f, lz = 0.0f;
  bool work = false, alive = false;
  bool held = false;  // the path has ended, its column not added
  int at_m = 0, at_l = 0, at_k = 0;  // the lane's group, l and k
  float* const acc = s_acc + threadIdx.x;
  SegmentQueueTape qt{tape, 0u, 0.0f, b0};
  KeepSegmentPathRow<Rows> hook{rows, b0};  // the rows of the lane's path

  // The lane's cotangent and S_end (+0 without one), loaded when its path
  // starts and read when it ends.
  float gv[3] = {0.0f, 0.0f, 0.0f};
  float Se[3] = {0.0f, 0.0f, 0.0f};
  // The seed of a path from its S_end in S; at_end: its last trip ran
  // bounce b1 - 1.
  auto seed = [&](bool at_end, float S[3]) {
    if (s_end != nullptr && !at_end) {  // one dead row of the lockstep loop
      const float e[3] = {0.0f, 0.0f, 0.0f}, a[3] = {1.0f, 1.0f, 1.0f};
      const float P[3] = {0.0f, 0.0f, 0.0f};
      sweep_bounce(acc, acc, -1, -1, a, e, P, 0.0f, 0.0f, P, S);
    }
  };

  while (true) {
    __syncwarp();  // the open words and sums of the last trip
    // Add the columns of the ended paths whose turn it is, in turn.
    while (true) {
      const int slot = at_m % SEGMENT_RING;
      const bool add =
          held && (open_w[slot * 32 + at_l] & ((1 << at_k) - 1)) == 0;
      if (!__any_sync(0xffffffffu, add)) break;
      if (add) {
        float* sum = ring + slot * E * 32 + at_l;
        for (int e = 0; e < E; ++e) {
          sum[e * 32] = sum[e * 32] + acc[e * DRT_BLOCK];
          acc[e * DRT_BLOCK] = 0.0f;
        }
        atomicAnd(open_w + slot * 32 + at_l, ~(1 << at_k));
        held = false;
      }
      __syncwarp();
    }
    // Reduce the oldest groups whose lanes are all dealt and added.
    const int dealt = pend != 0u ? cm - 1 : cm;
    while (4 * (oldest + 1) <= dealt) {
      const int s = oldest % SEGMENT_RING;
      if (__any_sync(0xffffffffu, open_w[s * 32 + lane] != 0)) break;
      float* sum = ring + s * E * 32;
      const size_t row = (size_t)gid[s] * E;
      for (int e = 0; e < E; ++e) {
        float v = sum[e * 32 + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = v + __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) partials[row + e] = v;
        sum[e * 32 + lane] = 0.0f;
      }
      __syncwarp();
      ++oldest;
    }
    // Live lanes to the threads with no path, chunk after chunk.
    while (true) {
      const unsigned idle = __ballot_sync(0xffffffffu, !work && !held);
      if (idle == 0u) break;
      if (pend == 0u) {
        const int m = cm >> 2;
        if (spent || m >= oldest + SEGMENT_RING) break;
        if ((cm & 3) == 0) {  // the warp's next group
          int gm = 0;
          if (lane == 0) {
            gm = atomicAdd(next_group, 1);
            gid[m % SEGMENT_RING] = gm;
          }
          gm = __shfl_sync(0xffffffffu, gm, 0);
          if (gm >= n_groups) {
            spent = true;
            break;
          }
        }
        __syncwarp();
        // The chunk's entry, read and staged together; its dead lanes end
        // here.
        const int j = gid[m % SEGMENT_RING] * DRT_BLOCK + (cm & 3) * 32 + lane;
        bool live = false;
        if (j < K) {
          float o3[3], d3[3], T3[3];
          int p = 0;
          uint32_t s = 0u;
          live = alive_in[j] > 0;
          if (live) {
            for (int c = 0; c < 3; ++c) {
              o3[c] = ray[c * n + j];
              d3[c] = ray[(3 + c) * n + j];
              T3[c] = ray[(6 + c) * n + j];
            }
            if (INTERNAL) {
              const int r = ray_idx[j];
              p = r % npix;
              s = (uint32_t)(chunk * cfg.spp_c + r / npix);
            }
          }
          SegmentQueueTape entry{tape, 0u, 0.0f, b0};
          if (INTERNAL) entry.key = path_key(cfg.seed1, (uint32_t)p, s);
          if (live && b0 >= cfg.min_bounces) {
            entry.u_rr = roulette_draw<INTERNAL>(cfg, entry, j, b0);
            live = !(entry.u_rr < cfg.absorb);
          }
          if (live) {
            for (int c = 0; c < 3; ++c) {
              stage[c * 32 + lane] = o3[c];
              stage[(3 + c) * 32 + lane] = d3[c];
              stage[(6 + c) * 32 + lane] = T3[c];
            }
            stage[9 * 32 + lane] = __uint_as_float(entry.key);
            stage[10 * 32 + lane] = entry.u_rr;
          } else if (s_start != nullptr) {
            float S[3] = {0.0f, 0.0f, 0.0f};
            if (s_end != nullptr) {
              S[0] = s_end[j]; S[1] = s_end[n + j]; S[2] = s_end[2 * n + j];
            }
            seed(false, S);
            s_start[j] = S[0]; s_start[n + j] = S[1]; s_start[2 * n + j] = S[2];
          }
        }
        pend = __ballot_sync(0xffffffffu, live);
        ++cm;
        continue;
      }
      __syncwarp();  // the stage
      const int take = min(__popc(idle), __popc(pend));
      const int rank = __popc(idle & below);
      if (!work && !held && rank < take) {
        // Lane i's path starts: its state and the roulette of bounce b0.
        at_m = (cm - 1) >> 2;
        at_k = (cm - 1) & 3;
        at_l = __fns(pend, 0, rank + 1);
        i = gid[at_m % SEGMENT_RING] * DRT_BLOCK + at_k * 32 + at_l;
        const float* st = stage + at_l;
        ox = st[0]; oy = st[32]; oz = st[2 * 32];
        dx = st[3 * 32]; dy = st[4 * 32]; dz = st[5 * 32];
        Tx = st[6 * 32]; Ty = st[7 * 32]; Tz = st[8 * 32];
        qt.key = __float_as_uint(st[9 * 32]);
        qt.u_rr = st[10 * 32];
        gv[0] = g[i]; gv[1] = g[n + i]; gv[2] = g[2 * n + i];
        if (s_end != nullptr) {
          Se[0] = s_end[i]; Se[1] = s_end[n + i]; Se[2] = s_end[2 * n + i];
        }
        lx = 0.0f; ly = 0.0f; lz = 0.0f;
        bnc = b0;
        work = alive = true;
        atomicOr(open_w + (at_m % SEGMENT_RING) * 32 + at_l, 1 << at_k);
      }
      pend &= ~((2u << __fns(pend, 0, take)) - 1u);
    }
    if (!__any_sync(0xffffffffu, work)) {
      if (!__any_sync(0xffffffffu, held) && spent && oldest == cm >> 2)
        break;
      continue;
    }
    if (work) {
      {
        const SegmentQueueTape& tape = qt;
#include "fused_bounce.inc"
      }
      ++bnc;
      // Russian roulette of the next bounce of the segment, decided now.
      if (alive && bnc < b1 && bnc >= cfg.min_bounces) {
        qt.u_rr = roulette_draw<INTERNAL>(cfg, qt, i, bnc);
        alive = !(qt.u_rr < cfg.absorb);
      }
      alive = alive && bnc < b1;
      if (!alive) {
        // The path has ended: the seed, the sweep, S_start.
        work = false;
        float S[3] = {Se[0], Se[1], Se[2]};
        seed(bnc == b1, S);
        sweep_segment_path(cfg, tab, rows, b0, bnc - b0, gv, S, acc);
        if (s_start != nullptr) {
          s_start[i] = S[0]; s_start[n + i] = S[1]; s_start[2 * n + i] = S[2];
        }
        held = true;
      }
    }
  }
}

template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_queue_kernel(DrtTrace cfg, int b0, int b1, int chunk,
                     const float* __restrict__ scene,
                     const float* __restrict__ alb,
                     const float* __restrict__ emi,
                     const float* __restrict__ tape,
                     const float* __restrict__ ray,
                     const int* __restrict__ alive_in,
                     const int* __restrict__ ray_idx,
                     const float* __restrict__ g,
                     const float* __restrict__ s_end,
                     int* __restrict__ next_group,
                     float* __restrict__ partials,
                     float* __restrict__ s_start) {
  PathRows rows;
  segment_queue_body<FAST, INTERNAL>(cfg, b0, b1, chunk, scene, alb, emi,
                                     tape, ray, alive_in, ray_idx, g, s_end,
                                     next_group, partials, s_start, rows);
}

// The segment queue's deep form, for segments of more than DRT_MAX_DEPTH
// bounces: a path's rows from DEEP_WINDOW on in device memory (grid at
// most deep_blocks).
template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_queue_deep_kernel(DrtTrace cfg, int b0, int b1, int chunk,
                          const float* __restrict__ scene,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const float* __restrict__ tape,
                          const float* __restrict__ ray,
                          const int* __restrict__ alive_in,
                          const int* __restrict__ ray_idx,
                          const float* __restrict__ g,
                          const float* __restrict__ s_end,
                          int* __restrict__ next_group,
                          float* __restrict__ partials,
                          float* __restrict__ s_start, DeepRows deep) {
  DeepPathRows rows(deep);
  segment_queue_body<FAST, INTERNAL>(cfg, b0, b1, chunk, scene, alb, emi,
                                     tape, ray, alive_in, ray_idx, g, s_end,
                                     next_group, partials, s_start, rows);
}

// The lockstep loop's deep form, for segments of more than DRT_MAX_DEPTH
// bounces: every bounce of every lane, all b1 - b0 rows swept from S_end
// (sweep_segment_path on the rows of the loop, which derives each row's
// gate as the bounce set it), rows from DEEP_WINDOW on in device memory;
// a grid of at most deep_blocks walks the 128-lane groups in turn and
// writes group k's row of partials, as block k of segment_adjoint_kernel.
template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
segment_adjoint_deep_kernel(DrtTrace cfg, DrtCamera cam, int b0, int b1,
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
                            float* __restrict__ s_start, DeepRows deep) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  const TableRows rows_tab{tab.scene, tab.alb, tab.emi};
  const int K = cfg.n_rays;
  deep_groups(cfg.n_alb, cfg.n_emi, K, s_acc, partials, [&](int i) {
    if (i >= K) return;
    DeepPathRows r(deep);
    KeepSegmentPathRow<DeepPathRows> hook{r, b0};
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
    sweep_segment_path(cfg, rows_tab, r, b0, b1 - b0, gv, S,
                       s_acc + threadIdx.x);
    if (s_start != nullptr) {
      s_start[i] = S[0]; s_start[K + i] = S[1]; s_start[2 * K + i] = S[2];
    }
  });
}

// Any depth: beyond DRT_MAX_DEPTH the queue takes its deep form. The
// lockstep checking builds keep their rows in the thread (lockstep_ok).
static bool adjoint_cfg_ok(const DrtTrace* cfg, int g_n) {
  return drt_cfg_ok(cfg) && cfg->max_depth >= 1 && g_n > 0;
}

static bool lockstep_ok(const DrtTrace* cfg, int g_n) {
  return adjoint_cfg_ok(cfg, g_n) && cfg->max_depth <= DRT_MAX_DEPTH;
}

// The queue kernel (its deep form beyond DRT_MAX_DEPTH bounces, on
// `scratch` of deep_bytes(n_rays, max_depth, ...)), then the sum of each
// 128 slots' columns into the partials, then reduce_partials.
template <bool FAST, bool INTERNAL, bool RAYS, bool COUNT>
static int launch_queue(const DrtTrace* cfg, const DrtCamera& cam,
                        const float* scene, const float* alb,
                        const float* emi, const float* cam_u, const float* o,
                        const float* d, const float* tape, const float* g,
                        int g_n, float* slot_acc, void* scratch,
                        float* partials, float* da, float* de,
                        unsigned long long* stats, cudaStream_t s) {
  const bool deep = cfg->max_depth > DRT_MAX_DEPTH;
  if ((!slot_acc && n_entries(cfg->n_alb, cfg->n_emi) > 0) ||
      (deep && COUNT))
    return (int)cudaErrorInvalidValue;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
  if (cfg->n_chunks == 1 && slot_acc) {  // mostly +0: see the flush
    const int E = n_entries(cfg->n_alb, cfg->n_emi);
    rc = (int)cudaMemsetAsync(
        slot_acc, 0, (size_t)cfg->n_rays * slot_stride(E) * sizeof(float),
        s);
    if (rc) return rc;
  }
  if (deep) {
    auto kernel = queue_adjoint_deep_kernel<FAST, INTERNAL, RAYS>;
    rc = launch_deep(kernel, scratch, cfg->n_rays, cfg->max_depth,
                     cfg->n_alb, cfg->n_emi, bytes, cfg->n_rays,
                     [&](int grid, int b, const DeepScratch& view) {
                       kernel<<<grid, DRT_BLOCK, b, s>>>(
                           *cfg, cam, scene, alb, emi, cam_u, o, d, tape, g,
                           g_n, slot_acc, view.rows);
                     });
    if (rc) return rc;
  } else {
    auto kernel = queue_adjoint_kernel<FAST, INTERNAL, RAYS, COUNT>;
    rc = allow_shared(kernel, bytes);
    if (rc) return rc;
    int grid = 0;
    rc = (int)queue_grid(kernel, cfg->n_rays, &grid, bytes);
    if (rc) return rc;
    kernel<<<grid, DRT_BLOCK, bytes, s>>>(*cfg, cam, scene, alb, emi, cam_u,
                                          o, d, tape, g, g_n, slot_acc,
                                          stats);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
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

// Whether drt_fused_segment_adjoint runs the segment queue for these
// bounds and tables on the current card, else the lockstep loop: the queue
// where lanes can enter dead (b_start > 0) and its tables, columns and
// open groups fit in a block's shared memory (up to about 70 real table
// rows). From the camera every lane enters live, and there the lockstep
// loop is the faster (PERF.md section 6).
static cudaError_t segment_takes_queue(int b_start, int n_shapes, int n_alb,
                                       int n_emi, bool* queue) {
  *queue = false;
  if (b_start == 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *queue = e == cudaSuccess &&
           (int)sizeof(float) * segment_floats(n_shapes, n_alb, n_emi) <=
               optin;
  return e;
}

// The segment queue (its deep form beyond DRT_MAX_DEPTH bounces, on
// `scratch` of deep_bytes(n_rays, b1 - b0, ...)), then reduce_partials.
template <bool FAST, bool INTERNAL>
static int launch_segment_queue(const DrtTrace* cfg, int b0, int b1,
                                int chunk, const float* scene,
                                const float* alb, const float* emi,
                                const float* tape, const float* ray,
                                const int* alive, const int* ray_idx,
                                const float* g, const float* s_end,
                                int* next_group, void* scratch,
                                float* partials, float* da, float* de,
                                float* s_start, cudaStream_t s) {
  if (!next_group) return (int)cudaErrorInvalidValue;
  const int K = cfg->n_rays;
  const int bytes = (int)sizeof(float) *
      segment_floats(cfg->n_shapes, cfg->n_alb, cfg->n_emi);
  const int n_groups = (K + DRT_BLOCK - 1) / DRT_BLOCK;
  // A warp takes whole groups: at most n_groups warps.
  const int items = (n_groups + SEGMENT_WARPS - 1) / SEGMENT_WARPS *
                    DRT_BLOCK;
  int rc = (int)cudaMemsetAsync(next_group, 0, sizeof(int), s);
  if (rc) return rc;
  if (b1 - b0 > DRT_MAX_DEPTH) {
    auto kernel = segment_queue_deep_kernel<FAST, INTERNAL>;
    rc = launch_deep(kernel, scratch, K, b1 - b0, cfg->n_alb, cfg->n_emi,
                     bytes, items,
                     [&](int grid, int b, const DeepScratch& view) {
                       kernel<<<grid, DRT_BLOCK, b, s>>>(
                           *cfg, b0, b1, chunk, scene, alb, emi, tape, ray,
                           alive, ray_idx, g, s_end, next_group, partials,
                           s_start, view.rows);
                     });
  } else {
    auto kernel = segment_queue_kernel<FAST, INTERNAL>;
    rc = allow_shared(kernel, bytes);
    if (rc) return rc;
    int grid = 0;
    rc = (int)queue_grid(kernel, items, &grid, bytes);
    if (rc) return rc;
    kernel<<<grid, DRT_BLOCK, bytes, s>>>(*cfg, b0, b1, chunk, scene, alb,
                                          emi, tape, ray, alive, ray_idx, g,
                                          s_end, next_group, partials,
                                          s_start);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  return reduce_partials(K, cfg->n_alb, cfg->n_emi, partials, da, de, s);
}

// The lockstep loop of a segment (segment_adjoint_kernel; its deep form
// beyond DRT_MAX_DEPTH bounces, on `scratch` of deep_bytes(n_rays, b1 -
// b0, ...)), then reduce_partials.
template <bool FAST, bool INTERNAL>
static int launch_segment_lockstep(
    const DrtTrace* cfg, const DrtCamera& cam, int b0, int b1, int chunk,
    const float* scene, const float* alb, const float* emi,
    const float* cam_u, const float* tape, const float* ray,
    const int* alive, const int* ray_idx, const float* g, int g_n,
    const float* s_end, void* scratch, float* partials, float* da,
    float* de, float* s_start, cudaStream_t s) {
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
  if (b1 - b0 > DRT_MAX_DEPTH) {
    auto kernel = segment_adjoint_deep_kernel<FAST, INTERNAL>;
    rc = launch_deep(kernel, scratch, cfg->n_rays, b1 - b0, cfg->n_alb,
                     cfg->n_emi, bytes, 0,
                     [&](int grid, int b, const DeepScratch& view) {
                       kernel<<<grid, DRT_BLOCK, b, s>>>(
                           *cfg, cam, b0, b1, chunk, scene, alb, emi, cam_u,
                           tape, ray, alive, ray_idx, g, g_n, s_end,
                           partials, s_start, view.rows);
                     });
    if (rc) return rc;
    return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials,
                           da, de, s);
  }
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  rc = allow_shared(segment_adjoint_kernel<FAST, INTERNAL>, bytes);
  if (rc) return rc;
  segment_adjoint_kernel<FAST, INTERNAL><<<grid, DRT_BLOCK, bytes, s>>>(
      *cfg, cam, b0, b1, chunk, scene, alb, emi, cam_u, tape, ray, alive,
      ray_idx, g, g_n, s_end, partials, s_start);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

// The inputs of a segment adjoint's call (drt_fused_segment_adjoint).
static bool segment_args_ok(const DrtTrace* cfg, int b_start, int b_end,
                            int chunk, const float* cam_u, const float* tape,
                            const float* ray, const int* alive,
                            const int* ray_idx, int g_n, const float* s_end,
                            const float* s_start) {
  const bool entry = b_start == 0, final = b_end == cfg->max_depth;
  return adjoint_cfg_ok(cfg, g_n) && cfg->n_chunks == 1 && b_start >= 0 &&
         b_end > b_start && b_end <= cfg->max_depth && chunk >= 0 &&
         (cfg->internal_rng || (tape != nullptr && (!entry || cam_u))) &&
         (entry || (ray && alive && (!cfg->internal_rng || ray_idx) &&
                    s_start && g_n == cfg->n_rays)) &&
         (final || s_end);
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
// Beyond SWEEP_MAX_DEPTH bounces the sweep takes its deep form on
// `scratch` (drt_deep_bytes(n_rays, max_depth, n_alb, n_emi) bytes; unread
// otherwise).
int drt_fused_sweep(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* rsc, const int* rbest,
                    const float* g, int g_n, void* scratch, float* partials,
                    float* da, float* de, void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cfg->max_depth > SWEEP_MAX_DEPTH)
    return launch_sweep_deep(fused_sweep_deep_kernel, cfg, scratch, partials,
                             da, de, s, scene, alb, emi, rsc, rbest, g, g_n);
  if (cfg->max_depth > SWEEP_HEAD)
    return launch_sweep(fused_sweep_kernel<true, true>,
                        fused_sweep_kernel<true, false>, cfg, partials, da,
                        de, s, scene, alb, emi, rsc, rbest, g, g_n);
  return launch_sweep(fused_sweep_kernel<false, true>,
                      fused_sweep_kernel<false, false>, cfg, partials, da, de,
                      s, scene, alb, emi, rsc, rbest, g, g_n);
}

// The queue needs slot_acc f32[n_rays, slot_stride(E)] as scratch, E =
// n_entries, and beyond DRT_MAX_DEPTH bounces `scratch` for its deep form
// (drt_deep_bytes(n_rays, max_depth, n_alb, n_emi) bytes).
int drt_fused_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      const float* cam_u, const float* tape, const float* g,
                      int g_n, float* slot_acc, void* scratch,
                      float* partials, float* da, float* de, void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DRT_LAUNCH(F, I)                                                   \
  return launch_queue<F, I, false, false>(cfg, *cam, scene, alb, emi, cam_u, \
                                          nullptr, nullptr, tape, g, g_n,  \
                                          slot_acc, scratch, partials, da, \
                                          de, nullptr, s)
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
  if (!lockstep_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
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
  if (!lockstep_ok(cfg, g_n) || !cfg->internal_rng || !stats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (queue) {
    if (cfg->fast)
      return launch_queue<true, true, false, true>(
          cfg, *cam, scene, alb, emi, nullptr, nullptr, nullptr, nullptr, g,
          g_n, slot_acc, nullptr, partials, da, de, stats, s);
    return launch_queue<false, true, false, true>(
        cfg, *cam, scene, alb, emi, nullptr, nullptr, nullptr, nullptr, g,
        g_n, slot_acc, nullptr, partials, da, de, stats, s);
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
// tape mode only; slot_acc and scratch as drt_fused_adjoint's.
int drt_ray_adjoint(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* o, const float* d,
                    const float* tape, const float* g, float* slot_acc,
                    void* scratch, float* partials, float* da, float* de,
                    void* stream) {
  if (!adjoint_cfg_ok(cfg, cfg->n_rays) || cfg->n_chunks != 1 ||
      cfg->internal_rng || cfg->fast)
    return (int)cudaErrorInvalidValue;
  const DrtCamera cam{};  // unread: the paths start from o, d
  return launch_queue<false, false, true, false>(
      cfg, cam, scene, alb, emi, nullptr, o, d, tape, g, cfg->n_rays,
      slot_acc, scratch, partials, da, de, nullptr, (cudaStream_t)stream);
}

// The checking build of the lockstep loop, the bit reference of
// drt_ray_adjoint.
int drt_ray_adjoint_lockstep(const DrtTrace* cfg, const float* scene,
                             const float* alb, const float* emi,
                             const float* o, const float* d,
                             const float* tape, const float* g,
                             float* partials, float* da, float* de,
                             void* stream) {
  if (!lockstep_ok(cfg, cfg->n_rays) || cfg->n_chunks != 1 ||
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

// Whether drt_fused_segment_adjoint runs the segment queue (*queue = 1)
// or the lockstep loop (0) at b_start for these tables on the current
// card (segment_takes_queue), for its checks.
int drt_fused_segment_form(int b_start, int n_shapes, int n_alb, int n_emi,
                           int* queue) {
  bool q = false;
  const cudaError_t e = segment_takes_queue(b_start, n_shapes, n_alb, n_emi,
                                            &q);
  *queue = q;
  return (int)e;
}

// The segment adjoint in the loop segment_takes_queue picks, or the
// lockstep loop (lockstep != 0).
static int segment_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                           int b_start, int b_end, int chunk,
                           const float* scene, const float* alb,
                           const float* emi, const float* cam_u,
                           const float* tape, const float* ray,
                           const int* alive, const int* ray_idx,
                           const float* g, int g_n, const float* s_end,
                           int* next_group, void* scratch, float* partials,
                           float* da, float* de, float* s_start,
                           int lockstep, void* stream) {
  if (!segment_args_ok(cfg, b_start, b_end, chunk, cam_u, tape, ray, alive,
                       ray_idx, g_n, s_end, s_start))
    return (int)cudaErrorInvalidValue;
  bool queue = false;
  if (!lockstep) {
    const int rc = (int)segment_takes_queue(b_start, cfg->n_shapes,
                                            cfg->n_alb, cfg->n_emi, &queue);
    if (rc) return rc;
  }
  const float* se = b_end == cfg->max_depth ? nullptr : s_end;
  float* ss = b_start == 0 ? nullptr : s_start;
  cudaStream_t s = (cudaStream_t)stream;
#define DRT_LAUNCH(F, I)                                                   \
  return queue ? launch_segment_queue<F, I>(                               \
                     cfg, b_start, b_end, chunk, scene, alb, emi, tape,    \
                     ray, alive, ray_idx, g, se, next_group, scratch,      \
                     partials, da, de, ss, s)                              \
               : launch_segment_lockstep<F, I>(                            \
                     cfg, *cam, b_start, b_end, chunk, scene, alb, emi,    \
                     cam_u, tape, ray, alive, ray_idx, g, g_n, se,         \
                     scratch, partials, da, de, ss, s)
  if (cfg->fast) {
    if (cfg->internal_rng) DRT_LAUNCH(true, true);
    DRT_LAUNCH(true, false);
  }
  if (cfg->internal_rng) DRT_LAUNCH(false, true);
  DRT_LAUNCH(false, false);
#undef DRT_LAUNCH
}

// Bounces [b_start, b_end) of chunk `chunk`, inputs as
// drt_fused_segment_trace's; g is f32[3, g_n], read at lane % g_n (g_n =
// n_rays per lane, or W*H per pixel when b_start == 0); s_end f32[3,
// n_rays] is read iff b_end < max_depth and s_start written iff
// b_start > 0. It runs the segment queue or the lockstep loop
// (segment_takes_queue); next_group is an int of scratch for the queue,
// and beyond DRT_MAX_DEPTH bounces a segment takes the deep form of its
// loop on `scratch` (drt_deep_bytes(n_rays, b_end - b_start, n_alb, n_emi)
// bytes; unread otherwise).
int drt_fused_segment_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                              int b_start, int b_end, int chunk,
                              const float* scene, const float* alb,
                              const float* emi, const float* cam_u,
                              const float* tape, const float* ray,
                              const int* alive, const int* ray_idx,
                              const float* g, int g_n, const float* s_end,
                              int* next_group, void* scratch,
                              float* partials, float* da, float* de,
                              float* s_start, void* stream) {
  return segment_adjoint(cfg, cam, b_start, b_end, chunk, scene, alb, emi,
                         cam_u, tape, ray, alive, ray_idx, g, g_n, s_end,
                         next_group, scratch, partials, da, de, s_start, 0,
                         stream);
}

// The checking build of the lockstep loop at every launch (one thread per
// lane, every bounce of the segment, then the sweep of all b_end - b_start
// rows from S_end), the bit reference of drt_fused_segment_adjoint's queue.
int drt_fused_segment_adjoint_lockstep(const DrtTrace* cfg,
                                       const DrtCamera* cam, int b_start,
                                       int b_end, int chunk,
                                       const float* scene, const float* alb,
                                       const float* emi, const float* cam_u,
                                       const float* tape, const float* ray,
                                       const int* alive, const int* ray_idx,
                                       const float* g, int g_n,
                                       const float* s_end, void* scratch,
                                       float* partials, float* da, float* de,
                                       float* s_start, void* stream) {
  return segment_adjoint(cfg, cam, b_start, b_end, chunk, scene, alb, emi,
                         cam_u, tape, ray, alive, ray_idx, g, g_n, s_end,
                         nullptr, scratch, partials, da, de, s_start, 1,
                         stream);
}

const char* drt_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

DRT_DEEP_BYTES_ENTRY
