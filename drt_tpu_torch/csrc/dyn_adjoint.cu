// Radiative-backprop adjoints over a memory-resident scene for Hopper
// (sm_90a): parameter gradients (d_albedo f32[K+1, 3], d_emission
// f32[L+1, 3]) of sum_rays g . L from a per-ray (or per-pixel) cotangent.
//
//  - drt_dyn_sweep replaces drt_tpu/ops/dynkernel.py:make_dyn_sweep_adjoint
//    (pallas_call at dynkernel.py:1286): from the residuals (rsc, rrow)
//    that the collect tracer of dyn_tracer.cu stored, it replays
//    gate_b = rr_b [live_b], P_b = T_{b-1} gate_b, T_b = P_b a_b sc_b in
//    the forward's op order and runs the reverse sweep, over each slot's
//    rows up to its first dead row. The residuals carry the table ROWS of
//    every bounce (albedo row | emission row << 8 | live << 16), so this
//    kernel reads no scene at all. Its body is sweep_rows.cuh, shared with
//    the scene-table sweep: at 144 rows the accumulator leaves no shared
//    memory for the ring, and the rows come through registers.
//  - drt_dyn_adjoint replaces dynkernel.py:make_dyn_adjoint (pallas_call
//    at :1408): it retraces the forward with the bounce body of
//    dyn_body.cuh, keeping P, sc, gate and the rows of every bounce in the
//    thread, then runs the same reverse sweep. Unbiased mode calls it with
//    a salted bounce seed.
//
// The reverse sweep is sweep_bounce of drt_common.cuh per bounce, from the
// last to the first, and the gradient tables are accumulated without float
// atomics by the routines of grad_accum.cuh, as in fused_adjoint.cu. Both
// kernels here use the same block size, ray -> block map, chunk order and
// routines, so the retrace adjoint equals the sweep adjoint fed the
// collect tracer's residuals bit for bit, and two runs give the same bits.
//
// The accumulator takes (real albedo rows + real emission rows) x 3 x 512
// bytes of dynamic shared memory beside the 6 KB of parameter tables: 6 KB
// for a scene of 4 + 1 rows, and DYN_MAX_GRAD_ROWS = 144 real rows at the
// 227 KB a block may have. The residual format allows 255 + 255.
//
// max_depth is a run-time value. The sweep adjoint keeps the first 8 rows
// of a slot's chunk in registers and reads later rows one by one
// (sweep_rows.cuh); the retrace adjoint indexes its arrays by the body's
// bounce counter, so they live in local memory and it is built for
// DRT_MAX_DEPTH = 32.
//
// Beyond either, above 144 real rows or 32 bounces, both take their deep
// forms (grad_accum.cuh; dyn_sweep_deep_kernel, dyn_adjoint_deep_kernel):
// a path's rows from DEEP_WINDOW = 32 on and, above 144 rows, each block's
// accumulator columns live in a scratch buffer in device memory that the
// caller passes (drt_deep_bytes), on a grid of at most the threads the
// card holds at once that walks the 128-slot groups in turn. The columns
// keep their layout, owner and order, so the sums are the shared-memory
// accumulator's (no float atomics) and B9 = B8(B7) bit for bit.
//
// What bounds them: the sweep adjoint is bound by device memory, at most 8
// bytes per bounce-ray read once (the rows before each slot's first dead
// row are what it needs) against about 20 f32 operations. The retrace
// adjoint is bound like the tracer, by operations: it traces with the
// tracer's warp-wide leaf test (dyn_body.cuh:dyn_intersect_warp), so every
// thread of the grid reaches the bounce loop, a thread past the last ray
// slot as a dead path that sweeps nothing. What is left per thread is the
// box walk, the shading, the lanes that Russian roulette has killed and
// the residuals, which live in local memory; the sweep adds a few percent
// to its work.

#include "dyn_body.cuh"
#include "grad_accum.cuh"
#include "sweep_rows.cuh"

#define DRT_MAX_DEPTH 32
#define DYN_MAX_GRAD_ROWS 144
static_assert(DYN_MAX_GRAD_ROWS == DEEP_MAX_ACC_ROWS,
              "above these rows the deep form holds the accumulator");

// Per-bounce values of one ray slot in one chunk; rows = albedo row |
// emission row << 8.
struct DynResiduals {
  float P[DRT_MAX_DEPTH][3];
  float sc[DRT_MAX_DEPTH];
  float gate[DRT_MAX_DEPTH];
  int rows[DRT_MAX_DEPTH];
};

// The hook of the retrace adjoint.
struct DynKeepResidual {
  DynResiduals& r;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float gate,
                                             int arow, int erow, bool) const {
    r.P[b][0] = Px; r.P[b][1] = Py; r.P[b][2] = Pz;
    r.sc[b] = sc;
    r.gate[b] = gate;
    r.rows[b] = arow | (erow << DYN_ROW_BITS);
  }
};

// The hook of the retrace adjoint's deep form: rows from DEEP_WINDOW on
// in device memory, P and sc, and rows | live << 16 (gate is live ?
// the roulette scale : 0, as dyn_bounce.inc sets it).
struct DynKeepDeepResidual {
  DynResiduals& r;
  const DeepRows& tail;
  __device__ __forceinline__ void operator()(int b, float Px, float Py,
                                             float Pz, float sc, float gate,
                                             int arow, int erow,
                                             bool alive) const {
    if (b < DEEP_WINDOW) {
      DynKeepResidual{r}(b, Px, Py, Pz, sc, gate, arow, erow, alive);
    } else {
      tail.put(b, make_float4(Px, Py, Pz, sc),
               arow | (erow << DYN_ROW_BITS) |
                   ((int)alive << (2 * DYN_ROW_BITS)));
    }
  }
};
static_assert(DRT_MAX_DEPTH == DEEP_WINDOW,
              "a deep form keeps the rows past the thread's in memory");

// One row of the reverse sweep (dynkernel.py:_dyn_reverse_sweep): rows =
// albedo row | emission row << 8.
static __device__ __forceinline__ void dyn_sweep_row(
    const DrtTrace& cfg, const DynTables& tab, int rows, const float P[3],
    float sc, float gate, const float g[3], float S[3], float* acc,
    float* acc_e) {
  const int ar = rows & (DYN_MAX_ROWS - 1);
  const int er = rows >> DYN_ROW_BITS;
  float e[3] = {0.0f, 0.0f, 0.0f};
  float a[3] = {1.0f, 1.0f, 1.0f};
  int erow = -1, arow = -1;
  if (er < cfg.n_emi - 1) {
    erow = er;
    e[0] = tab.emi[er * 3 + 0];
    e[1] = tab.emi[er * 3 + 1];
    e[2] = tab.emi[er * 3 + 2];
  }
  if (ar < cfg.n_alb - 1) {
    arow = ar;
    a[0] = tab.alb[ar * 3 + 0];
    a[1] = tab.alb[ar * 3 + 1];
    a[2] = tab.alb[ar * 3 + 2];
  }
  sweep_bounce(acc, acc_e, arow, erow, a, e, P, sc, gate, g, S);
}

// Reverse sweep of one ray slot's chunk into the thread's accumulator
// column `acc`.
static __device__ __forceinline__ void dyn_reverse_sweep(
    const DrtTrace& cfg, const DynTables& tab, const DynResiduals& r,
    float gx, float gy, float gz, float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  const float g[3] = {gx, gy, gz};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
#pragma unroll
  for (int b = DRT_MAX_DEPTH - 1; b >= 0; --b) {
    if (b >= cfg.max_depth) continue;
    dyn_sweep_row(cfg, tab, r.rows[b], r.P[b], r.sc[b], r.gate[b], g, S,
                  acc, acc_e);
  }
}

// dyn_reverse_sweep of the deep form: all max_depth rows, those from
// DEEP_WINDOW on from device memory, by the same statements.
static __device__ __forceinline__ void dyn_reverse_sweep_deep(
    const DrtTrace& cfg, const DynTables& tab, const DynResiduals& r,
    const DeepRows& tail, float gx, float gy, float gz, float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  const float g[3] = {gx, gy, gz};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  for (int b = cfg.max_depth - 1; b >= DEEP_WINDOW; --b) {
    const float4 v = tail.psc[tail.at(b)];
    const int w = tail.word[tail.at(b)];
    const float P[3] = {v.x, v.y, v.z};
    const bool alive = (w >> (2 * DYN_ROW_BITS)) & 1;
    const float gate =
        alive ? (b >= cfg.min_bounces ? cfg.inv_keep : 1.0f) : 0.0f;
    dyn_sweep_row(cfg, tab, w & ((1 << (2 * DYN_ROW_BITS)) - 1), P, v.w,
                  gate, g, S, acc, acc_e);
  }
  for (int b = min(cfg.max_depth, DEEP_WINDOW) - 1; b >= 0; --b)
    dyn_sweep_row(cfg, tab, r.rows[b], r.P[b], r.sc[b], r.gate[b], g, S,
                  acc, acc_e);
}

// The row code (sweep_rows.cuh:sweep_code) of a residual word albedo row |
// emission row << 8 | live << 16: 0 for a dead row.
struct DynSweepDecode {
  int n_alb, n_emi;
  __device__ __forceinline__ int operator()(int pack) const {
    if ((pack >> (2 * DYN_ROW_BITS)) == 0) return 0;
    return sweep_code(pack & (DYN_MAX_ROWS - 1),
                      (pack >> DYN_ROW_BITS) & (DYN_MAX_ROWS - 1), n_alb,
                      n_emi);
  }
};

// B8: the body of sweep_rows.cuh on the mesh residuals (rsc, rrow).
// TAIL: max_depth > SWEEP_HEAD; RING: the rows come through the ring of
// `stages` items, else through registers (launch_sweep chooses).
template <bool TAIL, bool RING>
__global__ void __launch_bounds__(DRT_BLOCK, SWEEP_MIN_BLOCKS)
dyn_sweep_kernel(DrtTrace cfg, const float* __restrict__ alb,
                 const float* __restrict__ emi,
                 const float* __restrict__ rsc,
                 const int* __restrict__ rrow, const float* __restrict__ g,
                 int g_n, int stages, float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  sweep_groups<TAIL, RING>(
      cfg, DynSweepDecode{cfg.n_alb, cfg.n_emi}, tab.alb, tab.emi, rsc, rrow,
      g, g_n, stages, s_acc, partials);
}

// B8's deep form, taken beyond DEEP_WINDOW bounces or DEEP_MAX_ACC_ROWS
// real table rows (launch_sweep_deep): the rows through registers, those
// past DEEP_WINDOW and, with more table rows, the accumulator in device
// memory.
__global__ void __launch_bounds__(DRT_BLOCK, SWEEP_MIN_BLOCKS)
dyn_sweep_deep_kernel(DrtTrace cfg, const float* __restrict__ alb,
                      const float* __restrict__ emi,
                      const float* __restrict__ rsc,
                      const int* __restrict__ rrow,
                      const float* __restrict__ g, int g_n,
                      DeepScratch deep, float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  sweep_groups<true, false, true>(
      cfg, DynSweepDecode{cfg.n_alb, cfg.n_emi}, tab.alb, tab.emi, rsc, rrow,
      g, g_n, 0, deep.block_acc(n_entries(cfg.n_alb, cfg.n_emi), s_acc),
      partials, deep.rows);
}

template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_adjoint_kernel(DrtTrace cfg, DynLayout lay, DrtCamera cam,
                   DynOperands scn, const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ cam_u,
                   const float* __restrict__ tape,
                   const float* __restrict__ g, int g_n,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  // Every thread of the warp takes part in its leaf loop: one past the
  // last ray slot traces slot N - 1 as a dead path and sweeps nothing, so
  // its accumulator column stays zero.
  const int N = cfg.n_rays;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = slot < N;
  const int i = lane ? slot : N - 1;
  const int gi = i % g_n;
  const float gx = g[gi], gy = g[g_n + gi], gz = g[2 * g_n + gi];
  for (int c = 0; c < cfg.n_chunks; ++c) {
    DynResiduals r;
    DynKeepResidual hook{r};
    float lx, ly, lz;
    dyn_trace_chunk<FAST, INTERNAL, false, true>(cfg, lay, cam, scn, tab,
                                                 cam_u, tape, i, lane, c,
                                                 hook, lx, ly, lz, nullptr);
    if (lane) dyn_reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

// B9's deep form, taken where the launch of dyn_adjoint_kernel would not
// hold its rows or its accumulator (takes_deep): the same trace and
// sweep, rows from DEEP_WINDOW on and, with more table rows, the
// accumulator in device memory (grad_accum.cuh). Its grid of at most
// deep_blocks walks the 128-slot groups in turn and writes group k's row
// of partials, as block k of dyn_adjoint_kernel does, so the two give the
// same bits where both run.
template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_adjoint_deep_kernel(DrtTrace cfg, DynLayout lay, DrtCamera cam,
                        DynOperands scn, const float* __restrict__ alb,
                        const float* __restrict__ emi,
                        const float* __restrict__ cam_u,
                        const float* __restrict__ tape,
                        const float* __restrict__ g, int g_n,
                        DeepScratch deep, float* __restrict__ partials) {
  extern __shared__ float s_dyn[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  float* const s_acc =
      deep.block_acc(n_entries(cfg.n_alb, cfg.n_emi), s_dyn);
  const int N = cfg.n_rays;
  deep_groups(cfg.n_alb, cfg.n_emi, N, s_acc, partials, [&](int slot) {
    // As dyn_adjoint_kernel: a thread past the last slot traces slot
    // N - 1 as a dead path.
    const bool lane = slot < N;
    const int i = lane ? slot : N - 1;
    const int gi = i % g_n;
    const float gx = g[gi], gy = g[g_n + gi], gz = g[2 * g_n + gi];
    for (int c = 0; c < cfg.n_chunks; ++c) {
      DynResiduals r;
      DynKeepDeepResidual hook{r, deep.rows};
      float lx, ly, lz;
      dyn_trace_chunk<FAST, INTERNAL, false, true>(cfg, lay, cam, scn, tab,
                                                   cam_u, tape, i, lane, c,
                                                   hook, lx, ly, lz,
                                                   nullptr);
      if (lane)
        dyn_reverse_sweep_deep(cfg, tab, r, deep.rows, gx, gy, gz,
                               s_acc + threadIdx.x);
    }
  });
}

// Any depth and up to DYN_MAX_ROWS rows a table: beyond DRT_MAX_DEPTH
// bounces or DYN_MAX_GRAD_ROWS real rows the deep forms.
static bool dyn_adjoint_cfg_ok(const DrtTrace* cfg, int g_n) {
  return dyn_tables_ok(cfg) && g_n > 0;
}

extern "C" {

int drt_dyn_adjoint_limits(int* max_rows, int* max_grad_rows, int* max_depth,
                           int* block) {
  *max_rows = DYN_MAX_ROWS;
  *max_grad_rows = DYN_MAX_GRAD_ROWS;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  return 0;
}

// The ring stages drt_dyn_sweep launches with for these table rows and
// depth on the current card (sweep_rows.cuh:sweep_stages; 0: the rows
// through registers).
int drt_dyn_sweep_stages(int n_alb, int n_emi, int max_depth, int* stages) {
  if (max_depth > SWEEP_HEAD)
    return sweep_stages(dyn_sweep_kernel<true, true>, n_alb, n_emi,
                        max_depth, stages);
  return sweep_stages(dyn_sweep_kernel<false, true>, n_alb, n_emi, max_depth,
                      stages);
}

// Each entry point launches its adjoint kernel and the reduction of the
// partials on `stream` and returns the first CUDA error (0 on success).
// `partials` is scratch of ceil(n_rays / block) x entries floats; g is
// f32[3, g_n] with g_n = n_rays (per ray) or width * height (per pixel).
// Beyond DRT_MAX_DEPTH bounces or DYN_MAX_GRAD_ROWS real table rows both
// take their deep forms on `scratch` (drt_deep_bytes(n_rays, max_depth,
// n_alb, n_emi) bytes; unread otherwise).
int drt_dyn_sweep(const DrtTrace* cfg, const float* alb, const float* emi,
                  const float* rsc, const int* rrow, const float* g, int g_n,
                  void* scratch, float* partials, float* da, float* de,
                  void* stream) {
  if (!dyn_adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (takes_deep(cfg->max_depth, cfg->n_alb, cfg->n_emi))
    return launch_sweep_deep(dyn_sweep_deep_kernel, cfg, scratch, partials,
                             da, de, s, alb, emi, rsc, rrow, g, g_n);
  if (cfg->max_depth > SWEEP_HEAD)
    return launch_sweep(dyn_sweep_kernel<true, true>,
                        dyn_sweep_kernel<true, false>, cfg, partials, da, de,
                        s, alb, emi, rsc, rrow, g, g_n);
  return launch_sweep(dyn_sweep_kernel<false, true>,
                      dyn_sweep_kernel<false, false>, cfg, partials, da, de,
                      s, alb, emi, rsc, rrow, g, g_n);
}

int drt_dyn_adjoint(const DrtTrace* cfg, const DynLayout* lay,
                    const DrtCamera* cam, const DynOperands* scn,
                    const float* alb, const float* emi, const float* cam_u,
                    const float* tape, const float* g, int g_n,
                    void* scratch, float* partials, float* da, float* de,
                    void* stream) {
  if (!dyn_cfg_ok(cfg, lay) || !dyn_adjoint_cfg_ok(cfg, g_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool deep = takes_deep(cfg->max_depth, cfg->n_alb, cfg->n_emi);
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(F, I)                                                   \
  if (deep) {                                                              \
    rc = launch_deep(                                                      \
        dyn_adjoint_deep_kernel<F, I>, scratch, cfg->n_rays,               \
        cfg->max_depth, cfg->n_alb, cfg->n_emi, -1, 0,                     \
        [&](int blocks, int b, const DeepScratch& view) {                  \
          dyn_adjoint_deep_kernel<F, I><<<blocks, DRT_BLOCK, b, s>>>(      \
              *cfg, *lay, *cam, *scn, alb, emi, cam_u, tape, g, g_n, view, \
              partials);                                                   \
        });                                                                \
  } else {                                                                 \
    rc = allow_shared(dyn_adjoint_kernel<F, I>, bytes);                    \
    if (rc) return rc;                                                     \
    dyn_adjoint_kernel<F, I><<<grid, DRT_BLOCK, bytes, s>>>(               \
        *cfg, *lay, *cam, *scn, alb, emi, cam_u, tape, g, g_n, partials);  \
    rc = (int)cudaGetLastError();                                          \
  }
  if (cfg->fast) {
    if (cfg->internal_rng) { DRT_LAUNCH(true, true); }
    else { DRT_LAUNCH(true, false); }
  } else {
    if (cfg->internal_rng) { DRT_LAUNCH(false, true); }
    else { DRT_LAUNCH(false, false); }
  }
#undef DRT_LAUNCH
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

const char* drt_dyn_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

DRT_DEEP_BYTES_ENTRY
