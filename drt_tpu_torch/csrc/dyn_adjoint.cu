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
// 227 KB a block may have. The residual format allows 255 + 255; above 144
// the launch is refused (the wrapper raises with the count).
//
// max_depth is a run-time value. The sweep adjoint keeps the first 8 rows
// of a slot's chunk in registers and reads later rows one by one
// (sweep_rows.cuh); the retrace adjoint indexes its arrays by the body's
// bounce counter, so they live in local memory and it is built for
// DRT_MAX_DEPTH = 32. Deeper paths are refused.
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

// Reverse sweep of one ray slot's chunk into the thread's accumulator
// column `acc` (dynkernel.py:_dyn_reverse_sweep).
static __device__ __forceinline__ void dyn_reverse_sweep(
    const DrtTrace& cfg, const DynTables& tab, const DynResiduals& r,
    float gx, float gy, float gz, float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  const float g[3] = {gx, gy, gz};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
#pragma unroll
  for (int b = DRT_MAX_DEPTH - 1; b >= 0; --b) {
    if (b >= cfg.max_depth) continue;
    const int ar = r.rows[b] & (DYN_MAX_ROWS - 1);
    const int er = r.rows[b] >> DYN_ROW_BITS;
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
    sweep_bounce(acc, acc_e, arow, erow, a, e, r.P[b], r.sc[b], r.gate[b],
                 g, S);
  }
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

static bool dyn_adjoint_cfg_ok(const DrtTrace* cfg, int g_n) {
  return dyn_tables_ok(cfg) && cfg->max_depth <= DRT_MAX_DEPTH && g_n > 0 &&
         cfg->n_alb - 1 + cfg->n_emi - 1 <= DYN_MAX_GRAD_ROWS;
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
int drt_dyn_sweep(const DrtTrace* cfg, const float* alb, const float* emi,
                  const float* rsc, const int* rrow, const float* g, int g_n,
                  float* partials, float* da, float* de, void* stream) {
  if (!dyn_adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
                    float* partials, float* da, float* de, void* stream) {
  if (!dyn_cfg_ok(cfg, lay) || !dyn_adjoint_cfg_ok(cfg, g_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(F, I)                                                   \
  rc = allow_shared(dyn_adjoint_kernel<F, I>, bytes);                      \
  if (rc) return rc;                                                       \
  dyn_adjoint_kernel<F, I><<<grid, DRT_BLOCK, bytes, s>>>(                 \
      *cfg, *lay, *cam, *scn, alb, emi, cam_u, tape, g, g_n, partials)
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

const char* drt_dyn_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
