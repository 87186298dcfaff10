// Sweep adjoint of the path-regeneration tracer over the scene table for
// Hopper (sm_90a): parameter gradients (d_albedo f32[K+1, 3], d_emission
// f32[L+1, 3]) of sum_pixels g . L from a per-PIXEL cotangent g f32[3,
// n_pix], out of the rows that regen_tracer.cu's collect form stored.
// drt_regen_sweep replaces drt_tpu/ops/regen.py:make_regen_sweep_adjoint
// (pallas_call at regen.py:614). No geometry is touched: the scene table
// only maps a row's hit shape to its albedo and emission rows.
//
// Each thread sweeps one pixel's own `trips` rows of every chunk, one
// sample's segment at a time, and adds into its accumulator column; the
// gradient tables are accumulated without float atomics by grad_accum.cuh,
// as in fused_adjoint.cu, so two runs give the same bits. There is no
// retrace kernel in this family: the retrace backward runs the collect
// tracer and this sweep per chunk.
//
// The per-sample values live in thread arrays of a compile-time size
// whose loops are unrolled: built for 8 bounces (registers) and for
// DRT_MAX_DEPTH = 32, the launch takes the smaller that holds max_depth.
// Deeper, both builds take the deep form (regen_window.cuh:
// regen_sweep_deep_kernel over regen_deep_groups): the per-pixel kernel's
// work in loops of run-time length, a sample's rows from DEEP_WINDOW = 32
// on in a scratch buffer in device memory (grad_accum.cuh).
//
// What bounds it: device memory, 8 bytes per trip run read once against
// about 20 f32 operations and the accumulator's read-modify-writes in
// shared memory. Row t of 32 adjacent pixels is one 128-byte line of rsc
// and one of rmeta (rsc[c][t][pix]).
//
// Two kernels. The per-pixel kernel (regen_sweep_kernel, the checking
// build drt_regen_sweep_lockstep, and the launch where the window
// kernel's ring does not fit) has one thread walk its rows with
// regen_body.cuh:regen_sweep_chunk. The window kernel
// (regen_window_kernel, drt_regen_sweep) reads the rows of a warp
// together, in windows of adjacent pixels' rows copied into a ring in
// shared memory (regen_window.cuh, the text B13 shares). It stages the
// tables and one code word per shape (its albedo and emission rows) once
// per block. At the main shape the copies and rounds alone take about a
// third of its time and the accumulator's read-modify-writes a quarter;
// the rest is the replay and the sweep, whose lanes wait for the longest
// segment of their round (PERF.md section 6, tools/ablate_sweep.py
// --kernel b11).

#include "fused_body.cuh"
#include "grad_accum.cuh"
#include "regen_body.cuh"

#define DRT_MAX_DEPTH 32
#define DRT_SMALL_DEPTH 8

#include "regen_window.cuh"

// rmeta = best | want << 8 | rr_on << 9 (regen_tracer.cu).
struct TableDecode {
  const DrtTrace& cfg;
  const DrtTables& tab;
  __device__ __forceinline__ bool want(int meta) const {
    return (meta >> 8) & 1;
  }
  __device__ __forceinline__ RegenRow row(int meta) const {
    const int best = meta & 0xFF;
    RegenRow r = {-1, -1, best > 0, (bool)((meta >> 9) & 1)};
    if (best > 0) {
      const float* rec = tab.scene + (best - 1) * DRT_REC;
      const int ar = (int)rec[R_ALB];
      const int er = (int)rec[R_EMI];
      if (ar < cfg.n_alb - 1) r.arow = ar;
      if (er < cfg.n_emi - 1) r.erow = er;
    }
    return r;
  }
};

// The per-pixel kernel: one thread per pixel, all chunks.
template <int DMAX>
__global__ void __launch_bounds__(DRT_BLOCK)
regen_sweep_kernel(DrtTrace cfg, const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ rsc,
                   const int* __restrict__ rmeta,
                   const int* __restrict__ trips,
                   const float* __restrict__ g,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = cfg.n_rays;  // pixels
  if (pix < n) {
    const float gp[3] = {g[pix], g[n + pix], g[2 * n + pix]};
    const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;
    const TableDecode decode{cfg, tab};
    for (int c = 0; c < cfg.n_chunks; ++c) {
      const size_t base = (size_t)c * t_cap * n + pix;
      regen_sweep_chunk<DMAX>(cfg, tab, decode, rsc + base, rmeta + base,
                              (size_t)n, trips[(size_t)c * n + pix], gp,
                              s_acc + threadIdx.x);
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

// The deep form (regen_window.cuh:regen_deep_groups), beyond
// DRT_MAX_DEPTH bounces.
__global__ void __launch_bounds__(DRT_BLOCK)
regen_sweep_deep_kernel(DrtTrace cfg, const float* __restrict__ scene,
                        const float* __restrict__ alb,
                        const float* __restrict__ emi,
                        const float* __restrict__ rsc,
                        const int* __restrict__ rmeta,
                        const int* __restrict__ trips,
                        const float* __restrict__ g, DeepScratch deep,
                        float* __restrict__ partials) {
  extern __shared__ float s_dyn[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  regen_deep_groups(cfg, tab, TableDecode{cfg, tab}, rsc, rmeta, trips, g,
                    deep, s_dyn, partials);
}

// TableDecode from the block's code word per shape (albedo row + 1 |
// emission row + 1 << 8, 0 for a sentinel row): the same rows.
struct CodeDecode {
  const int* code;
  __device__ __forceinline__ bool want(int meta) const {
    return (meta >> 8) & 1;
  }
  __device__ __forceinline__ RegenRow row(int meta) const {
    const int best = meta & 0xFF;
    RegenRow r = {-1, -1, best > 0, (bool)((meta >> 9) & 1)};
    if (best > 0) {
      const int cd = code[best - 1];
      r.arow = (cd & 255) - 1;
      r.erow = ((cd >> 8) & 255) - 1;
    }
    return r;
  }
};

// The window kernel: the block's tables and code words, then
// regen_window.cuh:window_sweep. Every thread of the block runs it to the
// end (it holds barriers).
template <int DMAX>
__global__ void __launch_bounds__(DRT_BLOCK)
regen_window_kernel(DrtTrace cfg, const float* __restrict__ scene,
                    const float* __restrict__ alb,
                    const float* __restrict__ emi,
                    const float* __restrict__ rsc,
                    const int* __restrict__ rmeta,
                    const int* __restrict__ trips,
                    const float* __restrict__ g,
                    float* __restrict__ partials) {
  extern __shared__ float s_dyn[];
  __shared__ float s_alb[DRT_MAX_ROWS * 3];
  __shared__ float s_emi[DRT_MAX_ROWS * 3];
  __shared__ int s_code[DRT_MAX_SHAPES];
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    s_alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    s_emi[k] = emi[k];
  for (int k = threadIdx.x; k < cfg.n_shapes; k += blockDim.x) {
    const float* rec = scene + k * DRT_REC;
    const int ar = (int)rec[R_ALB], er = (int)rec[R_EMI];
    s_code[k] = (ar < cfg.n_alb - 1 ? ar + 1 : 0) |
                ((er < cfg.n_emi - 1 ? er + 1 : 0) << 8);
  }
  zero_column(cfg.n_alb, cfg.n_emi, s_dyn);
  __syncthreads();
  window_sweep<DMAX>(cfg, CodeDecode{s_code}, s_alb, s_emi, s_dyn, rsc,
                     rmeta, trips, g, partials);
}

// Whether drt_regen_sweep runs the window kernel for these table rows and
// depth on the current card (its ring and accumulator fit in a block's
// shared memory), else the per-pixel kernel (as launch_sweep decides);
// beyond DRT_MAX_DEPTH neither (the deep form).
static cudaError_t sweep_takes_window(int max_depth, int n_alb, int n_emi,
                                      bool* window) {
  if (max_depth > DRT_MAX_DEPTH) {
    *window = false;
    return cudaSuccess;
  }
  return max_depth <= DRT_SMALL_DEPTH
             ? takes_window(regen_window_kernel<DRT_SMALL_DEPTH>,
                            window_bytes<DRT_SMALL_DEPTH>(n_alb, n_emi),
                            window)
             : takes_window(regen_window_kernel<DRT_MAX_DEPTH>,
                            window_bytes<DRT_MAX_DEPTH>(n_alb, n_emi),
                            window);
}

// The per-pixel kernel (lockstep != 0 or where the window kernel does not
// fit) or the window kernel, beyond DRT_MAX_DEPTH bounces the deep form
// in both builds, then the reduction of the partials.
static int regen_sweep(const DrtTrace* cfg, const float* scene,
                       const float* alb, const float* emi, const float* rsc,
                       const int* rmeta, const int* trips, const float* g,
                       void* scratch, float* partials, float* da, float* de,
                       int lockstep, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->max_depth < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = cfg->n_rays, na = cfg->n_alb, ne = cfg->n_emi;
  const int rc =
      cfg->max_depth > DRT_MAX_DEPTH
          ? launch_regen_deep(regen_sweep_deep_kernel, cfg, scratch,
                              partials, s, scene, alb, emi, rsc, rmeta,
                              trips, g)
      : cfg->max_depth <= DRT_SMALL_DEPTH
          ? launch_sweep(lockstep, regen_window_kernel<DRT_SMALL_DEPTH>,
                         window_bytes<DRT_SMALL_DEPTH>(na, ne),
                         regen_sweep_kernel<DRT_SMALL_DEPTH>,
                         acc_bytes(na, ne), n, s, *cfg, scene, alb, emi, rsc,
                         rmeta, trips, g, partials)
          : launch_sweep(lockstep, regen_window_kernel<DRT_MAX_DEPTH>,
                         window_bytes<DRT_MAX_DEPTH>(na, ne),
                         regen_sweep_kernel<DRT_MAX_DEPTH>,
                         acc_bytes(na, ne), n, s, *cfg, scene, alb, emi, rsc,
                         rmeta, trips, g, partials);
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

extern "C" {

int drt_regen_adjoint_limits(int* max_shapes, int* max_rows, int* rec,
                             int* max_depth, int* block, int* window_rows,
                             int* windows_small, int* windows_max) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  *window_rows = REGEN_WIN;
  *windows_small = RegenRing<DRT_SMALL_DEPTH>::WINDOWS;
  *windows_max = RegenRing<DRT_MAX_DEPTH>::WINDOWS;
  return 0;
}

// Launches the sweep and the reduction of the partials on `stream` and
// returns the first CUDA error (0 on success). cfg->n_rays is the number
// of pixels; `partials` is scratch of ceil(n_pix / block) x entries floats.
// It runs the window kernel where its ring fits (sweep_takes_window),
// else the per-pixel kernel; beyond DRT_MAX_DEPTH bounces the deep form on
// `scratch` (drt_deep_bytes(n_pix, max_depth, n_alb, n_emi) bytes; unread
// otherwise).
int drt_regen_sweep(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* rsc, const int* rmeta,
                    const int* trips, const float* g, void* scratch,
                    float* partials, float* da, float* de, void* stream) {
  return regen_sweep(cfg, scene, alb, emi, rsc, rmeta, trips, g, scratch,
                     partials, da, de, 0, stream);
}

// The checking build: the per-pixel kernel at every launch, the bit
// reference of drt_regen_sweep.
int drt_regen_sweep_lockstep(const DrtTrace* cfg, const float* scene,
                             const float* alb, const float* emi,
                             const float* rsc, const int* rmeta,
                             const int* trips, const float* g, void* scratch,
                             float* partials, float* da, float* de,
                             void* stream) {
  return regen_sweep(cfg, scene, alb, emi, rsc, rmeta, trips, g, scratch,
                     partials, da, de, 1, stream);
}

// Whether drt_regen_sweep runs the window kernel (*window = 1), the
// per-pixel kernel (0) or the deep form (2) at this depth and these table
// rows on the current card, for its checks.
int drt_regen_sweep_form(int max_depth, int n_alb, int n_emi, int* window) {
  bool w = false;
  const cudaError_t e = sweep_takes_window(max_depth, n_alb, n_emi, &w);
  *window = max_depth > DRT_MAX_DEPTH ? 2 : w;
  return (int)e;
}

const char* drt_regen_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

DRT_DEEP_BYTES_ENTRY
