// Sweep adjoint of the path-regeneration tracer over the scene table for
// Hopper (sm_90a): parameter gradients (d_albedo f32[K+1, 3], d_emission
// f32[L+1, 3]) of sum_pixels g . L from a per-PIXEL cotangent g f32[3,
// n_pix], out of the rows that regen_tracer.cu's collect form stored.
// drt_regen_sweep replaces drt_tpu/ops/regen.py:make_regen_sweep_adjoint
// (pallas_call at regen.py:614). No geometry is touched: the scene table
// only maps a row's hit shape to its albedo and emission rows.
//
// One thread per pixel walks the pixel's own `trips` rows of every chunk,
// one sample's segment at a time (regen_body.cuh:regen_sweep_chunk), and
// adds into its accumulator column; the gradient tables are accumulated
// without float atomics by grad_accum.cuh, as in fused_adjoint.cu, so two
// runs give the same bits. There is no retrace kernel in this family:
// the retrace backward runs the collect tracer and this sweep per chunk.
//
// The per-sample values live in thread arrays of a compile-time size
// whose loops are unrolled: built for 8 bounces (registers) and for
// DRT_MAX_DEPTH = 32, the launch takes the smaller that holds max_depth.
//
// What bounds it: device memory, 8 bytes per trip run read once against
// about 20 f32 operations. All threads of a warp work on every segment
// (each pixel has spp_c of them per chunk), but segments differ in length,
// so the lanes of a warp drift apart in the row they read: a warp's load
// touches several 128-byte lines, most of them lines its neighbours read
// a few rows earlier or later.

#include "fused_body.cuh"
#include "grad_accum.cuh"
#include "regen_body.cuh"

#define DRT_MAX_DEPTH 32
#define DRT_SMALL_DEPTH 8

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

extern "C" {

int drt_regen_adjoint_limits(int* max_shapes, int* max_rows, int* rec,
                             int* max_depth, int* block) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  return 0;
}

// Launches the sweep and the reduction of the partials on `stream` and
// returns the first CUDA error (0 on success). cfg->n_rays is the number
// of pixels; `partials` is scratch of ceil(n_pix / block) x entries floats.
int drt_regen_sweep(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* rsc, const int* rmeta,
                    const int* trips, const float* g, float* partials,
                    float* da, float* de, void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->max_depth < 1 ||
      cfg->max_depth > DRT_MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(DMAX)                                                   \
  rc = allow_shared(regen_sweep_kernel<DMAX>, bytes);                      \
  if (rc) return rc;                                                       \
  regen_sweep_kernel<DMAX><<<grid, DRT_BLOCK, bytes, s>>>(                 \
      *cfg, scene, alb, emi, rsc, rmeta, trips, g, partials)
  if (cfg->max_depth <= DRT_SMALL_DEPTH) { DRT_LAUNCH(DRT_SMALL_DEPTH); }
  else { DRT_LAUNCH(DRT_MAX_DEPTH); }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

const char* drt_regen_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
