// Sweep adjoint of the path-regeneration tracer over a memory-resident
// scene for Hopper (sm_90a): parameter gradients (d_albedo f32[K+1, 3],
// d_emission f32[L+1, 3]) of sum_pixels g . L from a per-PIXEL cotangent g
// f32[3, n_pix], out of the rows that dyn_regen_tracer.cu's collect form
// stored. drt_dyn_regen_sweep replaces
// drt_tpu/ops/dynregen.py:make_dyn_regen_sweep_adjoint (pallas_call at
// dynregen.py:474). The rows carry the table rows of every trip (albedo
// row | emission row << 8 | live << 16 | want << 17 | rr_on << 18), so
// this kernel reads no scene at all.
//
// It is regen_adjoint.cu with another row decoder: one thread per pixel
// walks the pixel's own `trips` rows, one sample's segment at a time
// (regen_body.cuh:regen_sweep_chunk), into the accumulator of
// grad_accum.cuh: no float atomics, two runs give the same bits. As in
// dyn_adjoint.cu the accumulator takes (real albedo rows + real emission
// rows) x 3 x 512 bytes of dynamic shared memory beside the 6 KB of
// parameter tables, which holds DYN_MAX_GRAD_ROWS = 144 real rows; above
// that the launch is refused (the wrapper raises with the count).
//
// What bounds it: device memory, 8 bytes per trip run read once.

#include "dyn_body.cuh"
#include "grad_accum.cuh"
#include "regen_body.cuh"

#define DRT_MAX_DEPTH 32
#define DRT_SMALL_DEPTH 8
#define DYN_MAX_GRAD_ROWS 144

struct RowDecode {
  const DrtTrace& cfg;
  __device__ __forceinline__ bool want(int pack) const {
    return (pack >> (2 * DYN_ROW_BITS + 1)) & 1;
  }
  __device__ __forceinline__ RegenRow row(int pack) const {
    const int ar = pack & (DYN_MAX_ROWS - 1);
    const int er = (pack >> DYN_ROW_BITS) & (DYN_MAX_ROWS - 1);
    return {ar < cfg.n_alb - 1 ? ar : -1, er < cfg.n_emi - 1 ? er : -1,
            (bool)((pack >> (2 * DYN_ROW_BITS)) & 1),
            (bool)((pack >> (2 * DYN_ROW_BITS + 2)) & 1)};
  }
};

template <int DMAX>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_regen_sweep_kernel(DrtTrace cfg, const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const float* __restrict__ rsc,
                       const int* __restrict__ rrow,
                       const int* __restrict__ trips,
                       const float* __restrict__ g,
                       float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = cfg.n_rays;  // pixels
  if (pix < n) {
    const float gp[3] = {g[pix], g[n + pix], g[2 * n + pix]};
    const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;
    const RowDecode decode{cfg};
    for (int c = 0; c < cfg.n_chunks; ++c) {
      const size_t base = (size_t)c * t_cap * n + pix;
      regen_sweep_chunk<DMAX>(cfg, tab, decode, rsc + base, rrow + base,
                              (size_t)n, trips[(size_t)c * n + pix], gp,
                              s_acc + threadIdx.x);
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

extern "C" {

int drt_dyn_regen_adjoint_limits(int* max_rows, int* max_grad_rows,
                                 int* max_depth, int* block) {
  *max_rows = DYN_MAX_ROWS;
  *max_grad_rows = DYN_MAX_GRAD_ROWS;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  return 0;
}

// Launches the sweep and the reduction of the partials on `stream` and
// returns the first CUDA error (0 on success). cfg->n_rays is the number
// of pixels; `partials` is scratch of ceil(n_pix / block) x entries floats.
int drt_dyn_regen_sweep(const DrtTrace* cfg, const float* alb,
                        const float* emi, const float* rsc, const int* rrow,
                        const int* trips, const float* g, float* partials,
                        float* da, float* de, void* stream) {
  if (!dyn_tables_ok(cfg) || cfg->max_depth > DRT_MAX_DEPTH ||
      cfg->n_alb - 1 + cfg->n_emi - 1 > DYN_MAX_GRAD_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(DMAX)                                                   \
  rc = allow_shared(dyn_regen_sweep_kernel<DMAX>, bytes);                  \
  if (rc) return rc;                                                       \
  dyn_regen_sweep_kernel<DMAX><<<grid, DRT_BLOCK, bytes, s>>>(             \
      *cfg, alb, emi, rsc, rrow, trips, g, partials)
  if (cfg->max_depth <= DRT_SMALL_DEPTH) { DRT_LAUNCH(DRT_SMALL_DEPTH); }
  else { DRT_LAUNCH(DRT_MAX_DEPTH); }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

const char* drt_dyn_regen_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
