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
// It is regen_adjoint.cu with another row decoder, and two kernels as
// there. The per-pixel kernel (dyn_regen_sweep_kernel: one thread per
// pixel walks the pixel's own `trips` rows, one sample's segment at a
// time, regen_body.cuh:regen_sweep_chunk) is the checking build
// drt_dyn_regen_sweep_lockstep and the launch where the window kernel's
// ring does not fit. The window kernel (dyn_regen_window_kernel,
// drt_dyn_regen_sweep) is B11's window sweep (regen_window.cuh: each
// warp's rows copied in windows of adjacent pixels' rows into a ring in
// shared memory, swept in rounds of a segment a lane) with this decoder.
// Both add into the accumulator of grad_accum.cuh: no float atomics, two
// runs give the same bits, and the window kernel's tables are the
// per-pixel kernel's bit for bit. As in dyn_adjoint.cu the accumulator
// takes (real albedo rows + real emission rows) x 3 x 512 bytes of
// dynamic shared memory, which holds DYN_MAX_GRAD_ROWS = 144 real rows;
// above that, or beyond DRT_MAX_DEPTH bounces, both builds take the deep
// form (regen_window.cuh: dyn_regen_sweep_deep_kernel), whose accumulator
// and rows past DEEP_WINDOW live in device memory (grad_accum.cuh).
// The per-pixel kernel stages the 6 KB of parameter tables beside it; the
// window kernel stages only the tables' own rows, after its ring, so that
// at the mesh's 4 + 1 rows 5 blocks of it fit an SM. With the rings of 32
// KB (8 bounces) and 64 KB (32 bounces) the window kernel fits up to 128
// and 107 real rows in an H100's 227 KB a block; above, the launch takes
// the per-pixel kernel (dyn_regen_sweep_form says which).
//
// What bounds it: device memory, 8 bytes per trip run read once.

#include "dyn_body.cuh"
#include "grad_accum.cuh"
#include "regen_body.cuh"

#define DRT_MAX_DEPTH 32
#define DRT_SMALL_DEPTH 8
#define DYN_MAX_GRAD_ROWS 144
static_assert(DYN_MAX_GRAD_ROWS == DEEP_MAX_ACC_ROWS,
              "above these rows the deep form holds the accumulator");

#include "regen_window.cuh"

// rrow = albedo row | emission row << 8 | live << 16 | want << 17 |
// rr_on << 18 (dyn_regen_tracer.cu); a table's last row is its sentinel.
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

// The per-pixel kernel: one thread per pixel, all chunks.
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

// The deep form (regen_window.cuh:regen_deep_groups), beyond
// DRT_MAX_DEPTH bounces or DYN_MAX_GRAD_ROWS real table rows.
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_regen_sweep_deep_kernel(DrtTrace cfg, const float* __restrict__ alb,
                            const float* __restrict__ emi,
                            const float* __restrict__ rsc,
                            const int* __restrict__ rrow,
                            const int* __restrict__ trips,
                            const float* __restrict__ g, DeepScratch deep,
                            float* __restrict__ partials) {
  extern __shared__ float s_dyn[];
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);
  regen_deep_groups(cfg, tab, RowDecode{cfg}, rsc, rrow, trips, g, deep,
                    s_dyn, partials);
}

// Bytes of the window kernel's dynamic shared memory: window_bytes, then
// the albedo and emission tables.
template <int DMAX>
static int dyn_window_bytes(int n_alb, int n_emi) {
  return window_bytes<DMAX>(n_alb, n_emi) +
         (n_alb + n_emi) * 3 * (int)sizeof(float);
}

// The window kernel: the block's tables after its rings, then
// regen_window.cuh:window_sweep. Every thread of the block runs it to the
// end (it holds barriers).
template <int DMAX>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_regen_window_kernel(DrtTrace cfg, const float* __restrict__ alb,
                        const float* __restrict__ emi,
                        const float* __restrict__ rsc,
                        const int* __restrict__ rrow,
                        const int* __restrict__ trips,
                        const float* __restrict__ g,
                        float* __restrict__ partials) {
  extern __shared__ float s_dyn[];
  float* const s_alb = s_dyn + window_words<DMAX>(cfg.n_alb, cfg.n_emi);
  float* const s_emi = s_alb + cfg.n_alb * 3;
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    s_alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    s_emi[k] = emi[k];
  zero_column(cfg.n_alb, cfg.n_emi, s_dyn);
  __syncthreads();
  window_sweep<DMAX>(cfg, RowDecode{cfg}, s_alb, s_emi, s_dyn, rsc, rrow,
                     trips, g, partials);
}

// Whether drt_dyn_regen_sweep runs the window kernel for these table rows
// and depth on the current card (its tables, ring and accumulator fit in
// a block's shared memory), else the per-pixel kernel (as launch_sweep
// decides).
static cudaError_t dyn_sweep_takes_window(int max_depth, int n_alb,
                                          int n_emi, bool* window) {
  if (takes_deep(max_depth, n_alb, n_emi)) {
    *window = false;
    return cudaSuccess;
  }
  return max_depth <= DRT_SMALL_DEPTH
             ? takes_window(dyn_regen_window_kernel<DRT_SMALL_DEPTH>,
                            dyn_window_bytes<DRT_SMALL_DEPTH>(n_alb, n_emi),
                            window)
             : takes_window(dyn_regen_window_kernel<DRT_MAX_DEPTH>,
                            dyn_window_bytes<DRT_MAX_DEPTH>(n_alb, n_emi),
                            window);
}

// The per-pixel kernel (lockstep != 0 or where the window kernel does not
// fit) or the window kernel, beyond DRT_MAX_DEPTH bounces or
// DYN_MAX_GRAD_ROWS real rows the deep form in both builds, then the
// reduction of the partials.
static int dyn_regen_sweep(const DrtTrace* cfg, const float* alb,
                           const float* emi, const float* rsc,
                           const int* rrow, const int* trips, const float* g,
                           void* scratch, float* partials, float* da,
                           float* de, int lockstep, void* stream) {
  if (!dyn_tables_ok(cfg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = cfg->n_rays, na = cfg->n_alb, ne = cfg->n_emi;
  const int rc =
      takes_deep(cfg->max_depth, na, ne)
          ? launch_regen_deep(dyn_regen_sweep_deep_kernel, cfg, scratch,
                              partials, s, alb, emi, rsc, rrow, trips, g)
      : cfg->max_depth <= DRT_SMALL_DEPTH
          ? launch_sweep(lockstep, dyn_regen_window_kernel<DRT_SMALL_DEPTH>,
                         dyn_window_bytes<DRT_SMALL_DEPTH>(na, ne),
                         dyn_regen_sweep_kernel<DRT_SMALL_DEPTH>,
                         acc_bytes(na, ne), n, s, *cfg, alb, emi, rsc, rrow,
                         trips, g, partials)
          : launch_sweep(lockstep, dyn_regen_window_kernel<DRT_MAX_DEPTH>,
                         dyn_window_bytes<DRT_MAX_DEPTH>(na, ne),
                         dyn_regen_sweep_kernel<DRT_MAX_DEPTH>,
                         acc_bytes(na, ne), n, s, *cfg, alb, emi, rsc, rrow,
                         trips, g, partials);
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

extern "C" {

int drt_dyn_regen_adjoint_limits(int* max_rows, int* max_grad_rows,
                                 int* max_depth, int* block,
                                 int* window_rows, int* windows_small,
                                 int* windows_max) {
  *max_rows = DYN_MAX_ROWS;
  *max_grad_rows = DYN_MAX_GRAD_ROWS;
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
// It runs the window kernel where its ring fits (dyn_sweep_takes_window),
// else the per-pixel kernel; beyond DRT_MAX_DEPTH bounces or
// DYN_MAX_GRAD_ROWS real rows the deep form on `scratch`
// (drt_deep_bytes(n_pix, max_depth, n_alb, n_emi) bytes; unread
// otherwise).
int drt_dyn_regen_sweep(const DrtTrace* cfg, const float* alb,
                        const float* emi, const float* rsc, const int* rrow,
                        const int* trips, const float* g, void* scratch,
                        float* partials, float* da, float* de,
                        void* stream) {
  return dyn_regen_sweep(cfg, alb, emi, rsc, rrow, trips, g, scratch,
                         partials, da, de, 0, stream);
}

// The checking build: the per-pixel kernel at every launch, the bit
// reference of drt_dyn_regen_sweep.
int drt_dyn_regen_sweep_lockstep(const DrtTrace* cfg, const float* alb,
                                 const float* emi, const float* rsc,
                                 const int* rrow, const int* trips,
                                 const float* g, void* scratch,
                                 float* partials, float* da, float* de,
                                 void* stream) {
  return dyn_regen_sweep(cfg, alb, emi, rsc, rrow, trips, g, scratch,
                         partials, da, de, 1, stream);
}

// Whether drt_dyn_regen_sweep runs the window kernel (*window = 1), the
// per-pixel kernel (0) or the deep form (2) at this depth and these table
// rows on the current card, for its checks.
int drt_dyn_regen_sweep_form(int max_depth, int n_alb, int n_emi,
                             int* window) {
  bool w = false;
  const cudaError_t e = dyn_sweep_takes_window(max_depth, n_alb, n_emi, &w);
  *window = takes_deep(max_depth, n_alb, n_emi) ? 2 : w;
  return (int)e;
}

const char* drt_dyn_regen_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

DRT_DEEP_BYTES_ENTRY
