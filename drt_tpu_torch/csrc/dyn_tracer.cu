// Forward path tracers over a memory-resident scene for Hopper (sm_90a):
// camera ray, sampling and the whole max_depth bounce loop of one ray per
// thread, in one launch, over a scene of up to 2048 shapes that is read
// from device memory at run time (dyn_body.cuh). Two entry points over one
// kernel template:
//  - drt_dyn_trace replaces drt_tpu/ops/dynkernel.py:make_dyn_tracer
//    (pallas_call at dynkernel.py:1030);
//  - drt_dyn_collect replaces dynkernel.py:make_dyn_collect_tracer
//    (pallas_call at :1172): the same trace, which also writes the
//    adjoint's residuals rsc f32[C, D, n] (the sampling weight) and rrow
//    i32[C, D, n] = albedo row | emission row << 8 | live << 16, 8 bytes
//    per bounce-ray, for the sweep adjoint of dyn_adjoint.cu. Its radiance
//    is the tracer's bit for bit;
//  - drt_dyn_cull_stats runs the tracer in a checking build that counts
//    the lane-bounces that ran the nearest hit and the leaves the rays and
//    the warps entered;
//  - drt_dyn_trace_lanes runs the tracer in a checking build that tests
//    the leaves per thread (dyn_intersect), the reference that the warp's
//    leaf test is held to: its radiance is drt_dyn_trace's bit for bit on
//    every layout, in both variants. No renderer launches it.
//
// One thread per ray slot with the spp-chunk loop inside the thread, the
// keyed hash for the internal RNG and the spp-outer ray order, exactly as
// the scene-table tracer (fused_tracer.cu): the same seeds give the same
// samples in both families.
//
// What bounds it: operations. Per live bounce a ray tests every plane and
// sphere, one box per super cluster, one per leaf of an entered super
// cluster and cluster_k triangles per entered leaf (about 50 f32
// operations each); it moves 12 bytes per ray slot (plus 8 per bounce-ray
// in the collect tracer), which the card does in well under a
// millisecond. After the first bounce the rays of a warp point
// everywhere: on the 1287-shape mesh at 640x480x64 spp about 2 of 32
// lanes enter a given leaf (the counters of the checking build), so a
// leaf's triangle loop run per thread kept 30 lanes idle and took most of
// the kernel's time. The leaves are therefore tested by the whole warp,
// one entered ray at a time, each lane on its own triangle, with the
// valid candidates folded in index order (the head of dyn_body.cuh says
// why that keeps the bits): every thread of the grid reaches that loop,
// the threads past the last ray slot as dead paths that store nothing.
// What is left per thread is the box walk, the shading and the lanes that
// Russian roulette has killed. Shared memory holds 6 KB of parameter
// tables and occupancy is set by registers (the ptxas report).
//
// Variants: FAST = false keeps the reference forms, FAST = true takes
// rsqrt, the cancelled shading quotients and the ratio form of the
// nearest hit, as the TPU kernel's fastmath does.

#include "dyn_body.cuh"

// The hook of the collect tracer: bounce b of this ray slot and chunk. A
// thread past the last ray slot (lane false) stores nothing: its sentinel
// rows would overwrite the last slot's.
struct DynStoreResidual {
  float* sc;  // rsc + (c * D) * N + i
  int* row;   // rrow likewise
  size_t n;
  bool lane;
  __device__ __forceinline__ void operator()(int b, float, float, float,
                                             float sc_b, float, int arow,
                                             int erow, bool alive) const {
    if (!lane) return;
    sc[(size_t)b * n] = sc_b;
    row[(size_t)b * n] = arow + (erow << DYN_ROW_BITS) +
                         (alive ? 1 << (2 * DYN_ROW_BITS) : 0);
  }
};

template <bool FAST, bool INTERNAL, bool COLLECT, bool COUNT>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_trace_kernel(DrtTrace cfg, DynLayout lay, DrtCamera cam, DynOperands scn,
                 const float* __restrict__ alb, const float* __restrict__ emi,
                 const float* __restrict__ cam_u,
                 const float* __restrict__ tape, float* __restrict__ out,
                 float* __restrict__ rsc, int* __restrict__ rrow,
                 unsigned long long* stats) {
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);

  // Every thread of the warp takes part in its leaf loop: one past the
  // last ray slot traces slot N - 1 as a dead path and writes nothing.
  const int N = cfg.n_rays;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = slot < N;
  const int i = lane ? slot : N - 1;

  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    float lx, ly, lz;
    if constexpr (COLLECT) {
      const size_t base = (size_t)c * cfg.max_depth * N + i;
      DynStoreResidual hook{rsc + base, rrow + base, (size_t)N, lane};
      dyn_trace_chunk<FAST, INTERNAL, COUNT, true>(cfg, lay, cam, scn, tab,
                                                   cam_u, tape, i, lane, c,
                                                   hook, lx, ly, lz, stats);
    } else {
      DynNoResidual hook;
      dyn_trace_chunk<FAST, INTERNAL, COUNT, true>(cfg, lay, cam, scn, tab,
                                                   cam_u, tape, i, lane, c,
                                                   hook, lx, ly, lz, stats);
    }
    Lx = Lx + lx;
    Ly = Ly + ly;
    Lz = Lz + lz;
  }
  if (!lane) return;
  out[i] = Lx;
  out[N + i] = Ly;
  out[2 * N + i] = Lz;
}

// The per-thread reference build: each thread traces its own ray slot
// alone, the leaves' triangles in a loop of its own.
template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
dyn_trace_lanes_kernel(DrtTrace cfg, DynLayout lay, DrtCamera cam,
                       DynOperands scn, const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const float* __restrict__ cam_u,
                       const float* __restrict__ tape,
                       float* __restrict__ out) {
  __shared__ DynTables tab;
  dyn_stage_tables(cfg, alb, emi, tab);

  const int N = cfg.n_rays;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;  // summed over chunks
  for (int c = 0; c < cfg.n_chunks; ++c) {
    float lx, ly, lz;
    DynNoResidual hook;
    dyn_trace_chunk<FAST, INTERNAL, false, false>(cfg, lay, cam, scn, tab,
                                                  cam_u, tape, i, true, c,
                                                  hook, lx, ly, lz, nullptr);
    Lx = Lx + lx;
    Ly = Ly + ly;
    Lz = Lz + lz;
  }
  out[i] = Lx;
  out[N + i] = Ly;
  out[2 * N + i] = Lz;
}

template <bool COLLECT>
static int launch(const DrtTrace* cfg, const DynLayout* lay,
                  const DrtCamera* cam, const DynOperands* scn,
                  const float* alb, const float* emi, const float* cam_u,
                  const float* tape, float* out, float* rsc, int* rrow,
                  void* stream) {
  if (!dyn_cfg_ok(cfg, lay)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, I)                                                  \
  dyn_trace_kernel<F, I, COLLECT, false><<<grid, DRT_BLOCK, 0, s>>>(      \
      *cfg, *lay, *cam, *scn, alb, emi, cam_u, tape, out, rsc, rrow,      \
      nullptr)
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

int drt_dyn_limits(int* max_rows, int* n_stats, int* block) {
  *max_rows = DYN_MAX_ROWS;
  *n_stats = DYN_N_STATS;
  *block = DRT_BLOCK;
  return 0;
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success). Shapes and types are checked by the Python wrappers.
int drt_dyn_trace(const DrtTrace* cfg, const DynLayout* lay,
                  const DrtCamera* cam, const DynOperands* scn,
                  const float* alb, const float* emi, const float* cam_u,
                  const float* tape, float* out, void* stream) {
  return launch<false>(cfg, lay, cam, scn, alb, emi, cam_u, tape, out,
                       nullptr, nullptr, stream);
}

int drt_dyn_collect(const DrtTrace* cfg, const DynLayout* lay,
                    const DrtCamera* cam, const DynOperands* scn,
                    const float* alb, const float* emi, const float* cam_u,
                    const float* tape, float* out, float* rsc, int* rrow,
                    void* stream) {
  return launch<true>(cfg, lay, cam, scn, alb, emi, cam_u, tape, out, rsc,
                      rrow, stream);
}

// The tracer's fast internal-RNG variant with the counters of dyn_body.cuh
// added into stats u64[DYN_N_STATS] (which the caller zeroes).
int drt_dyn_cull_stats(const DrtTrace* cfg, const DynLayout* lay,
                       const DrtCamera* cam, const DynOperands* scn,
                       const float* alb, const float* emi, float* out,
                       unsigned long long* stats, void* stream) {
  if (!dyn_cfg_ok(cfg, lay) || !cfg->internal_rng)
    return (int)cudaErrorInvalidValue;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  dyn_trace_kernel<true, true, false, true>
      <<<grid, DRT_BLOCK, 0, (cudaStream_t)stream>>>(
          *cfg, *lay, *cam, *scn, alb, emi, nullptr, nullptr, out, nullptr,
          nullptr, stats);
  return (int)cudaGetLastError();
}

// The per-thread reference build of drt_dyn_trace, with its arguments.
int drt_dyn_trace_lanes(const DrtTrace* cfg, const DynLayout* lay,
                        const DrtCamera* cam, const DynOperands* scn,
                        const float* alb, const float* emi,
                        const float* cam_u, const float* tape, float* out,
                        void* stream) {
  if (!dyn_cfg_ok(cfg, lay)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(F, I)                                                  \
  dyn_trace_lanes_kernel<F, I><<<grid, DRT_BLOCK, 0, s>>>(                \
      *cfg, *lay, *cam, *scn, alb, emi, cam_u, tape, out)
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

const char* drt_dyn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
