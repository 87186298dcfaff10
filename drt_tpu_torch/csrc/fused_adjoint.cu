// Radiative-backprop adjoints of the fused tracer for Hopper (sm_90a):
// parameter gradients (d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of
// sum_rays g . L from a per-ray (or per-pixel) cotangent g.
//
//  - drt_fused_sweep replaces drt_tpu/ops/megakernel.py:
//    make_fused_sweep_adjoint (pallas_call at :1483): from the residuals
//    (rsc, rbest) that the collect tracer of fused_tracer.cu stored, it
//    replays gate_b = rr_b [best_b > 0], P_b = T_{b-1} gate_b,
//    T_b = P_b a_b sc_b in the forward's op order (megakernel.py:1421-1440)
//    and runs the reverse sweep. No geometry is touched.
//  - drt_fused_adjoint replaces megakernel.py:make_fused_segment_adjoint
//    (pallas_call at :1672, behind make_fused_adjoint) at b_start = 0,
//    b_end = max_depth: it retraces the forward with the bounce body of
//    fused_body.cuh, keeping P, sc, gate and best of every bounce in the
//    thread, then runs the same reverse sweep. Unbiased mode calls it with
//    a salted bounce seed.
//  - drt_ray_adjoint replaces megakernel.py:make_pallas_adjoint
//    (pallas_call at :966), the backward of the key-driven wavefront: the
//    retrace of drt_ray_trace (fused_tracer.cu) on the input rays o, d and
//    tape, the reverse sweep with a per-ray cotangent g f32[3, N] and the
//    reduction; trace_rays(collect=True) + adjoint._param_grads as one
//    kernel. It runs B4's retrace, sweep and accumulation on a ray read
//    from memory where B4 makes it from the camera, so on B4's own rays,
//    tape and cotangent its tables are B4's bit for bit. Exact variant,
//    built for 32 bounces like B4; bound like B4 (it reads 96 bytes per
//    ray at depth 5, 0.14 ms of the card's memory rate at 4.9 M rays).
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
//  - max_depth is a run-time value; the per-bounce values live in thread
//    arrays of a compile-time size whose loops are unrolled, so that the
//    sweep adjoint can keep them in registers: it is built for 8 bounces
//    and for DRT_MAX_DEPTH = 32, and the launch takes the smaller that
//    holds max_depth. The retrace adjoint indexes its arrays by the bounce
//    counter of the shared body, so they live in local memory at either
//    size and it is built for 32 only. Deeper paths are refused.
//
// What bounds them: the sweep adjoint is bound by device memory. It reads
// 8 bytes per bounce-ray once (3.15 GB at 640x480x256 spp, depth 5) and
// does about 20 f32 operations per bounce-ray, an order of magnitude below
// what the card can do in the time the read takes; the ray slot is the
// fastest index, so a warp reads whole 128-byte lines. The retrace adjoint
// is bound like the tracer, by f32 and special-function issue and warp
// divergence; the sweep adds a few percent to its work.

#include "fused_body.cuh"
#include "grad_accum.cuh"

#define DRT_MAX_DEPTH 32
#define DRT_SMALL_DEPTH 8

// Per-bounce values of one ray slot in one chunk.
template <int DMAX>
struct Residuals {
  float P[DMAX][3];
  float sc[DMAX];
  float gate[DMAX];
  int best[DMAX];
};

// The hook of the retrace adjoint.
struct KeepResidual {
  Residuals<DRT_MAX_DEPTH>& r;
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
template <int DMAX>
static __device__ __forceinline__ void reverse_sweep(
    const DrtTrace& cfg, const DrtTables& tab, const Residuals<DMAX>& r,
    float gx, float gy, float gz, float* acc) {
  float S[3] = {0.0f, 0.0f, 0.0f};
  const float g[3] = {gx, gy, gz};
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
#pragma unroll
  for (int b = DMAX - 1; b >= 0; --b) {
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

template <int DMAX>
__global__ void __launch_bounds__(DRT_BLOCK)
fused_sweep_kernel(DrtTrace cfg, const float* __restrict__ scene,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ rsc,
                   const int* __restrict__ rbest,
                   const float* __restrict__ g, int g_n,
                   float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.n_rays;
  if (i < N) {
    const int gi = i % g_n;
    const float gx = g[gi], gy = g[g_n + gi], gz = g[2 * g_n + gi];
    for (int c = 0; c < cfg.n_chunks; ++c) {
      Residuals<DMAX> r;
      const size_t base = (size_t)c * cfg.max_depth * N + i;
      float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
#pragma unroll
      for (int b = 0; b < DMAX; ++b) {
        if (b >= cfg.max_depth) continue;
        const float sc = rsc[base + (size_t)b * N];
        const int best = rbest[base + (size_t)b * N];
        const float rr = b >= cfg.min_bounces ? cfg.inv_keep : 1.0f;
        const float gate = best > 0 ? rr : 0.0f;
        const float Px = Tx * gate, Py = Ty * gate, Pz = Tz * gate;
        float ax = 1.0f, ay = 1.0f, az = 1.0f;
        if (best > 0) {
          const int ar = (int)tab.scene[(best - 1) * DRT_REC + R_ALB];
          if (ar < cfg.n_alb - 1) {
            ax = tab.alb[ar * 3 + 0];
            ay = tab.alb[ar * 3 + 1];
            az = tab.alb[ar * 3 + 2];
          }
        }
        Tx = Px * ax * sc;
        Ty = Py * ay * sc;
        Tz = Pz * az * sc;
        r.P[b][0] = Px; r.P[b][1] = Py; r.P[b][2] = Pz;
        r.sc[b] = sc;
        r.gate[b] = gate;
        r.best[b] = best;
      }
      reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

template <bool FAST, bool INTERNAL>
__global__ void __launch_bounds__(DRT_BLOCK)
fused_adjoint_kernel(DrtTrace cfg, DrtCamera cam,
                     const float* __restrict__ scene,
                     const float* __restrict__ alb,
                     const float* __restrict__ emi,
                     const float* __restrict__ cam_u,
                     const float* __restrict__ tape,
                     const float* __restrict__ g, int g_n,
                     float* __restrict__ partials) {
  extern __shared__ float s_acc[];
  __shared__ DrtTables tab;
  stage_tables(cfg, scene, alb, emi, tab);
  zero_column(cfg.n_alb, cfg.n_emi, s_acc);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cfg.n_rays) {
    const int gi = i % g_n;
    const float gx = g[gi], gy = g[g_n + gi], gz = g[2 * g_n + gi];
    for (int c = 0; c < cfg.n_chunks; ++c) {
      Residuals<DRT_MAX_DEPTH> r;
      KeepResidual hook{r};
      float lx, ly, lz;
      trace_chunk<FAST, INTERNAL>(cfg, cam, tab, cam_u, tape, i, c, hook,
                                  lx, ly, lz);
      reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);
    }
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
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
    Residuals<DRT_MAX_DEPTH> r;
    KeepResidual hook{r};
    float lx, ly, lz;
    trace_ray(cfg, tab, o, d, tape, i, hook, lx, ly, lz);
    reverse_sweep(cfg, tab, r, g[i], g[N + i], g[2 * N + i],
                  s_acc + threadIdx.x);
  }
  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);
}

// The hook of the segment adjoint: bounce b of a segment that starts at
// b0 is row b - b0.
struct KeepSegmentResidual {
  Residuals<DRT_MAX_DEPTH>& r;
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
    const Residuals<DRT_MAX_DEPTH>& r, int n, const float g[3], float S[3],
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
    Residuals<DRT_MAX_DEPTH> r;
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

extern "C" {

int drt_adjoint_limits(int* max_shapes, int* max_rows, int* rec,
                       int* max_depth, int* block) {
  *max_shapes = DRT_MAX_SHAPES;
  *max_rows = DRT_MAX_ROWS;
  *rec = DRT_REC;
  *max_depth = DRT_MAX_DEPTH;
  *block = DRT_BLOCK;
  return 0;
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
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(DMAX)                                                   \
  rc = allow_shared(fused_sweep_kernel<DMAX>, bytes);                      \
  if (rc) return rc;                                                       \
  fused_sweep_kernel<DMAX><<<grid, DRT_BLOCK, bytes, s>>>(                 \
      *cfg, scene, alb, emi, rsc, rbest, g, g_n, partials)
  if (cfg->max_depth <= DRT_SMALL_DEPTH) { DRT_LAUNCH(DRT_SMALL_DEPTH); }
  else { DRT_LAUNCH(DRT_MAX_DEPTH); }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

int drt_fused_adjoint(const DrtTrace* cfg, const DrtCamera* cam,
                      const float* scene, const float* alb, const float* emi,
                      const float* cam_u, const float* tape, const float* g,
                      int g_n, float* partials, float* da, float* de,
                      void* stream) {
  if (!adjoint_cfg_ok(cfg, g_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);
  int rc;
#define DRT_LAUNCH(F, I)                                                   \
  rc = allow_shared(fused_adjoint_kernel<F, I>, bytes);                    \
  if (rc) return rc;                                                       \
  fused_adjoint_kernel<F, I><<<grid, DRT_BLOCK, bytes, s>>>(               \
      *cfg, *cam, scene, alb, emi, cam_u, tape, g, g_n, partials)
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

// g is f32[3, n_rays], one cotangent per ray; one chunk, exact variant,
// tape mode only.
int drt_ray_adjoint(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* o, const float* d,
                    const float* tape, const float* g, float* partials,
                    float* da, float* de, void* stream) {
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
