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
//
// What bounds it: device memory, 8 bytes per trip run read once against
// about 20 f32 operations and the accumulator's read-modify-writes in
// shared memory. Row t of 32 adjacent pixels is one 128-byte line of rsc
// and one of rmeta (rsc[c][t][pix]).
//
// Two kernels. The per-pixel kernel (regen_sweep_kernel, the checking
// build drt_regen_sweep_lockstep, and the launch where the ring below
// does not fit) has one thread walk its rows with regen_body.cuh:
// regen_sweep_chunk, which reads each row from device memory when the
// replay reaches it and the next row's rmeta only after it has decoded
// the one before; segments differ in length, so the lanes of a warp drift
// apart in the row they read and a warp's load touches several lines, on
// a chain of dependent loads. The window kernel (regen_window_kernel,
// drt_regen_sweep) reads the rows of a warp together instead:
//  - A persistent grid (queue_grid) over 128-pixel groups: block k takes
//    groups k, k + grid, ..., each group's chunks in order, an item being
//    one (group, chunk); each thread the pixel of its lane in the group.
//    The tables and one code word per shape (its albedo and emission
//    rows) are staged once per block.
//  - Each warp copies the rows [v W, v W + W) of its 32 pixels (window v,
//    W = REGEN_WIN rows) with cp.async into a ring of WINDOWS windows in
//    dynamic shared memory, one 128-byte line of rsc and of rmeta per row,
//    up to the largest `trips` of its pixels in the item; a lane copies
//    only its own pixel's rows below its own trips, so a row past them is
//    never read, and reads back only its own column, so no barrier guards
//    the ring.
//  - The lanes sweep in rounds, a segment each: a round waits until the
//    rows of every lane's next segment have landed (a segment that starts
//    at t holds at most max_depth rows, and the replay reads the row
//    after its last to see that it ends: rows up to t + max_depth, or all
//    of the lane's), so that the lanes of a warp sweep their j-th
//    segments together, as in the per-pixel kernel, whose lanes each have
//    spp_c segments a chunk. Each lane replays and sweeps its segment from
//    the ring. Then the warp copies the next windows into the slots that
//    every lane has passed (window v takes the slots of window v - WINDOWS
//    once each lane still at work is past its rows). Where the ring
//    cannot take a window that a round waits for (the lanes' rows too far
//    apart), the round sweeps the lanes whose rows have landed; the lane
//    furthest behind always has its rows, which the ring's size
//    guarantees.
// At the main shape the copies and rounds alone take about a third of
// its time and the accumulator's read-modify-writes a quarter; the rest
// is the replay and the sweep, whose lanes wait for the longest segment
// of their round (PERF.md section 6, tools/ablate_sweep.py --kernel b11).
//
// The bits: each pixel's column takes its chunks in chunk order, its
// segments in row order and each segment's rows through the statements
// of regen_sweep_chunk (window_segment repeats them on rows from the
// ring: the same values); each group is summed by block_reduce_row into
// the group's row of partials, and reduce_partials is unchanged. So the
// tables are the per-pixel kernel's bit for bit.

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

#define REGEN_WIN 8  // rows of a window

// The window kernel's ring: windows per instance, at least
// DMAX / REGEN_WIN + 1, which the copy rule needs to stay one window ahead
// of the wait (a lane still at work after a round is at most max_depth
// rows behind the rows landed). The 8-bounce instance's 4 windows leave 5
// blocks an SM; 3 (more rounds wait) and 8 (3 blocks an SM) took longer.
template <int DMAX>
struct RegenRing {
  static constexpr int WINDOWS = DMAX <= DRT_SMALL_DEPTH ? 4 : 8;
  static constexpr int ROWS = WINDOWS * REGEN_WIN;
  static_assert((WINDOWS - 1) * REGEN_WIN >= DMAX,
                "the ring cannot hold a segment ahead of the copies");
};

// cp.async of 4 bytes from global to shared memory; with pred false it
// reads nothing and writes 0. Unlike sweep_rows.cuh's, these carry memory
// clobbers, which keep the compiler from moving the ring's loads across
// the copies and the waits.
static __device__ __forceinline__ void ring_copy4(void* dst, const void* src,
                                                  bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

static __device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 to 7) groups of copies are in flight.
static __device__ __forceinline__ void ring_wait(int pending) {
  switch (pending) {
#define DRT_WAIT(N)                                                        \
  case N:                                                                  \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory");            \
    break;
    DRT_WAIT(0) DRT_WAIT(1) DRT_WAIT(2) DRT_WAIT(3)
    DRT_WAIT(4) DRT_WAIT(5) DRT_WAIT(6)
#undef DRT_WAIT
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

// A lane's column of its warp's ring: row t at slot t % ROWS, the slots
// 32 words apart.
template <int ROWS>
struct WindowRows {
  const float* sc;
  const int* meta;
  __device__ __forceinline__ float sc_of(int t) const {
    return sc[((unsigned)t % ROWS) * 32];
  }
  __device__ __forceinline__ int meta_of(int t) const {
    return meta[((unsigned)t % ROWS) * 32];
  }
};

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

// The segment of one sample that starts at row t (a want row) of a lane's
// t_act rows: replayed and swept into the thread's accumulator column by
// the statements of regen_body.cuh:regen_sweep_chunk, on rows from the
// ring. Returns its length.
template <int DMAX, int ROWS>
static __device__ __forceinline__ int window_segment(
    const DrtTrace& cfg, const float* s_alb, const float* s_emi,
    const CodeDecode& decode, const WindowRows<ROWS>& rows, int t,
    int t_act, const float g[3], float* acc, float* acc_e) {
  int meta = rows.meta_of(t);
  float P[DMAX][3], sc[DMAX], gate[DMAX];
  int arow[DMAX], erow[DMAX];
  float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
  int len = 0;
  bool open = true;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (!open) continue;
    const RegenRow r = decode.row(meta);
    const float sc_k = rows.sc_of(t + k);
    const float rr = r.rr_on ? cfg.inv_keep : 1.0f;
    const float gate_k = r.live ? rr : 0.0f;
    const float Px = Tx * gate_k, Py = Ty * gate_k, Pz = Tz * gate_k;
    float ax = 1.0f, ay = 1.0f, az = 1.0f;
    if (r.arow >= 0) {
      ax = s_alb[r.arow * 3 + 0];
      ay = s_alb[r.arow * 3 + 1];
      az = s_alb[r.arow * 3 + 2];
    }
    Tx = Px * ax * sc_k;
    Ty = Py * ay * sc_k;
    Tz = Pz * az * sc_k;
    P[k][0] = Px; P[k][1] = Py; P[k][2] = Pz;
    sc[k] = sc_k;
    gate[k] = gate_k;
    arow[k] = r.arow;
    erow[k] = r.erow;
    len = k + 1;
    // The segment ends before the next want row, or with the rows.
    open = false;
    if (t + k + 1 < t_act) {
      meta = rows.meta_of(t + k + 1);
      open = !decode.want(meta);
    }
  }
  float S[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = DMAX - 1; k >= 0; --k) {
    if (k >= len) continue;
    float e[3] = {0.0f, 0.0f, 0.0f};
    float a[3] = {1.0f, 1.0f, 1.0f};
    if (erow[k] >= 0) {
      e[0] = s_emi[erow[k] * 3 + 0];
      e[1] = s_emi[erow[k] * 3 + 1];
      e[2] = s_emi[erow[k] * 3 + 2];
    }
    if (arow[k] >= 0) {
      a[0] = s_alb[arow[k] * 3 + 0];
      a[1] = s_alb[arow[k] * 3 + 1];
      a[2] = s_alb[arow[k] * 3 + 2];
    }
    sweep_bounce(acc, acc_e, arow[k], erow[k], a, e, P[k], sc[k], gate[k], g,
                 S);
  }
  return len;
}

// Bytes of the window kernel's dynamic shared memory: the accumulator,
// then each warp's ring (rsc, then rmeta, ROWS x 32 words each).
template <int DMAX>
static int window_bytes(int n_alb, int n_emi) {
  return acc_bytes(n_alb, n_emi) + (DRT_BLOCK / 32) * 2 *
                                       RegenRing<DMAX>::ROWS * 32 *
                                       (int)sizeof(float);
}

// The window kernel (the notes at the top). Every thread of the block
// runs it to the end (it holds barriers).
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
  using Ring = RegenRing<DMAX>;
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

  const int n = cfg.n_rays, D = cfg.max_depth, C = cfg.n_chunks;
  const size_t t_cap = (size_t)cfg.spp_c * D;
  const int groups = (n + DRT_BLOCK - 1) / DRT_BLOCK;
  const int E = n_entries(cfg.n_alb, cfg.n_emi);
  const int lane = threadIdx.x & 31;
  float* const acc = s_dyn + threadIdx.x;
  float* const acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  float* const ring_sc =
      s_dyn + E * DRT_BLOCK + (threadIdx.x >> 5) * 2 * Ring::ROWS * 32 + lane;
  int* const ring_meta = reinterpret_cast<int*>(ring_sc + Ring::ROWS * 32);
  const WindowRows<Ring::ROWS> rows{ring_sc, ring_meta};
  const CodeDecode decode{s_code};
  float gp[3] = {0.0f, 0.0f, 0.0f};

  int grp = blockIdx.x, c = 0;  // the item: group grp, chunk c
  while (grp < groups) {
    const int pix = grp * DRT_BLOCK + threadIdx.x;
    const bool ok = pix < n;
    if (c == 0 && ok) {
      gp[0] = g[pix];
      gp[1] = g[n + pix];
      gp[2] = g[2 * n + pix];
    }
    const size_t base = (size_t)c * t_cap * n + (ok ? pix : 0);
    const int tr = ok ? trips[(size_t)c * n + pix] : 0;
    const int n_win =
        (__reduce_max_sync(0xffffffffu, tr) + REGEN_WIN - 1) / REGEN_WIN;
    // Copy window v into its slots.
    auto copy = [&](int v) {
#pragma unroll
      for (int k = 0; k < REGEN_WIN; ++k) {
        const int r = v * REGEN_WIN + k;
        const int slot = ((unsigned)r % Ring::ROWS) * 32;
        const bool on = r < tr;
        const size_t at = base + (on ? (size_t)r * n : 0);
        ring_copy4(ring_sc + slot, rsc + at, on);
        ring_copy4(ring_meta + slot, rmeta + at, on);
      }
      ring_commit();
    };
    // Window v may be copied once every lane at work is past the rows of
    // window v - WINDOWS, whose slots it takes.
    auto may_copy = [&](int v, int t_min) {
      return v < n_win && (v - Ring::WINDOWS + 1) * REGEN_WIN <= t_min;
    };
    int copied = 0, landed = 0;  // windows copied, windows landed
    for (; copied < n_win && copied < Ring::WINDOWS; ++copied) copy(copied);
    int t = 0;  // the lane's next segment
    // A round: every lane at work sweeps its next segment, once the rows
    // it needs (the segment's and the row after them) have landed for
    // all of them; where the ring cannot take a window the round waits
    // for (a lane far behind the others), the lanes whose rows have.
    while (__any_sync(0xffffffffu, t < tr)) {
      const bool work = t < tr;
      const int need = __reduce_max_sync(
          0xffffffffu, work ? min(t + D + 1, tr) : 0);
      while (landed * REGEN_WIN < need) {
        if (landed == copied) {
          const int t_min =
              __reduce_min_sync(0xffffffffu, work ? t : 0x7fffffff);
          if (!may_copy(copied, t_min)) break;
          copy(copied++);
        }
        ring_wait(copied - landed - 1);
        ++landed;
      }
      const int top = landed * REGEN_WIN;
      if (work && (t + D < top || top >= tr))
        t += window_segment<DMAX>(cfg, s_alb, s_emi, decode, rows, t, tr,
                                  gp, acc, acc_e);
      // The next windows, as far ahead as the ring lets.
      const int t_min =
          __reduce_min_sync(0xffffffffu, t < tr ? t : 0x7fffffff);
      while (may_copy(copied, t_min)) copy(copied++);
    }
    ring_wait(0);
    if (++c == C) {
      block_reduce_row(cfg.n_alb, cfg.n_emi, s_dyn, partials, (unsigned)grp);
      __syncthreads();
      zero_column(cfg.n_alb, cfg.n_emi, s_dyn);
      c = 0;
      grp += gridDim.x;
    }
  }
}

// Whether drt_regen_sweep runs the window kernel for these table rows and
// depth on the current card (its ring and accumulator fit in a block's
// shared memory), else the per-pixel kernel.
template <int DMAX>
static cudaError_t takes_window(int n_alb, int n_emi, bool* window) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  *window = false;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, regen_window_kernel<DMAX>);
  if (e != cudaSuccess) return e;
  *window = (int)attr.sharedSizeBytes + window_bytes<DMAX>(n_alb, n_emi) <=
            optin;
  return cudaSuccess;
}

static cudaError_t sweep_takes_window(int max_depth, int n_alb, int n_emi,
                                      bool* window) {
  return max_depth <= DRT_SMALL_DEPTH
             ? takes_window<DRT_SMALL_DEPTH>(n_alb, n_emi, window)
             : takes_window<DRT_MAX_DEPTH>(n_alb, n_emi, window);
}

// The per-pixel kernel (lockstep != 0 or where the window kernel does not
// fit) or the window kernel, then the reduction of the partials.
static int regen_sweep(const DrtTrace* cfg, const float* scene,
                       const float* alb, const float* emi, const float* rsc,
                       const int* rmeta, const int* trips, const float* g,
                       float* partials, float* da, float* de, int lockstep,
                       void* stream) {
  if (!drt_cfg_ok(cfg) || cfg->max_depth < 1 ||
      cfg->max_depth > DRT_MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bool window = false;
  int rc = 0;
  if (!lockstep) {
    rc = (int)sweep_takes_window(cfg->max_depth, cfg->n_alb, cfg->n_emi,
                                 &window);
    if (rc) return rc;
  }
  int grid = (cfg->n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
#define DRT_LAUNCH(DMAX)                                                   \
  if (window) {                                                            \
    const int bytes = window_bytes<DMAX>(cfg->n_alb, cfg->n_emi);          \
    rc = allow_shared(regen_window_kernel<DMAX>, bytes);                   \
    if (rc) return rc;                                                     \
    rc = (int)queue_grid(regen_window_kernel<DMAX>, cfg->n_rays, &grid,    \
                         bytes);                                           \
    if (rc) return rc;                                                     \
    regen_window_kernel<DMAX><<<grid, DRT_BLOCK, bytes, s>>>(              \
        *cfg, scene, alb, emi, rsc, rmeta, trips, g, partials);            \
  } else {                                                                 \
    const int bytes = acc_bytes(cfg->n_alb, cfg->n_emi);                   \
    rc = allow_shared(regen_sweep_kernel<DMAX>, bytes);                    \
    if (rc) return rc;                                                     \
    regen_sweep_kernel<DMAX><<<grid, DRT_BLOCK, bytes, s>>>(               \
        *cfg, scene, alb, emi, rsc, rmeta, trips, g, partials);            \
  }
  if (cfg->max_depth <= DRT_SMALL_DEPTH) { DRT_LAUNCH(DRT_SMALL_DEPTH) }
  else { DRT_LAUNCH(DRT_MAX_DEPTH) }
#undef DRT_LAUNCH
  rc = (int)cudaGetLastError();
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
// else the per-pixel kernel.
int drt_regen_sweep(const DrtTrace* cfg, const float* scene, const float* alb,
                    const float* emi, const float* rsc, const int* rmeta,
                    const int* trips, const float* g, float* partials,
                    float* da, float* de, void* stream) {
  return regen_sweep(cfg, scene, alb, emi, rsc, rmeta, trips, g, partials,
                     da, de, 0, stream);
}

// The checking build: the per-pixel kernel at every launch, the bit
// reference of drt_regen_sweep.
int drt_regen_sweep_lockstep(const DrtTrace* cfg, const float* scene,
                             const float* alb, const float* emi,
                             const float* rsc, const int* rmeta,
                             const int* trips, const float* g,
                             float* partials, float* da, float* de,
                             void* stream) {
  return regen_sweep(cfg, scene, alb, emi, rsc, rmeta, trips, g, partials,
                     da, de, 1, stream);
}

// Whether drt_regen_sweep runs the window kernel (*window = 1) or the
// per-pixel kernel (0) at this depth and these table rows on the current
// card, for its checks.
int drt_regen_sweep_form(int max_depth, int n_alb, int n_emi, int* window) {
  bool w = false;
  const cudaError_t e = sweep_takes_window(max_depth, n_alb, n_emi, &w);
  *window = w;
  return (int)e;
}

const char* drt_regen_adjoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
