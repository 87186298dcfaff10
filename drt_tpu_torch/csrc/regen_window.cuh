// The window sweep of the path-regeneration sweep adjoints of both
// families for Hopper (sm_90a): the body of B11 (regen_adjoint.cu:
// regen_window_kernel, over the scene table) and B13
// (dyn_regen_adjoint.cu: dyn_regen_window_kernel, over a memory-resident
// scene). Each kernel stages its tables, zeroes its accumulator and hands
// window_sweep a decoder of its row word (rmeta, or rrow) and the staged
// albedo and emission tables.
//
// Row t of 32 adjacent pixels is one 128-byte line of rsc and one of the
// row word (rsc[c][t][pix]). A thread that walks its own pixel's rows
// (regen_body.cuh:regen_sweep_chunk, the per-pixel kernels) reads each
// row from device memory when the replay reaches it and the next row's
// word only after it has decoded the one before; segments differ in
// length, so the lanes of a warp drift apart in the row they read and a
// warp's load touches several lines, on a chain of dependent loads. The
// window sweep reads the rows of a warp together instead:
//  - A persistent grid (queue_grid) over 128-pixel groups: block k takes
//    groups k, k + grid, ..., each group's chunks in order, an item being
//    one (group, chunk); each thread the pixel of its lane in the group.
//    The tables are staged once per block.
//  - Each warp copies the rows [v W, v W + W) of its 32 pixels (window v,
//    W = REGEN_WIN rows) with cp.async (drt_common.cuh: ring_copy4) into
//    a ring of WINDOWS windows in dynamic shared memory, one 128-byte
//    line of rsc and of the word per row, up to the largest `trips` of
//    its pixels in the item; a lane copies only its own pixel's rows below
//    its own trips, so a row past them is never read, and reads back only
//    its own column, so no barrier guards the ring.
//  - The lanes sweep in rounds, a segment each: a round waits until the
//    rows of every lane's next segment have landed (a segment that starts
//    at t holds at most max_depth rows, and the replay reads the row
//    after its last to see that it ends: rows up to t + max_depth, or all
//    of the lane's), so that the lanes of a warp sweep their j-th
//    segments together, as in the per-pixel kernels, whose lanes each
//    have spp_c segments a chunk. Each lane replays and sweeps its segment
//    from the ring. Then the warp copies the next windows into the slots
//    that every lane has passed (window v takes the slots of window
//    v - WINDOWS once each lane still at work is past its rows). Where the
//    ring cannot take a window that a round waits for (the lanes' rows
//    too far apart), the round sweeps the lanes whose rows have landed;
//    the lane furthest behind always has its rows, which the ring's size
//    guarantees.
//
// The bits: each pixel's column takes its chunks in chunk order, its
// segments in row order and each segment's rows through the statements
// of regen_sweep_chunk (window_segment repeats them on rows from the
// ring: the same values); each group is summed by block_reduce_row into
// the group's row of partials, and reduce_partials is unchanged. So the
// tables are the per-pixel kernel's bit for bit.
//
// The including file defines DRT_SMALL_DEPTH, the depth of its smaller
// instance.

#pragma once

#include "grad_accum.cuh"
#include "regen_body.cuh"

#ifndef DRT_SMALL_DEPTH
#error "regen_window.cuh: define DRT_SMALL_DEPTH first"
#endif

#define REGEN_WIN 8  // rows of a window

// The window sweep's ring: windows per instance, at least
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

// The segment of one sample that starts at row t (a want row) of a lane's
// t_act rows: replayed and swept into the thread's accumulator column by
// the statements of regen_body.cuh:regen_sweep_chunk, on rows from the
// ring. decode.want(meta) says whether a row starts a sample and
// decode.row(meta) gives its RegenRow. Returns its length.
template <int DMAX, int ROWS, class Decode>
static __device__ __forceinline__ int window_segment(
    const DrtTrace& cfg, const float* s_alb, const float* s_emi,
    const Decode& decode, const WindowRows<ROWS>& rows, int t, int t_act,
    const float g[3], float* acc, float* acc_e) {
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

// Words of the window sweep's dynamic shared memory: the accumulator, then
// each warp's ring (rsc, then the row word, ROWS x 32 words each).
template <int DMAX>
static __host__ __device__ __forceinline__ int window_words(int n_alb,
                                                            int n_emi) {
  return n_entries(n_alb, n_emi) * DRT_BLOCK +
         (DRT_BLOCK / 32) * 2 * RegenRing<DMAX>::ROWS * 32;
}

template <int DMAX>
static int window_bytes(int n_alb, int n_emi) {
  return window_words<DMAX>(n_alb, n_emi) * (int)sizeof(float);
}

// The window sweep (the notes at the top) over s_dyn, window_bytes of
// dynamic shared memory whose accumulator the kernel has zeroed, with the
// block's tables s_alb and s_emi staged, after a barrier. Every thread of
// the block runs it to the end (it holds barriers).
template <int DMAX, class Decode>
static __device__ __forceinline__ void window_sweep(
    const DrtTrace& cfg, const Decode& decode, const float* s_alb,
    const float* s_emi, float* s_dyn, const float* __restrict__ rsc,
    const int* __restrict__ rmeta, const int* __restrict__ trips,
    const float* __restrict__ g, float* __restrict__ partials) {
  using Ring = RegenRing<DMAX>;
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

// regen_body.cuh:regen_sweep_chunk of the deep form (grad_accum.cuh),
// for any max_depth: the same statements in loops of run-time length, a
// segment's rows below DEEP_WINDOW in the thread and the rest in `tail`
// (P and sc, and the row's word, decoded again by the sweep).
template <class Tables, class Decode>
static __device__ __forceinline__ void regen_sweep_chunk_deep(
    const DrtTrace& cfg, const Tables& tab, const Decode& decode,
    const float* __restrict__ rsc, const int* __restrict__ rmeta, size_t n,
    int t_act, const float g[3], float* acc, const DeepRows& tail) {
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  int t = 0;
  int meta = t_act > 0 ? rmeta[0] : 0;  // of row t + k below
  while (t < t_act) {
    float4 Psc[DEEP_WINDOW];
    int word[DEEP_WINDOW];
    float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
    int len = 0;
    bool open = true;
    for (int k = 0; open && k < cfg.max_depth; ++k) {
      const RegenRow r = decode.row(meta);
      const float sc_k = rsc[(size_t)(t + k) * n];
      const float rr = r.rr_on ? cfg.inv_keep : 1.0f;
      const float gate_k = r.live ? rr : 0.0f;
      const float Px = Tx * gate_k, Py = Ty * gate_k, Pz = Tz * gate_k;
      float ax = 1.0f, ay = 1.0f, az = 1.0f;
      if (r.arow >= 0) {
        ax = tab.alb[r.arow * 3 + 0];
        ay = tab.alb[r.arow * 3 + 1];
        az = tab.alb[r.arow * 3 + 2];
      }
      Tx = Px * ax * sc_k;
      Ty = Py * ay * sc_k;
      Tz = Pz * az * sc_k;
      const float4 v = make_float4(Px, Py, Pz, sc_k);
      if (k < DEEP_WINDOW) {
        Psc[k] = v;
        word[k] = meta;
      } else {
        tail.put(k, v, meta);
      }
      len = k + 1;
      // The segment ends before the next want row, or with the rows.
      open = false;
      if (t + k + 1 < t_act) {
        meta = rmeta[(size_t)(t + k + 1) * n];
        open = !decode.want(meta);
      }
    }
    float S[3] = {0.0f, 0.0f, 0.0f};
    for (int k = len - 1; k >= 0; --k) {
      const float4 v = k < DEEP_WINDOW ? Psc[k] : tail.psc[tail.at(k)];
      const RegenRow r =
          decode.row(k < DEEP_WINDOW ? word[k] : tail.word[tail.at(k)]);
      const float gate = r.live ? (r.rr_on ? cfg.inv_keep : 1.0f) : 0.0f;
      float e[3] = {0.0f, 0.0f, 0.0f};
      float a[3] = {1.0f, 1.0f, 1.0f};
      if (r.erow >= 0) {
        e[0] = tab.emi[r.erow * 3 + 0];
        e[1] = tab.emi[r.erow * 3 + 1];
        e[2] = tab.emi[r.erow * 3 + 2];
      }
      if (r.arow >= 0) {
        a[0] = tab.alb[r.arow * 3 + 0];
        a[1] = tab.alb[r.arow * 3 + 1];
        a[2] = tab.alb[r.arow * 3 + 2];
      }
      const float P[3] = {v.x, v.y, v.z};
      sweep_bounce(acc, acc_e, r.arow, r.erow, a, e, P, v.w, gate, g, S);
    }
    t += len;
  }
}

// The deep form of both families' sweeps (B11, B13), taken beyond
// DEEP_WINDOW bounces or DEEP_MAX_ACC_ROWS real table rows: the per-pixel
// kernel's work, one thread a pixel, on a grid of at most deep_blocks
// blocks that walks the 128-pixel groups in turn and writes group k's row
// of partials, as block k of the per-pixel kernel does; its rows past
// DEEP_WINDOW and, with more table rows, its accumulator in device memory.
// The kernel has staged `tab` (and synchronized); s_dyn is its dynamic
// shared memory (deep_shared_bytes).
template <class Tables, class Decode>
static __device__ __forceinline__ void regen_deep_groups(
    const DrtTrace& cfg, const Tables& tab, const Decode& decode,
    const float* __restrict__ rsc, const int* __restrict__ rmeta,
    const int* __restrict__ trips, const float* __restrict__ g,
    const DeepScratch& deep, float* s_dyn, float* __restrict__ partials) {
  float* const s_acc = deep.block_acc(n_entries(cfg.n_alb, cfg.n_emi), s_dyn);
  const int n = cfg.n_rays;  // pixels
  const size_t t_cap = (size_t)cfg.spp_c * cfg.max_depth;
  deep_groups(cfg.n_alb, cfg.n_emi, n, s_acc, partials, [&](int pix) {
    if (pix >= n) return;
    const float gp[3] = {g[pix], g[n + pix], g[2 * n + pix]};
    for (int c = 0; c < cfg.n_chunks; ++c) {
      const size_t base = (size_t)c * t_cap * n + pix;
      regen_sweep_chunk_deep(cfg, tab, decode, rsc + base, rmeta + base,
                             (size_t)n, trips[(size_t)c * n + pix], gp,
                             s_acc + threadIdx.x, deep.rows);
    }
  });
}

// Launch a family's deep kernel over `scratch` (deep_bytes(n_pix,
// max_depth, ...)); args follow its cfg and precede its scratch and
// partials. Returns the first CUDA error.
template <class Kernel, class... Args>
static int launch_regen_deep(Kernel kernel, const DrtTrace* cfg,
                             void* scratch, float* partials, cudaStream_t s,
                             Args... args) {
  return launch_deep(kernel, scratch, cfg->n_rays, cfg->max_depth,
                     cfg->n_alb, cfg->n_emi, -1, 0,
                     [&](int grid, int bytes, const DeepScratch& deep) {
                       kernel<<<grid, DRT_BLOCK, bytes, s>>>(
                           *cfg, args..., deep, partials);
                     });
}

// Whether a window kernel with `bytes` of dynamic shared memory fits in a
// block of the current card (its static shared memory beside them), else
// its launch takes the family's per-pixel kernel.
template <class Kernel>
static cudaError_t takes_window(Kernel kernel, int bytes, bool* window) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  *window = false;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *window = (int)attr.sharedSizeBytes + bytes <= optin;
  return cudaSuccess;
}

// One instance of a family's sweep: the window kernel wk on its persistent
// grid, with w_bytes of dynamic shared memory, where it fits
// (takes_window) and lockstep is 0, else the per-pixel kernel pk, a
// thread a pixel, with p_bytes; both on `args`. Returns the first CUDA
// error.
template <class WindowKernel, class PixelKernel, class... Args>
static int launch_sweep(int lockstep, WindowKernel wk, int w_bytes,
                        PixelKernel pk, int p_bytes, int n_pix,
                        cudaStream_t s, Args... args) {
  bool window = false;
  int rc = 0;
  if (!lockstep) {
    rc = (int)takes_window(wk, w_bytes, &window);
    if (rc) return rc;
  }
  int grid = (n_pix + DRT_BLOCK - 1) / DRT_BLOCK;
  if (window) {
    rc = allow_shared(wk, w_bytes);
    if (rc) return rc;
    rc = (int)queue_grid(wk, n_pix, &grid, w_bytes);
    if (rc) return rc;
    wk<<<grid, DRT_BLOCK, w_bytes, s>>>(args...);
  } else {
    rc = allow_shared(pk, p_bytes);
    if (rc) return rc;
    pk<<<grid, DRT_BLOCK, p_bytes, s>>>(args...);
  }
  return (int)cudaGetLastError();
}
