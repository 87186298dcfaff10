// The stored-residual sweeps of both kernel families for Hopper (sm_90a):
// the body of B3 (fused_adjoint.cu: fused_sweep_kernel) and B8
// (dyn_adjoint.cu: dyn_sweep_kernel). Each kernel stages its tables and
// hands this body a decoder of its residual word (rbest, or rrow).
//
// What held the one-thread-per-slot kernels back (PERF.md section 6,
// tools/ablate_sweep.py): 120-121 registers (255 in the 32-bounce build),
// so 4 blocks of 128 an SM; each thread read a chunk's rows only after it
// had swept the chunk before; and every row of every slot was read and
// swept, while a slot's rows after its first dead row add nothing (at the
// CLI's depth 32, 91% of them).
//
// The design:
//  - A persistent grid (queue_grid): block k takes the 128-slot groups k,
//    k + grid, ... in turn, and each thread the slot of its lane in the
//    group, chunk after chunk; an item is one (group, chunk). The tables
//    are staged once per block, not once per group.
//  - A ring of `stages` items in dynamic shared memory beside the
//    accumulator: each thread copies its own slot's head rows (the first
//    min(max_depth, SWEEP_HEAD) rows of rsc and of the word) with
//    cp.async (drt_common.cuh: ring_copy4, ring_commit, ring_wait),
//    stages - 1 items ahead of the one it sweeps, and reads only what it
//    copied itself, so no barrier guards the ring. The launch
//    sizes the ring from what the accumulator and the kernel's tables
//    leave of a block's shared memory (sweep_stages); where fewer than two
//    stages fit (the dyn family's 144 rows fill the block's shared
//    memory), the same body loads each item's rows into registers when it
//    takes the item (the RING = false instance). At the main shapes
//    (8 blocks an SM) the two take the same time; with one block an SM
//    (63 + 63 table rows) the registers take 1.6x the ring's (PERF.md
//    section 6, tools/ablate_sweep.py).
//  - The early stop: a slot's rows are replayed up to its first dead row
//    and swept from the last live row down with S = +0. Rows past the head
//    (max_depth > SWEEP_HEAD) are read one at a time, only while the slot
//    lives, into local memory.
//  - The replay keeps P and the row code of each live row in registers;
//    the row code (albedo row + 1 | emission row + 1 << 8 | live << 16, 0
//    for a sentinel row) comes from one shared-memory word per shape (the
//    fused family) or from the word itself (the dyn family), not from the
//    shape record.
//
// The bits: the rows a sweep skips are dead (gate 0, sentinel rows, sc
// finite: tests/test_torch_sweep_rows.py), so they add nothing to a
// column and leave S at +0 from +0 ((0 + 1 sc S) 0 = +0 for S = +0 and
// any finite sc); the live rows are replayed by the statements of the
// parent's replay and swept by sweep_bounce in the parent's order; each
// slot's column takes its chunks in order; each group is summed by
// block_reduce_row into the group's row of partials; reduce_partials is
// unchanged. So the tables are the lockstep sweep's, and the retrace
// adjoints', bit for bit (fused_adjoint.cu:80-87 makes the same argument
// for B4's queue).

#pragma once

#include "grad_accum.cuh"

#define SWEEP_HEAD 8        // rows of an item that come through the ring
#define SWEEP_MAX_STAGES 3  // items in the ring
#define SWEEP_MAX_DEPTH 32  // in the thread; beyond, the deep form
#define SWEEP_MIN_BLOCKS 8  // __launch_bounds__: blocks an SM must hold

static_assert(SWEEP_MAX_DEPTH == DEEP_WINDOW,
              "the deep form keeps rows past the thread's in device memory");

// A row code from table rows (sentinel rows give 0 in their field).
static __device__ __forceinline__ int sweep_code(int ar, int er, int n_alb,
                                                 int n_emi) {
  const int a = ar < n_alb - 1 ? ar + 1 : 0;
  const int e = er < n_emi - 1 ? er + 1 : 0;
  return a | (e << 8) | (1 << 16);
}

// Wait until all but the newest stages - 1 groups of copies have landed
// (stages 2 or 3).
static __device__ __forceinline__ void ring_wait_stages(int stages) {
  if (stages == 3)
    ring_wait(2);
  else
    ring_wait(1);
}

// One live row of the reverse sweep (drt_common.cuh:sweep_bounce) from
// its row code, into the thread's accumulator column acc / acc_e.
static __device__ __forceinline__ void sweep_row(
    const DrtTrace& cfg, const float* s_alb, const float* s_emi, float* acc,
    float* acc_e, int b, int code, const float P[3], float sc,
    const float g[3], float S[3]) {
  const int arow = (code & 255) - 1, erow = ((code >> 8) & 255) - 1;
  float e[3] = {0.0f, 0.0f, 0.0f};
  float a[3] = {1.0f, 1.0f, 1.0f};
  if (erow >= 0) {
    e[0] = s_emi[erow * 3 + 0];
    e[1] = s_emi[erow * 3 + 1];
    e[2] = s_emi[erow * 3 + 2];
  }
  if (arow >= 0) {
    a[0] = s_alb[arow * 3 + 0];
    a[1] = s_alb[arow * 3 + 1];
    a[2] = s_alb[arow * 3 + 2];
  }
  const float gate = b >= cfg.min_bounces ? cfg.inv_keep : 1.0f;
  sweep_bounce(acc, acc_e, arow, erow, a, e, P, sc, gate, g, S);
}

// One live row of the replay: P = T gate, T = P a sc (the forward's op
// order, megakernel.py:1421-1440).
static __device__ __forceinline__ void replay_row(
    const DrtTrace& cfg, const float* s_alb, int b, int code, float sc,
    float T[3], float P[3]) {
  const float gate = b >= cfg.min_bounces ? cfg.inv_keep : 1.0f;
  P[0] = T[0] * gate;
  P[1] = T[1] * gate;
  P[2] = T[2] * gate;
  const int arow = (code & 255) - 1;
  float ax = 1.0f, ay = 1.0f, az = 1.0f;
  if (arow >= 0) {
    ax = s_alb[arow * 3 + 0];
    ay = s_alb[arow * 3 + 1];
    az = s_alb[arow * 3 + 2];
  }
  T[0] = P[0] * ax * sc;
  T[1] = P[1] * ay * sc;
  T[2] = P[2] * az * sc;
}

// The head rows of the item a thread sweeps: in its ring stage (read from
// shared memory when the replay or the sweep needs them) ...
struct RingRows {
  const float* sc;  // row b at sc[b * DRT_BLOCK]
  const int* word;
  __device__ __forceinline__ float sc_of(int b) const {
    return sc[b * DRT_BLOCK];
  }
  __device__ __forceinline__ int word_of(int b) const {
    return word[b * DRT_BLOCK];
  }
};

// ... or, where no ring fits beside the accumulator, in registers.
struct RegisterRows {
  float sc[SWEEP_HEAD];
  int word[SWEEP_HEAD];
  __device__ __forceinline__ float sc_of(int b) const { return sc[b]; }
  __device__ __forceinline__ int word_of(int b) const { return word[b]; }
};

// The replay and reverse sweep of one slot's chunk whose first H rows are
// `head`; `base` indexes row 0 of the slot's chunk in rsc and rword (rows
// N apart), read past the head only.
// DEEP (the deep form, grad_accum.cuh): rows from DEEP_WINDOW on go to
// `deep` in device memory, so max_depth has no bound.
template <bool TAIL, bool DEEP, class Decode, class Head>
static __device__ __forceinline__ void sweep_item(
    const DrtTrace& cfg, const Decode& decode, const float* s_alb,
    const float* s_emi, const float* __restrict__ rsc,
    const int* __restrict__ rword, size_t base, int H, const Head& head,
    const float g[3], float* acc, float* acc_e, const DeepRows& deep) {
  float P[SWEEP_HEAD][3];
  int code[SWEEP_HEAD];
  float T[3] = {1.0f, 1.0f, 1.0f};
  int L = 0;  // the slot's live rows: 0 .. L-1
  bool run = true;
#pragma unroll
  for (int b = 0; b < SWEEP_HEAD; ++b) {
    if (b < H && run) {
      code[b] = decode(head.word_of(b));
      run = (code[b] >> 16) != 0;
      if (run) {
        replay_row(cfg, s_alb, b, code[b], head.sc_of(b), T, P[b]);
        L = b + 1;
      }
    }
  }
  struct TailRows {
    float4 Psc[SWEEP_MAX_DEPTH - SWEEP_HEAD];
    int code[SWEEP_MAX_DEPTH - SWEEP_HEAD];
  };
  TailRows t;
  if (TAIL && run) {
    const size_t N = (size_t)cfg.n_rays;
    for (int b = SWEEP_HEAD; b < cfg.max_depth; ++b) {
      const int w = rword[base + (size_t)b * N];
      const float sc = rsc[base + (size_t)b * N];
      const int cd = decode(w);
      if ((cd >> 16) == 0) break;
      float Pb[3];
      replay_row(cfg, s_alb, b, cd, sc, T, Pb);
      if (!DEEP || b < DEEP_WINDOW) {
        t.Psc[b - SWEEP_HEAD] = make_float4(Pb[0], Pb[1], Pb[2], sc);
        t.code[b - SWEEP_HEAD] = cd;
      } else {
        deep.put(b, make_float4(Pb[0], Pb[1], Pb[2], sc), cd);
      }
      L = b + 1;
    }
  }
  float S[3] = {0.0f, 0.0f, 0.0f};
  if (TAIL) {
    for (int b = L - 1; b >= SWEEP_HEAD; --b) {
      const bool here = !DEEP || b < DEEP_WINDOW;
      const float4 v = here ? t.Psc[b - SWEEP_HEAD] : deep.psc[deep.at(b)];
      const int cd = here ? t.code[b - SWEEP_HEAD] : deep.word[deep.at(b)];
      const float Pb[3] = {v.x, v.y, v.z};
      sweep_row(cfg, s_alb, s_emi, acc, acc_e, b, cd, Pb, v.w, g, S);
    }
  }
#pragma unroll
  for (int b = SWEEP_HEAD - 1; b >= 0; --b)
    if (b < L)
      sweep_row(cfg, s_alb, s_emi, acc, acc_e, b, code[b], P[b],
                head.sc_of(b), g, S);
}

// A block's place in its items: group grp (the block's groups are
// blockIdx.x, blockIdx.x + gridDim.x, ...) and chunk c, stepped one item at
// a time with no division.
struct ItemCursor {
  int grp, c;
  __device__ __forceinline__ void next(int C) {
    if (++c == C) {
      c = 0;
      grp += (int)gridDim.x;
    }
  }
};

// The body of a sweep kernel after its tables are staged (s_alb, s_emi in
// shared memory). s_acc: the block's accumulator, entries x DRT_BLOCK
// floats, and with RING the ring behind it: `stages` (2 to
// SWEEP_MAX_STAGES) x 2 x H x DRT_BLOCK words. Every thread of the block
// runs it to the end (it holds barriers).
// DEEP: the deep form (registers, not the ring), whose rows past
// DEEP_WINDOW and, with acc set, accumulator are in device memory.
template <bool TAIL, bool RING, bool DEEP = false, class Decode>
static __device__ __forceinline__ void sweep_groups(
    const DrtTrace& cfg, const Decode& decode, const float* s_alb,
    const float* s_emi, const float* __restrict__ rsc,
    const int* __restrict__ rword, const float* __restrict__ g, int g_n,
    int stages, float* s_acc, float* __restrict__ partials,
    const DeepRows& deep = DeepRows{}) {
  static_assert(!(DEEP && RING), "the deep form takes its rows in registers");
  const int N = cfg.n_rays, D = cfg.max_depth, C = cfg.n_chunks;
  const int H = D < SWEEP_HEAD ? D : SWEEP_HEAD;
  const int groups = (N + DRT_BLOCK - 1) / DRT_BLOCK;
  const int E = n_entries(cfg.n_alb, cfg.n_emi);
  float* acc = s_acc + threadIdx.x;
  float* acc_e = acc + (cfg.n_alb - 1) * 3 * DRT_BLOCK;
  float* ring = s_acc + E * DRT_BLOCK + threadIdx.x;
  const int stage_words = 2 * H * DRT_BLOCK;

  // Copy the head rows of the item at `ahead` into stage `put`, and step
  // both (past the last item, an empty group of copies, so that every
  // iteration commits one).
  ItemCursor ahead{(int)blockIdx.x, 0};
  int put = 0;
  auto prefetch = [&]() {
    if (ahead.grp < groups) {
      const int i = ahead.grp * DRT_BLOCK + (int)threadIdx.x;
      const bool ok = i < N;
      const size_t base = (size_t)ahead.c * D * N + (ok ? i : 0);
      const float* ps = rsc + base;
      const int* pw = rword + base;
      float* st = ring + put * stage_words;
      float* sw = st + H * DRT_BLOCK;
#pragma unroll
      for (int b = 0; b < SWEEP_HEAD; ++b) {
        if (b < H) {
          ring_copy4(st + b * DRT_BLOCK, ps, ok);
          ring_copy4(sw + b * DRT_BLOCK, pw, ok);
          ps += N;
          pw += N;
        }
      }
      ahead.next(C);
    }
    ring_commit();
    if (++put == stages) put = 0;
  };
  if (RING)
    for (int k = 0; k < stages - 1; ++k) prefetch();

  zero_column(cfg.n_alb, cfg.n_emi, s_acc);
  float gv[3] = {0.0f, 0.0f, 0.0f};
  int take = 0;  // the stage of the item swept
  for (ItemCursor it{(int)blockIdx.x, 0}; it.grp < groups; it.next(C)) {
    const int i = it.grp * DRT_BLOCK + (int)threadIdx.x;
    const bool ok = i < N;
    const size_t base = (size_t)it.c * D * N + (ok ? i : 0);
    if (it.c == 0 && ok) {
      const int gi = i % g_n;
      gv[0] = g[gi];
      gv[1] = g[g_n + gi];
      gv[2] = g[2 * g_n + gi];
    }
    if (RING) {
      prefetch();
      ring_wait_stages(stages);
      const float* st = ring + take * stage_words;
      if (++take == stages) take = 0;
      const RingRows head{st, reinterpret_cast<const int*>(st) +
                                  H * DRT_BLOCK};
      if (ok)
        sweep_item<TAIL, DEEP>(cfg, decode, s_alb, s_emi, rsc, rword, base,
                               H, head, gv, acc, acc_e, deep);
    } else {
      RegisterRows head;
      const float* ps = rsc + base;
      const int* pw = rword + base;
#pragma unroll
      for (int b = 0; b < SWEEP_HEAD; ++b) {
        if (b < H && ok) {
          head.sc[b] = *ps;
          head.word[b] = *pw;
          ps += N;
          pw += N;
        }
      }
      if (ok)
        sweep_item<TAIL, DEEP>(cfg, decode, s_alb, s_emi, rsc, rword, base,
                               H, head, gv, acc, acc_e, deep);
    }
    if (it.c == C - 1) {
      block_reduce_row(cfg.n_alb, cfg.n_emi, s_acc, partials,
                       (unsigned)it.grp);
      __syncthreads();
      zero_column(cfg.n_alb, cfg.n_emi, s_acc);
    }
  }
  if (RING) ring_wait(0);
}

// Bytes of dynamic shared memory of a sweep block with `stages` ring
// stages.
static int sweep_bytes(int n_alb, int n_emi, int max_depth, int stages) {
  const int H = max_depth < SWEEP_HEAD ? max_depth : SWEEP_HEAD;
  return acc_bytes(n_alb, n_emi) +
         stages * 2 * H * DRT_BLOCK * (int)sizeof(float);
}

// The ring stages of a sweep with these table rows and depth on the
// current card: as many items (at most SWEEP_MAX_STAGES) as a block's
// shared memory holds beside the ring instance's static tables and the
// accumulator; 0, the rows through registers, where fewer than two fit.
template <class Kernel>
static int sweep_stages(Kernel ring, int n_alb, int n_emi, int max_depth,
                        int* stages) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ring);
  if (e != cudaSuccess) return (int)e;
  const int stage = sweep_bytes(n_alb, n_emi, max_depth, 1) -
                    sweep_bytes(n_alb, n_emi, max_depth, 0);
  int k = (optin - (int)attr.sharedSizeBytes -
           sweep_bytes(n_alb, n_emi, max_depth, 0)) / stage;
  if (k > SWEEP_MAX_STAGES) k = SWEEP_MAX_STAGES;
  *stages = k < 2 ? 0 : k;
  return 0;
}

// Launch a sweep on a persistent grid, then reduce_partials; returns the
// first CUDA error. `ring` and `regs` are the kernel's two instances for
// cfg's depth: the ring with sweep_stages' stages where they are 2 or
// more, else the registers. `args` follow the kernel's cfg and precede
// its stages and partials.
template <class Kernel, class... Args>
static int launch_sweep(Kernel ring, Kernel regs, const DrtTrace* cfg,
                        float* partials, float* da, float* de,
                        cudaStream_t s, Args... args) {
  int stages = 0;
  int rc = sweep_stages(ring, cfg->n_alb, cfg->n_emi, cfg->max_depth,
                        &stages);
  if (rc) return rc;
  const Kernel kernel = stages ? ring : regs;
  const int bytes = sweep_bytes(cfg->n_alb, cfg->n_emi, cfg->max_depth,
                                stages);
  rc = allow_shared(kernel, bytes);
  if (rc) return rc;
  int grid = 0;
  rc = (int)queue_grid(kernel, cfg->n_rays, &grid, bytes);
  if (rc) return rc;
  kernel<<<grid, DRT_BLOCK, bytes, s>>>(*cfg, args..., stages, partials);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}

// Launch a sweep's deep form (sweep_groups<TAIL, false, true>) over the
// scratch of deep_bytes(n_rays, max_depth, ...) on at most deep_blocks
// blocks, then reduce_partials; returns the first CUDA error. `args`
// follow the kernel's cfg and precede its scratch and partials.
template <class Kernel, class... Args>
static int launch_sweep_deep(Kernel kernel, const DrtTrace* cfg,
                             void* scratch, float* partials, float* da,
                             float* de, cudaStream_t s, Args... args) {
  const int rc = launch_deep(
      kernel, scratch, cfg->n_rays, cfg->max_depth, cfg->n_alb, cfg->n_emi,
      -1, cfg->n_rays, [&](int grid, int bytes, const DeepScratch& deep) {
        kernel<<<grid, DRT_BLOCK, bytes, s>>>(*cfg, args..., deep, partials);
      });
  if (rc) return rc;
  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, partials, da,
                         de, s);
}
