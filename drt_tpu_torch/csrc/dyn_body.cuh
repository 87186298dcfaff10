// Shared device code of the memory-resident ("dyn") kernels: the nearest
// hit over a scene read from device memory at run time, with two-level
// cluster-AABB culling of the triangles, and the bounce loop of one ray
// slot over one spp chunk (dyn_trace_chunk) with a per-bounce residual
// hook; the bounce itself is the text of dyn_bounce.inc, which dyn_bounce
// also wraps for the regeneration tracer (dyn_regen_tracer.cu). It is
// what drt_tpu/ops/dynkernel.py computes in _dyn_intersect,
// _dyn_shade and _dyn_wavefront_body, over the six DynScene operands
// (drt_tpu_torch/ops/dynkernel.py): geo f32[S',12] (triangle rows as v0,
// e1, e2), aux f32[S',3] (normal source), orig i32[S'] (original shape
// index), meta i32[S'] (albedo row | emission row << 8 | material << 16 |
// shape type << 18), expo f32[S'] and caabb f32[R,6] (leaf boxes, padded
// to a multiple of super_m, then the super boxes).
//
// How the TPU design maps here:
//  - Where the scene lives. The TPU kernels read the operands as scalars
//    from SMEM. Here they stay in device memory and are read through the
//    read-only path (__ldg): a leaf is one coalesced read of its rows by
//    the warp (dyn_leaf_warp), the other rows are broadcast reads by the
//    lanes that test them, and the 93 KB of a 1287-shape scene (147 KB at
//    2048 shapes) stay resident in the SM's L1. Staging them in shared
//    memory instead would take most of the 227 KB a block may have and
//    leave one 128-thread block per SM; as it is, shared memory holds only
//    the two parameter tables (6 KB) and occupancy is set by registers.
//  - Culling. The TPU skips a cluster when no lane of its 1024-lane tile
//    enters the cluster's box. Here each ray takes its own slab tests,
//    against its own running best, and the unit of the skip is the warp.
//    The slab test is conservative (<= with slack), padded leaf rows are
//    skipped by index (an inverted box passes a min/max slab test), and
//    padded triangle slots are degenerate rows (det == 0) that never win.
//    In the exact variant the winner is the lexicographic (t, original
//    index) minimum over every triangle a ray can reach, so the nearest
//    hit is the same bits with culling on, off, or one level deep. The
//    fast variant compares candidates by rounded cross-products, an order
//    that is not transitive on near-ties: there the winner depends on the
//    set of candidates and their order (the JAX kernel's semantics too),
//    and a ray aimed at a mesh vertex may get another winner on another
//    layout. Every kernel here keeps one visit order, each ray's own
//    boxes in row order and each entered leaf's triangles in index order,
//    so on one layout all of them agree bit for bit.
//  - The leaf loop (dyn_intersect_warp, in every kernel of the family
//    that traces). After the first bounce the rays of a warp point
//    everywhere and about 2 of 32 lanes enter a given leaf of the
//    1287-shape mesh; a loop over the leaf's triangles per thread ran
//    with the other 30 idle. So the warp tests a leaf together: every
//    lane takes part (a dead lane or one past the last ray slot as "no
//    ray"), the lanes walk the boxes in a loop of the same bounds, lane k
//    loads the leaf's triangle k once (one coalesced read of the leaf),
//    and for each ray that entered, in ascending lane order, the ray is
//    broadcast by shuffles, every lane tests its own triangle, and the
//    valid candidates are folded into that ray's best in ascending
//    triangle index, one dyn_update each. An invalid candidate is a no-op
//    of dyn_update, so this is the per-thread loop's sequence of updates
//    and gives its bits in both variants (a shuffle-tree minimum would
//    not, in the fast one). A leaf of more than 32 triangles takes passes
//    of 32 in index order. The tracers and the retrace adjoint keep their
//    warps together for it; the regeneration tracer (dyn_regen_tracer.cu)
//    runs a trip loop that the warp steps through together. The loop per
//    thread (dyn_intersect) is left in one checking build of the tracer
//    (drt_dyn_trace_lanes), the reference that the warp's fold is held to.
//  - The carry. The TPU sweep carries the winner's attributes through
//    masked selects. A thread here carries (t, original index, row) and
//    reads the winner's aux, meta and exponent once after the loop.
//  - Material dispatch is a per-thread branch on the winner's material
//    type, and the specular exponent a per-ray value, so the sign rule of
//    pow is found at run time (dynkernel.py:_pow_cpp_vec).
//  - FAST carries the best hit as a ratio (numerator, denominator > 0),
//    compares candidates by cross-multiplication and divides once per ray
//    after the loop, as the TPU kernel's fastmath does.

#pragma once

#include "drt_common.cuh"

#define DYN_ROW_BITS 8
#define DYN_MAX_ROWS 256  // 1 << DYN_ROW_BITS rows per parameter table

struct DynLayout {
  int n_plane, n_sphere, n_tri;  // n_tri: rows tested when unclustered
  int n_rows;                    // S': rows of geo, aux, orig, meta, expo
  int cluster_k, n_clusters, n_clusters_pad, n_super, super_m;
  int n_caabb;                   // R: rows of caabb
};

struct DynOperands {
  const float* geo;
  const float* aux;
  const int* orig;
  const int* meta;
  const float* expo;
  const float* caabb;
};

// The block's copy of the albedo and emission tables.
struct DynTables {
  float alb[DYN_MAX_ROWS * 3];
  float emi[DYN_MAX_ROWS * 3];
};

// Every thread of the block calls this (it ends in a barrier).
static __device__ __forceinline__ void dyn_stage_tables(
    const DrtTrace& cfg, const float* __restrict__ alb,
    const float* __restrict__ emi, DynTables& t) {
  for (int k = threadIdx.x; k < cfg.n_alb * 3; k += blockDim.x)
    t.alb[k] = alb[k];
  for (int k = threadIdx.x; k < cfg.n_emi * 3; k += blockDim.x)
    t.emi[k] = emi[k];
  __syncthreads();
}

static __host__ __device__ __forceinline__ int dyn_pack_meta(int arow,
                                                             int erow,
                                                             int mtype,
                                                             int stype) {
  return arow | (erow << DYN_ROW_BITS) | (mtype << (2 * DYN_ROW_BITS)) |
         (stype << (2 * DYN_ROW_BITS + 2));
}

// Counters of a checking build (COUNT): lane-bounces and warp-bounces
// that ran the nearest-hit loop, leaf clusters entered summed over lanes,
// and leaves the warps tested (for at least one ray).
enum { STAT_LANE_BOUNCES = 0, STAT_WARP_BOUNCES = 1, STAT_LANE_LEAVES = 2,
       STAT_WARP_LEAVES = 3, DYN_N_STATS = 4 };

// The running nearest hit: t = num / den (den == 1 unless FAST), the
// winner's original shape index and its row in the operands.
struct DynBest {
  float num, den;
  int orig, row;
};

// (t, original index) lexicographic update (dynkernel.py:392-413).
template <bool FAST>
static __device__ __forceinline__ void dyn_update(
    DynBest& b, const int* __restrict__ orig, int i, float num, float den,
    bool valid) {
  if (!valid) return;
  const float INF = __int_as_float(0x7f800000);
  bool closer;
  if (FAST) {
    const float lhs = num * b.den;
    const float rhs = b.num * den;
    closer = lhs < rhs ||
             (lhs == rhs && b.num < INF && __ldg(orig + i) < b.orig);
  } else {
    closer = num < b.num ||
             (num == b.num && b.num < INF && __ldg(orig + i) < b.orig);
  }
  if (closer) {
    b.num = num;
    b.den = FAST ? den : 1.0f;
    b.orig = __ldg(orig + i);
    b.row = i;
  }
}

template <bool FAST>
static __device__ __forceinline__ void dyn_plane(
    DynBest& b, const DynOperands& s, int i, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(s.geo) + 3 * i);
  const float h = (ox * g.x + oy * g.y + oz * g.z) - g.w;
  const float denom = dx * (-g.x) + dy * (-g.y) + dz * (-g.z);
  if (FAST) {
    // t = h / denom > 0 <=> num > 0 with den = |denom| > 0.
    const float num = denom < 0.0f ? -h : h;
    const float den = fabsf(denom);
    dyn_update<FAST>(b, s.orig, i, num, den, num > 0.0f && den > 0.0f);
  } else {
    const float t = h / denom;
    dyn_update<FAST>(b, s.orig, i, t, 1.0f, t > 0.0f);
  }
}

template <bool FAST>
static __device__ __forceinline__ void dyn_sphere(
    DynBest& b, const DynOperands& s, int i, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(s.geo) + 3 * i);
  const float ocx = ox - g.x, ocy = oy - g.y, ocz = oz - g.z;
  const float b2 = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
  const float cc = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - g.w * g.w;
  const float disc = b2 * b2 - 4.0f * cc;
  const float sq = sqrtf(max0(disc));
  const float t1 = FAST ? (-b2 - sq) * 0.5f : (-b2 - sq) / 2.0f;
  const float t2 = FAST ? (-b2 + sq) * 0.5f : (-b2 + sq) / 2.0f;
  const float t = t1 > 0.0f ? t1 : t2;
  dyn_update<FAST>(b, s.orig, i, t, 1.0f, disc >= 0.0f && t > 0.0f);
}

// Moller-Trumbore on the (v0, e1, e2) edge form of the triangle row
// (ga, gb, gc): the candidate (num, den, valid) that dyn_update takes.
template <bool FAST>
static __device__ __forceinline__ void dyn_tri_candidate(
    const float4& ga, const float4& gb, const float4& gc, float ox,
    float oy, float oz, float dx, float dy, float dz, float& num,
    float& den, bool& valid) {
  const float v0x = ga.x, v0y = ga.y, v0z = ga.z;
  const float e1x = ga.w, e1y = gb.x, e1z = gb.y;
  const float e2x = gb.z, e2y = gb.w, e2z = gc.x;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  const float u_raw = tvx * px + tvy * py + tvz * pz;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v_raw = dx * qx + dy * qy + dz * qz;
  const float t_raw = e2x * qx + e2y * qy + e2z * qz;
  if (FAST) {
    // Sign-normalized numerators over den = |det| > 0: no divide.
    const bool neg = det < 0.0f;
    den = fabsf(det);
    const float u_n = neg ? -u_raw : u_raw;
    const float v_n = neg ? -v_raw : v_raw;
    num = neg ? -t_raw : t_raw;
    valid = den > 1e-9f && u_n >= 0.0f && v_n >= 0.0f && u_n + v_n <= den &&
            num > 0.0f;
  } else {
    const float inv = 1.0f / det;
    const float u = u_raw * inv;
    const float v = v_raw * inv;
    num = t_raw * inv;
    den = 1.0f;
    valid = fabsf(det) > 1e-9f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            num > 0.0f;
  }
}

template <bool FAST>
static __device__ __forceinline__ void dyn_triangle(
    DynBest& b, const DynOperands& s, int i, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  const float4* g4 = reinterpret_cast<const float4*>(s.geo) + 3 * i;
  const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), gc = __ldg(g4 + 2);
  float num, den;
  bool valid;
  dyn_tri_candidate<FAST>(ga, gb, gc, ox, oy, oz, dx, dy, dz, num, den,
                          valid);
  dyn_update<FAST>(b, s.orig, i, num, den, valid);
}

// 1 / c with near-zero components clamped, so that the reciprocal stays
// finite (dynkernel.py:_safe_inv).
static __device__ __forceinline__ float dyn_safe_inv(float c) {
  const float big = 1e30f;
  return fabsf(c) < 1e-30f ? (c < 0.0f ? -big : big) : 1.0f / c;
}

// Does the ray enter box `row` short of its current best hit
// (dynkernel.py:_slab_enter)? <= with slack: a tie t == best can still
// win on the smaller original index.
template <bool FAST>
static __device__ __forceinline__ bool dyn_slab_enter(
    const DynBest& b, const float* __restrict__ caabb, int row, float ox,
    float oy, float oz, float ivx, float ivy, float ivz) {
  const float2* p = reinterpret_cast<const float2*>(caabb) + 3 * row;
  const float2 c0 = __ldg(p), c1 = __ldg(p + 1), c2 = __ldg(p + 2);
  const float tx1 = (c0.x - ox) * ivx;
  const float ty1 = (c0.y - oy) * ivy;
  const float tz1 = (c1.x - oz) * ivz;
  const float tx2 = (c1.y - ox) * ivx;
  const float ty2 = (c2.x - oy) * ivy;
  const float tz2 = (c2.y - oz) * ivz;
  const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                           fminf(tz1, tz2));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                           fmaxf(tz1, tz2));
  const float one_eps = (float)(1.0 + 1e-5);
  bool bound;
  if (FAST)
    bound = tmin * b.den <= b.num * one_eps + 1e-5f * b.den;
  else
    bound = tmin <= b.num * one_eps + 1e-5f;
  return tmax >= tmin && tmax > 0.0f && bound;
}

// The planes, the spheres and, when the scene is not clustered, the
// triangles of one live ray, per thread. Returns the first triangle row.
template <bool FAST>
static __device__ __forceinline__ int dyn_intersect_flat(
    const DynLayout& lay, const DynOperands& s, float ox, float oy,
    float oz, float dx, float dy, float dz, DynBest& best) {
  int lo = 0;
  for (int i = lo; i < lo + lay.n_plane; ++i)
    dyn_plane<FAST>(best, s, i, ox, oy, oz, dx, dy, dz);
  lo += lay.n_plane;
  for (int i = lo; i < lo + lay.n_sphere; ++i)
    dyn_sphere<FAST>(best, s, i, ox, oy, oz, dx, dy, dz);
  lo += lay.n_sphere;
  if (lay.n_clusters == 0) {
    for (int i = lo; i < lo + lay.n_tri; ++i)
      dyn_triangle<FAST>(best, s, i, ox, oy, oz, dx, dy, dz);
  }
  return lo;
}

// Nearest hit of one live ray over the whole scene, into `best`, with the
// leaves' triangles tested per thread: the reference build's loop.
template <bool FAST>
static __device__ __forceinline__ void dyn_intersect(
    const DynLayout& lay, const DynOperands& s, float ox, float oy,
    float oz, float dx, float dy, float dz, DynBest& best) {
  const int lo =
      dyn_intersect_flat<FAST>(lay, s, ox, oy, oz, dx, dy, dz, best);
  if (lay.n_clusters == 0) return;
  const float ivx = dyn_safe_inv(dx), ivy = dyn_safe_inv(dy),
              ivz = dyn_safe_inv(dz);
  const int K = lay.cluster_k;
  // One level: every leaf is its own group. Two levels: super row g
  // (stored after the padded leaf rows) unions leaves [g*M, (g+1)*M).
  const int M = lay.n_super ? lay.super_m : 1;
  const int n_groups = lay.n_super ? lay.n_super : lay.n_clusters;
  for (int g = 0; g < n_groups; ++g) {
    if (lay.n_super &&
        !dyn_slab_enter<FAST>(best, s.caabb, lay.n_clusters_pad + g, ox, oy,
                              oz, ivx, ivy, ivz))
      continue;
    for (int j = 0; j < M; ++j) {
      const int c = g * M + j;
      // Padded leaf rows are skipped by index: an inverted box passes
      // the min/max slab test.
      if (c >= lay.n_clusters) break;
      if (!dyn_slab_enter<FAST>(best, s.caabb, c, ox, oy, oz, ivx, ivy, ivz))
        continue;
      const int t0 = lo + c * K;
      for (int k = 0; k < K; ++k)
        dyn_triangle<FAST>(best, s, t0 + k, ox, oy, oz, dx, dy, dz);
    }
  }
}

// The K triangles from row t0 of a leaf that the rays of the lanes in
// `rays` entered, tested by the whole warp: in passes of 32 triangles in
// index order, lane k holds triangle k of the pass; for each ray in
// ascending lane order every lane tests its triangle against the ray
// broadcast from its lane, and the ray's lane folds the valid candidates
// in ascending triangle index.
template <bool FAST>
static __device__ __forceinline__ void dyn_leaf_warp(
    const DynOperands& s, int t0, int K, unsigned rays, float ox, float oy,
    float oz, float dx, float dy, float dz, DynBest& best) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < K; base += 32) {
    const bool has = base + lane < K;
    float4 ga = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gb = ga, gc = ga;
    if (has) {
      const float4* g4 =
          reinterpret_cast<const float4*>(s.geo) + 3 * (t0 + base + lane);
      ga = __ldg(g4);
      gb = __ldg(g4 + 1);
      gc = __ldg(g4 + 2);
    }
    for (unsigned m = rays; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const float rox = __shfl_sync(FULL, ox, r);
      const float roy = __shfl_sync(FULL, oy, r);
      const float roz = __shfl_sync(FULL, oz, r);
      const float rdx = __shfl_sync(FULL, dx, r);
      const float rdy = __shfl_sync(FULL, dy, r);
      const float rdz = __shfl_sync(FULL, dz, r);
      float num, den;
      bool valid;
      dyn_tri_candidate<FAST>(ga, gb, gc, rox, roy, roz, rdx, rdy, rdz, num,
                              den, valid);
      for (unsigned v = __ballot_sync(FULL, has && valid); v; v &= v - 1) {
        const int k = __ffs(v) - 1;
        const float num_k = __shfl_sync(FULL, num, k);
        const float den_k = FAST ? __shfl_sync(FULL, den, k) : 1.0f;
        if (lane == r)
          dyn_update<FAST>(best, s.orig, t0 + base + k, num_k, den_k, true);
      }
    }
  }
}

// dyn_intersect with the leaves tested by the warp (dyn_leaf_warp). Every
// lane of the warp calls it; `ray` is false for a lane with no ray (a dead
// path, or a thread past the last ray slot), which tests nothing and
// leaves `best` as it is. Each ray tests the boxes, and so enters the
// leaves, that dyn_intersect would: the lanes walk the groups and leaves
// in a loop of the same bounds, each with its own slab tests against its
// own running best. The counters count the lanes with a ray by ballot,
// and the warp-step once.
template <bool FAST, bool COUNT>
static __device__ __forceinline__ void dyn_intersect_warp(
    const DynLayout& lay, const DynOperands& s, bool ray, float ox,
    float oy, float oz, float dx, float dy, float dz, DynBest& best,
    unsigned long long* stats) {
  const unsigned FULL = 0xffffffffu;
  const bool lead = (threadIdx.x & 31) == 0;
  if (COUNT) {
    const unsigned a = __ballot_sync(FULL, ray);
    if (a && lead) {
      atomicAdd(stats + STAT_LANE_BOUNCES, (unsigned long long)__popc(a));
      atomicAdd(stats + STAT_WARP_BOUNCES, 1ull);
    }
  }
  if (ray) dyn_intersect_flat<FAST>(lay, s, ox, oy, oz, dx, dy, dz, best);
  if (lay.n_clusters == 0) return;
  const int lo = lay.n_plane + lay.n_sphere;
  const float ivx = dyn_safe_inv(dx), ivy = dyn_safe_inv(dy),
              ivz = dyn_safe_inv(dz);
  const int K = lay.cluster_k;
  const int M = lay.n_super ? lay.super_m : 1;
  const int n_groups = lay.n_super ? lay.n_super : lay.n_clusters;
  for (int g = 0; g < n_groups; ++g) {
    const bool in_group =
        ray && (!lay.n_super ||
                dyn_slab_enter<FAST>(best, s.caabb, lay.n_clusters_pad + g,
                                     ox, oy, oz, ivx, ivy, ivz));
    if (!__any_sync(FULL, in_group)) continue;
    for (int j = 0; j < M; ++j) {
      const int c = g * M + j;
      if (c >= lay.n_clusters) break;
      const bool enter =
          in_group && dyn_slab_enter<FAST>(best, s.caabb, c, ox, oy, oz, ivx,
                                           ivy, ivz);
      const unsigned rays = __ballot_sync(FULL, enter);
      if (!rays) continue;
      if (COUNT && lead) {
        atomicAdd(stats + STAT_LANE_LEAVES, (unsigned long long)__popc(rays));
        atomicAdd(stats + STAT_WARP_LEAVES, 1ull);
      }
      dyn_leaf_warp<FAST>(s, lo + c * K, K, rays, ox, oy, oz, dx, dy, dz,
                          best);
    }
  }
}

// Sign rule of pow(negative base, e) for a run-time exponent
// (dynkernel.py:_pow_cpp_vec): integral test by round-half-even, parity
// by the floored modulus.
static __device__ __forceinline__ int dyn_pow_mode(float e) {
  const float r = rintf(e);
  if (e != r) return POW_NONINT;
  return (r - 2.0f * floorf(r / 2.0f)) == 1.0f ? POW_ODD : POW_EVEN;
}

// A per-ray specular exponent (drt_common.cuh:shade).
struct DynSpecular {
  float e;
  __device__ __forceinline__ float expo() const { return e; }
  __device__ __forceinline__ float inv_e2() const { return 1.0f / (e + 2.0f); }
  __device__ __forceinline__ int pow_mode() const { return dyn_pow_mode(e); }
};

// The hook of the forward tracer: keeps nothing.
struct DynNoResidual {
  __device__ __forceinline__ void operator()(int, float, float, float,
                                             float, float, int, int,
                                             bool) const {}
};

// Radiance (lx, ly, lz) of ray slot i in spp chunk c, all max_depth
// bounces. hook(b, Px, Py, Pz, sc, gate, arow, erow, alive) is called
// once per bounce with sanitized rows (the sentinel rows on a dead lane).
// WARP: the nearest hit is dyn_intersect_warp, which every lane of the
// warp must reach: `lane` is false for a thread past the last ray slot,
// which traces slot i (the caller's last valid slot) as a dead path.
// Otherwise it is dyn_intersect, taken by the live lanes alone.
template <bool FAST, bool INTERNAL, bool COUNT, bool WARP, class Hook>
static __device__ __forceinline__ void dyn_trace_chunk(
    const DrtTrace& cfg, const DynLayout& lay, const DrtCamera& cam,
    const DynOperands& scn, const DynTables& tab,
    const float* __restrict__ cam_u, const float* __restrict__ tape, int i,
    bool lane, int c, Hook& hook, float& lx, float& ly, float& lz,
    unsigned long long* stats) {
  const float INF = __int_as_float(0x7f800000);
  const float RAY_EPS_F = 1e-3f;
  const int row_mask = DYN_MAX_ROWS - 1;
  const int dead_meta =
      dyn_pack_meta(cfg.n_alb - 1, cfg.n_emi - 1, NULL_BXDF, PLANE);

  int pix;
  uint32_t smp;
  float dx, dy, dz;
  primary_ray<FAST, INTERNAL>(cfg, cam, cam_u, i, c, pix, smp, dx, dy, dz);
  float ox = cam.eye[0], oy = cam.eye[1], oz = cam.eye[2];
  float Tx = 1.0f, Ty = 1.0f, Tz = 1.0f;
  lx = 0.0f; ly = 0.0f; lz = 0.0f;
  bool alive = lane;

  for (int bnc = 0; bnc < cfg.max_depth; ++bnc) {
#include "dyn_bounce.inc"
  }
}

// dyn_bounce.inc as a routine on a PathState, with the keyed hash: one
// bounce of sample smp of pixel pix at depth bnc. The regeneration tracer
// (dyn_regen_tracer.cu) calls it at each thread's own depth. The nearest
// hit is dyn_intersect_warp, so every lane of the warp calls it together:
// a lane whose p.alive is false takes part with no ray.
template <bool FAST, bool COUNT, class Hook>
static __device__ __forceinline__ void dyn_bounce(
    const DrtTrace& cfg, const DynLayout& lay, const DynOperands& scn,
    const DynTables& tab, int pix, uint32_t smp, int bnc, Hook& hook,
    PathState& p, unsigned long long* stats) {
  constexpr bool INTERNAL = true;
  constexpr bool WARP = true;
  const float INF = __int_as_float(0x7f800000);
  const float RAY_EPS_F = 1e-3f;
  const int row_mask = DYN_MAX_ROWS - 1;
  const int dead_meta =
      dyn_pack_meta(cfg.n_alb - 1, cfg.n_emi - 1, NULL_BXDF, PLANE);
  const float* tape = nullptr;
  const int i = pix;
  float &ox = p.ox, &oy = p.oy, &oz = p.oz;
  float &dx = p.dx, &dy = p.dy, &dz = p.dz;
  float &Tx = p.Tx, &Ty = p.Ty, &Tz = p.Tz;
  float &lx = p.lx, &ly = p.ly, &lz = p.lz;
  bool& alive = p.alive;
  {
#include "dyn_bounce.inc"
  }
}

static inline bool dyn_tables_ok(const DrtTrace* cfg) {
  return cfg->n_alb >= 1 && cfg->n_alb <= DYN_MAX_ROWS && cfg->n_emi >= 1 &&
         cfg->n_emi <= DYN_MAX_ROWS && cfg->n_rays > 0 &&
         cfg->max_depth >= 1 && cfg->ray_base >= 0;
}

static inline bool dyn_cfg_ok(const DrtTrace* cfg, const DynLayout* lay) {
  const int t0 = lay->n_plane + lay->n_sphere;
  const int tri_rows =
      lay->n_clusters ? lay->n_clusters_pad * lay->cluster_k : lay->n_tri;
  const int boxes = lay->n_clusters ? lay->n_clusters_pad + lay->n_super : 0;
  return dyn_tables_ok(cfg) && cfg->n_shapes >= 1 && t0 >= 0 &&
         lay->n_rows == t0 + tri_rows && lay->n_caabb >= boxes &&
         lay->n_clusters <= lay->n_clusters_pad &&
         (lay->n_super == 0 ||
          lay->n_super * lay->super_m == lay->n_clusters_pad);
}
