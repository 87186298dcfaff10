"""The memory-resident-scene ("dyn") kernels: four CUDA kernels over a
scene read from device memory at run time, their plain PyTorch versions
and the host-side scene preparation.

The port of `drt_tpu.ops.dynkernel`. Where the fused kernels of
`ops.megakernel` take a table of at most 64 shapes into shared memory,
these read the six `DynScene.operands` at run time, so a scene may hold up
to `MAX_DYN_SHAPES` shapes (every triangle mesh) and a change of geometry
or material values needs no new table layout. With N = W*H*spp/spp_chunks
ray slots, D = max_depth, C = n_chunks:
  `make_dyn_tracer`: radiance f32[3, N], summed over the spp chunks;
  `make_dyn_collect_tracer`: the same trace, which also writes the
    residuals rsc f32[C, D, N] and rrow i32[C, D, N] = albedo row |
    emission row << 8 | live << 16 ([D, N] when C == 1);
  `make_dyn_sweep_adjoint`: (d_albedo f32[K+1, 3], d_emission f32[L+1,
    3]) from those residuals and a cotangent g; it needs no geometry;
  `make_dyn_adjoint`: the same gradients by retracing in the kernel.
The kernels are `csrc/dyn_tracer.cu` and `csrc/dyn_adjoint.cu` over
`csrc/dyn_body.cuh`; the source notes say what bounds each and how the
designs differ from the TPU kernels'. Uniforms, seeds, ray order and the
cotangent's forms are those of `ops.megakernel`: the same seeds give the
same samples in both kernel families.

`DynScene` sorts the shapes by type (planes, spheres, triangles), packs
the per-shape attributes, and clusters the triangles into leaves of
`cluster_k` with conservative boxes and, past `super_m` leaves, a second
level of boxes. It is numpy on the host and gives the JAX package's
operands bit for bit. The nearest hit is the lexicographic (t, original
shape index) minimum, so in the exact variant it is the same with culling
on or off (`dyn_intersect` says where the fast variant's is not).

`dyn_trace`, `dyn_collect`, `dyn_sweep` and `dyn_adjoint` are the
wrappers: for tensors on the CPU each runs its plain version
(`dyn_*_plain`, written in the kernels' op order on the operands); for
CUDA tensors it launches its kernel or raises. Each counts its launches;
`ops.megakernel.launch_counts()` reads them with the fused kernels'.
`dyn_cull_stats` and `dyn_trace_lanes` run checking builds of the tracer
(the cull's counters; the leaves tested per thread, the reference that
the kernels' warp-wide leaf test is held to), which are not counted.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.constants import PI, RAY_EPS
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.bxdf import _pow_cpp as _pow_cpp_vec
from drt_tpu_torch.scene import (DIFFUSE, MIRROR, NULL_BXDF, PLANE, SPECULAR,
                                 SPHERE, TRIANGLE, Scene)

SOURCE = "dyn_tracer.cu"
ADJOINT_SOURCE = "dyn_adjoint.cu"
# Most shapes a scene may hold for these kernels.
MAX_DYN_SHAPES = 2048
# Most real (non-sentinel) albedo + emission rows whose gradient
# accumulator fits a block's shared memory (DYN_MAX_GRAD_ROWS in
# csrc/dyn_adjoint.cu); beyond, up to 255 + 255, the adjoint kernels'
# deep forms keep it in device memory (csrc/grad_accum.cuh).
MAX_GRAD_ROWS = 144
N_STATS = 4

_TRI_DET_EPS = 1e-9  # as ops/intersect.py

# Row packing in the stored residual (albedo row | emission row | live
# flag in one i32) and in `meta`: 8 bits per row index.
_ROW_BITS = 8
_ROW_CAP = 1 << _ROW_BITS
_META_MT_SHIFT = 2 * _ROW_BITS
_META_ST_SHIFT = _META_MT_SHIFT + 2

# cluster_k=None: meshes at or above this many triangles take leaves of
# 32, smaller ones leaves of 16 (the JAX package's rule, kept so that both
# packages build the same operands).
_AUTO_K32_TRIS = 1024


def _pack_meta(arow, erow, mtype, stype):
    return (arow | (erow << _ROW_BITS) | (mtype << _META_MT_SHIFT)
            | (stype << _META_ST_SHIFT))


def _unpack_meta(meta):
    """meta i32 -> (albedo row, emission row, material type, shape type);
    the inverse of _pack_meta."""
    mask = _ROW_CAP - 1
    ar = meta & mask
    er = (meta >> _ROW_BITS) & mask
    mt = (meta >> _META_MT_SHIFT) & 3
    st = meta >> _META_ST_SHIFT
    return ar, er, mt, st


class DynScene:
    """Host-side preparation of a Scene for the memory-resident kernels.

    Static facts: shape counts per type (`n_plane`, `n_sphere`, `n_tri`,
    `n_tri_pad`), the cluster layout (`cluster_k`, `n_clusters`,
    `n_clusters_pad`, `n_super`, `super_m`) and the material classes
    present. Run-time data: `operands`, six tensors on the scene's device:
    geo f32[S', 12] (triangle rows in the (v0, e1, e2) edge form), aux
    f32[S', 3] (the hit normal's source), orig i32[S'] (original shape
    index), meta i32[S'] (`_pack_meta`), expo f32[S'], caabb f32[R, 6].

    Triangle clustering: a mesh of more than `cluster_min_tris` triangles
    is sorted into spatial leaves of `cluster_k` (median split on the
    longest centroid axis), each with a conservative box; the kernels
    skip a leaf's triangles for a ray that does not enter its box short
    of its current best hit. Past `super_m` leaves, `super_m` consecutive
    leaves are united under a super box whose one test skips them all.
    Leaf rows are padded to a multiple of `super_m` with inverted boxes.
    The slab test does NOT skip those (min/max normalizes an inverted box
    into one that covers every t): the kernels skip padded rows by index,
    and their triangle slots are in-range rows of degenerate triangles
    (det == 0, original index S), so they can never win.
    """

    def __init__(self, scene: Scene, cluster_k: int | None = None,
                 cluster_min_tris: int = 32, super_m: int = 8):
        self.scene = scene  # the original Scene (material tables etc.)
        if scene.shape_geo.dtype != torch.float32:
            raise ValueError("dyn kernels are f32-only (the kernels and "
                             "their operands are float32)")

        def host(t):
            return t.detach().cpu().numpy()

        stype = host(scene.shape_type)
        geo = host(scene.shape_geo)
        shape_mat = host(scene.shape_mat)
        mat_type = host(scene.mat_type)
        mat_albedo = host(scene.mat_albedo)
        mat_exponent = host(scene.mat_exponent).astype(np.float32)
        S = stype.shape[0]

        # Stable type sort: planes, spheres, triangles.
        perm = np.argsort(stype, kind="stable")
        self.n_plane = int((stype == PLANE).sum())
        self.n_sphere = int((stype == SPHERE).sum())
        self.n_tri = int((stype == TRIANGLE).sum())
        self.n_shapes = S

        geo_s = geo[perm]
        orig = perm.astype(np.int32)
        mtype = mat_type[shape_mat][perm].astype(np.int32)
        arow = mat_albedo[shape_mat][perm].astype(np.int32)
        erow = host(scene.shape_emit)[perm].astype(np.int32)
        expo = mat_exponent[shape_mat][perm].astype(np.float32)
        if (arow.max(initial=0) >= _ROW_CAP
                or erow.max(initial=0) >= _ROW_CAP):
            raise ValueError(
                f"dyn kernels pack table rows into {_ROW_BITS} bits "
                f"(meta operand + stored residuals): max row is "
                f"{int(max(arow.max(initial=0), erow.max(initial=0)))} "
                f">= {_ROW_CAP}")
        meta = _pack_meta(arow, erow, mtype,
                          stype[perm].astype(np.int32)).astype(np.int32)

        # Hit-normal source per shape: the plane's raw stored normal
        # (shape.hpp:58-59), the sphere's center (normal recomputed per
        # hit, shape.hpp:105-106), the triangle's unit normal, computed
        # here in the f32 op order of ops/intersect.py (edge diffs, cross,
        # v * (1/sqrt(dot))).
        aux = geo_s[:, 0:3].copy()
        tri = np.nonzero(stype[perm] == TRIANGLE)[0]
        if tri.size:
            g = geo_s[tri]
            v0 = g[:, 0:3]
            e1 = g[:, 3:6] - v0
            e2 = g[:, 6:9] - v0
            cx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
            cy = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
            cz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            inv = np.float32(1.0) / np.sqrt(cx * cx + cy * cy + cz * cz)
            aux[tri, 0] = cx * inv
            aux[tri, 1] = cy * inv
            aux[tri, 2] = cz * inv

        self.have_diffuse = bool((mtype == DIFFUSE).any())
        self.have_specular = bool((mtype == SPECULAR).any())
        self.have_mirror = bool((mtype == MIRROR).any())

        self.n_clusters = 0
        if cluster_k is None:
            cluster_k = 32 if self.n_tri >= _AUTO_K32_TRIS else 16
        self.cluster_k = cluster_k
        self.n_super = 0
        self.super_m = super_m
        self.n_clusters_pad = 0
        caabb = np.zeros((1, 6), np.float32)
        t0 = self.n_plane + self.n_sphere
        if self.n_tri > cluster_min_tris:
            slots, caabb = _cluster_tris(geo_s[t0:], cluster_k)
            self.n_clusters = caabb.shape[0]
            self.n_clusters_pad = self.n_clusters
            if super_m > 1 and self.n_clusters > super_m:
                M = super_m
                C = self.n_clusters
                n_super = -(-C // M)
                pad = n_super * M - C
                if pad:
                    empty = np.empty((pad, 6), np.float32)
                    empty[:, :3] = 1e30
                    empty[:, 3:] = -1e30
                    caabb = np.concatenate([caabb, empty])
                    slots = np.concatenate(
                        [slots, np.full(pad * cluster_k, -1, slots.dtype)])
                grp = caabb.reshape(n_super, M, 6)
                sup = np.concatenate([grp[:, :, :3].min(1),
                                      grp[:, :, 3:].max(1)], axis=1)
                caabb = np.concatenate([caabb, sup.astype(np.float32)])
                self.n_super = n_super
                self.n_clusters_pad = n_super * M

            def reseg(a, fill):
                seg = a[t0:][np.maximum(slots, 0)].copy()
                seg[slots < 0] = fill
                return np.concatenate([a[:t0], seg])

            geo_s = reseg(geo_s, 0.0)
            aux = reseg(aux, 0.0)
            orig = reseg(orig, S)
            # Padding rows are degenerate triangles (det == 0, never win);
            # their attributes are inert.
            meta = reseg(meta, _pack_meta(0, 0, NULL_BXDF, TRIANGLE))
            expo = reseg(expo, 0.0)
        self.n_tri_pad = geo_s.shape[0] - t0 if self.n_clusters \
            else self.n_tri

        # Kernel geo form: triangle rows store (v0, e1 = v1-v0, e2 =
        # v2-v0), the Moller-Trumbore edge diffs in the f32 subtraction
        # the test would do. `geo_vertex` keeps the (v0, v1, v2) form.
        self.geo_vertex = geo_s
        geo_k = geo_s.copy()
        if geo_k.shape[0] > t0:
            geo_k[t0:, 3:6] -= geo_k[t0:, 0:3]
            geo_k[t0:, 6:9] -= geo_k[t0:, 0:3]

        self.operands_numpy = (geo_k, aux, orig, meta, expo, caabb)
        dev = scene.device
        self.operands = tuple(torch.as_tensor(a, device=dev).contiguous()
                              for a in self.operands_numpy)

    @staticmethod
    def of(scene) -> "DynScene":
        """A prebuilt DynScene as it is (callers who want their own
        `cluster_k` build `DynScene(scene, cluster_k=...)` and hand that
        to the factories), a Scene prepared with the defaults."""
        return scene if isinstance(scene, DynScene) else DynScene(scene)


def _cluster_tris(tri_geo: np.ndarray, K: int):
    """Median-split triangle clustering (a flattened BVH leaf list).

    Splits recursively on the longest centroid axis, with the split point
    biased to a multiple of K so that most leaves are full. Returns
    `(slots, aabbs)`: `slots` i64[C*K] maps each visit slot to a triangle
    index within the segment (-1 = degenerate padding), and `aabbs`
    f32[C, 6] are per-cluster (lo xyz, hi xyz) boxes grown by a relative
    epsilon, so that f32 rounding in the slab test never culls a true
    hit."""
    v = np.asarray(tri_geo[:, :9], np.float64).reshape(-1, 3, 3)
    lo = v.min(1)
    hi = v.max(1)
    cent = (lo + hi) * 0.5
    leaves: list[np.ndarray] = []

    def split(idx):
        if idx.size <= K:
            leaves.append(idx)
            return
        ext = cent[idx].max(0) - cent[idx].min(0)
        ax = int(np.argmax(ext))
        order = idx[np.argsort(cent[idx, ax], kind="stable")]
        mid = K * int(round(idx.size / 2 / K))
        mid = min(max(mid, K), ((idx.size - 1) // K) * K)
        split(order[:mid])
        split(order[mid:])

    split(np.arange(v.shape[0]))
    slots = np.full((len(leaves), K), -1, np.int64)
    aabbs = np.empty((len(leaves), 6), np.float32)
    for c, idx in enumerate(leaves):
        slots[c, :idx.size] = idx
        l = lo[idx].min(0)
        h = hi[idx].max(0)
        eps = 1e-5 * np.maximum(np.abs(l), np.abs(h)) + 1e-6
        aabbs[c, :3] = (l - eps).astype(np.float32)
        aabbs[c, 3:] = (h + eps).astype(np.float32)
    return slots.ravel(), aabbs


# ---------------------------------------------------------------------------
# The plain PyTorch versions, in the kernels' op order.

_TRI_BLOCK = 32  # triangle rows tested per batch when unclustered


def dyn_intersect(ds: DynScene, o, d, fastmath: bool = False, alive=None,
                  stats: dict | None = None):
    """Nearest hit over the operands for rays (o, d), each a tuple of
    three f[n]. Returns (best_t f[n], hit bool[n], row i64[n]): the
    winner's distance, whether anything was hit, and its row in the
    operands (meaningless where `hit` is false).

    The winner is the lexicographic (t, original index) minimum: the
    keep-first rule of the reference scan (pathtracer.hpp:78-80), whatever
    the visit order in the exact variant. With `fastmath` the best hit is
    carried as a ratio (numerator, denominator > 0), candidates compare by
    cross-multiplication and one divide per ray recovers t after the loop;
    that order of rounded products is not transitive on near-ties, so
    there the winner may depend on the visit order (a ray aimed at a mesh
    vertex may get another winner on another cluster layout), as in the
    JAX kernel. Rays visit the boxes in row order and each entered leaf's
    triangles in index order, as the kernels do, so on one layout this
    and the kernels agree bit for bit in both variants.
    Each ray skips the clusters its own slab test does not enter; rays
    with `alive` false skip everything. `stats`, when given, gains this
    call's counts of rays and of plane, sphere, box and triangle tests.
    """
    geo, _, _, _, _, caabb = ds.operands
    geo_np, _, orig_np, _, _, caabb_np = ds.operands_numpy
    ox, oy, oz = o
    dx, dy, dz = d
    n = dx.shape[0]
    dev, dtype = dx.device, dx.dtype
    inf = float("inf")
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=dev)
    bn = torch.full((n,), inf, dtype=dtype, device=dev)
    bd = torch.ones(n, dtype=dtype, device=dev)
    boi = torch.full((n,), ds.n_shapes, dtype=torch.int64, device=dev)
    brow = torch.zeros(n, dtype=torch.int64, device=dev)
    if stats is not None:
        n_live = int(alive.sum())
        stats["rays"] = stats.get("rays", 0) + n_live
        stats["plane"] = stats.get("plane", 0) + n_live * ds.n_plane
        stats["sphere"] = stats.get("sphere", 0) + n_live * ds.n_sphere

    def count(key, mask, per_ray):
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(mask.sum()) * per_ray

    def update(i, num, den, valid):
        nonlocal bn, bd, boi, brow
        oi = int(orig_np[i])
        if fastmath:
            lhs = num * bd
            rhs = bn * den
            closer = valid & ((lhs < rhs)
                              | ((lhs == rhs) & (bn < inf) & (oi < boi)))
            bd = torch.where(closer, den, bd)
        else:
            closer = valid & ((num < bn)
                              | ((num == bn) & (bn < inf) & (oi < boi)))
        bn = torch.where(closer, num, bn)
        boi = torch.where(closer, oi, boi)
        brow = torch.where(closer, i, brow)

    one = torch.ones(n, dtype=dtype, device=dev)
    lo = 0
    for i in range(lo, lo + ds.n_plane):
        n0, n1, n2, off = (float(v) for v in geo_np[i, :4])
        h = (ox * n0 + oy * n1 + oz * n2) - off
        denom = dx * (-n0) + dy * (-n1) + dz * (-n2)
        if fastmath:
            num = torch.where(denom < 0, -h, h)
            den = torch.abs(denom)
            update(i, num, den, alive & (num > 0) & (den > 0))
        else:
            t = h / denom
            update(i, t, None, alive & (t > 0))
    lo += ds.n_plane
    for i in range(lo, lo + ds.n_sphere):
        c0, c1, c2, r = (float(v) for v in geo_np[i, :4])
        ocx, ocy, ocz = ox - c0, oy - c1, oz - c2
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        cc = (ocx * ocx + ocy * ocy + ocz * ocz) - float(
            np.float32(r) * np.float32(r))
        disc = b * b - 4.0 * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        if fastmath:
            t1 = (-b - sq) * 0.5
            t2 = (-b + sq) * 0.5
        else:
            t1 = (-b - sq) / 2.0
            t2 = (-b + sq) / 2.0
        t = torch.where(t1 > 0, t1, t2)
        update(i, t, one, alive & (disc >= 0) & (t > 0))
    lo += ds.n_sphere

    def tri_rows(r0, r1, mask):
        """Test triangle rows [r0, r1) as one batch [k, n], then update
        row by row in visit order for the rays of `mask`."""
        G = geo[r0:r1]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            G[:, j:j + 1] for j in range(9))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u_raw = tvx * px + tvy * py + tvz * pz
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v_raw = dx * qx + dy * qy + dz * qz
        t_raw = e2x * qx + e2y * qy + e2z * qz
        if fastmath:
            neg = det < 0
            den = torch.abs(det)
            u_n = torch.where(neg, -u_raw, u_raw)
            v_n = torch.where(neg, -v_raw, v_raw)
            num = torch.where(neg, -t_raw, t_raw)
            valid = ((den > _TRI_DET_EPS) & (u_n >= 0) & (v_n >= 0)
                     & (u_n + v_n <= den) & (num > 0))
        else:
            inv = 1.0 / det
            u = u_raw * inv
            v = v_raw * inv
            num = t_raw * inv
            den = None
            valid = ((torch.abs(det) > _TRI_DET_EPS) & (u >= 0) & (v >= 0)
                     & (u + v <= 1) & (num > 0))
        valid = valid & mask
        for k in range(r1 - r0):
            update(r0 + k, num[k], den[k] if fastmath else None, valid[k])

    if not ds.n_clusters:
        count("tri", alive, ds.n_tri)
        for r0 in range(lo, lo + ds.n_tri, _TRI_BLOCK):
            tri_rows(r0, min(r0 + _TRI_BLOCK, lo + ds.n_tri), alive)
    else:
        big = 1e30

        def safe_inv(c):
            tiny = torch.abs(c) < 1e-30
            return torch.where(tiny, torch.where(c < 0, -big, big), 1.0 / c)

        ivx, ivy, ivz = safe_inv(dx), safe_inv(dy), safe_inv(dz)

        def slab_enter(row):
            lx, ly, lz, hx, hy, hz = (float(v) for v in caabb_np[row])
            tx1, ty1, tz1 = (lx - ox) * ivx, (ly - oy) * ivy, (lz - oz) * ivz
            tx2, ty2, tz2 = (hx - ox) * ivx, (hy - oy) * ivy, (hz - oz) * ivz
            tmin = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                               torch.minimum(ty1, ty2)),
                                 torch.minimum(tz1, tz2))
            tmax = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                               torch.maximum(ty1, ty2)),
                                 torch.maximum(tz1, tz2))
            if fastmath:
                bound = tmin * bd <= bn * (1 + 1e-5) + 1e-5 * bd
            else:
                bound = tmin <= bn * (1 + 1e-5) + 1e-5
            return (tmax >= tmin) & (tmax > 0) & bound

        K = ds.cluster_k
        M = ds.super_m if ds.n_super else 1
        for grp in range(ds.n_super or ds.n_clusters):
            in_grp = alive
            if ds.n_super:
                count("box", alive, 1)
                in_grp = alive & slab_enter(ds.n_clusters_pad + grp)
                if not bool(in_grp.any()):
                    continue
            for c in range(grp * M, min((grp + 1) * M, ds.n_clusters)):
                # Padded leaf rows (c >= n_clusters) are skipped by index.
                count("box", in_grp, 1)
                enter = in_grp & slab_enter(c)
                if not bool(enter.any()):
                    continue
                count("tri", enter, K)
                tri_rows(lo + c * K, lo + (c + 1) * K, enter)

    hit = bn < inf
    bt = bn / bd if fastmath else bn
    return bt, hit, brow


def _rows_select(tab: torch.Tensor, rows: torch.Tensor, default: float):
    """Per-ray value f[3, n] of a parameter table by row index: the
    table's row for a real row, the sentinel's constant (ones for albedo,
    zeros for emission) for the last row or beyond."""
    n_param = tab.shape[0] - 1
    val = tab[rows.clamp(max=n_param)].T
    return torch.where(rows < n_param, val, default)


def dyn_shade(ds: DynScene, mt, ex, normal, d_in, u1, u2,
              fastmath: bool = False):
    """BxDF sample and scalar weight with the material type `mt` and the
    specular exponent `ex` as per-ray values (dynkernel.py:_dyn_shade,
    bxdf.hpp:29-41, :56-144); only the classes the scene holds are
    computed. Returns (dir_out as three f[n], sc_raw = s * cos / pdf)."""
    nx, ny, nz = normal
    ix, iy, iz = d_in

    def inv_sqrt(x):
        return torch.rsqrt(x) if fastmath else 1.0 / torch.sqrt(x)

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def reflect(v, m):
        k = 2.0 * dot3(m, v)
        return (-v[0] + k * m[0], -v[1] + k * m[1], -v[2] + k * m[2])

    if ds.have_diffuse or ds.have_specular:
        use_e1 = torch.abs(nx) < torch.abs(ny)
        tvx = torch.where(use_e1, 1.0 - nx * nx, -nx * ny)
        tvy = torch.where(use_e1, -ny * nx, 1.0 - ny * ny)
        tvz = torch.where(use_e1, -nz * nx, -nz * ny)
        tinv = inv_sqrt(tvx * tvx + tvy * tvy + tvz * tvz)
        tx, ty, tz = tvx * tinv, tvy * tinv, tvz * tinv
        bx = ny * tz - nz * ty
        by = nz * tx - nx * tz
        bz = nx * ty - ny * tx
        binv = inv_sqrt(bx * bx + by * by + bz * bz)
        bx, by, bz = bx * binv, by * binv, bz * binv
        cos_phi = torch.cos(2.0 * PI * u2)
        sin_phi = torch.sin(2.0 * PI * u2)

    def frame_dir(cos_t, sin_t):
        fx = cos_phi * sin_t
        fy = sin_phi * sin_t
        return (tx * fx + bx * fy + nx * cos_t,
                ty * fx + by * fy + ny * cos_t,
                tz * fx + bz * fy + nz * cos_t)

    zero = torch.zeros_like(u1)
    out = (zero, zero, zero)
    sc = zero

    def select(m, dd, sc_c):
        nonlocal out, sc
        out = tuple(torch.where(m, a, b) for a, b in zip(dd, out))
        sc = torch.where(m, sc_c, sc)

    if ds.have_diffuse:
        cos_t = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
        sin_t = torch.sqrt(u1)
        dd = frame_dir(cos_t, sin_t)
        cos_geom = dot3(normal, dd)
        if fastmath:
            sc_d = torch.where(u1 < 1.0,
                               cos_geom * torch.rsqrt(1.0 - u1), 0.0)
        else:
            pdf = cos_t / PI
            sc_d = torch.where(pdf > 0, (1.0 / PI) * cos_geom / pdf, 0.0)
        select(mt == DIFFUSE, dd, sc_d)

    if ds.have_specular:
        e = ex
        cos_h = torch.pow(u1, 1.0 / (e + 2.0))
        sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
        h = frame_dir(cos_h, sin_h)
        flip = dot3(h, d_in) < 0
        hf = reflect(h, normal)
        h = tuple(torch.where(flip, a, b) for a, b in zip(hf, h))
        dd = reflect(d_in, h)
        pdf = ((e + 2.0) / (2.0 * PI) * torch.pow(cos_h, e + 1.0) * sin_h)
        hwx, hwy, hwz = ix + dd[0], iy + dd[1], iz + dd[2]
        hw2 = hwx * hwx + hwy * hwy + hwz * hwz
        hinv = inv_sqrt(hw2)
        hwx, hwy, hwz = hwx * hinv, hwy * hinv, hwz * hinv
        cos_he = nx * hwx + ny * hwy + nz * hwz
        sin_he = torch.sqrt(torch.clamp(1.0 - cos_he * cos_he, min=0.0))
        powv = _pow_cpp_vec(cos_he, e)
        cos_geom = dot3(normal, dd)
        if fastmath:
            denom = torch.pow(cos_h, e + 1.0) * sin_h
            sc_s = torch.where((denom > 0) & (hw2 > 0),
                               powv * sin_he * cos_geom / denom, 0.0)
        else:
            s_val = (e + 2.0) / (2.0 * PI) * powv * sin_he
            s_val = torch.where(hw2 > 0, s_val, 0.0)
            sc_s = torch.where(pdf > 0, s_val * cos_geom / pdf, 0.0)
        select(mt == SPECULAR, dd, sc_s)

    if ds.have_mirror:
        dd = reflect(d_in, normal)
        cos_geom = dot3(normal, dd)
        if fastmath:
            sc_m = torch.where(cos_geom != 0, 1.0, 0.0).to(u1.dtype)
        else:
            sc_m = torch.where(cos_geom != 0, (1.0 / cos_geom) * cos_geom,
                               0.0)
        select(mt == MIRROR, dd, sc_m)

    return out, sc


def _dyn_bounce(ds: DynScene, cfg: RenderConfig, alb, emi, state, b, u,
                fastmath: bool = False, stats: dict | None = None):
    """One bounce over the operands (dynkernel.py:_dyn_wavefront_body) of
    state = (o, d, T f[3, n], L f[3, n], alive), o and d tuples of three
    f[n], at depth b: the wavefront's bounce, or i64[n] where every ray
    has its own depth (`ops.dynregen`). u = (u_rr, u1, u2). Returns (the
    new state, (P f[3, n], sc, gate, albedo row, emission row, alive)),
    the rows sanitized (the sentinel rows on dead lanes)."""
    _, aux_t, _, meta_t, expo_t, _ = ds.operands
    (ox, oy, oz), (dx, dy, dz), T, L, alive = state
    u_rr, u1, u2 = u
    dtype = dx.dtype
    inv_keep = 1.0 / (1.0 - cfg.absorb_prob)
    dead_meta = _pack_meta(alb.shape[0] - 1, emi.shape[0] - 1, NULL_BXDF,
                           PLANE)

    def inv_sqrt(x):
        return torch.rsqrt(x) if fastmath else 1.0 / torch.sqrt(x)

    if torch.is_tensor(b):
        rr_on = b >= cfg.min_bounces
        alive = alive & ~(rr_on & (u_rr < cfg.absorb_prob))
        # inv_keep rounded to dtype once (a Python float in torch.where
        # would make a float32 tensor).
        rr_scale = torch.where(
            rr_on, torch.tensor(inv_keep, dtype=dtype, device=dx.device),
            1.0)
    else:
        rr_scale = 1.0
        if b >= cfg.min_bounces:
            alive = alive & ~(u_rr < cfg.absorb_prob)
            rr_scale = inv_keep

    best_t, hit, row = dyn_intersect(ds, (ox, oy, oz), (dx, dy, dz),
                                     fastmath=fastmath, alive=alive,
                                     stats=stats)
    alive = alive & hit
    gate = torch.where(alive, rr_scale, 0.0).to(dtype)
    # The winner's attributes, sanitized on dead lanes: sentinel rows,
    # null material, zero normal source.
    meta = torch.where(alive, meta_t[row].long(), dead_meta)
    ar, er, mt, st = _unpack_meta(meta)
    aux = torch.where(alive, aux_t[row].T, 0.0)
    ex = torch.where(alive, expo_t[row], 0.0)

    P = T * gate
    L = L + P * _rows_select(emi, er, 0.0)

    px = torch.where(alive, ox + dx * best_t, 0.0)
    py = torch.where(alive, oy + dy * best_t, 0.0)
    pz = torch.where(alive, oz + dz * best_t, 0.0)
    # Normal: the raw plane normal or the unit triangle normal straight
    # from aux; for a sphere normalize(p - center).
    sx, sy, sz = px - aux[0], py - aux[1], pz - aux[2]
    sinv = inv_sqrt(sx * sx + sy * sy + sz * sz)
    is_sph = st == SPHERE
    normal = (torch.where(is_sph, sx * sinv, aux[0]),
              torch.where(is_sph, sy * sinv, aux[1]),
              torch.where(is_sph, sz * sinv, aux[2]))

    w, sc_raw = dyn_shade(ds, mt, ex, normal, (-dx, -dy, -dz), u1, u2,
                          fastmath=fastmath)
    sc = torch.where(alive, sc_raw, 0.0)

    T = P * _rows_select(alb, ar, 1.0) * sc
    o = tuple(torch.where(alive, q + wk * RAY_EPS, 0.0)
              for q, wk in zip((px, py, pz), w))
    d = tuple(torch.where(alive, wk, 0.0) for wk in w)
    return (o, d, T, L, alive), (P, sc, gate, ar, er, alive)


def _dyn_body(ds: DynScene, cfg: RenderConfig, alb, emi, o, d, tape,
              fastmath: bool = False, on_residual=None,
              stats: dict | None = None):
    """All max_depth bounces of rays (o, d) over the operands. Returns
    radiance f[3, n]. on_residual(b, P f[3, n], sc, gate, arow, erow,
    alive) sees every bounce."""
    n = d[0].shape[0]
    dtype, dev = d[0].dtype, d[0].device
    state = (o, d, torch.ones((3, n), dtype=dtype, device=dev),
             torch.zeros((3, n), dtype=dtype, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev))
    for b in range(cfg.max_depth):
        state, residual = _dyn_bounce(ds, cfg, alb, emi, state, b, tape[b],
                                      fastmath=fastmath, stats=stats)
        if on_residual is not None:
            on_residual(b, *residual)
    return state[3]


# Rays per pass of a plain version: it tests a leaf's triangles as one
# [cluster_k, rays] batch, and a dozen such temporaries are alive at once.
RAY_BLOCK = 1 << 20


def _plain_chunks(ds: DynScene, cc, cfg: RenderConfig, alb, emi, seeds,
                  cam_u, tape, n_chunks: int, fastmath: bool, collect: bool,
                  stats: dict | None, ray_base: int = 0,
                  n_rays: int | None = None):
    """Radiance summed over the chunks and, with `collect`, the stacked
    residuals of every chunk, of the n_rays slots from ray_base on (by
    default one chunk's W*H*spp_c from 0)."""
    n, pix_all, smp = mk._slots(cfg, n_rays, ray_base, alb.device)
    L = None
    rsc, rrow = [], []
    for c in range(n_chunks):
        cu, tp = mk._chunk_uniforms(cfg, alb, seeds, cam_u, tape, c, pix_all,
                                    smp)
        Lc, sc_c, row_c = [], [], []
        for r0 in range(0, n, RAY_BLOCK):
            r1 = min(r0 + RAY_BLOCK, n)
            pix = pix_all[r0:r1]
            o, d = mk.camera_ray_from_pix(cc, pix, cu[0, r0:r1],
                                          cu[1, r0:r1])
            sc_b = [None] * cfg.max_depth
            row_b = [None] * cfg.max_depth

            def keep(b, P, sc, gate, ar, er, alive):
                sc_b[b] = sc
                row_b[b] = (ar + (er << _ROW_BITS)
                            + torch.where(alive, 1 << (2 * _ROW_BITS), 0)
                            ).to(torch.int32)

            Lc.append(_dyn_body(ds, cfg, alb, emi, tuple(o), tuple(d),
                                tp[:, :, r0:r1], fastmath=fastmath,
                                on_residual=keep if collect else None,
                                stats=stats))
            if collect:
                sc_c.append(torch.stack(sc_b))
                row_c.append(torch.stack(row_b))
        Lc = torch.cat(Lc, dim=1)
        L = Lc if L is None else L + Lc
        if collect:
            rsc.append(torch.cat(sc_c, dim=1))
            rrow.append(torch.cat(row_c, dim=1))
    if not collect:
        return L
    if n_chunks == 1:
        return L, rsc[0], rrow[0]
    return L, torch.stack(rsc), torch.stack(rrow)


def dyn_trace_plain(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                    emi: torch.Tensor, *, seeds=None, cam_u=None, tape=None,
                    n_chunks: int = 1, fastmath: bool = False,
                    stats: dict | None = None, ray_base: int = 0,
                    n_rays: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of the dyn tracer, on the tensors'
    device. Pass `seeds` (internal RNG, any n_chunks) or `cam_u` and
    `tape`. Returns radiance f[3, N] summed over the chunks. `fastmath`
    takes the kernel's fast forms except the camera's rsqrt. ray_base and
    n_rays select a shard's slots, as `megakernel.fused_trace_plain`'s."""
    return _plain_chunks(ds, cc, cfg, alb, emi, seeds, cam_u, tape, n_chunks,
                         fastmath, False, stats, ray_base, n_rays)


def dyn_collect_plain(ds: DynScene, cc, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, *, seeds=None,
                      cam_u=None, tape=None, n_chunks: int = 1,
                      fastmath: bool = False, ray_base: int = 0,
                      n_rays: int | None = None):
    """The plain version of the dyn collect tracer: (radiance f[3, N]
    summed over the chunks, rsc f[C, D, N], rrow i32[C, D, N]), the chunk
    dimension dropped when n_chunks == 1."""
    return _plain_chunks(ds, cc, cfg, alb, emi, seeds, cam_u, tape, n_chunks,
                         fastmath, True, None, ray_base, n_rays)


def dyn_sweep_plain(cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                    rsc: torch.Tensor, rrow: torch.Tensor, g: torch.Tensor):
    """The plain version of the dyn sweep adjoint: the replay and reverse
    sweep of `ops.megakernel.sweep_rows_plain` with the rows of each
    bounce unpacked from `rrow`. Returns (d_albedo f[K+1, 3], d_emission
    f[L+1, 3]), sentinel rows zero."""
    if rsc.ndim == 2:
        rsc, rrow = rsc[None], rrow[None]
    mask = _ROW_CAP - 1

    def rows_of(c, b):
        pack = rrow[c, b].long()
        return ((pack >> (2 * _ROW_BITS)) > 0, pack & mask,
                (pack >> _ROW_BITS) & mask)

    return mk.sweep_rows_plain(cfg, alb, emi, rsc, rows_of, g)


def dyn_adjoint_plain(ds: DynScene, cc, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, g: torch.Tensor,
                      *, seeds=None, cam_u=None, tape=None,
                      n_chunks: int = 1, fastmath: bool = False,
                      ray_base: int = 0, n_rays: int | None = None):
    """The plain version of the dyn retrace adjoint: the collect version,
    then the sweep version on its residuals."""
    _, rsc, rrow = dyn_collect_plain(ds, cc, cfg, alb, emi, seeds=seeds,
                                     cam_u=cam_u, tape=tape,
                                     n_chunks=n_chunks, fastmath=fastmath,
                                     ray_base=ray_base, n_rays=n_rays)
    return dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g)


# ---------------------------------------------------------------------------
# The kernels' wrappers.

class _DynLayout(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "n_plane", "n_sphere", "n_tri", "n_rows", "cluster_k", "n_clusters",
        "n_clusters_pad", "n_super", "super_m", "n_caabb")]


class _DynOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "geo", "aux", "orig", "meta", "expo", "caabb")]


def _library() -> ctypes.CDLL:
    """The tracer library: drt_dyn_trace, drt_dyn_collect,
    drt_dyn_cull_stats, drt_dyn_trace_lanes."""
    from drt_tpu_torch.utils import native

    lib = native.load(SOURCE)
    if lib.drt_dyn_trace.argtypes is None:
        structs = (mk._DrtTrace, _DynLayout, mk._DrtCamera, _DynOperands)
        # alb, emi, cam_u, tape, out, [rsc, rrow,] stream
        mk._bind(lib, "drt_dyn_trace", 6, structs)
        mk._bind(lib, "drt_dyn_trace_lanes", 6, structs)
        mk._bind(lib, "drt_dyn_collect", 8, structs)
        # alb, emi, out, stats, stream
        mk._bind(lib, "drt_dyn_cull_stats", 5, structs)
        lib.drt_dyn_error_string.argtypes = [ctypes.c_int]
        lib.drt_dyn_error_string.restype = ctypes.c_char_p
        mk._check_limits(SOURCE, lib.drt_dyn_limits,
                         [_ROW_CAP, N_STATS, mk.BLOCK])
    return lib


def _adjoint_library() -> ctypes.CDLL:
    """The adjoint library: drt_dyn_sweep, drt_dyn_adjoint."""
    from drt_tpu_torch.utils import native

    lib = native.load(ADJOINT_SOURCE)
    if lib.drt_dyn_sweep.argtypes is None:
        # alb, emi, rsc, rrow, g, g_n, scratch, partials, da, de, stream
        mk._bind(lib, "drt_dyn_sweep", 11, (mk._DrtTrace,), n_ints_at=(5,))
        mk._bind_stages(lib, "drt_dyn_sweep_stages")
        mk._bind_deep_bytes(lib)
        # alb, emi, cam_u, tape, g, g_n, scratch, partials, da, de, stream
        mk._bind(lib, "drt_dyn_adjoint", 11,
                 (mk._DrtTrace, _DynLayout, mk._DrtCamera, _DynOperands),
                 n_ints_at=(5,))
        lib.drt_dyn_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.drt_dyn_adjoint_error_string.restype = ctypes.c_char_p
        mk._check_limits(ADJOINT_SOURCE, lib.drt_dyn_adjoint_limits,
                         [_ROW_CAP, MAX_GRAD_ROWS, mk.MAX_DEPTH, mk.BLOCK])
    return lib


def _dyn_config(cfg: RenderConfig, n_shapes: int, alb, emi, *, seeds=None,
                fastmath: bool = False, n_chunks: int = 1,
                n_rays: int | None = None,
                ray_base: int = 0) -> mk._DrtTrace:
    """Check the parameter tables on the card and fill the kernels'
    config: n_rays slots from ray_base on (by default one chunk's
    W*H*spp_c from 0)."""
    dev = alb.device
    spp_c = cfg.spp // cfg.spp_chunks
    n_total = cfg.width * cfg.height * spp_c
    n = n_total if n_rays is None else n_rays
    if ray_base:
        mk.check_ray_base(ray_base, n, n_total)
    for name, tab in (("albedo", alb), ("emission", emi)):
        if tab.ndim != 2 or not 1 <= tab.shape[0] <= _ROW_CAP:
            raise ValueError(f"{name} table {tuple(tab.shape)}: "
                             f"1..{_ROW_CAP} rows of 3")
        mk._check(f"{name} table", tab, (tab.shape[0], 3), dev)
    seed_words = mk._seed_words(seeds, n_chunks * spp_c)
    if 3 * n >= 2 ** 31 or n_chunks * cfg.max_depth * n >= 2 ** 31:
        raise ValueError(f"{n} rays per chunk x {n_chunks} chunks x "
                         f"{cfg.max_depth} bounces exceed the kernels' "
                         "32-bit indexing; raise spp_chunks")
    return mk._DrtTrace(cfg.width, cfg.height, n, spp_c, n_chunks,
                        cfg.max_depth, cfg.min_bounces, n_shapes,
                        alb.shape[0], emi.shape[0], int(seeds is not None),
                        int(bool(fastmath)), cfg.absorb_prob,
                        1.0 / (1.0 - cfg.absorb_prob), *seed_words,
                        ray_base)


def _scene_structs(ds: DynScene, dev):
    """(layout, operand pointers) of a DynScene for a launch on `dev`."""
    if ds.n_shapes > MAX_DYN_SHAPES:
        raise ValueError(f"{ds.n_shapes} shapes exceed the "
                         f"{MAX_DYN_SHAPES} the memory-resident kernels "
                         "take")
    geo, aux, orig, meta, expo, caabb = ds.operands
    rows = geo.shape[0]
    for name, t, shape, dtype in (
            ("geo", geo, (rows, 12), torch.float32),
            ("aux", aux, (rows, 3), torch.float32),
            ("orig", orig, (rows,), torch.int32),
            ("meta", meta, (rows,), torch.int32),
            ("expo", expo, (rows,), torch.float32),
            ("caabb", caabb, (caabb.shape[0], 6), torch.float32)):
        mk._check(f"scene operand {name}", t, shape, dev, dtype)
    lay = _DynLayout(ds.n_plane, ds.n_sphere, ds.n_tri, rows, ds.cluster_k,
                     ds.n_clusters, ds.n_clusters_pad, ds.n_super,
                     ds.super_m, caabb.shape[0])
    return lay, _DynOperands(*(t.data_ptr() for t in ds.operands))


def _launch_trace(wrapper, what: str, entry_name: str, ds: DynScene, cc,
                  cfg: RenderConfig, alb, emi, seeds, cam_u, tape,
                  fastmath: bool, n_chunks: int, ray_base: int = 0,
                  n_rays: int | None = None) -> torch.Tensor:
    """Launch one of the tracer library's radiance-only entry points and
    return its radiance f32[3, N]."""
    dev = alb.device
    tcfg = _dyn_config(cfg, ds.n_shapes, alb, emi, seeds=seeds,
                       fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                       ray_base=ray_base)
    cu_ptr, tape_ptr = mk._uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lay, ops = _scene_structs(ds, dev)
    lib = _library()
    out = torch.empty((3, tcfg.n_rays), dtype=torch.float32, device=dev)
    mk._launch(wrapper, what, lib.drt_dyn_error_string,
               getattr(lib, entry_name), dev, ctypes.byref(tcfg),
               ctypes.byref(lay), ctypes.byref(mk._camera_struct(cc)),
               ctypes.byref(ops), alb.data_ptr(), emi.data_ptr(), cu_ptr,
               tape_ptr, out.data_ptr())
    return out


def dyn_trace(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
              emi: torch.Tensor, *, seeds=None, cam_u=None, tape=None,
              fastmath: bool = False, n_chunks: int = 1, ray_base: int = 0,
              n_rays: int | None = None) -> torch.Tensor:
    """Radiance f32[3, N] of the dyn tracer. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise. A shard traces the
    n_rays slots from ray_base on (`megakernel.fused_trace`)."""
    if mk._device_of("dyn_trace", alb) == "cpu":
        return dyn_trace_plain(ds, cc, cfg, alb, emi, seeds=seeds,
                               cam_u=cam_u, tape=tape, n_chunks=n_chunks,
                               fastmath=fastmath, ray_base=ray_base,
                               n_rays=n_rays)
    return _launch_trace(dyn_trace, "dyn tracer", "drt_dyn_trace", ds, cc,
                         cfg, alb, emi, seeds, cam_u, tape, fastmath,
                         n_chunks, ray_base, n_rays)


def dyn_trace_lanes(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                    emi: torch.Tensor, *, seeds=None, cam_u=None, tape=None,
                    fastmath: bool = False,
                    n_chunks: int = 1) -> torch.Tensor:
    """Radiance f32[3, N] of the dyn tracer's per-thread reference build
    (`drt_dyn_trace_lanes`): each thread tests the triangles of the
    leaves its ray enters alone, as the kernels did before the warp-wide
    leaf test. Its radiance is `dyn_trace`'s bit for bit on every layout,
    in both variants, which holds the warp's fold order to the per-thread
    loop's. A checking build: no renderer routes to it and its launches
    are not counted. CPU tensors run the plain version; CUDA tensors
    launch the build or raise."""
    if mk._device_of("dyn_trace_lanes", alb) == "cpu":
        return dyn_trace_plain(ds, cc, cfg, alb, emi, seeds=seeds,
                               cam_u=cam_u, tape=tape, n_chunks=n_chunks,
                               fastmath=fastmath)
    return _launch_trace(None, "dyn per-thread reference tracer",
                         "drt_dyn_trace_lanes", ds, cc, cfg, alb, emi, seeds,
                         cam_u, tape, fastmath, n_chunks)


def dyn_cull_stats(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                   emi: torch.Tensor, seeds, n_chunks: int = 1) -> dict:
    """Run the tracer's checking build (fast variant, internal RNG) on
    the card and return its counters: the lane-bounces and warp-bounces
    that ran the nearest-hit loop, the leaf clusters entered summed over
    lanes, and the leaves the warps tested (for at least one ray). Not
    counted as a launch of the tracer."""
    dev = alb.device
    tcfg = _dyn_config(cfg, ds.n_shapes, alb, emi, seeds=seeds,
                       fastmath=True, n_chunks=n_chunks)
    lay, ops = _scene_structs(ds, dev)
    lib = _library()
    out = torch.empty((3, tcfg.n_rays), dtype=torch.float32, device=dev)
    stats = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    mk._launch(None, "dyn cull-stats", lib.drt_dyn_error_string,
               lib.drt_dyn_cull_stats, dev, ctypes.byref(tcfg),
               ctypes.byref(lay), ctypes.byref(mk._camera_struct(cc)),
               ctypes.byref(ops), alb.data_ptr(), emi.data_ptr(),
               out.data_ptr(), stats.data_ptr())
    lane_bounces, warp_bounces, lane_leaves, warp_leaves = stats.tolist()
    return dict(lane_bounces=lane_bounces, warp_bounces=warp_bounces,
                lane_leaves=lane_leaves, warp_leaves=warp_leaves,
                radiance=out)


def dyn_collect(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                emi: torch.Tensor, *, seeds=None, cam_u=None, tape=None,
                fastmath: bool = False, n_chunks: int = 1, ray_base: int = 0,
                n_rays: int | None = None):
    """(radiance f32[3, N], rsc f32[C, D, N], rrow i32[C, D, N]) of the
    dyn collect tracer, the chunk dimension dropped when n_chunks == 1.
    The radiance equals `dyn_trace`'s bit for bit. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if alb.shape[0] > _ROW_CAP or emi.shape[0] > _ROW_CAP:
        raise ValueError(
            f"dyn stored residuals pack rows into {_ROW_BITS} bits: "
            f"{alb.shape[0]} albedo / {emi.shape[0]} "
            "emission rows exceed that (use adjoint='retrace')")
    if mk._device_of("dyn_collect", alb) == "cpu":
        return dyn_collect_plain(ds, cc, cfg, alb, emi, seeds=seeds,
                                 cam_u=cam_u, tape=tape, n_chunks=n_chunks,
                                 fastmath=fastmath, ray_base=ray_base,
                                 n_rays=n_rays)
    dev = alb.device
    tcfg = _dyn_config(cfg, ds.n_shapes, alb, emi, seeds=seeds,
                       fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                       ray_base=ray_base)
    cu_ptr, tape_ptr = mk._uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lay, ops = _scene_structs(ds, dev)
    lib = _library()
    n, D = tcfg.n_rays, cfg.max_depth
    res_shape = (D, n) if n_chunks == 1 else (n_chunks, D, n)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    rsc = torch.empty(res_shape, dtype=torch.float32, device=dev)
    rrow = torch.empty(res_shape, dtype=torch.int32, device=dev)
    mk._launch(dyn_collect, "dyn collect tracer", lib.drt_dyn_error_string,
               lib.drt_dyn_collect, dev, ctypes.byref(tcfg),
               ctypes.byref(lay), ctypes.byref(mk._camera_struct(cc)),
               ctypes.byref(ops), alb.data_ptr(), emi.data_ptr(), cu_ptr,
               tape_ptr, out.data_ptr(), rsc.data_ptr(), rrow.data_ptr())
    return out, rsc, rrow


def dyn_sweep_stages(n_alb: int, n_emi: int, max_depth: int) -> int:
    """The ring stages `dyn_sweep`'s kernel launches with on the current
    card for tables of n_alb and n_emi rows (the sentinel rows included):
    3 up to 128 real rows; 0 means its rows come through registers."""
    return mk._stages(_adjoint_library().drt_dyn_sweep_stages,
                      "dyn sweep stages", n_alb, n_emi, max_depth)


def dyn_sweep(cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
              rsc: torch.Tensor, rrow: torch.Tensor, g: torch.Tensor, *,
              n_chunks: int = 1, n_rays: int | None = None):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of the dyn sweep
    adjoint from the collect tracer's residuals and a cotangent g. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise. The kernel reads a slot's rows up to its first dead row (the
    live bit of rrow clear) and no further. It takes each slot's first
    rows through a ring in shared memory, sized at launch from what the
    table rows' accumulator leaves (`dyn_sweep_stages`: 3 stages up to 128
    real rows), and through registers where fewer than two stages fit, as
    at 144 rows, where the accumulator fills the block's shared memory.
    Above MAX_GRAD_ROWS real rows (up to 255 + 255) or mk.MAX_DEPTH
    bounces it takes its deep form, whose accumulator and rows past 32
    live in device memory (`mk.deep_scratch`). A shard's sweep (n_rays
    slots) draws nothing and takes no ray offset."""
    if mk._device_of("dyn_sweep", alb) == "cpu":
        return dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g)
    dev = alb.device
    tcfg = _dyn_config(cfg, 0, alb, emi, n_chunks=n_chunks, n_rays=n_rays)
    n, D = tcfg.n_rays, cfg.max_depth
    res_shape = (D, n) if n_chunks == 1 else (n_chunks, D, n)
    mk._check("rsc", rsc, res_shape, dev)
    mk._check("rrow", rrow, res_shape, dev, torch.int32)
    partials, da, de = mk._adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    deep = mk.deep_scratch(lib, n, D, tcfg.n_alb, tcfg.n_emi, dev)
    mk._launch(dyn_sweep, "dyn sweep adjoint",
               lib.drt_dyn_adjoint_error_string, lib.drt_dyn_sweep, dev,
               ctypes.byref(tcfg), alb.data_ptr(), emi.data_ptr(),
               rsc.data_ptr(), rrow.data_ptr(), g.data_ptr(), g.shape[1],
               mk._ptr(deep), partials.data_ptr(), da.data_ptr(),
               de.data_ptr())
    return da, de


def dyn_adjoint(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                emi: torch.Tensor, g: torch.Tensor, *, seeds=None,
                cam_u=None, tape=None, fastmath: bool = False,
                n_chunks: int = 1, ray_base: int = 0,
                n_rays: int | None = None):
    """(d_albedo, d_emission) of the dyn retrace adjoint: the forward
    traced again in the kernel from `seeds` (or `cam_u`, `tape`), then
    the sweep. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise. ray_base and n_rays as `dyn_trace`'s; from ray_base
    > 0, g is per ray."""
    if mk._device_of("dyn_adjoint", alb) == "cpu":
        return dyn_adjoint_plain(ds, cc, cfg, alb, emi, g, seeds=seeds,
                                 cam_u=cam_u, tape=tape, n_chunks=n_chunks,
                                 fastmath=fastmath, ray_base=ray_base,
                                 n_rays=n_rays)
    dev = alb.device
    tcfg = _dyn_config(cfg, ds.n_shapes, alb, emi, seeds=seeds,
                       fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                       ray_base=ray_base)
    cu_ptr, tape_ptr = mk._uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lay, ops = _scene_structs(ds, dev)
    partials, da, de = mk._adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    deep = mk.deep_scratch(lib, tcfg.n_rays, cfg.max_depth, tcfg.n_alb,
                           tcfg.n_emi, dev)
    mk._launch(dyn_adjoint, "dyn retrace adjoint",
               lib.drt_dyn_adjoint_error_string, lib.drt_dyn_adjoint, dev,
               ctypes.byref(tcfg), ctypes.byref(lay),
               ctypes.byref(mk._camera_struct(cc)), ctypes.byref(ops),
               alb.data_ptr(), emi.data_ptr(), cu_ptr, tape_ptr,
               g.data_ptr(), g.shape[1], mk._ptr(deep), partials.data_ptr(),
               da.data_ptr(), de.data_ptr())
    return da, de


mk.register_wrappers(dyn_tracer=dyn_trace, dyn_collect=dyn_collect,
                     dyn_sweep=dyn_sweep, dyn_adjoint=dyn_adjoint)


def make_dyn_tracer(scene, cam, cfg: RenderConfig, rng: str = "internal",
                    fastmath: bool = False, n_chunks: int = 1,
                    plain: bool = False, n_rays: int | None = None):
    """Build `trace(alb, emi, seeds)` (rng="internal") or `trace(alb, emi,
    cam_u, tape)` (rng="tape") -> radiance f32[3, N] over a Scene or a
    prebuilt DynScene. n_chunks > 1 (internal RNG only) runs the spp
    chunks in one launch and sums their radiance per ray slot. plain=True
    runs the plain version on whatever device the tensors lie on (the
    "torch-dyn" backend). n_rays and `trace(..., ray_base=)` select a
    shard's slots (`megakernel.make_fused_tracer`)."""
    mk._check_rng(rng, n_chunks)
    ds = DynScene.of(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    fn = dyn_trace_plain if plain else dyn_trace

    def trace(alb, emi, *args, ray_base: int = 0):
        return fn(ds, cc, cfg, alb, emi, fastmath=fastmath,
                  n_chunks=n_chunks, ray_base=ray_base, n_rays=n_rays,
                  **mk._uniform_kw(rng, args))

    return trace


def make_dyn_collect_tracer(scene, cam, cfg: RenderConfig,
                            rng: str = "internal", fastmath: bool = False,
                            n_chunks: int = 1, plain: bool = False,
                            n_rays: int | None = None):
    """Build `trace(alb, emi, seeds | cam_u, tape) -> (L f32[3, N], rsc,
    rrow)`: the tracer that also stores the adjoint's residuals, 8 bytes
    per bounce-ray. L is `make_dyn_tracer`'s radiance bit for bit."""
    mk._check_rng(rng, n_chunks)
    ds = DynScene.of(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    fn = dyn_collect_plain if plain else dyn_collect

    def trace(alb, emi, *args, ray_base: int = 0):
        return fn(ds, cc, cfg, alb, emi, fastmath=fastmath,
                  n_chunks=n_chunks, ray_base=ray_base, n_rays=n_rays,
                  **mk._uniform_kw(rng, args))

    return trace


def make_dyn_sweep_adjoint(scene, cfg: RenderConfig, n_chunks: int = 1,
                           plain: bool = False, n_rays: int | None = None):
    """Build `sweep(alb, emi, rsc, rrow, g) -> (d_albedo, d_emission)`:
    the backward from the collect tracer's residuals, with g f32[3, N] per
    ray slot (identical across chunks) or f32[3, W*H] per pixel. `scene`
    is taken for the JAX package's signature; the sweep reads rows, not
    shapes."""
    def sweep(alb, emi, rsc, rrow, g):
        if plain:
            return dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g)
        return dyn_sweep(cfg, alb, emi, rsc, rrow, g, n_chunks=n_chunks,
                         n_rays=n_rays)

    return sweep


def make_dyn_adjoint(scene, cam, cfg: RenderConfig, rng: str = "internal",
                     fastmath: bool = False, n_chunks: int = 1,
                     plain: bool = False, n_rays: int | None = None):
    """Build `adj(alb, emi, seeds, g)` (rng="internal") or `adj(alb, emi,
    cam_u, tape, g)` (rng="tape") -> (d_albedo, d_emission): the retrace
    adjoint. Pass the forward's seeds for biased mode or a fresh seeds[1]
    for unbiased mode (integrate.hpp:39-52)."""
    mk._check_rng(rng, n_chunks)
    ds = DynScene.of(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    fn = dyn_adjoint_plain if plain else dyn_adjoint

    def adjoint(alb, emi, *args, ray_base: int = 0):
        *uniforms, g = args
        return fn(ds, cc, cfg, alb, emi, g, fastmath=fastmath,
                  n_chunks=n_chunks, ray_base=ray_base, n_rays=n_rays,
                  **mk._uniform_kw(rng, tuple(uniforms)))

    return adjoint
