"""Vectorized ray-scene intersection (nearest hit), scalarized SoA.

The port of `drt_tpu.ops.intersect`: the reference's per-ray linear scan
with virtual dispatch (pathtracer.hpp:72-89, shape.hpp:20-24) becomes a
masked sweep over the shapes with a running (t, index) minimum. Strict
`<` keeps the first of tied shapes, as the reference's `t >= tmin` skip
does (pathtracer.hpp:79).

Quirks kept:
  - plane: `t = (dot(o, n) - offset) / dot(d, -n)`, hit iff t > 0, no
    epsilon, IEEE inf/nan on a parallel ray (shape.hpp:49-56);
  - the plane normal is returned as stored, unnormalized
    (shape.hpp:58-59);
  - sphere: smallest positive root, miss iff discriminant < 0
    (shape.hpp:78-103); normal = normalize(p - c) (shape.hpp:105-106).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drt_tpu_torch.ops.vecmath import V3, crossv, dotv, normalizev, wherev
from drt_tpu_torch.scene import PLANE, SPHERE, Scene

_TRI_DET_EPS = 1e-9


class Hit(NamedTuple):
    t: torch.Tensor  # f[N] distance (+inf on miss)
    point: V3
    normal: V3  # raw plane normal; unit sphere/triangle normal
    mat: torch.Tensor  # i32[N] material row (null sentinel on miss)
    emit: torch.Tensor  # i32[N] emission row (zero sentinel on miss)
    valid: torch.Tensor  # bool[N]
    shape: torch.Tensor  # i64[N] nearest shape's index (0 on miss)


def _cv3(geo, i) -> V3:
    return V3(geo[i], geo[i + 1], geo[i + 2])


def _plane_t(geo, o: V3, d: V3):
    n = _cv3(geo, 0)
    h = dotv(o, n) - geo[3]
    denom = dotv(d, -n)
    t = h / denom
    return t, t > 0


def _sphere_t(geo, o: V3, d: V3):
    c = _cv3(geo, 0)
    r = geo[3]
    oc = o - c
    b = 2.0 * dotv(oc, d)
    cc = dotv(oc, oc) - r * r
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    t = torch.where(t1 > 0, t1, t2)
    return t, (disc >= 0) & (t > 0)


def _triangle_t(geo, o: V3, d: V3):
    v0 = _cv3(geo, 0)
    e1 = _cv3(geo, 3) - v0
    e2 = _cv3(geo, 6) - v0
    p = crossv(d, e2)
    det = dotv(e1, p)
    inv = 1.0 / det
    tvec = o - v0
    u = dotv(tvec, p) * inv
    q = crossv(tvec, e1)
    v = dotv(d, q) * inv
    t = dotv(e2, q) * inv
    valid = ((torch.abs(det) > _TRI_DET_EPS) & (u >= 0) & (v >= 0)
             & (u + v <= 1) & (t > 0))
    return t, valid


_SHAPE_T = {PLANE: _plane_t, SPHERE: _sphere_t}


def intersect_scene(scene: Scene, o: V3, d: V3, emit_sentinel: int) -> Hit:
    """Nearest hit over all shapes. o, d: V3 of f[N].

    emit_sentinel: the zero row of the padded emission table (= number
    of emission params L), given to missed rays.
    """
    dtype = o.x.dtype
    geo_all = scene.shape_geo.to(dtype)
    n_rays = d.x.shape[0]
    best_t = torch.full((n_rays,), float("inf"), dtype=dtype,
                        device=d.x.device)
    best_i = torch.zeros(n_rays, dtype=torch.int64, device=d.x.device)
    for i, stype in enumerate(scene.shape_type.tolist()):
        t, valid = _SHAPE_T.get(stype, _triangle_t)(geo_all[i], o, d)
        # NaN t compares False, as the C++ comparisons do; strict < keeps
        # the first of tied shapes.
        closer = valid & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, i, best_i)

    hit_valid = torch.isfinite(best_t)

    def gcol(j):
        return geo_all[:, j][best_i]

    g0 = V3(gcol(0), gcol(1), gcol(2))
    hit_type = scene.shape_type[best_i]
    point = o + d * best_t
    n_sphere = normalizev(point - g0)
    tri_e1 = V3(gcol(3), gcol(4), gcol(5)) - g0
    tri_e2 = V3(gcol(6), gcol(7), gcol(8)) - g0
    n_tri = normalizev(crossv(tri_e1, tri_e2))
    normal = wherev(hit_type == PLANE, g0,
                    wherev(hit_type == SPHERE, n_sphere, n_tri))

    null_mat = scene.mat_type.shape[0] - 1
    mat = torch.where(hit_valid, scene.shape_mat[best_i], null_mat)
    emit = torch.where(hit_valid, scene.shape_emit[best_i], emit_sentinel)
    return Hit(t=best_t, point=point, normal=normal, mat=mat, emit=emit,
               valid=hit_valid, shape=best_i)
