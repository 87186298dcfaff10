"""Demo scenes that exercise the specular and mirror BRDFs
(bxdf.hpp:85-144) and triangles, which the Cornell box never touches.
Each but `build_rows` is `drt_tpu.models.gallery`'s scene of the same
name. The triangle mesh scene (`build_mesh`) is the geometry class of the
memory-resident kernels (`ops.dynkernel`); `build_rows` fills the
scene-table kernels' albedo and emission tables for the tests of their
gradient accumulators.
"""

from __future__ import annotations

import numpy as np
import torch

from drt_tpu_torch.camera import Camera, look_at
from drt_tpu_torch.scene import DEFAULT_DEVICE, Params, Scene, SceneBuilder


def build_glossy(dtype=torch.float32,
                 device=DEFAULT_DEVICE) -> tuple[Scene, Params, Camera]:
    """Cornell-style box with a glossy (specular) sphere and a mirror
    sphere."""
    b = SceneBuilder()
    red = b.albedo_param([0.5, 0.1, 0.1])
    green = b.albedo_param([0.1, 0.5, 0.1])
    white = b.albedo_param([0.5, 0.5, 0.5])
    gloss = b.albedo_param([0.4, 0.4, 0.45])
    emission = b.emission_param([1.5, 1.5, 1.5])

    b.sphere([-1.2, -1.0, 3.5], 1.0, b.specular(gloss, 30.0))
    b.sphere([1.2, -1.0, 4.0], 1.0, b.mirror())
    b.plane([-1.0, 0.0, 0.0], -3.0, b.diffuse(red))
    b.plane([1.0, 0.0, 0.0], -3.0, b.diffuse(green))
    b.plane([0.0, 0.0, -1.0], -6.0, b.diffuse(white))
    b.plane([0.0, 0.0, 1.0], 0.0, b.diffuse(white))
    b.plane([0.0, 1.0, 0.0], -3.0, b.diffuse(white))
    b.plane([0.0, -1.0, 0.0], -3.0, b.diffuse(white))
    b.sphere([0.0, 3.0, 3.0], 1.0, None, emission)

    scene, params = b.build(dtype, device)
    cam = look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], dtype=dtype,
                  device=device)
    return scene, params, cam


def build_mesh(level: int = 1, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> tuple[Scene, Params, Camera]:
    """Triangle-mesh scene: a subdivided icosphere (20 * 4^level
    triangles: 80, 320, 1280 at levels 1, 2, 3) in a Cornell-style box
    under an area light, 87 / 327 / 1287 shapes in all. All mesh faces
    share one diffuse material; the box walls give the usual red and
    green gradient signal. The vertices are computed in float64 with
    numpy, operation for operation as the JAX package does."""
    # Icosahedron.
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
        [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
        [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    vlist = [tuple(v) for v in verts]

    def midpoint(a, b):
        m = (np.asarray(a) + np.asarray(b)) / 2.0
        m /= np.linalg.norm(m)
        return tuple(m)

    for _ in range(level):
        new_faces = []
        for (a, b, c) in faces:
            va, vb, vc = vlist[a], vlist[b], vlist[c]
            ab, bc, ca = midpoint(va, vb), midpoint(vb, vc), \
                midpoint(vc, va)
            for v in (ab, bc, ca):
                vlist.append(v)
            i_ab, i_bc, i_ca = len(vlist) - 3, len(vlist) - 2, \
                len(vlist) - 1
            new_faces += [(a, i_ab, i_ca), (b, i_bc, i_ab),
                          (c, i_ca, i_bc), (i_ab, i_bc, i_ca)]
        faces = new_faces

    b = SceneBuilder()
    red = b.albedo_param([0.5, 0.1, 0.1])
    green = b.albedo_param([0.1, 0.5, 0.1])
    white = b.albedo_param([0.5, 0.5, 0.5])
    blue = b.albedo_param([0.25, 0.3, 0.55])
    emission = b.emission_param([2.0, 2.0, 2.0])
    mesh_mat = b.diffuse(blue)

    center = np.array([0.0, -0.6, 3.8])
    radius = 1.2
    for (i, j, k) in faces:
        v0 = center + radius * np.asarray(vlist[i])
        v1 = center + radius * np.asarray(vlist[j])
        v2 = center + radius * np.asarray(vlist[k])
        b.triangle(v0, v1, v2, mesh_mat)

    b.plane([-1.0, 0.0, 0.0], -3.0, b.diffuse(red))
    b.plane([1.0, 0.0, 0.0], -3.0, b.diffuse(green))
    b.plane([0.0, 0.0, -1.0], -6.5, b.diffuse(white))
    b.plane([0.0, 0.0, 1.0], 0.0, b.diffuse(white))
    b.plane([0.0, 1.0, 0.0], -3.0, b.diffuse(white))
    b.plane([0.0, -1.0, 0.0], -3.0, b.diffuse(white))
    b.sphere([0.0, 2.9, 3.8], 0.8, None, emission)

    scene, params = b.build(dtype, device)
    cam = look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], dtype=dtype,
                  device=device)
    return scene, params, cam


def build_tri(dtype=torch.float32,
              device=DEFAULT_DEVICE) -> tuple[Scene, Params, Camera]:
    """A tetrahedron over a ground plane under an area light."""
    b = SceneBuilder()
    white = b.albedo_param([0.5, 0.5, 0.5])
    blue = b.albedo_param([0.2, 0.3, 0.6])
    emission = b.emission_param([2.0, 2.0, 2.0])
    diffuse_white = b.diffuse(white)
    diffuse_blue = b.diffuse(blue)

    v = [(-1.0, -1.0, 3.0), (1.0, -1.0, 3.0), (0.0, -1.0, 4.5),
         (0.0, 0.8, 3.5)]
    # Outward winding: BxDF frames are built about the raw geometric
    # normal, so inward normals would trap bounced rays in the solid.
    for tri in ((0, 3, 1), (1, 3, 2), (2, 3, 0), (0, 1, 2)):
        b.triangle(v[tri[0]], v[tri[1]], v[tri[2]], diffuse_blue)
    b.plane([0.0, 1.0, 0.0], -1.0, diffuse_white)
    b.sphere([0.0, 3.5, 3.5], 1.0, None, emission)

    scene, params = b.build(dtype, device)
    cam = look_at([0.0, 0.5, 0.0], [0.0, 0.0, 1.0], dtype=dtype,
                  device=device)
    return scene, params, cam


def build_rows(dtype=torch.float32,
               device=DEFAULT_DEVICE) -> tuple[Scene, Params, Camera]:
    """A Cornell-style box holding a 6 x 6 grid of small spheres, each with
    an albedo row of its own and every other one an emission row of its
    own: 43 shapes, 42 albedo and 19 emission rows (61 real rows of the
    63 the scene-table kernels hold), colours drawn from a fixed seed."""
    rng = np.random.default_rng(61)
    b = SceneBuilder()
    walls = [b.diffuse(b.albedo_param(rng.uniform(0.2, 0.8, 3)))
             for _ in range(6)]
    b.plane([-1.0, 0.0, 0.0], -3.0, walls[0])
    b.plane([1.0, 0.0, 0.0], -3.0, walls[1])
    b.plane([0.0, 0.0, -1.0], -6.0, walls[2])
    b.plane([0.0, 0.0, 1.0], 0.0, walls[3])
    b.plane([0.0, 1.0, 0.0], -3.0, walls[4])
    b.plane([0.0, -1.0, 0.0], -3.0, walls[5])
    b.sphere([0.0, 3.0, 3.0], 1.0, None, b.emission_param([1.5, 1.5, 1.5]))
    for k in range(36):
        x, y = -2.0 + 0.8 * (k % 6), -2.0 + 0.8 * (k // 6)
        mat = b.diffuse(b.albedo_param(rng.uniform(0.1, 0.9, 3)))
        emit = (b.emission_param(rng.uniform(0.0, 0.5, 3)) if k % 2 == 0
                else None)
        b.sphere([x, y, 4.0 + 0.5 * (k % 3)], 0.3, mat, emit)

    scene, params = b.build(dtype, device)
    cam = look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], dtype=dtype,
                  device=device)
    return scene, params, cam
