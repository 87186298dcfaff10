"""Demo scenes that exercise the specular and mirror BRDFs
(bxdf.hpp:85-144) and triangles, which the Cornell box never touches.
Each is `drt_tpu.models.gallery`'s scene of the same name; the triangle
mesh scene (`build_mesh`) belongs to the memory-resident kernels and
waits for them.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.camera import Camera, look_at
from drt_tpu_torch.scene import Params, Scene, SceneBuilder


def build_glossy(dtype=torch.float32,
                 device=None) -> tuple[Scene, Params, Camera]:
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


def build_tri(dtype=torch.float32,
              device=None) -> tuple[Scene, Params, Camera]:
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
