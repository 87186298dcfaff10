"""The reference sample scene: a Cornell-box-like arrangement.

Reproduces src/render.cpp:26-65 as `drt_tpu.models.cbox` does: the
parameters, the materials, the nine shapes in scene-list order (nearest-hit
ties keep the first shape), and the camera. Quirks kept: the right wall's
unnormalized normal (1, 0, 0.1) and the unused specular_white material.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.camera import Camera, look_at
from drt_tpu_torch.scene import DEFAULT_DEVICE, Params, Scene, SceneBuilder

# Albedo/emission parameter row indices (src/render.cpp:26-29).
RED, GREEN, WHITE = 0, 1, 2
EMISSION = 0


def build(dtype=torch.float32,
          device=DEFAULT_DEVICE) -> tuple[Scene, Params, Camera]:
    b = SceneBuilder()
    red = b.albedo_param([0.5, 0.0, 0.0])
    green = b.albedo_param([0.0, 0.5, 0.0])
    white = b.albedo_param([0.5, 0.5, 0.5])
    emission = b.emission_param([1.0, 1.0, 1.0])

    diffuse_red = b.diffuse(red)
    diffuse_green = b.diffuse(green)
    diffuse_white = b.diffuse(white)
    b.specular(white, 30.0)  # specular_white: defined but unused

    b.sphere([0.0, 0.0, 3.0], 1.0, diffuse_white)  # sphere_front
    b.sphere([-1.0, 1.0, 4.5], 1.0, diffuse_white)  # sphere_back
    b.plane([-1.0, 0.0, 0.0], -3.0, diffuse_red)  # left_plane
    b.plane([1.0, 0.0, 0.1], -3.0, diffuse_green)  # right_plane (raw normal)
    b.plane([0.0, 0.0, -1.0], -6.0, diffuse_white)  # back_plane
    b.plane([0.0, 0.0, 1.0], 0.0, diffuse_white)  # front_plane
    b.plane([0.0, 1.0, 0.0], -3.0, diffuse_white)  # ground_plane
    b.plane([0.0, -1.0, 0.0], -3.0, diffuse_white)  # ceiling_plane
    b.sphere([0.0, 3.0, 3.0], 1.0, None, emission)  # light (null BxDF)

    scene, params = b.build(dtype, device)
    cam = look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], dtype=dtype,
                  device=device)
    return scene, params, cam
