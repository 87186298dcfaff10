"""Pinhole camera (reference: include/drt/camera.hpp), on torch tensors.

Quirks kept from the reference, as `drt_tpu.camera` keeps them:
  - the image t-axis uses `-up`, so y=0 is the TOP row (camera.hpp:57);
  - `look_at` builds right = normalize(cross(forward, up))
    (camera.hpp:29-37), which for the sample app's look_at((0,0,0) ->
    (0,0,1)) gives right = (-1, 0, 0): the image is x-mirrored;
  - the pdf returned per ray is identically 1 (camera.hpp:59).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drt_tpu_torch.ops.vecmath import V3, normalizev
from drt_tpu_torch.scene import DEFAULT_DEVICE, checked_device


class Camera(NamedTuple):
    eye: torch.Tensor  # f[3]
    forward: torch.Tensor  # f[3]
    right: torch.Tensor  # f[3]
    up: torch.Tensor  # f[3]
    vfov: torch.Tensor  # f[] radians; reference default 1.3963


def _normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def default_camera(dtype=torch.float32, vfov: float = 1.3963,
                   device=DEFAULT_DEVICE) -> Camera:
    """Reference defaults (camera.hpp:15-19): eye at the origin, forward
    -z."""
    device = checked_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return Camera(eye=torch.zeros(3, dtype=dtype, device=device),
                  forward=t([0.0, 0.0, -1.0]), right=t([1.0, 0.0, 0.0]),
                  up=t([0.0, 1.0, 0.0]), vfov=t(vfov))


def look_at(eye, at, up=(0.0, 1.0, 0.0), vfov: float = 1.3963,
            dtype=torch.float32, device=DEFAULT_DEVICE) -> Camera:
    """Build a camera basis (reference: camera.hpp:29-37)."""
    device = checked_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    eye, at, up = t(eye), t(at), t(up)
    forward = _normalize(at - eye)
    right = _normalize(_cross(forward, up))
    cam_up = _cross(right, forward)
    return Camera(eye=eye, forward=forward, right=right, up=cam_up,
                  vfov=t(vfov))


def camera_rays(cam: Camera, width: int, height: int, xy: torch.Tensor,
                u: torch.Tensor):
    """Jittered primary rays (reference: camera.hpp:51-60).

    xy: i32[N, 2] pixel coordinates (x, y); u: f[N, 2] jitter (s-draw
    first, then t-draw, as camera.hpp:53-54 consumes them).
    Returns (orig V3 of f[N], dir V3 of f[N], pdf f[N]); the pdf is 1.
    """
    dtype = cam.forward.dtype
    n = xy.shape[0]
    x = xy[:, 0].to(dtype)
    y = xy[:, 1].to(dtype)
    s = (x + u[:, 0]) / width
    t = (y + u[:, 1]) / height
    aspect = float(width) / float(height)
    half = torch.tan(cam.vfov / 2.0)
    a = (2.0 * s - 1.0) * aspect * half  # right coefficient
    b = (2.0 * t - 1.0) * half  # (-up) coefficient
    fwd, right, up = (V3.from_array(cam.forward), V3.from_array(cam.right),
                      V3.from_array(cam.up))
    d = normalizev(fwd + right * a + (-up) * b)
    orig = V3(*(c.expand(n) for c in (cam.eye[0], cam.eye[1], cam.eye[2])))
    return orig, d, torch.ones(n, dtype=dtype, device=xy.device)


def pixel_grid(width: int, height: int, device=None) -> torch.Tensor:
    """i32[H*W, 2] pixel coordinates in raster order (y outer, x inner —
    src/render.cpp:72-73)."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)],
                       dim=-1).to(torch.int32)
