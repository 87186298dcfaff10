"""Scene-of-arrays (SoA) representation and builder, on torch tensors.

Mirrors `drt_tpu.scene` field for field: virtual dispatch of the
reference (pathtracer.hpp:12-13, shape.hpp:11-35, bxdf.hpp:12-25) becomes
flat arrays of shape/material codes. Only `Params` is differentiable.

Sentinel conventions (so gathers never need branches):
  - a shape with no BxDF points at material row M (type NULL -> f = 0,
    sample dir = 0, pdf = 1), as the reference's null-BxDF fallback
    (pathtracer.hpp:17-35);
  - a shape with no emitter points at emission row L of the zero-padded
    emission table (pathtracer.hpp:41-49);
  - materials without a color parameter (mirror) point at albedo row K of
    the ones-padded albedo table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Shape type codes
PLANE = 0
SPHERE = 1
TRIANGLE = 2

# Material type codes
DIFFUSE = 0
SPECULAR = 1
MIRROR = 2
NULL_BXDF = 3

GEO_WIDTH = 12  # plane: n(3)+offset; sphere: c(3)+r; triangle: v0,v1,v2

# Where the constructors put a scene, its params and its camera unless the
# caller names a device: the card, as every entry point of the port.
DEFAULT_DEVICE = "cuda"


def checked_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device where none is visible
    raises, naming the way to the CPU, rather than falling back to it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the scene constructors put the "
            "scene on the card; pass device='cpu' for the plain PyTorch "
            "version on the CPU")
    return device


class Params(NamedTuple):
    """Differentiable shading parameters (reference: the `VariableNode`
    leaves red/green/white/emission at src/render.cpp:26-29)."""

    albedo: torch.Tensor  # f[K, 3]
    emission: torch.Tensor  # f[L, 3]


class Scene(NamedTuple):
    """Static (non-differentiable) scene arrays."""

    shape_type: torch.Tensor  # i32[S]
    shape_geo: torch.Tensor  # f[S, GEO_WIDTH]
    shape_mat: torch.Tensor  # i32[S] in [0, M]; M = null sentinel
    shape_emit: torch.Tensor  # i32[S] in [0, L]; L = zero sentinel
    mat_type: torch.Tensor  # i32[M+1] (sentinel NULL row appended)
    mat_albedo: torch.Tensor  # i32[M+1] index into padded albedo table
    mat_exponent: torch.Tensor  # f[M+1]

    @property
    def num_shapes(self) -> int:
        return self.shape_type.shape[0]

    @property
    def device(self) -> torch.device:
        return self.shape_geo.device


def albedo_table(scene: Scene, params: Params) -> torch.Tensor:
    """Padded albedo table: K param rows + a ones row (mirror / colorless)."""
    a = params.albedo
    return torch.cat([a, torch.ones((1, 3), dtype=a.dtype, device=a.device)])


def emission_table(scene: Scene, params: Params) -> torch.Tensor:
    """Padded emission table: L param rows + a zeros row (no emitter)."""
    e = params.emission
    return torch.cat([e, torch.zeros((1, 3), dtype=e.dtype, device=e.device)])


class SceneBuilder:
    """Imperative builder in the reference's scene-construction style
    (src/render.cpp:26-59), producing SoA arrays."""

    def __init__(self) -> None:
        self._albedo: list[list[float]] = []
        self._emission: list[list[float]] = []
        self._mat_type: list[int] = []
        self._mat_albedo: list[int] = []
        self._mat_exponent: list[float] = []
        self._shape_type: list[int] = []
        self._shape_geo: list[np.ndarray] = []
        self._shape_mat: list[int] = []
        self._shape_emit: list[int] = []

    def albedo_param(self, rgb) -> int:
        self._albedo.append([float(v) for v in rgb])
        return len(self._albedo) - 1

    def emission_param(self, rgb) -> int:
        self._emission.append([float(v) for v in rgb])
        return len(self._emission) - 1

    def diffuse(self, albedo_id: int) -> int:
        """Lambertian BRDF `albedo/pi` (reference: bxdf.hpp:56-83)."""
        return self._add_material(DIFFUSE, albedo_id, 0.0)

    def specular(self, albedo_id: int, exponent: float) -> int:
        """Blinn-Phong-like glossy BRDF (reference: bxdf.hpp:85-124)."""
        return self._add_material(SPECULAR, albedo_id, float(exponent))

    def mirror(self) -> int:
        """Delta reflection (reference: bxdf.hpp:126-144); colorless, so
        the albedo gather resolves to the padded ones row."""
        return self._add_material(MIRROR, -1, 0.0)

    def _add_material(self, mtype: int, albedo_id: int,
                      exponent: float) -> int:
        self._mat_type.append(mtype)
        self._mat_albedo.append(albedo_id)
        self._mat_exponent.append(exponent)
        return len(self._mat_type) - 1

    def plane(self, normal, offset: float, bxdf: int | None = None,
              emitter: int | None = None) -> int:
        """Half-space `dot(p, n) = offset` (reference: shape.hpp:37-64);
        the normal is stored as given, never normalized
        (src/render.cpp:42 has n=(1,0,0.1))."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(normal, dtype=np.float64)
        geo[3] = float(offset)
        return self._add_shape(PLANE, geo, bxdf, emitter)

    def sphere(self, center, radius: float, bxdf: int | None = None,
               emitter: int | None = None) -> int:
        """Sphere (reference: shape.hpp:66-111)."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(center, dtype=np.float64)
        geo[3] = float(radius)
        return self._add_shape(SPHERE, geo, bxdf, emitter)

    def triangle(self, v0, v1, v2, bxdf: int | None = None,
                 emitter: int | None = None) -> int:
        """Triangle (Moller-Trumbore; no reference analogue)."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(v0, dtype=np.float64)
        geo[3:6] = np.asarray(v1, dtype=np.float64)
        geo[6:9] = np.asarray(v2, dtype=np.float64)
        return self._add_shape(TRIANGLE, geo, bxdf, emitter)

    def _add_shape(self, stype: int, geo: np.ndarray, bxdf: int | None,
                   emitter: int | None) -> int:
        self._shape_type.append(stype)
        self._shape_geo.append(geo)
        self._shape_mat.append(-1 if bxdf is None else bxdf)
        self._shape_emit.append(-1 if emitter is None else emitter)
        return len(self._shape_type) - 1

    def build(self, dtype=torch.float32,
              device=DEFAULT_DEVICE) -> tuple[Scene, Params]:
        device = checked_device(device)
        n_mat = len(self._mat_type)
        n_alb = len(self._albedo)
        n_emit = len(self._emission)
        mat_type = self._mat_type + [NULL_BXDF]
        mat_albedo = ([a if a >= 0 else n_alb for a in self._mat_albedo]
                      + [n_alb])
        mat_exponent = self._mat_exponent + [0.0]
        shape_mat = [m if m >= 0 else n_mat for m in self._shape_mat]
        shape_emit = [e if e >= 0 else n_emit for e in self._shape_emit]

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        def flt(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                   device=device)

        scene = Scene(
            shape_type=i32(self._shape_type),
            shape_geo=flt(np.stack(self._shape_geo)),
            shape_mat=i32(shape_mat),
            shape_emit=i32(shape_emit),
            mat_type=i32(mat_type),
            mat_albedo=i32(mat_albedo),
            mat_exponent=flt(mat_exponent),
        )
        params = Params(
            albedo=flt(np.asarray(self._albedo).reshape(n_alb, 3)),
            emission=flt(np.asarray(self._emission).reshape(n_emit, 3)),
        )
        return scene, params


def make_scene(shapes_spec, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> tuple[Scene, Params]:
    """Build a scene from a declarative list of dicts: {"kind":
    "plane"|"sphere"|"triangle", geometry kwargs, optional
    "diffuse"/"specular"/"mirror" material, optional "emission" rgb}."""
    b = SceneBuilder()
    for spec in shapes_spec:
        mat = None
        if "diffuse" in spec:
            mat = b.diffuse(b.albedo_param(spec["diffuse"]))
        elif "specular" in spec:
            rgb, exp = spec["specular"]
            mat = b.specular(b.albedo_param(rgb), exp)
        elif spec.get("mirror"):
            mat = b.mirror()
        emit = None
        if "emission" in spec:
            emit = b.emission_param(spec["emission"])
        kind = spec["kind"]
        if kind == "plane":
            b.plane(spec["normal"], spec["offset"], mat, emit)
        elif kind == "sphere":
            b.sphere(spec["center"], spec["radius"], mat, emit)
        elif kind == "triangle":
            b.triangle(spec["v0"], spec["v1"], spec["v2"], mat, emit)
        else:
            raise ValueError(f"unknown shape kind: {kind}")
    return b.build(dtype, device)


def from_numpy(scene_arrays, params_arrays, camera_arrays,
               device=DEFAULT_DEVICE):
    """The JAX package's `Scene`, `Params` and `Camera` fields, given as
    numpy arrays in field order, as the port's (scene, params, camera) on
    `device`. Dtypes are kept, so an f64 scene stays f64."""
    from drt_tpu_torch.camera import Camera

    device = checked_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    scene = Scene(*(t(a) for a in scene_arrays))
    params = Params(*(t(a) for a in params_arrays))
    cam = Camera(*(t(a) for a in camera_arrays))
    return scene, params, cam
