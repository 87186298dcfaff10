"""Scene description of the reference: shapes, materials, parameter rows
and camera as numpy arrays, built with the reference's construction calls
(src/render.cpp:26-65), and the scene builders found by name under
`scenes/`."""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np

PLANE, SPHERE, TRIANGLE = 0, 1, 2
DIFFUSE, SPECULAR, MIRROR, NULL_BXDF = 0, 1, 2, 3
SCENES_DIR = Path(__file__).resolve().parent / "scenes"


@dataclasses.dataclass
class SceneData:
    """Shapes in scene-list order (nearest-hit ties keep the first),
    materials with a NULL row appended, the albedo and emission rows,
    and the look-at camera."""

    shape_type: np.ndarray  # i64[S]
    shape_geo: np.ndarray  # f64[S, 12]: plane n, d; sphere c, r; v0 v1 v2
    shape_mat: np.ndarray  # i64[S], the NULL row where a shape has no BxDF
    shape_emit: np.ndarray  # i64[S], row L (zero) where it emits nothing
    mat_type: np.ndarray  # i64[M + 1]
    mat_albedo: np.ndarray  # i64[M + 1], row K (ones) where colourless
    mat_exponent: np.ndarray  # f64[M + 1]
    albedo: np.ndarray  # f64[K, 3]
    emission: np.ndarray  # f64[L, 3]
    eye: tuple
    at: tuple
    up: tuple = (0.0, 1.0, 0.0)
    vfov: float = 1.3963


class Builder:
    """The reference's scene calls: parameter rows, materials, shapes."""

    def __init__(self):
        self.albedo, self.emission = [], []
        self.mats = []  # (type, albedo row or -1, exponent)
        self.shapes = []  # (type, geo[12], material or -1, emission or -1)

    def albedo_param(self, rgb):
        self.albedo.append([float(v) for v in rgb])
        return len(self.albedo) - 1

    def emission_param(self, rgb):
        self.emission.append([float(v) for v in rgb])
        return len(self.emission) - 1

    def material(self, mtype, albedo_row=-1, exponent=0.0):
        self.mats.append((mtype, albedo_row, float(exponent)))
        return len(self.mats) - 1

    def shape(self, stype, values, mat=None, emit=None):
        geo = np.zeros(12)
        geo[:len(values)] = np.asarray(values, np.float64)
        self.shapes.append((stype, geo, -1 if mat is None else mat,
                            -1 if emit is None else emit))

    def scene(self, eye, at) -> SceneData:
        n_mat, n_alb = len(self.mats), len(self.albedo)
        n_emi = len(self.emission)
        return SceneData(
            shape_type=np.array([s[0] for s in self.shapes], np.int64),
            shape_geo=np.stack([s[1] for s in self.shapes]),
            shape_mat=np.array([n_mat if s[2] < 0 else s[2]
                                for s in self.shapes], np.int64),
            shape_emit=np.array([n_emi if s[3] < 0 else s[3]
                                 for s in self.shapes], np.int64),
            mat_type=np.array([m[0] for m in self.mats] + [NULL_BXDF],
                              np.int64),
            mat_albedo=np.array([n_alb if m[1] < 0 else m[1]
                                 for m in self.mats] + [n_alb], np.int64),
            mat_exponent=np.array([m[2] for m in self.mats] + [0.0]),
            albedo=np.array(self.albedo, np.float64).reshape(n_alb, 3),
            emission=np.array(self.emission, np.float64).reshape(n_emi, 3),
            eye=tuple(eye), at=tuple(at))


def build(name: str, **kwargs) -> SceneData:
    """The scene of `scenes/<name>.py` (its `build(**kwargs)`)."""
    path = SCENES_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference scene {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"drtbench_scene_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(**kwargs)
