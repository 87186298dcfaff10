"""A subdivided icosphere (20 * 4**level triangles) of one diffuse
material in a Cornell-style box under a spherical light: at level 3, 1280
triangles and 1287 shapes. Vertices in float64, each level splitting
every face into four at its edges' midpoints pushed to the unit sphere,
children in order (a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)."""

import numpy as np

from drtbench.reference.scene import DIFFUSE, PLANE, SPHERE, TRIANGLE, Builder

FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


def _icosphere(level):
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                      [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                      [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    vs = [tuple(v) for v in verts]
    faces = list(FACES)

    def mid(a, b):
        m = (np.asarray(a) + np.asarray(b)) / 2.0
        return tuple(m / np.linalg.norm(m))

    for _ in range(level):
        out = []
        for a, b, c in faces:
            vs += [mid(vs[a], vs[b]), mid(vs[b], vs[c]), mid(vs[c], vs[a])]
            ab, bc, ca = len(vs) - 3, len(vs) - 2, len(vs) - 1
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = out
    return vs, faces


def build(level=3):
    vs, faces = _icosphere(level)
    b = Builder()
    red = b.albedo_param([0.5, 0.1, 0.1])
    green = b.albedo_param([0.1, 0.5, 0.1])
    white = b.albedo_param([0.5, 0.5, 0.5])
    blue = b.albedo_param([0.25, 0.3, 0.55])
    light = b.emission_param([2.0, 2.0, 2.0])
    mesh = b.material(DIFFUSE, blue)
    center, radius = np.array([0.0, -0.6, 3.8]), 1.2
    for f in faces:
        b.shape(TRIANGLE, np.concatenate(
            [center + radius * np.asarray(vs[i]) for i in f]), mesh)
    b.shape(PLANE, [-1.0, 0.0, 0.0, -3.0], b.material(DIFFUSE, red))
    b.shape(PLANE, [1.0, 0.0, 0.0, -3.0], b.material(DIFFUSE, green))
    b.shape(PLANE, [0.0, 0.0, -1.0, -6.5], b.material(DIFFUSE, white))
    b.shape(PLANE, [0.0, 0.0, 1.0, 0.0], b.material(DIFFUSE, white))
    b.shape(PLANE, [0.0, 1.0, 0.0, -3.0], b.material(DIFFUSE, white))
    b.shape(PLANE, [0.0, -1.0, 0.0, -3.0], b.material(DIFFUSE, white))
    b.shape(SPHERE, [0.0, 2.9, 3.8, 0.8], None, light)
    return b.scene(eye=(0.0, 0.0, 0.0), at=(0.0, 0.0, 1.0))
