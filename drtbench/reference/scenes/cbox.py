"""The reference's sample scene (src/render.cpp:26-65): three albedo rows
and one emission row, nine shapes in scene-list order, the unused
specular_white material and the right wall's raw normal (1, 0, 0.1)."""

from drtbench.reference.scene import (DIFFUSE, PLANE, SPECULAR, SPHERE,
                                      Builder)


def build():
    b = Builder()
    red = b.albedo_param([0.5, 0.0, 0.0])
    green = b.albedo_param([0.0, 0.5, 0.0])
    white = b.albedo_param([0.5, 0.5, 0.5])
    light = b.emission_param([1.0, 1.0, 1.0])
    d_red = b.material(DIFFUSE, red)
    d_green = b.material(DIFFUSE, green)
    d_white = b.material(DIFFUSE, white)
    b.material(SPECULAR, white, 30.0)  # specular_white: defined, unused
    b.shape(SPHERE, [0.0, 0.0, 3.0, 1.0], d_white)
    b.shape(SPHERE, [-1.0, 1.0, 4.5, 1.0], d_white)
    b.shape(PLANE, [-1.0, 0.0, 0.0, -3.0], d_red)
    b.shape(PLANE, [1.0, 0.0, 0.1, -3.0], d_green)
    b.shape(PLANE, [0.0, 0.0, -1.0, -6.0], d_white)
    b.shape(PLANE, [0.0, 0.0, 1.0, 0.0], d_white)
    b.shape(PLANE, [0.0, 1.0, 0.0, -3.0], d_white)
    b.shape(PLANE, [0.0, -1.0, 0.0, -3.0], d_white)
    b.shape(SPHERE, [0.0, 3.0, 3.0, 1.0], None, light)
    return b.scene(eye=(0.0, 0.0, 0.0), at=(0.0, 0.0, 1.0))
