"""The yardstick's work count for small scenes, against counts by hand."""

import torch

from drtbench import work
from drtbench.reference.scene import DIFFUSE, PLANE, TRIANGLE, Builder
from drtbench.reference.tracer import RefScene, trace_paths

CFG = {"width": 2, "height": 2, "spp": 1, "max_depth": 2, "min_bounces": 1,
       "absorb_prob": 0.5}


def _count(scene):
    rs = RefScene(scene, 2, 2, "cpu")
    counts = {}
    pix = torch.arange(4)
    trace_paths(rs, CFG, [7, 11], pix, pix, torch.zeros(4, dtype=torch.int64),
                counts)
    return counts


def test_plane_facing_camera():
    """Every primary ray hits the wall ahead and is live; the bounce off it
    leaves toward the camera, where nothing is, so it misses: 4 rays, 4
    live bounce-rays, 4 plane tests, and all 4 paths end before bounce 2.
    Operations 4 * 70 + 4 * 170 + 4 * 13 = 1012."""
    b = Builder()
    white = b.material(DIFFUSE, b.albedo_param([0.5, 0.5, 0.5]))
    b.shape(PLANE, [0.0, 0.0, -1.0, -5.0], white, b.emission_param([1, 1, 1]))
    c = _count(b.scene(eye=(0, 0, 0), at=(0, 0, 1)))
    assert c == {"rays": 4, "live": 4, "plane": 4, "sphere": 0, "ended": 4}
    assert work.trace_ops(c) == 1012
    assert work.row_bytes(c) == 4 * (2 * 4 + 4)
    launches = work.kernels("render", c, shapes=1, rows=4, slots=4, pixels=4)
    assert launches == [("tracer", 128 + 48 + 48, 1012)]
    bound, by = work.bound_seconds(launches)
    assert by == "bytes" and bound == 224 / 3.35e12


def test_triangle_counts_its_ball():
    """One large triangle ahead of the camera covers all four rays: each
    live bounce-ray needs one box test (the group's ball) and one triangle
    test (its own ball); the plane behind it is tested but never hit."""
    b = Builder()
    white = b.material(DIFFUSE, b.albedo_param([0.5, 0.5, 0.5]))
    b.shape(TRIANGLE, [-50.0, -50.0, 5.0, 0.0, 60.0, 5.0, 50.0, -50.0, 5.0],
            white)
    b.shape(PLANE, [0.0, 0.0, -1.0, -9.0], white)
    c = _count(b.scene(eye=(0, 0, 0), at=(0, 0, 1)))
    assert (c["rays"], c["live"], c["box"], c["tri"], c["plane"]) == \
        (4, 4, 4, 4, 4)
    ops = 4 * 70 + 4 * 170 + 4 * 13 + 4 * 50 + 4 * 28
    assert work.trace_ops(c) == ops
    launches = work.kernels("train", dict(c, renders=1), shapes=2, rows=4,
                            slots=4, pixels=4)
    assert [n for n, _, _ in launches] == ["collect", "sweep"]
    assert launches[1][2] == 4 * work.OPS_SWEEP
