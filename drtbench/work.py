"""The least time the card could take for the work of an image or an
optimizer step: the yardstick of the kernel rooflines.

A frozen copy of the arithmetic `chip_smoke.py` used for its bounds (its
`PEAK_*` and `OPS_*`, counted from the kernels' sources at the time), fed
with counts that the benchmark's reference makes on the same inputs: the
rays, the live bounce-rays (those that reach a surface), the shape tests
they need by kind, and the paths that end before the last bounce. No
count comes from the program, so a change to the program cannot move its
own yardstick, and the count reads the same whichever kernel does the
work.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over the memory rate and its operations over
the float32 rate; a unit's bound is the sum over the kernel launches it
needs, which run one after another.
"""

from __future__ import annotations

# The card's published peaks (H100 SXM data sheet, 700 W): device memory
# rate, and the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per primary ray (camera and its 2 hash draws), per test of a
# shape kind in the nearest-hit loop, per live bounce of shading (frame,
# sample, weight, 3 hash draws), per live bounce of the replay and reverse
# sweep, per slab test of a box.
OPS_CAMERA = 70
OPS_PLANE, OPS_SPHERE, OPS_TRIANGLE = 13, 27, 50
OPS_SHADE = 170
OPS_SWEEP = 20
OPS_BOX = 28
# One shape record of a scene read once (32 floats), one table row (3).
SHAPE_RECORD_BYTES = 4 * 32
ROW_BYTES = 4 * 3


def trace_ops(c: dict) -> int:
    """Operations of tracing the counted rays: camera, shading and every
    shape test a live bounce-ray needs."""
    return (c["rays"] * OPS_CAMERA + c["live"] * OPS_SHADE
            + c["plane"] * OPS_PLANE + c["sphere"] * OPS_SPHERE
            + c.get("tri", 0) * OPS_TRIANGLE + c.get("box", 0) * OPS_BOX)


def row_bytes(c: dict) -> int:
    """The residual rows a sweep needs: (sc, row) of every live bounce-ray
    and the dead row that ends each path before the last bounce."""
    return 4 * (2 * c["live"] + c["ended"])


def kernels(kind: str, c: dict, *, shapes: int, rows: int, slots: int,
            pixels: int) -> list:
    """The launches of one unit as (name, bytes, operations). kind
    "render": the tracer. kind "train": per render of the step (`c`
    counts both) the collect tracer, which writes the rows, and the sweep,
    which reads them with the image's cotangent and writes the gradient
    tables. `slots` is the radiance slots of a launch (W*H*spp/chunks),
    `rows` the table rows, `pixels` W*H."""
    tables = rows * ROW_BYTES
    scene = shapes * SHAPE_RECORD_BYTES
    if kind == "render":
        return [("tracer", scene + tables + 12 * slots, trace_ops(c))]
    renders = c["renders"]
    return [("collect", renders * (scene + tables + 12 * slots)
             + row_bytes(c), trace_ops(c)),
            ("sweep", renders * (2 * tables + 12 * pixels) + row_bytes(c),
             c["live"] * OPS_SWEEP)]


def bound_seconds(launches: list) -> tuple[float, str]:
    """The sum of the launches' bounds, and what bounds most of it:
    "operations" or "bytes"."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for _, n_bytes, n_ops in launches:
        tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S
        key = "bytes" if tb >= to else "operations"
        by[key] += max(tb, to)
        total += max(tb, to)
    return total, max(by, key=by.get)
