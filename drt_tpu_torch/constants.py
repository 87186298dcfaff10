"""Math constants (reference: include/drt/constants.hpp:9-11)."""

import math

PI = math.pi

# Self-intersection offset applied along the scattered direction
# (reference: include/drt/pathtracer.hpp:99 `hit.point + 1e-3*dir_out`).
RAY_EPS = 1e-3
