"""Scalarized SoA 3-vectors over torch tensors (reference:
include/drt/vector.hpp:573-606).

A `V3` holds three same-shaped tensors (usually f[N]), the layout of
`drt_tpu.ops.vecmath.V3`, so each op here is written in the same
operand order as its JAX counterpart and gives the same rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    """SoA 3-vector: three same-shaped tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """f[..., 3] -> V3 of f[...]."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        """V3 of f[...] -> f[..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def dotv(a: V3, b: V3) -> torch.Tensor:
    """reference: vector.hpp:573-578."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def normv(a: V3) -> torch.Tensor:
    return torch.sqrt(dotv(a, a))


def normalizev(a: V3) -> V3:
    return a * (1.0 / normv(a))


def crossv(a: V3, b: V3) -> V3:
    """reference: vector.hpp:592-600."""
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def reflectv(v: V3, n: V3) -> V3:
    """-v + 2 dot(n, v) n (reference: vector.hpp:602-606)."""
    return -v + 2.0 * dotv(n, v) * n


def wherev(mask: torch.Tensor, a: V3, b) -> V3:
    """Componentwise select; `b` is a V3 or a scalar."""
    if isinstance(b, V3):
        return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                  torch.where(mask, a.z, b.z))
    return V3(torch.where(mask, a.x, b), torch.where(mask, a.y, b),
              torch.where(mask, a.z, b))


def gatherv(table: torch.Tensor, idx: torch.Tensor) -> V3:
    """Rows of a small f[R, 3] table as a V3 of f[N]."""
    return V3(table[:, 0][idx], table[:, 1][idx], table[:, 2][idx])
