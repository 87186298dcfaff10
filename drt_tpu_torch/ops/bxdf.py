"""Branch-free vectorized BxDF evaluation and sampling (scalarized SoA).

The port of `drt_tpu.ops.bxdf`: every ray computes each material's
scalar parts and selects by material code, in place of the reference's
virtual dispatch (bxdf.hpp:12-25, pathtracer.hpp:17-35). BRDF values
factor as `f = albedo_row * scale`.

Reference math kept, quirks included:
  - the frame Gram-Schmidts e1 or e2 against the raw (possibly
    unnormalized) hit normal and uses that normal as its z-axis
    (bxdf.hpp:29-41);
  - diffuse: eval = albedo/pi; theta = asin(sqrt(u1)), phi = 2 pi u2,
    pdf = cos(theta)/pi (bxdf.hpp:63-79);
  - specular: eval = (e+2)/(2 pi) cos^e(th_h) sin(th_h), with the extra
    sin factor; half-vector sampling with the below-horizon flip
    (bxdf.hpp:93-120);
  - mirror: eval = 1/cos(theta_out), delta reflection with pdf 1
    (bxdf.hpp:126-144);
  - null BxDF: f = 0, sample dir = 0, pdf = 1 (pathtracer.hpp:17-35).
"""

from __future__ import annotations

import torch

from drt_tpu_torch.constants import PI
from drt_tpu_torch.ops.vecmath import (V3, crossv, dotv, normalizev,
                                       reflectv, wherev)
from drt_tpu_torch.scene import DIFFUSE, MIRROR, SPECULAR


def make_frame(normal: V3):
    """Frame about the raw normal (bxdf.hpp:29-41) -> (tangent,
    bitangent, normal)."""
    use_e1 = torch.abs(normal.x) < torch.abs(normal.y)
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    e1 = V3(one, zero, zero)
    e2 = V3(zero, one, zero)
    tv = wherev(use_e1, e1 - normal * normal.x, e2 - normal * normal.y)
    tangent = normalizev(tv)
    bitangent = normalizev(crossv(normal, tangent))
    return tangent, bitangent, normal


def angle_to_dir(theta, phi, frame) -> V3:
    """Spherical angles in a frame -> direction (bxdf.hpp:43-52)."""
    tangent, bitangent, normal = frame
    st = torch.sin(theta)
    x = torch.cos(phi) * st
    y = torch.sin(phi) * st
    z = torch.cos(theta)
    return tangent * x + bitangent * y + normal * z


def _pow_cpp(base: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    """C++ `std::pow` for a possibly negative base: with an integral
    exponent (-x)^n = |x|^n (-1)^n, where torch.pow gives NaN; with a
    non-integral one, NaN (as in C++)."""
    mag = torch.pow(torch.abs(base), expo)
    is_int = expo == torch.round(expo)
    odd = torch.remainder(torch.round(expo), 2.0) == 1.0
    neg = base < 0
    sign = torch.where(neg & odd, -1.0, 1.0).to(mag.dtype)
    val = mag * sign
    return torch.where(neg & ~is_int, torch.nan, val)


def eval_scale(mat_type: torch.Tensor, exponent: torch.Tensor, normal: V3,
               dir_in: V3, dir_out: V3) -> torch.Tensor:
    """Scalar BRDF factor s with f = albedo_row * s. dir_in points away
    from the surface (the tracer passes -ray_dir, pathtracer.hpp:100)."""
    s_diff = torch.full_like(normal.x, 1.0 / PI)
    # Degenerate-halfway guard: dir_out == -dir_in makes the halfway
    # vector 0/0 (measure-zero in f64).
    hw = dir_in + dir_out
    hw2 = dotv(hw, hw)
    halfway = normalizev(hw)
    cos_h = dotv(normal, halfway)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    s_spec = ((exponent + 2.0) / (2.0 * PI) * _pow_cpp(cos_h, exponent)
              * sin_h)
    s_spec = torch.where(hw2 > 0, s_spec, 0.0)
    # Guarded: an exactly perpendicular reflection would give 1/0 = inf
    # and then inf * cos = NaN in the tracer.
    cos_out = dotv(normal, dir_out)
    s_mirr = torch.where(cos_out != 0, 1.0 / cos_out, 0.0)
    return torch.where(mat_type == DIFFUSE, s_diff,
                       torch.where(mat_type == SPECULAR, s_spec,
                                   torch.where(mat_type == MIRROR, s_mirr,
                                               0.0)))


def sample_bxdf(mat_type: torch.Tensor, exponent: torch.Tensor,
                normal: V3, dir_in: V3, u1: torch.Tensor, u2: torch.Tensor):
    """Sample an outgoing direction per ray -> (dir V3 of f[N], pdf f[N]).
    Null-material rays return (0, 1) as the reference's null fallback
    does (pathtracer.hpp:17-26)."""
    frame = make_frame(normal)
    th_d = torch.asin(torch.sqrt(u1))
    phi = 2.0 * PI * u2
    dir_d = angle_to_dir(th_d, phi, frame)
    pdf_d = torch.cos(th_d) / PI
    th_s = torch.acos(torch.sqrt(torch.pow(u1, 2.0 / (exponent + 2.0))))
    half = angle_to_dir(th_s, phi, frame)
    flip = dotv(half, dir_in) < 0
    half = wherev(flip, reflectv(half, normal), half)
    dir_s = reflectv(dir_in, half)
    pdf_s = ((exponent + 2.0) / (2.0 * PI)
             * torch.pow(torch.cos(th_s), exponent + 1.0) * torch.sin(th_s))
    dir_m = reflectv(dir_in, normal)
    pdf_m = torch.ones_like(u1)

    is_d = mat_type == DIFFUSE
    is_s = mat_type == SPECULAR
    is_m = mat_type == MIRROR
    d = wherev(is_d, dir_d, wherev(is_s, dir_s, wherev(is_m, dir_m, 0.0)))
    pdf = torch.where(is_d, pdf_d,
                      torch.where(is_s, pdf_s,
                                  torch.where(is_m, pdf_m, 1.0)))
    return d, pdf
