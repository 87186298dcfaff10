"""The reference path tracer: keyed draws, camera rays, nearest hit,
BxDF sampling and the bounce loop, in plain PyTorch.

Semantics (the reference renderer's, src/ and include/drt/):
  - ray i of a chunk covers pixel i % (W*H), sample c*spp_c + i // (W*H);
  - draws are the keyed hash of (seed, pixel, sample, bounce, dim), the
    open-interval uniform (i23 + 0.5) * 2^-23; the camera's two draws
    from seeds[0] at bounce 0, (rr, u1, u2) per bounce from seeds[1];
  - Russian roulette from min_bounces on, with the gate 1/(1 - absorb);
  - a ray dies when absorbed or on a miss, not when its throughput is 0;
  - the nearest hit is the least (t, shape index): ties keep the first;
  - rays leave a surface 1e-3 along their new direction;
  - L = sum_b P_b e_b, P_b = T_b gate_b, T_{b+1} = P_b (a_b sc_b).

The geometry pass (`trace_paths`) keeps, per bounce, the live rays and
what the tables multiply: albedo row, emission row, the scalar weight sc
= s cos / pdf and the gate. Images and gradients come from those
residuals (`radiance`), so the tables may be any tensors, with autograd.
Triangles are tested in groups of consecutive triangle shapes under a
bounding sphere, which changes which pairs are computed and not one
rounding of any test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from drtbench.reference.scene import (DIFFUSE, MIRROR, PLANE, SPECULAR,
                                      SPHERE, TRIANGLE, SceneData)

MASK32 = 0xFFFFFFFF
C1, C2 = 0x85EBCA6B, 0xC2B2AE35
GOLD, DIMSALT = 0x9E3779B9, 0x27D4EB2F
RAY_EPS = 1e-3
TRI_DET_EPS = 1e-9
PI = math.pi
TRI_GROUP = 64  # triangles under one bounding sphere
RAY_BLOCK = 1 << 24  # rays per block of the geometry pass
PAIR_BLOCK = 1 << 16  # (ray, triangle group) pairs tested at once


# --- the keyed hash: words carried in int64, cut to 32 bits each step ---

def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def sample_word(seed: int, pix, smp):
    """The word of draw (seed, pixel, sample) that every bounce and dim
    of that sample starts from."""
    key = _fmix((_mul32(pix, GOLD) + (int(seed) & MASK32)) & MASK32)
    return key ^ _mul32(smp, C1)


def uniform(word, b: int, dim: int):
    """Draw (bounce b, dim) of a sample word as an open-interval f32."""
    bits = _fmix(word ^ (_mul32(b, C2) ^ ((dim * DIMSALT) & MASK32)))
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


# --- small SoA vector algebra, operand order of the renderer's ---

class V3(NamedTuple):
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

    def take(self, i):
        return V3(self.x[i], self.y[i], self.z[i])


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def normalize(a):
    return a * (1.0 / torch.sqrt(dot(a, a)))


def cross(a, b):
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def reflect(v, n):
    return -v + 2.0 * dot(n, v) * n


def where3(mask, a, b):
    if isinstance(b, V3):
        return V3(*(torch.where(mask, p, q) for p, q in zip(a, b)))
    return V3(*(torch.where(mask, p, b) for p in a))


# --- the scene on the device ---

class Camera(NamedTuple):
    eye: tuple
    forward: tuple
    right: tuple
    up: tuple
    aspect_half: float
    half: float
    width: int
    height: int


def _camera(sd: SceneData, width: int, height: int) -> Camera:
    """The look-at basis in float32 (camera.hpp:29-37) and the folded
    half-extents: tan(vfov / 2) in float64, then rounded to float32."""
    f32 = np.float32
    eye, at, up = (np.array(v, f32) for v in (sd.eye, sd.at, sd.up))

    def norm(a):
        return a / np.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])

    def crs(a, b):
        return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                         a[0] * b[1] - a[1] * b[0]], f32)

    fwd = norm(at - eye)
    right = norm(crs(fwd, up))
    cam_up = crs(right, fwd)
    half = math.tan(float(f32(sd.vfov)) / 2.0)
    aspect = float(width) / float(height)
    return Camera(tuple(map(float, eye)), tuple(map(float, fwd)),
                  tuple(map(float, right)), tuple(map(float, cam_up)),
                  float(f32(aspect * half)), float(f32(half)), width, height)


class RefScene:
    """A `SceneData` on the device, float32, with the triangles grouped."""

    def __init__(self, sd: SceneData, width: int, height: int, device):
        self.device = torch.device(device)
        dev = self.device
        self.data = sd
        self.cam = _camera(sd, width, height)
        self.geo = torch.as_tensor(sd.shape_geo, dtype=torch.float32,
                                   device=dev)
        self.shape_type = torch.as_tensor(sd.shape_type, device=dev)
        self.shape_mat = torch.as_tensor(sd.shape_mat, device=dev)
        self.shape_emit = torch.as_tensor(sd.shape_emit, device=dev)
        self.mat_type = torch.as_tensor(sd.mat_type, device=dev)
        self.mat_albedo = torch.as_tensor(sd.mat_albedo, device=dev)
        self.mat_exponent = torch.as_tensor(sd.mat_exponent,
                                            dtype=torch.float32, device=dev)
        types = sd.shape_type.tolist()
        self.others = [(i, t) for i, t in enumerate(types) if t != TRIANGLE]
        self.n_plane = types.count(PLANE)
        self.n_sphere = types.count(SPHERE)
        tris = [i for i, t in enumerate(types) if t == TRIANGLE]
        self.groups = None
        if tris:
            self._group(tris)

    def _group(self, tris):
        """Groups of TRI_GROUP consecutive triangles: v0, e1 = v1 - v0 and
        e2 = v2 - v0 in float32 as each test computes them, padded with
        degenerate triangles (det 0: never a hit), and each group's
        bounding sphere (every triangle lies in the ball about its
        vertices' mean through the farthest vertex), widened."""
        dev = self.device
        n_grp = -(-len(tris) // TRI_GROUP)
        idx = np.full(n_grp * TRI_GROUP, -1, np.int64)
        idx[:len(tris)] = tris
        g = self.geo[torch.as_tensor(np.maximum(idx, 0), device=dev)]
        g[torch.as_tensor(idx < 0, device=dev)] = 0.0
        v0, v1, v2 = (V3(g[:, k], g[:, k + 1], g[:, k + 2]) for k in (0, 3, 6))
        shape = (n_grp, TRI_GROUP)
        self.tri_v0 = V3(*(c.reshape(shape) for c in v0))
        self.tri_e1 = V3(*(c.reshape(shape) for c in (v1 - v0)))
        self.tri_e2 = V3(*(c.reshape(shape) for c in (v2 - v0)))
        self.tri_index = torch.as_tensor(np.where(idx < 0, 1 << 40, idx),
                                         device=dev).reshape(shape)
        geo64 = self.data.shape_geo[np.maximum(idx, 0)].reshape(
            n_grp, TRI_GROUP, 12)
        verts = geo64[..., :9].reshape(n_grp, TRI_GROUP * 3, 3)
        live = np.repeat(idx.reshape(n_grp, TRI_GROUP) >= 0, 3, axis=1)
        centers = np.stack([verts[k][live[k]].mean(axis=0)
                            for k in range(n_grp)])
        radii = np.array([np.linalg.norm(verts[k][live[k]] - centers[k],
                                         axis=1).max() for k in range(n_grp)])
        self.grp_center = torch.as_tensor(centers, dtype=torch.float32,
                                          device=dev)
        self.grp_r2 = torch.as_tensor((radii * 1.001 + 1e-4) ** 2,
                                      dtype=torch.float32, device=dev)
        self.groups = n_grp
        # Each triangle's own ball (its vertices' mean through the
        # farthest vertex), for the count of tests a ray needs.
        tri = geo64[..., :9].reshape(n_grp, TRI_GROUP, 3, 3)
        tc = tri.mean(axis=2)
        tr = np.linalg.norm(tri - tc[:, :, None, :], axis=3).max(axis=2)
        self.tri_center = torch.as_tensor(tc, dtype=torch.float32, device=dev)
        self.tri_r2 = torch.as_tensor(np.where(idx.reshape(shape) < 0, -1.0,
                                               tr * tr), dtype=torch.float32,
                                      device=dev)


# --- rays, hits and BxDFs ---

def camera_rays(cam: Camera, pix, u_s, u_t):
    """camera.hpp:51-60 in the kernels' operand order: d = normalize((fwd
    + right a) + (-up) b); the pdf is 1."""
    y = pix // cam.width
    x = pix - y * cam.width
    s = (x.to(torch.float32) + u_s) / cam.width
    t = (y.to(torch.float32) + u_t) / cam.height
    a = (2.0 * s - 1.0) * cam.aspect_half
    b = (2.0 * t - 1.0) * cam.half
    dx, dy, dz = ((cam.forward[k] + a * cam.right[k]) + b * (-cam.up[k])
                  for k in range(3))
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    o = V3(*(torch.full_like(u_s, e) for e in cam.eye))
    return o, V3(dx * inv, dy * inv, dz * inv)


def _row(geo, i):
    return V3(geo[i], geo[i + 1], geo[i + 2])


def _plane_t(geo, o, d):
    n = _row(geo, 0)
    t = (dot(o, n) - geo[3]) / dot(d, -n)
    return t, t > 0


def _sphere_t(geo, o, d):
    oc = o - _row(geo, 0)
    r = geo[3]
    b = 2.0 * dot(oc, d)
    cc = dot(oc, oc) - r * r
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    t = torch.where(t1 > 0, t1, t2)
    return t, (disc >= 0) & (t > 0)


def _closer(t, i, valid, best_t, best_i):
    """The lexicographic (t, shape index) minimum, the first of tied
    shapes: the reference's scan with its strict `<`."""
    return valid & ((t < best_t) | ((t == best_t) & (i < best_i)))


def _tri_pairs(rs: RefScene, o, d, ray, grp):
    """Möller-Trumbore over the triangles of each (ray, group) pair:
    (t, index) of each pair's nearest valid triangle (inf where none)."""
    v0, e1, e2 = (V3(*(c[grp] for c in v))
                  for v in (rs.tri_v0, rs.tri_e1, rs.tri_e2))
    od = V3(*(c[ray][:, None] for c in o))
    dd = V3(*(c[ray][:, None] for c in d))
    p = cross(dd, e2)
    det = dot(e1, p)
    inv = 1.0 / det
    tvec = od - v0
    u = dot(tvec, p) * inv
    q = cross(tvec, e1)
    v = dot(dd, q) * inv
    t = dot(e2, q) * inv
    valid = ((torch.abs(det) > TRI_DET_EPS) & (u >= 0) & (v >= 0)
             & (u + v <= 1) & (t > 0))
    t = torch.where(valid, t, math.inf)
    tmin = t.min(dim=1).values
    index = rs.tri_index[grp]
    imin = torch.where(t == tmin[:, None], index, 1 << 40).min(dim=1).values
    return tmin, imin


def _enters(center, r2, o, d, t_max=None):
    """Whether the segment o + d t, 0 <= t (<= t_max), comes within the
    ball (center, r2)."""
    oc = V3(*(c - o_ for c, o_ in zip(center, o)))
    tc = torch.clamp(dot(oc, d), min=0.0)
    if t_max is not None:
        tc = torch.minimum(tc, t_max)
    w = oc - d * tc
    return dot(w, w) <= r2


def intersect(rs: RefScene, o, d):
    """Nearest hit of rays (o, d): (t f32[m], shape index i64[m]), t inf
    and index S on a miss."""
    m = o.x.shape[0]
    dev = o.x.device
    S = rs.shape_type.shape[0]
    best_t = torch.full((m,), math.inf, device=dev)
    best_i = torch.full((m,), S, dtype=torch.int64, device=dev)
    if rs.groups:
        gc = rs.grp_center
        center = V3(gc[None, :, 0], gc[None, :, 1], gc[None, :, 2])
        parts = []
        for a in range(0, m, PAIR_BLOCK * 4):
            sl = slice(a, a + PAIR_BLOCK * 4)
            enter = _enters(center, rs.grp_r2[None, :],
                            V3(*(c[sl, None] for c in o)),
                            V3(*(c[sl, None] for c in d)))
            ray, grp = enter.nonzero(as_tuple=True)
            ray = ray + a
            for k in range(0, ray.shape[0], PAIR_BLOCK):
                r, g = ray[k:k + PAIR_BLOCK], grp[k:k + PAIR_BLOCK]
                parts.append((r, *_tri_pairs(rs, o, d, r, g)))
        if parts:
            r, tp, ip = (torch.cat(x) for x in zip(*parts))
            # Per ray the pair of least t, then of least shape index.
            bt = best_t.scatter_reduce(0, r, tp, "amin")
            big = 1 << 41
            bi = torch.full((m,), big, dtype=torch.int64, device=dev)
            bi = bi.scatter_reduce(0, r, torch.where(tp == bt[r], ip, big),
                                   "amin")
            hit = torch.isfinite(bt)
            best_t = torch.where(hit, bt, best_t)
            best_i = torch.where(hit, bi, best_i)
    for i, stype in rs.others:
        fn = _plane_t if stype == PLANE else _sphere_t
        t, valid = fn(rs.geo[i], o, d)
        closer = _closer(t, i, valid, best_t, best_i)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, i, best_i)
    return best_t, best_i


def _tri_tests(rs: RefScene, o, d, t_hit):
    """The triangles a ray needs to test: those whose own ball its segment
    up to its hit comes within."""
    gc = rs.grp_center
    enter = _enters(V3(gc[None, :, 0], gc[None, :, 1], gc[None, :, 2]),
                    rs.grp_r2[None, :], V3(*(c[:, None] for c in o)),
                    V3(*(c[:, None] for c in d)), t_hit[:, None])
    ray, grp = enter.nonzero(as_tuple=True)
    total = 0
    for a in range(0, ray.shape[0], PAIR_BLOCK):
        r, g = ray[a:a + PAIR_BLOCK], grp[a:a + PAIR_BLOCK]
        tc = rs.tri_center[g]
        hit = _enters(V3(tc[..., 0], tc[..., 1], tc[..., 2]), rs.tri_r2[g],
                      V3(*(c[r][:, None] for c in o)),
                      V3(*(c[r][:, None] for c in d)), t_hit[r][:, None])
        total += int(hit.sum())
    return total


def make_frame(n):
    use_e1 = torch.abs(n.x) < torch.abs(n.y)
    one, zero = torch.ones_like(n.x), torch.zeros_like(n.x)
    tv = where3(use_e1, V3(one, zero, zero) - n * n.x,
                V3(zero, one, zero) - n * n.y)
    tangent = normalize(tv)
    return tangent, normalize(cross(n, tangent)), n


def angle_to_dir(theta, phi, frame):
    tangent, bitangent, n = frame
    st = torch.sin(theta)
    return (tangent * (torch.cos(phi) * st) + bitangent * (torch.sin(phi) * st)
            + n * torch.cos(theta))


def _pow_cpp(base, expo):
    mag = torch.pow(torch.abs(base), expo)
    is_int = expo == torch.round(expo)
    odd = torch.remainder(torch.round(expo), 2.0) == 1.0
    neg = base < 0
    val = mag * torch.where(neg & odd, -1.0, 1.0).to(mag.dtype)
    return torch.where(neg & ~is_int, torch.nan, val)


def sample_bxdf(mt, ex, n, d_in, u1, u2):
    """bxdf.hpp's sampling: diffuse, specular (with its below-horizon
    flip), mirror; the null BxDF gives direction 0 and pdf 1."""
    frame = make_frame(n)
    th_d = torch.asin(torch.sqrt(u1))
    phi = 2.0 * PI * u2
    dir_d = angle_to_dir(th_d, phi, frame)
    pdf_d = torch.cos(th_d) / PI
    th_s = torch.acos(torch.sqrt(torch.pow(u1, 2.0 / (ex + 2.0))))
    half = angle_to_dir(th_s, phi, frame)
    half = where3(dot(half, d_in) < 0, reflect(half, n), half)
    dir_s = reflect(d_in, half)
    pdf_s = ((ex + 2.0) / (2.0 * PI) * torch.pow(torch.cos(th_s), ex + 1.0)
             * torch.sin(th_s))
    dir_m = reflect(d_in, n)
    is_d, is_s, is_m = mt == DIFFUSE, mt == SPECULAR, mt == MIRROR
    d = where3(is_d, dir_d, where3(is_s, dir_s, where3(is_m, dir_m, 0.0)))
    pdf = torch.where(is_d, pdf_d, torch.where(
        is_s, pdf_s, torch.where(is_m, torch.ones_like(u1), 1.0)))
    return d, pdf


def eval_scale(mt, ex, n, d_in, d_out):
    """The scalar s of f = albedo * s (bxdf.hpp)."""
    s_diff = torch.full_like(n.x, 1.0 / PI)
    hw = d_in + d_out
    hw2 = dot(hw, hw)
    cos_h = dot(n, normalize(hw))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    s_spec = (ex + 2.0) / (2.0 * PI) * _pow_cpp(cos_h, ex) * sin_h
    s_spec = torch.where(hw2 > 0, s_spec, 0.0)
    cos_out = dot(n, d_out)
    s_mirr = torch.where(cos_out != 0, 1.0 / cos_out, 0.0)
    return torch.where(mt == DIFFUSE, s_diff, torch.where(
        mt == SPECULAR, s_spec, torch.where(mt == MIRROR, s_mirr, 0.0)))


# --- the geometry pass ---

class Bounce(NamedTuple):
    sel: torch.Tensor  # this bounce's live rays among the last bounce's
    ray: torch.Tensor  # i64: each live ray's index in the block
    aid: torch.Tensor  # albedo row (of the ones-padded table)
    eid: torch.Tensor  # emission row (of the zero-padded table)
    sc: torch.Tensor  # f32 s cos / pdf (0 where the pdf is not > 0)
    gate: float  # 1/(1 - absorb) under the roulette, else 1


class Paths(NamedTuple):
    pixel: torch.Tensor  # i64[n]: each ray's position among the pixels
    bounces: list


def trace_paths(rs: RefScene, cfg: dict, seeds, pixels, pix_pos, smp,
                counts: dict | None = None) -> Paths:
    """The live rays of every bounce of rays (pixel index pixels[pix_pos],
    sample smp): their table rows, weights and gates. `counts`, if given,
    gains the rays, the live bounce-rays, the shape tests they need by
    kind and the paths that end before the last bounce."""
    s0, s1 = (int(v) & MASK32 for v in seeds)
    pix = pixels[pix_pos]
    cam_word = sample_word(s0, pix, smp)
    o, d = camera_rays(rs.cam, pix, uniform(cam_word, 0, 0),
                       uniform(cam_word, 0, 1))
    word = sample_word(s1, pix, smp)
    n = pix.shape[0]
    ray = torch.arange(n, device=pix.device)
    sel = ray
    absorb, min_b = float(cfg["absorb_prob"]), int(cfg["min_bounces"])
    depth = int(cfg["max_depth"])
    inv_keep = float(np.float32(1.0 / (1.0 - absorb)))
    bounces = []
    for b in range(depth):
        if ray.shape[0] == 0:
            break
        u_rr, u1, u2 = (uniform(word, b, k) for k in range(3))
        if b >= min_b:
            keep = ~(u_rr < absorb)
            o, d, u1, u2, word, ray, sel = (
                o.take(keep), d.take(keep), u1[keep], u2[keep], word[keep],
                ray[keep], sel[keep])
        t, hit = intersect(rs, o, d)
        live = torch.isfinite(t)
        o, d, t, hit, u1, u2, word, ray, sel = (
            o.take(live), d.take(live), t[live], hit[live], u1[live],
            u2[live], word[live], ray[live], sel[live])
        if counts is not None:
            m = ray.shape[0]
            counts["live"] = counts.get("live", 0) + m
            counts["plane"] = counts.get("plane", 0) + m * rs.n_plane
            counts["sphere"] = counts.get("sphere", 0) + m * rs.n_sphere
            if rs.groups:
                counts["box"] = counts.get("box", 0) + m
                counts["tri"] = counts.get("tri", 0) + _tri_tests(rs, o, d, t)
        g = rs.geo[hit]
        g0 = V3(g[:, 0], g[:, 1], g[:, 2])
        htype = rs.shape_type[hit]
        point = o + d * t
        n_tri = normalize(cross(V3(g[:, 3], g[:, 4], g[:, 5]) - g0,
                                V3(g[:, 6], g[:, 7], g[:, 8]) - g0))
        normal = where3(htype == PLANE, g0,
                        where3(htype == SPHERE, normalize(point - g0), n_tri))
        mat = rs.shape_mat[hit]
        mt, ex = rs.mat_type[mat], rs.mat_exponent[mat]
        d_in = -d
        d_out, pdf = sample_bxdf(mt, ex, normal, d_in, u1, u2)
        s = eval_scale(mt, ex, normal, d_in, d_out)
        sc = torch.where(pdf > 0, s * dot(normal, d_out) / pdf, 0.0)
        bounces.append(Bounce(sel, ray, rs.mat_albedo[mat],
                              rs.shape_emit[hit], sc,
                              inv_keep if b >= min_b else 1.0))
        o = point + d_out * RAY_EPS
        d = d_out
        sel = torch.arange(ray.shape[0], device=ray.device)
    if counts is not None:
        alive_at_end = ray.shape[0] if len(bounces) == depth else 0
        counts["rays"] = counts.get("rays", 0) + n
        counts["ended"] = counts.get("ended", 0) + n - alive_at_end
    return Paths(pix_pos, bounces)


def _rows(tab, idx):
    """tab[idx] as a product with one-hot rows: its gradient is a sum over
    the rays, where a gather's would add every ray into a few table rows
    by atomics, one at a time."""
    return torch.nn.functional.one_hot(idx, tab.shape[0]).to(tab.dtype) @ tab


def radiance(paths: Paths, n_rays: int, alb_tab, emi_tab, dtype=None):
    """Per-ray radiance f[n_rays, 3] of the traced paths under the padded
    tables (albedo + a ones row, emission + a zeros row), differentiable in
    them. dtype (default the tables') is that of the weights, throughput
    and radiance."""
    dtype = dtype or alb_tab.dtype
    alb_tab, emi_tab = alb_tab.to(dtype), emi_tab.to(dtype)
    dev = alb_tab.device
    L = torch.zeros((n_rays, 3), dtype=dtype, device=dev)
    T = None
    for bn in paths.bounces:
        T = (torch.ones((bn.ray.shape[0], 3), dtype=dtype, device=dev)
             if T is None else T[bn.sel])
        P = T * torch.tensor(bn.gate, dtype=dtype, device=dev)
        L = L.index_add(0, bn.ray, P * _rows(emi_tab, bn.eid))
        T = P * (_rows(alb_tab, bn.aid) * bn.sc.to(dtype)[:, None])
    return L
