"""Fixed-depth wavefront path tracer over flat SoA ray state, in tape mode.

The port of `drt_tpu.renderer`'s `BounceResiduals`, `_bounce` and
`trace_rays(tape=..., collect=...)`:
the reference's per-ray recursion (pathtracer.hpp:91-136) becomes a loop
over bounces in which every bounce intersects the whole wavefront, adds
emission, samples the BxDF and updates the throughput. Dead rays
(absorbed by Russian roulette or missed) are masked, never branched on.

Per-path estimator (what `adjoint.py` differentiates analytically):

    L = sum_b P_b * e_b,   P_b = prod_{j<=b} gate_j * prod_{j<b} w_j

The uniforms come from a tape f[max_depth, 3, N] with slots (rr, u1, u2)
per bounce, the reference's per-vertex order RR -> theta -> phi, or, in
key mode, from the keyed hash of `ops.rng` under the seed pair `seeds:
i32[2]` that every renderer of the port takes (`fused.seeds_from_generator`).
The JAX package draws key mode from threefry (`fold_in(key, bounce)`),
which is not reproduced here: the port's draws are the ones its fused
kernels take, and the JAX side of a test is fed them as a tape.

Key mode: ray r of chunk c (`chunk_pixel_ids`: pixel-major, spp-minor) at
pixel p and in-chunk sample j is sample s = c*spp_c + j of pixel p. Its
camera offsets are draws (seeds[0], p, s, 0, dim 0|1) and its bounce slots
(rr, u1, u2) draws (seeds[1], p, s, b, dim 0|1|2): the samples the fused
tracer's internal RNG draws, in another ray order.

Per-vertex splitting (bsdf_samples = n > 1, the reference integration
operator's n_samples at every scatter, integrate.hpp:56-66) is key mode
only: each ray becomes M = n^(max_depth-1) leaf lanes, ray-major, whose
draws are shared by the lanes of one path prefix (`ops.rng.prefix_tape`),
and a ray's radiance is the mean of its lanes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from drt_tpu_torch.camera import Camera, camera_rays, pixel_grid
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.constants import RAY_EPS
from drt_tpu_torch.ops.bxdf import eval_scale, sample_bxdf
from drt_tpu_torch.ops.intersect import intersect_scene
from drt_tpu_torch.ops.rng import (bounce_tape, camera_draws,
                                   prefix_tape, split_lanes)
from drt_tpu_torch.ops.vecmath import V3, dotv, gatherv, wherev
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table


class BounceResiduals(NamedTuple):
    """Per-bounce values stacked over depth, consumed by the adjoint."""

    P: V3  # V3 of f[D, N]: emission weight (gated throughput prefix)
    sc: torch.Tensor  # f[D, N] scalar factor s*cos/pdf, w = albedo[aid]*sc
    gate: torch.Tensor  # f[D, N] RR/liveness gate at this bounce
    aid: torch.Tensor  # i32[D, N] albedo row of this bounce's material
    eid: torch.Tensor  # i32[D, N] emission row of this bounce's emitter


def _bounce(tabs, scene: Scene, cfg: RenderConfig, carry, b, u):
    """One wavefront bounce; carry = (o, d, T, L, alive). Returns the new
    carry, the residuals (P, sc, gate, aid, eid) of this bounce, and the
    hit (whose shape index the fused kernels' twins record).

    A ray dies only when absorbed or on a miss, not when its throughput
    reaches zero: the reference keeps recursing with a zero BRDF value
    (pathtracer.hpp:17-35).
    """
    albedo_tab, emission_tab = tabs
    o, d, T, L, alive = carry
    n_emit = emission_tab.shape[0] - 1  # sentinel (zero) row index
    u_rr, u1, u2 = u
    dtype = u1.dtype

    # Russian roulette at depth b (pathtracer.hpp:128-133); b is the
    # wavefront's bounce, or i[N] where every ray has its own depth (the
    # regeneration kernels' plain versions, ops/regen.py).
    inv_keep = 1.0 / (1.0 - cfg.absorb_prob)
    if torch.is_tensor(b):
        rr_on = b >= cfg.min_bounces
        alive = alive & ~(rr_on & (u_rr < cfg.absorb_prob))
        # inv_keep rounded to dtype once (a Python float in torch.where
        # would make a float32 tensor).
        rr_scale = torch.where(
            rr_on, torch.tensor(inv_keep, dtype=dtype, device=u1.device),
            1.0)
    else:
        do_rr = b >= cfg.min_bounces
        if do_rr:
            alive = alive & ~(u_rr < cfg.absorb_prob)
        rr_scale = torch.tensor(inv_keep if do_rr else 1.0, dtype=dtype,
                                device=u1.device)

    hit = intersect_scene(scene, o, d, emit_sentinel=n_emit)
    alive = alive & hit.valid
    gate = torch.where(alive, rr_scale, 0.0)

    # Emission at this vertex; the RR divide applies to it too
    # (pathtracer.hpp:113-114, :133).
    P = T * gate
    e = gatherv(emission_tab, hit.emit)
    L = L + P * e

    mt = scene.mat_type[hit.mat]
    mex = scene.mat_exponent[hit.mat].to(dtype)
    aid = scene.mat_albedo[hit.mat]
    d_in = -d
    dir_out, pdf = sample_bxdf(mt, mex, hit.normal, d_in, u1, u2)
    s = eval_scale(mt, mex, hit.normal, d_in, dir_out)
    cos_t = dotv(hit.normal, dir_out)  # raw normal dot (pathtracer.hpp:103)
    # Dead rays carry inf/NaN hit data; the pdf > 0 guard drops the f32
    # samples whose pdf rounds to 0 (drt_tpu.renderer._bounce).
    sc = torch.where(alive & (pdf > 0), s * cos_t / pdf, 0.0)
    a = gatherv(albedo_tab, aid)
    T_next = P * (a * sc)

    o_next = wherev(alive, hit.point + dir_out * RAY_EPS, 0.0)
    d_next = wherev(alive, dir_out, 0.0)
    return ((o_next, d_next, T_next, L, alive),
            (P, sc, gate, aid, hit.emit), hit)


def trace_segment(params: Params, scene: Scene, cfg: RenderConfig,
                  b_start: int, b_end: int, orig: V3, dir: V3, T: V3 | None,
                  alive: torch.Tensor | None, tape: torch.Tensor,
                  early_exit: bool = False):
    """Bounces [b_start, b_end) of a wavefront entered in state (orig,
    dir, throughput T, alive bool[K]); T and alive None are a fresh path
    (unit throughput, alive). The tape f[b_end - b_start, 3, K] is indexed
    by the segment-local bounce, Russian roulette by the absolute one
    (drt_tpu/ops/megakernel.py:_wavefront_body(b_start, b_end, T, alive,
    full_output=True)). early_exit=True stops at the first bounce where no
    ray lives, which changes nothing of the radiance (a dead ray adds
    P e = 0) and leaves the residuals of the skipped bounces out.

    Returns (segment radiance V3 of f[K], exit state (orig, dir, T, alive),
    BounceResiduals of the segment's bounces, nearest shape index
    i64[b_end - b_start, K], which is 0 on a miss and meaningful only where
    gate > 0)."""
    if cfg.bsdf_samples != 1:
        raise ValueError("bsdf_samples > 1 is key-driven only")
    dtype = dir.x.dtype
    n = dir.x.shape[0]
    dev = dir.x.device
    tabs = (albedo_table(scene, params).to(dtype),
            emission_table(scene, params).to(dtype))
    if T is None:
        one = torch.ones(n, dtype=dtype, device=dev)
        T = V3(one, one, one)
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=dev)
    zero = torch.zeros(n, dtype=dtype, device=dev)
    carry = (orig, dir, T, V3(zero, zero, zero), alive)
    res, shapes = [], []
    for b in range(b_start, b_end):
        if early_exit and not bool(carry[4].any()):
            break
        u = tape[b - b_start]
        carry, res_b, hit = _bounce(tabs, scene, cfg, carry, b,
                                    (u[0], u[1], u[2]))
        res.append(res_b)
        shapes.append(hit.shape)
    o, d, T, L, alive = carry
    if not res:
        return L, (o, d, T, alive), None, None
    P, sc, gate, aid, eid = zip(*res)
    residuals = BounceResiduals(
        V3(*(torch.stack(c) for c in zip(*P))), torch.stack(sc),
        torch.stack(gate), torch.stack(aid), torch.stack(eid))
    return L, (o, d, T, alive), residuals, torch.stack(shapes)


def trace_residuals(params: Params, scene: Scene, orig: V3, dir: V3,
                    cfg: RenderConfig, tape: torch.Tensor):
    """`trace_rays` that keeps every bounce: (radiance V3 of f[N],
    BounceResiduals, nearest shape index i64[D, N], which is 0 on a miss
    and meaningful only where gate > 0)."""
    L, _, residuals, shapes = trace_segment(params, scene, cfg, 0,
                                            cfg.max_depth, orig, dir, None,
                                            None, tape)
    return L, residuals, shapes


def lane_count(cfg: RenderConfig) -> int:
    """Leaf lanes per primary ray under per-vertex splitting: bounces
    0..max_depth-2 each branch bsdf_samples ways (the last bounce's
    sampled direction is never traced)."""
    return split_lanes(cfg.bsdf_samples, cfg.max_depth)


def one_lane(cfg: RenderConfig) -> RenderConfig:
    """The config that traces each leaf lane of a splitting config as a
    ray of its own."""
    return dataclasses.replace(cfg, bsdf_samples=1)


def expand_lanes(v, m: int):
    """Rays -> their m lanes each, ray-major: a V3 of f[N] (or a tensor
    f[3, N]) -> the same of f[N * m]; v itself at m == 1."""
    if m == 1:
        return v
    if torch.is_tensor(v):
        return v.repeat_interleave(m, dim=-1)
    return V3(*(c.repeat_interleave(m) for c in v))


def _trace_rays_splitting(params: Params, scene: Scene, orig: V3, dir: V3,
                          cfg: RenderConfig, seeds, pix: torch.Tensor,
                          sample: torch.Tensor, collect: bool = False):
    """The n-sample-per-vertex tree estimator (integrate.hpp:56-66) as a
    flat wavefront over N * M leaf lanes, ray-major, M = `lane_count(cfg)`
    (drt_tpu/renderer.py:_trace_rays_splitting). Lanes of one path prefix
    read the same draws (`prefix_tape`), so the per-ray lane MEAN is the
    recursive estimator: the emission of bounce b appears in
    n^(D-1-b) of a ray's n^(D-1) lanes, the product of b nested 1/n
    averages. Returns the per-ray radiance, with collect=True also the
    PER-LANE BounceResiduals f[D, N * M] (the adjoint gives each lane the
    cotangent g / M, `adjoint._lane_cotangent`)."""
    M = lane_count(cfg)
    n = dir.x.shape[0]
    tape = prefix_tape(int(seeds[1]), pix, sample, cfg.bsdf_samples,
                       cfg.max_depth, dir.x.dtype)
    L, residuals, _ = trace_residuals(params, scene, expand_lanes(orig, M),
                                      expand_lanes(dir, M), one_lane(cfg),
                                      tape)
    L_ray = V3(*(c.reshape(n, M).mean(dim=1) for c in L))
    return (L_ray, residuals) if collect else L_ray


def trace_rays(params: Params, scene: Scene, orig: V3, dir: V3,
               cfg: RenderConfig, tape: torch.Tensor | None = None,
               collect: bool = False, *, seeds=None, pix=None, sample=None):
    """Trace a wavefront of rays to radiance, in plain PyTorch on the
    tensors' device (the fused kernels' plain versions are built on it).

    orig, dir: V3 of f[N] primary rays; tape: f[max_depth, 3, N] uniforms
    with slots (rr, u1, u2) per bounce. Without a tape (key mode) the
    slots are drawn from `seeds` for rays (pix, sample) (i64[N] each); by
    default ray i is pixel i at sample 0. Returns radiance as a V3 of
    f[N], or with collect=True (radiance, BounceResiduals).

    bsdf_samples > 1 splits each ray into `lane_count(cfg)` lanes
    (`_trace_rays_splitting`): key mode only, since one stream of draws
    per ray cannot drive a branching tree; with collect=True the
    residuals are per lane, ray-major.
    """
    if tape is None:
        if seeds is None:
            raise TypeError("trace_rays takes a tape or seeds")
        n = dir.x.shape[0]
        if pix is None:
            pix = torch.arange(n, device=dir.x.device)
        if sample is None:
            sample = torch.zeros_like(pix)
        if cfg.bsdf_samples > 1:
            return _trace_rays_splitting(params, scene, orig, dir, cfg,
                                         seeds, pix, sample, collect)
        tape = bounce_tape(int(seeds[1]), pix, sample, cfg.max_depth,
                           dir.x.dtype)
    elif cfg.bsdf_samples > 1:
        raise ValueError("bsdf_samples > 1 is key-driven only")
    L, residuals, _ = trace_residuals(params, scene, orig, dir, cfg, tape)
    return (L, residuals) if collect else L


def chunk_pixel_ids(cfg: RenderConfig, device=None) -> torch.Tensor:
    """i32[N_c, 2] pixel coordinates for one spp chunk (spp-minor within a
    pixel, pixels in the reference's raster order)."""
    assert cfg.spp % cfg.spp_chunks == 0
    spp_c = cfg.spp // cfg.spp_chunks
    return torch.repeat_interleave(pixel_grid(cfg.width, cfg.height, device),
                                   spp_c, dim=0)


def chunk_sample_ids(cfg: RenderConfig, xy_rep: torch.Tensor, chunk: int):
    """(pixel i64[N_c], sample i64[N_c]) of the rays of chunk `chunk`, laid
    out as `chunk_pixel_ids`: ray r is sample chunk*spp_c + r % spp_c of
    its pixel."""
    spp_c = cfg.spp // cfg.spp_chunks
    pix = xy_rep[:, 1].long() * cfg.width + xy_rep[:, 0].long()
    j = torch.arange(xy_rep.shape[0], device=xy_rep.device) % spp_c
    return pix, chunk * spp_c + j


def chunk_rays(cam: Camera, cfg: RenderConfig, xy_rep: torch.Tensor, seeds,
               chunk: int):
    """Primary rays (orig, dir, pdf) of spp chunk `chunk` (deterministic in
    seeds[0]); xy_rep is `chunk_pixel_ids(cfg)`."""
    pix, s = chunk_sample_ids(cfg, xy_rep, chunk)
    cam_u = camera_draws(int(seeds[0]), pix, s, cam.forward.dtype)
    return camera_rays(cam, cfg.width, cfg.height, xy_rep, cam_u.T)


def render_image(params: Params, scene: Scene, cam: Camera, seeds,
                 cfg: RenderConfig, trace_fn=None) -> torch.Tensor:
    """Render an image f[H, W, 3]: the mean over spp of per-sample radiance
    / camera pdf (src/render.cpp:72-87; the camera pdf is 1), the spp
    chunks one after another, each chunk's image the mean of its pixels'
    spp_c samples and the image the mean of the chunk images.

    trace_fn: a replacement for key-mode `trace_rays`, `trace_fn(params,
    orig, dir, seeds, pix, sample) -> radiance` (V3 of f[N], or f[3, N]),
    such as `adjoint.make_wavefront_trace_fn`'s over the kernels.

    Autograd through this function keeps every chunk's residuals; the
    differentiable form is `adjoint.make_diff_image_renderer`, whose
    backward retraces chunk by chunk.
    """
    w, h = cfg.width, cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    xy_rep = chunk_pixel_ids(cfg, cam.forward.device)
    if trace_fn is None:
        def trace_fn(p, o, d, sd, pix, s):
            return trace_rays(p, scene, o, d, cfg, seeds=sd, pix=pix,
                              sample=s)

    images = []
    for c in range(cfg.spp_chunks):
        pix, s = chunk_sample_ids(cfg, xy_rep, c)
        o, d, pdf = chunk_rays(cam, cfg, xy_rep, seeds, c)
        radiance = trace_fn(params, o, d, seeds, pix, s)
        images.append(torch.stack([(ch / pdf).reshape(h, w, spp_c).mean(dim=2)
                                   for ch in radiance], dim=-1))
    if len(images) == 1:
        return images[0]
    return torch.stack(images).mean(dim=0)
