"""Radiative backpropagation as a `torch.autograd.Function`.

The port of `drt_tpu.adjoint`. The forward saves no per-bounce state,
only its inputs; the backward retraces the wavefront on the forward's
samples (biased mode, integrate.hpp:26-37) or on fresh ones (unbiased
mode, integrate.hpp:11-24, 39-52: a second tape, or the bounce seed
salted by `fused._salted`, which keeps the camera stream), collects the
per-bounce residuals and closes the gradient analytically from the
path-estimator factorization

    L_c = sum_b P_{b,c} e_{b,c},    w_{b,c} = albedo_{aid_b, c} * sc_b,

giving  dL_c/d e_{l,c}      = sum_b P_{b,c} [eid_b = l]
        dL_c/d albedo_{k,c} = sum_b P_{b,c} sc_b S_{b+1,c} [aid_b = k]

with the suffix radiance S from the reverse scan
S_b = gate_b * (e_b + w_b * S_{b+1}). In biased mode this equals
reverse-mode autograd through `renderer.trace_rays`
(tests/test_torch_adjoint.py). This module is the pure-tensor oracle of
the sweep and retrace adjoint kernels (`ops/megakernel.py`).

`make_diff_image_renderer` is the key-driven wavefront image renderer:
each spp chunk's rays from `renderer.chunk_rays`, traced by the wavefront
tracer kernel's keyed form (`ops.megakernel.make_pallas_tracer(...,
keyed=True)`, which draws the bounce uniforms itself) and differentiated
by the wavefront adjoint kernel (`make_pallas_adjoint`, on the chunk's
tape) when the scene is on the card, by their plain twins when it is on
the CPU or plain=True.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import _salted
from drt_tpu_torch.ops.megakernel import (make_pallas_adjoint,
                                          make_pallas_tracer)
from drt_tpu_torch.ops.rng import prefix_tape
from drt_tpu_torch.ops.vecmath import V3, gatherv
from drt_tpu_torch.renderer import (BounceResiduals, chunk_pixel_ids,
                                    chunk_rays, chunk_sample_ids,
                                    expand_lanes, lane_count, one_lane,
                                    render_image, trace_rays)
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table


def _lane_cotangent(g, cfg: RenderConfig):
    """Per-ray cotangent (V3 of f[N], or f[3, N]) -> the per-lane
    cotangent of the splitting tracer's N * M ray-major lanes: a ray's
    radiance is the MEAN of its lanes, so each lane gets g / M
    (drt_tpu/adjoint.py:_lane_cotangent). The identity at M == 1."""
    M = lane_count(cfg)
    if M == 1:
        return g
    if torch.is_tensor(g):
        return expand_lanes(g / M, M)
    return expand_lanes(V3(*(c / M for c in g)), M)


def _tape_of(cfg: RenderConfig, seeds, pix, sample, dtype,
             n_samples: int | None = None) -> torch.Tensor:
    """The bounce draws of the ray-major lanes of the rays (pix, sample)
    under the bounce seed seeds[1]: `prefix_tape`, whose one lane a ray
    at bsdf_samples == 1 is `bounce_tape`."""
    return prefix_tape(int(seeds[1]), pix, sample, cfg.bsdf_samples,
                       cfg.max_depth, dtype, n_samples=n_samples)


def _segv(data: V3, ids: torch.Tensor, num: int) -> V3:
    """V3 of f[N] -> V3 of f[num] by segment id: `num` masked sums per
    channel, as the reference (the tables have a handful of rows)."""
    def seg1(c):
        return torch.stack([torch.where(ids == k, c, 0.0).sum()
                            for k in range(num)])
    return V3(seg1(data.x), seg1(data.y), seg1(data.z))


def _reverse_sweep(albedo_tab: torch.Tensor, emission_tab: torch.Tensor,
                   residuals: BounceResiduals, g: V3, S: V3 | None = None):
    """The reverse scan over per-bounce residuals into the padded tables
    (d_albedo, d_emission as V3 of f[K+1] and f[L+1], sentinel rows
    included), seeded by the suffix radiance S after the last bounce (0
    for a path's end, a later segment's S at its entry for a segment:
    drt_tpu/ops/megakernel.py:_reverse_sweep). Returns (d_albedo,
    d_emission, S at the first bounce)."""
    dtype = albedo_tab.dtype
    n_alb = albedo_tab.shape[0]
    n_emit = emission_tab.shape[0]
    dev = g.x.device
    if S is None:
        S = V3(*(torch.zeros_like(g.x) for _ in range(3)))
    da = V3(*(torch.zeros(n_alb, dtype=dtype, device=dev) for _ in range(3)))
    de = V3(*(torch.zeros(n_emit, dtype=dtype, device=dev)
              for _ in range(3)))
    for b in reversed(range(residuals.sc.shape[0])):
        P = V3(residuals.P.x[b], residuals.P.y[b], residuals.P.z[b])
        sc, gate = residuals.sc[b], residuals.gate[b]
        aid, eid = residuals.aid[b], residuals.eid[b]
        e = gatherv(emission_tab, eid)
        gP = g * P
        de = de + _segv(gP, eid, n_emit)
        da = da + _segv(gP * sc * S, aid, n_alb)
        w = gatherv(albedo_tab, aid) * sc
        S = (e + w * S) * gate
    return da, de, S


def _param_grads(params: Params, scene: Scene, residuals: BounceResiduals,
                 g: V3, dtype) -> Params:
    """Close the gradient from per-bounce residuals by a reverse scan.
    g: V3 of f[N] per-ray cotangent."""
    da, de, _ = _reverse_sweep(albedo_table(scene, params).to(dtype),
                               emission_table(scene, params).to(dtype),
                               residuals, g)
    k = params.albedo.shape[0]
    l = params.emission.shape[0]
    return Params(albedo=da.to_array()[:k].to(params.albedo.dtype),
                  emission=de.to_array()[:l].to(params.emission.dtype))


def _bwd_seeds(cfg: RenderConfig, seeds) -> list:
    """The seed pairs of the backward's retraces: the forward's in biased
    mode, `adjoint_samples` salted ones in unbiased mode (a fresh bounce
    stream each, the same camera stream)."""
    if not cfg.unbiased:
        return [seeds]
    return [_salted(seeds, s) for s in range(cfg.adjoint_samples)]


def make_diff_renderer(scene: Scene, cfg: RenderConfig,
                       use_tape: bool = False, bwd_tape: bool = False):
    """Build the differentiable radiance estimator for a scene.

    use_tape=False: `f(params, orig, dir, seeds) -> radiance V3 of f[N]`
    for the seed pair `seeds` (key-mode `trace_rays`: ray i draws as pixel
    i at sample 0); the backward replays the forward's draws (biased) or
    averages `adjoint_samples` retraces on salted bounce seeds (unbiased).
    bsdf_samples > 1 (key mode only) traces `lane_count(cfg)` ray-major
    lanes per ray and returns their mean; the backward retraces the lanes
    with the cotangent g / M each (`_lane_cotangent`).

    use_tape=True: `f(params, orig, dir, tape)` with an injected uniform
    tape f[max_depth, 3, N]; differentiable in `params` by radiative
    backprop, upstream cotangents flow per ray.

    bwd_tape=True (needs use_tape=True and cfg.unbiased): `f(params, orig,
    dir, tape_fwd, tape_bwd)`, whose backward retraces on the second tape.
    With tape_bwd == tape_fwd it reduces exactly to the biased replay.
    """
    if bwd_tape:
        if not (use_tape and cfg.unbiased):
            raise ValueError("bwd_tape requires use_tape=True and "
                             "cfg.unbiased=True")
        if cfg.bsdf_samples != 1:
            raise ValueError("bwd_tape mode is single-BSDF-sample only "
                             "(a 1-stream tape cannot drive a tree)")
    if use_tape and cfg.bsdf_samples > 1:
        raise ValueError("bsdf_samples > 1 is key-driven only")
    M = lane_count(cfg)
    cfg1 = one_lane(cfg)

    class DiffTrace(torch.autograd.Function):
        # Traces the N * M lanes of (ox.., dx..) f[N] (M = 1 without
        # splitting) and returns each ray's lane mean.
        @staticmethod
        def forward(ctx, albedo, emission, ox, oy, oz, dx, dy, dz, tape_f,
                    bwd_tapes):
            ctx.save_for_backward(albedo, emission, ox, oy, oz, dx, dy, dz)
            ctx.bwd_tapes = bwd_tapes
            L = trace_rays(Params(albedo, emission), scene,
                           expand_lanes(V3(ox, oy, oz), M),
                           expand_lanes(V3(dx, dy, dz), M), cfg1,
                           tape=tape_f)
            return tuple(c.reshape(-1, M).mean(dim=1) for c in L)

        @staticmethod
        def backward(ctx, gx, gy, gz):
            albedo, emission, ox, oy, oz, dx, dy, dz = ctx.saved_tensors
            params = Params(albedo, emission)
            g = _lane_cotangent(V3(gx, gy, gz), cfg)
            da = de = 0.0
            with torch.no_grad():
                tapes = ctx.bwd_tapes()
                for tape in tapes:
                    _, residuals = trace_rays(
                        params, scene, expand_lanes(V3(ox, oy, oz), M),
                        expand_lanes(V3(dx, dy, dz), M), cfg1, tape=tape,
                        collect=True)
                    d = _param_grads(params, scene, residuals, g, ox.dtype)
                    da = da + d.albedo
                    de = de + d.emission
                if len(tapes) > 1:
                    da, de = da / len(tapes), de / len(tapes)
            return (da, de) + (None,) * 8

    def diff_trace(params: Params, orig: V3, dir: V3, tape_f, tape_b=None):
        if not use_tape:
            if tape_b is not None:
                raise TypeError("key mode takes (params, orig, dir, seeds)")
            seeds, n = tape_f, dir.x.shape[0]
            pix = torch.arange(n, device=dir.x.device)
            smp = torch.zeros_like(pix)

            def tape_of(sd):
                return _tape_of(cfg, sd, pix, smp, dir.x.dtype)

            tape_f = tape_of(seeds)
            bwd = (lambda: [tape_of(sd) for sd in _bwd_seeds(cfg, seeds)])
        elif bwd_tape:
            if tape_b is None:
                raise TypeError("bwd_tape=True takes (params, orig, dir, "
                                "tape_fwd, tape_bwd)")
            bwd = (lambda: [tape_b])
        else:
            if tape_b is not None:
                raise TypeError("a second tape needs bwd_tape=True")
            bwd = (lambda: [tape_f])  # biased: replay the forward's samples
        return V3(*DiffTrace.apply(params.albedo, params.emission, *orig,
                                   *dir, tape_f, bwd))

    return diff_trace


def make_wavefront_trace_fn(scene: Scene, cfg: RenderConfig,
                            plain: bool = False, mesh=None):
    """The `trace_fn` of `renderer.render_image` over the wavefront tracer
    kernel (B5a; its plain twin, `trace_rays`, for a CPU scene or
    plain=True). At bsdf_samples == 1 its keyed form: one launch on a
    chunk's rays, which draws their bounce uniforms in the kernel from
    seeds[1] and each ray's (pix, sample); no tape is built. At
    bsdf_samples > 1 its tape form on the chunk's rays expanded to
    `lane_count(cfg)` ray-major lanes and their prefix-shared draws
    (`ops.rng.prefix_tape`), which the keyed form cannot key; a ray's
    radiance is the mean of its lanes. With a mesh (`parallel.mesh`) each
    shard traces its contiguous range of the chunk's rays on its device
    (their lanes and draws its own), and the radiance is gathered in ray
    order."""
    M = lane_count(cfg)
    if M == 1:
        trace = make_pallas_tracer(scene, cfg, plain=plain, keyed=True)
    else:
        trace = make_pallas_tracer(scene, one_lane(cfg), plain=plain)

    def trace_rays_of(alb, emi, o, d, seeds, pix, s):
        """Radiance f[3, n] of rays o, d f[3, n] with ids (pix, s)."""
        if M == 1:
            return trace(alb, emi, o, d, seeds, pix.int(), s.int())
        u = _tape_of(cfg, seeds, pix, s, alb.dtype, n_samples=cfg.spp)
        L = trace(alb, emi, expand_lanes(o, M), expand_lanes(d, M), u)
        return L.reshape(3, -1, M).mean(dim=2)

    def trace_fn(params, o, d, seeds, pix, s):
        alb = albedo_table(scene, params).contiguous()
        emi = emission_table(scene, params).contiguous()
        o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
        if mesh is None:
            return trace_rays_of(alb, emi, o, d, seeds, pix, s)
        from drt_tpu_torch.parallel.mesh import gather, per_shard, take

        return gather(mesh, per_shard(
            mesh, pix.shape[0], lambda k, a, b, dev: trace_rays_of(
                alb.to(dev), emi.to(dev), take(o, a, b, dev),
                take(d, a, b, dev), seeds, take(pix, a, b, dev),
                take(s, a, b, dev))), alb.device)

    return trace_fn


def make_diff_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                             plain: bool = False, mesh=None):
    """Build `render(params, seeds: i32[2]) -> image f[H, W, 3]`,
    differentiable in params, with the spp-chunk loop inside one
    `torch.autograd.Function`: the forward keeps only (params, seeds),
    nothing per ray, and renders `render_image` with the wavefront tracer
    kernel (B5a) chunk by chunk; the backward rebuilds each chunk's rays
    and tape from the seeds and runs the wavefront adjoint kernel (B5b) on
    them, one launch per chunk, or `adjoint_samples` launches on salted
    bounce seeds in unbiased mode (the samples the "cuda" backend's
    retrace draws). The kernels take scenes of at most 64 shapes on the
    card, float32; a CPU scene, or plain=True, runs their plain twins on
    the scene's device. At bsdf_samples > 1 both kernels run on the
    chunk's rays split into `lane_count(cfg)` ray-major lanes and their
    prefix-shared tape, the adjoint with the cotangent g / M a lane; the
    unbiased mode redraws the lanes' tape from salted bounce seeds. With
    a mesh (`parallel.mesh`; the JAX package's `constrain`) each shard
    runs both kernels on its contiguous range of every chunk's rays, the
    radiance gathered in ray order and the shards' gradient partials
    summed.
    """
    spp_c = cfg.spp // cfg.spp_chunks
    M = lane_count(cfg)
    trace_fn = make_wavefront_trace_fn(scene, cfg, plain=plain, mesh=mesh)
    adjoint = make_pallas_adjoint(scene, one_lane(cfg), plain=plain)

    def chunk_grads(alb, emi, o, d, pix, s, g_ray, bwd_seeds, da=0.0,
                    de=0.0):
        """(da, de) plus the (d_albedo, d_emission) of the rays o, d
        f[3, n] (ids pix, s) under their cotangent g_ray f[3, n], averaged
        over bwd_seeds: each seed's term added in turn."""
        dtype = o.dtype
        g_lane = _lane_cotangent(g_ray, cfg)
        o, d = expand_lanes(o, M), expand_lanes(d, M)
        for sd in bwd_seeds:
            da_s, de_s = adjoint(
                alb, emi, o, d,
                _tape_of(cfg, sd, pix, s, dtype, n_samples=cfg.spp), g_lane)
            da = da + da_s / len(bwd_seeds)
            de = de + de_s / len(bwd_seeds)
        return da, de

    def image(params, seeds):
        return render_image(params, scene, cam, seeds, cfg,
                            trace_fn=trace_fn)

    class Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, albedo, emission, seeds):
            ctx.save_for_backward(albedo, emission)
            ctx.seeds = seeds
            return image(Params(albedo, emission), seeds)

        @staticmethod
        def backward(ctx, g):
            albedo, emission = ctx.saved_tensors
            params = Params(albedo, emission)
            alb = albedo_table(scene, params).contiguous()
            emi = emission_table(scene, params).contiguous()
            dtype = cam.forward.dtype
            xy_rep = chunk_pixel_ids(cfg, cam.forward.device)
            # image = mean over chunks of per-pixel spp_c means, so every
            # ray of a pixel gets g[pixel] / (spp_c * chunks * pdf).
            g_pix = (g / (spp_c * cfg.spp_chunks)).to(dtype)
            g_planes = g_pix.permute(2, 0, 1).reshape(3, -1)
            bwd_seeds = _bwd_seeds(cfg, ctx.seeds)
            da = de = 0.0
            for c in range(cfg.spp_chunks):
                pix, s = chunk_sample_ids(cfg, xy_rep, c)
                o, d, pdf = chunk_rays(cam, cfg, xy_rep, ctx.seeds, c)
                rays = (torch.stack(tuple(o)), torch.stack(tuple(d)), pix, s,
                        g_planes[:, pix] / pdf)
                if mesh is None:
                    da, de = chunk_grads(alb, emi, *rays, bwd_seeds, da, de)
                else:
                    from drt_tpu_torch.parallel.mesh import (per_shard,
                                                             sum_partials,
                                                             take)

                    da_c, de_c = sum_partials(mesh, per_shard(
                        mesh, pix.shape[0], lambda k, a, b, dev: chunk_grads(
                            alb.to(dev), emi.to(dev),
                            *(take(t, a, b, dev) for t in rays), bwd_seeds)),
                        alb.device)
                    da, de = da + da_c, de + de_c
            k, l = albedo.shape[0], emission.shape[0]
            return da[:k].to(albedo.dtype), de[:l].to(emission.dtype), None

    def render(params: Params, seeds) -> torch.Tensor:
        if torch.is_grad_enabled() and (params.albedo.requires_grad
                                        or params.emission.requires_grad):
            return Render.apply(params.albedo, params.emission, seeds)
        with torch.no_grad():
            return image(params, seeds)

    return render
