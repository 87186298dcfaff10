"""Radiative backpropagation as a `torch.autograd.Function`.

The port of `drt_tpu.adjoint` in its tape forms. The forward saves no
per-bounce state, only its inputs; the backward retraces the wavefront on
a tape (the forward's in biased mode, integrate.hpp:26-37; a second,
fresh one in unbiased mode, integrate.hpp:11-24, 39-52), collects the
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

The key-driven forms (`use_tape=False`, `make_diff_image_renderer`) need
the key-mode wavefront tracer and come with ROADMAP item A4.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.vecmath import V3, gatherv
from drt_tpu_torch.renderer import BounceResiduals, trace_rays
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table


def _lane_cotangent(g: V3, cfg: RenderConfig) -> V3:
    """Per-ray cotangent -> per-lane cotangent of the splitting tracer.
    The identity at bsdf_samples == 1, the only estimator the port's
    tracer has until ROADMAP item A12."""
    if cfg.bsdf_samples != 1:
        raise NotImplementedError(
            "bsdf_samples > 1 (per-vertex splitting) comes to the port "
            "with ROADMAP item A12")
    return g


def _segv(data: V3, ids: torch.Tensor, num: int) -> V3:
    """V3 of f[N] -> V3 of f[num] by segment id: `num` masked sums per
    channel, as the reference (the tables have a handful of rows)."""
    def seg1(c):
        return torch.stack([torch.where(ids == k, c, 0.0).sum()
                            for k in range(num)])
    return V3(seg1(data.x), seg1(data.y), seg1(data.z))


def _param_grads(params: Params, scene: Scene, residuals: BounceResiduals,
                 g: V3, dtype) -> Params:
    """Close the gradient from per-bounce residuals by a reverse scan.
    g: V3 of f[N] per-ray cotangent."""
    albedo_tab = albedo_table(scene, params).to(dtype)  # [K+1, 3]
    emission_tab = emission_table(scene, params).to(dtype)  # [L+1, 3]
    n_alb = albedo_tab.shape[0]
    n_emit = emission_tab.shape[0]
    dev = g.x.device
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
    k = params.albedo.shape[0]
    l = params.emission.shape[0]
    return Params(albedo=da.to_array()[:k].to(params.albedo.dtype),
                  emission=de.to_array()[:l].to(params.emission.dtype))


def make_diff_renderer(scene: Scene, cfg: RenderConfig,
                       use_tape: bool = False, bwd_tape: bool = False):
    """Build the differentiable radiance estimator for a scene.

    use_tape=True: `f(params, orig, dir, tape) -> radiance V3 of f[N]`
    with an injected uniform tape f[max_depth, 3, N]; differentiable in
    `params` by radiative backprop, upstream cotangents flow per ray.

    bwd_tape=True (needs use_tape=True and cfg.unbiased): `f(params, orig,
    dir, tape_fwd, tape_bwd)`, whose backward retraces on the second tape.
    With tape_bwd == tape_fwd it reduces exactly to the biased replay.

    use_tape=False draws from a PRNG key in the JAX package; that form
    waits for the key-mode tracer (ROADMAP item A4).
    """
    if bwd_tape:
        if not (use_tape and cfg.unbiased):
            raise ValueError("bwd_tape requires use_tape=True and "
                             "cfg.unbiased=True")
        if cfg.bsdf_samples != 1:
            raise ValueError("bwd_tape mode is single-BSDF-sample only "
                             "(a 1-stream tape cannot drive a tree)")
    if not use_tape:
        raise NotImplementedError(
            "the key-driven differentiable renderer is not ported yet: "
            "ROADMAP A4 (key-mode wavefront); pass use_tape=True")

    class DiffTrace(torch.autograd.Function):
        @staticmethod
        def forward(ctx, albedo, emission, ox, oy, oz, dx, dy, dz, tape_f,
                    tape_b):
            ctx.save_for_backward(albedo, emission, ox, oy, oz, dx, dy, dz,
                                  tape_b)
            return tuple(trace_rays(Params(albedo, emission), scene,
                                    V3(ox, oy, oz), V3(dx, dy, dz), cfg,
                                    tape=tape_f))

        @staticmethod
        def backward(ctx, gx, gy, gz):
            albedo, emission, ox, oy, oz, dx, dy, dz, tape_b = \
                ctx.saved_tensors
            params = Params(albedo, emission)
            g = _lane_cotangent(V3(gx, gy, gz), cfg)
            with torch.no_grad():
                _, residuals = trace_rays(params, scene, V3(ox, oy, oz),
                                          V3(dx, dy, dz), cfg, tape=tape_b,
                                          collect=True)
                d = _param_grads(params, scene, residuals, g, ox.dtype)
            return (d.albedo, d.emission) + (None,) * 8

    def diff_trace(params: Params, orig: V3, dir: V3, tape_f, tape_b=None):
        if bwd_tape and tape_b is None:
            raise TypeError("bwd_tape=True takes (params, orig, dir, "
                            "tape_fwd, tape_bwd)")
        if not bwd_tape:
            if tape_b is not None:
                raise TypeError("a second tape needs bwd_tape=True")
            tape_b = tape_f  # biased: replay the forward's samples
        return V3(*DiffTrace.apply(params.albedo, params.emission, *orig,
                                   *dir, tape_f, tape_b))

    return diff_trace


def make_diff_image_renderer(scene: Scene, cam, cfg: RenderConfig,
                             constrain=None):
    """The key-driven image renderer of the JAX package (`render(params,
    rng) -> image`); its rays come from `chunk_rays`, which waits for the
    key-mode tracer."""
    raise NotImplementedError(
        "make_diff_image_renderer is key-driven and not ported yet: "
        "ROADMAP A4 (key-mode wavefront); the differentiable image "
        "renderer of the port is fused.make_fused_image_renderer")
