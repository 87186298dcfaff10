"""Gradient images and forward-mode gradient checking: the port of
`drt_tpu.gradcheck`.

The reference validates its per-pixel gradient image d(pixel)/d(red-wall
albedo), rendered by its reverse-mode tape, against a dual-number
(forward-mode) render (reference: README.md:138-145; dual.hpp:10-72, used
at src/render.cpp:22-23). Here:

- `grad_image`: the radiative-backprop gradient image. One retrace per spp
  chunk; the reverse suffix sweep keeps the per-ray gradient d L_c / d
  theta_{row,c} instead of summing it into parameter rows (transport is
  componentwise, so the per-channel diagonal is the whole Jacobian). Plain
  PyTorch: no TPU kernel computes it.
- `grad_image_fwd`: the same image by `torch.func.jvp` through the plain
  `renderer.render_image` with a one-hot tangent, the analogue of the
  reference's Dual<double> render.
- `check_gradients`: <vjp grad, v> == jvp tangent on random directions,
  the VJP of `adjoint.make_diff_image_renderer` (the wavefront adjoint
  kernel when the scene is on the card) against forward mode through the
  plain renderer.

In biased mode (the same seeds forward and backward) the two images agree
to rounding by the AD identity; `python -m drt_tpu_torch.cli grad-image`
renders and writes both.
"""

from __future__ import annotations

import numpy as np
import torch

from drt_tpu_torch.adjoint import make_diff_image_renderer
from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.vecmath import V3, gatherv
from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                    chunk_sample_ids, lane_count,
                                    render_image, trace_rays)
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table


def _parse_param(params: Params, param: str):
    """'albedo:0' -> ('albedo', 0), validated against the param shapes."""
    name, _, row_s = param.partition(":")
    row = int(row_s) if row_s else 0
    if name not in ("albedo", "emission"):
        raise ValueError(f"unknown parameter {name!r} "
                         "(expected albedo or emission)")
    n_rows = getattr(params, name).shape[0]
    if not 0 <= row < n_rows:
        raise ValueError(f"{name} row {row} out of range [0, {n_rows})")
    return name, row


def _check_biased(cfg: RenderConfig, what: str) -> None:
    if cfg.unbiased:
        raise ValueError(
            f"{what} is the biased (seed-replay) gradient, which equals "
            "forward-mode AD of the estimator; an unbiased-mode gradient is "
            "a different estimator with no matching jvp ground truth: set "
            "unbiased=False")


def grad_image(scene: Scene, cam: Camera, cfg: RenderConfig,
               params: Params, seeds, param: str = "albedo:0"
               ) -> torch.Tensor:
    """d(image)/d(params.<name>[row]) as f[H, W, 3] by radiative backprop:
    channel c is d(pixel_c)/d(theta_{row,c}) (transport never mixes
    channels, pathtracer.hpp:97-114). Replays the forward's seeds, so it
    equals forward-mode AD of the image rendered with the same seeds
    (`grad_image_fwd`). At bsdf_samples > 1 the sweep runs on each ray's
    `lane_count(cfg)` lanes and a pixel's gradient is the mean over its
    spp_c * M lanes (drt_tpu/gradcheck.py's `pdf_l`)."""
    name, row = _parse_param(params, param)
    _check_biased(cfg, "grad_image")
    dtype = cam.forward.dtype
    w, h = cfg.width, cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    M = lane_count(cfg)
    xy_rep = chunk_pixel_ids(cfg, cam.forward.device)
    albedo_tab = albedo_table(scene, params).to(dtype)
    emission_tab = emission_table(scene, params).to(dtype)

    images = []
    with torch.no_grad():
        for c in range(cfg.spp_chunks):
            pix, s = chunk_sample_ids(cfg, xy_rep, c)
            o, d, pdf = chunk_rays(cam, cfg, xy_rep, seeds, c)
            _, res = trace_rays(params, scene, o, d, cfg, collect=True,
                                seeds=seeds, pix=pix, sample=s)
            # Reverse suffix sweep (adjoint._param_grads), the row's
            # per-ray gradient kept:
            #   d L_c/d albedo_{k,c}   = sum_b P_b sc_b S_{b+1} [aid_b = k]
            #   d L_c/d emission_{l,c} = sum_b P_b [eid_b = l]
            # Lanes are ray-major, a pixel's spp_c * M lanes contiguous.
            pdf_l = pdf.repeat_interleave(M)
            zero = torch.zeros_like(pdf_l)
            S = acc = V3(zero, zero, zero)
            for b in reversed(range(cfg.max_depth)):
                P = V3(res.P.x[b], res.P.y[b], res.P.z[b])
                sc, gate = res.sc[b], res.gate[b]
                aid, eid = res.aid[b], res.eid[b]
                if name == "albedo":
                    acc = acc + P * (sc * (aid == row).to(dtype)) * S
                else:
                    acc = acc + P * (eid == row).to(dtype)
                e = gatherv(emission_tab, eid)
                w_b = gatherv(albedo_tab, aid) * sc
                S = (e + w_b * S) * gate
            images.append(torch.stack(
                [(ch / pdf_l).reshape(h, w, spp_c * M).mean(dim=2)
                 for ch in acc],
                dim=-1))
    if len(images) == 1:
        return images[0]
    return torch.stack(images).mean(dim=0)


def grad_image_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
                   params: Params, seeds, param: str = "albedo:0"
                   ) -> torch.Tensor:
    """The same gradient image by forward-mode AD (`torch.func.jvp`)
    through the plain `render_image`, the reference's Dual<double> render
    (dual.hpp:10-72) in one tangent pass: the tangent is ones on the
    chosen row, and since transport is channel-diagonal the jvp output is
    the per-channel gradient image."""
    name, row = _parse_param(params, param)
    _check_biased(cfg, "grad_image_fwd")
    one_row = torch.zeros_like(getattr(params, name))
    one_row[row] = 1.0
    tangent = Params(torch.zeros_like(params.albedo),
                     torch.zeros_like(params.emission))._replace(
                         **{name: one_row})
    _, g_img = torch.func.jvp(
        lambda p: render_image(p, scene, cam, seeds, cfg), (params,),
        (tangent,))
    return g_img


def check_gradients(scene: Scene, cam: Camera, cfg: RenderConfig,
                    params: Params, seeds, n_directions: int = 4,
                    seed: int = 0, rtol: float = 1e-4, atol: float = 1e-8):
    """Check the radiative-backprop VJP against forward-mode AD on random
    tangent directions v: <grad L, v> must equal the jvp tangent of the
    same scalar loss L = sum(image) (the reference's dual-number
    validation, README.md:138-145, as a utility). The VJP is that of
    `adjoint.make_diff_image_renderer` (the wavefront adjoint kernel for
    a scene on the card); the jvp goes through the plain `render_image`.

    Returns a list of (dot, tangent) pairs; raises AssertionError on a
    mismatch. Biased mode only (unbiased is a different estimator whose
    expectation, not value, matches)."""
    _check_biased(cfg, "check_gradients")
    diff = make_diff_image_renderer(scene, cam, cfg)
    leaves = Params(*(p.detach().clone().requires_grad_() for p in params))
    grad = Params(*torch.autograd.grad(diff(leaves, seeds).sum(), leaves))

    def loss_ad(p):
        return render_image(p, scene, cam, seeds, cfg).sum()

    results = []
    rand = np.random.default_rng(seed)
    for _ in range(n_directions):
        v = Params(*(torch.as_tensor(rand.normal(size=tuple(p.shape)),
                                     dtype=p.dtype, device=p.device)
                     for p in params))
        _, tangent = torch.func.jvp(loss_ad, (params,), (v,))
        dot = (torch.sum(grad.albedo * v.albedo)
               + torch.sum(grad.emission * v.emission))
        np.testing.assert_allclose(float(dot), float(tangent), rtol=rtol,
                                   atol=atol)
        results.append((float(dot), float(tangent)))
    return results
