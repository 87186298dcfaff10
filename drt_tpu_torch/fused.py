"""Image-level renderer over the fused tracer, forward only.

The port of the forward of `drt_tpu.fused.make_fused_image_renderer`:
`render(params, seeds) -> image f32[H, W, 3]` over one launch of the
fused tracer for all spp chunks (internal RNG), or `render(params, cam_u,
tape)` over caller-given uniforms (tape mode). The image carries no
autograd history: the radiative-backprop backward (kernels B2-B4 and
`adjoint.py`) is the next slice (ROADMAP A5, A6).
"""

from __future__ import annotations

import torch

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.megakernel import make_fused_tracer
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table


def seeds_from_generator(gen: torch.Generator) -> torch.Tensor:
    """The i32[2] (camera, bounce) seed pair drawn from `gen`."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen,
                         dtype=torch.int64).to(torch.int32)


def _check_fused_cfg(cfg: RenderConfig) -> None:
    """The fused tracer is the 1-sample-per-vertex estimator
    (pathtracer.hpp:111); per-vertex splitting is a later slice."""
    if cfg.bsdf_samples != 1:
        raise NotImplementedError(
            "bsdf_samples > 1 (per-vertex splitting) comes to the port "
            "with ROADMAP item A12")


def _resolve_fastmath(fastmath, rng: str) -> bool:
    """'auto' -> fast forms for the internal RNG (whose samples are only
    statistically tied to any other renderer), exact forms for tapes."""
    if fastmath == "auto":
        return rng == "internal"
    return bool(fastmath)


def _chunk_img(L: torch.Tensor, spp_c: int, h: int, w: int) -> torch.Tensor:
    """Radiance f[3, N] -> per-pixel chunk image f[H, W, 3]. Rays are
    spp-outer, so the spp mean reduces over the major axis."""
    return L.reshape(3, spp_c, h, w).mean(dim=1).permute(1, 2, 0)


def make_fused_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                              rng: str = "internal",
                              fastmath: bool | str = "auto",
                              plain: bool = False):
    """Build `render(params, seeds: i32[2]) -> image f32[H, W, 3]`
    (rng="internal"; `seeds` from `seeds_from_generator`) or
    `render(params, cam_u: f[2, N], tape: f[D, 3, N]) -> image`
    (rng="tape", N = W*H*spp, spp_chunks == 1).

    The internal RNG renders all `cfg.spp_chunks` chunks in one launch.
    plain=True runs the plain PyTorch twin on the tensors' device.
    """
    _check_fused_cfg(cfg)
    if rng == "tape":
        if cfg.spp_chunks != 1:
            raise ValueError("tape-mode fused renderer requires "
                             "spp_chunks == 1 (one tape per launch)")
        if cfg.unbiased:
            raise ValueError("tape-mode fused renderer is biased-only: "
                             "the tape IS the sample stream")
    fm = _resolve_fastmath(fastmath, rng)
    n_chunks = cfg.spp_chunks if rng == "internal" else 1
    tracer = make_fused_tracer(scene, cam, cfg, rng=rng, fastmath=fm,
                               n_chunks=n_chunks, plain=plain)
    spp_c = cfg.spp // cfg.spp_chunks
    h, w = cfg.height, cfg.width

    @torch.no_grad()
    def render(params: Params, *uniforms) -> torch.Tensor:
        alb = albedo_table(scene, params).contiguous()
        emi = emission_table(scene, params).contiguous()
        return _chunk_img(tracer(alb, emi, *uniforms), spp_c, h,
                          w) / n_chunks

    return render
