"""The early-exit tracer: one CUDA kernel and its plain PyTorch twin.

The port of `drt_tpu.ops.earlyexit.make_earlyexit_tracer`: the fused
tracer (`ops.megakernel.make_fused_tracer`) whose bounce loop is skipped,
from the first bounce on which no ray of a group lives. The TPU kernel
keeps its ray tile's state in VMEM and wraps each bounce in `pl.when` on
the tile's count of live rays. Here the unit of early exit is the path:
the kernel (`drt_earlyexit_trace` in `csrc/fused_tracer.cu`) runs the
exact tracer's queue of (ray slot, chunk) paths, which spends a trip only
on a live bounce, so no thread runs a bounce that no path enters; there
is no `tile_rows`. A dead ray adds nothing, so the radiance is the fused
tracer's (exact variant) and its lockstep loop's bit for bit; the twin
stops the loop when no ray of the whole wavefront lives.

The wrapper `earlyexit_trace` runs the twin for tensors on the CPU and
launches the kernel for CUDA tensors, or raises; its launches count in
`ops.megakernel.launch_counts()` as "earlyexit_tracer".
"""

from __future__ import annotations

import ctypes

import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.renderer import trace_segment
from drt_tpu_torch.scene import Params, Scene


def earlyexit_trace_plain(scene: Scene, cc: mk.CameraConsts,
                          cfg: RenderConfig, alb: torch.Tensor,
                          emi: torch.Tensor, *, seeds=None, cam_u=None,
                          tape=None, n_chunks: int = 1,
                          n_rays: int | None = None,
                          ray_base: int = 0) -> torch.Tensor:
    """The plain twin: `fused_trace_plain`'s chunks with the bounce loop
    left once no ray lives (`renderer.trace_segment(early_exit=True)`).
    Returns radiance f[3, N] summed over the chunks, of the n_rays slots
    from ray_base on."""
    _, pix, smp = mk._slots(cfg, n_rays, ray_base, alb.device)
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    L = None
    for c in range(n_chunks):
        cu, tp = mk._chunk_uniforms(cfg, alb, seeds, cam_u, tape, c, pix,
                                    smp)
        o, d = mk.camera_ray_from_pix(cc, pix, cu[0], cu[1])
        Lc, _, _, _ = trace_segment(params, scene, cfg, 0, cfg.max_depth,
                                    o, d, None, None, tp, early_exit=True)
        Lc = torch.stack(tuple(Lc))
        L = Lc if L is None else L + Lc
    return L


def earlyexit_trace(scene: Scene, table: torch.Tensor, cc: mk.CameraConsts,
                    cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                    *, seeds=None, cam_u=None, tape=None, n_chunks: int = 1,
                    n_rays: int | None = None,
                    ray_base: int = 0) -> torch.Tensor:
    """Radiance f32[3, N] of the early-exit tracer, summed over the
    chunks. CPU tensors run the plain twin; CUDA tensors launch the
    kernel (exact variant, the only one) or raise. The n_rays slots from
    ray_base on, as `megakernel.fused_trace`'s."""
    if mk._device_of("earlyexit_trace", alb) == "cpu":
        return earlyexit_trace_plain(scene, cc, cfg, alb, emi, seeds=seeds,
                                     cam_u=cam_u, tape=tape,
                                     n_chunks=n_chunks, n_rays=n_rays,
                                     ray_base=ray_base)
    dev = alb.device
    tcfg = mk._trace_config(cfg, table, alb, emi, seeds=seeds,
                            n_chunks=n_chunks, n_rays=n_rays,
                            ray_base=ray_base)
    cu_ptr, tape_ptr = mk._uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lib = mk._library()
    out = torch.empty((3, tcfg.n_rays), dtype=torch.float32, device=dev)
    mk._launch(earlyexit_trace, "early-exit tracer", lib.drt_error_string,
               lib.drt_earlyexit_trace, dev, ctypes.byref(tcfg),
               ctypes.byref(mk._camera_struct(cc)), table.data_ptr(),
               alb.data_ptr(), emi.data_ptr(), cu_ptr, tape_ptr,
               out.data_ptr())
    return out


def make_earlyexit_tracer(scene: Scene, cam, cfg: RenderConfig,
                          rng: str = "internal", n_rays: int | None = None,
                          n_chunks: int = 1, plain: bool = False):
    """Build the early-exit tracer with the fused tracer's call forms and
    streams: `trace(alb, emi, seeds)` (rng="internal") or `trace(alb, emi,
    cam_u, u)` (rng="tape") -> radiance f32[3, N], N = n_rays (default one
    chunk's W*H*spp_c). n_chunks > 1 (internal RNG only) runs the spp
    chunks in one launch and sums their radiance per ray slot, as
    `make_fused_tracer` does. `trace(..., ray_base=k * n_rays)` traces
    shard k's slots, as the fused tracer's shards do. The JAX package's
    `tile_base` counts tiles of `tile_rows` x 128 rays, which the port's
    kernels do not have, and no sharded renderer takes the early-exit
    tracer: any other value than 0 raises. plain=True runs the plain twin
    on the tensors' device."""
    mk._check_rng(rng, n_chunks)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else mk.scene_table(scene)

    def trace(alb, emi, *args, ray_base: int = 0, tile_base: int = 0):
        if tile_base != 0:
            raise ValueError(
                "tile_base counts the JAX kernels' tiles of tile_rows x "
                "128 rays; the port's tracers take a ray offset, "
                "ray_base=")
        kw = dict(mk._uniform_kw(rng, args), n_chunks=n_chunks,
                  n_rays=n_rays, ray_base=ray_base)
        if plain:
            return earlyexit_trace_plain(scene, cc, cfg, alb, emi, **kw)
        return earlyexit_trace(scene, table, cc, cfg, alb, emi, **kw)

    return trace


mk.register_wrappers(earlyexit_tracer=earlyexit_trace)
