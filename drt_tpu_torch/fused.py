"""Image-level differentiable renderer over the fused kernels.

The port of `drt_tpu.fused.make_fused_image_renderer`: `render(params,
seeds) -> image f32[H, W, 3]` over one launch of the fused tracer for all
spp chunks (internal RNG), or `render(params, cam_u, tape)` over
caller-given uniforms (tape mode), differentiable in `params` by radiative
backprop as a `torch.autograd.Function` (reference semantics:
include/drt/integrate.hpp:11-52; biased mode replays the forward's sample
streams, unbiased mode redraws the bounce stream and keeps the primary
rays).

The backward is one of two kernels. adjoint="stored": the forward is the
collect tracer, which writes 8 bytes per bounce-ray of residuals, and the
backward is the sweep adjoint over them. adjoint="retrace": the forward
keeps only (params, seeds) and the backward traces again inside the
retrace adjoint kernel; the only form unbiased mode can take. When no
parameter requires grad, or under `torch.no_grad()`, the forward is the
plain tracer and nothing is kept.

The internal RNG is the keyed hash of `ops.rng`: chunk c draws sample
indices from `c * spp_c` on (where the TPU kernels step their seed words
per chunk), so `drt_tpu.ops.regen.hash_tapes` rebuilds every sample.

`make_split_fused_image_renderer` and `make_split_dyn_image_renderer` are
the ports of the JAX package's lane-splitting renderers (bsdf_samples >
1): the tape-mode kernels of both families on each chunk's camera
samples split into M leaf lanes, their prefix-shared draws made in
tensor ops (`split_prefix_tape`).

`make_regen_image_renderer` and `make_dyn_regen_image_renderer` are the
ports of the JAX package's regeneration renderers over `ops.regen` and
`ops.dynregen`: the same samples, one thread per pixel.

`make_sharded_fused_image_renderer`, `make_sharded_dyn_image_renderer`,
`make_sharded_split_image_renderer`, `make_sharded_regen_image_renderer`
and `make_sharded_dyn_regen_image_renderer` run the same renderers over
a device mesh (`parallel.mesh`): each shard launches the kernels on its
contiguous range of every launch's slots from its global offset
(`ray_base`), the per-slot radiance is gathered in global order, so the
image is the one device's bit for bit, and the shards' gradient
partials are summed (`_shard_kernels`).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
import warnings

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.megakernel import (make_fused_adjoint,
                                          make_fused_collect_tracer,
                                          make_fused_sweep_adjoint,
                                          make_fused_tracer)
from drt_tpu_torch.ops.rng import camera_draws, prefix_tape
from drt_tpu_torch.renderer import lane_count, one_lane
from drt_tpu_torch.scene import Params, Scene, albedo_table, emission_table

# Bounce-seed offsets of the unbiased backward (drt_tpu/fused.py:45-46).
_BWD_SALT = 0x0ADD
_BWD_SAMPLE_STRIDE = 0x51ED  # per-adjoint-sample seed offset

# The stored adjoint keeps the residuals of all spp chunks from the forward
# to the backward, beside the radiance buffer and whatever else the caller
# holds on the card. It may take a quarter of the device's total memory
# (the total, not what is free now, so the choice is the same from run to
# run): the paired loss of `optim` holds two renders' residuals at once,
# which leaves half the card for everything else. A CPU tensor has no
# device to ask; 4 GiB keeps test-sized renders stored.
_STORED_SHARE = 0.25
_STORED_BUDGET_CPU_BYTES = 4 << 30


def seeds_from_generator(gen: torch.Generator) -> torch.Tensor:
    """The i32[2] (camera, bounce) seed pair drawn from `gen`."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen,
                         dtype=torch.int64).to(torch.int32)


def stored_budget_bytes(device) -> int:
    """What the stored adjoint's residuals may take on `device`."""
    device = torch.device(device)
    if device.type != "cuda":
        return _STORED_BUDGET_CPU_BYTES
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * _STORED_SHARE)


def stored_bytes(cfg: RenderConfig) -> int:
    """The residual footprint of one render: 8 bytes (sc f32, best i32)
    per bounce-lane over all chunks, with no padding; a ray is
    `lane_count(cfg)` lanes (one without per-vertex splitting)."""
    n = cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks)
    return n * lane_count(cfg) * cfg.spp_chunks * cfg.max_depth * 8


def _resolve_adjoint(cfg: RenderConfig, adjoint: str, device="cpu",
                     share: float = 1.0) -> str:
    """'auto' -> 'stored' (the forward writes the (sc, best) residuals,
    the backward is a cheap reverse sweep) when the mode is biased and
    `stored_bytes(cfg)` (times `share`, the part of them one device of a
    mesh holds) fits `stored_budget_bytes(device)`: a quarter of the
    device's total memory, see `_STORED_SHARE`; 'retrace' otherwise.
    The unbiased adjoint needs fresh retraces (integrate.hpp:11-24)."""
    if adjoint not in ("auto", "stored", "retrace"):
        raise ValueError(f"unknown adjoint mode {adjoint!r}")
    if adjoint == "auto":
        if cfg.unbiased:
            return "retrace"
        fits = stored_bytes(cfg) * share <= stored_budget_bytes(device)
        return "stored" if fits else "retrace"
    if adjoint == "stored" and cfg.unbiased:
        raise ValueError("adjoint='stored' replays the forward's stream; "
                         "unbiased mode requires retrace "
                         "(integrate.hpp:11-24)")
    return adjoint


def _check_fused_cfg(cfg: RenderConfig) -> None:
    """The fused kernels' own RNG is the 1-sample-per-vertex estimator
    (pathtracer.hpp:111); per-vertex splitting feeds them a prefix-shared
    tape (`make_split_fused_image_renderer`)."""
    if cfg.bsdf_samples != 1:
        raise ValueError("bsdf_samples > 1 (per-vertex splitting) runs on "
                         "the 'cuda-split' / 'cuda-split-dyn' backends "
                         "(their plain versions 'torch-split' / "
                         "'torch-split-dyn') or the wavefront")


def _resolve_fastmath(fastmath, rng: str) -> bool:
    """'auto' -> fast forms for the internal RNG (whose samples are only
    statistically tied to any other renderer), exact forms for tapes."""
    if fastmath == "auto":
        return rng == "internal"
    return bool(fastmath)


def _slice_dparams(params: Params, da, de) -> Params:
    k = params.albedo.shape[0]
    l = params.emission.shape[0]
    return Params(albedo=da[:k].to(params.albedo.dtype),
                  emission=de[:l].to(params.emission.dtype))


def _chunk_img(L: torch.Tensor, spp_c: int, h: int, w: int) -> torch.Tensor:
    """Radiance f[3, N] -> per-pixel chunk image f[H, W, 3]. Rays are
    spp-outer, so the spp mean reduces over the major axis."""
    return L.reshape(3, spp_c, h, w).mean(dim=1).permute(1, 2, 0)


def _g_pix_of(g: torch.Tensor, spp_c: int, n_chunks: int,
              dtype) -> torch.Tensor:
    """Image cotangent f[H, W, 3] -> per-pixel ray cotangent f[3, W*H]:
    image = mean over chunks of per-pixel spp_c means, so every ray of a
    pixel gets g[pixel] / (spp_c * n_chunks), in every chunk."""
    g_pix = (g / (spp_c * n_chunks)).to(dtype)
    return g_pix.permute(2, 0, 1).reshape(3, -1).contiguous()


def _g_ray_of(g: torch.Tensor, spp_c: int, n_chunks: int,
              dtype) -> torch.Tensor:
    """Image cotangent -> per-ray cotangent f[3, N] for one chunk (ray i
    covers pixel i % (W*H), spp-outer order). The adjoint kernels and
    twins also take `_g_pix_of`'s per-pixel form and index it themselves,
    which is what the renderers hand them."""
    return _g_pix_of(g, spp_c, n_chunks, dtype).repeat(1, spp_c)


def _salted(seeds, sample: int):
    """The seed pair of adjoint sample `sample` in unbiased mode: a fresh
    bounce stream, the same camera stream (integrate.hpp:39-52). The add
    wraps mod 2^32 as the reference's i32 add does."""
    s0, s1 = (int(v) for v in
              (seeds.tolist() if torch.is_tensor(seeds) else seeds))
    salt = _BWD_SALT + sample * _BWD_SAMPLE_STRIDE
    return [s0 & 0xFFFFFFFF, (s1 + salt) & 0xFFFFFFFF]


def _wants_grad(params: Params) -> bool:
    return torch.is_grad_enabled() and (params.albedo.requires_grad
                                        or params.emission.requires_grad)


def _sum(parts):
    """parts[0] + parts[1] + ..., in order."""
    return functools.reduce(operator.add, parts)


def _save(ctx, albedo, emission, rows=()) -> None:
    """Keep (albedo, emission) and the forward's residual rows (lists,
    tuples and per-shard dicts of tensors) with `save_for_backward`: the
    backward frees them, and saved-tensor hooks see them."""
    leaves, ctx.rows_spec = tree_flatten(rows)
    ctx.save_for_backward(albedo, emission, *leaves)


def _saved(ctx):
    """(albedo, emission, rows) as `_save` kept them."""
    albedo, emission, *leaves = ctx.saved_tensors
    return albedo, emission, tree_unflatten(leaves, ctx.rows_spec)


def _build_renderer(scene: Scene, cfg: RenderConfig, adjoint: str,
                    trace_fn, collect_fn, sweep_fn, adj_fn,
                    per_chunk: bool = False):
    """`render(params, *uniforms) -> image` with the radiative-backprop
    backward. Without per_chunk, one launch of each kernel callable takes
    `uniforms` as given: (seeds,) for the internal RNG, which covers
    every chunk, or (cam_u, tape). With per_chunk (the lane-splitting
    renderers) `uniforms` is (seeds,) and chunk c is a launch of its own
    on (seeds, c), whose callables draw the chunk's tape, `lane_count(cfg)`
    lanes a camera sample; the stored form keeps every chunk's residuals,
    the retrace form draws each chunk's tape again in the backward. The
    image is the mean over chunks of each pixel's spp_c * M lanes, so the
    adjoints take every lane's cotangent g[pixel] / (spp_c * M * chunks)
    in `_g_pix_of`'s per-pixel form. collect_fn returns (L, *rows), which
    the forward keeps for sweep_fn(alb, emi, *rows, g)."""
    w, h = cfg.width, cfg.height
    n_chunks = cfg.spp_chunks
    spp_l = cfg.spp // n_chunks * lane_count(cfg)
    n_adj = cfg.adjoint_samples if cfg.unbiased else 1
    n_launch = n_chunks if per_chunk else 1

    def launch(uniforms, c):
        return (uniforms[0], c) if per_chunk else uniforms

    def tables(albedo, emission):
        params = Params(albedo, emission)
        return (albedo_table(scene, params).contiguous(),
                emission_table(scene, params).contiguous())

    def image(L):
        return _chunk_img(L, spp_l, h, w) / n_chunks

    def trace(alb, emi, uniforms):
        return _sum([image(trace_fn(alb, emi, *launch(uniforms, c)))
                     for c in range(n_launch)])

    class Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, albedo, emission, *uniforms):
            alb, emi = tables(albedo, emission)
            ctx.n_uniforms = len(uniforms)
            if adjoint != "stored":
                _save(ctx, albedo, emission)
                ctx.uniforms = uniforms  # seeds, or the caller's tapes
                return trace(alb, emi, uniforms)
            images, rows = [], []
            for c in range(n_launch):
                L, *rows_c = collect_fn(alb, emi, *launch(uniforms, c))
                images.append(image(L))
                rows.append(rows_c)
            _save(ctx, albedo, emission, rows)
            return _sum(images)

        @staticmethod
        def backward(ctx, g):
            albedo, emission, rows = _saved(ctx)
            params = Params(albedo, emission)
            alb, emi = tables(albedo, emission)
            g_pix = _g_pix_of(g, spp_l, n_chunks, alb.dtype)
            if adjoint == "stored":
                da, de = (_sum(d) for d in zip(*(
                    sweep_fn(alb, emi, *rows_c, g_pix) for rows_c in rows)))
            else:
                da = de = 0.0
                for s in range(n_adj):
                    uniforms = ctx.uniforms
                    if cfg.unbiased:
                        uniforms = (_salted(uniforms[0], s),)
                    for c in range(n_launch):
                        da_s, de_s = adj_fn(alb, emi, *launch(uniforms, c),
                                            g_pix)
                        da = da + da_s / n_adj
                        de = de + de_s / n_adj
            d = _slice_dparams(params, da, de)
            return (d.albedo, d.emission) + (None,) * ctx.n_uniforms

    def render(params: Params, *uniforms) -> torch.Tensor:
        if _wants_grad(params):
            return Render.apply(params.albedo, params.emission, *uniforms)
        with torch.no_grad():
            return trace(*tables(*params), uniforms)

    return render


def _on(dev, *tensors):
    return tuple(t.to(dev) for t in tensors)


def _shard_kernels(mesh, n: int, home, fns, tape: bool):
    """A family's kernel callables `fns` = (trace, collect, sweep, adjoint),
    made for n // mesh.size slots, run on each of this process's shards of
    `mesh` with the shard's ray_base (`parallel.mesh.ray_range` of n
    slots: rays of a chunk, lanes, or pixels), with the same signatures:
    trace's per-slot output (the first of a tuple) gathered in global
    order on `home`; collect's rows kept per shard, its radiance gathered;
    sweep and adjoint on each shard's slots of the per-pixel cotangent,
    their partials summed (`parallel.mesh.sum_partials`). tape: the
    uniforms are the caller's global (cam_u, tape), sliced per shard;
    otherwise (seeds, ...) reach every shard as they are."""
    from drt_tpu_torch.parallel.mesh import (gather, per_shard, sum_partials,
                                             take)

    trace_fn, collect_fn, sweep_fn, adj_fn = fns

    def uniforms_of(uniforms, a, b, dev):
        if not tape:
            return uniforms
        return tuple(take(u, a, b, dev) for u in uniforms)

    def g_of(g, a, b, dev):
        """Slots [a, b) of the per-pixel cotangent f[3, W*H]: slot i
        covers pixel i % (W*H) (rays and lanes are spp-outer)."""
        idx = torch.arange(a, b, device=g.device) % g.shape[1]
        return g[:, idx].to(dev).contiguous()

    def forward(fn):
        """The tracer or collect tracer fn on every shard: its per-slot
        output gathered, and with a tuple the rest kept per shard."""
        def run(alb, emi, *uniforms):
            outs = per_shard(mesh, n, lambda k, a, b, dev: fn(
                *_on(dev, alb, emi), *uniforms_of(uniforms, a, b, dev),
                ray_base=a))
            if not isinstance(outs[min(outs)], tuple):
                return gather(mesh, outs, home)
            return (gather(mesh, {k: o[0] for k, o in outs.items()}, home),
                    {k: o[1:] for k, o in outs.items()})
        return run

    def sweep(alb, emi, rows, g):
        return sum_partials(mesh, per_shard(
            mesh, n, lambda k, a, b, dev: sweep_fn(
                *_on(dev, alb, emi), *rows[k], g_of(g, a, b, dev))), home)

    def adjoint(alb, emi, *args):
        *uniforms, g = args
        return sum_partials(mesh, per_shard(
            mesh, n, lambda k, a, b, dev: adj_fn(
                *_on(dev, alb, emi), *uniforms_of(uniforms, a, b, dev),
                g_of(g, a, b, dev), ray_base=a)), home)

    return (forward(trace_fn), forward(collect_fn) if collect_fn else None,
            sweep if sweep_fn else None, adjoint if adj_fn else None)


def _mesh_share(mesh) -> float:
    """The part of a render's residuals the busiest device of `mesh`
    holds (1 without a mesh)."""
    if mesh is None:
        return 1.0
    mine = [mesh.devices[k] for k in mesh.local_shards()]
    return max(mine.count(d) for d in mine) / mesh.size


def split_chunk_cfg(cfg: RenderConfig) -> RenderConfig:
    """The kernels' config of one chunk of a lane-splitting config:
    `one_lane(cfg)` whose rays are the chunk's n_lanes = W*H*spp_c * M,
    spp = spp_c * M in one chunk (drt_tpu/fused.py:533-547 does the
    same)."""
    return dataclasses.replace(
        one_lane(cfg), spp=cfg.spp // cfg.spp_chunks * lane_count(cfg),
        spp_chunks=1)


def _make_image_renderer(factories, scene: Scene, kernel_scene, cam: Camera,
                         cfg: RenderConfig, rng: str, adjoint: str, fastmath,
                         plain: bool, differentiable: bool, tape_fn=None,
                         mesh=None):
    """The image renderer over one kernel family: `factories` are its
    (tracer, collect tracer, sweep adjoint, retrace adjoint) makers and
    `kernel_scene` what they take for the scene. rng="split" is the
    lane-splitting renderer: the makers' tape forms built for
    `split_chunk_cfg(cfg)`, one launch a chunk on the chunk's lanes'
    draws (by default `split_prefix_tape`'s; tape_fn(seeds, chunk) gives
    the whole chunk's instead). With a mesh each shard launches the
    kernels on its slots of every launch (`_shard_kernels`): a chunk's
    rays, or lanes, split into mesh.size contiguous ranges."""
    make_tracer, make_collect, make_sweep, make_adjoint = factories
    if rng == "split":
        _check_split_cfg(cfg)
        cfg_k, rng_k = split_chunk_cfg(cfg), "tape"
    else:
        _check_fused_cfg(cfg)
        if rng == "tape":
            if cfg.spp_chunks != 1:
                raise ValueError("tape-mode fused renderer requires "
                                 "spp_chunks == 1 (one tape per launch)")
            if cfg.unbiased:
                raise ValueError("tape-mode fused renderer is biased-only: "
                                 "the tape IS the sample stream")
        cfg_k, rng_k = cfg, rng
    n = cfg_k.width * cfg_k.height * (cfg_k.spp // cfg_k.spp_chunks)
    n_local = n
    if mesh is not None:
        from drt_tpu_torch.parallel.mesh import local_count

        n_local = local_count(n, mesh, "lanes per chunk" if rng == "split"
                              else "rays per chunk")
    adjoint = _resolve_adjoint(cfg, adjoint, scene.device, _mesh_share(mesh))
    k_chunks = cfg.spp_chunks if rng_k == "internal" else 1
    kw = dict(rng=rng_k, fastmath=_resolve_fastmath(fastmath, rng_k),
              n_chunks=k_chunks, plain=plain, n_rays=n_local)
    fns = [make_tracer(kernel_scene, cam, cfg_k, **kw), None, None, None]
    if differentiable and adjoint == "stored":
        fns[1] = make_collect(kernel_scene, cam, cfg_k, **kw)
        fns[2] = make_sweep(kernel_scene, cfg_k, n_chunks=k_chunks,
                            plain=plain, n_rays=n_local)
    elif differentiable:
        fns[3] = make_adjoint(kernel_scene, cam, cfg_k, **kw)
    if rng == "split":  # the sweep (fns[2]) reads rows, not draws
        fns = [f if k == 2 or f is None else _drawn(f, cfg, n_local, tape_fn)
               for k, f in enumerate(fns)]
    if mesh is not None:
        fns = _shard_kernels(mesh, n, scene.device, fns, rng == "tape")
    render = _build_renderer(scene, cfg, adjoint, *fns,
                             per_chunk=rng == "split")
    if differentiable:
        return render
    return torch.no_grad()(render)


def _drawn(fn, cfg: RenderConfig, n_local: int, tape_fn=None):
    """A tape-form kernel callable `fn(alb, emi, cam_u, tape, *rest,
    ray_base=)` of the lane-splitting renderers as `run(alb, emi, seeds,
    chunk, *rest, ray_base=0)`: it draws the chunk's lanes [ray_base,
    ray_base + n_local) (`split_prefix_tape`; or slices them from
    tape_fn(seeds, chunk)) on the tables' device and launches on them."""
    def run(alb, emi, seeds, chunk, *rest, ray_base: int = 0):
        lanes = (ray_base, ray_base + n_local)
        if tape_fn is None:
            cam_u, tape = split_prefix_tape(seeds, chunk, cfg, alb.device,
                                            alb.dtype, lanes=lanes)
        else:
            cam_u, tape = (u[..., lanes[0]:lanes[1]].to(alb.device)
                           .contiguous() for u in tape_fn(seeds, chunk))
        return fn(alb, emi, cam_u, tape, *rest, ray_base=ray_base)

    return run


def make_fused_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                              rng: str = "internal", adjoint: str = "auto",
                              fastmath: bool | str = "auto",
                              plain: bool = False,
                              differentiable: bool = True):
    """Build `render(params, seeds: i32[2]) -> image f32[H, W, 3]`
    (rng="internal"; `seeds` from `seeds_from_generator`) or
    `render(params, cam_u: f[2, N], tape: f[D, 3, N]) -> image`
    (rng="tape", N = W*H*spp, spp_chunks == 1, biased only: the tape is
    the sample stream). Differentiable in params.

    The internal RNG runs all `cfg.spp_chunks` chunks in one launch of
    each kernel: a forward+backward step is two launches (stored) or
    1 + adjoint_samples (retrace).

    adjoint: "stored" writes the (sc, best) residuals in the forward and
    makes the backward a reverse sweep over them; "retrace" rebuilds them
    by tracing again in the adjoint kernel (no extra memory, the only
    form for unbiased mode); both give the same gradient bits. "auto"
    takes stored when the mode is biased and the residuals fit
    (`_resolve_adjoint`).
    plain=True runs the plain PyTorch twins on the tensors' device.
    differentiable=False renders under `torch.no_grad()` whatever the
    params ask for.
    """
    return _make_image_renderer(_FUSED_FACTORIES, scene, scene, cam, cfg,
                                rng, adjoint, fastmath, plain,
                                differentiable)


def make_dyn_image_renderer(scene, cam: Camera, cfg: RenderConfig,
                            rng: str = "internal", adjoint: str = "auto",
                            fastmath: bool | str = "auto",
                            plain: bool = False,
                            differentiable: bool = True):
    """`make_fused_image_renderer` over the memory-resident kernels
    (`ops.dynkernel`): the same `render(params, seeds)` or `render(params,
    cam_u, tape)`, RNG streams, adjoint modes and unbiased reseed, for
    scenes of up to `MAX_DYN_SHAPES` shapes (triangle meshes), or whose
    values change often. `scene` is a Scene or a prebuilt `DynScene`
    (for a `cluster_k` of the caller's own). plain=True runs the plain
    PyTorch versions (the "torch-dyn" backend)."""
    from drt_tpu_torch.ops.dynkernel import DynScene

    ds = DynScene.of(scene)
    return _make_image_renderer(_dyn_factories(), ds.scene, ds, cam, cfg,
                                rng, adjoint, fastmath, plain,
                                differentiable)


def split_prefix_tape(seeds, chunk: int, cfg: RenderConfig,
                      device=None, dtype=torch.float32, lanes=None):
    """One spp chunk's uniforms for the lane-splitting renderers: (cam_u
    f[2, n_lanes], tape f[D, 3, n_lanes]), n_lanes = W*H*spp_c * M,
    lanes M-outer (lane m * n_cam + ray, the rays spp-outer as the fused
    kernels lay them, so that a lane's pixel is lane % (W*H)). Chunk c's
    ray j * W*H + p is sample c * spp_c + j of pixel p; its M lanes share
    the camera draws `camera_draws(seeds[0], p, sample)` and take their
    bounce draws from `ops.rng.prefix_tape` under seeds[1]: lanes of one
    path prefix read the same draws, so the per-lane tracer gives the
    recursive n-sample tree estimator (drt_tpu/fused.py:split_prefix_tape
    draws the same pattern from threefry). At M = 1 these are
    `hash_tapes` of the chunk. Deterministic in (seeds, chunk): the
    retrace backward draws it again. lanes=(start, stop) draws those
    lanes alone (a shard's; `prefix_tape(..., lanes=)`), bit for bit the
    slice [start, stop) of the whole chunk's."""
    M = lane_count(cfg)
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    n_cam = npix * spp_c
    start, stop = (0, n_cam * M) if lanes is None else lanes
    words = [int(v) for v in (seeds.tolist() if torch.is_tensor(seeds)
                              else seeds)]
    i = torch.arange(n_cam, dtype=torch.int64, device=device)
    pix = i % npix
    s = chunk * spp_c + i // npix
    m_lo, m_hi = start // n_cam, -(-stop // n_cam)  # the leaves crossed
    cam_u = camera_draws(words[0], pix, s, dtype).repeat(1, m_hi - m_lo)[
        :, start - m_lo * n_cam:stop - m_lo * n_cam].contiguous()
    tape = prefix_tape(words[1], pix, s, cfg.bsdf_samples, cfg.max_depth,
                       dtype, lanes_outer=True, n_samples=cfg.spp,
                       lanes=(start, stop))
    return cam_u, tape


def _check_split_cfg(cfg: RenderConfig) -> None:
    if cfg.bsdf_samples < 2:
        raise ValueError("use make_fused_image_renderer / "
                         "make_dyn_image_renderer for bsdf_samples == 1")
    if cfg.unbiased:
        raise ValueError("fused splitting is biased-only (the tape IS the "
                         "sample stream); the 'cuda-wavefront' backend "
                         "keeps unbiased splitting gradients")


def make_split_fused_image_renderer(scene: Scene, cam: Camera,
                                    cfg: RenderConfig, adjoint: str = "auto",
                                    plain: bool = False,
                                    differentiable: bool = True,
                                    tape_fn=None):
    """bsdf_samples > 1 on the fused kernels: the per-vertex tree-splitting
    estimator (the reference integration operator's n_samples at every
    scatter, integrate.hpp:56-66 via pathtracer.hpp:96-112) as M =
    bsdf_samples^(max_depth-1) leaf lanes per camera sample. Returns
    `render(params, seeds: i32[2]) -> image f32[H, W, 3]`, differentiable
    in params (biased mode only: the tape is the sample stream).

    The kernels are lane-oblivious: each chunk's prefix-shared uniforms
    (`split_prefix_tape`, lanes M-outer) feed the tape-mode tracer B1 (a
    forward), the collect tracer B2 and sweep B3 (adjoint="stored") or
    B1 and the retrace adjoint B4 ("retrace"), one launch of each per
    chunk; both give the same gradient bits. "auto" takes stored when the
    residuals of all chunks fit (`_resolve_adjoint`). plain=True
    runs their plain versions on the tensors' device (the "torch-split"
    backend); differentiable=False renders under `torch.no_grad()`.
    tape_fn(seeds, chunk) -> (cam_u, tape) replaces `split_prefix_tape`
    (the tests feed the JAX package's draws)."""
    return _make_image_renderer(_FUSED_FACTORIES, scene, scene, cam, cfg,
                                "split", adjoint, False, plain,
                                differentiable, tape_fn)


def make_split_dyn_image_renderer(scene, cam: Camera, cfg: RenderConfig,
                                  adjoint: str = "auto", plain: bool = False,
                                  differentiable: bool = True,
                                  tape_fn=None):
    """`make_split_fused_image_renderer` over the memory-resident kernels
    (`ops.dynkernel`: B6, B7 + B8 stored, B6 + B9 retrace) for scenes of
    up to `MAX_DYN_SHAPES` shapes. `scene` is a Scene or a prebuilt
    `DynScene`; plain=True is the "torch-split-dyn" backend."""
    from drt_tpu_torch.ops.dynkernel import DynScene

    ds = DynScene.of(scene)
    return _make_image_renderer(_dyn_factories(), ds.scene, ds, cam, cfg,
                                "split", adjoint, False, plain,
                                differentiable, tape_fn)


def _check_regen_cfg(cfg: RenderConfig, adjoint: str, device,
                     share: float = 1.0) -> str:
    """The regeneration renderers' limits, and the adjoint they take:
    biased mode only (the stored or replayed keyed streams ARE the
    sample). The residual footprint is the lockstep one (`stored_bytes`:
    t_cap rows per pixel and chunk), so 'auto' resolves as there."""
    _check_fused_cfg(cfg)
    if cfg.unbiased:
        raise ValueError(
            "the regen renderer is biased-only (stored/replayed keyed "
            "streams); use the lockstep cuda or cuda-dyn backend for "
            "unbiased gradients (integrate.hpp:11-24)")
    return _resolve_adjoint(cfg, adjoint, device, share)


def _build_regen_renderer(scene: Scene, cfg: RenderConfig, adjoint: str,
                          trace_fn, collect_fn, sweep_fn, n_chunks: int,
                          bwd_chunks: int):
    """`render(params, seeds) -> image` over a regeneration kernel family
    (drt_tpu/fused.py:_build_regen_renderer):
      trace_fn(alb, emi, seeds, sample_base) -> (L f[3, n_pix], trips)
      collect_fn(...) -> (L, *rows): (L, rsc, rows, trips)
      sweep_fn(alb, emi, *rows, g f[3, n_pix]) -> (da, de)
    n_chunks == cfg.spp_chunks: the tracer covers every chunk in one
    launch; n_chunks == 1: a host loop of cfg.spp_chunks launches with
    sample_base = c * spp_c. bwd_chunks is the same switch for the collect
    and sweep pair; the retrace backward keeps it at 1, so that one
    chunk's residuals are alive at a time."""
    w, h = cfg.width, cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    assert n_chunks in (1, cfg.spp_chunks)
    assert bwd_chunks in (1, cfg.spp_chunks)

    def tables(albedo, emission):
        params = Params(albedo, emission)
        return (albedo_table(scene, params).contiguous(),
                emission_table(scene, params).contiguous())

    def image(L):
        return L.reshape(3, h, w).permute(1, 2, 0) / cfg.spp

    def bases(chunks):
        """sample_base of each launch that together cover all chunks."""
        if chunks == cfg.spp_chunks:
            return (0,)
        return tuple(c * spp_c for c in range(cfg.spp_chunks))

    def trace(alb, emi, seeds):
        L = 0.0
        for sb in bases(n_chunks):
            L = L + trace_fn(alb, emi, seeds, sb)[0]
        return L

    class Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, albedo, emission, seeds):
            alb, emi = tables(albedo, emission)
            ctx.seeds = seeds
            if adjoint != "stored":
                _save(ctx, albedo, emission)
                return image(trace(alb, emi, seeds))
            L, rows = 0.0, []
            for sb in bases(bwd_chunks):
                L_c, *rows_c = collect_fn(alb, emi, seeds, sb)
                rows.append(rows_c)
                L = L + L_c
            _save(ctx, albedo, emission, rows)
            return image(L)

        @staticmethod
        def backward(ctx, g):
            albedo, emission, stored = _saved(ctx)
            params = Params(albedo, emission)
            alb, emi = tables(albedo, emission)
            # Lanes are pixels: one cotangent per pixel, the same for all
            # of its samples (image = sum over all spp of radiance / spp).
            g_pix = (g / cfg.spp).to(alb.dtype).permute(2, 0, 1) \
                .reshape(3, -1).contiguous()
            da = de = 0.0
            for k, sb in enumerate(bases(bwd_chunks)):
                if adjoint == "stored":
                    rows = stored[k]
                else:
                    rows = collect_fn(alb, emi, ctx.seeds, sb)[1:]
                da_c, de_c = sweep_fn(alb, emi, *rows, g_pix)
                da = da + da_c
                de = de + de_c
            d = _slice_dparams(params, da, de)
            return d.albedo, d.emission, None

    def render(params: Params, seeds) -> torch.Tensor:
        if _wants_grad(params):
            return Render.apply(params.albedo, params.emission, seeds)
        with torch.no_grad():
            return image(trace(*tables(*params), seeds))

    return render


def _make_regen_renderer(make_tracer, make_sweep, scene: Scene, kernel_scene,
                         cam: Camera, cfg: RenderConfig, adjoint: str,
                         fastmath, chunked: bool, plain: bool,
                         differentiable: bool, mesh=None):
    """The image renderer over one regeneration kernel family. With a
    mesh each shard renders a contiguous range of W*H / mesh.size pixels
    (`_shard_kernels`): any whole number of pixels; a multiple of 32
    keeps every batch of the scene-table tracer's warps (32 pixels of a
    chunk) whole."""
    npix = cfg.width * cfg.height
    n_pix = npix
    if mesh is not None:
        from drt_tpu_torch.parallel.mesh import local_count

        n_pix = local_count(npix, mesh, "pixels")
    adjoint = _check_regen_cfg(cfg, adjoint, scene.device, _mesh_share(mesh))
    fm = _resolve_fastmath(fastmath, "internal")
    n_chunks = cfg.spp_chunks if chunked else 1
    # The retrace backward exists to hold one chunk's residuals at a time:
    # its collect and sweep stay per-chunk launches.
    bwd_chunks = n_chunks if adjoint == "stored" else 1
    kw = dict(fastmath=fm, plain=plain, n_pix=n_pix)
    fns = [make_tracer(kernel_scene, cam, cfg, n_chunks=n_chunks, **kw),
           None, None, None]
    if differentiable:
        fns[1] = make_tracer(kernel_scene, cam, cfg, collect=True,
                             n_chunks=bwd_chunks, **kw)
        fns[2] = make_sweep(kernel_scene, cfg, n_chunks=bwd_chunks,
                            plain=plain, n_pix=n_pix)
    if mesh is not None:
        fns = _shard_kernels(mesh, npix, scene.device, fns, False)
    render = _build_regen_renderer(scene, cfg, adjoint, *fns[:3], n_chunks,
                                   bwd_chunks)
    if differentiable:
        return render
    return torch.no_grad()(render)


def make_regen_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                              adjoint: str = "auto",
                              fastmath: bool | str = "auto",
                              chunked: bool = True, plain: bool = False,
                              differentiable: bool = True):
    """Build `render(params, seeds: i32[2]) -> image f32[H, W, 3]` on the
    path-regeneration kernels (`ops.regen`): one thread per pixel renders
    the pixel's samples one after the other and starts the next sample in
    the trip after its path died. The samples are the lockstep
    renderer's at the same seeds; the image differs by the order in which
    a pixel's samples are summed. Keyed-hash RNG and biased mode only.

    adjoint: "stored" keeps one row per trip from the forward (the collect
    form) and sweeps them in the backward: two launches a step. "retrace"
    keeps (params, seeds) and, per chunk, runs the collect form and the
    sweep inside the backward, one chunk's rows alive at a time: 1 + 2 *
    spp_chunks launches. "auto" as `_resolve_adjoint`.
    chunked=True runs all chunks in one launch; False keeps one launch per
    chunk with `sample_base = c * spp_c` (the same bits).
    plain=True runs the plain PyTorch versions on the tensors' device.
    """
    from drt_tpu_torch.ops.regen import (make_regen_sweep_adjoint,
                                         make_regen_tracer)

    return _make_regen_renderer(make_regen_tracer, make_regen_sweep_adjoint,
                                scene, scene, cam, cfg, adjoint, fastmath,
                                chunked, plain, differentiable)


def make_dyn_regen_image_renderer(scene, cam: Camera, cfg: RenderConfig,
                                  adjoint: str = "auto",
                                  fastmath: bool | str = "auto",
                                  chunked: bool = True, plain: bool = False,
                                  differentiable: bool = True):
    """`make_regen_image_renderer` over the memory-resident kernels
    (`ops.dynregen`), for scenes of up to `MAX_DYN_SHAPES` shapes. `scene`
    is a Scene or a prebuilt `DynScene`."""
    from drt_tpu_torch.ops.dynkernel import DynScene
    from drt_tpu_torch.ops.dynregen import (make_dyn_regen_sweep_adjoint,
                                            make_dyn_regen_tracer)

    ds = DynScene.of(scene)
    return _make_regen_renderer(make_dyn_regen_tracer,
                                make_dyn_regen_sweep_adjoint, ds.scene, ds,
                                cam, cfg, adjoint, fastmath, chunked, plain,
                                differentiable)


def _dyn_factories():
    from drt_tpu_torch.ops.dynkernel import (make_dyn_adjoint,
                                             make_dyn_collect_tracer,
                                             make_dyn_sweep_adjoint,
                                             make_dyn_tracer)

    return (make_dyn_tracer, make_dyn_collect_tracer, make_dyn_sweep_adjoint,
            make_dyn_adjoint)


_FUSED_FACTORIES = (make_fused_tracer, make_fused_collect_tracer,
                    make_fused_sweep_adjoint, make_fused_adjoint)


def make_sharded_fused_image_renderer(scene: Scene, cam: Camera,
                                      cfg: RenderConfig, mesh,
                                      rng: str = "internal",
                                      adjoint: str = "auto",
                                      fastmath: bool | str = "auto",
                                      plain: bool = False,
                                      differentiable: bool = True):
    """`make_fused_image_renderer` over a device mesh
    (`parallel.mesh.make_mesh`; drt_tpu/fused.py:1017): the same
    `render(params, seeds)` or `render(params, cam_u, tape)`, adjoint
    modes and unbiased reseed. Shard k of S launches every kernel on the
    slots [k N / S, (k + 1) N / S) of each launch's N = W*H*spp_c rays,
    with ray_base = k N / S (its pixels and samples those of the global
    slots; a tape is sliced to its slots); the radiance is gathered in
    global order, so the image is the one device's bit for bit, and each
    shard's sweep or retrace adjoint takes its slots of the cotangent,
    the shards' gradient partials summed. N must split into whole shards.
    plain=True runs the plain versions on the shards' devices."""
    return _make_image_renderer(_FUSED_FACTORIES, scene, scene, cam, cfg,
                                rng, adjoint, fastmath, plain,
                                differentiable, mesh=mesh)


def make_sharded_dyn_image_renderer(scene, cam: Camera, cfg: RenderConfig,
                                    mesh, rng: str = "internal",
                                    adjoint: str = "auto",
                                    fastmath: bool | str = "auto",
                                    plain: bool = False,
                                    differentiable: bool = True):
    """`make_sharded_fused_image_renderer` over the memory-resident
    kernels (drt_tpu/fused.py:684), for scenes of up to `MAX_DYN_SHAPES`
    shapes; `scene` is a Scene or a prebuilt DynScene."""
    from drt_tpu_torch.ops.dynkernel import DynScene

    ds = DynScene.of(scene)
    return _make_image_renderer(_dyn_factories(), ds.scene, ds, cam, cfg,
                                rng, adjoint, fastmath, plain,
                                differentiable, mesh=mesh)


def make_sharded_split_image_renderer(scene, cam: Camera, cfg: RenderConfig,
                                      mesh, adjoint: str = "auto",
                                      dyn: bool = False, plain: bool = False,
                                      differentiable: bool = True,
                                      tape_fn=None):
    """bsdf_samples > 1 over a device mesh (drt_tpu/fused.py:507):
    `make_split_fused_image_renderer` (dyn=True:
    `make_split_dyn_image_renderer`) whose every chunk's n_lanes =
    W*H*spp_c * M lanes split into mesh.size contiguous ranges, each
    shard drawing its own lanes' prefix-shared uniforms
    (`split_prefix_tape(..., lanes=)`, at the lanes' global pixel and
    sample ids) and launching the tape-form kernels on them from its
    ray_base. Any spp_chunks; n_lanes must split into whole shards."""
    if dyn:
        from drt_tpu_torch.ops.dynkernel import DynScene

        ds = DynScene.of(scene)
        return _make_image_renderer(_dyn_factories(), ds.scene, ds, cam,
                                    cfg, "split", adjoint, False, plain,
                                    differentiable, tape_fn, mesh)
    return _make_image_renderer(_FUSED_FACTORIES, scene, scene, cam, cfg,
                                "split", adjoint, False, plain,
                                differentiable, tape_fn, mesh)


def make_sharded_regen_image_renderer(scene: Scene, cam: Camera,
                                      cfg: RenderConfig, mesh,
                                      adjoint: str = "auto",
                                      fastmath: bool | str = "auto",
                                      chunked: bool = True,
                                      plain: bool = False,
                                      differentiable: bool = True):
    """`make_regen_image_renderer` over a device mesh
    (drt_tpu/fused.py:1401): shard k of S renders the pixels [k P / S,
    (k + 1) P / S) of the P = W*H, with the kernels' pixel offset
    ray_base = k P / S; the per-pixel sums are gathered in pixel order
    (the image is the one device's bit for bit), and each shard's sweep
    takes its pixels' cotangent, the partials summed. P must split into
    whole shards."""
    from drt_tpu_torch.ops.regen import (make_regen_sweep_adjoint,
                                         make_regen_tracer)

    return _make_regen_renderer(make_regen_tracer, make_regen_sweep_adjoint,
                                scene, scene, cam, cfg, adjoint, fastmath,
                                chunked, plain, differentiable, mesh)


def make_sharded_dyn_regen_image_renderer(scene, cam: Camera,
                                          cfg: RenderConfig, mesh,
                                          adjoint: str = "auto",
                                          fastmath: bool | str = "auto",
                                          chunked: bool = True,
                                          plain: bool = False,
                                          differentiable: bool = True):
    """`make_sharded_regen_image_renderer` over the memory-resident
    kernels (drt_tpu/fused.py:1542); `scene` is a Scene or a prebuilt
    DynScene."""
    from drt_tpu_torch.ops.dynkernel import DynScene
    from drt_tpu_torch.ops.dynregen import (make_dyn_regen_sweep_adjoint,
                                            make_dyn_regen_tracer)

    ds = DynScene.of(scene)
    return _make_regen_renderer(make_dyn_regen_tracer,
                                make_dyn_regen_sweep_adjoint, ds.scene, ds,
                                cam, cfg, adjoint, fastmath, chunked, plain,
                                differentiable, mesh)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def compact_lanes(live: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The indices i64[size] of the first `size` true entries of `live`
    (bool[K]) in ascending order, `fill` in the slots beyond them, on the
    tensor's device and without reading anything back to the host."""
    return torch.nonzero_static(live, size=size, fill_value=fill)[:, 0]


def _spread(idx: torch.Tensor, pad: int) -> torch.Tensor:
    """Compacted lane -> slot indices with each fill lane (idx == pad) sent
    to a slot of its own past the pad slot, pad + lane: a scatter to them
    has no two writes to one address (hundreds of thousands of fill lanes
    adding to one slot serialize on the card's atomics)."""
    lane = torch.arange(idx.shape[0], device=idx.device)
    return torch.where(idx < pad, idx, pad + lane)


def compacted_capacities(cfg: RenderConfig, splits, tile_rows: int = 32,
                         margin: float = 0.05) -> list:
    """Lanes of each segment (drt_tpu/fused.py:875-882): one chunk's rays
    first, then after each split the Russian-roulette survival bound
    (1 - absorb)^(split - min_bounces) plus `margin`, rounded up to
    tile_rows * 128 lanes and at most the chunk's rays."""
    n = cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks)
    caps = [n]
    for s in splits:
        frac = (1.0 - cfg.absorb_prob) ** max(0, s - cfg.min_bounces)
        caps.append(min(n, _round_up(int(np.ceil(n * (frac + margin))),
                                     tile_rows * 128)))
    return caps


def make_compacted_image_renderer(scene: Scene, cam: Camera,
                                  cfg: RenderConfig, splits=None,
                                  tile_rows: int = 32, margin: float = 0.05,
                                  plain: bool = False):
    """Build `render(params, seeds: i32[2]) -> image f32[H, W, 3]` over
    segments of the bounce loop with the dead rays compacted away between
    them (drt_tpu/fused.py:make_compacted_image_renderer), differentiable
    in params by radiative backprop.

    Each spp chunk runs the segment tracer over [0, splits[0]) on all of
    its rays; at each split the live lanes, the first K of them in
    ascending order, are gathered into the next segment's K lanes
    (`compacted_capacities`), the lanes beyond them point at a pad slot
    whose state is zero and dead; each segment's radiance is scatter-added
    back to its rays. The backward runs the segment adjoints from the last
    segment to the first, scattering each one's S at its entry back as the
    previous one's S_end. The forward keeps each chunk's (idx, cidx,
    state) per split, so the backward traces no extra forward; under
    torch.no_grad(), or when no parameter requires grad, nothing is kept.

    The kernels are the exact variant, as the reference builds them, and
    the mode is biased only: the unbiased adjoint draws new paths, which
    the kept compaction no longer fits (cfg.unbiased raises ValueError).
    More live rays at a split than its capacity are dropped, as in the
    reference, and reported by a warning with the numbers; the live lanes
    are counted on the device and read once per forward.

    The one deliberate difference from the reference: the draws. The TPU
    kernels reseed their PRNG per (seed, segment, compacted tile), so a
    compacted path draws other samples than the unsplit one. Here every
    lane draws from the keyed hash at its ray slot (cidx, composed across
    the splits) and the absolute bounce, so the paths are those of the
    "cuda" backend's tracer at the same seeds sample for sample, and the
    image equals its exact image up to where the per-ray sum is split.
    plain=True runs the plain PyTorch twins on the tensors' device.
    """
    from drt_tpu_torch.ops.megakernel import (make_fused_segment_adjoint,
                                              make_fused_segment_tracer)

    if cfg.unbiased:
        raise ValueError("compacted renderer supports biased mode only")
    _check_fused_cfg(cfg)
    D = cfg.max_depth
    if splits is None:
        splits = (min(cfg.min_bounces + 1, D - 1),)
    splits = tuple(sorted(splits))
    if not all(0 < s < D for s in splits):
        raise ValueError(f"splits {splits} must lie inside (0, {D})")
    bounds = [0, *splits, D]
    w, h = cfg.width, cfg.height
    npix = w * h
    spp_c = cfg.spp // cfg.spp_chunks
    n = npix * spp_c
    caps = compacted_capacities(cfg, splits, tile_rows, margin)
    kw = dict(rng="internal", fastmath=False, plain=plain)
    tracers = [make_fused_segment_tracer(scene, cam, cfg, b0, b1,
                                         n_rays=caps[k], **kw)
               for k, (b0, b1) in enumerate(zip(bounds, bounds[1:]))]
    adjoints = [make_fused_segment_adjoint(scene, cam, cfg, b0, b1,
                                           n_rays=caps[k], **kw)
                for k, (b0, b1) in enumerate(zip(bounds, bounds[1:]))]

    def tables(albedo, emission):
        params = Params(albedo, emission)
        return (albedo_table(scene, params).contiguous(),
                emission_table(scene, params).contiguous())

    def forward_chunk(alb, emi, seeds, c, acc, live, keep):
        """Chunk c's radiance added into acc f[3, n + K] (the slots past n
        take the fill lanes' zeros); its live-lane counts appended to
        `live`; its residuals [(idx, cidx, ray, alive)] per split returned
        if `keep`."""
        residuals = []
        out = tracers[0](alb, emi, seeds, chunk=c)
        cidx = None
        for k in range(len(tracers)):
            if k > 0:
                out = tracers[k](alb, emi, seeds, ray, alive, cidx,
                                 chunk=c)
            L, state = (out, None) if k == len(tracers) - 1 else out
            if cidx is None:
                acc[:, :n] += L
            else:
                # One add per slot, so their order changes nothing.
                acc.scatter_add_(1, _spread(cidx.long(), n).expand(3, -1), L)
            if state is None:
                break
            ray_k, alive_k = state
            on = alive_k > 0
            live.append(on.sum())
            idx = compact_lanes(on, caps[k + 1], caps[k])
            ray = torch.nn.functional.pad(ray_k, (0, 1))[:, idx]
            alive = torch.nn.functional.pad(alive_k, (0, 1))[idx]
            cidx = (idx if cidx is None else torch.nn.functional.pad(
                cidx.long(), (0, 1), value=n)[idx]).to(torch.int32)
            if keep:
                residuals.append((idx, cidx, ray, alive))
        return residuals

    def trace(alb, emi, seeds, keep):
        acc = torch.zeros((3, n + max(caps[1:])), dtype=alb.dtype,
                          device=alb.device)
        live, residuals = [], []
        for c in range(cfg.spp_chunks):
            residuals.append(forward_chunk(alb, emi, seeds, c, acc, live,
                                           keep))
        counts = torch.stack(live).tolist()  # the forward's one read-back
        for c in range(cfg.spp_chunks):
            for k, count in enumerate(counts[c * len(splits):
                                             (c + 1) * len(splits)]):
                if count > caps[k + 1]:
                    warnings.warn(
                        f"compacted renderer: {count} alive rays > capacity "
                        f"{caps[k + 1]} at the split before bounce "
                        f"{splits[k]} (chunk {c}); the rays beyond it are "
                        "dropped and the image and gradients biased: "
                        "increase `margin`")
        img = acc[:, :n].reshape(3, spp_c, h, w).mean(dim=1) \
            .permute(1, 2, 0) / cfg.spp_chunks
        return img, residuals

    class Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, albedo, emission, seeds):
            alb, emi = tables(albedo, emission)
            img, residuals = trace(alb, emi, seeds, keep=True)
            ctx.save_for_backward(albedo, emission)
            ctx.seeds = seeds
            ctx.residuals = residuals
            return img

        @staticmethod
        def backward(ctx, g):
            albedo, emission = ctx.saved_tensors
            params = Params(albedo, emission)
            alb, emi = tables(albedo, emission)
            g_pix = _g_pix_of(g, spp_c, cfg.spp_chunks, alb.dtype)
            da = de = 0.0
            for c, residuals in enumerate(ctx.residuals):
                S = None
                for k in reversed(range(len(adjoints))):
                    tail = () if S is None else (S,)
                    if k == 0:
                        da_k, de_k = adjoints[0](alb, emi, ctx.seeds, g_pix,
                                                 *tail, chunk=c)
                    else:
                        idx, cidx, ray, alive = residuals[k - 1]
                        g_k = g_pix[:, cidx.long() % npix]
                        da_k, de_k, S_k = adjoints[k](
                            alb, emi, ctx.seeds, ray, alive, cidx, g_k,
                            *tail, chunk=c)
                        S = torch.zeros((3, caps[k - 1] + caps[k]),
                                        dtype=alb.dtype, device=alb.device)
                        S.index_copy_(1, _spread(idx, caps[k - 1]), S_k)
                        S = S[:, :caps[k - 1]].contiguous()
                    da = da + da_k
                    de = de + de_k
            d = _slice_dparams(params, da, de)
            return d.albedo, d.emission, None

    def render(params: Params, seeds) -> torch.Tensor:
        if _wants_grad(params):
            return Render.apply(params.albedo, params.emission, seeds)
        with torch.no_grad():
            return trace(*tables(*params), seeds, keep=False)[0]

    return render
