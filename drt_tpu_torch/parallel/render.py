"""Renderer routing: the port of `drt_tpu.parallel.render`'s
`resolve_backend` and `make_renderer`, on one device or a device mesh.

Backends: "cuda" runs the fused kernels over a scene table of at most
`MAX_SHAPES` shapes (the port of the JAX "pallas" backend) and "cuda-dyn"
the memory-resident kernels for up to `MAX_DYN_SHAPES` shapes (the port
of "pallas-dyn"); "cuda-regen" and "cuda-dyn-regen" run the
path-regeneration kernels of the same two families (the ports of
"pallas-regen" and "pallas-dyn-regen"; "auto" never picks them, as in the
JAX package); "cuda-wavefront" runs the key-driven wavefront (the port of
"xla": `renderer.render_image` and `adjoint.make_diff_image_renderer`)
over the wavefront tracer and adjoint kernels, for at most `MAX_SHAPES`
shapes; "cuda-split" and "cuda-split-dyn" run per-vertex splitting
(bsdf_samples > 1) on the tape forms of the two fused families (the ports
of "pallas-split" and "pallas-split-dyn"). On a device mesh
(`parallel.mesh.make_mesh`) their "-sharded" forms ("cuda-sharded",
"cuda-dyn-sharded", "cuda-split-sharded", "cuda-split-dyn-sharded",
"cuda-regen-sharded", "cuda-dyn-regen-sharded", the ports of the JAX
"pallas-*-sharded") run the same kernels on each shard's slots
(`fused.make_sharded_*`), and "cuda-wavefront" shards its rays. These
need the scene and every shard on a CUDA device. Each has a "torch-"
twin, its plain PyTorch version on the scene's (and the shards')
devices; "torch-wavefront" takes a scene of any size. The wavefront
backends take bsdf_samples > 1 too, the unbiased mode among it.
"""

from __future__ import annotations

import functools

import torch

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.dynkernel import MAX_DYN_SHAPES
from drt_tpu_torch.ops.megakernel import MAX_SHAPES
from drt_tpu_torch.parallel.mesh import Mesh, local_count
from drt_tpu_torch.scene import Params, Scene

_FAMILIES = ("", "-dyn", "-regen", "-dyn-regen", "-split", "-split-dyn")
BACKENDS = tuple(f"{route}{fam}{sharded}" for sharded in ("", "-sharded")
                 for route in ("cuda", "torch") for fam in _FAMILIES) + (
    "cuda-wavefront", "torch-wavefront")


def resolve_backend(scene: Scene, cfg: RenderConfig, backend: str = "auto",
                    mesh=None) -> str:
    """Resolve "auto" to the backend make_renderer will use. A scene on
    the CPU takes "torch". A float32 scene on a CUDA device takes "cuda"
    up to `MAX_SHAPES` shapes and "cuda-dyn" up to `MAX_DYN_SHAPES`.
    bsdf_samples > 1 takes their lane-splitting forms: "torch-split" on
    the CPU, "cuda-split" and "cuda-split-dyn" on the card (the JAX
    package keeps its baked kernels to 24 shapes; the port's scene table
    takes 64). On a mesh each takes its "-sharded" form.

    A CUDA scene the kernels do not take (not float32, or more shapes
    than that) raises rather than silently running a plain version on the
    card; pass backend="torch" (or "torch-wavefront", which takes any
    number of shapes) to ask for that.
    """
    if backend != "auto":
        return backend
    split = "-split" if cfg.bsdf_samples > 1 else ""
    sharded = "" if mesh is None else "-sharded"
    if scene.device.type != "cuda":
        return "torch" + split + sharded
    if scene.shape_geo.dtype != torch.float32:
        raise ValueError("the tracer kernels are float32; pass "
                         f"backend='torch{split}{sharded}' for the plain "
                         "version on the card")
    if scene.num_shapes <= MAX_SHAPES:
        return "cuda" + split + sharded
    if scene.num_shapes <= MAX_DYN_SHAPES:
        return "cuda" + split + "-dyn" + sharded
    raise ValueError(f"a scene of {scene.num_shapes} shapes is more than "
                     f"the {MAX_DYN_SHAPES} the kernels take; pass "
                     "backend='torch-wavefront' for the plain version on "
                     "the card")


def _check_backend(backend: str, scene: Scene, mesh) -> None:
    """Refuse a name the port does not have (naming the port of a JAX
    name), a "-sharded" backend without a mesh or another one on a mesh,
    and a "cuda" backend with the scene or a shard off the card."""
    if backend not in BACKENDS:
        port = "cuda" + backend[len("pallas"):]
        hint = (f" (the JAX package's {backend!r} is {port!r} here)"
                if backend.startswith("pallas") and port in BACKENDS
                else "")
        if backend == "xla":
            hint = (" (the JAX package's 'xla' is 'cuda-wavefront' or "
                    "'torch-wavefront' here)")
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}{hint}")
    sharded = backend.endswith("-sharded")
    if mesh is None and sharded:
        raise ValueError(f"backend {backend!r} needs a device mesh")
    if mesh is not None and not (sharded or backend.endswith("wavefront")):
        raise ValueError(f"backend {backend!r} renders on one device; on a "
                         f"mesh take {backend + '-sharded'!r}")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    if backend.startswith("cuda"):
        if scene.device.type != "cuda":
            raise ValueError(f"backend {backend!r} needs the scene on a "
                             f"CUDA device, not {scene.device}")
        off = [d for d in (mesh.devices if mesh else ()) if d.type != "cuda"]
        if off:
            raise ValueError(f"backend {backend!r} needs every shard of the "
                             f"mesh on a CUDA device, not {off[0]}")


def make_renderer(scene: Scene, cfg: RenderConfig, cam: Camera,
                  mesh=None, differentiable: bool = True,
                  backend: str = "auto"):
    """Build `render(params, seeds: i32[2]) -> image f[H, W, 3]`.

    differentiable=True: the image carries the radiative-backprop
    backward wherever a parameter requires grad (the stored or retrace
    adjoint as `fused._resolve_adjoint` picks; unbiased mode retraces with
    fresh samples). differentiable=False renders under `torch.no_grad()`.
    mesh (`parallel.mesh.make_mesh`): every shard renders its slots of
    each chunk's rays (pixels, for the regeneration backends), the image
    is the one device's bit for bit, the gradients the shards' partials
    summed; the rays of a chunk must split into whole shards.
    """
    backend = resolve_backend(scene, cfg, backend, mesh)
    _check_backend(backend, scene, mesh)
    from drt_tpu_torch import fused

    plain = backend.startswith("torch")
    if backend.endswith("wavefront"):
        from drt_tpu_torch.adjoint import (make_diff_image_renderer,
                                           make_wavefront_trace_fn)
        from drt_tpu_torch.renderer import render_image

        if mesh is not None:
            local_count(cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks),
                        mesh)
        if differentiable:
            return make_diff_image_renderer(scene, cam, cfg, plain=plain,
                                            mesh=mesh)
        trace_fn = make_wavefront_trace_fn(scene, cfg, plain=plain,
                                           mesh=mesh)

        @torch.no_grad()
        def render(params: Params, seeds) -> torch.Tensor:
            return render_image(params, scene, cam, seeds, cfg,
                                trace_fn=trace_fn)

        return render
    family = backend.split("-", 1)[1] if "-" in backend else ""
    kw = dict(plain=plain, differentiable=differentiable)
    if family.endswith("sharded"):
        family = family[:-len("sharded")].rstrip("-")
        make = {"": fused.make_sharded_fused_image_renderer,
                "dyn": fused.make_sharded_dyn_image_renderer,
                "regen": fused.make_sharded_regen_image_renderer,
                "dyn-regen": fused.make_sharded_dyn_regen_image_renderer,
                "split": fused.make_sharded_split_image_renderer,
                "split-dyn": functools.partial(
                    fused.make_sharded_split_image_renderer, dyn=True),
                }[family]
        return make(scene, cam, cfg, mesh, **kw)
    make = {"": fused.make_fused_image_renderer,
            "dyn": fused.make_dyn_image_renderer,
            "regen": fused.make_regen_image_renderer,
            "dyn-regen": fused.make_dyn_regen_image_renderer,
            "split": fused.make_split_fused_image_renderer,
            "split-dyn": fused.make_split_dyn_image_renderer}[family]
    return make(scene, cam, cfg, **kw)
