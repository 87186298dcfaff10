"""Renderer routing: the port of `drt_tpu.parallel.render`'s
`resolve_backend` and `make_renderer` on a single device.

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
of "pallas-split" and "pallas-split-dyn"). These seven need the scene on
a CUDA device. "torch", "torch-dyn", "torch-regen", "torch-dyn-regen",
"torch-wavefront", "torch-split" and "torch-split-dyn" run their plain
PyTorch versions on the scene's device; "torch-wavefront" takes a scene
of any size. The wavefront backends take bsdf_samples > 1 too, the
unbiased mode among it. The JAX package's other backends raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.dynkernel import MAX_DYN_SHAPES
from drt_tpu_torch.ops.megakernel import MAX_SHAPES
from drt_tpu_torch.scene import Params, Scene

BACKENDS = ("cuda", "cuda-dyn", "cuda-regen", "cuda-dyn-regen",
            "cuda-wavefront", "cuda-split", "cuda-split-dyn", "torch",
            "torch-dyn", "torch-regen", "torch-dyn-regen", "torch-wavefront",
            "torch-split", "torch-split-dyn")

# JAX backends not ported yet -> the ROADMAP item (queue A) that ports them.
_LATER = {
    "pallas-sharded": "A14 (multi-device)",
    "pallas-dyn-sharded": "A14 (multi-device)",
    "pallas-split-sharded": "A14 (multi-device)",
    "pallas-split-dyn-sharded": "A14 (multi-device)",
    "pallas-regen-sharded": "A14 (multi-device)",
    "pallas-dyn-regen-sharded": "A14 (multi-device)",
}


def _not_yet(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def resolve_backend(scene: Scene, cfg: RenderConfig,
                    backend: str = "auto") -> str:
    """Resolve "auto" to the backend make_renderer will use. A scene on
    the CPU takes "torch". A float32 scene on a CUDA device takes "cuda"
    up to `MAX_SHAPES` shapes and "cuda-dyn" up to `MAX_DYN_SHAPES`.
    bsdf_samples > 1 takes their lane-splitting forms: "torch-split" on
    the CPU, "cuda-split" and "cuda-split-dyn" on the card (the JAX
    package keeps its baked kernels to 24 shapes; the port's scene table
    takes 64).

    A CUDA scene the kernels do not take (not float32, or more shapes
    than that) raises rather than silently running a plain version on the
    card; pass backend="torch" (or "torch-wavefront", which takes any
    number of shapes) to ask for that.
    """
    if backend != "auto":
        return backend
    split = "-split" if cfg.bsdf_samples > 1 else ""
    if scene.device.type != "cuda":
        return "torch" + split
    if scene.shape_geo.dtype != torch.float32:
        raise ValueError("the tracer kernels are float32; pass "
                         f"backend='torch{split}' for the plain version on "
                         "the card")
    if scene.num_shapes <= MAX_SHAPES:
        return "cuda" + split
    if scene.num_shapes <= MAX_DYN_SHAPES:
        return "cuda" + split + "-dyn"
    raise ValueError(f"a scene of {scene.num_shapes} shapes is more than "
                     f"the {MAX_DYN_SHAPES} the kernels take; pass "
                     "backend='torch-wavefront' for the plain version on "
                     "the card")


def make_renderer(scene: Scene, cfg: RenderConfig, cam: Camera,
                  mesh=None, differentiable: bool = True,
                  backend: str = "auto"):
    """Build `render(params, seeds: i32[2]) -> image f32[H, W, 3]`.

    differentiable=True: the image carries the radiative-backprop
    backward wherever a parameter requires grad (the stored or retrace
    adjoint as `fused._resolve_adjoint` picks; unbiased mode retraces with
    fresh samples). differentiable=False renders under `torch.no_grad()`.
    A device mesh raises (ROADMAP A14).
    """
    if mesh is not None:
        raise _not_yet("rendering over a device mesh", _LATER["pallas-sharded"])
    backend = resolve_backend(scene, cfg, backend)
    if backend in _LATER:
        raise _not_yet(f"backend {backend!r}", _LATER[backend])
    if backend not in BACKENDS:
        hint = (f" (the JAX package's {backend!r} is "
                f"{'cuda' + backend[len('pallas'):]!r} here)"
                if "cuda" + backend[len("pallas"):] in BACKENDS
                and backend.startswith("pallas") else "")
        if backend == "xla":
            hint = (" (the JAX package's 'xla' is 'cuda-wavefront' or "
                    "'torch-wavefront' here)")
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}{hint}")
    if backend.startswith("cuda") and scene.device.type != "cuda":
        raise ValueError(f"backend {backend!r} needs the scene on a CUDA "
                         f"device, not {scene.device}")
    from drt_tpu_torch import fused

    if backend.endswith("wavefront"):
        from drt_tpu_torch.adjoint import (make_diff_image_renderer,
                                           make_wavefront_trace_fn)
        from drt_tpu_torch.renderer import render_image

        plain = backend.startswith("torch")
        if differentiable:
            return make_diff_image_renderer(scene, cam, cfg, plain=plain)
        trace_fn = make_wavefront_trace_fn(scene, cfg, plain=plain)

        @torch.no_grad()
        def render(params: Params, seeds) -> torch.Tensor:
            return render_image(params, scene, cam, seeds, cfg,
                                trace_fn=trace_fn)

        return render
    family = backend.split("-", 1)[1] if "-" in backend else ""
    make = {"": fused.make_fused_image_renderer,
            "dyn": fused.make_dyn_image_renderer,
            "regen": fused.make_regen_image_renderer,
            "dyn-regen": fused.make_dyn_regen_image_renderer,
            "split": fused.make_split_fused_image_renderer,
            "split-dyn": fused.make_split_dyn_image_renderer}[family]
    return make(scene, cam, cfg, plain=backend.startswith("torch"),
                differentiable=differentiable)
