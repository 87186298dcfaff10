"""drt_tpu_torch — the PyTorch and CUDA port of drt_tpu.

The same Monte-Carlo path tracer on an NVIDIA GPU: module names mirror
`drt_tpu`'s so each has a counterpart there, plain tensor code is
PyTorch, and each Pallas kernel of `drt_tpu` becomes a hand-written
Hopper kernel under `csrc/` beside a plain PyTorch twin. This package
imports torch and never jax.

Ported so far: the main render path, forward and backward
(`parallel.render.make_renderer`, differentiable by radiative backprop
over the fused tracer, collect tracer, sweep adjoint and retrace adjoint
kernels), the same path over memory-resident scenes of up to 2048 shapes
(`ops.dynkernel`: `DynScene` and four more kernels, for triangle meshes
such as `models.gallery.build_mesh`), the path-regeneration renderers of
both families (`ops.regen`, `ops.dynregen`: backends "cuda-regen" and
"cuda-dyn-regen"), the key-driven wavefront (`renderer.render_image`,
`adjoint.make_diff_image_renderer` over the wavefront tracer and adjoint
kernels: backend "cuda-wavefront"), per-vertex splitting (bsdf_samples >
1: `fused.make_split_fused_image_renderer` and
`make_split_dyn_image_renderer` over the tape forms of both fused
families, backends "cuda-split" and "cuda-split-dyn", and the wavefront),
`adjoint.make_diff_renderer`, `gradcheck`, `integrate`, the Adam loop
of `optim` with checkpoint and resume (`utils.checkpoint`) and its
metrics stream (`utils.logging`), `cli` (render, grad, grad-image,
invert), and `utils.profiling`, `utils.debug` and `utils.image`.
"""

from drt_tpu_torch.adjoint import make_diff_image_renderer, make_diff_renderer
from drt_tpu_torch.camera import Camera, default_camera, look_at
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
from drt_tpu_torch.renderer import render_image, trace_rays
from drt_tpu_torch.scene import Params, Scene, SceneBuilder, make_scene

__all__ = [
    "RenderConfig",
    "Scene",
    "Params",
    "SceneBuilder",
    "make_scene",
    "Camera",
    "default_camera",
    "look_at",
    "trace_rays",
    "render_image",
    "make_diff_renderer",
    "make_diff_image_renderer",
    "make_renderer",
    "resolve_backend",
]
