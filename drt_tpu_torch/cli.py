"""Command-line renderer: the `render`, `grad`, `grad-image` and
`invert` subcommands of `drt_tpu.cli`.

Reference flags and defaults (src/args.hpp:19-67: width 640, height 480,
samples 100, min-bounces 1, absorb-prob 0.5, required output path) on the
sample scene (src/render.cpp:26-65), plus max depth, spp chunking, seed,
f64 tracing (on the CPU), backend, device, the unbiased gradient mode and
BSDF samples per vertex (per-vertex splitting).

Usage:
  python -m drt_tpu_torch.cli render -o out.png [-x W -y H -n SPP ...]
  python -m drt_tpu_torch.cli grad -o grads.json [-x W -y H -n SPP ...]
  python -m drt_tpu_torch.cli grad-image -o grad.exr [--param albedo:0 ...]
  python -m drt_tpu_torch.cli invert -o recovered.json [--steps 200
      --checkpoint-dir DIR --metrics-jsonl FILE --steps-per-call 8 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_render_flags(p: argparse.ArgumentParser) -> None:
    # Reference flags (src/args.hpp:19-67).
    p.add_argument("-x", "--width", type=int, default=640)
    p.add_argument("-y", "--height", type=int, default=480)
    p.add_argument("-n", "--samples", type=int, default=100,
                   help="samples per pixel")
    p.add_argument("-b", "--min-bounces", type=int, default=1)
    p.add_argument("-p", "--absorb-prob", type=float, default=0.5)
    p.add_argument("-o", "--output", required=True)
    # Framework extras.
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--spp-chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true",
                   help="trace in float64: the plain version on the CPU "
                        "(the CPU validation mode; implies --device cpu)")
    p.add_argument("--backend",
                   choices=("auto", "cuda", "cuda-dyn", "cuda-regen",
                            "cuda-dyn-regen", "cuda-wavefront", "cuda-split",
                            "cuda-split-dyn", "torch", "torch-dyn",
                            "torch-regen", "torch-dyn-regen",
                            "torch-wavefront", "torch-split",
                            "torch-split-dyn"),
                   default="auto",
                   help="auto = the fused CUDA kernels for a scene on a "
                        "card (their -split forms at --bsdf-samples > 1), "
                        "the plain PyTorch version for one on the CPU; "
                        "the -regen backends (path regeneration) and the "
                        "-wavefront backends (the key-driven wavefront) "
                        "are taken only when asked for")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, or cpu with --f64; "
                        "without a card the command fails unless --device "
                        "cpu is given)")
    p.add_argument("--unbiased", action="store_true",
                   help="unbiased gradient mode: the backward retraces "
                        "with fresh samples (integrate.hpp:39-52) instead "
                        "of replaying the forward's")
    p.add_argument("--adjoint-samples", type=int, default=1,
                   help="fresh retraces averaged by the unbiased backward "
                        "(integrate.hpp:15-19 n_samples)")
    p.add_argument("--bsdf-samples", type=int, default=1,
                   help="BSDF samples per path vertex in the forward "
                        "estimator (integrate.hpp:56-66 n_samples; lanes "
                        "are exponential in max_depth): auto routes to "
                        "the lane-splitting kernels (cuda-split, "
                        "cuda-split-dyn); cuda-wavefront takes it too, "
                        "also unbiased")


def _build(args):
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox

    device = args.device or ("cpu" if args.f64 else "cuda")
    if args.f64 and torch.device(device).type != "cpu":
        raise SystemExit(f"drt_tpu_torch: --f64 runs the plain version on "
                         f"the CPU (the kernels are float32); drop "
                         f"--device {device}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"drt_tpu_torch: no CUDA device is visible for "
                         f"--device {device}; pass --device cpu to run the "
                         "plain PyTorch version on the CPU")
    dtype = torch.float64 if args.f64 else torch.float32
    scene, params, cam = cbox.build(dtype=dtype, device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       spp=args.samples, min_bounces=args.min_bounces,
                       absorb_prob=args.absorb_prob,
                       max_depth=args.max_depth,
                       spp_chunks=args.spp_chunks,
                       unbiased=args.unbiased,
                       adjoint_samples=args.adjoint_samples,
                       bsdf_samples=args.bsdf_samples)
    return scene, params, cam, cfg


def _write(path: str, img: np.ndarray) -> None:
    from drt_tpu_torch.utils.image import write_exr, write_png

    if path.endswith(".png"):
        write_png(path, img)
    else:
        write_exr(path, img)


def cmd_render(args) -> int:
    import torch

    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.parallel.render import make_renderer

    scene, params, cam, cfg = _build(args)
    render = make_renderer(scene, cfg, cam, differentiable=False,
                           backend=args.backend)
    seeds = seeds_from_generator(torch.Generator().manual_seed(args.seed))
    t0 = time.time()
    img = render(params, seeds).cpu().numpy()
    dt = time.time() - t0
    _write(args.output, img)
    n_rays = cfg.width * cfg.height * cfg.spp
    print(f"rendered {cfg.width}x{cfg.height}x{cfg.spp}spp on "
          f"{scene.device} in {dt:.2f}s ({n_rays / dt / 1e6:.2f} Mrays/s "
          f"incl. kernel build) -> {args.output}", file=sys.stderr)
    return 0


def cmd_grad(args) -> int:
    """Render + parameter gradients of the mean image intensity, through
    the backend the scene's device resolves to (`--backend` applies to
    the gradients, not just the forward)."""
    import torch

    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
    from drt_tpu_torch.scene import Params

    scene, params, cam, cfg = _build(args)
    backend = resolve_backend(scene, cfg, args.backend)
    print(f"gradient backend: {backend}", file=sys.stderr)
    render = make_renderer(scene, cfg, cam, differentiable=True,
                           backend=backend)
    seeds = seeds_from_generator(torch.Generator().manual_seed(args.seed))
    leaves = Params(*(p.clone().requires_grad_() for p in params))
    val = render(leaves, seeds).mean()
    d_albedo, d_emission = torch.autograd.grad(val, leaves)
    out = {
        "mean_intensity": float(val.detach()),
        "d_albedo": d_albedo.cpu().tolist(),
        "d_emission": d_emission.cpu().tolist(),
        "backend": backend,
        "unbiased": cfg.unbiased,
    }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"gradients -> {args.output}", file=sys.stderr)
    return 0


def cmd_grad_image(args) -> int:
    """The per-pixel gradient image d(pixel)/d(param row), the reference's
    headline validation artifact (README.md:138-145), rendered both by
    radiative backprop and by forward-mode AD (the dual-number ground
    truth) through the plain wavefront on the chosen device, and written
    side by side."""
    import torch

    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.gradcheck import grad_image, grad_image_fwd
    from drt_tpu_torch.utils.image import write_png

    if args.backend not in ("auto", "torch-wavefront"):
        # Both images come from the plain wavefront (the jvp ground truth
        # has no kernel); honouring another backend here would mislead.
        print("grad-image runs the plain wavefront (the jvp ground truth "
              "has no kernel): use --backend auto or torch-wavefront, or "
              "`grad` for the kernels' gradients", file=sys.stderr)
        return 2
    scene, params, cam, cfg = _build(args)
    seeds = seeds_from_generator(torch.Generator().manual_seed(args.seed))
    g_bp = grad_image(scene, cam, cfg, params, seeds,
                      args.param).cpu().numpy()
    g_fw = grad_image_fwd(scene, cam, cfg, params, seeds,
                          args.param).cpu().numpy()
    diff = np.abs(g_bp - g_fw).max()
    scale = max(np.abs(g_fw).max(), 1e-12)

    def write_pair(path, img):
        if path.endswith(".png"):
            # A signed map around mid-grey.
            write_png(path, 0.5 + 0.5 * img / scale, gamma=1.0)
        else:
            _write(path, img)

    stem, ext = os.path.splitext(args.output)
    gt_path = f"{stem}-gt{ext}"
    write_pair(args.output, g_bp)
    write_pair(gt_path, g_fw)
    print(f"grad image d(pixel)/d({args.param}) -> {args.output}; jvp "
          f"ground truth -> {gt_path}; max |backprop - jvp| = {diff:.3e} "
          f"(scale {scale:.3e})", file=sys.stderr)
    return 0


def cmd_invert(args) -> int:
    """Inverse rendering: recover the albedo and emission tables from a
    ground-truth render of the sample scene, by Adam through radiative
    backprop (`optim.inverse_render`), resumable from `--checkpoint-dir`."""
    import torch

    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.optim import inverse_render
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    scene, params, cam, cfg = _build(args)
    render = make_renderer(scene, cfg, cam, differentiable=False,
                           backend=args.backend)
    target = render(params, seeds_from_generator(
        torch.Generator().manual_seed(args.seed + 1)))
    init = Params(albedo=torch.full_like(params.albedo, 0.25),
                  emission=torch.full_like(params.emission, 0.5))
    recovered, metrics = inverse_render(
        scene, cfg, cam, target, init,
        torch.Generator().manual_seed(args.seed), steps=args.steps,
        learning_rate=args.lr, log_every=args.log_every,
        backend=args.backend, checkpoint_dir=args.checkpoint_dir,
        metrics_jsonl=args.metrics_jsonl,
        steps_per_call=args.steps_per_call)
    out = {
        "true_albedo": params.albedo.cpu().tolist(),
        "recovered_albedo": recovered.albedo.cpu().tolist(),
        "true_emission": params.emission.cpu().tolist(),
        "recovered_emission": recovered.emission.cpu().tolist(),
        "final_loss": float(metrics["loss"][-1]),
    }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"recovered params -> {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="drt_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="forward render the sample scene")
    _add_render_flags(pr)
    pr.set_defaults(fn=cmd_render)
    pg = sub.add_parser("grad", help="parameter gradients of mean intensity")
    _add_render_flags(pg)
    pg.set_defaults(fn=cmd_grad)
    pgi = sub.add_parser(
        "grad-image",
        help="per-pixel gradient image d(pixel)/d(param row), with the "
             "forward-mode (dual-number) ground-truth image beside it")
    _add_render_flags(pgi)
    pgi.add_argument("--param", default="albedo:0",
                     help="parameter row, e.g. albedo:0 or emission:0")
    pgi.set_defaults(fn=cmd_grad_image)
    pi = sub.add_parser("invert", help="inverse rendering recovery loop")
    _add_render_flags(pi)
    pi.add_argument("--steps", type=int, default=200)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--log-every", type=int, default=20)
    pi.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (one npz file a saved "
                         "step); resumes from its latest if it has one")
    pi.add_argument("--metrics-jsonl", default=None,
                    help="stream per-step metrics to this JSONL file")
    pi.add_argument("--steps-per-call", type=int, default=8,
                    help="optimizer steps per block, in which the host "
                         "reads nothing from the card (bit-equal to 1: "
                         "the same draws)")
    pi.set_defaults(fn=cmd_invert)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
