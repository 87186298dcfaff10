"""Time drt_tpu_torch's mesh kernels and mesh paths on one NVIDIA GPU, so
that two checkouts can be compared on one card, in one sitting.

  python3 tools/bench_torch_dyn.py [--root DIR] [--label NAME]

Imports drt_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels from DIR's sources, and prints JSON lines:
  - "ptxas": each entry function's registers, stack and spills, per
    library, from the compiler's report;
  - "kernel": B6 (dyn tracer), B7 (dyn collect tracer), B8 (dyn sweep), B9
    (dyn retrace adjoint), B12 (dyn regeneration tracer), its collect form
    and B13 (its sweep, on B12's collect form's rows) at the mesh
    main shape of chip_smoke.py (the 1287-shape mesh, 640x480, 64 spp,
    depth 5, 4 chunks, fast variant, internal RNG, seeds (7, 8)): device
    ms per launch, the median of 3 windows of 10 launches after 20
    warm-ups (CUDA events), with the window means; B8's with its GB/s
    and share of the memory bound over every row and over the rows it
    needs (bench_torch_fused.py:sweep_rates);
  - "digest": SHA-256 of the bytes of B6's radiance, of B7's radiance, rsc
    and rrow, of B8's and B9's (d_albedo, d_emission), of B12's radiance
    and trips
    and of its collect form's rsc and rrow (the rows beyond each pixel's
    trips, which the kernel never writes, set to 0), and of B13's
    (d_albedo, d_emission) on those rows and on chunk 1's rows alone, in
    both builds where the checkout has B13's checking build
    (build="lockstep", the per-pixel kernel; its times too), at those
    seeds: equal digests across checkouts mean bit-equal outputs;
  - "path": the mesh through the user's entry points, seconds on the host
    clock with a synchronize: make_renderer forward, a forward+backward
    step of the mean squared image loss in the stored and the retrace
    forms and unbiased with 2 adjoint samples (median of 5 after 2
    warm-ups), the same forward and stored and retrace steps through
    backend "cuda-dyn-regen", and the trainer step of
    optim.inverse_render: a call of 10 steps less a call of 5, over 5
    (each call builds its renderer first);
  - "card": nvidia-smi's name and power limit.
Run it on the checkouts in turns (A, B, B, A) to see the card's drift.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from bench_torch_fused import sweep_rates

MESH_MAIN = dict(width=640, height=480, spp=64, max_depth=5, spp_chunks=4)


def emit(kind: str, label: str, **kw) -> None:
    print(json.dumps({"kind": kind, "label": label, **kw}), flush=True)


def cuda_ms(torch, fn, reps=10, warmup=20, windows=3):
    """Device ms per fn() call: the median of `windows` window means."""
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[len(means) // 2], means, out


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def host_s(torch, fn, reps=5, warmup=2) -> tuple[float, list]:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    label = args.label or str(root)
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        print("bench_torch_dyn: no CUDA device visible", file=sys.stderr)
        return 2
    import drt_tpu_torch
    assert Path(drt_tpu_torch.__file__).resolve().parent.parent == root
    from drt_tpu_torch import optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import (make_dyn_image_renderer,
                                     make_dyn_regen_image_renderer)
    from drt_tpu_torch.models import gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table
    from drt_tpu_torch.utils import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit("card", label, smi=smi, torch=torch.__version__)
    built = native.build_all()
    for source in sorted(built):
        lines = [ln.strip() for ln in
                 native.log_path(source).read_text().splitlines()
                 if any(w in ln for w in ("Compiling entry", "registers",
                                          "spill"))]
        emit("ptxas", label, source=source, lines=lines)

    dev = torch.device("cuda")
    cfg = RenderConfig(**MESH_MAIN)
    C = cfg.spp_chunks
    scene, params, cam = gallery.build_mesh(3, device=dev)
    ds = dk.DynScene(scene)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    kw = dict(fastmath=True, n_chunks=C)
    g = torch.Generator(device=dev).manual_seed(11)
    g_pix = torch.rand((3, cfg.width * cfg.height), generator=g,
                       device=dev) / cfg.spp

    trace = dk.make_dyn_tracer(ds, cam, cfg, **kw)
    collect = dk.make_dyn_collect_tracer(ds, cam, cfg, **kw)
    sweep = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=C)
    adjoint = dk.make_dyn_adjoint(ds, cam, cfg, **kw)
    regen = dr.make_dyn_regen_tracer(ds, cam, cfg, **kw)
    ms, windows, L = cuda_ms(torch, lambda: trace(alb, emi, seeds))
    emit("kernel", label, name="dyn_tracer", ms=ms, windows=windows)
    emit("digest", label, name="dyn_tracer radiance", sha256=digest(L))
    del L
    ms, windows, (L, rsc, rrow) = cuda_ms(
        torch, lambda: collect(alb, emi, seeds))
    emit("kernel", label, name="dyn_collect", ms=ms, windows=windows)
    for what, t in (("radiance", L), ("rsc", rsc), ("rrow", rrow)):
        emit("digest", label, name=f"dyn_collect {what}", sha256=digest(t))
    ms, windows, tables = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rrow,
                                                       g_pix))
    emit("kernel", label, name="dyn_sweep", ms=ms, windows=windows,
         **sweep_rates(torch, ms, (rrow >> 16) > 0))
    for what, t in zip(("d_albedo", "d_emission"), tables):
        emit("digest", label, name=f"dyn_sweep {what}", sha256=digest(t))
    del L, rsc, rrow
    ms, windows, grads = cuda_ms(torch,
                                 lambda: adjoint(alb, emi, seeds, g_pix))
    emit("kernel", label, name="dyn_adjoint", ms=ms, windows=windows)
    for what, t in zip(("d_albedo", "d_emission"), grads):
        emit("digest", label, name=f"dyn_adjoint {what}", sha256=digest(t))
    ms, windows, (L, trips) = cuda_ms(torch, lambda: regen(alb, emi, seeds))
    emit("kernel", label, name="dyn_regen_tracer", ms=ms, windows=windows)
    for what, t in (("radiance", L), ("trips", trips)):
        emit("digest", label, name=f"dyn_regen_tracer {what}",
             sha256=digest(t))
    del L, trips
    regen_collect = dr.make_dyn_regen_tracer(ds, cam, cfg, collect=True,
                                             **kw)
    ms, windows, (_, rsc, rrow, trips) = cuda_ms(
        torch, lambda: regen_collect(alb, emi, seeds))
    emit("kernel", label, name="dyn_regen_collect", ms=ms, windows=windows)
    own = torch.arange(rsc.shape[1], device=dev)[None, :, None] \
        < trips[:, None, :]
    for what, t in (("rsc", rsc), ("rrow", rrow)):
        emit("digest", label, name=f"dyn_regen_collect {what}",
             sha256=digest(torch.where(own, t, 0)))
    del own
    # B13 in both builds where the checkout has its checking build (the
    # per-pixel kernel), on the main path's rows and on chunk 1's alone
    # (a retrace's launch).
    builds = ("queue", "lockstep") if hasattr(
        dr, "dyn_regen_sweep_form") else ("queue",)
    cfg_1 = RenderConfig(width=cfg.width, height=cfg.height, spp=cfg.spp // C,
                         max_depth=cfg.max_depth)
    _, rsc_1, rrow_1, trips_1 = dr.make_dyn_regen_tracer(
        ds, cam, cfg_1, collect=True, fastmath=True)(alb, emi, seeds,
                                                     cfg_1.spp)
    for build in builds:
        kw_b = {} if build == "queue" else dict(build=build)
        name = "dyn_regen_sweep" + ("" if build == "queue" else
                                    f" ({build} build)")
        regen_sweep = dr.make_dyn_regen_sweep_adjoint(ds, cfg, n_chunks=C,
                                                      **kw_b)
        ms, windows, tables = cuda_ms(
            torch, lambda: regen_sweep(alb, emi, rsc, rrow, trips, g_pix))
        form = (dr.dyn_regen_sweep_form(cfg, alb, emi)
                if len(builds) == 2 and build == "queue" else None)
        emit("kernel", label, name=name, ms=ms, windows=windows, form=form,
             rows=int(trips.sum()))
        for what, t in zip(("d_albedo", "d_emission"), tables):
            emit("digest", label, name=f"{name} {what}", sha256=digest(t))
        sweep_1 = dr.make_dyn_regen_sweep_adjoint(ds, cfg_1, **kw_b)
        ms, windows, tables = cuda_ms(
            torch, lambda: sweep_1(alb, emi, rsc_1, rrow_1, trips_1, g_pix))
        emit("kernel", label, name=f"{name}, chunk 1 alone", ms=ms,
             windows=windows, rows=int(trips_1.sum()))
        for what, t in zip(("d_albedo", "d_emission"), tables):
            emit("digest", label, name=f"{name}, chunk 1 alone {what}",
                 sha256=digest(t))
    del rsc, rrow, trips, rsc_1, rrow_1, trips_1

    render = make_renderer(scene, cfg, cam, differentiable=False)
    s_img = torch.tensor([1, 2], dtype=torch.int32)
    target = render(params, s_img)
    med, times = host_s(torch, lambda: render(params, s_img))
    emit("path", label, name="make_renderer forward", s=med, times=times)
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)

    def step(render_fn):
        p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
        ((render_fn(p, s_img) - target) ** 2).mean().backward()

    cfg_u = RenderConfig(**MESH_MAIN, unbiased=True, adjoint_samples=2)
    for form, fn in (("stored", make_renderer(scene, cfg, cam)),
                     ("retrace", make_dyn_image_renderer(
                         scene, cam, cfg, adjoint="retrace")),
                     ("unbiased x2", make_renderer(scene, cfg_u, cam))):
        med, times = host_s(torch, lambda: step(fn))
        emit("path", label, name=f"fwd+bwd step, {form}", s=med,
             times=times)
    regen_render = make_renderer(scene, cfg, cam, backend="cuda-dyn-regen",
                                 differentiable=False)
    med, times = host_s(torch, lambda: regen_render(params, s_img))
    emit("path", label, name="cuda-dyn-regen make_renderer forward", s=med,
         times=times)
    for form, fn in (("stored", make_renderer(scene, cfg, cam,
                                              backend="cuda-dyn-regen")),
                     ("retrace", make_dyn_regen_image_renderer(
                         ds, cam, cfg, adjoint="retrace"))):
        med, times = host_s(torch, lambda: step(fn))
        emit("path", label, name=f"cuda-dyn-regen fwd+bwd step, {form}",
             s=med, times=times)
    start = params.albedo.clone()
    start[3] = torch.tensor([0.6, 0.2, 0.2], device=dev)

    def train(n_steps):
        t0 = time.perf_counter()
        optim.inverse_render(scene, cfg, cam, target,
                             Params(start, params.emission),
                             torch.Generator().manual_seed(5), steps=n_steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    train(1)  # warm-up
    t5, t10 = train(5), train(10)
    emit("path", label, name="trainer step", s=(t10 - t5) / 5,
         s_per_step_of_5=t5 / 5, s_per_step_of_10=t10 / 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
