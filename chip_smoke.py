"""Drive drt_tpu_torch's forward render path on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result line):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the fused tracer kernel from drt_tpu_torch/csrc;
  3. hold the kernel against its plain PyTorch twin on the card: tape
     mode, exact variant, on the cbox, glossy and tri scenes (64x48x4 spp,
     depth 5); the fast variant against the exact one; the internal RNG
     (32x24x8 spp, spp_chunks=2) against the twin fed the same hash tapes;
     and the main path's own call (fast, internal RNG, all 16 chunks),
     and the exact variant at that shape, against the twin;
  4. the main path: the Cornell box at 640x480, 256 spp, depth 5,
     spp_chunks=16 through make_renderer(differentiable=False), one
     warm-up and three seeds, with the launch counter reset just before
     and read just after; the images are finite, read right, and their
     means agree with the twin's at the same seeds;
  5. a line {"kernels": [...]}, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Imports nothing of JAX. Refuses to run without a card, or without the
repository beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
EXACT_TOL = dict(rtol=2e-5, atol=2e-6)
FAST_TOL = dict(rtol=2e-3, atol=1e-4)
MAX_SHARE_BEYOND = 1e-3
MEAN_RTOL = 1e-5
MAIN = dict(width=640, height=480, spp=256, max_depth=5, spp_chunks=16)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, tol: dict,
            mean_rtol: float | None = MEAN_RTOL) -> float:
    """Per-ray comparison of radiance f[3, N]; returns the max abs error."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite radiance")
    diff = (got - ref).abs()
    bad = diff > tol["atol"] + tol["rtol"] * ref.abs()
    share = bad.any(dim=0).float().mean().item()
    max_abs = diff.max().item()
    max_rel = (diff / ref.abs().clamp_min(1e-6)).max().item()
    mean_rel = abs(got.mean().item() / ref.mean().item() - 1.0)
    print(f"[compare] {name}: max_abs={max_abs!r} max_rel={max_rel!r} "
          f"share_beyond(rtol={tol['rtol']}, atol={tol['atol']})="
          f"{share!r} mean_rel={mean_rel!r}", flush=True)
    check(share <= MAX_SHARE_BEYOND,
          f"{name}: {share:.3%} of rays beyond tolerance")
    if mean_rtol is not None:
        check(mean_rel <= mean_rtol,
              f"{name}: means differ by {mean_rel:.3g} relative")
    return max_abs


def cuda_ms(fn, reps: int, warmup: int = 1,
            windows: int = 1) -> tuple[float, list, object]:
    """Device ms per fn() call: the median over `windows` windows of
    `reps` calls each, after `warmup` calls. The card idles at a low
    clock, so a short warm-up times part of its ramp; the window means
    are returned to show the spread."""
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


def reads_right(img: torch.Tensor, name: str) -> None:
    """Light at the top rows; image-left red-dominant, image-right
    green-dominant (the reference camera's x-mirrored basis)."""
    check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
    rows = img.shape[0] // 8
    cols = img.shape[1] // 8
    top, bottom = img[:rows].mean().item(), img[-rows:].mean().item()
    left = img[:, :cols].mean((0, 1)).tolist()
    right = img[:, -cols:].mean((0, 1)).tolist()
    print(f"[image] {name}: mean={img.mean().item()!r} top={top!r} "
          f"bottom={bottom!r} left_rgb={left} right_rgb={right}",
          flush=True)
    check(top > 2 * bottom, f"{name}: light is not at the top")
    check(left[0] > 1.5 * left[1], f"{name}: image-left is not red")
    check(right[1] > 1.5 * right[0], f"{name}: image-right is not green")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import drt_tpu_torch
    check(Path(drt_tpu_torch.__file__).resolve().parent.parent == HERE,
          "drt_tpu_torch must be the package beside this script")
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import albedo_table, emission_table
    from drt_tpu_torch.utils import native

    t_start = time.time()
    dev = torch.device("cuda")
    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(smi_line, flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # Phase 2: build the kernel.
    t0 = time.time()
    so = native.build(mk.SOURCE)
    print(f"[build] {mk.SOURCE} -> {so.relative_to(HERE)} in "
          f"{time.time() - t0:.1f}s", flush=True)
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)

    # Phase 3: kernel against its twin.
    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(1)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    for label, build in (("cbox", cbox.build),
                         ("glossy", gallery.build_glossy),
                         ("tri", gallery.build_tri)):
        scene, params, cam = build(device=dev)
        alb, emi = tables(scene, params)
        exact = mk.make_fused_tracer(scene, cam, cfg, rng="tape")
        got = exact(alb, emi, cam_u, tape)
        ref = mk.make_fused_tracer(scene, cam, cfg, rng="tape",
                                   plain=True)(alb, emi, cam_u, tape)
        compare(f"tape exact vs twin, {label}", got, ref, EXACT_TOL)
        fast = mk.make_fused_tracer(scene, cam, cfg, rng="tape",
                                    fastmath=True)(alb, emi, cam_u, tape)
        compare(f"tape fast vs exact, {label}", fast, got, FAST_TOL, None)

    cfg_i = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                         max_depth=5)
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    seeds = torch.tensor([2024, -77], dtype=torch.int32)
    got = mk.make_fused_tracer(scene, cam, cfg_i, n_chunks=2)(alb, emi,
                                                             seeds)
    ref = mk.fused_trace_plain(scene, mk.camera_consts(cam, 32, 24), cfg_i,
                               alb, emi, seeds=seeds, n_chunks=2)
    compare("internal rng exact vs twin, cbox 32x24x8", got, ref, EXACT_TOL)
    # The twin fed explicit hash tapes gives the same thing per chunk.
    c_u, c_t = hash_tapes(seeds, 32 * 24, 4, 5, device=dev, sample_base=4)
    one = mk.make_fused_tracer(scene, cam, RenderConfig(
        width=32, height=24, spp=4, max_depth=5), rng="tape")(
        alb, emi, c_u, c_t)
    first = mk.make_fused_tracer(scene, cam, cfg_i, n_chunks=1)(
        alb, emi, seeds)  # chunk 0 only
    compare("internal rng = tape of hash_tapes, chunks 0+1", first + one,
            got, EXACT_TOL)

    # The main path's own call: fast variant, internal RNG, 16 chunks.
    cfg_m = RenderConfig(**MAIN)
    n_rays = cfg_m.width * cfg_m.height * cfg_m.spp
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    main_trace = mk.make_fused_tracer(scene, cam, cfg_m, fastmath=True,
                                      n_chunks=cfg_m.spp_chunks)
    kernel_ms, kernel_windows, got = cuda_ms(
        lambda: main_trace(alb, emi, seeds), reps=10, warmup=20, windows=3)
    cc = mk.camera_consts(cam, cfg_m.width, cfg_m.height)
    plain_ms, plain_windows, ref = cuda_ms(lambda: mk.fused_trace_plain(
        scene, cc, cfg_m, alb, emi, seeds=seeds,
        n_chunks=cfg_m.spp_chunks), reps=1, windows=3)
    main_err = compare("main-path call (fast, internal, 640x480x256, 16 "
                       "chunks) vs twin", got, ref, FAST_TOL)
    exact = mk.make_fused_tracer(scene, cam, cfg_m, n_chunks=cfg_m.spp_chunks)
    compare("exact variant at the main-path shape vs twin",
            exact(alb, emi, seeds), ref, EXACT_TOL)
    print(f"[time] fused tracer at the main-path shape: kernel "
          f"{kernel_ms!r} ms ({n_rays / kernel_ms / 1e3!r} Mrays/s), "
          f"plain twin {plain_ms!r} ms ({n_rays / plain_ms / 1e3!r} "
          f"Mrays/s) on {smi_line}; window means: kernel "
          f"{kernel_windows!r}, twin {plain_windows!r}", flush=True)
    del got, ref

    # Phase 4: the main path through the user's entry point.
    render = make_renderer(scene, cfg_m, cam, differentiable=False)
    twin = make_renderer(scene, cfg_m, cam, differentiable=False,
                         backend="torch")
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2, 3)]
    mk.fused_trace.launches = 0
    images = []
    t_imgs = []
    for s in seed_list:  # the first is the warm-up
        t0 = time.perf_counter()
        images.append(render(params, s))
        torch.cuda.synchronize()
        t_imgs.append(time.perf_counter() - t0)
    launches = mk.fused_trace.launches
    print(f"[main] make_renderer(cuda) 640x480x256spp depth 5: launches="
          f"{launches} seconds={t_imgs[1:]!r} Mrays/s="
          f"{[n_rays / t / 1e6 for t in t_imgs[1:]]!r}", flush=True)
    check(launches >= 1, "the main path launched no kernel")
    t_twin = []
    for s, img in zip(seed_list[1:], images[1:]):
        check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
              f"image {tuple(img.shape)} {img.dtype}")
        reads_right(img, f"seed {s.tolist()}")
        t0 = time.perf_counter()
        ref_img = twin(params, s)
        torch.cuda.synchronize()
        t_twin.append(time.perf_counter() - t0)
        rel = abs(img.mean().item() / ref_img.mean().item() - 1.0)
        print(f"[main] seed {s.tolist()}: image mean kernel="
              f"{img.mean().item()!r} twin={ref_img.mean().item()!r} "
              f"rel={rel!r}", flush=True)
        check(rel <= MEAN_RTOL, f"image mean differs by {rel:.3g}")
    print(f"[main] make_renderer(torch) twin seconds={t_twin!r} Mrays/s="
          f"{[n_rays / t / 1e6 for t in t_twin]!r}", flush=True)
    print(f"[total] {time.time() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_tracer",
        "route": "cuda",
        "source": "drt_tpu_torch/csrc/fused_tracer.cu",
        "replaces": "drt_tpu/ops/megakernel.py:1024",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
