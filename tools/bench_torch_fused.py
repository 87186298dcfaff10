"""Time drt_tpu_torch's scene-table kernels and Cornell-box paths on one
NVIDIA GPU, so that two checkouts can be compared on one card, in one
sitting; and break the tracers' time down by section.

  python3 tools/bench_torch_fused.py [--root DIR] [--label NAME]
  python3 tools/bench_torch_fused.py --segments
  python3 tools/bench_torch_fused.py --regen-sweep
  python3 tools/bench_torch_fused.py --breakdown [--queue] [--root DIR]
  python3 tools/bench_torch_fused.py --split-tape [--root DIR]

Imports drt_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels from DIR's sources, and prints JSON lines:
  - "card": nvidia-smi's name and power limit;
  - "ptxas": each entry function's registers, stack and spills, per
    library, from the compiler's report;
  - "kernel": device ms per launch, the median of 3 windows of 10 launches
    after 20 warm-ups (CUDA events), with the window means: B1 (tracer),
    B2 (collect tracer) and B4 (retrace adjoint) at the main shape of
    chip_smoke.py (Cornell box, 640x480, 256 spp, depth 5, 16 chunks, fast
    variant, internal RNG, seeds (7, 8)) and at the CLI's default shape
    (640x480, 100 spp, depth 32, one chunk); where the checkout has them,
    the lockstep checking builds of B1, B2, B4 and B5b and, as the
    store-only yardstick, the zeroing of the collect tracer's buffers
    alone; B3 (sweep, also at the CLI shape, with its GB/s and share of
    the memory bound over every row and over the rows it needs), B10
    (regeneration tracer, both forms) and B11 (its sweep) at the main
    shape; B5a and B5b (wavefront) on one chunk of it; and what
    --segments prints alone: B14 (early exit, exact) at the main shape
    and at 640x480x32, depths 8, 16 and 32, beside B1 exact in both
    builds; B1-seg's launches on chunk 1 of the main shape, [0, 2) from
    the camera, [2, 5) over every lane and in the compacted chain's
    layout (`segment_layouts`, chip_smoke.py's phase 15 inputs) and the
    uncompacted tape chain's two, and B4-seg's launches [2, 5) and
    [0, 2) in both layouts, each in every build the checkout has, with
    the share of lane-bounces that live, the lane-trips a queue runs
    (`segment_trips_plain`), the resident blocks per SM of B1-seg's
    kernels and the loop each launch runs where the checkout chooses one
    ("segments" lines); and the compacted renderer's forward and step
    ("path"); and what --regen-sweep prints alone: B11 at the main
    shape, at the CLI shape and on one chunk in every build the
    checkout has, with the kernel its entry point runs, and the
    "cuda-regen" forward, stored and retrace steps and trainer step;
  - "digest": SHA-256 of B1's radiance and of B2's radiance, rsc and rbest
    at the main shape (fast and exact), at the CLI default shape (fast)
    and in tape mode (one chunk of the main shape, its hash tapes, fast);
    of B4's gradient tables at the main shape (fast and exact) and in tape
    mode, of B3's at the main and CLI shapes (fast), of B5b's on one
    chunk, of B14's radiance and of B4-seg's tables and S_start: equal
    digests across checkouts mean bit-equal outputs;
  - "path": the Cornell box through the user's entry points, seconds on
    the host clock with a synchronize (median of 5 after 2 warm-ups):
    make_renderer forward at the main shape and at the CLI default shape,
    a forward+backward step of the mean squared image loss in the stored
    and the retrace forms and unbiased with 2 adjoint samples, the stored
    step at the CLI default shape, and the
    trainer step of optim.inverse_render (a
    call of 10 steps less a call of 5, over 5).
With --breakdown it prints "breakdown" lines instead: the lockstep loop's
checking build at the main shape (cycles per section of a warp-bounce,
clock64() summed over the warps, and the live lanes per warp-bounce by
bounce), both forms; the same sections on B10's trips; B4's lockstep
loop in its timing build (the bounce's sections, the sweep, the block
reduction; with --queue also B4's queue, where the last is the flush of
a slot's column); the SASS
instruction counts (LDS, MUFU, the division's FCHK, CALLs to slow paths,
branches) of a shape test and of shade in the fast builds, from nvdisasm
of a -lineinfo cubin of csrc/fused_tracer.cu; and with --queue the
queue's checking build (lane-trips, warp-trips, sections, and its trip
counter against ops.megakernel.trip_counts_plain).
With --split-tape it builds no kernel and prints "tape" lines: one
chunk's `fused.split_prefix_tape` at chip_smoke.py's split cells (phases
18 and 20: Cornell box, 640x480x16 spp, 4 chunks, depth 5, bsdf_samples
2, 19,660,800 lanes a chunk), device ms as "kernel" lines time them, and
the SHA-256 of (cam_u, tape): the whole chunk and, where the checkout's
`split_prefix_tape` takes lanes=, shards 0 and 1 of 2 (whole leaves) and
shard 1 of 3 (parts of leaves).
Run the comparison on the checkouts in turns (A, B, B, A) to see the
card's drift.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

MAIN = dict(width=640, height=480, spp=256, max_depth=5, spp_chunks=16)
CLI = dict(width=640, height=480, spp=100, max_depth=32, spp_chunks=1)


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


PEAK_BYTES_PER_S = 3.35e12  # H100 SXM peak device memory rate


def sweep_rates(torch, ms: float, live) -> dict:
    """GB/s and share of bound of a sweep (B3, B8) that took `ms` on rows
    whose live mask is live bool[C, D, N] (or [D, N]): over every row
    (rsc and the word, 8 bytes a bounce-ray), and over the rows the
    function needs, a slot's words up to its first dead row and its rsc
    before it (sweep_rows.cuh)."""
    live = live.reshape(-1, live.shape[-2], live.shape[-1])
    D = live.shape[1]
    n_live = torch.cumprod(live.to(torch.int32), dim=1).sum(dim=1)
    every = 8 * live.numel()
    needed = 4 * int((n_live + (n_live < D).to(torch.int32)).sum()
                     + n_live.sum())
    out = {}
    for what, n_bytes in (("every row", every), ("needed rows", needed)):
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        out[what] = dict(bytes=n_bytes, gb_s=n_bytes / ms / 1e6,
                         bound_ms=bound_ms, share_of_bound=bound_ms / ms)
    return out


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


# ---------------------------------------------------------------------------
# SASS counts by source section.

def _line_of(text: str, needle: str, start: int = 0) -> int:
    """1-based line of the first line at or after `start` holding needle."""
    for k, line in enumerate(text.splitlines()[start:], start + 1):
        if needle in line:
            return k
    raise ValueError(f"{needle!r} not found")


def source_sections(csrc: Path) -> dict:
    """name -> (file name, first line, last line) of the source regions a
    SASS instruction is attributed to by its line info."""
    inc = (csrc / "fused_bounce.inc").read_text()
    common = (csrc / "drt_common.cuh").read_text()
    loop = _line_of(inc, "for (int k = 0; k < cfg.n_shapes; ++k)")
    plane = _line_of(inc, "if (st == PLANE) {", loop)
    sphere = _line_of(inc, "} else if (st == SPHERE) {", plane)
    tri = _line_of(inc, "} else {  // TRIANGLE", sphere)
    valid = _line_of(inc, "if (valid && tk < best_t)", tri)
    shade = _line_of(common, "static __device__ __forceinline__ void shade(")
    shade_end = _line_of(common, "// The grid of a persistent kernel", shade)
    hash0 = _line_of(common, "static __device__ __forceinline__ uint32_t fmix")
    hash1 = _line_of(common, "// max(x, 0) that keeps NaN", hash0)
    cam0 = _line_of(common, "static __device__ __forceinline__ void "
                    "primary_dir(")
    cam1 = _line_of(common, "// The (rr, u1, u2) uniforms of bounce bnc.",
                    cam0)
    return {"shape loop": ("fused_bounce.inc", loop, plane - 1),
            "plane test": ("fused_bounce.inc", plane, sphere - 1),
            "sphere test": ("fused_bounce.inc", sphere, tri - 1),
            "triangle test": ("fused_bounce.inc", tri, valid - 1),
            "nearest-hit update": ("fused_bounce.inc", valid, valid + 4),
            "shade": ("drt_common.cuh", shade, shade_end - 1),
            "keyed hash": ("drt_common.cuh", hash0, hash1 - 1),
            "camera ray": ("drt_common.cuh", cam0, cam1 - 1)}


def _opcode(ins: str) -> str:
    tokens = ins.split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0] if tokens else ""


def sass_counts(native, csrc: Path, kernels: list, out_dir: Path) -> dict:
    """Per kernel (a substring of its mangled name) and section: the number
    of SASS instructions and of LDS, MUFU, FCHK (the IEEE division's
    range check), CALL (slow-path subroutines) and BRA among them, from
    nvdisasm -g of csrc/fused_tracer.cu built with -lineinfo (which leaves
    the code as it is: the totals are printed beside the .so's)."""
    nvcc = native.nvcc_path()
    bindir = Path(nvcc).parent
    flags = [f for f in native.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    cubin = out_dir / "fused_tracer_lineinfo.cubin"
    subprocess.run([nvcc, *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                    str(csrc / "fused_tracer.cu")], check=True,
                   capture_output=True, text=True)
    text = subprocess.run([str(bindir / "nvdisasm"), "-g", "-c", str(cubin)],
                          check=True, capture_output=True,
                          text=True).stdout
    regions = source_sections(csrc)
    fn, loc = None, None
    counts: dict = {}
    for line in text.splitlines():
        m = re.match(r"\s*\.section\s+\.text\.(\S+?),", line)
        if m:
            fn, loc = m.group(1), None
            continue
        m = re.search(r'File "([^"]+)", line (\d+)', line)
        if m:
            loc = (Path(m.group(1)).name, int(m.group(2)))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if not m or fn is None:
            continue
        key = next((k for k in kernels if k in fn), None)
        if key is None:
            continue
        op = _opcode(m.group(1))
        names = ["total"]
        if loc is not None:
            names += [name for name, (f, a, b) in regions.items()
                      if loc[0] == f and a <= loc[1] <= b]
        for name in names:
            c = counts.setdefault(key, {}).setdefault(
                name, dict(instructions=0, LDS=0, MUFU=0, FCHK=0, CALL=0,
                           BRA=0, slow_paths=[]))
            c["instructions"] += 1
            for cls in ("LDS", "MUFU", "FCHK", "CALL", "BRA"):
                if op.split(".")[0] == cls:
                    c[cls] += 1
            if op.startswith("CALL"):
                callee = re.search(r"\(([^)]*)\)", m.group(1))
                c["slow_paths"].append(callee.group(1) if callee else op)
    so_text = subprocess.run([str(bindir / "cuobjdump"), "-sass",
                              str(native.library_path("fused_tracer.cu"))],
                             check=True, capture_output=True,
                             text=True).stdout
    for key in kernels:
        n, inside = 0, False
        for line in so_text.splitlines():
            if "Function :" in line:
                inside = key in line
            elif inside and re.search(r"/\*[0-9a-f]{4,}\*/\s+[^;]*;", line):
                n += 1
        counts.setdefault(key, {})["so_total"] = n
    return counts


# ---------------------------------------------------------------------------

def regen_occupancy(torch, native, root: Path) -> dict:
    """Resident blocks per SM of B10's two forms (fast variant) by the
    occupancy API, from a scratch library that includes root's
    csrc/regen_tracer.cu (its kernel template regen_trace_kernel<FAST,
    COLLECT, COUNT>), with the SM count."""
    import ctypes

    csrc = root / "drt_tpu_torch" / "csrc"
    out_dir = root / "drt_tpu_torch" / "_build" / "occupancy"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "regen_occupancy.cu"
    src.write_text(
        f'#include "{csrc / "regen_tracer.cu"}"\n'
        'extern "C" int drt_occupancy(int collect, int* per_sm, int* sms) {\n'
        '  cudaError_t e = cudaDeviceGetAttribute(\n'
        '      sms, cudaDevAttrMultiProcessorCount, 0);\n'
        '  if (e != cudaSuccess) return (int)e;\n'
        '  return (int)(collect\n'
        '      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
        '            per_sm, regen_trace_kernel<true, true, false>, DRT_BLOCK,'
        ' 0)\n'
        '      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
        '            per_sm, regen_trace_kernel<true, false, false>,'
        ' DRT_BLOCK, 0));\n'
        '}\n')
    lib_path = out_dir / "regen_occupancy.so"
    subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    out = {}
    for collect in (0, 1):
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        rc = lib.drt_occupancy(collect, ctypes.byref(per_sm),
                               ctypes.byref(sms))
        if rc:
            raise RuntimeError(f"occupancy query failed: {rc}")
        out["collect" if collect else "tracer"] = per_sm.value
        out["sms"] = sms.value
    return out


def regen_cycles(rg, stats: dict, scene, table, cc, cfg, alb, emi,
                 seeds) -> dict:
    """B10's cycles by section: from its checking build's counters, or,
    in a checkout whose timing build is a form of its own, from that."""
    if "cycles" in stats:
        return stats.pop("cycles")
    return rg.regen_sections(scene, table, cc, cfg, alb, emi, seeds,
                             n_chunks=cfg.spp_chunks)["cycles"]


def parts(torch, label: str, root: Path) -> None:
    """The parts of one chunk of the "cuda-wavefront" forward at the main
    shape (chunk_rays, the keyed draw of the tape, B5a in each form the
    checkout has) and B5a's live lane-bounces on it; B10 at the main
    shape: resident blocks per SM and waves, lane-trips and the lane
    groups (a grid of one thread per pixel) or warp-trips (the persistent
    grid) that ran them, cycles per section, the spread of trips over
    pixels and over (pixel, chunk) units, the persistent grid where the
    checkout has one, and both forms timed in each hand-out the checkout
    has, with their digests; then the "cuda-regen" and "cuda-wavefront"
    paths (`wave_and_regen_paths`)."""
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.ops.rng import bounce_tape
    from drt_tpu_torch.ops.vecmath import V3
    from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                        chunk_sample_ids, trace_rays)
    from drt_tpu_torch.scene import Params, albedo_table, emission_table
    from drt_tpu_torch.utils import native

    dev = torch.device("cuda")
    cfg = RenderConfig(**MAIN)
    C, D = cfg.spp_chunks, cfg.max_depth
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    npix = cfg.width * cfg.height

    # One chunk of the wavefront forward, its parts in the forward's order.
    xy = chunk_pixel_ids(cfg, dev)
    pix, smp = chunk_sample_ids(cfg, xy, 1)
    n = pix.shape[0]
    ms_rays, win, (o, d, _) = cuda_ms(
        torch, lambda: chunk_rays(cam, cfg, xy, seeds, 1))
    emit("kernel", label, name="wavefront chunk_rays, one chunk", ms=ms_rays,
         windows=win)
    ms_draw, win, u = cuda_ms(
        torch, lambda: bounce_tape(int(seeds[1]), pix, smp, D))
    emit("kernel", label, name="wavefront bounce_tape, one chunk",
         ms=ms_draw, windows=win)
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
    ms, win, L = cuda_ms(torch, lambda: mk.ray_trace(scene, table, cfg, alb,
                                                     emi, o, d, u))
    emit("kernel", label, name="B5a tape form, forward's chunk", ms=ms,
         windows=win)
    emit("digest", label, name="B5a radiance, forward's chunk",
         sha256=digest(L))
    keyed = "seeds" in inspect.signature(mk.ray_trace).parameters
    if keyed:
        pix32, smp32 = pix.int(), smp.int()
        ms, win, Lk = cuda_ms(torch, lambda: mk.ray_trace(
            scene, table, cfg, alb, emi, o, d, seeds=seeds, pix=pix32,
            sample=smp32))
        emit("kernel", label, name="B5a keyed form, forward's chunk", ms=ms,
             windows=win, equal_tape_form=bool(torch.equal(Lk, L)))
        ms, win, Ll = cuda_ms(torch, lambda: mk.ray_trace(
            scene, table, cfg, alb, emi, o, d, u, build="lockstep"))
        emit("kernel", label, name="B5a lockstep build, forward's chunk",
             ms=ms, windows=win, equal_queue=bool(torch.equal(Ll, L)))
        del Lk, Ll
    _, res = trace_rays(Params(alb[:-1], emi[:-1]), scene, V3(*o), V3(*d),
                        cfg, tape=u, collect=True)
    live = int((res.gate > 0).sum())
    emit("parts", label, what="B5a, forward's chunk", rays=n,
         live_lane_bounces=live, lane_bounces=n * D,
         live_share=live / (n * D), chunk_rays_ms=ms_rays,
         bounce_tape_ms=ms_draw)
    del o, d, u, L, res
    torch.cuda.empty_cache()

    # B10 at the main shape.
    kw = dict(fastmath=True, n_chunks=C)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    occ = regen_occupancy(torch, native, root)
    blocks = -(-npix // mk.BLOCK)
    emit("parts", label, what="B10 occupancy", blocks_per_sm=occ,
         pixel_grid_blocks=blocks,
         waves={f: blocks / (occ[f] * occ["sms"])
                for f in ("tracer", "collect")},
         resident_lanes={f: occ[f] * occ["sms"] * mk.BLOCK
                         for f in ("tracer", "collect")})
    for _ in range(2):  # the first is the warm-up
        st = rg.regen_trip_stats(scene, table, cc, cfg, alb, emi, seeds,
                                 n_chunks=C)
    out = st.pop("radiance")
    cycles = regen_cycles(rg, st, scene, table, cc, cfg, alb, emi, seeds)
    _, trips_i = rg.regen_trace(scene, table, cc, cfg, alb, emi, seeds,
                                fastmath=True, n_chunks=C)
    trips = trips_i.long()  # [C, npix]
    per_pix = trips.sum(dim=0)
    lanes = occ["tracer"] * occ["sms"] * mk.BLOCK
    # What the warps of each hand-out need at least: a pixel unit runs a
    # pixel's chunks in one lane, so a lane's trips are whole pixels' (the
    # lanes of the pixel grid: 2 or 3 pixels each at this shape); a (pixel,
    # chunk) unit spreads a lane's trips over ~C times more units.
    emit("parts", label, what="B10 trips", **st,
         cycles_per_group_trip={k: v / st["group_trips"]
                                for k, v in cycles.items()},
         pixel_trips_mean=float(per_pix.float().mean()),
         pixel_trips_max=int(per_pix.max()),
         pixel_trips_min=int(per_pix.min()),
         unit_trips_mean=float(trips.float().mean()),
         unit_trips_max=int(trips.max()),
         lane_trips_if_even=float(per_pix.sum()) / lanes,
         pixels_per_lane=npix / lanes,
         radiance_digest=digest(out))
    emit("digest", label, name="B10 radiance, main shape, fast",
         sha256=digest(out))
    emit("digest", label, name="B10 trips, main shape, fast",
         sha256=digest(trips_i))
    del out, trips, trips_i
    if hasattr(rg, "regen_grid"):
        for collect in (False, True):
            emit("parts", label, what="B10 grid", collect=collect,
                 **rg.regen_grid(cfg, n_chunks=C, collect=collect))
    # Both forms in each hand-out the checkout has, with their digests.
    for unit in getattr(rg, "UNITS", (None,)):
        ukw = {} if unit is None else dict(unit=unit)
        ms, win, (L, trips) = cuda_ms(torch, lambda: rg.regen_trace(
            scene, table, cc, cfg, alb, emi, seeds, **kw, **ukw))
        emit("kernel", label, name=f"B10 tracer, unit {unit}", ms=ms,
             windows=win, radiance=digest(L), trips=digest(trips))
        ms, win, (L, rsc, rmeta, trips) = cuda_ms(
            torch, lambda: rg.regen_collect(scene, table, cc, cfg, alb, emi,
                                            seeds, **kw, **ukw))
        own = (torch.arange(rsc.shape[1], device=dev)[None, :, None]
               < trips[:, None, :])
        emit("kernel", label, name=f"B10 collect form, unit {unit}", ms=ms,
             windows=win, radiance=digest(L), trips=digest(trips),
             rows=[digest(torch.where(own, rsc, 0.0)),
                   digest(torch.where(own, rmeta, 0))])
        del L, rsc, rmeta, trips, own
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    wave_and_regen_paths(torch, label, scene, params, cam)


def wave_and_regen_paths(torch, label: str, scene, params, cam) -> None:
    """The "cuda-wavefront" and "cuda-regen" paths at the main shape on the
    host clock with a synchronize (median of 5 after 2 warm-ups, the
    wavefront's of 3 after 1): forward, a biased fwd+bwd step (stored for
    regen), the trainer step (3 steps after 1, over 3), with digests of
    the forward's images."""
    from drt_tpu_torch import optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    cfg = RenderConfig(**MAIN)
    s_img = torch.tensor([1, 2], dtype=torch.int32)
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    start = params.albedo.clone()
    start[1] = torch.tensor([0.2, 0.15, 0.1], device=start.device)
    for backend, reps, warmup in (("cuda-regen", 5, 2),
                                  ("cuda-wavefront", 3, 1)):
        render = make_renderer(scene, cfg, cam, differentiable=False,
                               backend=backend)
        img = render(params, s_img)
        emit("digest", label, name=f"{backend} image, main shape",
             sha256=digest(img))
        med, times = host_s(torch, lambda: render(params, s_img), reps,
                            warmup)
        emit("path", label, name=f"{backend} forward, main shape", s=med,
             times=times)
        target = img.detach()
        diff = make_renderer(scene, cfg, cam, backend=backend)

        def step():
            p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
            ((diff(p, s_img) - target) ** 2).mean().backward()
            return p.albedo.grad, p.emission.grad

        emit("digest", label, name=f"{backend} step gradients, main shape",
             sha256=[digest(t) for t in step()])
        med, times = host_s(torch, step, reps, warmup)
        emit("path", label, name=f"{backend} fwd+bwd step, main shape",
             s=med, times=times)

        def train(n_steps):
            t0 = time.perf_counter()
            optim.inverse_render(scene, cfg, cam, target,
                                 Params(start, params.emission),
                                 torch.Generator().manual_seed(5),
                                 steps=n_steps, backend=backend)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        train(1)  # warm-up
        emit("path", label, name=f"{backend} trainer step", s=train(3) / 3)
        del render, diff, target, img
        torch.cuda.empty_cache()


def regen_sweep_and_paths(torch, label: str) -> None:
    """B11 in each build the checkout has ("queue", the entry point, and
    "lockstep", its checking build, the per-pixel kernel) at the main
    shape, at the CLI's default shape (one chunk, depth 32) and on one
    chunk of the main shape as the retrace launches it, with the kernel
    the entry point runs and the digests of its tables; then the
    "cuda-regen" paths at the main shape: forward, stored and retrace
    fwd+bwd steps (median of 5 after 2 warm-ups) and the trainer step
    (3 steps after 1, over 3), with digests of the image and gradients."""
    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(11)
    builds = (("queue", "lockstep") if "build" in inspect.signature(
        rg.regen_sweep).parameters else (None,))
    main = RenderConfig(**MAIN)
    spp_c = main.spp // main.spp_chunks
    one = RenderConfig(width=main.width, height=main.height, spp=spp_c,
                       max_depth=main.max_depth)
    for shape, cfg, C, base in (("main shape", main, main.spp_chunks, 0),
                                ("CLI shape", RenderConfig(**CLI), 1, 0),
                                ("chunk 1 of the main shape", one, 1,
                                 spp_c)):
        _, rsc, rmeta, trips = rg.make_regen_tracer(
            scene, cam, cfg, fastmath=True, collect=True, n_chunks=C)(
            alb, emi, seeds, base)
        g = torch.rand((3, cfg.width * cfg.height), generator=gen,
                       device=dev) / main.spp
        if builds[0] is not None:
            emit("segments", label, what="B11 kernel", shape=shape,
                 form=rg.regen_sweep_form(cfg, alb, emi))
        for build in builds:
            bkw = {} if build is None else dict(build=build)
            tag = "" if build is None else f", {build} build"
            sweep = rg.make_regen_sweep_adjoint(scene, cfg, n_chunks=C,
                                                **bkw)
            ms, win, out = cuda_ms(torch, lambda: sweep(alb, emi, rsc,
                                                        rmeta, trips, g))
            emit("kernel", label, name=f"B11 regen sweep, {shape}{tag}",
                 ms=ms, windows=win, rows=int(trips.sum()))
            emit("digest", label, name=f"B11 tables, {shape}{tag}",
                 sha256=[digest(t) for t in out])
        del rsc, rmeta, trips
        torch.cuda.empty_cache()

    cfg = main
    s_img = torch.tensor([1, 2], dtype=torch.int32)
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    render = make_renderer(scene, cfg, cam, differentiable=False,
                           backend="cuda-regen")
    target = render(params, s_img).detach()
    emit("digest", label, name="cuda-regen image, main shape",
         sha256=digest(target))
    med, times = host_s(torch, lambda: render(params, s_img))
    emit("path", label, name="cuda-regen forward, main shape", s=med,
         times=times)
    for adjoint in ("stored", "retrace"):
        diff = fused.make_regen_image_renderer(scene, cam, cfg,
                                               adjoint=adjoint)

        def step():
            p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
            ((diff(p, s_img) - target) ** 2).mean().backward()
            return p.albedo.grad, p.emission.grad

        emit("digest", label, name=f"cuda-regen {adjoint} step gradients, "
             "main shape", sha256=[digest(t) for t in step()])
        med, times = host_s(torch, step)
        emit("path", label, name=f"cuda-regen {adjoint} fwd+bwd step, main "
             "shape", s=med, times=times)
    start = params.albedo.clone()
    start[1] = torch.tensor([0.2, 0.15, 0.1], device=start.device)

    def train(n_steps):
        t0 = time.perf_counter()
        optim.inverse_render(scene, cfg, cam, target,
                             Params(start, params.emission),
                             torch.Generator().manual_seed(5),
                             steps=n_steps, backend="cuda-regen")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    train(1)  # warm-up
    emit("path", label, name="cuda-regen trainer step", s=train(3) / 3)


def breakdown(torch, label: str, root: Path, queue: bool) -> None:
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.scene import albedo_table, emission_table
    from drt_tpu_torch.utils import native

    dev = torch.device("cuda")
    cfg = RenderConfig(**MAIN)
    C, D = cfg.spp_chunks, cfg.max_depth
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    kw = dict(fastmath=True, n_chunks=C)
    loops = (False, True) if queue else (False,)
    for q in loops:
        for collect in (False, True):
            mk.fused_trace_stats(scene, table, cc, cfg, alb, emi, seeds,
                                 queue=q, collect=collect, **kw)  # warm-up
            torch.cuda.synchronize()
            st = mk.fused_trace_stats(scene, table, cc, cfg, alb, emi, seeds,
                                      queue=q, collect=collect, **kw)
            steps = st["warp_steps"]
            hist = st["live_hist"].cpu()
            k = torch.arange(33)
            by_bounce = [dict(warp_bounces=int(h.sum()),
                              mean_live=(float((h * k).sum() / h.sum())
                                         if h.sum() else 0.0),
                              all_dead=int(h[0]), all_live=int(h[32]))
                         for h in hist]
            extra = {}
            if q:
                ref = mk.trip_counts_plain(cfg, st["rbest"], seeds=seeds) \
                    if collect else None
                extra = dict(trips_sum=int(st["trips"].sum()),
                             trips_equal_plain=(None if ref is None else
                                                bool(torch.equal(
                                                    st["trips"], ref))))
            emit("breakdown", label, what=("queue" if q else "lockstep")
                 + (" collect" if collect else " tracer"),
                 **{name: st[name] for name in mk.STEP_STATS},
                 cycles=st["cycles"],
                 cycles_per_warp_step={s: v / steps for s, v in
                                       st["cycles"].items()},
                 live_by_bounce=None if q else by_bounce,
                 live_hist=None if q else hist.tolist(), **extra)
            del st
    # B10's trips, in its timing build, and its warp-trips.
    for _ in range(2):  # the first is the warm-up
        ts = rg.regen_trip_stats(scene, table, cc, cfg, alb, emi, seeds,
                                 n_chunks=C)
    cycles = regen_cycles(rg, ts, scene, table, cc, cfg, alb, emi, seeds)
    emit("breakdown", label, what="regen tracer (B10)",
         cycles=cycles, group_trips=ts["group_trips"],
         lane_trips=ts["lane_trips"],
         cycles_per_group_trip={s: v / ts["group_trips"]
                                for s, v in cycles.items()})
    # B4's lockstep loop in its timing build: the bounce's sections, the
    # hook's stores, the sweep after each chunk and the block reduction.
    if hasattr(mk, "fused_adjoint_stats"):
        npix = cfg.width * cfg.height
        g = torch.Generator(device=dev).manual_seed(11)
        g_pix = torch.rand((3, npix), generator=g, device=dev) / cfg.spp
        akw = dict(fastmath=True, n_chunks=C)
        ref = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g_pix,
                               seeds=seeds, **akw)
        has_queue = "queue" in inspect.signature(
            mk.fused_adjoint_stats).parameters
        for q in loops if has_queue else (False,):
            if has_queue:
                akw["queue"] = q
            for _ in range(2):  # the first is the warm-up
                st = mk.fused_adjoint_stats(scene, table, cc, cfg, alb, emi,
                                            g_pix, seeds, **akw)
            steps = st["warp_steps"]
            emit("breakdown", label, what="B4 retrace adjoint, "
                 + ("queue" if q else "lockstep"),
                 **{name: st[name] for name in mk.STEP_STATS},
                 cycles=st["cycles"],
                 cycles_per_warp_step={s: v / steps for s, v in
                                       st["cycles"].items()},
                 grads_equal_b4=all(bool(torch.equal(a, b))
                                    for a, b in zip(st["grads"], ref)))
            del st
        del ref
    kernels = ["fused_trace_kernelILb1ELb1ELb0ELb0E"]
    if queue:
        kernels.append("queue_trace_kernelILb1ELb1ELb0ELb0E")
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        counts = sass_counts(native, root / "drt_tpu_torch" / "csrc",
                             kernels, Path(tmp))
    for key, c in counts.items():
        emit("sass", label, kernel=key, sections=c)


def segment_trips_plain(cfg, rbest, tape, b0: int, b1: int):
    """The trips each lane of one chunk takes in bounces [b0, b1) on a
    queue that spends a trip only on a bounce its path enters alive (the
    roulette of the bounce passed): from a collect tracer's rows rbest
    i32[D, N] of that chunk and the roulette draws in row (b, 0) of its
    tape f32[D, 3, N], as ops.megakernel.trip_counts_plain counts
    [0, max_depth). i32[N]."""
    import torch
    n = rbest.shape[1]
    trips = torch.zeros(n, dtype=torch.int32, device=rbest.device)
    for b in range(b0, b1):
        enter = (torch.ones(n, dtype=torch.bool, device=rbest.device)
                 if b == 0 else rbest[b - 1] > 0)
        if b >= cfg.min_bounces:
            enter &= ~(tape[b, 0].float() < cfg.absorb_prob)
        trips += enter
    return trips


def segment_layouts(torch, scene, cam, cfg, alb, emi, seeds, b: int,
                    chunk: int) -> dict:
    """The inputs of B4-seg's two launches on one chunk, split before
    bounce b, internal RNG, as chip_smoke.py's phase 15 makes them: "n"
    lanes of the chunk, the per-pixel cotangent "g_pix" of [0, b), and
    per layout (K, ray, alive, ray_idx, g, scatter) of segment [b, D):
    every lane of the chunk (scatter None: S_start is the next launch's
    S_end as it is), or the compacted chain's K = compacted_capacities
    lanes (the live lanes in ascending order, dead pad lanes after them;
    scatter is the lane -> slot index, the pad slot n); g is g_pix at
    each lane's pixel. "counts": the lanes, the live lanes at the split
    and the live lane-bounces of each segment with their share."""
    from drt_tpu_torch import fused
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import hash_tapes

    dev = alb.device
    D = cfg.max_depth
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    n = npix * spp_c
    # chip_smoke.py's draws before its main shape: its digests are these.
    g = torch.Generator(device=dev).manual_seed(41)
    for shape in ((2, 64 * 48 * 4), (5, 3, 64 * 48 * 4), (3, 64 * 48 * 4)):
        torch.rand(shape, generator=g, device=dev)
    g_pix = torch.rand((3, npix), generator=g, device=dev) / cfg.spp
    _, (ray, alive) = mk.make_fused_segment_tracer(scene, cam, cfg, 0, b)(
        alb, emi, seeds, chunk=chunk)
    # The live lane-bounces of each segment, from the collect tracer's
    # rows of this chunk (its hash tapes, tape mode).
    cu, tp = hash_tapes(seeds, npix, spp_c, D, sample_base=chunk * spp_c,
                        device=dev)
    _, _, rbest = mk.fused_collect(scene, mk.scene_table(scene),
                                   mk.camera_consts(cam, cfg.width,
                                                    cfg.height),
                                   cfg, alb, emi, cam_u=cu, tape=tp)
    live = [int((rbest[:b] > 0).sum()), int((rbest[b:] > 0).sum())]
    trips = [int(segment_trips_plain(cfg, rbest, tp, b0, b1).sum())
             for b0, b1 in ((0, b), (b, D))]
    del cu, tp, rbest
    caps = fused.compacted_capacities(cfg, (b,))
    on = alive > 0
    idx = fused.compact_lanes(on, caps[1], caps[0])
    every = torch.arange(n, dtype=torch.int32, device=dev)

    def gather(*rows):
        return [torch.nn.functional.pad(r, (0, 1))[..., idx].contiguous()
                for r in rows]

    def g_at(lanes):
        return g_pix[:, lanes.long() % npix].contiguous()

    return dict(n=n, g_pix=g_pix, layouts={
        "every lane": (n, ray, alive, every, g_at(every), None),
        "compacted": (caps[1], *gather(ray, alive), idx.to(torch.int32),
                      g_at(idx), idx)}, counts=dict(
        lanes=caps, live_lanes_at_split=int(on.sum()),
        live_lane_bounces=live, queue_lane_trips=trips,
        live_share={f"[0, {b}) of every lane": live[0] / (n * b),
                    f"[{b}, {D}) of every lane": live[1] / (n * (D - b)),
                    f"[{b}, {D}) compacted": live[1] / (caps[1] * (D - b))}))


def segment_tracer_times(torch, label: str, scene, cam, cfg, alb, emi,
                         seeds, b: int, chunk: int, layouts: dict) -> None:
    """B1-seg's launches on chunk `chunk` of the main shape, split before
    bounce b: [0, b) from the camera, and [b, D) on every lane of the
    chunk and on the compacted chain's lanes (internal RNG); then the
    uncompacted tape chain (the chunk's hash tapes, tape mode), [0, b)
    and [b, D). In each build the checkout has ("queue", the entry point,
    and "lockstep", its checking build), with the digests of radiance and
    exit state, the loop the entry point runs at each b_start where the
    checkout chooses one, and the resident blocks per SM of its
    kernels."""
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.utils import native
    import ablate_variants as ablate

    D = cfg.max_depth
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    root = Path(mk.__file__).resolve().parents[2]
    queue = hasattr(mk, "segment_trace_form")
    kernels = {f"segment_trace_kernel<{f}, {i}>":
               (f"segment_trace_kernel<{f}, {i}>", 0)
               for f in ("true", "false") for i in ("true", "false")}
    if queue:
        kernels.update({
            f"segment_queue_trace_kernel<{f}, {i}>":
            (f"segment_queue_trace_kernel<{f}, {i}, false, false>", 0)
            for f in ("true", "false") for i in ("true", "false")})
        emit("segments", label, what="B1-seg loops", loops={
            f"[{b0}, {b1})": mk.segment_trace_form(b0)
            for b0, b1 in ((0, b), (b, D))})
    emit("occupancy", label, source="fused_tracer.cu",
         blocks_per_sm=ablate.occupancy(native, root, "fused_tracer.cu",
                                        kernels))
    builds = ("queue", "lockstep") if queue else (None,)
    cu, tp = mk.hash_tapes(seeds, npix, spp_c, D, sample_base=chunk * spp_c,
                           device=alb.device)
    for build in builds:
        bkw = {} if build is None else dict(build=build)
        tag = "" if build is None else f", {build} build"

        def seg(b0, b1, **kw):
            return mk.make_fused_segment_tracer(scene, cam, cfg, b0, b1,
                                                **kw, **bkw)

        runs = {f"[0, {b}) from the camera": (
            seg(0, b), (alb, emi, seeds), dict(chunk=chunk))}
        for layout, (K, rayB, aliveB, ridx, _, _) in layouts.items():
            runs[f"[{b}, {D}) on {K} lanes, {layout}"] = (
                seg(b, D, n_rays=K), (alb, emi, seeds, rayB, aliveB, ridx),
                dict(chunk=chunk))
        tapeA = seg(0, b, rng="tape")
        _, (ray_t, alive_t) = tapeA(alb, emi, cu, tp[:b].contiguous())
        runs[f"[0, {b}), tape chain"] = (
            tapeA, (alb, emi, cu, tp[:b].contiguous()), {})
        runs[f"[{b}, {D}), tape chain"] = (
            seg(b, D, rng="tape"),
            (alb, emi, tp[b:].contiguous(), ray_t, alive_t), {})
        for name, (fn, args, kw) in runs.items():
            ms, win, out = cuda_ms(torch, lambda: fn(*args, **kw))
            emit("kernel", label, name=f"B1-seg {name}, one chunk{tag}",
                 ms=ms, windows=win)
            outs = out if isinstance(out, torch.Tensor) else (
                out[0], *out[1])
            emit("digest", label, name=f"B1-seg {name}{tag}: radiance"
                 + ("" if isinstance(out, torch.Tensor)
                    else ", exit ray, alive"),
                 sha256=[digest(t) for t in (
                     (outs,) if isinstance(outs, torch.Tensor) else outs)])
            del out, outs
        del ray_t, alive_t
        torch.cuda.empty_cache()


# B14 against B1 exact: the main shape, then 640x480x32 (one chunk) deeper.
EARLYEXIT_SHAPES = (
    ("main shape", MAIN),
    *((f"640x480x32, depth {d}", dict(width=640, height=480, spp=32,
                                       max_depth=d)) for d in (8, 16, 32)))


def segments_and_earlyexit(torch, label: str) -> None:
    """B14 (exact, internal RNG) at EARLYEXIT_SHAPES beside B1 exact in
    both builds; B4-seg's two launches ([2, 5) then [0, 2)) on chunk 1 of
    the main shape in two layouts, the bench's (every lane of the chunk in
    both segments) and the compacted chain's (the live lanes after the
    split gathered into compacted_capacities' K lanes, the rest dead pad
    lanes), with the share of lane-bounces that live in each segment, the
    lockstep build where the checkout has it and the digests of its tables
    and S_start; and make_compacted_image_renderer's forward and step."""
    from drt_tpu_torch import fused
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import earlyexit
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    trace_builds = "build" in inspect.signature(mk.fused_trace).parameters
    seg_builds = "build" in inspect.signature(
        mk.fused_segment_adjoint).parameters
    for shape, kw in EARLYEXIT_SHAPES:
        cfg = RenderConfig(**kw)
        C = cfg.spp_chunks
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        ee = earlyexit.make_earlyexit_tracer(scene, cam, cfg, n_chunks=C)
        ms, win, L = cuda_ms(torch, lambda: ee(alb, emi, seeds))
        emit("kernel", label, name=f"B14 early-exit tracer (exact), {shape}",
             ms=ms, windows=win)
        emit("digest", label, name=f"B14 radiance, {shape}",
             sha256=digest(L))
        for build in ("queue", "lockstep") if trace_builds else ("queue",):
            bkw = dict(build=build) if trace_builds else {}
            ms, win, _ = cuda_ms(torch, lambda: mk.fused_trace(
                scene, table, cc, cfg, alb, emi, seeds=seeds, n_chunks=C,
                **bkw))
            emit("kernel", label, name=f"B1 exact, {build} build, {shape}",
                 ms=ms, windows=win)
        del L
        torch.cuda.empty_cache()

    cfg = RenderConfig(**MAIN)
    D, b, chunk = cfg.max_depth, 2, 1
    lay = segment_layouts(torch, scene, cam, cfg, alb, emi, seeds, b, chunk)
    loops = ({f"[{b0}, {b1})": mk.segment_form(b0, table.shape[0],
                                                 alb.shape[0], emi.shape[0])
              for b0, b1 in ((0, b), (b, D))}
             if hasattr(mk, "segment_form") else None)
    emit("segments", label, chunk=chunk, split=b, loops=loops,
         **lay["counts"])
    n, g_pix, layouts = lay["n"], lay["g_pix"], lay["layouts"]
    segment_tracer_times(torch, label, scene, cam, cfg, alb, emi, seeds, b,
                         chunk, layouts)
    for layout, (K, rayB, aliveB, ridx, gB, scatter) in layouts.items():
        for build in ("queue", "lockstep") if seg_builds else ("queue",):
            bkw = dict(build=build) if seg_builds else {}
            tag = f"{layout}, {build} build" if seg_builds else layout
            adjA = mk.make_fused_segment_adjoint(scene, cam, cfg, 0, b, **bkw)
            adjB = mk.make_fused_segment_adjoint(scene, cam, cfg, b, D,
                                                 n_rays=K, **bkw)
            msB, winB, (daB, deB, S_B) = cuda_ms(torch, lambda: adjB(
                alb, emi, seeds, rayB, aliveB, ridx, gB, chunk=chunk))
            if scatter is None:
                S_A = S_B
            else:
                S_A = torch.zeros((3, n + 1), device=dev)
                S_A[:, scatter] = S_B
                S_A = S_A[:, :n].contiguous()
            msA, winA, (daA, deA) = cuda_ms(torch, lambda: adjA(
                alb, emi, seeds, g_pix, S_A, chunk=chunk))
            emit("kernel", label, name=f"B4-seg [{b}, {D}) on {K} lanes, "
                 f"one chunk, {tag}", ms=msB, windows=winB)
            emit("kernel", label, name=f"B4-seg [0, {b}), one chunk, {tag}",
                 ms=msA, windows=winA)
            emit("kernel", label, name=f"B4-seg both launches, one chunk, "
                 f"{tag}", ms=msA + msB)
            emit("digest", label, name=f"B4-seg [{b}, {D}) tables and "
                 f"S_start, {tag}", sha256=[digest(t) for t in
                                            (daB, deB, S_B)])
            emit("digest", label, name=f"B4-seg [0, {b}) tables, {tag}",
                 sha256=[digest(t) for t in (daA, deA)])
            del daB, deB, S_B, S_A, daA, deA
    del lay, layouts, g_pix
    torch.cuda.empty_cache()

    render = fused.make_compacted_image_renderer(scene, cam, cfg)
    s_img = torch.tensor([1, 2], dtype=torch.int32)
    with torch.no_grad():
        target = render(params, s_img)
        med, times = host_s(torch, lambda: render(params, s_img))
    emit("path", label, name="compacted forward, main shape", s=med,
         times=times)
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)

    def step():
        p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
        ((render(p, s_img) - target) ** 2).mean().backward()

    med, times = host_s(torch, step)
    emit("path", label, name="compacted fwd+bwd step, main shape", s=med,
         times=times)


def compare(torch, label: str) -> None:
    from drt_tpu_torch import optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import make_fused_image_renderer
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    builds = "build" in inspect.signature(mk.fused_trace).parameters
    g = torch.Generator(device=dev).manual_seed(11)

    def both(shape_name, cfg, fast=True, digests=True, extra=True):
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        kw = dict(seeds=seeds, fastmath=fast, n_chunks=cfg.spp_chunks)
        tag = f"{shape_name}, {'fast' if fast else 'exact'}"
        ms, win, L = cuda_ms(torch, lambda: mk.fused_trace(
            scene, table, cc, cfg, alb, emi, **kw))
        emit("kernel", label, name=f"B1 tracer, {tag}", ms=ms, windows=win)
        if digests:
            emit("digest", label, name=f"B1 radiance, {tag}",
                 sha256=digest(L))
        del L
        ms, win, (L, rsc, rbest) = cuda_ms(torch, lambda: mk.fused_collect(
            scene, table, cc, cfg, alb, emi, **kw))
        emit("kernel", label, name=f"B2 collect, {tag}", ms=ms, windows=win)
        if digests:
            for what, t in (("radiance", L), ("rsc", rsc), ("rbest", rbest)):
                emit("digest", label, name=f"B2 {what}, {tag}",
                     sha256=digest(t))
        n_bytes = rsc.numel() * 8
        del L, rsc, rbest
        if not (builds and extra):
            return
        ms, win, _ = cuda_ms(torch, lambda: mk.fused_collect(
            scene, table, cc, cfg, alb, emi, build="lockstep", **kw))
        emit("kernel", label, name=f"B2 collect lockstep build, {tag}",
             ms=ms, windows=win)
        ms, win, _ = cuda_ms(torch, lambda: mk.fused_trace(
            scene, table, cc, cfg, alb, emi, build="lockstep", **kw))
        emit("kernel", label, name=f"B1 tracer lockstep build, {tag}",
             ms=ms, windows=win)
        rows = torch.empty(n_bytes // 4, dtype=torch.int32, device=dev)
        ms, win, _ = cuda_ms(torch, lambda: rows.zero_())
        emit("kernel", label, name=f"zeroing B2's rows alone, {tag}", ms=ms,
             windows=win, bytes=n_bytes)
        del rows

    cfg = RenderConfig(**MAIN)
    C = cfg.spp_chunks
    both("main shape", cfg)
    both("main shape", cfg, fast=False, extra=False)
    both("CLI default shape", RenderConfig(**CLI))
    torch.cuda.empty_cache()

    # Tape mode: one chunk of the main shape and its hash tapes.
    cfg1 = RenderConfig(**{**MAIN, "spp": MAIN["spp"] // C,
                           "spp_chunks": 1})
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    cam_u, tape = hash_tapes(seeds, cfg.width * cfg.height, cfg1.spp,
                             cfg.max_depth, device=dev)
    kw = dict(cam_u=cam_u, tape=tape, fastmath=True)
    emit("digest", label, name="B1 radiance, tape mode, fast",
         sha256=digest(mk.fused_trace(scene, table, cc, cfg1, alb, emi,
                                      **kw)))
    for what, t in zip(("radiance", "rsc", "rbest"), mk.fused_collect(
            scene, table, cc, cfg1, alb, emi, **kw)):
        emit("digest", label, name=f"B2 {what}, tape mode, fast",
             sha256=digest(t))

    # The other kernels of the family, at the main shape.
    npix = cfg.width * cfg.height
    g_pix = torch.rand((3, npix), generator=g, device=dev) / cfg.spp
    kw = dict(fastmath=True, n_chunks=C)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg, **kw)(
        alb, emi, seeds)
    sweep = mk.make_fused_sweep_adjoint(scene, cfg, n_chunks=C)
    ms, win, tables = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rbest,
                                                   g_pix))
    emit("kernel", label, name="B3 sweep, main shape", ms=ms, windows=win,
         **sweep_rates(torch, ms, rbest > 0))
    emit("digest", label, name="B3 tables, main shape, fast",
         sha256=[digest(t) for t in tables])
    del rsc, rbest
    adj = mk.make_fused_adjoint(scene, cam, cfg, **kw)
    ms, win, _ = cuda_ms(torch, lambda: adj(alb, emi, seeds, g_pix))
    emit("kernel", label, name="B4 retrace adjoint, main shape", ms=ms,
         windows=win)
    adj_builds = "build" in inspect.signature(mk.fused_adjoint).parameters
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    for fast in (True, False):
        tables = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g_pix,
                                  seeds=seeds, fastmath=fast, n_chunks=C)
        emit("digest", label, name="B4 tables, main shape, "
             + ("fast" if fast else "exact"),
             sha256=[digest(t) for t in tables])
    cfg_cli = RenderConfig(**CLI)
    g_cli = g_pix * (cfg.spp / cfg_cli.spp)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg_cli,
                                                 fastmath=True)(alb, emi,
                                                                seeds)
    sweep = mk.make_fused_sweep_adjoint(scene, cfg_cli)
    ms, win, tables = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rbest,
                                                   g_cli))
    emit("kernel", label, name="B3 sweep, CLI default shape", ms=ms,
         windows=win, **sweep_rates(torch, ms, rbest > 0))
    emit("digest", label, name="B3 tables, CLI default shape, fast",
         sha256=[digest(t) for t in tables])
    del rsc, rbest
    torch.cuda.empty_cache()
    ms, win, _ = cuda_ms(torch, lambda: mk.fused_adjoint(
        scene, table, cc, cfg_cli, alb, emi, g_cli, seeds=seeds,
        fastmath=True))
    emit("kernel", label, name="B4 retrace adjoint, CLI default shape",
         ms=ms, windows=win)
    if adj_builds:
        for shape, c, g_c, n_c in (("main shape", cfg, g_pix, C),
                                   ("CLI default shape", cfg_cli, g_cli, 1)):
            ms, win, _ = cuda_ms(torch, lambda: mk.fused_adjoint(
                scene, table, cc, c, alb, emi, g_c, seeds=seeds,
                fastmath=True, n_chunks=n_c, build="lockstep"))
            emit("kernel", label,
                 name=f"B4 retrace adjoint lockstep build, {shape}", ms=ms,
                 windows=win)
    regen = rg.make_regen_tracer(scene, cam, cfg, **kw)
    ms, win, _ = cuda_ms(torch, lambda: regen(alb, emi, seeds))
    emit("kernel", label, name="B10 regen tracer, main shape", ms=ms,
         windows=win)
    regen_c = rg.make_regen_tracer(scene, cam, cfg, collect=True, **kw)
    ms, win, (_, rsc, rmeta, trips) = cuda_ms(
        torch, lambda: regen_c(alb, emi, seeds))
    emit("kernel", label, name="B10 regen collect form, main shape", ms=ms,
         windows=win)
    rsweep = rg.make_regen_sweep_adjoint(scene, cfg, n_chunks=C)
    ms, win, _ = cuda_ms(torch, lambda: rsweep(alb, emi, rsc, rmeta, trips,
                                               g_pix))
    emit("kernel", label, name="B11 regen sweep, main shape", ms=ms,
         windows=win)
    del rsc, rmeta, trips
    # One chunk: the wavefront kernels on B1's own rays, the segments.
    n = npix * cfg1.spp
    pix = torch.arange(n, device=dev) % npix
    o, d = mk.camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
    g_ray = torch.rand((3, n), generator=g, device=dev)
    trace = mk.make_pallas_tracer(scene, cfg)
    ms, win, _ = cuda_ms(torch, lambda: trace(alb, emi, o, d, tape))
    emit("kernel", label, name="B5a wavefront tracer, one chunk", ms=ms,
         windows=win)
    wadj = mk.make_pallas_adjoint(scene, cfg)
    ms, win, tables = cuda_ms(torch, lambda: wadj(alb, emi, o, d, tape,
                                                  g_ray))
    emit("kernel", label, name="B5b wavefront adjoint, one chunk", ms=ms,
         windows=win)
    emit("digest", label, name="B5b tables, one chunk",
         sha256=[digest(t) for t in tables])
    emit("digest", label, name="B4 tables, tape mode, fast",
         sha256=[digest(t) for t in mk.fused_adjoint(
             scene, table, cc, cfg1, alb, emi, g_ray, cam_u=cam_u,
             tape=tape, fastmath=True)])
    if adj_builds:
        ms, win, _ = cuda_ms(torch, lambda: mk.ray_adjoint(
            scene, table, cfg1, alb, emi, o, d, tape, g_ray,
            build="lockstep"))
        emit("kernel", label,
             name="B5b wavefront adjoint lockstep build, one chunk", ms=ms,
             windows=win)
    del o, d, tape, cam_u
    torch.cuda.empty_cache()
    segments_and_earlyexit(torch, label)

    # The paths.
    render = make_renderer(scene, cfg, cam, differentiable=False)
    s_img = torch.tensor([1, 2], dtype=torch.int32)
    target = render(params, s_img)
    med, times = host_s(torch, lambda: render(params, s_img))
    emit("path", label, name="make_renderer forward, main shape", s=med,
         times=times)
    cli = make_renderer(scene, RenderConfig(**CLI), cam,
                        differentiable=False)
    med, times = host_s(torch, lambda: cli(params, s_img))
    emit("path", label, name="make_renderer forward, CLI default shape",
         s=med, times=times)
    del cli
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)

    def step(render_fn):
        p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
        ((render_fn(p, s_img) - target) ** 2).mean().backward()

    cfg_u = RenderConfig(**MAIN, unbiased=True, adjoint_samples=2)
    for form, fn in (("stored", make_renderer(scene, cfg, cam)),
                     ("retrace", make_fused_image_renderer(
                         scene, cam, cfg, adjoint="retrace")),
                     ("unbiased, 2 adjoint samples",
                      make_renderer(scene, cfg_u, cam))):
        med, times = host_s(torch, lambda: step(fn))
        emit("path", label, name=f"fwd+bwd step, {form}", s=med,
             times=times)
    cli = make_renderer(scene, RenderConfig(**CLI), cam)
    target_cli = cli(params, s_img).detach()

    def step_cli():
        p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
        ((cli(p, s_img) - target_cli) ** 2).mean().backward()

    med, times = host_s(torch, step_cli)
    emit("path", label, name="fwd+bwd step, stored, CLI default shape",
         s=med, times=times)
    del cli, target_cli
    torch.cuda.empty_cache()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)

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


def split_tape(torch, label: str) -> None:
    """The "tape" lines of --split-tape (the module docstring)."""
    from drt_tpu_torch import fused
    from drt_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=640, height=480, spp=16, spp_chunks=4,
                       max_depth=5, bsdf_samples=2)
    n = fused.split_chunk_cfg(cfg).spp * cfg.width * cfg.height
    seeds = [7, 8]
    ranges = [None]
    if "lanes" in inspect.signature(fused.split_prefix_tape).parameters:
        ranges += [(0, n // 2), (n // 2, n), (n // 3, 2 * n // 3)]
    for lanes in ranges:
        kw = {} if lanes is None else dict(lanes=lanes)
        ms, means, (cam_u, tape) = cuda_ms(
            torch, lambda: fused.split_prefix_tape(seeds, 1, cfg, "cuda",
                                                   **kw))
        h = hashlib.sha256()
        for t in (cam_u, tape):
            h.update(t.contiguous().cpu().numpy().tobytes())
        emit("tape", label, lanes=lanes or [0, n], ms=ms, window_ms=means,
             digest=h.hexdigest())
        del cam_u, tape


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--queue", action="store_true")
    ap.add_argument("--segments", action="store_true",
                    help="only B14, B4-seg and the compacted renderer")
    ap.add_argument("--regen-sweep", action="store_true",
                    help="only B11 and the cuda-regen paths")
    ap.add_argument("--split-tape", action="store_true",
                    help="only split_prefix_tape, whole and a shard's lanes")
    ap.add_argument("--parts", action="store_true",
                    help="only the parts of the wavefront's chunk and B10's "
                         "launch")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    label = args.label or str(root)
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        print("bench_torch_fused: no CUDA device visible", file=sys.stderr)
        return 2
    import drt_tpu_torch
    assert Path(drt_tpu_torch.__file__).resolve().parent.parent == root
    from drt_tpu_torch.utils import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit("card", label, smi=smi, torch=torch.__version__)
    if args.split_tape:
        split_tape(torch, label)
        return 0
    built = native.build_all()
    for source in sorted(built):
        lines = [ln.strip() for ln in
                 native.log_path(source).read_text().splitlines()
                 if any(w in ln for w in ("Compiling entry", "registers",
                                          "spill"))]
        emit("ptxas", label, source=source, lines=lines)
    if args.breakdown:
        breakdown(torch, label, root, args.queue)
    elif args.segments:
        segments_and_earlyexit(torch, label)
    elif args.regen_sweep:
        regen_sweep_and_paths(torch, label)
    elif args.parts:
        parts(torch, label, root)
    else:
        compare(torch, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
