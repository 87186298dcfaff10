"""Drive drt_tpu_torch's render and training paths on one NVIDIA GPU.

  python3 chip_smoke.py [--keep-going]
                        [--only=dyn|regen|wavefront|compact|fused|sweep|split|
                                invert|mesh|deep]

Phases (any failure raises, exits non-zero and prints no result line):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel library of drt_tpu_torch/csrc, one nvcc each, all
     at once; print each entry point's registers and spills;
  3. hold the tracer kernel against its plain PyTorch twin on the card:
     tape mode, exact variant, on the cbox, glossy and tri scenes (64x48x4
     spp, depth 5); the fast variant against the exact one; the internal
     RNG (32x24x8 spp, spp_chunks=2) against the twin fed the same hash
     tapes; and the main path's own call (fast, internal RNG, all 16
     chunks), and the exact variant at that shape, against the twin;
  4. hold the collect tracer, the sweep adjoint and the retrace adjoint
     against their twins at the same small shapes and at the main-path
     shape: the collect tracer's radiance equals the tracer's bit for bit;
     the retrace adjoint equals sweep(collect) bit for bit; two sweeps
     give the same bits; the unbiased salted seed equals the twin fed
     hash_tapes of that seed; time each kernel and twin;
  5. the forward main path: the Cornell box at 640x480, 256 spp, depth 5,
     spp_chunks=16 through make_renderer(differentiable=False), one
     warm-up and three seeds; the images are finite, read right, and
     their means agree with the twin's at the same seeds;
  6. the differentiable main path: make_renderer(scene, cfg, cam) ->
     mean squared loss -> backward, in its stored, retrace and unbiased
     forms, gradients against backend="torch" at the same seeds, seconds
     per forward+backward step;
  7. the trainer: optim.inverse_render, 5 Adam steps at the main shape
     from a perturbed red-wall albedo towards a target render;
  8. the memory-resident ("dyn") kernels against their plain versions:
     tape mode on cbox, glossy, tri and the 87-shape mesh (64x48x4 spp,
     depth 5), exact and fast; the collect tracer's radiance equals the
     tracer's, the retrace adjoint equals sweep(collect), two sweeps agree,
     all bit for bit; the tracer against its per-thread reference build
     (the leaves tested per thread), bit for bit, here and at the main
     shape; culling on against off and two-level against
     one-level on the 327- and 1287-shape meshes, bit for bit; the dyn
     tracer on cbox against the fused tracer on cbox; the internal RNG and
     the unbiased salted seed against hash tapes;
  9. the dyn kernels at their main shape, the 1287-shape mesh at 640x480,
     64 spp, depth 5, spp_chunks=4: time each kernel on the main path's
     launch (all chunks); hold it against its plain version on one chunk
     (tape mode fed that chunk's hash tapes: the plain version takes
     seconds per chunk), timing both there; count the triangle loops the
     cull skipped;
 10. the mesh main path through make_renderer, "auto" resolving to
     "cuda-dyn": three seeds forward; a forward+backward step in the
     stored, retrace and unbiased forms, gradients against
     backend="torch-dyn" on one chunk; 5 optim.inverse_render steps;
 11. the path-regeneration kernels of both families against their plain
     versions at small shapes (cbox, glossy, tri, and for the dyn family
     the 87-shape mesh; 64x48x4 spp in 2 chunks, depth 5, exact and fast),
     and the equalities their design gives, all bit for bit: collect
     radiance and trips = tracer's; one launch over the chunks = per-chunk
     launches with sample_base; per-sample radiance = the lockstep
     tracer's; the rows laid out by sample = the lockstep collect tracer's
     residuals; two sweeps; a sweep over rows filled with NaN beyond each
     pixel's trips; the retrace backward = the stored one launched per
     chunk; and the dyn family on cbox against the scene-table family;
     the scene-table tracer also at 61x47 (a partial last batch);
 12. the regeneration kernels at the two main shapes (Cornell box
     640x480x256 in 16 chunks, 1287-shape mesh 640x480x64 in 4), timed on
     the main path's launch, held against their plain versions on one
     chunk, with the trip counters of the checking builds (the
     memory-resident tracer runs exactly the warp-trips its warps need;
     the scene-table tracer counts every trip, and its warp-trips run at
     most 32 bounces each), the scene-table tracer's persistent grid
     (blocks an SM holds, the occupancy API) and the SHA-256 digests of
     its radiance, trips and rows; each family's sweep (B11, B13: the
     window kernel of csrc/regen_window.cuh) against its checking build
     (the per-pixel kernel), bit for bit, the two timed in turns, and
     against its plain version, at the main shape and at 640x480x100,
     depth 32, one chunk (the CLI's default shape, the 32-bounce
     instance), with the kernel each launch runs, and on its one-chunk
     launch against its checking build;
 13. make_renderer(backend="cuda-regen" | "cuda-dyn-regen"): three seeds
     forward, the image against the lockstep image at the same seeds, a
     forward+backward step stored and retrace against "torch-regen" /
     "torch-dyn-regen" (the mesh on one chunk), 5 optim.inverse_render
     steps on each;
 14. the key-driven wavefront kernels (wavefront tracer B5a and adjoint
     B5b) against their plain twins on cbox, glossy and tri (64x48x4 spp,
     depth 5), on the fused tracer's own rays and tape against B1 and B4
     (bit for bit where the rays are the same bits), boundary tapes and
     rays that miss everything; the tracer's keyed form (its draws in
     the kernel) = its tape form on the same draws and against its twin,
     its queue = its lockstep build; both kernels timed on one chunk of
     the main shape beside the per-chunk ray generation and keyed draws
     (the tracer's tape form, keyed form and lockstep build in turns, bit
     for bit, their SHA-256 digests printed); then
     make_renderer(backend="cuda-wavefront") at the main shape: three
     seeds forward against the fused tracer's exact image at the same
     seeds, forward+backward steps biased and unbiased against the "cuda"
     retrace form and against "torch-wavefront" on one chunk, 5
     optim.inverse_render steps, and gradcheck.check_gradients at 64x48x4;
 15. segment chaining and ray compaction: the segment tracer and segment
     adjoint (the segment forms of the tracer and the retrace adjoint)
     against their twins in tape mode, exact variant, on cbox, glossy and
     tri (64x48x4 spp, depth 5) split at (2,) and (1, 3) with the live
     lanes compacted between segments, each segment on the kernel chain's
     state; the split radiance scattered back against the tracer and the
     stitched adjoints against the retrace adjoint; bit for bit the
     segment [0, 5) and the tracer, each segment tracer and segment
     adjoint (a queue of its lanes past the camera, the lockstep loop
     from it) and its lockstep checking build, and the early-exit tracer
     (the exact tracer's queue) and the exact tracer in both of its builds
     (tape mode at the small shapes; the internal RNG at the main shape
     and at 640x480x32, depths 8, 16 and 32, where B14 and B1 are timed in
     turns and B14's SHA-256 digest printed); one chunk of the compacted
     chain at the main shape timed (segment before the split, the
     compaction, segment after it, both segment tracers and both
     adjoints in both builds and the loop each runs, their outputs'
     SHA-256 digests printed) and held against the
     twins, the lockstep builds, the tracer and the retrace adjoint on
     that chunk; then make_compacted_image_renderer at the
     main shape: three seeds forward against the fused tracer's exact
     image, a forward+backward step against the "cuda" retrace form
     (exact), the bytes it keeps, and 5 Adam steps of optim's paired loss
     over it;
 16. the queue of the tracer, the collect tracer, the retrace adjoint and
     the wavefront adjoint (one live bounce a trip) against their
     lockstep checking builds, bit for bit: radiance, rsc and rbest, and
     the gradient tables with a per-ray and a per-pixel cotangent, on
     cbox, glossy and tri (30x20x4 spp, so that a warp's last round of the
     queue is partial), exact and fast, tape mode and the internal RNG in
     1, 3, 4 and 16 chunks, depths 1, 5 and 32 (the wavefront adjoint:
     tape, exact, on the retrace adjoint's own rays, which it equals), on
     a scene of 61 table rows, and at the main shape and the CLI's default
     640x480x100 at depth 32, where both loops are timed and the tables'
     SHA-256 digests printed; the wavefront adjoint on one chunk of the
     main shape (= the retrace adjoint in tape mode), both loops timed;
     the retrace adjoint = sweep(collect) on the queue's rows; the dyn
     tracer on cbox against the queue's B1; the lane-trip counter of the
     checking build against trip_counts_plain; and the breakdown:
     clock64() cycles per section of a step of both loops of the tracer
     and of the retrace adjoint, and of B10's trips;
 17. the stored-residual sweeps B3 and B8 (a slot's rows read up to its
     first dead row) against the retrace adjoints B4 and B9, bit for bit,
     per-ray and per-pixel cotangents: on cbox, glossy and tri (30x20x4
     spp a chunk), exact and fast, tape mode and 1, 3 and 16 chunks,
     depths 1, 5, 8, 9 and 32; on cbox and the 87-, 327- and 1287-shape
     meshes in 1 and 3 chunks, depths 5, 9 and 32; on rows of NaN after
     each slot's first dead row; at n_rays 1, 127 and 129, at the tables'
     row limits (63 + 63 for B3; 144, rows through registers, and 128 for
     B8) and at 641x479 pixels of both main shapes; B3 timed at the CLI's
     default shape, its tables' SHA-256 digest printed;
 18. per-vertex splitting (bsdf_samples=2): at 64x48x2 spp, depth 5 (16
     lanes a camera sample), the tape forms of the tracer, collect
     tracer, sweep and retrace adjoint of both families (cbox and glossy;
     the 87-shape mesh for the dyn family) and of the wavefront kernels
     against their plain versions on one fused.split_prefix_tape, the
     retrace adjoint = sweep(collect) bit for bit; then the three split
     paths at full width: make_renderer's "cuda-split" on the Cornell box
     at 640x480x16 spp in 4 chunks, depth 5 (19,660,800 lanes a chunk):
     forward against "torch-split" per pixel, stored and retrace steps
     (bit-equal gradients, against "torch-split" on one chunk), 5
     optim.inverse_render steps, each kernel and the chunk's tape timed on
     one chunk; "cuda-split-dyn" on the 1287-shape mesh at 640x480x4 spp:
     forward and stored step, against "torch-split-dyn" at 1 spp, stored =
     retrace; "cuda-wavefront" at 640x480x16 spp in 16 chunks: forward
     (its image = "cuda-split"'s at the same seeds, per pixel) and a step,
     and gradcheck.check_gradients at 64x48x4, depth 3;
 19. the inverse-rendering entry point, cli.main(["invert", ...]) in
     process at the CLI's full default shape (640x480x100 spp, depth 32,
     one chunk; B1 for the target, then B2 + B3 twice a step), 60 steps a
     run: launched B1 once and B2, B3 120 times each, and nothing else;
     checkpoints at 50 and 60 and the metrics lines --log-every selects;
     50 steps, then the same command with --steps 60 resuming from the
     checkpoint, equals the uninterrupted run, and --steps-per-call 1
     equals 8, bit for bit (outputs and checkpoint 60); validate_scene and
     assert_finite on the card; one block of 8 steps under
     torch.cuda.set_sync_debug_mode("error"); profiling.trace of one step
     names B2's and B3's kernels; trainer seconds a step at 1 and 8 steps
     a block, and of one save_dir;
 20. rendering over a device mesh whose shards share the card: through
     make_renderer(mesh=make_mesh(devices=[card] * 2)), "auto" takes
     "cuda-sharded" on the Cornell box at the main shape, and
     "cuda-dyn-sharded" the 1287-shape mesh at its main shape over 4
     shards, "cuda-split-sharded" 640x480x16 in 4 chunks at 2 samples a
     vertex; "cuda-regen-sharded" and "cuda-dyn-regen-sharded" at those
     shapes, "cuda-wavefront" on a mesh at 640x480x64 in 16 chunks: each
     forward image bit for bit the one device's, a stored and a retrace
     step's image bit for bit and their gradients within rtol 2e-5 /
     atol 1e-7, a trainer's Adam steps on the mesh, the launches of each
     path, the sharded step's time against the one device's; two
     processes sharing the card over gloo with CUDA tensors (this script
     with --mesh-worker RANK WORLD INIT DIR, one a rank): heartbeat 2,
     the one process's image bit for bit and its gradients, the same Adam
     steps on both ranks; TileScheduler(fault_rate=0.25) over the card
     equal to the fault-free run;
 21. deep paths and wide tables, the adjoint kernels' deep forms (rows
     past the 32 a thread keeps, and accumulators past the 144 table rows
     a block's shared memory holds, in device memory): each lifted kernel
     (B3, B4, B5b, B4-seg, B8, B9, B11, B13) at depths 33, 40 and 64 with
     absorb_prob 0.1 (the live bounce-slots past 32 counted), per-ray and
     per-pixel cotangents, tape mode, the internal RNG in 2 chunks and the
     unbiased salted seed: with every albedo 0.8 (so that the rows past
     32 weigh) the sweeps against their plain versions on the kernels'
     rows and, bit for bit, retrace = sweep(collect), B5b = B4 on B4's
     rays, B4-seg's queue = its lockstep build and [0, D) = B4; the
     retrace forms against their plain versions on the scenes' own
     tables; the memory-resident kernels at 100 + 45 and 255 + 255 real
     table rows;
     then at full width: the Cornell box at 640x480x256 in 16 chunks,
     depth 64, through make_renderer "auto" (which retraces: 40 GB of
     rows would exceed the stored budget): forward, a retrace step, a
     stored step (the same gradients bit for bit), one chunk against
     backend="torch", an unbiased step (2 adjoint samples), a step of
     the compacted renderer (against the exact retrace) and of
     "cuda-regen", 5 optim.inverse_render steps; `cli invert` at the
     CLI's 640x480x100 with --max-depth 64 -p 0.1; "cuda-wavefront" at
     640x480x64 in 16 chunks, depth 64, one step; the 1287-shape mesh
     with 255 + 255 real rows at 640x480x64 in 4 chunks, depth 64,
     through "auto" ("cuda-dyn", stored) and retrace, the same gradients
     bit for bit, and "cuda-dyn-regen"; each lifted kernel timed at depth
     64 beside depth 32 on one shape, B8, B9 and B13 also at 255 + 255
     rows, with the bound of the depth-64 work and its tables' SHA-256
     digests (at depth 32 those of the parent's instance);
 22. a line {"kernels": [...]} of seventeen entries, the nvidia-smi line,
     and last {"ok": true, "device": {...}}.
Before each of the paths of 5, 6, 7, 10, 13, 14, 15, 18, 19, 20 and 21 the
launch counts are set to 0, and read just after. --only=dyn (phases 8-10),
--only=regen (phases 11-13), --only=wavefront (phase 14), --only=compact
(phase 15), --only=fused (phase 16), --only=sweep (phase 17),
--only=split (phase 18), --only=invert (phase 19), --only=mesh (phase
20) and --only=deep (phase 21) build, run those
phases and stop without a result line (exit 1): short runs while working
on them.

Imports nothing of JAX. Refuses to run without a card, or without the
repository beside it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import statistics
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
# Share of bounce-slots whose sampling weight may lie beyond EXACT_TOL at
# the small shapes: the specular weight divides by sqrt(1 - cos_h^2), which
# loses digits as cos_h -> 1, so two pow implementations differ there.
RSC_SHARE_SMALL = 5e-3
# Gradient tables against the twin, relative to the table's largest entry:
# the same terms summed in another order (and, at the main shape, the few
# ray slots whose path an ulp turns).
GRAD_RTOL_SMALL = 2e-5
GRAD_RTOL_MAIN = 1e-4
MAIN = dict(width=640, height=480, spp=256, max_depth=5, spp_chunks=16)
# The CLI's default shape (src/args.hpp:19-67 and --max-depth), which
# phase 19 runs `cli invert` at, passing no shape flag.
CLI_SHAPE = dict(width=640, height=480, spp=100, max_depth=32)
# The card's published peaks (H100 SXM data sheet): device memory rate and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations the bound counts: per primary ray (camera + 2 hash draws), per
# live bounce and shape kind of the nearest-hit loop, per live bounce of
# shading (frame, sample, weight, 3 hash draws), and per live bounce of the
# replay and reverse sweep. Counted from the kernels' source.
OPS_CAMERA = 70
OPS_SHAPE = {0: 13, 1: 27, 2: 50}  # plane, sphere, triangle
OPS_SHADE = 170
OPS_SWEEP = 20
OPS_BOX = 28  # one slab test of a cluster box
# The dyn kernels' main shape: the 1287-shape mesh (gallery.build_mesh(3)).
MESH_MAIN = dict(width=640, height=480, spp=64, max_depth=5, spp_chunks=4)
KERNELS = ("fused_tracer", "fused_collect", "fused_sweep", "fused_adjoint",
           "dyn_tracer", "dyn_collect", "dyn_sweep", "dyn_adjoint",
           "regen_tracer", "regen_sweep", "dyn_regen_tracer",
           "dyn_regen_sweep", "ray_tracer", "ray_adjoint", "segment_tracer",
           "segment_adjoint", "earlyexit_tracer")
# B14 is timed against the exact tracer at the main shape and at one
# chunk of 32 spp, depths 8, 16 and 32.
EARLYEXIT_CELLS = (
    ("main shape, depth 5", MAIN),
    *((f"640x480x32, depth {d}", dict(width=640, height=480, spp=32,
                                      max_depth=d)) for d in (8, 16, 32)))
# The names of B14's digests in tools/bench_torch_fused.py's runs.
EARLYEXIT_DIGEST = {"main shape, depth 5": "main shape",
                    **{f"640x480x32, depth {d}": f"640x480x32, depth {d}"
                       for d in (8, 16, 32)}}
# Every wrapper that counts its launches: the two forms of a regeneration
# tracer (one TPU kernel, one entry of the kernels line) count apart.
WRAPPERS = KERNELS + ("regen_collect", "dyn_regen_collect")
# A regeneration image against the lockstep image of the same seeds, per
# pixel relative to the larger of the pixel and the image mean: the same
# samples summed in another order (in the thread, sample after sample,
# against a tensor mean per chunk).
REGEN_IMAGE_RTOL = 1e-6


FAILED: list[str] = []
KEEP_GOING = "--keep-going" in sys.argv[1:]
ONLY = next((a.split("=", 1)[1] for a in sys.argv[1:]
             if a.startswith("--only=")), None)


def check(cond: bool, msg: str) -> None:
    """Raise on a failed check; with --keep-going, note it and go on, so
    that one run shows every failure (the run still ends non-zero and
    prints no result line)."""
    if cond:
        return
    if not KEEP_GOING:
        raise RuntimeError(msg)
    FAILED.append(msg)
    print(f"[FAILED] {msg}", flush=True)


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
    ref_mean = ref.mean().item()
    mean_rel = (abs(got.mean().item() / ref_mean - 1.0) if ref_mean
                else abs(got.mean().item()))
    print(f"[compare] {name}: max_abs={max_abs!r} max_rel={max_rel!r} "
          f"share_beyond(rtol={tol['rtol']}, atol={tol['atol']})="
          f"{share!r} mean_rel={mean_rel!r}", flush=True)
    check(share <= MAX_SHARE_BEYOND,
          f"{name}: {share:.3%} of rays beyond tolerance")
    if mean_rtol is not None:
        check(mean_rel <= mean_rtol,
              f"{name}: means differ by {mean_rel:.3g} relative")
    return max_abs


def compare_residuals(name: str, got, ref, tol: dict, max_share_best: float,
                      max_share_sc: float,
                      live_of=lambda best: best > 0) -> float:
    """(rsc, rbest) of the collect tracer against the twin's (for the dyn
    kernels (rsc, rrow), with `live_of` reading the live bit): of the
    bounce-slots that matter, at most max_share_best may differ in best,
    at most max_share_sc more may have sc beyond `tol`, and at most
    MAX_SHARE_BEYOND beyond FAST_TOL. Returns max |sc - ref| over the
    slots whose best agrees.

    Slots after a live bounce whose sc is 0 do not matter and are left
    out: nothing depends on them (the throughput after that bounce and
    the suffix radiance before it are both cut by the zero weight), and
    what they hold is decided by an ulp. A ray that has hit the light
    (null BxDF: sc = 0, dir_out = 0) goes on with a zero direction from a
    point on the sphere, where the sign of |p - c|^2 - r^2 says hit or
    miss."""
    (sc, best), (sc_r, best_r) = got, ref
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sc).all()), f"{name}: non-finite rsc")
    zero = ((sc_r == 0) & live_of(best_r)).to(torch.int32)
    matters = (zero.cumsum(dim=-2, dtype=torch.int32) - zero) == 0
    del zero
    same = matters & (best == best_r)
    diff = torch.where(same, (sc - sc_r).abs(), 0.0)
    n_matter = matters.sum().item()
    share_best = (matters & (best != best_r)).sum().item() / n_matter
    share_sc = (diff > tol["atol"] + tol["rtol"] * sc_r.abs()
                ).sum().item() / n_matter
    share_far = (diff > FAST_TOL["atol"] + FAST_TOL["rtol"] * sc_r.abs()
                 ).sum().item() / n_matter
    max_abs = diff.max().item()
    print(f"[compare] {name}: of {n_matter} bounce-slots that matter (of "
          f"{matters.numel()}) rbest_differs={share_best!r} "
          f"rsc_beyond(rtol={tol['rtol']}, atol={tol['atol']})={share_sc!r} "
          f"rsc_beyond(rtol={FAST_TOL['rtol']}, atol={FAST_TOL['atol']})="
          f"{share_far!r} max_abs_rsc={max_abs!r}", flush=True)
    check(share_best <= max_share_best,
          f"{name}: rbest differs on {share_best:.3%} of bounce-slots")
    check(share_sc <= max_share_sc,
          f"{name}: rsc beyond tolerance on {share_sc:.3%} of bounce-slots")
    check(share_far <= MAX_SHARE_BEYOND,
          f"{name}: rsc beyond the fast tolerance on {share_far:.3%}")
    return max_abs


def compare_grads(name: str, got, ref, rtol: float) -> float:
    """(d_albedo, d_emission) against the twin's, each table to
    rtol * max|ref|. Returns the larger max abs error."""
    torch.cuda.synchronize()
    worst = 0.0
    for label, g, r in zip(("d_albedo", "d_emission"), got, ref):
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {label}")
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        print(f"[compare] {name}: {label} max_abs={err!r} max|ref|="
              f"{scale!r} rel={err / scale if scale else 0.0!r}",
              flush=True)
        check(scale > 0, f"{name}: {label} of the twin is all zero")
        check(err <= rtol * scale,
              f"{name}: {label} differs by {err:.3g} > {rtol} * {scale:.3g}")
        worst = max(worst, err)
    return worst


def same_bits(name: str, got, ref) -> None:
    torch.cuda.synchronize()
    for k, (g, r) in enumerate(zip(got, ref)):
        check(torch.equal(g, r), f"{name}: output {k} is not bit-equal "
              f"(max abs {(g - r).abs().max().item()!r})")
    print(f"[compare] {name}: bit-equal", flush=True)


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


def only(**launched) -> dict:
    """The launch counts of a path that launched these kernels and no
    other."""
    return {name: launched.get(name, 0) for name in WRAPPERS}


def time_steps(label, step, mk, expected: dict, n_rays: int,
               n_steps: int = 5):
    """n_steps synchronized steps with the launch counts read around them,
    then n_steps pipelined ones. Returns (counts, last step's result)."""
    step()  # warm-up
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    t_sync = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        t_sync.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    check(counts == {k: v * n_steps for k, v in expected.items()},
          f"{label}: {n_steps} steps launched {counts}")
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    t_pipe = (time.perf_counter() - t0) / n_steps
    print(f"[grad] {label}: loss={out[0].item()!r} launches per {n_steps} "
          f"steps={counts} seconds per fwd+bwd step synchronized={t_sync!r} "
          f"pipelined={t_pipe!r} ({n_rays / t_pipe / 1e6!r} Mrays/s)",
          flush=True)
    check(all(bool(torch.isfinite(x).all()) and bool((x != 0).any())
              for x in out[1]), f"{label}: gradients not finite, or zero")
    return counts, out


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


def dyn_phases(dev, smi_line: str, timing: dict) -> dict:
    """Phases 8-10: the memory-resident kernels. Returns, per dyn kernel,
    its row of the kernels line (launches, max_abs_err, ms, plain_ms,
    bound_ms, bound_by)."""
    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def live_of(rrow):
        return (rrow >> 16) > 0

    def mesh(level):
        return lambda device: gallery.build_mesh(level, device=device)

    # Phase 8: small shapes.
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(11)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    g_small = torch.rand((3, n), generator=g, device=dev)
    for label, build in (("cbox", cbox.build),
                         ("glossy", gallery.build_glossy),
                         ("tri", gallery.build_tri), ("mesh87", mesh(1))):
        scene, params, cam = build(device=dev)
        ds = dk.DynScene(scene)
        alb, emi = tables(scene, params)
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        radiance = {}
        for fm in (False, True):
            kw = dict(rng="tape", fastmath=fm)
            radiance[fm] = dk.make_dyn_tracer(ds, cam, cfg, **kw)(
                alb, emi, cam_u, tape)
            same_bits(f"dyn tracer = its per-thread reference build, "
                      f"{label}, fast={fm}", (radiance[fm],),
                      (dk.dyn_trace_lanes(ds, cc, cfg, alb, emi, cam_u=cam_u,
                                          tape=tape, fastmath=fm),))
            L, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg, **kw)(
                alb, emi, cam_u, tape)
            same_bits(f"dyn collect radiance = dyn tracer's, {label}, "
                      f"fast={fm}", (L,), (radiance[fm],))
            sweep = dk.make_dyn_sweep_adjoint(ds, cfg)
            d_sweep = sweep(alb, emi, rsc, rrow, g_small)
            d_adj = dk.make_dyn_adjoint(ds, cam, cfg, **kw)(
                alb, emi, cam_u, tape, g_small)
            same_bits(f"dyn retrace adjoint = dyn sweep(collect), {label}, "
                      f"fast={fm}", d_adj, d_sweep)
            if fm:
                continue
            plain = dict(rng="tape", plain=True)
            compare(f"dyn tape exact vs plain, {label}", radiance[fm],
                    dk.make_dyn_tracer(ds, cam, cfg, **plain)(
                        alb, emi, cam_u, tape), EXACT_TOL)
            _, rsc_r, rrow_r = dk.make_dyn_collect_tracer(
                ds, cam, cfg, **plain)(alb, emi, cam_u, tape)
            compare_residuals(f"dyn collect exact vs plain, {label}",
                              (rsc, rrow), (rsc_r, rrow_r), EXACT_TOL, 0.0,
                              RSC_SHARE_SMALL, live_of)
            compare_grads(f"dyn sweep vs plain on the kernel's residuals, "
                          f"{label}", d_sweep, dk.dyn_sweep_plain(
                              cfg, alb, emi, rsc, rrow, g_small),
                          GRAD_RTOL_SMALL)
            compare_grads(f"dyn retrace adjoint exact vs plain, {label}",
                          d_adj, dk.make_dyn_adjoint(ds, cam, cfg, **plain)(
                              alb, emi, cam_u, tape, g_small),
                          GRAD_RTOL_SMALL)
            same_bits(f"dyn sweep twice, {label}",
                      sweep(alb, emi, rsc, rrow, g_small), d_sweep)
        compare(f"dyn tape fast vs exact, {label}", radiance[True],
                radiance[False], FAST_TOL, None)
        if label == "cbox":
            compare("dyn tracer vs fused tracer (exact, same tapes), cbox",
                    radiance[False], mk.make_fused_tracer(
                        scene, cam, cfg, rng="tape")(alb, emi, cam_u, tape),
                    EXACT_TOL)

    # Culling on == off and two-level == one-level, bit for bit.
    for label, build in (("mesh327", mesh(2)), ("mesh1287", mesh(3))):
        scene, params, cam = build(device=dev)
        alb, emi = tables(scene, params)
        variants = (dk.DynScene(scene),
                    dk.DynScene(scene, cluster_min_tris=10 ** 9),
                    dk.DynScene(scene, super_m=1))
        check(variants[0].n_super > 0 and variants[1].n_clusters == 0
              and variants[2].n_super == 0 and variants[2].n_clusters > 0,
              f"{label}: the three cluster layouts are not distinct")
        for fm in (False, True):
            kw = dict(rng="tape", fastmath=fm)
            outs = [(dk.make_dyn_tracer(ds, cam, cfg, **kw)(
                         alb, emi, cam_u, tape),
                     *dk.make_dyn_adjoint(ds, cam, cfg, **kw)(
                         alb, emi, cam_u, tape, g_small))
                    for ds in variants]
            check(outs[0][0].mean().item() > 0, f"{label}: black render")
            same_bits(f"culling on = off (radiance, grads), {label}, "
                      f"fast={fm}", outs[0], outs[1])
            same_bits(f"two-level = one-level (radiance, grads), {label}, "
                      f"fast={fm}", outs[0], outs[2])

    # Internal RNG and the salted seed of unbiased mode, on the 87-shape
    # mesh at 32x24x8 spp in 2 chunks.
    cfg_i = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                         max_depth=5)
    cfg_1 = RenderConfig(width=32, height=24, spp=4, max_depth=5)
    scene, params, cam = gallery.build_mesh(1, device=dev)
    ds = dk.DynScene(scene)
    alb, emi = tables(scene, params)
    cc = mk.camera_consts(cam, 32, 24)
    seeds = torch.tensor([2024, -77], dtype=torch.int32)
    got = dk.make_dyn_tracer(ds, cam, cfg_i, n_chunks=2)(alb, emi, seeds)
    compare("dyn internal rng exact vs plain on hash tapes, mesh87 32x24x8",
            got, dk.dyn_trace_plain(ds, cc, cfg_i, alb, emi, seeds=seeds,
                                    n_chunks=2), EXACT_TOL)
    c_u, c_t = hash_tapes(seeds, 32 * 24, 4, 5, device=dev, sample_base=4)
    one = dk.make_dyn_tracer(ds, cam, cfg_1, rng="tape")(alb, emi, c_u, c_t)
    first = dk.make_dyn_tracer(ds, cam, cfg_i, n_chunks=1)(alb, emi, seeds)
    same_bits("dyn internal rng = tape of hash_tapes, chunks 0+1",
              (first + one,), (got,))
    salted = fused._salted(seeds, 1)
    g_pix = torch.rand((3, 32 * 24), generator=g, device=dev)
    d_salt = dk.make_dyn_adjoint(ds, cam, cfg_1)(alb, emi, salted, g_pix)
    s_u, s_t = hash_tapes(salted, 32 * 24, 4, 5, device=dev)
    same_bits("dyn salted internal adjoint = tape adjoint of "
              "hash_tapes(salted)",
              dk.make_dyn_adjoint(ds, cam, cfg_1, rng="tape")(
                  alb, emi, s_u, s_t, g_pix), d_salt)
    compare_grads("dyn salted retrace adjoint vs plain on hash_tapes(salted)",
                  d_salt, dk.dyn_adjoint_plain(ds, cc, cfg_1, alb, emi, g_pix,
                                               cam_u=s_u, tape=s_t),
                  GRAD_RTOL_SMALL)

    # Phase 9: the main shape. Each kernel is timed on the main path's own
    # call (fast, internal RNG, all chunks in one launch) and held against
    # its plain version on one chunk, in tape mode fed that chunk's hash
    # tapes: the plain version tests triangles in [cluster_k, rays] batches
    # and takes seconds per chunk.
    cfg_m = RenderConfig(**MESH_MAIN)
    C, D = cfg_m.spp_chunks, cfg_m.max_depth
    npix = cfg_m.width * cfg_m.height
    spp_c = cfg_m.spp // C
    n_slots = npix * spp_c
    n_rays = n_slots * C
    cfg_c = RenderConfig(width=cfg_m.width, height=cfg_m.height, spp=spp_c,
                         max_depth=D)
    scene, params, cam = gallery.build_mesh(3, device=dev)
    check(resolve_backend(scene, cfg_m) == "cuda-dyn",
          f"'auto' resolved to {resolve_backend(scene, cfg_m)!r} for "
          f"{scene.num_shapes} shapes")
    ds = dk.DynScene(scene)
    print(f"[mesh] {scene.num_shapes} shapes: {ds.n_plane} planes, "
          f"{ds.n_sphere} spheres, {ds.n_tri} triangles in {ds.n_clusters} "
          f"leaves of {ds.cluster_k} under {ds.n_super} super boxes of "
          f"{ds.super_m}; operands "
          f"{sum(t.numel() * 4 for t in ds.operands)} B", flush=True)
    alb, emi = tables(scene, params)
    cc = mk.camera_consts(cam, cfg_m.width, cfg_m.height)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    chunk = 1  # the chunk held against the plain version
    c_u, c_t = hash_tapes(seeds, npix, spp_c, D, device=dev,
                          sample_base=chunk * spp_c)
    kw_m = dict(fastmath=True, n_chunks=C)
    kw_c = dict(rng="tape", fastmath=True)
    once = dict(reps=1, warmup=0, windows=1)
    # ms: the main path's launch (all chunks); chunk_ms and plain_ms: the
    # kernel and its plain version on the one chunk, the same inputs.
    ms, windows, chunk_ms, plain_ms, err = {}, {}, {}, {}, {}

    trace = dk.make_dyn_tracer(ds, cam, cfg_m, **kw_m)
    ms["dyn_tracer"], windows["dyn_tracer"], L_all = cuda_ms(
        lambda: trace(alb, emi, seeds), **timing)
    lanes_ms, lanes_windows, L_lanes = cuda_ms(
        lambda: dk.dyn_trace_lanes(ds, cc, cfg_m, alb, emi, seeds=seeds,
                                   **kw_m), **timing)
    same_bits("dyn tracer = its per-thread reference build at the main "
              "shape", (L_all,), (L_lanes,))
    del L_lanes
    print(f"[time] dyn tracer's per-thread reference build at the mesh main "
          f"shape: {lanes_ms!r} ms on {smi_line}; window means "
          f"{lanes_windows!r}", flush=True)
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    plain_ms["dyn_tracer"], _, ref = cuda_ms(
        lambda: dk.dyn_trace_plain(ds, cc, cfg_c, alb, emi, cam_u=c_u,
                                   tape=c_t, fastmath=True, stats=stats),
        **once)
    print(f"[mesh] peak device memory over the plain tracer on one chunk "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    chunk_trace = dk.make_dyn_tracer(ds, cam, cfg_c, **kw_c)
    chunk_ms["dyn_tracer"], _, L_c = cuda_ms(
        lambda: chunk_trace(alb, emi, c_u, c_t), **timing)
    err["dyn_tracer"] = compare(
        f"dyn tracer (fast) vs plain, mesh1287 640x480x{spp_c}, chunk "
        f"{chunk}", L_c, ref, FAST_TOL)
    compare("dyn tracer exact vs plain (fast forms but the camera's), same "
            "chunk", dk.make_dyn_tracer(ds, cam, cfg_c, rng="tape")(
                alb, emi, c_u, c_t), ref, FAST_TOL)
    del ref

    collect = dk.make_dyn_collect_tracer(ds, cam, cfg_m, **kw_m)
    ms["dyn_collect"], windows["dyn_collect"], (L, rsc, rrow) = cuda_ms(
        lambda: collect(alb, emi, seeds), **timing)
    same_bits("dyn collect radiance = dyn tracer's at the main shape", (L,),
              (L_all,))
    del L
    live = int(live_of(rrow).sum().item())
    chunk_collect = dk.make_dyn_collect_tracer(ds, cam, cfg_c, **kw_c)
    chunk_ms["dyn_collect"], _, (L, rsc_c, rrow_c) = cuda_ms(
        lambda: chunk_collect(alb, emi, c_u, c_t), **timing)
    same_bits(f"dyn collect in tape mode = chunk {chunk} of the chunked "
              "launch (radiance of the tracer, residuals)",
              (L, rsc_c, rrow_c), (L_c, rsc[chunk], rrow[chunk]))
    plain_ms["dyn_collect"], _, (_, rsc_r, rrow_r) = cuda_ms(
        lambda: dk.dyn_collect_plain(ds, cc, cfg_c, alb, emi, cam_u=c_u,
                                     tape=c_t, fastmath=True), **once)
    err["dyn_collect"] = compare_residuals(
        f"dyn collect (fast) vs plain, chunk {chunk}", (rsc_c, rrow_c),
        (rsc_r, rrow_r), FAST_TOL, MAX_SHARE_BEYOND, MAX_SHARE_BEYOND,
        live_of)
    del rsc_r, rrow_r, L, L_c

    g_main = torch.rand((3, npix), generator=g, device=dev) / cfg_m.spp
    sweep = dk.make_dyn_sweep_adjoint(ds, cfg_m, n_chunks=C)
    ms["dyn_sweep"], windows["dyn_sweep"], d_sweep = cuda_ms(
        lambda: sweep(alb, emi, rsc, rrow, g_main), **timing)
    same_bits("dyn sweep twice at the main shape",
              sweep(alb, emi, rsc, rrow, g_main), d_sweep)
    print(f"[digest] B8 tables, mesh main shape, fast: "
          f"{[digest(t) for t in d_sweep]}", flush=True)
    # The rows the sweep needs: each path's words up to its first dead row
    # and its rsc before it (csrc/sweep_rows.cuh).
    sweep_bytes = 4 * (2 * live
                       + int((~live_of(rrow)).any(dim=1).sum().item()))
    print(f"[rate] dyn_sweep at the mesh main shape: "
          f"{rsc.numel() * 8 / ms['dyn_sweep'] / 1e6!r} GB/s of every row, "
          f"{sweep_bytes / ms['dyn_sweep'] / 1e6!r} GB/s of the "
          f"{sweep_bytes} bytes it needs", flush=True)
    chunk_sweep = dk.make_dyn_sweep_adjoint(ds, cfg_c)
    chunk_ms["dyn_sweep"], _, d_sweep_c = cuda_ms(
        lambda: chunk_sweep(alb, emi, rsc_c, rrow_c, g_main), **timing)
    plain_ms["dyn_sweep"], _, d_ref = cuda_ms(
        lambda: dk.dyn_sweep_plain(cfg_c, alb, emi, rsc_c, rrow_c, g_main),
        **once)
    err["dyn_sweep"] = compare_grads(
        f"dyn sweep vs plain on the kernel's residuals, chunk {chunk}",
        d_sweep_c, d_ref, GRAD_RTOL_MAIN)
    del rsc, rrow, rsc_c, rrow_c

    adj = dk.make_dyn_adjoint(ds, cam, cfg_m, **kw_m)
    ms["dyn_adjoint"], windows["dyn_adjoint"], d_adj = cuda_ms(
        lambda: adj(alb, emi, seeds, g_main), **timing)
    same_bits("dyn retrace adjoint = dyn sweep(collect) at the main shape",
              d_adj, d_sweep)
    chunk_adj = dk.make_dyn_adjoint(ds, cam, cfg_c, **kw_c)
    chunk_ms["dyn_adjoint"], _, d_adj_c = cuda_ms(
        lambda: chunk_adj(alb, emi, c_u, c_t, g_main), **timing)
    same_bits(f"dyn retrace adjoint = dyn sweep(collect), chunk {chunk}",
              d_adj_c, d_sweep_c)
    plain_ms["dyn_adjoint"], _, d_ref = cuda_ms(
        lambda: dk.dyn_adjoint_plain(ds, cc, cfg_c, alb, emi, g_main,
                                     cam_u=c_u, tape=c_t, fastmath=True),
        **once)
    err["dyn_adjoint"] = compare_grads(
        f"dyn retrace adjoint (fast) vs plain, chunk {chunk}", d_adj_c,
        d_ref, GRAD_RTOL_MAIN)
    del c_u, c_t
    for name in ms:
        print(f"[time] {name} at the mesh main shape (1287 shapes, "
              f"640x480x{cfg_m.spp}, {C} chunks): kernel {ms[name]!r} ms "
              f"({n_rays / ms[name] / 1e3!r} Mrays/s); on chunk {chunk} "
              f"alone (tape mode) kernel {chunk_ms[name]!r} ms, plain version "
              f"{plain_ms[name]!r} ms on {smi_line}; window means: kernel "
              f"{windows[name]!r}", flush=True)

    # What the cull skipped, from the tracer's checking build: the warps
    # test a leaf together, for the rays of their lanes that entered it.
    cs = dk.dyn_cull_stats(ds, cc, cfg_m, alb, emi, seeds, n_chunks=C)
    same_bits("the checking build's radiance = the tracer's",
              (cs.pop("radiance"),), (L_all,))
    del L_all
    warp_slots = -(-n_slots // 32) * C * D * ds.n_clusters
    print(f"[cull] {cs}: of the {warp_slots} leaf tests that "
          f"{-(-n_slots // 32) * C * D} warp-bounces could run over "
          f"{ds.n_clusters} leaves, the warps ran {cs['warp_leaves']}: "
          f"skipped share {1 - cs['warp_leaves'] / warp_slots!r}; a ray's own "
          f"slab tests skip {1 - cs['lane_leaves'] / (cs['lane_bounces'] * ds.n_clusters)!r} "
          f"of its {ds.n_clusters} leaves per live bounce; rays per leaf a "
          f"warp tests {cs['lane_leaves'] / cs['warp_leaves']!r} of 32; "
          f"rays per warp-bounce that ran the nearest hit "
          f"{cs['lane_bounces'] / cs['warp_bounces']!r}", flush=True)
    # Every bounce-ray that the collect tracer stored as live went through
    # the nearest-hit loop; the few more that did so missed (a ray that hit
    # the light goes on with a zero direction).
    check(live <= cs["lane_bounces"] <= 1.01 * live,
          f"the checking build ran the nearest-hit loop for "
          f"{cs['lane_bounces']} bounce-rays, the collect tracer stored "
          f"{live} live ones")

    # Bounds: bytes in and out once, or this run's operations: the tests
    # the plain version counted on one chunk (planes, spheres, the boxes
    # and the triangles of the leaves a ray's own slab test enters), times
    # the number of chunks, with OPS_SHAPE per test and OPS_BOX per box.
    ops_hit = C * (stats["plane"] * OPS_SHAPE[0] + stats["sphere"]
                   * OPS_SHAPE[1] + stats["box"] * OPS_BOX
                   + stats["tri"] * OPS_SHAPE[2])
    ops_trace = n_rays * OPS_CAMERA + ops_hit + live * OPS_SHADE
    scene_bytes = sum(t.numel() * 4 for t in ds.operands)
    table_bytes = 4 * (alb.numel() + emi.numel())
    res_bytes = 8 * n_rays * D
    grad_bytes = table_bytes
    work = {
        "dyn_tracer": (scene_bytes + table_bytes + 12 * n_slots, ops_trace),
        "dyn_collect": (scene_bytes + table_bytes + 12 * n_slots + res_bytes,
                        ops_trace),
        "dyn_sweep": (table_bytes + sweep_bytes + 4 * g_main.numel()
                      + grad_bytes, live * OPS_SWEEP),
        "dyn_adjoint": (scene_bytes + table_bytes + 4 * g_main.numel()
                        + grad_bytes, ops_trace + live * OPS_SWEEP),
    }
    print(f"[bound] plain version's counts on chunk {chunk}: {stats}; live "
          f"bounce-rays of the whole run {live} of {n_rays * D}", flush=True)
    bound = {}
    for name, (n_bytes, n_ops) in work.items():
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
        bound[name] = (max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"[bound] {name}: bytes={n_bytes} ({t_bytes!r} ms at "
              f"{PEAK_BYTES_PER_S:.3g} B/s) operations={n_ops} ({t_ops!r} "
              f"ms at {PEAK_F32_OPS_PER_S:.3g} op/s)", flush=True)

    # Phase 10: the mesh main path through the user's entry points.
    render = make_renderer(scene, cfg_m, cam, differentiable=False)
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2, 3)]
    launches = {}
    mk.reset_launch_counts()
    images, t_imgs = [], []
    for s in seed_list:  # the first is the warm-up
        t0 = time.perf_counter()
        images.append(render(params, s))
        torch.cuda.synchronize()
        t_imgs.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    launches["dyn_tracer"] = counts["dyn_tracer"]
    print(f"[mesh] make_renderer(auto -> cuda-dyn, differentiable=False) "
          f"640x480x{cfg_m.spp}spp depth {D}: launches={counts} seconds="
          f"{t_imgs[1:]!r} Mrays/s={[n_rays / t / 1e6 for t in t_imgs[1:]]!r}",
          flush=True)
    check(counts == only(dyn_tracer=len(seed_list)),
          f"the mesh forward path launched {counts}")
    for s, img in zip(seed_list[1:], images[1:]):
        check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
              f"image {tuple(img.shape)} {img.dtype}")
        reads_right(img, f"mesh, seed {s.tolist()}")
    # The mesh's blue shows at the image centre, against the white back
    # wall beside it.
    centre = images[1][240:300, 290:350].mean((0, 1)).tolist()
    print(f"[image] mesh centre rgb={centre}", flush=True)
    check(centre[2] > 1.3 * centre[0], "the mesh at the centre is not blue")
    target = images[1]
    del images

    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s, tgt):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - tgt) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad)

    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    unbiased = dict(unbiased=True, adjoint_samples=2)
    cfg_u = RenderConfig(**MESH_MAIN, **unbiased)
    check(fused._resolve_adjoint(cfg_m, "auto", dev) == "stored",
          "adjoint='auto' must resolve to 'stored' at the mesh main shape")
    print(f"[mesh] residuals {fused.stored_bytes(cfg_m)} B of a budget of "
          f"{fused.stored_budget_bytes(dev)} B", flush=True)
    # Each form at full width for its time and launches; then on one chunk
    # (640x480x16, spp_chunks=1) against backend="torch-dyn".
    forms = (("stored (default)", cfg_m, {},
              only(dyn_collect=1, dyn_sweep=1)),
             ("retrace", cfg_m, dict(adjoint="retrace"),
              only(dyn_tracer=1, dyn_adjoint=1)),
             ("unbiased, 2 adjoint samples", cfg_u, {},
              only(dyn_tracer=1, dyn_adjoint=2)))
    for label, cfg_f, kw, expected in forms:
        if kw:
            render_fn = fused.make_dyn_image_renderer(scene, cam, cfg_f, **kw)
        else:
            render_fn = make_renderer(scene, cfg_f, cam)
        counts, _ = time_steps(
            f"mesh, {label}",
            lambda: step(render_fn, p_off, seed_list[1], target), mk,
            expected, n_rays)
        if label == "retrace":
            launches["dyn_adjoint"] = counts["dyn_adjoint"]
        one = RenderConfig(width=cfg_m.width, height=cfg_m.height, spp=spp_c,
                           max_depth=D, **(unbiased if cfg_f.unbiased
                                           else {}))
        pair = []
        for plain in (False, True):
            if kw:
                fn = fused.make_dyn_image_renderer(scene, cam, one,
                                                   plain=plain, **kw)
            else:
                fn = make_renderer(scene, one, cam, backend="torch-dyn"
                                   if plain else "auto")
            t0 = time.perf_counter()
            pair.append(step(fn, p_off, seed_list[2], target))
            torch.cuda.synchronize()
            print(f"[grad] mesh, {label}, one chunk, "
                  f"{'torch-dyn' if plain else 'cuda-dyn'}: loss="
                  f"{pair[-1][0].item()!r} seconds="
                  f"{time.perf_counter() - t0!r}", flush=True)
        rel = abs(pair[0][0].item() / pair[1][0].item() - 1.0)
        check(rel <= 1e-4, f"mesh, {label}: losses differ by {rel:.3g}")
        compare_grads(f"mesh, {label}: grads vs backend='torch-dyn' on one "
                      "chunk", pair[0][1], pair[1][1], GRAD_RTOL_MAIN)

    # The trainer on the mesh: the icosphere's blue albedo, perturbed.
    blue = 3
    true_row = params.albedo[blue].clone()
    start = params.albedo.clone()
    start[blue] = torch.tensor([0.6, 0.2, 0.2], device=dev)
    n_steps = 5
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    fitted, metrics = optim.inverse_render(
        scene, cfg_m, cam, target, Params(start, params.emission),
        torch.Generator().manual_seed(5), steps=n_steps)
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) / n_steps
    counts = mk.launch_counts()
    launches["dyn_collect"] = counts["dyn_collect"]
    launches["dyn_sweep"] = counts["dyn_sweep"]
    before = (start[blue] - true_row).norm().item()
    after = (fitted.albedo[blue] - true_row).norm().item()
    print(f"[train] mesh inverse_render {n_steps} steps: launches={counts} "
          f"seconds per step={t_train!r} loss={metrics['loss'].tolist()} "
          f"grad_norm={metrics['grad_norm'].tolist()} blue row "
          f"{start[blue].tolist()} -> {fitted.albedo[blue].tolist()} (true "
          f"{true_row.tolist()}): distance {before!r} -> {after!r}",
          flush=True)
    check(counts == only(dyn_collect=2 * n_steps, dyn_sweep=2 * n_steps),
          f"the mesh trainer launched {counts}")
    check(bool(torch.isfinite(metrics["loss"]).all())
          and bool(torch.isfinite(metrics["grad_norm"]).all()),
          "the mesh trainer's metrics are not finite")
    check(after < before, "the perturbed mesh albedo moved away from its "
          "true value")
    return {name: dict(launches=launches.get(name, 0), max_abs_err=err[name],
                       ms=ms[name], plain_ms=plain_ms[name],
                       bound_ms=bound[name][0], bound_by=bound[name][1],
                       chunks=C, plain_ms_chunks=1,
                       ms_one_chunk=chunk_ms[name]) for name in ms}


def regen_phases(dev, smi_line: str, timing: dict) -> dict:
    """Phases 11-13: the path-regeneration kernels of both families.
    Returns the rows of the kernels line of regen_tracer, regen_sweep,
    dyn_regen_tracer and dyn_regen_sweep."""
    from types import SimpleNamespace

    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def dead_rows(alb, emi):
        return (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)

    # What differs between the two families. `ks` is what a family's
    # factories take for the scene: the Scene, or its DynScene.
    table = SimpleNamespace(
        name="regen", backend="cuda-regen", plain_backend="torch-regen",
        prep=lambda scene: scene,
        tracer=rg.make_regen_tracer, sweep=rg.make_regen_sweep_adjoint,
        renderer=fused.make_regen_image_renderer,
        lock_tracer=mk.make_fused_tracer,
        lock_collect=mk.make_fused_collect_tracer,
        lock_sweep=mk.make_fused_sweep_adjoint,
        sweep_plain=rg.regen_sweep_plain, trace_plain=rg.regen_trace_plain,
        collect_plain=rg.regen_collect_plain,
        stats=lambda ks, cc, cfg, alb, emi, seeds, C: rg.regen_trip_stats(
            ks, mk.scene_table(ks), cc, cfg, alb, emi, seeds, n_chunks=C),
        want_bit=8, keep=0xFF, dead=lambda alb, emi: 0,
        live_of=lambda best: best > 0, kernel="B11",
        sweep_form=rg.regen_sweep_form)
    dyn = SimpleNamespace(
        name="dyn_regen", backend="cuda-dyn-regen",
        plain_backend="torch-dyn-regen", prep=dk.DynScene,
        tracer=dr.make_dyn_regen_tracer,
        sweep=dr.make_dyn_regen_sweep_adjoint,
        renderer=fused.make_dyn_regen_image_renderer,
        lock_tracer=dk.make_dyn_tracer,
        lock_collect=dk.make_dyn_collect_tracer,
        lock_sweep=dk.make_dyn_sweep_adjoint,
        sweep_plain=lambda ks, cfg, *a: dr.dyn_regen_sweep_plain(cfg, *a),
        trace_plain=lambda ks, *a, **kw: dr.dyn_regen_trace_plain(
            ks, *a, fastmath=True, **kw),
        collect_plain=lambda ks, *a, **kw: dr.dyn_regen_collect_plain(
            ks, *a, fastmath=True, **kw),
        stats=lambda ks, cc, cfg, alb, emi, seeds, C:
            dr.dyn_regen_trip_stats(ks, cc, cfg, alb, emi, seeds,
                                    n_chunks=C),
        want_bit=17, keep=0x1FFFF, dead=dead_rows,
        live_of=lambda rrow: (rrow >> 16) > 0, kernel="B13",
        sweep_form=dr.dyn_regen_sweep_form)

    def by_sample(fam, cfg, alb, emi, rsc, rows, trips):
        return rg.rows_by_sample(cfg, rsc, rows, trips, fam.want_bit,
                                 fam.keep, fam.dead(alb, emi))

    def nan_beyond(rsc, rows, trips):
        """The rows with NaN (and all bits set) wherever a pixel's own
        trips end."""
        t = torch.arange(rsc.shape[1], device=rsc.device)[None, :, None]
        own = t < trips[:, None, :]
        return (torch.where(own, rsc, float("nan")).contiguous(),
                torch.where(own, rows, -1).contiguous())

    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s, tgt):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - tgt) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad), img.detach()

    def mesh(level):
        return lambda device: gallery.build_mesh(level, device=device)

    # Phase 11: small shapes, 2 chunks of 2 samples.
    cfg = RenderConfig(width=64, height=48, spp=4, spp_chunks=2, max_depth=5)
    cfg_s = RenderConfig(width=64, height=48, spp=4, spp_chunks=4,
                         max_depth=5)  # one sample per chunk
    C, spp_c, npix = 2, 2, 64 * 48
    seeds = torch.tensor([2024, -77], dtype=torch.int32)
    g = torch.Generator(device=dev).manual_seed(21)
    g_pix = torch.rand((3, npix), generator=g, device=dev)
    small = (("cbox", cbox.build), ("glossy", gallery.build_glossy),
             ("tri", gallery.build_tri), ("mesh87", mesh(1)))
    cbox_radiance = {}
    for fam in (table, dyn):
        for label, build in small:
            if fam is table and label == "mesh87":
                continue  # 87 shapes: more than the scene table holds
            scene, params, cam = build(device=dev)
            ks = fam.prep(scene)
            alb, emi = tables(scene, params)
            tag = f"{fam.name}, {label}"
            radiance = {}
            for fm in (False, True):
                t2 = f"{tag}, fast={fm}"
                kw = dict(fastmath=fm)
                L, trips = fam.tracer(ks, cam, cfg, n_chunks=C, **kw)(
                    alb, emi, seeds)
                radiance[fm] = L
                Lc, rsc, rows, trips_c = fam.tracer(
                    ks, cam, cfg, collect=True, n_chunks=C, **kw)(
                    alb, emi, seeds)
                same_bits(f"collect radiance and trips = tracer's, {t2}",
                          (Lc, trips_c), (L, trips))
                check(int(trips.min()) >= spp_c
                      and int(trips.max()) <= rg.t_cap(cfg),
                      f"{t2}: trips outside [spp_c, t_cap]")
                one = fam.tracer(ks, cam, cfg, n_chunks=1, **kw)
                one_c = fam.tracer(ks, cam, cfg, collect=True, n_chunks=1,
                                   **kw)
                parts = [one_c(alb, emi, seeds, c * spp_c) for c in range(C)]
                same_bits(f"one launch over {C} chunks = {C} launches with "
                          f"sample_base (radiance, trips), {t2}",
                          (one(alb, emi, seeds, 0)[0]
                           + one(alb, emi, seeds, spp_c)[0],
                           torch.cat([p[3] for p in parts])), (L, trips))
                sc_u, code_u = by_sample(fam, cfg, alb, emi, rsc, rows,
                                         trips)
                cfg_1 = RenderConfig(width=64, height=48, spp=spp_c,
                                     max_depth=5)
                per_chunk = [rg.rows_by_sample(
                    cfg_1, p[1], p[2], p[3], fam.want_bit, fam.keep,
                    fam.dead(alb, emi)) for p in parts]
                same_bits(f"rows of one launch = rows of per-chunk launches, "
                          f"{t2}", (sc_u, code_u),
                          (torch.cat([p[0] for p in per_chunk]),
                           torch.cat([p[1] for p in per_chunk])))
                # Sample for sample the lockstep kernels' paths.
                Ls, _ = fam.tracer(ks, cam, cfg_s, n_chunks=4, **kw)(
                    alb, emi, seeds)
                same_bits(f"per-sample radiance = lockstep tracer's, {t2}",
                          (Ls,), (fam.lock_tracer(ks, cam, cfg_s, n_chunks=4,
                                                  **kw)(alb, emi, seeds),))
                _, rsc_l, rcode_l = fam.lock_collect(
                    ks, cam, cfg, n_chunks=C, **kw)(alb, emi, seeds)
                same_bits(f"rows by sample = lockstep collect's residuals, "
                          f"{t2}", (sc_u, code_u), (rsc_l, rcode_l))
                sweep = fam.sweep(ks, cfg, n_chunks=C)
                d = sweep(alb, emi, rsc, rows, trips, g_pix)
                same_bits(f"sweep twice, {t2}",
                          sweep(alb, emi, rsc, rows, trips, g_pix), d)
                same_bits(f"sweep over rows of NaN beyond each pixel's "
                          f"trips, {t2}",
                          sweep(alb, emi, *nan_beyond(rsc, rows, trips),
                                trips, g_pix), d)
                compare_grads(f"sweep vs lockstep sweep of the same "
                              f"samples, {t2}", d,
                              fam.lock_sweep(ks, cfg, n_chunks=C)(
                                  alb, emi, rsc_l, rcode_l, g_pix),
                              GRAD_RTOL_SMALL)
                # The backward through the renderer: retrace = stored when
                # both launch per chunk; one launch over the chunks sums
                # in another order.
                tgt = torch.zeros((48, 64, 3), device=dev)
                outs = [step(fam.renderer(ks, cam, cfg, fastmath=fm, **rkw),
                             params, seeds, tgt)
                        for rkw in (dict(adjoint="retrace"),
                                    dict(adjoint="stored", chunked=False),
                                    dict(adjoint="stored"))]
                same_bits(f"retrace backward = stored backward launched per "
                          f"chunk (image, grads), {t2}",
                          (outs[0][2], *outs[0][1]),
                          (outs[1][2], *outs[1][1]))
                same_bits(f"image of one launch = of per-chunk launches, "
                          f"{t2}", (outs[2][2],), (outs[0][2],))
                compare_grads(f"stored backward in one launch vs retrace, "
                              f"{t2}", outs[2][1], outs[0][1],
                              GRAD_RTOL_SMALL)
                if fm:
                    continue
                Lp, rsc_p, rows_p, trips_p = fam.tracer(
                    ks, cam, cfg, collect=True, n_chunks=C, plain=True)(
                    alb, emi, seeds)
                compare(f"radiance exact vs plain, {tag}", L, Lp, EXACT_TOL)
                differ = (trips != trips_p).float().mean().item()
                print(f"[compare] {tag}: trips differ from the plain "
                      f"version's on {differ!r} of pixel-chunks; mean trips "
                      f"per sample "
                      f"{trips.float().mean().item() / spp_c!r} of 5",
                      flush=True)
                compare_residuals(
                    f"rows by sample exact vs plain, {tag}", (sc_u, code_u),
                    by_sample(fam, cfg, alb, emi, rsc_p, rows_p, trips_p),
                    EXACT_TOL, 0.0, RSC_SHARE_SMALL, fam.live_of)
                compare_grads(
                    f"sweep vs plain on the kernel's rows, {tag}", d,
                    fam.sweep_plain(ks, cfg, alb, emi, rsc, rows, trips,
                                    g_pix), GRAD_RTOL_SMALL)
            compare(f"radiance fast vs exact, {tag}", radiance[True],
                    radiance[False], FAST_TOL, None)
            if label == "cbox":
                cbox_radiance[fam.name] = radiance[False]
    compare("dyn regen tracer vs regen tracer (exact, same seeds), cbox",
            cbox_radiance["dyn_regen"], cbox_radiance["regen"], EXACT_TOL)
    # The scene-table tracer at 61x47 = 2867 pixels (19 in the last batch
    # of 32), 3 chunks of 2 samples: = its collect form and, sample for
    # sample, the lockstep kernels.
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    cfg_p = RenderConfig(width=61, height=47, spp=6, spp_chunks=3,
                         max_depth=5)
    cfg_ps = RenderConfig(width=61, height=47, spp=3, spp_chunks=3,
                          max_depth=5)
    for fm in (False, True):
        kw = dict(fastmath=fm, n_chunks=3)
        t2 = f"regen, cbox at 61x47, fast={fm}"
        L, trips = rg.make_regen_tracer(scene, cam, cfg_p, **kw)(
            alb, emi, seeds)
        Lc, rsc, rows, trips_c = rg.make_regen_tracer(
            scene, cam, cfg_p, collect=True, **kw)(alb, emi, seeds)
        same_bits(f"collect radiance and trips = tracer's, {t2}",
                  (Lc, trips_c), (L, trips))
        _, rsc_l, rcode_l = mk.make_fused_collect_tracer(
            scene, cam, cfg_p, **kw)(alb, emi, seeds)
        same_bits(f"rows by sample = lockstep collect's residuals, {t2}",
                  by_sample(table, cfg_p, alb, emi, rsc, rows, trips),
                  (rsc_l, rcode_l))
        same_bits(f"per-sample radiance = lockstep tracer's, {t2}",
                  (rg.make_regen_tracer(scene, cam, cfg_ps, **kw)(
                      alb, emi, seeds)[0],),
                  (mk.make_fused_tracer(scene, cam, cfg_ps, **kw)(
                      alb, emi, seeds),))

    def window_sweep_checks(fam, label, ks, cam, alb, emi, cfg_m, rsc, rows,
                            trips, g_main, d_sweep):
        """A family's window kernel (B11 or B13, the window sweep of
        csrc/regen_window.cuh) against its checking build (the per-pixel
        kernel) bit for bit, the two timed in turns, and against the plain
        version, at the main shape (the rows given) and at 640x480x100,
        depth 32, one chunk (the CLI's default shape, the 32-bounce
        instance); the kernel each launch runs."""
        B = fam.kernel
        cli = RenderConfig(width=640, height=480, spp=100, max_depth=32)
        for shape, cfg_s in (("main shape", cfg_m), ("32-bounce shape", cli)):
            form = fam.sweep_form(cfg_s, alb, emi)
            print(f"[regen sweep] {label}, {shape}: the entry point runs "
                  f"the {form} kernel", flush=True)
            check(form == "window", f"{label}, {shape}: the sweep runs the "
                  f"{form} kernel")
            C_s = cfg_s.spp_chunks
            g_s = g_main
            if cfg_s is cli:
                _, rsc, rows, trips = fam.tracer(
                    ks, cam, cli, collect=True, fastmath=True)(
                    alb, emi, torch.tensor([7, 8], dtype=torch.int32))
                g_s = torch.rand(
                    (3, cli.width * cli.height), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(31)
                ) / cli.spp
            sweeps = {b: fam.sweep(ks, cfg_s, n_chunks=C_s, build=b)
                      for b in mk.BUILDS}
            times, outs = [], {}
            for b in ("lockstep", "queue", "queue", "lockstep"):
                t, _, outs[b] = cuda_ms(
                    lambda: sweeps[b](alb, emi, rsc, rows, trips, g_s),
                    **timing)
                times.append(t)
            same_bits(f"{label}: {B}'s window kernel = its checking build "
                      f"(the per-pixel kernel) at the {shape}",
                      outs["queue"], outs["lockstep"])
            if cfg_s is cfg_m:
                same_bits(f"{label}: the renderer's sweep = the window "
                          "kernel at the main shape", d_sweep, outs["queue"])
            t_p, _, d_p = cuda_ms(lambda: fam.sweep_plain(
                ks, cfg_s, alb, emi, rsc, rows, trips, g_s),
                reps=1, warmup=0, windows=1)
            compare_grads(f"{label}: {B} vs plain at the {shape}",
                          outs["queue"], d_p, GRAD_RTOL_MAIN)
            print(f"[time] {label}: {B}'s plain version at the {shape} "
                  f"{t_p!r} ms", flush=True)
            if cfg_s is cli:
                del rsc, rows, trips
            del d_p
            print(f"[time] {label}: {B} at the {shape} (checking build, "
                  f"window kernel, window kernel, checking build) "
                  f"{times!r} ms on {smi_line}", flush=True)
            del outs
            torch.cuda.empty_cache()

    # Phases 12 and 13 at a main shape.
    def main_shape(fam, label, scene, params, cam, cfg_m, plain_full,
                   true_row, start_row, lock_backend):
        C, D = cfg_m.spp_chunks, cfg_m.max_depth
        npix = cfg_m.width * cfg_m.height
        spp_c = cfg_m.spp // C
        n_rays = npix * cfg_m.spp
        ks = fam.prep(scene)
        alb, emi = tables(scene, params)
        cc = mk.camera_consts(cam, cfg_m.width, cfg_m.height)
        seeds = torch.tensor([7, 8], dtype=torch.int32)
        tr, sw = f"{fam.name}_tracer", f"{fam.name}_sweep"
        kw_m = dict(fastmath=True, n_chunks=C)
        once = dict(reps=1, warmup=0, windows=1)
        ms, windows, chunk_ms, plain_ms, err = {}, {}, {}, {}, {}

        # Phase 12: the main path's launches.
        trace = fam.tracer(ks, cam, cfg_m, **kw_m)
        ms[tr], windows[tr], (L_all, trips_all) = cuda_ms(
            lambda: trace(alb, emi, seeds), **timing)
        collect = fam.tracer(ks, cam, cfg_m, collect=True, **kw_m)
        collect_ms, collect_windows, (Lc, rsc, rows, trips) = cuda_ms(
            lambda: collect(alb, emi, seeds), **timing)
        same_bits(f"{label}: collect radiance and trips = tracer's at the "
                  "main shape", (Lc, trips), (L_all, trips_all))
        own = (torch.arange(rsc.shape[1], device=dev)[None, :, None]
               < trips[:, None, :])
        kept = (Lc, trips, torch.where(own, rsc, 0.0),
                torch.where(own, rows, 0))
        print(f"[digest] {label}: radiance, trips, rsc and rows up to each "
              f"pixel's trips at the main shape: "
              f"{[digest(t) for t in kept]}", flush=True)
        del Lc, trips_all, own, kept
        one = fam.tracer(ks, cam, cfg_m, fastmath=True, n_chunks=1)
        L_sum = one(alb, emi, seeds, 0)[0]
        for c in range(1, C):
            L_sum = L_sum + one(alb, emi, seeds, c * spp_c)[0]
        same_bits(f"{label}: one launch over {C} chunks = {C} launches with "
                  "sample_base", (L_sum,), (L_all,))
        del L_sum
        cfg_ps = RenderConfig(width=cfg_m.width, height=cfg_m.height, spp=C,
                              spp_chunks=C, max_depth=D)
        same_bits(f"{label}: per-sample radiance = lockstep tracer's "
                  f"(640x480, {C} chunks of one sample)",
                  (fam.tracer(ks, cam, cfg_ps, **kw_m)(alb, emi, seeds)[0],),
                  (fam.lock_tracer(ks, cam, cfg_ps, **kw_m)(alb, emi,
                                                            seeds),))
        # The lockstep kernels on the same seeds: the residuals, sample
        # for sample, and the per-pixel sums.
        L_lock, rsc_l, rcode_l = fam.lock_collect(ks, cam, cfg_m, **kw_m)(
            alb, emi, seeds)
        same_bits(f"{label}: rows by sample = lockstep collect's residuals "
                  "at the main shape",
                  by_sample(fam, cfg_m, alb, emi, rsc, rows, trips),
                  (rsc_l, rcode_l))
        live = int(fam.live_of(rcode_l).sum().item())
        lock_sum = L_lock.reshape(3, spp_c, npix).sum(dim=1)
        rel = ((L_all - lock_sum).abs()
               / lock_sum.clamp_min(lock_sum.mean())).max().item()
        print(f"[compare] {label}: per-pixel radiance sums vs the lockstep "
              f"tracer's summed per pixel: max rel (to the larger of pixel "
              f"and mean) {rel!r}", flush=True)
        del L_lock, lock_sum
        g_main = torch.rand((3, npix), generator=g, device=dev) / cfg_m.spp
        sweep = fam.sweep(ks, cfg_m, n_chunks=C)
        ms[sw], windows[sw], d_sweep = cuda_ms(
            lambda: sweep(alb, emi, rsc, rows, trips, g_main), **timing)
        same_bits(f"{label}: sweep twice at the main shape",
                  sweep(alb, emi, rsc, rows, trips, g_main), d_sweep)
        compare_grads(f"{label}: sweep vs lockstep sweep of the same samples "
                      "at the main shape", d_sweep,
                      fam.lock_sweep(ks, cfg_m, n_chunks=C)(
                          alb, emi, rsc_l, rcode_l, g_main), GRAD_RTOL_MAIN)
        del rsc_l, rcode_l
        rsc_n, rows_n = nan_beyond(rsc, rows, trips)
        same_bits(f"{label}: sweep over rows of NaN beyond each pixel's "
                  "trips at the main shape",
                  sweep(alb, emi, rsc_n, rows_n, trips, g_main), d_sweep)
        del rsc_n, rows_n
        window_sweep_checks(fam, label, ks, cam, alb, emi, cfg_m, rsc, rows,
                            trips, g_main, d_sweep)
        del rsc, rows

        # One chunk against the plain versions.
        chunk = 1
        sb = chunk * spp_c
        one_c = fam.tracer(ks, cam, cfg_m, collect=True, fastmath=True,
                           n_chunks=1)
        chunk_ms[tr], _, (L_k, _) = cuda_ms(
            lambda: one(alb, emi, seeds, sb), **timing)
        chunk_collect_ms, _, (_, rsc_k, rows_k, trips_k) = cuda_ms(
            lambda: one_c(alb, emi, seeds, sb), **timing)
        stats: dict = {}
        plain_kw = dict(n_chunks=1, sample_base=sb)
        if fam is dyn:
            plain_kw["stats"] = stats
        torch.cuda.reset_peak_memory_stats()
        plain_ms[tr], _, (L_p, _) = cuda_ms(
            lambda: fam.trace_plain(ks, cc, cfg_m, alb, emi, seeds,
                                    **plain_kw), **once)
        print(f"[{fam.name}] peak device memory over the plain tracer on one "
              f"chunk {torch.cuda.max_memory_allocated()} B", flush=True)
        err[tr] = compare(f"{label}: tracer (fast) vs plain, chunk {chunk}",
                          L_k, L_p, FAST_TOL)
        del L_p
        plain_collect_ms, _, (_, rsc_p, rows_p, trips_p) = cuda_ms(
            lambda: fam.collect_plain(ks, cc, cfg_m, alb, emi, seeds,
                                      n_chunks=1, sample_base=sb), **once)
        cfg_c = RenderConfig(width=cfg_m.width, height=cfg_m.height,
                             spp=spp_c, max_depth=D)
        collect_err = compare_residuals(
            f"{label}: rows by sample (fast) vs plain, chunk {chunk}",
            by_sample(fam, cfg_c, alb, emi, rsc_k, rows_k, trips_k),
            by_sample(fam, cfg_c, alb, emi, rsc_p, rows_p, trips_p),
            FAST_TOL, MAX_SHARE_BEYOND, MAX_SHARE_BEYOND, fam.live_of)
        print(f"[compare] {label}: trips differ from the plain version's on "
              f"{(trips_k != trips_p).float().mean().item()!r} of the pixels "
              f"of chunk {chunk}", flush=True)
        del rsc_p, rows_p, trips_p
        sweep_1 = fam.sweep(ks, cfg_c, n_chunks=1)
        chunk_ms[sw], _, d_k = cuda_ms(
            lambda: sweep_1(alb, emi, rsc_k, rows_k, trips_k, g_main),
            **timing)
        plain_ms[sw], _, d_p = cuda_ms(
            lambda: fam.sweep_plain(ks, cfg_c, alb, emi, rsc_k, rows_k,
                                    trips_k, g_main), **once)
        err[sw] = compare_grads(
            f"{label}: sweep vs plain on the kernel's rows, chunk {chunk}",
            d_k, d_p, GRAD_RTOL_MAIN)
        same_bits(f"{label}: one-chunk sweep = its checking build (the "
                  "per-pixel kernel)", d_k,
                  fam.sweep(ks, cfg_c, build="lockstep")(
                      alb, emi, rsc_k, rows_k, trips_k, g_main))
        del rsc_k, rows_k
        print(f"[time] {label} ({C} chunks of {spp_c} samples): {tr} "
              f"{ms[tr]!r} ms ({n_rays / ms[tr] / 1e3!r} Mrays/s), its "
              f"collect form {collect_ms!r} ms, {sw} {ms[sw]!r} ms; on chunk "
              f"{chunk} alone: tracer {chunk_ms[tr]!r} ms, plain "
              f"{plain_ms[tr]!r} ms; collect form {chunk_collect_ms!r} ms, "
              f"plain {plain_collect_ms!r} ms; sweep {chunk_ms[sw]!r} ms, "
              f"plain {plain_ms[sw]!r} ms on {smi_line}; window means: "
              f"tracer {windows[tr]!r} collect {collect_windows!r} sweep "
              f"{windows[sw]!r}", flush=True)

        # The trip counters of the tracer's checking build.
        st = fam.stats(ks, cc, cfg_m, alb, emi, seeds, C)
        same_bits(f"{label}: the checking build's radiance = the tracer's",
                  (st.pop("radiance"),), (L_all,))
        trips_sum = int(trips.sum().item())
        check(st["lane_trips"] == trips_sum == st["trips_sum"],
              f"{label}: the checking build counted {st['lane_trips']} "
              f"lane-trips, trips sum to {trips_sum}")
        check(live <= st["live_trips"] <= 1.01 * live,
              f"{label}: {st['live_trips']} live trips, the lockstep "
              f"collect tracer stored {live} live bounce-rays")
        warps = -(-npix // 32)
        cycles = st.pop("cycles", None)
        print(f"[trips] {label}: {st}: {trips_sum} lane-trips for {n_rays} "
              f"samples = {trips_sum / n_rays!r} trips per sample (a "
              f"lockstep sample takes {D} slots: {n_rays * D}); live share "
              f"of lane-trips {st['live_trips'] / trips_sum!r} (lockstep: "
              f"{live / (n_rays * D)!r} of slots); a warp runs until its "
              f"slowest pixel has done all {C} chunks: at least "
              f"{st['warp_trips']} warp-trips over {warps} warps = "
              f"{st['warp_trips'] / warps!r} each of at most "
              f"{C * rg.t_cap(cfg_m)} ({st['warp_trips_by_chunk']} if the "
              f"threads of a warp waited for each other after every chunk), "
              f"against {-(-n_rays // 32) * D} lockstep warp-bounces; lanes "
              f"at work per warp-trip at best "
              f"{trips_sum / st['warp_trips']!r} of 32 on such a grid; the "
              f"warp-trips run: {st['group_trips']}, "
              f"{trips_sum / st['group_trips']!r} lane-trips each; slowest "
              f"pixel {st['trips_max']} trips in a chunk", flush=True)
        # The memory-resident tracer's warps step through their trip loop
        # together: they run exactly the warp-trips they need. The
        # scene-table tracer's lanes take (pixel, chunk) units as they
        # free up and write a dying trip's row without a bounce: each of
        # its warp-trips runs at most 32 bounces, the live ones among them.
        if fam is dyn:
            check(st["group_trips"] == st["warp_trips"],
                  f"{label}: the warps ran {st['group_trips']} warp-trips, "
                  f"not the {st['warp_trips']} they need")
        else:
            check(st["live_trips"] <= st["lane_bounces"] <= st["lane_trips"]
                  and st["group_trips"] >= -(-st["lane_bounces"] // 32),
                  f"{label}: {st['group_trips']} warp-trips ran "
                  f"{st['lane_bounces']} bounces ({st['live_trips']} live) "
                  f"of {st['lane_trips']} trips")
            grids = {form: rg.regen_grid(cfg_m, n_chunks=C,
                                         collect=form == "collect")
                     for form in ("tracer", "collect")}
            per = {k: round(v / st["group_trips"], 1)
                   for k, v in cycles.items()}
            blocks = -(-npix // mk.BLOCK)
            resident = (grids["tracer"]["blocks_per_sm"]
                        * grids["tracer"]["sms"])
            print(f"[trips] {label}: the bounces ran in "
                  f"{st['group_trips']} warp-trips, "
                  f"{st['lane_bounces'] / st['group_trips']!r} lanes each "
                  f"(at least {-(-st['lane_bounces'] // 32)}); "
                  f"{st['lane_trips'] - st['lane_bounces']} dying trips "
                  f"wrote their rows without a bounce; clock64 cycles per "
                  f"warp-trip by section {per}; persistent grid {grids} "
                  f"(a grid of one thread per pixel: {blocks} blocks, "
                  f"{blocks / resident!r} waves)", flush=True)
        if fam is dyn:
            print(f"[trips] {label}: leaves the warps tested "
                  f"{st['warp_leaves']}, for "
                  f"{st['lane_leaves'] / st['warp_leaves']!r} rays each of "
                  f"32; rays per warp-trip that ran the nearest hit "
                  f"{st['lane_bounces'] / st['warp_bounces']!r}", flush=True)

        # Bounds: the operations of this run's live bounces (as the
        # lockstep kernels count them) and one camera ray per sample; the
        # bytes of the rows actually written, 8 per trip run.
        if fam is dyn:
            ops_hit = C * (stats["plane"] * OPS_SHAPE[0] + stats["sphere"]
                           * OPS_SHAPE[1] + stats["box"] * OPS_BOX
                           + stats["tri"] * OPS_SHAPE[2])
            scene_bytes = sum(t.numel() * 4 for t in ks.operands)
            print(f"[bound] {label}: plain version's counts on chunk "
                  f"{chunk}: {stats}", flush=True)
        else:
            ops_hit = live * sum(OPS_SHAPE[t]
                                 for t in scene.shape_type.tolist())
            scene_bytes = 4 * mk.scene_table(scene).numel()
        ops_trace = n_rays * OPS_CAMERA + ops_hit + live * OPS_SHADE
        table_bytes = 4 * (alb.numel() + emi.numel())
        io_bytes = scene_bytes + table_bytes + 12 * npix + 4 * npix * C
        row_bytes = 8 * trips_sum
        work = {
            tr: (io_bytes, ops_trace),
            tr + " (collect form)": (io_bytes + row_bytes, ops_trace),
            sw: (table_bytes + row_bytes + 4 * npix * C + 4 * g_main.numel()
                 + table_bytes, live * OPS_SWEEP),
        }
        bound = {}
        for name, (n_bytes, n_ops) in work.items():
            t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
            t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
            bound[name] = (max(t_bytes, t_ops),
                           "bytes" if t_bytes >= t_ops else "operations")
            print(f"[bound] {name}: bytes={n_bytes} ({t_bytes!r} ms at "
                  f"{PEAK_BYTES_PER_S:.3g} B/s) operations={n_ops} "
                  f"({t_ops!r} ms at {PEAK_F32_OPS_PER_S:.3g} op/s)",
                  flush=True)
        del L_all, trips

        # Phase 13: through the user's entry points.
        col = f"{fam.name}_collect"
        render = make_renderer(scene, cfg_m, cam, differentiable=False,
                               backend=fam.backend)
        lock_render = make_renderer(scene, cfg_m, cam, differentiable=False,
                                    backend=lock_backend)
        seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                     for s in (0, 1, 2, 3)]
        launches = {}
        mk.reset_launch_counts()
        images, t_imgs = [], []
        for s in seed_list:  # the first is the warm-up
            t0 = time.perf_counter()
            images.append(render(params, s))
            torch.cuda.synchronize()
            t_imgs.append(time.perf_counter() - t0)
        counts = mk.launch_counts()
        launches[tr] = counts[tr]
        print(f"[{fam.name}] make_renderer({fam.backend}, "
              f"differentiable=False) 640x480x{cfg_m.spp}spp depth {D}: "
              f"launches={counts} seconds={t_imgs[1:]!r} Mrays/s="
              f"{[n_rays / t / 1e6 for t in t_imgs[1:]]!r}", flush=True)
        check(counts == only(**{tr: len(seed_list)}),
              f"{label}: the forward path launched {counts}")
        for s, img in zip(seed_list[1:], images[1:]):
            check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
                  f"image {tuple(img.shape)} {img.dtype}")
            reads_right(img, f"{label}, seed {s.tolist()}")
            ref = lock_render(params, s)
            rel = ((img - ref).abs()
                   / ref.clamp_min(ref.mean())).max().item()
            print(f"[compare] {label}, seed {s.tolist()}: image vs the "
                  f"lockstep image ({lock_backend}): max rel (to the larger "
                  f"of pixel and image mean) {rel!r}, means "
                  f"{img.mean().item()!r} {ref.mean().item()!r}", flush=True)
            check(rel <= REGEN_IMAGE_RTOL,
                  f"{label}: image differs from the lockstep image by "
                  f"{rel:.3g}")
        target = images[1]
        del images

        p_off = Params(params.albedo * 0.8, params.emission * 1.1)
        check(fused._resolve_adjoint(cfg_m, "auto", dev) == "stored",
              f"{label}: adjoint='auto' must resolve to 'stored'")
        forms = (("stored (default)", {},
                  only(**{col: 1, sw: 1})),
                 ("retrace", dict(adjoint="retrace"),
                  only(**{tr: 1, col: C, sw: C})))
        cfg_p = cfg_m if plain_full else RenderConfig(
            width=cfg_m.width, height=cfg_m.height, spp=spp_c, max_depth=D)
        grads_of = {}
        for form, kw, expected in forms:
            if kw:
                render_fn = fam.renderer(ks, cam, cfg_m, **kw)
            else:
                render_fn = make_renderer(scene, cfg_m, cam,
                                          backend=fam.backend)
            counts, out = time_steps(
                f"{label}, {form}",
                lambda: step(render_fn, p_off, seed_list[1], target), mk,
                expected, n_rays)
            grads_of[form] = out[1]
            if form == "retrace":
                launches[tr] += counts[tr]
            # Against the plain backend: at full width, or on one chunk.
            pair = []
            for plain in (False, True):
                if kw:
                    fn = fam.renderer(ks, cam, cfg_p, plain=plain, **kw)
                else:
                    fn = make_renderer(scene, cfg_p, cam,
                                       backend=fam.plain_backend if plain
                                       else fam.backend)
                t0 = time.perf_counter()
                pair.append(step(fn, p_off, seed_list[2], target))
                torch.cuda.synchronize()
                print(f"[grad] {label}, {form}, "
                      f"{'all chunks' if plain_full else 'one chunk'}, "
                      f"{fam.plain_backend if plain else fam.backend}: loss="
                      f"{pair[-1][0].item()!r} seconds="
                      f"{time.perf_counter() - t0!r}", flush=True)
            rel = abs(pair[0][0].item() / pair[1][0].item() - 1.0)
            check(rel <= 1e-4, f"{label}, {form}: losses differ by {rel:.3g}")
            compare_grads(f"{label}, {form}: grads vs backend="
                          f"'{fam.plain_backend}'", pair[0][1], pair[1][1],
                          GRAD_RTOL_MAIN)
        compare_grads(f"{label}: stored grads (one launch) vs retrace grads "
                      "(per chunk)", grads_of["stored (default)"],
                      grads_of["retrace"], GRAD_RTOL_SMALL)

        # The trainer.
        row = true_row[0]
        truth = params.albedo[row].clone()
        start = params.albedo.clone()
        start[row] = torch.tensor(start_row, device=dev)
        n_steps = 5
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        fitted, metrics = optim.inverse_render(
            scene, cfg_m, cam, target, Params(start, params.emission),
            torch.Generator().manual_seed(5), steps=n_steps,
            backend=fam.backend)
        torch.cuda.synchronize()
        t_train = (time.perf_counter() - t0) / n_steps
        counts = mk.launch_counts()
        launches[col] = counts[col]
        launches[sw] = counts[sw]
        before = (start[row] - truth).norm().item()
        after = (fitted.albedo[row] - truth).norm().item()
        print(f"[train] {label} inverse_render(backend={fam.backend!r}) "
              f"{n_steps} steps: launches={counts} seconds per step="
              f"{t_train!r} loss={metrics['loss'].tolist()} grad_norm="
              f"{metrics['grad_norm'].tolist()} row {row} "
              f"{start[row].tolist()} -> {fitted.albedo[row].tolist()} (true "
              f"{truth.tolist()}): distance {before!r} -> {after!r}",
              flush=True)
        check(counts == only(**{col: 2 * n_steps, sw: 2 * n_steps}),
              f"{label}: the trainer launched {counts}")
        check(bool(torch.isfinite(metrics["loss"]).all())
              and bool(torch.isfinite(metrics["grad_norm"]).all()),
              f"{label}: the trainer's metrics are not finite")
        check(after < before, f"{label}: the perturbed albedo row moved "
              "away from its true value")
        common = dict(chunks=C, plain_ms_chunks=1)
        return {
            tr: dict(launches=launches[tr], max_abs_err=err[tr], ms=ms[tr],
                     plain_ms=plain_ms[tr], bound_ms=bound[tr][0],
                     bound_by=bound[tr][1], ms_one_chunk=chunk_ms[tr],
                     collect_launches=launches[col], collect_ms=collect_ms,
                     collect_max_abs_err=collect_err,
                     collect_plain_ms=plain_collect_ms,
                     collect_ms_one_chunk=chunk_collect_ms,
                     collect_bound_ms=bound[tr + " (collect form)"][0],
                     collect_bound_by=bound[tr + " (collect form)"][1],
                     **common),
            sw: dict(launches=launches[sw], max_abs_err=err[sw], ms=ms[sw],
                     plain_ms=plain_ms[sw], bound_ms=bound[sw][0],
                     bound_by=bound[sw][1], ms_one_chunk=chunk_ms[sw],
                     **common)}

    scene, params, cam = cbox.build(device=dev)
    rows = main_shape(table, "regen, Cornell box 640x480x256", scene, params,
                      cam, RenderConfig(**MAIN), True, (cbox.RED,),
                      [0.2, 0.15, 0.1], "cuda")
    torch.cuda.empty_cache()
    scene, params, cam = gallery.build_mesh(3, device=dev)
    rows.update(main_shape(dyn, "dyn regen, mesh1287 640x480x64", scene,
                           params, cam, RenderConfig(**MESH_MAIN), False,
                           (3,), [0.6, 0.2, 0.2], "cuda-dyn"))
    return rows


def wavefront_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 14: the key-driven wavefront kernels, B5a (`ray_tracer`) and
    B5b (`ray_adjoint`). Returns their rows of the kernels line."""
    from drt_tpu_torch import fused, gradcheck, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import bounce_tape
    from drt_tpu_torch.ops.vecmath import V3
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                        chunk_sample_ids, trace_rays)
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def fused_rays(cam, cfg, cam_u, exact_division):
        """The fused tracer's primary rays f32[3, N] through
        camera_ray_from_pix (its op order). A tensor divided by a Python
        number is multiplied by the number's reciprocal on the card; with
        exact_division the divisors are tensors, as in the kernel."""
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        if exact_division:
            cc = cc._replace(width=torch.tensor(cfg.width, device=dev),
                             height=torch.tensor(cfg.height, device=dev))
        pix = torch.arange(cam_u.shape[1], device=dev) % (cfg.width
                                                           * cfg.height)
        o, d = mk.camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
        return torch.stack(tuple(o)), torch.stack(tuple(d))

    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s, tgt):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - tgt) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad)

    # Small shapes.
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(31)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    g_ray = torch.rand((3, n), generator=g, device=dev)
    key_seeds = torch.tensor([41, -42], dtype=torch.int32)
    small = (("cbox", cbox.build), ("glossy", gallery.build_glossy),
             ("tri", gallery.build_tri))
    for label, build in small:
        scene, params, cam = build(device=dev)
        alb, emi = tables(scene, params)
        trace = mk.make_pallas_tracer(scene, cfg)
        adj = mk.make_pallas_adjoint(scene, cfg)
        o, d = fused_rays(cam, cfg, cam_u, False)
        L = trace(alb, emi, o, d, tape)
        compare(f"wavefront tracer vs twin, {label}", L,
                mk.make_pallas_tracer(scene, cfg, plain=True)(
                    alb, emi, o, d, tape), EXACT_TOL)
        d_adj = adj(alb, emi, o, d, tape, g_ray)
        compare_grads(f"wavefront adjoint vs twin, {label}", d_adj,
                      mk.make_pallas_adjoint(scene, cfg, plain=True)(
                          alb, emi, o, d, tape, g_ray), GRAD_RTOL_SMALL)
        same_bits(f"wavefront adjoint twice, {label}",
                  adj(alb, emi, o, d, tape, g_ray), d_adj)
        # The fused tracer's own rays and tape: B1's tape form, B4's.
        L_b1 = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
            alb, emi, cam_u, tape)
        d_b4 = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
            alb, emi, cam_u, tape, g_ray)
        o2, d2 = fused_rays(cam, cfg, cam_u, True)
        torch.cuda.synchronize()
        print(f"[compare] {label}: rays of camera_ray_from_pix (x * (1/w)) "
              f"differ from the kernel's camera (x / w) on "
              f"{int((d != d2).any(dim=0).sum())!r} of {n} directions; "
              f"B5a on them differs from B1 on "
              f"{int((L != L_b1).any(dim=0).sum())!r} rays, max abs "
              f"{(L - L_b1).abs().max().item()!r}", flush=True)
        same_bits(f"wavefront tracer on B1's rays and tape = B1 (tape), "
                  f"{label}", (trace(alb, emi, o2, d2, tape),), (L_b1,))
        same_bits(f"wavefront tracer (queue) = its lockstep build, {label}",
                  (L,), (mk.ray_trace(scene, mk.scene_table(scene), cfg, alb,
                                      emi, o, d, tape, build="lockstep"),))
        # The keyed form: the draws of (seeds[1], pix, sample) in the
        # kernel, = the tape form on their tape, and against its twin.
        i = torch.arange(n, dtype=torch.int32, device=dev)
        ids = (i % (64 * 48), i // (64 * 48))
        L_k = mk.make_pallas_tracer(scene, cfg, keyed=True)(
            alb, emi, o, d, key_seeds, *ids)
        same_bits(f"wavefront tracer keyed = tape form on bounce_tape, "
                  f"{label}", (L_k,), (trace(alb, emi, o, d, bounce_tape(
                      int(key_seeds[1]), *ids, cfg.max_depth)),))
        compare(f"wavefront tracer keyed vs twin, {label}", L_k,
                mk.make_pallas_tracer(scene, cfg, plain=True, keyed=True)(
                    alb, emi, o, d, key_seeds, *ids), EXACT_TOL)
        same_bits(f"wavefront adjoint on B4's rays, tape and g = B4 (tape), "
                  f"{label}", adj(alb, emi, o2, d2, tape, g_ray), d_b4)
    # Boundary tapes (entries exactly 0 and 1) and rays that miss all.
    scene, params, cam = gallery.build_glossy(device=dev)
    alb, emi = tables(scene, params)
    u = tape.clone()
    u[:, 1, ::7] = 1.0
    u[:, 1, 3::11] = 0.0
    u[:, 2, 5::13] = 0.0
    u[:, 0, 2::9] = 0.0
    o, d = fused_rays(cam, cfg, cam_u, False)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, o, d, u)
    grads = mk.make_pallas_adjoint(scene, cfg)(alb, emi, o, d, u, g_ray)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(L).all()) and L.mean().item() > 0
          and all(bool(torch.isfinite(t).all()) for t in grads),
          "boundary tapes: non-finite radiance or gradients")
    print(f"[compare] boundary tapes, glossy: radiance finite, mean "
          f"{L.mean().item()!r}; gradients finite", flush=True)
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    away = torch.rand((3, n), generator=g, device=dev) + 0.1
    away[2] = -away[2]
    away = (away / away.norm(dim=0)).contiguous()
    far = torch.tensor([[100.0], [100.0], [-100.0]], device=dev).repeat(1, n)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, far, away, tape)
    grads = mk.make_pallas_adjoint(scene, cfg)(alb, emi, far, away, tape,
                                               g_ray)
    torch.cuda.synchronize()
    check(not L.any() and not any(t.any() for t in grads),
          "rays that miss everything: non-zero radiance or gradients")
    print("[compare] rays that miss everything, cbox: radiance and "
          "gradients exactly 0", flush=True)

    # The kernels at the main shape, one chunk (one launch) of rays.
    cfg_m = RenderConfig(**MAIN)
    C, D = cfg_m.spp_chunks, cfg_m.max_depth
    spp_c = cfg_m.spp // C
    npix = cfg_m.width * cfg_m.height
    n_chunk = npix * spp_c
    n_rays = npix * cfg_m.spp
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    trace = mk.make_pallas_tracer(scene, cfg_m)
    adj = mk.make_pallas_adjoint(scene, cfg_m)
    xy = chunk_pixel_ids(cfg_m, dev)
    chunk = 1
    pix, smp = chunk_sample_ids(cfg_m, xy, chunk)
    once = dict(reps=1, warmup=0, windows=1)
    rays_ms, rays_win, (o, d, _) = cuda_ms(
        lambda: chunk_rays(cam, cfg_m, xy, seeds, chunk), **timing)
    draw_ms, draw_win, u = cuda_ms(
        lambda: bounce_tape(int(seeds[1]), pix, smp, D), **timing)
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
    g_main = torch.rand((3, n_chunk), generator=g, device=dev) / cfg_m.spp
    ms, windows, plain_ms, err = {}, {}, {}, {}
    # B5a's three builds in turns: the tape form, the keyed form (the main
    # path's) and the lockstep build, forward and backward.
    table = mk.scene_table(scene)
    ids = (pix.int(), smp.int())
    forms = {
        "tape": lambda: trace(alb, emi, o, d, u),
        "keyed": lambda: mk.ray_trace(scene, table, cfg_m, alb, emi, o, d,
                                      seeds=seeds, pix=ids[0],
                                      sample=ids[1]),
        "lockstep": lambda: mk.ray_trace(scene, table, cfg_m, alb, emi, o, d,
                                         u, build="lockstep")}
    b5a_ms, b5a_out = {f: [] for f in forms}, {}
    for f in list(forms) + list(reversed(forms)):
        t, win, b5a_out[f] = cuda_ms(forms[f], **timing)
        b5a_ms[f].append(t)
        print(f"[time] B5a {f} on chunk {chunk} of the main shape: {t!r} "
              f"ms, window means {win!r}", flush=True)
    L = b5a_out["tape"]
    same_bits("B5a keyed form = tape form on its bounce_tape, main shape",
              (b5a_out["keyed"],), (L,))
    same_bits("B5a queue = lockstep build, main shape",
              (b5a_out["lockstep"],), (L,))
    print(f"[digest] B5a radiance on chunk {chunk} of the main shape, "
          f"{ {f: digest(t) for f, t in b5a_out.items()} }", flush=True)
    del b5a_out
    ms["ray_tracer"] = statistics.mean(b5a_ms["tape"])
    windows["ray_tracer"] = b5a_ms["tape"]
    b5a_extra = {"keyed_ms": statistics.mean(b5a_ms["keyed"]),
                 "lockstep_ms": statistics.mean(b5a_ms["lockstep"])}
    plain_ms["ray_tracer"], _, L_p = cuda_ms(
        lambda: mk.ray_trace_plain(scene, cfg_m, alb, emi, o, d, u), **once)
    err["ray_tracer"] = compare(
        f"wavefront tracer vs twin at the main shape, chunk {chunk}", L, L_p,
        EXACT_TOL)
    del L_p
    ms["ray_adjoint"], windows["ray_adjoint"], d_k = cuda_ms(
        lambda: adj(alb, emi, o, d, u, g_main), **timing)
    plain_ms["ray_adjoint"], _, d_p = cuda_ms(
        lambda: mk.ray_adjoint_plain(scene, cfg_m, alb, emi, o, d, u,
                                     g_main), **once)
    err["ray_adjoint"] = compare_grads(
        f"wavefront adjoint vs twin at the main shape, chunk {chunk}", d_k,
        d_p, GRAD_RTOL_MAIN)
    same_bits("wavefront adjoint twice at the main shape",
              adj(alb, emi, o, d, u, g_main), d_k)
    print(f"[time] one chunk of {n_chunk} rays at the main shape: "
          f"ray_tracer {ms['ray_tracer']!r} ms (keyed "
          f"{b5a_extra['keyed_ms']!r}, lockstep build "
          f"{b5a_extra['lockstep_ms']!r}), plain "
          f"{plain_ms['ray_tracer']!r} ms; ray_adjoint "
          f"{ms['ray_adjoint']!r} ms, plain {plain_ms['ray_adjoint']!r} ms; "
          f"per-chunk work outside the kernels: chunk_rays {rays_ms!r} ms, "
          f"the keyed draw of the tape ({D}x3 rows) {draw_ms!r} ms; on "
          f"{smi_line}; window means: tracer {windows['ray_tracer']!r} "
          f"adjoint {windows['ray_adjoint']!r} rays {rays_win!r} draw "
          f"{draw_win!r}", flush=True)
    # Bounds: each input read once and each output written once (o, d
    # 24 B, the tape 12 D B, radiance or g 12 B per ray), or this chunk's
    # live bounces' operations (no camera, no draws in these kernels).
    _, res = trace_rays(Params(alb[:-1], emi[:-1]), scene, V3(*o), V3(*d),
                        cfg_m, tape=u, collect=True)
    live = int((res.gate > 0).sum().item())
    del res
    ops_hit = sum(OPS_SHAPE[t] for t in scene.shape_type.tolist())
    table_bytes = 4 * (mk.scene_table(scene).numel() + alb.numel()
                       + emi.numel())
    ray_bytes = n_chunk * (24 + 12 * D + 12)
    # The keyed form reads pix and sample (8 B a ray) where the tape form
    # reads the tape, and draws (rr, u1, u2) itself: 3 hash draws a live
    # bounce, which OPS_SHADE counts already.
    work = {"ray_tracer": (table_bytes + ray_bytes,
                           live * (ops_hit + OPS_SHADE)),
            "ray_tracer (keyed form)": (table_bytes + n_chunk * (24 + 8 + 12),
                                        live * (ops_hit + OPS_SHADE)),
            "ray_adjoint": (table_bytes + ray_bytes + 4 * (alb.numel()
                                                           + emi.numel()),
                            live * (ops_hit + OPS_SHADE + OPS_SWEEP))}
    bound = {}
    for name, (n_bytes, n_ops) in work.items():
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
        bound[name] = (max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"[bound] {name}: bytes={n_bytes} ({t_bytes!r} ms at "
              f"{PEAK_BYTES_PER_S:.3g} B/s) operations={n_ops} ({t_ops!r} "
              f"ms at {PEAK_F32_OPS_PER_S:.3g} op/s) live bounce-rays="
              f"{live} of {n_chunk * D}", flush=True)
    del o, d, u, L, g_main

    # The main path through make_renderer(backend="cuda-wavefront").
    launches = {}
    render = make_renderer(scene, cfg_m, cam, differentiable=False,
                           backend="cuda-wavefront")
    exact = fused.make_fused_image_renderer(scene, cam, cfg_m,
                                            fastmath=False,
                                            differentiable=False)
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2, 3)]
    mk.reset_launch_counts()
    images, t_imgs = [], []
    for s in seed_list:  # the first is the warm-up
        t0 = time.perf_counter()
        images.append(render(params, s))
        torch.cuda.synchronize()
        t_imgs.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    launches["ray_tracer"] = counts["ray_tracer"]
    check(counts == only(ray_tracer=C * len(seed_list)),
          f"the wavefront forward launched {counts}")
    t0 = time.perf_counter()
    for _ in range(5):
        render(params, seed_list[1])
    torch.cuda.synchronize()
    t_pipe = (time.perf_counter() - t0) / 5
    print(f"[wavefront] make_renderer(cuda-wavefront, differentiable=False) "
          f"640x480x256spp depth 5, {C} chunks: launches={counts} seconds "
          f"synchronized={t_imgs[1:]!r} pipelined={t_pipe!r} "
          f"({n_rays / t_pipe / 1e6!r} Mrays/s) on {smi_line}", flush=True)
    for s, img in zip(seed_list[1:], images[1:]):
        check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
              f"image {tuple(img.shape)} {img.dtype}")
        reads_right(img, f"wavefront, seed {s.tolist()}")
        ref = exact(params, s)
        compare(f"wavefront image vs the fused tracer's exact image, seed "
                f"{s.tolist()} (per pixel)", img.permute(2, 0, 1)
                .reshape(3, -1), ref.permute(2, 0, 1).reshape(3, -1),
                EXACT_TOL)
    target = images[1]
    del images

    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    cfg_u = RenderConfig(**MAIN, unbiased=True, adjoint_samples=2)
    forms = (("biased", cfg_m, only(ray_tracer=C, ray_adjoint=C)),
             ("unbiased, 2 adjoint samples", cfg_u,
              only(ray_tracer=C, ray_adjoint=2 * C)))
    for label, cfg_f, expected in forms:
        render_fn = make_renderer(scene, cfg_f, cam, backend="cuda-wavefront")
        counts, (_, grads) = time_steps(
            f"wavefront, {label}",
            lambda: step(render_fn, p_off, seed_list[1], target), mk,
            expected, n_rays)
        if label == "biased":
            launches["ray_adjoint"] = counts["ray_adjoint"]
        # The same samples through the fused kernels' retrace form (exact
        # variant), and through the plain backend on one chunk.
        ref = step(fused.make_fused_image_renderer(
            scene, cam, cfg_f, adjoint="retrace", fastmath=False), p_off,
            seed_list[1], target)
        compare_grads(f"wavefront, {label}: grads vs 'cuda' retrace (exact) "
                      "at the same seeds", grads, ref[1], GRAD_RTOL_MAIN)
        cfg_1 = RenderConfig(width=cfg_f.width, height=cfg_f.height,
                             spp=spp_c, max_depth=D, unbiased=cfg_f.unbiased,
                             adjoint_samples=cfg_f.adjoint_samples)
        pair = []
        for backend in ("cuda-wavefront", "torch-wavefront"):
            t0 = time.perf_counter()
            pair.append(step(make_renderer(scene, cfg_1, cam,
                                           backend=backend), p_off,
                             seed_list[2], target))
            torch.cuda.synchronize()
            print(f"[grad] wavefront, {label}, one chunk, {backend}: loss="
                  f"{pair[-1][0].item()!r} seconds="
                  f"{time.perf_counter() - t0!r}", flush=True)
        compare_grads(f"wavefront, {label}: grads vs 'torch-wavefront' on "
                      "one chunk", pair[0][1], pair[1][1], GRAD_RTOL_MAIN)

    # The trainer.
    true_red = params.albedo[cbox.RED].clone()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    n_steps = 5
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    fitted, metrics = optim.inverse_render(
        scene, cfg_m, cam, target, Params(start, params.emission),
        torch.Generator().manual_seed(5), steps=n_steps,
        backend="cuda-wavefront")
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) / n_steps
    counts = mk.launch_counts()
    before = (start[cbox.RED] - true_red).norm().item()
    after = (fitted.albedo[cbox.RED] - true_red).norm().item()
    print(f"[train] inverse_render(backend='cuda-wavefront') {n_steps} steps: "
          f"launches={counts} seconds per step={t_train!r} "
          f"loss={metrics['loss'].tolist()} red row "
          f"{start[cbox.RED].tolist()} -> {fitted.albedo[cbox.RED].tolist()}"
          f": distance {before!r} -> {after!r} on {smi_line}", flush=True)
    check(counts == only(ray_tracer=2 * C * n_steps,
                         ray_adjoint=2 * C * n_steps),
          f"the wavefront trainer launched {counts}")
    check(bool(torch.isfinite(metrics["loss"]).all()),
          "the wavefront trainer's losses are not finite")
    check(after < before, "the perturbed albedo row moved away from its "
          "true value")

    # The gradient check: the kernel VJP against the plain jvp.
    cfg_g = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    res = gradcheck.check_gradients(scene, cam, cfg_g, params, seeds,
                                    rtol=1e-4)
    counts = mk.launch_counts()
    print(f"[gradcheck] check_gradients 64x48x4 f32 on the card, rtol 1e-4: "
          f"(vjp dot, jvp tangent) {res!r}; launches={counts}; "
          f"{time.perf_counter() - t0!r} s", flush=True)
    check(counts == only(ray_tracer=1, ray_adjoint=1),
          f"check_gradients launched {counts}")
    rows = {name: dict(launches=launches[name], max_abs_err=err[name],
                       ms=ms[name], plain_ms=plain_ms[name],
                       bound_ms=bound[name][0], bound_by=bound[name][1],
                       rays=n_chunk, chunks=C)
            for name in ("ray_tracer", "ray_adjoint")}
    rows["ray_tracer"].update(
        b5a_extra, keyed_bound_ms=bound["ray_tracer (keyed form)"][0],
        keyed_bound_by=bound["ray_tracer (keyed form)"][1])
    return rows


def profile_forward(fn, smi_line: str) -> None:
    """One call of fn under torch.profiler: the device time of its kernels
    by name, their sum against the wall, and the host time between."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"[profile] one compacted forward under torch.profiler: wall "
          f"{wall!r} ms, kernels {busy!r} ms ({busy / wall!r} of the wall) "
          f"on {smi_line}; by name (ms, launches): "
          + "; ".join(f"{name[:60]} {ms!r} x{n}" for name, (ms, n) in top),
          flush=True)


def compact_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 15: the segment forms of B1 and B4 (`segment_tracer`,
    `segment_adjoint`), the early-exit tracer B14 (`earlyexit_tracer`) and
    make_compacted_image_renderer. Returns their rows of the kernels
    line."""
    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import earlyexit
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def carries(ray):
        """Lanes whose throughput is not all zero: a path that hit the
        light goes on with throughput 0 and a zero direction, and an ulp
        decides its hit or miss (ROADMAP C.4); nothing depends on it."""
        return (ray[6:9] != 0).any(dim=0)

    def compare_state(name, got, ref, share):
        """An exit state (ray f[9, K], alive i32[K]) against the twin's,
        per lane: throughput to EXACT_TOL, origin and direction to
        EXACT_TOL with the atol scaled to each lane's vector (the origin
        p + w eps carries the error of p = o + d t, relative to |p| and
        not to a coordinate near 0; the direction is a unit vector),
        liveness equal, on the lanes that carry; at most `share` of the
        lanes beyond (paths an ulp of libm turns: the sampling weight of
        a specular bounce, RSC_SHARE_SMALL)."""
        (ray, alive), (ray_r, alive_r) = got, ref
        torch.cuda.synchronize()
        on = carries(ray_r)
        n_on = int(on.sum())
        diff = (ray - ray_r).abs()
        rtol, atol = EXACT_TOL["rtol"], EXACT_TOL["atol"]
        bad = torch.zeros_like(on)
        line = []
        for label, rows in (("throughput", (6, 9)), ("origin", (0, 3)),
                            ("direction", (3, 6))):
            d, r = diff[rows[0]:rows[1]], ray_r[rows[0]:rows[1]]
            a = atol if label == "throughput" else (
                atol + rtol * r.norm(dim=0))
            beyond = (d > a + rtol * r.abs()).any(dim=0)
            bad |= beyond & (on if label != "throughput" else True)
            line.append(f"{label} max_abs={d[:, on].max().item()!r}")
        bad |= on & (alive != alive_r)
        frac = int(bad.sum()) / max(n_on, 1)
        print(f"[compare] {name}: exit state of the {n_on!r} lanes that "
              f"carry: {'; '.join(line)}; alive differs on "
              f"{int((on & (alive != alive_r)).sum())!r}; share of lanes "
              f"beyond {frac!r}", flush=True)
        check(frac <= share, f"{name}: {frac:.3%} of lanes beyond")

    def segment_grads(name, got, ref, rtol):
        """compare_grads, where a table of the twin may be all zero (a
        segment of an open scene whose paths reach no light): the
        kernel's table must then be zero too."""
        torch.cuda.synchronize()
        if all(bool(r.any()) for r in ref):
            return compare_grads(name, got, ref, rtol)
        worst = 0.0
        for label, a, r in zip(("d_albedo", "d_emission"), got, ref):
            if not r.any():
                same_bits(f"{name}: {label} (all zero)", (a,), (r,))
                continue
            scale = r.abs().max().item()
            err = (a - r).abs().max().item()
            print(f"[compare] {name}: {label} max_abs={err!r} max|ref|="
                  f"{scale!r} rel={err / scale!r}", flush=True)
            check(err <= rtol * scale, f"{name}: {label} differs by "
                  f"{err:.3g} > {rtol} * {scale:.3g}")
            worst = max(worst, err)
        return worst

    def gather_lanes(idx, *rows):
        """rows f[R, K] (or i32[K]) at lanes idx, the pad slot K zero."""
        return [torch.nn.functional.pad(r, (0, 1))[..., idx] for r in rows]

    # Small shapes: tape mode, exact variant, each segment's kernel and
    # twin on the kernel chain's compacted state.
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(41)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    g_ray = torch.rand((3, n), generator=g, device=dev)
    small = (("cbox", cbox.build), ("glossy", gallery.build_glossy),
             ("tri", gallery.build_tri))
    for label, build in small:
        scene, params, cam = build(device=dev)
        alb, emi = tables(scene, params)
        L_b1 = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
            alb, emi, cam_u, tape)
        d_b4 = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
            alb, emi, cam_u, tape, g_ray)
        same_bits(f"segment tracer [0, 5) = B1 (tape), {label}",
                  (mk.make_fused_segment_tracer(scene, cam, cfg, 0, 5,
                                                rng="tape")(
                      alb, emi, cam_u, tape),), (L_b1,))
        same_bits(f"early-exit tracer = B1 exact (tape), {label}",
                  (earlyexit.make_earlyexit_tracer(scene, cam, cfg,
                                                   rng="tape")(
                      alb, emi, cam_u, tape),), (L_b1,))
        same_bits(f"early-exit tracer = B1's lockstep build exact (tape), "
                  f"{label}", (earlyexit.make_earlyexit_tracer(
                      scene, cam, cfg, rng="tape")(alb, emi, cam_u, tape),),
                  (mk.fused_trace(scene, mk.scene_table(scene),
                                  mk.camera_consts(cam, 64, 48), cfg, alb,
                                  emi, cam_u=cam_u, tape=tape,
                                  build="lockstep"),))
        compare(f"early-exit tracer vs twin (tape), {label}",
                earlyexit.make_earlyexit_tracer(scene, cam, cfg, rng="tape")(
                    alb, emi, cam_u, tape),
                earlyexit.make_earlyexit_tracer(scene, cam, cfg, rng="tape",
                                                plain=True)(
                    alb, emi, cam_u, tape), EXACT_TOL)
        for splits in ((2,), (1, 3)):
            caps = fused.compacted_capacities(cfg, splits)
            bounds = [0, *splits, 5]
            tag = f"{label}, splits {splits}, lanes {caps}"
            full = torch.zeros((3, n + 1), device=dev)
            segs, state, cidx = [], (), None
            for k, (b0, b1) in enumerate(zip(bounds, bounds[1:])):
                u = (tape[b0:b1] if cidx is None else
                     gather_lanes(cidx.long(), tape[b0:b1])[0]).contiguous()
                args = ((cam_u,) if k == 0 else ()) + (u,) + tuple(state)
                kw = dict(n_rays=caps[k], rng="tape")
                out = mk.make_fused_segment_tracer(scene, cam, cfg, b0, b1,
                                                   **kw)(alb, emi, *args)
                ref = mk.make_fused_segment_tracer(
                    scene, cam, cfg, b0, b1, plain=True, **kw)(alb, emi,
                                                               *args)
                final = b1 == 5
                L, L_r = (out, ref) if final else (out[0], ref[0])
                compare(f"segment tracer [{b0}, {b1}) vs twin, {tag}", L,
                        L_r, EXACT_TOL, None)
                if cidx is None:
                    full[:, :n] += L
                else:
                    full.index_add_(1, cidx.long(), L)
                g_k = (g_ray if cidx is None else
                       gather_lanes(cidx.long(), g_ray)[0].contiguous())
                segs.append((b0, b1, args, g_k, cidx, kw))
                if final:
                    break
                compare_state(f"segment tracer [{b0}, {b1}) vs twin, {tag}",
                              out[1], ref[1], RSC_SHARE_SMALL)
                ray, alive = out[1]
                on = alive > 0
                check(int(on.sum()) <= caps[k + 1],
                      f"{tag}: {int(on.sum())} live lanes > {caps[k + 1]}")
                idx = fused.compact_lanes(on, caps[k + 1], caps[k])
                segs[-1] += (idx,)
                state = [t.contiguous() for t in gather_lanes(idx, ray,
                                                              alive)]
                cidx = (idx if cidx is None else torch.nn.functional.pad(
                    cidx.long(), (0, 1), value=n)[idx]).to(torch.int32)
            compare(f"split radiance scattered back vs B1 (tape), {tag}",
                    full[:, :n], L_b1, EXACT_TOL)
            S, da, de = None, 0.0, 0.0
            for j in reversed(range(len(segs))):
                b0, b1, args, g_k, _, kw = segs[j][:6]
                tail = () if S is None else (S,)
                out = mk.make_fused_segment_adjoint(scene, cam, cfg, b0, b1,
                                                    **kw)(alb, emi, *args,
                                                          g_k, *tail)
                ref = mk.make_fused_segment_adjoint(
                    scene, cam, cfg, b0, b1, plain=True, **kw)(
                    alb, emi, *args, g_k, *tail)
                same_bits(f"segment adjoint [{b0}, {b1}) = its lockstep "
                          f"build, {tag}", out, mk.make_fused_segment_adjoint(
                              scene, cam, cfg, b0, b1, build="lockstep",
                              **kw)(alb, emi, *args, g_k, *tail))
                segment_grads(f"segment adjoint [{b0}, {b1}) vs twin, {tag}",
                              out[:2], ref[:2], GRAD_RTOL_SMALL)
                da, de = da + out[0], de + out[1]
                S = None
                if b0 > 0:
                    on = carries(args[-2])
                    compare(f"segment adjoint [{b0}, {b1}) S_start vs twin "
                            f"on the lanes that carry, {tag}", out[2][:, on],
                            ref[2][:, on], EXACT_TOL, None)
                    prev = segs[j - 1]
                    S = torch.zeros((3, prev[5]["n_rays"] + 1), device=dev)
                    S[:, prev[6]] = out[2]
                    S = S[:, :prev[5]["n_rays"]].contiguous()
            compare_grads(f"stitched segment adjoints vs B4 (tape), {tag}",
                          (da, de), d_b4, GRAD_RTOL_SMALL)

    # The main shape: one chunk of the compacted renderer's chain, timed.
    cfg_m = RenderConfig(**MAIN)
    C, D = cfg_m.spp_chunks, cfg_m.max_depth
    spp_c = cfg_m.spp // C
    npix = cfg_m.width * cfg_m.height
    n_chunk = npix * spp_c
    n_rays = npix * cfg_m.spp
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    cc = mk.camera_consts(cam, cfg_m.width, cfg_m.height)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    splits = (min(cfg_m.min_bounces + 1, D - 1),)
    caps = fused.compacted_capacities(cfg_m, splits)
    print(f"[compact] main shape: splits {splits}, lanes {caps} (rays of a "
          f"chunk, then after the split)", flush=True)
    check(caps[1] < caps[0], f"capacities {caps}: nothing to compact")
    b = splits[0]
    segA = mk.make_fused_segment_tracer(scene, cam, cfg_m, 0, b)
    segB = mk.make_fused_segment_tracer(scene, cam, cfg_m, b, D,
                                        n_rays=caps[1])
    adjA = mk.make_fused_segment_adjoint(scene, cam, cfg_m, 0, b)
    adjB = mk.make_fused_segment_adjoint(scene, cam, cfg_m, b, D,
                                         n_rays=caps[1])
    chunk = 1
    once = dict(reps=1, warmup=0, windows=1)
    ms, plain_ms, err = {}, {}, {}
    msA, winA, (LA, (ray, alive)) = cuda_ms(
        lambda: segA(alb, emi, seeds, chunk=chunk), **timing)

    def compaction():
        on = alive > 0
        idx = fused.compact_lanes(on, caps[1], caps[0])
        r, a = gather_lanes(idx, ray, alive)
        return on.sum(), idx, r.contiguous(), a.contiguous(), idx.to(
            torch.int32)

    ms_c, win_c, (n_live, idx, rayB, aliveB, cidx) = cuda_ms(compaction,
                                                           **timing)
    n_live = int(n_live)
    msB, winB, LB = cuda_ms(lambda: segB(alb, emi, seeds, rayB, aliveB, cidx,
                                         chunk=chunk), **timing)
    print(f"[compact] chunk {chunk}: {n_live!r} live lanes of {caps[1]} at "
          f"the split before bounce {b} ({n_live / n_chunk!r} of the "
          f"chunk's rays)", flush=True)
    check(n_live <= caps[1], "live lanes beyond the capacity")
    # B1-seg: the loop each segment runs (the queue past the camera, the
    # lockstep loop from it), each segment against its lockstep checking
    # build bit for bit (radiance, alive, the exit ray of the lanes alive
    # at the split and +0 on the others), the two timed in turns.
    forms = [mk.segment_trace_form(b0) for b0 in (0, b)]
    print(f"[segment tracer] loops at the main shape: [0, {b}) {forms[0]}, "
          f"[{b}, {D}) {forms[1]}", flush=True)
    check(forms == ["lockstep", "queue"],
          f"segment tracer loops {forms}, expected lockstep from the camera "
          "and the queue past it")
    seg_builds = {
        build: (mk.make_fused_segment_tracer(scene, cam, cfg_m, 0, b,
                                             build=build),
                mk.make_fused_segment_tracer(scene, cam, cfg_m, b, D,
                                             n_rays=caps[1], build=build))
        for build in mk.BUILDS}
    seg_times, seg_outs = {0: [], b: []}, {}
    for build in ("lockstep", "queue", "queue", "lockstep"):
        fA, fB = seg_builds[build]
        t, _, outA = cuda_ms(lambda: fA(alb, emi, seeds, chunk=chunk),
                             **timing)
        seg_times[0].append(t)
        t, _, outB = cuda_ms(lambda: fB(alb, emi, seeds, rayB, aliveB, cidx,
                                        chunk=chunk), **timing)
        seg_times[b].append(t)
        seg_outs[build] = outA, outB
    (qA, qB), (lA, lB) = seg_outs["queue"], seg_outs["lockstep"]
    live_a = lA[1][1] > 0
    same_bits(f"segment tracer [0, {b}) = its lockstep build at the main "
              "shape (radiance, alive, the exit ray of the live lanes)",
              (qA[0], qA[1][1], qA[1][0][:, live_a]),
              (lA[0], lA[1][1], lA[1][0][:, live_a]))
    check(bool(torch.equal(qA[1][0][:, ~live_a], lA[1][0][:, ~live_a])),
          f"segment tracer [0, {b}): the exit ray of the dead lanes differs "
          "from its lockstep build's")
    same_bits(f"segment tracer [{b}, {D}) = its lockstep build at the main "
              "shape (compacted)", (qB,), (lB,))
    same_bits(f"segment tracer launches = the timed calls at the main shape",
              (LA, ray, alive, LB), (qA[0], qA[1][0], qA[1][1], qB))
    print(f"[digest] B1-seg [0, {b}) radiance, exit ray, alive and [{b}, "
          f"{D}) radiance, compacted: "
          f"{[digest(t) for t in (qA[0], qA[1][0], qA[1][1], qB)]}",
          flush=True)
    print(f"[time] segment tracer at the main shape, chunk {chunk} (lockstep "
          f"build, entry point, entry point, lockstep build): [0, {b}) "
          f"{seg_times[0]!r} ms, [{b}, {D}) on {caps[1]} lanes "
          f"{seg_times[b]!r} ms on {smi_line}", flush=True)
    del seg_outs, qA, qB, lA, lB, outA, outB, live_a
    # The compaction's index against a prefix sum and a scatter.
    on = alive > 0
    pos = torch.cumsum(on, 0) - 1
    ref_idx = torch.full((caps[1] + 1,), caps[0], dtype=torch.int64,
                         device=dev)
    ref_idx.scatter_(0, torch.where(on & (pos < caps[1]), pos, caps[1]),
                     torch.arange(caps[0], device=dev))
    same_bits("compact_lanes = a prefix sum and a scatter", (idx,),
              (ref_idx[:caps[1]],))
    idx_ms, _, _ = cuda_ms(lambda: fused.compact_lanes(on, caps[1], caps[0]),
                           **timing)
    print(f"[compact] the index alone (torch.nonzero_static): {idx_ms!r} ms",
          flush=True)
    del on, pos, ref_idx
    # Twins on the same inputs, with the live bounce-rays they count.
    tA, _, refA = cuda_ms(lambda: mk.segment_trace_plain(
        scene, cc, cfg_m, 0, b, alb, emi, seeds=seeds, chunk=chunk), **once)
    tB, _, refB = cuda_ms(lambda: mk.segment_trace_plain(
        scene, cc, cfg_m, b, D, alb, emi, seeds=seeds, ray=rayB,
        alive=aliveB, ray_idx=cidx, chunk=chunk, n_rays=caps[1]), **once)
    err["segment_tracer"] = max(
        compare(f"segment tracer [0, {b}) vs twin at the main shape, chunk "
                f"{chunk}", LA, refA[0], EXACT_TOL),
        compare(f"segment tracer [{b}, {D}) vs twin at the main shape, "
                f"chunk {chunk}", LB, refB, EXACT_TOL))
    compare_state(f"segment tracer [0, {b}) vs twin at the main shape",
                  (ray, alive), refA[1], MAX_SHARE_BEYOND)
    del refA, refB
    live = []
    for b0, b1, kw in ((0, b, {}), (b, D, dict(ray=rayB, alive=aliveB,
                                               ray_idx=cidx,
                                               n_rays=caps[1]))):
        _, res = mk.segment_trace_plain(scene, cc, cfg_m, b0, b1, alb, emi,
                                        seeds=seeds, chunk=chunk,
                                        collect=True, **kw)
        live.append(int((res.gate > 0).sum()))
        del res
    ms["segment_tracer"], plain_ms["segment_tracer"] = msA + msB, tA + tB
    # [0, D) on chunk 0 is B1 on one chunk, bit for bit.
    whole = mk.make_fused_segment_tracer(scene, cam, cfg_m, 0, D)
    same_bits("segment tracer [0, 5) = B1 exact on chunk 0 at the main "
              "shape", (whole(alb, emi, seeds, chunk=0),),
              (mk.make_fused_tracer(scene, cam, cfg_m)(alb, emi, seeds),))
    # The split radiance scattered back against B1 on this chunk.
    cu, tp = mk.hash_tapes(seeds, npix, spp_c, D, sample_base=chunk * spp_c,
                           device=dev)
    L_b1 = mk.make_fused_tracer(scene, cam, cfg_m, rng="tape")(alb, emi, cu,
                                                               tp)
    full = torch.zeros((3, n_chunk + 1), device=dev)
    full[:, :n_chunk] += LA
    full.index_add_(1, cidx.long(), LB)
    compare("split and compacted radiance scattered back vs B1 on chunk "
            f"{chunk} at the main shape (per ray)", full[:, :n_chunk], L_b1,
            EXACT_TOL)
    del full, cu, tp
    # The adjoints on this chunk, stitched, against B4 on it.
    g_pix = torch.rand((3, npix), generator=g, device=dev) / cfg_m.spp
    g_lane = g_pix[:, cidx.long() % npix].contiguous()
    msB_adj, winB_adj, (daB, deB, S_B) = cuda_ms(
        lambda: adjB(alb, emi, seeds, rayB, aliveB, cidx, g_lane,
                     chunk=chunk), **timing)
    S_A = torch.zeros((3, caps[0] + 1), device=dev)
    S_A[:, idx] = S_B
    S_A = S_A[:, :caps[0]].contiguous()
    msA_adj, winA_adj, (daA, deA) = cuda_ms(
        lambda: adjA(alb, emi, seeds, g_pix, S_A, chunk=chunk), **timing)
    # The loop each launch runs: the queue past the camera, the lockstep
    # loop from it. Then each against the lockstep checking build, bit for
    # bit, timed.
    forms = [mk.segment_form(b0, mk.scene_table(scene).shape[0],
                             alb.shape[0], emi.shape[0]) for b0 in (0, b)]
    print(f"[segment adjoint] loops at the main shape: [0, {b}) {forms[0]}, "
          f"[{b}, {D}) {forms[1]}", flush=True)
    check(forms == ["lockstep", "queue"],
          f"segment adjoint loops {forms}, expected lockstep from the "
          "camera and the queue past it")
    adjB_l = mk.make_fused_segment_adjoint(scene, cam, cfg_m, b, D,
                                           n_rays=caps[1], build="lockstep")
    adjA_l = mk.make_fused_segment_adjoint(scene, cam, cfg_m, 0, b,
                                           build="lockstep")
    msB_l, winB_l, outB_l = cuda_ms(
        lambda: adjB_l(alb, emi, seeds, rayB, aliveB, cidx, g_lane,
                       chunk=chunk), **timing)
    msA_l, winA_l, outA_l = cuda_ms(
        lambda: adjA_l(alb, emi, seeds, g_pix, S_A, chunk=chunk), **timing)
    same_bits(f"segment adjoint [{b}, {D}) = its lockstep build at the main "
              "shape (compacted)", (daB, deB, S_B), outB_l)
    same_bits(f"segment adjoint [0, {b}) = its lockstep build at the main "
              "shape", (daA, deA), outA_l)
    for name, outs in ((f"B4-seg [{b}, {D}) tables and S_start, compacted",
                        (daB, deB, S_B)),
                       (f"B4-seg [0, {b}) tables, compacted", (daA, deA))):
        print(f"[digest] {name}: {[digest(t) for t in outs]}", flush=True)
    print(f"[time] segment adjoints at the main shape, lockstep build: "
          f"[{b}, {D}) {msB_l!r} ms, [0, {b}) {msA_l!r} ms (entry point "
          f"{msB_adj!r}, {msA_adj!r}) on {smi_line}; window means "
          f"{winB_l!r} {winA_l!r}", flush=True)
    del outB_l, outA_l
    tA_adj, _, refA = cuda_ms(lambda: mk.segment_adjoint_plain(
        scene, cc, cfg_m, 0, b, alb, emi, g_pix, S_end=S_A, seeds=seeds,
        chunk=chunk), **once)
    tB_adj, _, refB = cuda_ms(lambda: mk.segment_adjoint_plain(
        scene, cc, cfg_m, b, D, alb, emi, g_lane, seeds=seeds, ray=rayB,
        alive=aliveB, ray_idx=cidx, chunk=chunk, n_rays=caps[1]), **once)
    err["segment_adjoint"] = max(
        compare_grads(f"segment adjoint [0, {b}) vs twin at the main shape",
                      (daA, deA), refA, GRAD_RTOL_MAIN),
        compare_grads(f"segment adjoint [{b}, {D}) vs twin at the main "
                      "shape", (daB, deB), refB[:2], GRAD_RTOL_MAIN))
    cu, tp = mk.hash_tapes(seeds, npix, spp_c, D, sample_base=chunk * spp_c,
                           device=dev)
    compare_grads(f"stitched segment adjoints vs B4 on chunk {chunk} at the "
                  "main shape", (daA + daB, deA + deB),
                  mk.make_fused_adjoint(scene, cam, cfg_m, rng="tape")(
                      alb, emi, cu, tp, g_pix), GRAD_RTOL_MAIN)
    del refA, refB, cu, tp
    ms["segment_adjoint"] = msA_adj + msB_adj
    plain_ms["segment_adjoint"] = tA_adj + tB_adj
    print(f"[time] one chunk of {n_chunk} rays at the main shape, split "
          f"{splits}: segment tracer [0, {b}) {msA!r} ms, the compaction "
          f"{ms_c!r} ms, segment tracer [{b}, {D}) on {caps[1]} lanes "
          f"{msB!r} ms; segment adjoints [{b}, {D}) {msB_adj!r} ms, "
          f"[0, {b}) {msA_adj!r} ms; twins {tA!r} + {tB!r} ms and "
          f"{tA_adj!r} + {tB_adj!r} ms; on {smi_line}; window means: "
          f"{winA!r} {win_c!r} {winB!r} {winB_adj!r} {winA_adj!r}",
          flush=True)

    # Bounds of one chunk's two launches: each input read once and each
    # output written once (the state 40 B a lane, ray_idx 4, radiance 12,
    # g 12 a lane or a pixel, S 12), and this chunk's live bounces.
    ops_hit = sum(OPS_SHAPE[t] for t in scene.shape_type.tolist())
    table_bytes = 4 * (mk.scene_table(scene).numel() + alb.numel()
                       + emi.numel())
    grad_bytes = 4 * (alb.numel() + emi.numel())
    K = caps[1]
    trace_ops = n_chunk * OPS_CAMERA + sum(live) * (ops_hit + OPS_SHADE)
    work = {
        "segment_tracer": (2 * table_bytes + n_chunk * (12 + 40)
                           + K * (40 + 4 + 12), trace_ops),
        "segment_adjoint": (2 * (table_bytes + grad_bytes) + 12 * npix
                            + 12 * n_chunk + K * (40 + 4 + 12 + 12),
                            trace_ops + sum(live) * OPS_SWEEP),
    }
    bound = {}

    def bound_of(name, n_bytes, n_ops, note):
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
        bound[name] = (max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"[bound] {name}: bytes={n_bytes} ({t_bytes!r} ms at "
              f"{PEAK_BYTES_PER_S:.3g} B/s) operations={n_ops} ({t_ops!r} "
              f"ms at {PEAK_F32_OPS_PER_S:.3g} op/s) {note}", flush=True)

    for name, (n_bytes, n_ops) in work.items():
        bound_of(name, n_bytes, n_ops, f"live bounce-rays {live} of "
                 f"{n_chunk * b} and {K * (D - b)} lane-bounces")
    del ray, alive, rayB, aliveB, idx, cidx, LA, LB

    # B14 against B1 exact: the main shape, then 640x480x32 (one chunk)
    # at depths 8, 16 and 32.
    launches = {}
    ee_ms = {}
    for label, kw in EARLYEXIT_CELLS:
        cfg_e = RenderConfig(**kw)
        b1 = mk.make_fused_tracer(scene, cam, cfg_e,
                                  n_chunks=cfg_e.spp_chunks)
        ee = earlyexit.make_earlyexit_tracer(scene, cam, cfg_e,
                                             n_chunks=cfg_e.spp_chunks)
        mk.reset_launch_counts()
        L_ee = ee(alb, emi, seeds)
        torch.cuda.synchronize()
        counts = mk.launch_counts()
        check(counts == only(earlyexit_tracer=1),
              f"the early-exit tracer's call launched {counts}")
        launches.setdefault("earlyexit_tracer", counts["earlyexit_tracer"])
        same_bits(f"early-exit tracer = B1 exact, {label} (internal RNG)",
                  (L_ee,), (b1(alb, emi, seeds),))

        def b1_lockstep():
            return mk.fused_trace(scene, mk.scene_table(scene),
                                  mk.camera_consts(cam, cfg_e.width,
                                                   cfg_e.height),
                                  cfg_e, alb, emi, seeds=seeds,
                                  n_chunks=cfg_e.spp_chunks,
                                  build="lockstep")

        same_bits(f"early-exit tracer = B1's lockstep build exact, {label} "
                  "(internal RNG)", (L_ee,), (b1_lockstep(),))
        print(f"[digest] B14 radiance, {EARLYEXIT_DIGEST[label]}: "
              f"{digest(L_ee)}", flush=True)
        t_b1, w_b1, _ = cuda_ms(lambda: b1(alb, emi, seeds), **timing)
        t_ee, w_ee, _ = cuda_ms(lambda: ee(alb, emi, seeds), **timing)
        t_ee2, w_ee2, _ = cuda_ms(lambda: ee(alb, emi, seeds), **timing)
        t_b12, w_b12, _ = cuda_ms(lambda: b1(alb, emi, seeds), **timing)
        t_l, w_l, _ = cuda_ms(b1_lockstep, **timing)
        ee_ms[label] = (t_ee, t_ee2, t_b1, t_b12)
        print(f"[time] {label}: B1 exact {t_b1!r} / {t_b12!r} ms, early-exit "
              f"{t_ee!r} / {t_ee2!r} ms (B1, B14, B14, B1; ratio B1/B14 "
              f"{(t_b1 + t_b12) / (t_ee + t_ee2)!r}), B1's lockstep build "
              f"exact {t_l!r} ms on {smi_line}; window means {w_b1!r} "
              f"{w_ee!r} {w_ee2!r} {w_b12!r} {w_l!r}", flush=True)
        if kw == MAIN:
            ms["earlyexit_tracer"] = t_ee
            t_p, _, ref = cuda_ms(lambda: earlyexit.earlyexit_trace_plain(
                scene, cc, cfg_e, alb, emi, seeds=seeds,
                n_chunks=cfg_e.spp_chunks), **once)
            plain_ms["earlyexit_tracer"] = t_p
            err["earlyexit_tracer"] = compare(
                "early-exit tracer vs twin at the main shape", L_ee, ref,
                EXACT_TOL)
            del ref
            # The live bounce-rays of this run, from the collect tracer.
            _, _, rbest = mk.make_fused_collect_tracer(
                scene, cam, cfg_e, n_chunks=cfg_e.spp_chunks)(alb, emi,
                                                              seeds)
            live_e = int((rbest > 0).sum())
            del rbest
            bound_of("earlyexit_tracer", table_bytes
                     + 12 * npix * spp_c, n_rays * OPS_CAMERA
                     + live_e * (ops_hit + OPS_SHADE),
                     f"live bounce-rays {live_e} of {n_rays * D}")
        del L_ee

    # The compacted renderer at the main shape.
    render = fused.make_compacted_image_renderer(scene, cam, cfg_m)
    exact = fused.make_fused_image_renderer(scene, cam, cfg_m,
                                            fastmath=False,
                                            differentiable=False)
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2, 3)]
    mk.reset_launch_counts()
    images, t_imgs = [], []
    with torch.no_grad():
        for s in seed_list:  # the first is the warm-up
            t0 = time.perf_counter()
            images.append(render(params, s))
            torch.cuda.synchronize()
            t_imgs.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    launches["segment_tracer"] = counts["segment_tracer"]
    check(counts == only(segment_tracer=2 * C * len(seed_list)),
          f"the compacted forward launched {counts}")
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(5):
            render(params, seed_list[1])
    torch.cuda.synchronize()
    t_pipe = (time.perf_counter() - t0) / 5
    print(f"[compact] make_compacted_image_renderer forward 640x480x256spp "
          f"depth 5, {C} chunks: launches={counts} seconds synchronized="
          f"{t_imgs[1:]!r} pipelined={t_pipe!r} ({n_rays / t_pipe / 1e6!r} "
          f"Mrays/s) on {smi_line}", flush=True)
    profile_forward(lambda: render(params, seed_list[1]), smi_line)
    for s, img in zip(seed_list[1:], images[1:]):
        check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
              f"image {tuple(img.shape)} {img.dtype}")
        reads_right(img, f"compacted, seed {s.tolist()}")
        ref = exact(params, s)
        compare(f"compacted image vs the fused tracer's exact image, seed "
                f"{s.tolist()} (per pixel)", img.permute(2, 0, 1)
                .reshape(3, -1), ref.permute(2, 0, 1).reshape(3, -1),
                EXACT_TOL)
    target = images[1]
    del images

    def step(render_fn, p, s):
        p = Params(*(t.detach().clone().requires_grad_() for t in p))
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - target) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad)

    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    counts, (_, grads) = time_steps(
        "compacted", lambda: step(render, p_off, seed_list[1]), mk,
        only(segment_tracer=2 * C, segment_adjoint=2 * C), n_rays)
    launches["segment_adjoint"] = counts["segment_adjoint"]
    p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
    before = torch.cuda.memory_allocated(dev)
    img = render(p, seed_list[1])
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated(dev) - before - img.numel() * 4
    del img, p
    print(f"[compact] bytes the forward keeps for the backward: {kept!r} "
          f"({C} chunks x (idx i64, cidx i32, state 40 B) x {caps[1]} lanes "
          f"= {C * caps[1] * 52!r}); peak allocated in the steps "
          f"{torch.cuda.max_memory_allocated(dev) - base!r} B", flush=True)
    ref = step(fused.make_fused_image_renderer(
        scene, cam, cfg_m, adjoint="retrace", fastmath=False), p_off,
        seed_list[1])
    compare_grads("compacted: grads vs 'cuda' retrace (exact) at the same "
                  "seeds", grads, ref[1], GRAD_RTOL_MAIN)

    # Five Adam steps of optim's paired loss over the compacted render.
    true_red = params.albedo[cbox.RED].clone()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    step_fn = optim.make_train_step(scene, cfg_m, cam, target,
                                    optim.Adam(2e-2), render=render)
    state = optim.init_state(Params(start, params.emission))
    gen = torch.Generator().manual_seed(5)
    n_steps = 5
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n_steps):
        state, metrics = step_fn(state, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) / n_steps
    counts = mk.launch_counts()
    losses = torch.stack(losses)
    before = (start[cbox.RED] - true_red).norm().item()
    after = (state.params.albedo[cbox.RED] - true_red).norm().item()
    print(f"[train] 5 Adam steps over the compacted render: launches="
          f"{counts} seconds per step={t_train!r} loss={losses.tolist()} "
          f"red row distance {before!r} -> {after!r} on {smi_line}",
          flush=True)
    check(counts == only(segment_tracer=4 * C * n_steps,
                         segment_adjoint=4 * C * n_steps),
          f"the compacted trainer launched {counts}")
    check(bool(torch.isfinite(losses).all()), "the losses are not finite")
    check(after < before, "the perturbed albedo row moved away from its "
          "true value")
    return {name: dict(launches=launches[name], max_abs_err=err[name],
                       ms=ms[name], plain_ms=plain_ms[name],
                       bound_ms=bound[name][0], bound_by=bound[name][1])
            for name in ("segment_tracer", "segment_adjoint",
                         "earlyexit_tracer")}


def fused_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 16: the queue of the tracer B1, the collect tracer B2, the
    retrace adjoint B4 and the wavefront adjoint B5b against their
    lockstep checking builds, bit for bit; the trip counter against
    trip_counts_plain; the section breakdown of both loops of B1 and B4
    and of B10's trips. Returns extra keys of the kernels line for B1, B2
    and B4: their time at the CLI's default shape and their lockstep
    builds' times, and B5b's lockstep build's time on one chunk."""
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.scene import albedo_table, emission_table

    g = torch.Generator(device=dev).manual_seed(16)

    def runs(scene, alb, emi, cfg, fast, uniforms, n_chunks):
        """B1 and B2 in both loops on one input: the queue's outputs and
        the lockstep builds'."""
        table = mk.scene_table(scene)
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        kw = dict(fastmath=fast, n_chunks=n_chunks, **uniforms)
        out = {}
        for build in ("queue", "lockstep"):
            out[build] = (
                mk.fused_trace(scene, table, cc, cfg, alb, emi, build=build,
                               **kw),
                *mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                  build=build, **kw))
        return out

    def adjoints(scene, alb, emi, cfg, fast, uniforms, g_adj):
        """B4 in both loops on one input and cotangent."""
        table = mk.scene_table(scene)
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        return {build: mk.fused_adjoint(scene, table, cc, cfg, alb, emi,
                                        g_adj, fastmath=fast, build=build,
                                        **uniforms)
                for build in ("queue", "lockstep")}

    def hold_adjoint(label, scene, alb, emi, cfg, fast, uniforms, cots):
        """B4's queue = its lockstep build for each cotangent; returns the
        tables of the first."""
        tables = []
        for kind, g_adj in zip(("per ray", "per pixel"), cots):
            out = adjoints(scene, alb, emi, cfg, fast, uniforms, g_adj)
            same_bits(f"B4 queue = lockstep build, {label}, g {kind}",
                      out["queue"], out["lockstep"])
            tables.append(out["queue"])
        return tables[0]

    def hold_ray_adjoint(label, scene, alb, emi, cfg, cam_u, tape, g_ray,
                         d_b4):
        """B5b in both loops on B4's own rays and tape (rays built with
        true divisions, as the kernel's camera): = each other and B4."""
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        cc = cc._replace(width=torch.tensor(cfg.width, device=dev),
                         height=torch.tensor(cfg.height, device=dev))
        pix = torch.arange(cam_u.shape[1], device=dev) % (cfg.width
                                                           * cfg.height)
        o, d = mk.camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
        o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
        out = {build: mk.ray_adjoint(scene, mk.scene_table(scene), cfg, alb,
                                     emi, o, d, tape, g_ray, build=build)
               for build in ("queue", "lockstep")}
        same_bits(f"B5b queue = lockstep build, {label}", out["queue"],
                  out["lockstep"])
        same_bits(f"B5b on B4's rays and tape = B4, {label}", out["queue"],
                  d_b4)
        return o, d, out["queue"]

    def hold(label, out):
        same_bits(f"B1 queue = lockstep build, {label}", out["queue"][:1],
                  out["lockstep"][:1])
        same_bits(f"B2 queue = lockstep build (radiance, rsc, rbest), "
                  f"{label}", out["queue"][1:], out["lockstep"][1:])
        same_bits(f"B2 radiance = B1's, {label}", out["queue"][1:2],
                  out["queue"][:1])

    small = (("cbox", cbox.build), ("glossy", gallery.build_glossy),
             ("tri", gallery.build_tri))
    # The adjoints' per-pixel cotangents, from a generator of their own.
    g_adj = torch.Generator(device=dev).manual_seed(161)
    for label, build in small:
        scene, params, cam = build(device=dev)
        alb, emi = albedo_table(scene, params), emission_table(scene, params)
        table = mk.scene_table(scene)
        for depth in (1, 5, 32):
            # 30x20: a warp's last round of the queue is partial.
            cfg_t = RenderConfig(width=30, height=20, spp=4, max_depth=depth)
            n = 30 * 20 * 4
            cam_u = torch.rand((2, n), generator=g, device=dev)
            tape = torch.rand((depth, 3, n), generator=g, device=dev)
            seeds = torch.tensor([depth, -3], dtype=torch.int32)
            g_t = torch.rand((3, n), generator=g, device=dev)
            cots = (g_t, torch.rand((3, 30 * 20), generator=g_adj,
                                    device=dev))
            for fast in (False, True):
                tag = f"{label}, depth {depth}, fast={fast}"
                out = runs(scene, alb, emi, cfg_t, fast,
                           dict(cam_u=cam_u, tape=tape), 1)
                hold(f"tape, {tag}", out)
                d_b4 = hold_adjoint(f"tape, {tag}", scene, alb, emi, cfg_t,
                                    fast, dict(cam_u=cam_u, tape=tape), cots)
                if not fast:
                    hold_ray_adjoint(f"tape, {tag}", scene, alb, emi, cfg_t,
                                     cam_u, tape, g_t, d_b4)
                if depth > 1:  # B4's retrace = sweep(collect), as before
                    kw = dict(rng="tape", fastmath=fast)
                    _, _, rsc, rbest = out["queue"]
                    same_bits(f"retrace adjoint = sweep(collect), tape, {tag}",
                              mk.make_fused_adjoint(scene, cam, cfg_t, **kw)(
                                  alb, emi, cam_u, tape, g_t),
                              mk.make_fused_sweep_adjoint(scene, cfg_t)(
                                  alb, emi, rsc, rbest, g_t))
                for chunks in (1, 3, 4, 16):
                    cfg_i = RenderConfig(width=30, height=20, spp=4 * chunks,
                                         spp_chunks=chunks, max_depth=depth)
                    out = runs(scene, alb, emi, cfg_i, fast,
                               dict(seeds=seeds), chunks)
                    hold(f"internal, {chunks} chunks, {tag}", out)
                    hold_adjoint(f"internal, {chunks} chunks, {tag}", scene,
                                 alb, emi, cfg_i, fast,
                                 dict(seeds=seeds, n_chunks=chunks), cots)
                    st = mk.fused_trace_stats(
                        scene, table, mk.camera_consts(cam, 30, 20), cfg_i,
                        alb, emi, seeds, fastmath=fast, n_chunks=chunks,
                        collect=True)
                    ref = mk.trip_counts_plain(cfg_i, out["queue"][3],
                                               seeds=seeds)
                    check(torch.equal(st["trips"], ref)
                          and st["lane_steps"] == int(ref.sum()),
                          f"trip counter != trip_counts_plain, {tag}")
                    same_bits(f"the counting build = B2, internal, {chunks} "
                              f"chunks, {tag}",
                              (st["radiance"], st["rsc"], st["rbest"]),
                              out["queue"][1:])
                    print(f"[trips] internal, {chunks} chunks, {tag}: "
                          f"lane-trips {st['lane_steps']} = "
                          f"trip_counts_plain, warp-trips "
                          f"{st['warp_steps']}", flush=True)
        if label == "cbox":  # the dyn tracer on cbox against B1, as before
            cfg_t = RenderConfig(width=30, height=20, spp=4, max_depth=5)
            compare("dyn tracer vs the queue's B1 (exact, same tapes), cbox",
                    dk.make_dyn_tracer(dk.DynScene(scene), cam, cfg_t,
                                       rng="tape")(alb, emi, cam_u, tape[:5]),
                    mk.make_fused_tracer(scene, cam, cfg_t, rng="tape")(
                        alb, emi, cam_u, tape[:5]), EXACT_TOL)

    # 61 real table rows (E = 183 accumulator entries a slot).
    scene, params, cam = gallery.build_rows(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    cfg_t = RenderConfig(width=30, height=20, spp=12, spp_chunks=3,
                         max_depth=5)
    cam_u = torch.rand((2, 2400), generator=g_adj, device=dev)
    tape = torch.rand((5, 3, 2400), generator=g_adj, device=dev)
    cots = (torch.rand((3, 2400), generator=g_adj, device=dev),
            torch.rand((3, 600), generator=g_adj, device=dev))
    for fast in (False, True):
        tag = f"61 table rows, fast={fast}"
        hold_adjoint(f"internal, 3 chunks, {tag}", scene, alb, emi, cfg_t,
                     fast, dict(seeds=torch.tensor([4, 5], dtype=torch.int32),
                                n_chunks=3), cots)
        cfg_1 = RenderConfig(width=30, height=20, spp=4, max_depth=5)
        d_b4 = hold_adjoint(f"tape, {tag}", scene, alb, emi, cfg_1, fast,
                            dict(cam_u=cam_u, tape=tape), cots)
        if not fast:
            hold_ray_adjoint(f"tape, {tag}", scene, alb, emi, cfg_1, cam_u,
                             tape, cots[0], d_b4)

    # The main shape and the CLI's default shape.
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    extra = {"fused_tracer": {}, "fused_collect": {}, "fused_adjoint": {},
             "ray_adjoint": {}}
    npix = 640 * 480
    g_main = torch.rand((3, npix), generator=g_adj, device=dev)
    cli = dict(width=640, height=480, spp=100, max_depth=32, spp_chunks=1)
    for shape, kw_cfg in (("main shape", MAIN), ("CLI default shape", cli)):
        cfg = RenderConfig(**kw_cfg)
        C = cfg.spp_chunks
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        g_pix = g_main / cfg.spp
        for fast in ((True, False) if shape == "main shape" else (True,)):
            tag = f"{shape}, {'fast' if fast else 'exact'}"
            out = runs(scene, alb, emi, cfg, fast, dict(seeds=seeds), C)
            hold(tag, out)
            del out
            d_b4 = hold_adjoint(tag, scene, alb, emi, cfg, fast,
                                dict(seeds=seeds, n_chunks=C), (g_pix,))
            print(f"[digest] B4 tables, {tag}: "
                  f"{[digest(t) for t in d_b4]}", flush=True)
        kw = dict(seeds=seeds, fastmath=True, n_chunks=C)
        times = {}
        for name, fn in (
                ("B1", lambda: mk.fused_trace(scene, table, cc, cfg, alb,
                                              emi, **kw)),
                ("B1 lockstep", lambda: mk.fused_trace(
                    scene, table, cc, cfg, alb, emi, build="lockstep", **kw)),
                ("B2", lambda: mk.fused_collect(scene, table, cc, cfg, alb,
                                                emi, **kw)),
                ("B2 lockstep", lambda: mk.fused_collect(
                    scene, table, cc, cfg, alb, emi, build="lockstep",
                    **kw)),
                ("B4", lambda: mk.fused_adjoint(scene, table, cc, cfg, alb,
                                                emi, g_pix, **kw)),
                ("B4 lockstep", lambda: mk.fused_adjoint(
                    scene, table, cc, cfg, alb, emi, g_pix, build="lockstep",
                    **kw))):
            times[name], win, _ = cuda_ms(fn, **timing)
            print(f"[time] {name} at the {shape}: {times[name]!r} ms, "
                  f"window means {win!r}, on {smi_line}", flush=True)
        pre = "" if shape == "main shape" else "cli_"
        for name, b in (("fused_tracer", "B1"), ("fused_collect", "B2"),
                        ("fused_adjoint", "B4")):
            if pre:
                extra[name]["cli_ms"] = times[b]
            extra[name][f"{pre}lockstep_ms"] = times[f"{b} lockstep"]
        print(f"[time] {shape}: B1 {times['B1'] / times['B1 lockstep']!r}, "
              f"B2 {times['B2'] / times['B2 lockstep']!r}, "
              f"B4 {times['B4'] / times['B4 lockstep']!r} of the lockstep "
              f"builds' time", flush=True)
        st = mk.fused_trace_stats(scene, table, cc, cfg, alb, emi, seeds,
                                  n_chunks=C, collect=True)
        ref = mk.trip_counts_plain(cfg, st["rbest"], seeds=seeds)
        check(torch.equal(st["trips"], ref),
              f"trip counter != trip_counts_plain at the {shape}")
        n_items = cfg.width * cfg.height * cfg.spp
        print(f"[trips] {shape}: lane-trips {st['lane_steps']} = "
              f"trip_counts_plain ({st['lane_steps'] / n_items!r} a path), "
              f"warp-trips {st['warp_steps']} "
              f"({st['warp_steps'] * 32 / st['lane_steps']!r} of lane-trips "
              f"/ 32), live after the bounce {st['live_lanes']}",
              flush=True)
        del st, ref
        torch.cuda.empty_cache()

    # B4 in tape mode and B5b on one chunk of the main shape: B4's rays and
    # hash tapes, both builds of B5b bit for bit and = B4, timed.
    cfg = RenderConfig(**{**MAIN, "spp": MAIN["spp"] // MAIN["spp_chunks"],
                          "spp_chunks": 1})
    cam_u, tape = hash_tapes(seeds, npix, cfg.spp, cfg.max_depth, device=dev)
    g_ray = torch.rand((3, cam_u.shape[1]), generator=g_adj, device=dev)
    d_b4 = hold_adjoint("tape, one chunk of the main shape, fast", scene,
                        alb, emi, cfg, True, dict(cam_u=cam_u, tape=tape),
                        (g_ray,))
    print(f"[digest] B4 tables, tape, one chunk of the main shape, fast: "
          f"{[digest(t) for t in d_b4]}", flush=True)
    d_b4 = mk.fused_adjoint(scene, table, mk.camera_consts(cam, 640, 480),
                            cfg, alb, emi, g_ray, cam_u=cam_u, tape=tape)
    o, d, d_b5b = hold_ray_adjoint("one chunk of the main shape", scene,
                                   alb, emi, cfg, cam_u, tape, g_ray, d_b4)
    print(f"[digest] B5b tables, one chunk of the main shape: "
          f"{[digest(t) for t in d_b5b]}", flush=True)
    for name, build in (("B5b", "queue"), ("B5b lockstep", "lockstep")):
        t, win, _ = cuda_ms(lambda: mk.ray_adjoint(
            scene, table, cfg, alb, emi, o, d, tape, g_ray, build=build),
            **timing)
        print(f"[time] {name} on one chunk of the main shape: {t!r} ms, "
              f"window means {win!r}, on {smi_line}", flush=True)
    extra["ray_adjoint"]["lockstep_ms"] = t
    del cam_u, tape, g_ray, o, d
    torch.cuda.empty_cache()

    # The breakdown (Step 1 of the design): cycles per section of a step.
    cfg = RenderConfig(**MAIN)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    for what, fn in (
            ("B1 lockstep (per warp-bounce)", lambda: mk.fused_trace_stats(
                scene, table, cc, cfg, alb, emi, seeds, queue=False,
                n_chunks=cfg.spp_chunks)),
            ("B1 queue (per warp-trip)", lambda: mk.fused_trace_stats(
                scene, table, cc, cfg, alb, emi, seeds,
                n_chunks=cfg.spp_chunks)),
            ("B10 (per warp-trip)", lambda: rg.regen_trip_stats(
                scene, table, cc, cfg, alb, emi, seeds,
                n_chunks=cfg.spp_chunks))):
        fn()
        st = fn()
        steps = st.get("warp_steps") or st["group_trips"]
        per = {k: round(v / steps, 1) for k, v in st["cycles"].items()}
        print(f"[breakdown] {what}: {steps} steps; clock64 cycles per step "
              f"by section {per} (total {sum(per.values())!r}) on "
              f"{smi_line}", flush=True)
        if "live_hist" in st and st["trips"] is None:
            h = st["live_hist"].double()
            k = torch.arange(33, dtype=torch.float64, device=h.device)
            print(f"[breakdown] live lanes per warp-bounce by bounce: "
                  f"{((h * k).sum(1) / h.sum(1)).tolist()}", flush=True)
    g_pix = g_main / cfg.spp
    ref = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g_pix,
                           seeds=seeds, fastmath=True,
                           n_chunks=cfg.spp_chunks)
    for what, queue in (("B4 lockstep (per warp-bounce)", False),
                        ("B4 queue (per warp-trip)", True)):
        for _ in range(2):  # the first is the warm-up
            st = mk.fused_adjoint_stats(scene, table, cc, cfg, alb, emi,
                                        g_pix, seeds, queue=queue,
                                        n_chunks=cfg.spp_chunks)
        same_bits(f"the timing build = B4, {what}", st["grads"], ref)
        steps = st["warp_steps"]
        per = {k: round(v / steps, 1) for k, v in st["cycles"].items()}
        print(f"[breakdown] {what}: {steps} steps, {st['lane_steps']} "
              f"lane-steps; clock64 cycles per step by section {per} (total "
              f"{sum(per.values())!r}) on {smi_line}", flush=True)
    return extra


def sweep_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 17: the stored-residual sweeps B3 (`fused_sweep`) and B8
    (`dyn_sweep`, csrc/sweep_rows.cuh: a slot's rows read up to its first
    dead row) against the retrace adjoints B4 and B9, bit for bit, with a
    per-ray and a per-pixel cotangent: B3 on cbox, glossy and tri (30x20x4
    spp a chunk), exact and fast, tape mode and the internal RNG in 1, 3
    and 16 chunks, depths 1, 5, 8, 9 and 32; B8 on cbox and the 87-, 327-
    and 1287-shape meshes in 1 and 3 chunks, depths 5, 9 and 32; both on
    rows filled with NaN after each slot's first dead row (= the sweep of
    the rows as they are); n_rays of 1, 127 and 129; the tables at their
    row limits (63 + 63 real rows for B3; 144 for B8, whose rows then come
    through registers, and 128, with a ring); and 641x479 pixels at the
    main shapes (n_rays not a multiple of 128). B3 is timed at the CLI's
    default shape, 640x480x100 at depth 32. Returns extra keys of the
    kernels line for B3: that time."""
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.scene import albedo_table, emission_table

    g = torch.Generator(device=dev).manual_seed(17)

    def nan_after_dead(rsc, word, live):
        dead = torch.cumsum((~live).to(torch.int32), dim=-2) > 0
        after = torch.cumsum(dead.to(torch.int32), dim=-2) > 1
        return (torch.where(after, float("nan"), rsc),
                torch.where(after, 0x7FC00000, word).to(torch.int32))

    def cots(cfg):
        n = cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks)
        return (torch.rand((3, n), generator=g, device=dev),
                torch.rand((3, cfg.width * cfg.height), generator=g,
                           device=dev))

    def wide(t, n):
        """t with its real rows repeated up to n - 1, the sentinel last."""
        reps = -(-(n - 1) // (t.shape[0] - 1))
        return torch.cat([torch.cat([t[:-1]] * reps)[:n - 1],
                          t[-1:]]).contiguous()

    def hold_b3(label, scene, cam, alb, emi, cfg, fast, uniforms, g_list):
        table = mk.scene_table(scene)
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        C = uniforms.get("n_chunks", 1)
        _, rsc, rbest = mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                         fastmath=fast, **uniforms)
        for kind, g_adj in zip(("per ray", "per pixel"), g_list):
            b3 = mk.fused_sweep(scene, table, cfg, alb, emi, rsc, rbest,
                                g_adj, n_chunks=C)
            same_bits(f"B3 = B4, {label}, g {kind}", b3, mk.fused_adjoint(
                scene, table, cc, cfg, alb, emi, g_adj, fastmath=fast,
                **uniforms))
        rsc, rbest = nan_after_dead(rsc, rbest, rbest > 0)
        same_bits(f"B3 on NaN after each slot's first dead row = B3, "
                  f"{label}", mk.fused_sweep(scene, table, cfg, alb, emi,
                                             rsc, rbest, g_adj, n_chunks=C),
                  b3)

    def hold_b8(label, ds, cam, alb, emi, cfg, fast, seeds, C, g_list):
        _, rsc, rrow = dk.make_dyn_collect_tracer(
            ds, cam, cfg, fastmath=fast, n_chunks=C)(alb, emi, seeds)
        sweep = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=C)
        adj = dk.make_dyn_adjoint(ds, cam, cfg, fastmath=fast, n_chunks=C)
        for kind, g_adj in zip(("per ray", "per pixel"), g_list):
            b8 = sweep(alb, emi, rsc, rrow, g_adj)
            same_bits(f"B8 = B9, {label}, g {kind}", b8,
                      adj(alb, emi, seeds, g_adj))
        rsc, rrow = nan_after_dead(rsc, rrow, (rrow >> 16) > 0)
        same_bits(f"B8 on NaN after each slot's first dead row = B8, "
                  f"{label}", sweep(alb, emi, rsc, rrow, g_adj), b8)

    n_cases = 0
    for label, build in (("cbox", cbox.build), ("glossy",
                                                gallery.build_glossy),
                         ("tri", gallery.build_tri)):
        scene, params, cam = build(device=dev)
        alb, emi = albedo_table(scene, params), emission_table(scene, params)
        for depth in (1, 5, 8, 9, 32):
            for fast in (False, True):
                tag = f"{label}, depth {depth}, fast={fast}"
                cfg = RenderConfig(width=30, height=20, spp=4,
                                   max_depth=depth)
                hold_b3(f"tape, {tag}", scene, cam, alb, emi, cfg, fast,
                        dict(cam_u=torch.rand((2, 2400), generator=g,
                                              device=dev),
                             tape=torch.rand((depth, 3, 2400), generator=g,
                                             device=dev)), cots(cfg))
                n_cases += 1
                for C in (1, 3, 16):
                    cfg = RenderConfig(width=30, height=20, spp=4 * C,
                                       spp_chunks=C, max_depth=depth)
                    hold_b3(f"internal, {C} chunks, {tag}", scene, cam, alb,
                            emi, cfg, fast,
                            dict(seeds=torch.tensor([depth, C],
                                                    dtype=torch.int32),
                                 n_chunks=C), cots(cfg))
                    n_cases += 1
    for label, build in (("cbox", cbox.build),
                         ("87-shape mesh", lambda device: gallery.build_mesh(
                             1, device=device)),
                         ("327-shape mesh", lambda device: gallery.build_mesh(
                             2, device=device)),
                         ("1287-shape mesh", lambda device: gallery.build_mesh(
                             3, device=device))):
        scene, params, cam = build(device=dev)
        ds = dk.DynScene(scene)
        alb, emi = albedo_table(scene, params), emission_table(scene, params)
        for depth in (5, 9, 32):
            for fast in (False, True):
                for C in (1, 3):
                    cfg = RenderConfig(width=30, height=20, spp=4 * C,
                                       spp_chunks=C, max_depth=depth)
                    hold_b8(f"{label}, {C} chunks, depth {depth}, "
                            f"fast={fast}", ds, cam, alb, emi, cfg, fast,
                            torch.tensor([depth, -C], dtype=torch.int32), C,
                            cots(cfg))
                    n_cases += 1
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    ds = dk.DynScene(scene)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    for n in (1, 127, 129):  # n x 1 pixels, one sample a chunk, 3 chunks
        cfg = RenderConfig(width=n, height=1, spp=3, spp_chunks=3,
                           max_depth=5)
        hold_b3(f"n_rays {n}, 3 chunks", scene, cam, alb, emi, cfg, True,
                dict(seeds=seeds, n_chunks=3), cots(cfg))
        hold_b8(f"n_rays {n}, 3 chunks, cbox", ds, cam, alb, emi, cfg, True,
                seeds, 3, cots(cfg))
    for depth in (5, 9):  # the accumulator at the row limits
        cfg = RenderConfig(width=30, height=20, spp=12, spp_chunks=3,
                           max_depth=depth)
        a, e = wide(alb, 64), wide(emi, 64)
        stages = mk.fused_sweep_stages(64, 64, depth)
        check(stages == 3, f"B3's ring at 63 + 63 rows: {stages} stages")
        hold_b3(f"63 + 63 table rows (E = 378, {stages} ring stages), "
                f"depth {depth}", scene, cam, a, e, cfg, True,
                dict(seeds=seeds, n_chunks=3), cots(cfg))
        for rows in (73, 65):
            a, e = wide(alb, rows), wide(emi, rows)
            stages = dk.dyn_sweep_stages(rows, rows, depth)
            check(stages == (0 if rows == 73 else 3),
                  f"B8's ring at {rows - 1} + {rows - 1} rows: {stages} "
                  f"stages")
            hold_b8(f"{rows - 1} + {rows - 1} table rows ({stages} ring "
                    f"stages: {'registers' if stages == 0 else 'ring'})"
                    f", depth {depth}", ds, cam, a, e, cfg, True, seeds, 3,
                    cots(cfg))
    for depth in (1, 2, 3, 5, 8, 9, 32):  # the stages by table rows
        got = (mk.fused_sweep_stages(4, 2, depth),
               mk.fused_sweep_stages(64, 64, depth),
               dk.dyn_sweep_stages(4, 2, depth),
               dk.dyn_sweep_stages(65, 65, depth),
               dk.dyn_sweep_stages(73, 73, depth))
        check(got == (3, 3, 3, 3, {1: 3, 2: 2}.get(depth, 0)),
              f"sweep ring stages at E = 12, 378 (B3), 12, 384, 432 (B8), "
              f"depth {depth}: {got}")
    print(f"[sweep] B3 = B4 and B8 = B9 bit for bit in {n_cases} "
          f"configurations, on NaN rows after the first dead row, at n_rays "
          f"1, 127, 129 and at the row limits", flush=True)
    # 641 x 479 pixels: n_rays not a multiple of 128 at the main shapes.
    cfg = RenderConfig(**{**MAIN, "width": 641, "height": 479})
    hold_b3("641x479x256, 16 chunks, fast", scene, cam, alb, emi, cfg, True,
            dict(seeds=seeds, n_chunks=16), cots(cfg))
    scene, params, cam = gallery.build_mesh(3, device=dev)
    ds = dk.DynScene(scene)
    m_alb, m_emi = albedo_table(scene, params), emission_table(scene, params)
    cfg = RenderConfig(**{**MESH_MAIN, "width": 641, "height": 479})
    hold_b8("1287-shape mesh 641x479x64, 4 chunks, fast", ds, cam, m_alb,
            m_emi, cfg, True, seeds, 4, cots(cfg))
    torch.cuda.empty_cache()
    # B3 at the CLI's default shape.
    scene, params, cam = cbox.build(device=dev)
    cfg = RenderConfig(width=640, height=480, spp=100, max_depth=32)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 fastmath=True)(alb, emi,
                                                                seeds)
    g_cli = torch.rand((3, 640 * 480), generator=g, device=dev) / cfg.spp
    sweep = mk.make_fused_sweep_adjoint(scene, cfg)
    t, win, d_cli = cuda_ms(lambda: sweep(alb, emi, rsc, rbest, g_cli),
                            **timing)
    ends = int((rbest == 0).any(dim=0).sum().item())
    live = int((rbest > 0).sum().item())
    needed = 4 * (2 * live + ends)
    print(f"[time] B3 at the CLI default shape (640x480x100, depth 32): "
          f"{t!r} ms, window means {win!r}; {rsc.numel() * 8 / t / 1e6!r} "
          f"GB/s of every row, {needed / t / 1e6!r} GB/s of the {needed} "
          f"bytes it needs ({needed / PEAK_BYTES_PER_S * 1e3 / t!r} of that "
          f"bound) on {smi_line}", flush=True)
    print(f"[digest] B3 tables, CLI default shape, fast: "
          f"{[digest(t) for t in d_cli]}", flush=True)
    del rsc, rbest
    torch.cuda.empty_cache()
    return {"fused_sweep": {"cli_ms": t}}


def split_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 18: per-vertex splitting (bsdf_samples > 1) on the tape forms
    of the fused kernels (B1-B4), the memory-resident kernels (B6-B9) and
    the wavefront kernels (B5a, B5b). Returns, per kernel it launches, the
    keys it adds to that kernel's row of the kernels line: its launches on
    the split paths and, for B1-B4, its time per launch on one chunk of
    the Cornell box split cell."""
    from drt_tpu_torch import fused, gradcheck, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
    from drt_tpu_torch.renderer import lane_count
    from drt_tpu_torch.scene import Params, albedo_table, emission_table

    t_phase = time.time()

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def allocator(label):
        """The caching allocator's state, beside the phase's host times."""
        st = torch.cuda.memory_stats(dev)
        print(f"[split] allocator {label}: reserved "
              f"{st.get('reserved_bytes.all.current')} B, allocated "
              f"{st.get('allocated_bytes.all.current')} B, cudaMalloc "
              f"{st.get('num_device_alloc')}, cudaFree "
              f"{st.get('num_device_free')}, alloc retries "
              f"{st.get('num_alloc_retries')}", flush=True)

    allocator("at the phase's start")

    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s, tgt):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - tgt) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad), img.detach()

    def planes(img):
        return img.permute(2, 0, 1).reshape(3, -1)

    # 18.1: every kernel of the split paths against its plain version on
    # one split_prefix_tape, 64x48x2 spp, depth 5, 2 samples a vertex.
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=5,
                       bsdf_samples=2)
    cfg_l = fused.split_chunk_cfg(cfg)
    seeds = torch.tensor([17, -18], dtype=torch.int32)
    cam_u, tape = fused.split_prefix_tape(seeds, 0, cfg, dev)
    n = cam_u.shape[1]
    npix = cfg.width * cfg.height
    g_pix = torch.rand((3, npix), generator=torch.Generator(
        device=dev).manual_seed(18), device=dev)
    print(f"[split] small shape 64x48x2 spp, depth 5, bsdf_samples=2: "
          f"{lane_count(cfg)} lanes a camera sample, {n} lanes", flush=True)
    families = {
        "fused": ((mk.make_fused_tracer, mk.make_fused_collect_tracer,
                   mk.make_fused_sweep_adjoint, mk.make_fused_adjoint),
                  lambda best: best > 0, ("B1", "B2", "B3", "B4")),
        "dyn": ((dk.make_dyn_tracer, dk.make_dyn_collect_tracer,
                 dk.make_dyn_sweep_adjoint, dk.make_dyn_adjoint),
                lambda rrow: (rrow >> 16) > 0, ("B6", "B7", "B8", "B9"))}
    for label, build, family in (
            ("cbox", cbox.build, "fused"), ("glossy", gallery.build_glossy,
                                            "fused"),
            ("mesh87", lambda device: gallery.build_mesh(1, device=device),
             "dyn")):
        scene, params, cam = build(device=dev)
        alb, emi = tables(scene, params)
        kscene = scene if family == "fused" else dk.DynScene(scene)
        (m_trace, m_collect, m_sweep, m_adj), live_of, names = \
            families[family]
        plain = dict(rng="tape", plain=True)
        L = m_trace(kscene, cam, cfg_l, rng="tape")(alb, emi, cam_u, tape)
        compare(f"split {names[0]} vs plain, {label}", L,
                m_trace(kscene, cam, cfg_l, **plain)(alb, emi, cam_u, tape),
                EXACT_TOL)
        L_c, rsc, rows = m_collect(kscene, cam, cfg_l, rng="tape")(
            alb, emi, cam_u, tape)
        same_bits(f"split {names[1]} radiance = {names[0]}'s, {label}",
                  (L_c,), (L,))
        _, rsc_r, rows_r = m_collect(kscene, cam, cfg_l, **plain)(
            alb, emi, cam_u, tape)
        compare_residuals(f"split {names[1]} vs plain, {label}", (rsc, rows),
                          (rsc_r, rows_r), EXACT_TOL, 0.0, RSC_SHARE_SMALL,
                          live_of)
        d_sweep = m_sweep(kscene, cfg_l)(alb, emi, rsc, rows, g_pix)
        compare_grads(f"split {names[2]} vs plain on the kernel's rows, "
                      f"{label}", d_sweep, m_sweep(kscene, cfg_l, plain=True)(
                          alb, emi, rsc, rows, g_pix), GRAD_RTOL_SMALL)
        d_adj = m_adj(kscene, cam, cfg_l, rng="tape")(alb, emi, cam_u, tape,
                                                       g_pix)
        same_bits(f"split {names[3]} = {names[2]}({names[1]}): stored = "
                  f"retrace, {label}", d_adj, d_sweep)
        compare_grads(f"split {names[3]} vs plain, {label}", d_adj,
                      m_adj(kscene, cam, cfg_l, **plain)(
                          alb, emi, cam_u, tape, g_pix), GRAD_RTOL_SMALL)
        if family != "fused":
            continue
        # B5a and B5b's tape forms on the same lanes, from the kernel
        # camera's rays.
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        o, d = mk.camera_ray_from_pix(cc, torch.arange(n, device=dev) % npix,
                                      cam_u[0], cam_u[1])
        o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
        compare(f"split B5a (tape form) vs plain, {label}",
                mk.make_pallas_tracer(scene, cfg_l)(alb, emi, o, d, tape),
                mk.make_pallas_tracer(scene, cfg_l, plain=True)(
                    alb, emi, o, d, tape), EXACT_TOL)
        g_lane = g_pix.repeat(1, n // npix)
        compare_grads(f"split B5b vs plain, {label}",
                      mk.make_pallas_adjoint(scene, cfg_l)(
                          alb, emi, o, d, tape, g_lane),
                      mk.make_pallas_adjoint(scene, cfg_l, plain=True)(
                          alb, emi, o, d, tape, g_lane), GRAD_RTOL_SMALL)
    del cam_u, tape

    # 18.2: "cuda-split", the Cornell box at 640x480x16 spp in 4 chunks,
    # depth 5, 2 samples a vertex: 16 lanes a camera sample.
    cfg_m = RenderConfig(width=640, height=480, spp=16, spp_chunks=4,
                         max_depth=5, bsdf_samples=2)
    C = cfg_m.spp_chunks
    n_lanes = cfg_m.width * cfg_m.height * cfg_m.spp * lane_count(cfg_m)
    cfg_ml = fused.split_chunk_cfg(cfg_m)
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    check(resolve_backend(scene, cfg_m) == "cuda-split",
          "a split Cornell box on the card must resolve to 'cuda-split'")
    check(fused._resolve_adjoint(cfg_m, "auto", dev) == "stored",
          "the split cell's adjoint must resolve to 'stored'")
    print(f"[split] cuda-split 640x480x16 spp, 4 chunks, depth 5, "
          f"bsdf_samples=2: {n_lanes // C} lanes a chunk, {n_lanes} a "
          f"render; residuals {fused.stored_bytes(cfg_m)} B of a "
          f"budget of {fused.stored_budget_bytes(dev)} B", flush=True)
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2)]
    extra = {}
    render = make_renderer(scene, cfg_m, cam, differentiable=False)
    mk.reset_launch_counts()
    images, t_fwd = [], []
    for s in seed_list:  # the first is the warm-up
        t0 = time.perf_counter()
        images.append(render(params, s))
        torch.cuda.synchronize()
        t_fwd.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    check(counts == only(fused_tracer=C * len(seed_list)),
          f"the split forward launched {counts}")
    extra["fused_tracer"] = dict(split_launches=C)
    for s, img in zip(seed_list[1:], images[1:]):
        check(img.shape == (480, 640, 3) and img.dtype == torch.float32,
              f"split image {tuple(img.shape)} {img.dtype}")
        reads_right(img, f"cuda-split, seed {s.tolist()}")
    t0 = time.perf_counter()
    ref = make_renderer(scene, cfg_m, cam, differentiable=False,
                        backend="torch-split")(params, seed_list[1])
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    compare("cuda-split image vs torch-split at the same seeds (per pixel)",
            planes(images[1]), planes(ref), EXACT_TOL)
    del ref
    # One chunk's tape, and each kernel on one chunk's lanes.
    tape_ms, tape_win, (cu, tp) = cuda_ms(
        lambda: fused.split_prefix_tape(seed_list[1], 1, cfg_m, dev),
        reps=3, warmup=1, windows=1)
    g_main = torch.rand((3, cfg_m.width * cfg_m.height), generator=
                        torch.Generator(device=dev).manual_seed(19),
                        device=dev) / (cfg_m.spp * lane_count(cfg_m))
    b1 = mk.make_fused_tracer(scene, cam, cfg_ml, rng="tape")
    b2 = mk.make_fused_collect_tracer(scene, cam, cfg_ml, rng="tape")
    b3 = mk.make_fused_sweep_adjoint(scene, cfg_ml)
    b4 = mk.make_fused_adjoint(scene, cam, cfg_ml, rng="tape")
    kernel_ms = {}
    kernel_ms["fused_tracer"], _, _ = cuda_ms(
        lambda: b1(alb, emi, cu, tp), **timing)
    kernel_ms["fused_collect"], _, (_, rsc, rbest) = cuda_ms(
        lambda: b2(alb, emi, cu, tp), **timing)
    kernel_ms["fused_sweep"], _, d_sweep = cuda_ms(
        lambda: b3(alb, emi, rsc, rbest, g_main), **timing)
    kernel_ms["fused_adjoint"], _, d_adj = cuda_ms(
        lambda: b4(alb, emi, cu, tp, g_main), **timing)
    same_bits("split B4 = B3(B2) on one chunk of the split cell", d_adj,
              d_sweep)
    live = int((rbest > 0).sum().item())
    del cu, tp, rsc, rbest
    print(f"[time] split cell, one chunk of {n_lanes // C} lanes: "
          f"split_prefix_tape {tape_ms!r} ms (window means {tape_win!r}), "
          f"B1 {kernel_ms['fused_tracer']!r}, B2 "
          f"{kernel_ms['fused_collect']!r}, B3 {kernel_ms['fused_sweep']!r}"
          f", B4 {kernel_ms['fused_adjoint']!r} ms; {live} live "
          f"bounce-lanes of {n_lanes // C * cfg_m.max_depth}; on {smi_line}",
          flush=True)
    t_f = statistics.median(t_fwd[1:])
    print(f"[split] cuda-split forward: seconds {t_fwd[1:]!r} "
          f"({n_lanes / t_f / 1e6!r} Mlanes/s); the tape {C} x {tape_ms!r} "
          f"ms = {C * tape_ms / 1e3 / t_f!r} of it; torch-split forward "
          f"{t_plain!r} s; on {smi_line}", flush=True)

    target = images[1]
    del images
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    steps = {}
    for label, render_fn, expected, n_tapes in (
            ("stored (auto)", make_renderer(scene, cfg_m, cam),
             only(fused_collect=C, fused_sweep=C), C),
            ("retrace", fused.make_split_fused_image_renderer(
                scene, cam, cfg_m, adjoint="retrace"),
             only(fused_tracer=C, fused_adjoint=C), 2 * C)):
        counts, out = time_steps(
            f"cuda-split, {label}",
            lambda: step(render_fn, p_off, seed_list[1], target)[:2], mk,
            expected, n_lanes, n_steps=3)
        steps[label] = out[1]
        for name, k in counts.items():
            if k:
                extra.setdefault(name, {})["split_launches"] = k // 3
        t_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(render_fn, p_off, seed_list[1], target)
            torch.cuda.synchronize()
            t_s.append(time.perf_counter() - t0)
        t_med = statistics.median(t_s)
        print(f"[split] cuda-split {label} step: seconds {t_s!r}; the tape "
              f"{n_tapes} x {tape_ms!r} ms = {n_tapes * tape_ms / 1e3 / t_med!r}"
              f" of it; on {smi_line}", flush=True)
    same_bits("cuda-split stored step = retrace step (gradient tables)",
              steps["stored (auto)"], steps["retrace"])
    # Against the plain version on one chunk of the same config.
    cfg_1 = dataclasses.replace(cfg_m, spp=cfg_m.spp // C, spp_chunks=1)
    pair = []
    for backend in ("cuda-split", "torch-split"):
        t0 = time.perf_counter()
        pair.append(step(make_renderer(scene, cfg_1, cam, backend=backend),
                         p_off, seed_list[2], target))
        torch.cuda.synchronize()
        print(f"[grad] split, one chunk, {backend}: loss="
              f"{pair[-1][0].item()!r} seconds={time.perf_counter() - t0!r}",
              flush=True)
    compare_grads("cuda-split grads vs torch-split on one chunk", pair[0][1],
                  pair[1][1], GRAD_RTOL_MAIN)
    del pair
    true_red = params.albedo[cbox.RED].clone()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    n_train = 5
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    fitted, metrics = optim.inverse_render(
        scene, cfg_m, cam, target, Params(start, params.emission),
        torch.Generator().manual_seed(5), steps=n_train)
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) / n_train
    counts = mk.launch_counts()
    before = (start[cbox.RED] - true_red).norm().item()
    after = (fitted.albedo[cbox.RED] - true_red).norm().item()
    print(f"[train] inverse_render, split cell, {n_train} steps: launches="
          f"{counts} seconds per step={t_train!r} loss="
          f"{metrics['loss'].tolist()} red row distance {before!r} -> "
          f"{after!r} on {smi_line}", flush=True)
    check(counts == only(fused_collect=2 * C * n_train,
                         fused_sweep=2 * C * n_train),
          f"the split trainer launched {counts}")
    check(bool(torch.isfinite(metrics["loss"]).all()),
          "the split trainer's losses are not finite")
    check(after < before, "split trainer: the perturbed albedo row moved "
          "away from its true value")
    split_image = target
    torch.cuda.empty_cache()

    # 18.3: "cuda-split-dyn", the 1287-shape mesh at 640x480x4 spp, one
    # chunk, depth 5, 2 samples a vertex.
    cfg_d = RenderConfig(width=640, height=480, spp=4, max_depth=5,
                         bsdf_samples=2)
    mesh, mesh_params, mesh_cam = gallery.build_mesh(3, device=dev)
    check(resolve_backend(mesh, cfg_d) == "cuda-split-dyn",
          "the split 1287-shape mesh must resolve to 'cuda-split-dyn'")
    n_dyn = cfg_d.width * cfg_d.height * cfg_d.spp * lane_count(cfg_d)
    render = make_renderer(mesh, cfg_d, mesh_cam, differentiable=False)
    mk.reset_launch_counts()
    t_fwd = []
    for s in seed_list:
        t0 = time.perf_counter()
        img = render(mesh_params, s)
        torch.cuda.synchronize()
        t_fwd.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    check(counts == only(dyn_tracer=len(seed_list)),
          f"the split dyn forward launched {counts}")
    check(bool(torch.isfinite(img).all()) and img.mean().item() > 0,
          "split mesh image not finite, or black")
    extra["dyn_tracer"] = dict(split_launches=1)
    print(f"[split] cuda-split-dyn forward, 1287 shapes, {n_dyn} lanes: "
          f"seconds {t_fwd[1:]!r}, image mean {img.mean().item()!r}; on "
          f"{smi_line}", flush=True)
    # The one launch of 19.66 M lanes against the plain version at its
    # size: the same samples in 4 chunks of one sample each (chunk c draws
    # sample c), a forward only (the plain step takes ~10 s a chunk).
    cfg_d4 = dataclasses.replace(cfg_d, spp_chunks=cfg_d.spp)
    t0 = time.perf_counter()
    ref = make_renderer(mesh, cfg_d4, mesh_cam, differentiable=False,
                        backend="torch-split-dyn")(mesh_params, seed_list[2])
    torch.cuda.synchronize()
    print(f"[split] torch-split-dyn forward, {cfg_d.spp} chunks of "
          f"{n_dyn // cfg_d.spp} lanes: seconds "
          f"{time.perf_counter() - t0!r}", flush=True)
    compare(f"cuda-split-dyn image, one launch of {n_dyn} lanes, vs "
            f"torch-split-dyn in {cfg_d.spp} chunks (per pixel)",
            planes(img), planes(ref), EXACT_TOL)
    del ref
    render_fn = make_renderer(mesh, cfg_d, mesh_cam)
    _, (_, grads_d) = time_steps(
        "cuda-split-dyn, stored (auto)",
        lambda: step(render_fn, mesh_params, seed_list[1], img)[:2],
        mk, only(dyn_collect=1, dyn_sweep=1), n_dyn, n_steps=3)
    extra["dyn_collect"] = dict(split_launches=1)
    extra["dyn_sweep"] = dict(split_launches=1)
    grads_d4 = step(make_renderer(mesh, cfg_d4, mesh_cam), mesh_params,
                    seed_list[1], img)[1]
    compare_grads(f"cuda-split-dyn step, one launch of {n_dyn} lanes, vs "
                  f"{cfg_d.spp} launches of {n_dyn // cfg_d.spp}", grads_d,
                  grads_d4, GRAD_RTOL_MAIN)
    del grads_d, grads_d4
    # The step against the plain version on the first of its 4 samples
    # (the plain step takes ~10 s for these 4.9 M lanes); the retrace
    # form (B6 + B9) = the stored form there.
    cfg_d1 = dataclasses.replace(cfg_d, spp=1)
    pair = []
    for backend in ("cuda-split-dyn", "torch-split-dyn"):
        t0 = time.perf_counter()
        pair.append(step(make_renderer(mesh, cfg_d1, mesh_cam,
                                       backend=backend), mesh_params,
                         seed_list[2], img))
        torch.cuda.synchronize()
        print(f"[grad] split mesh, 1 spp, {backend}: loss="
              f"{pair[-1][0].item()!r} seconds={time.perf_counter() - t0!r}",
              flush=True)
    compare("cuda-split-dyn image vs torch-split-dyn, 1 spp (per pixel)",
            planes(pair[0][2]), planes(pair[1][2]), EXACT_TOL)
    compare_grads("cuda-split-dyn grads vs torch-split-dyn, 1 spp",
                  pair[0][1], pair[1][1], GRAD_RTOL_MAIN)
    mk.reset_launch_counts()
    retrace = step(fused.make_split_dyn_image_renderer(
        mesh, mesh_cam, cfg_d1, adjoint="retrace"), mesh_params,
        seed_list[2], img)
    check(mk.launch_counts() == only(dyn_tracer=1, dyn_adjoint=1),
          f"the split dyn retrace step launched {mk.launch_counts()}")
    extra["dyn_adjoint"] = dict(split_launches=1)
    same_bits("cuda-split-dyn stored = retrace, 1 spp", pair[0][1],
              retrace[1])
    del pair, retrace, mesh, img
    torch.cuda.empty_cache()

    allocator("before the split wavefront")
    # 18.4: "cuda-wavefront" at 2 samples a vertex, the Cornell box at
    # 640x480x16 spp in 16 chunks: each chunk's rays split into 16
    # ray-major lanes through B5a's and B5b's tape forms.
    cfg_w = dataclasses.replace(cfg_m, spp_chunks=16)
    render = make_renderer(scene, cfg_w, cam, differentiable=False,
                           backend="cuda-wavefront")
    mk.reset_launch_counts()
    t_fwd = []
    for s in seed_list[:2]:
        t0 = time.perf_counter()
        img_w = render(params, s)
        torch.cuda.synchronize()
        t_fwd.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    check(counts == only(ray_tracer=2 * 16),
          f"the split wavefront forward launched {counts}")
    print(f"[split] cuda-wavefront forward at bsdf_samples=2, 16 chunks: "
          f"seconds {t_fwd[1:]!r}; on {smi_line}", flush=True)
    compare("cuda-wavefront image at bsdf_samples=2 vs cuda-split's at the "
            "same seeds (per pixel)", planes(img_w), planes(split_image),
            EXACT_TOL)
    render_fn = make_renderer(scene, cfg_w, cam, backend="cuda-wavefront")
    _, (_, grads_w) = time_steps(
        "cuda-wavefront, bsdf_samples=2",
        lambda: step(render_fn, p_off, seed_list[1], split_image)[:2], mk,
        only(ray_tracer=16, ray_adjoint=16), n_lanes, n_steps=2)
    compare_grads("cuda-wavefront step at bsdf_samples=2 vs cuda-split's "
                  "stored step (same seeds, target and params)", grads_w,
                  steps["stored (auto)"], GRAD_RTOL_MAIN)
    extra["ray_tracer"] = dict(split_launches=16)
    extra["ray_adjoint"] = dict(split_launches=16)
    cfg_g = RenderConfig(width=64, height=48, spp=4, max_depth=3,
                         bsdf_samples=2)
    mk.reset_launch_counts()
    res = gradcheck.check_gradients(scene, cam, cfg_g, params, seeds,
                                    rtol=1e-4)
    counts = mk.launch_counts()
    print(f"[gradcheck] check_gradients 64x48x4, depth 3, bsdf_samples=2 "
          f"on the card, rtol 1e-4: {res!r}; launches={counts}", flush=True)
    check(counts == only(ray_tracer=1, ray_adjoint=1),
          f"split check_gradients launched {counts}")
    for name, ms in kernel_ms.items():
        extra[name]["split_ms"] = ms
    extra["fused_tracer"]["split_tape_ms"] = tape_ms
    print(f"[phase] 18 (split): {time.time() - t_phase:.1f}s", flush=True)
    return extra


def invert_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 19: the inverse-rendering entry point, `cli invert`, in
    process at the CLI's full default shape (640x480x100 spp, depth 32,
    one chunk: "auto" takes "cuda", the stored adjoint), 60 steps a run:
    a run resumed from its checkpoint at 50 equals the uninterrupted one,
    and --steps-per-call 1 equals 8, bit for bit; the launch counts of a
    run; its metrics file; the utilities on the card (validate_scene,
    assert_finite, a block of 8 steps with no synchronizing call, a
    profiler trace of a step that names B2's and B3's kernels); seconds a
    trainer step at 1 and 8 steps a block and of one save_dir. Returns,
    for B1, B2 and B3, their launches in one run as `invert_launches`."""
    import tempfile

    from drt_tpu_torch import cli, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params
    from drt_tpu_torch.utils import checkpoint, debug, profiling

    t_phase = time.time()
    steps, every = 60, 50  # every: inverse_render's checkpoint_every
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def invert(name, *argv):
            out = tmp / f"{name}.json"
            t0 = time.perf_counter()
            rc = cli.main(["invert", "-o", str(out), *argv])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(rc == 0, f"cli invert {argv} returned {rc}")
            return json.loads(out.read_text()), seconds

        def saved(directory, step):
            state, gen_state, _ = checkpoint.restore_dir(
                str(directory), like, step)
            return [*state.params, *state.opt_state.mu, *state.opt_state.nu,
                    torch.tensor(state.step), gen_state]

        scene, params, cam = cbox.build(device=dev)
        debug.validate_scene(scene, params)
        like = optim.init_state(params)
        ck_a, jsonl = tmp / "a", tmp / "a.jsonl"
        mk.reset_launch_counts()
        a, t_a = invert("a", "--steps", str(steps), "--checkpoint-dir",
                        str(ck_a), "--metrics-jsonl", str(jsonl))
        counts = mk.launch_counts()
        print(f"[invert] cli invert 640x480x100 depth 32, {steps} steps, "
              f"--steps-per-call 8: {t_a!r} s with the target render and "
              f"the renderers' set-up; launches={counts}; final_loss="
              f"{a['final_loss']!r}; recovered albedo "
              f"{a['recovered_albedo']} (true {a['true_albedo']}), "
              f"emission {a['recovered_emission']} (true "
              f"{a['true_emission']})", flush=True)
        check(counts == only(fused_tracer=1, fused_collect=2 * steps,
                             fused_sweep=2 * steps),
              f"cli invert launched {counts}")
        debug.assert_finite({k: torch.tensor(a[k]) for k in a},
                            "cli invert output")
        check(sorted(p.name for p in ck_a.iterdir())
              == [f"{every}.npz", f"{steps}.npz"],
              f"checkpoints written: {sorted(ck_a.iterdir())}")
        recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
        print(f"[invert] metrics file: {recs}", flush=True)
        check([r["step"] for r in recs] == [0, 20, 40, steps - 1]
              and all({"step", "t", "loss", "grad_norm"} <= set(r)
                      and math.isfinite(r["loss"])
                      and math.isfinite(r["grad_norm"])
                      for r in recs),
              "the metrics file lacks the lines --log-every 20 selects")

        ck_b = tmp / "b"
        invert("b50", "--steps", str(every), "--checkpoint-dir", str(ck_b),
               "--log-every", "0")
        check(checkpoint.latest_step(str(ck_b)) == every,
              f"the 50-step run saved {sorted(ck_b.iterdir())}")
        b, _ = invert("b", "--steps", str(steps), "--checkpoint-dir",
                      str(ck_b), "--log-every", "0")
        check(b == a, "the run resumed at 50 differs from the "
              f"uninterrupted one: {b} against {a}")
        for k, (x, y) in enumerate(zip(saved(ck_b, steps),
                                       saved(ck_a, steps))):
            check(torch.equal(x, y), f"checkpoint {steps} of the resumed "
                  f"run differs from the uninterrupted one's in leaf {k}")
        c, _ = invert("c", "--steps", str(steps), "--steps-per-call", "1",
                      "--log-every", "0")
        check(c == a, "--steps-per-call 1 differs from 8: "
              f"{c} against {a}")
        print(f"[invert] resumed at {every} = uninterrupted (outputs and "
              f"checkpoint {steps}: params, moments, step, generator); "
              "--steps-per-call 1 = 8: bit-equal" if b == c == a else
              "[invert] resumed or single-step run differs", flush=True)

        # The trainer under the utilities: the CLI's target and start.
        cfg = RenderConfig(**CLI_SHAPE)
        target = make_renderer(scene, cfg, cam, differentiable=False)(
            params, seeds_from_generator(torch.Generator().manual_seed(1)))
        init = Params(torch.full_like(params.albedo, 0.25),
                      torch.full_like(params.emission, 0.5))
        block = optim.make_train_block(scene, cfg, cam, target,
                                       optim.Adam(2e-2))
        gen = torch.Generator().manual_seed(0)
        state, _ = block(optim.init_state(init), gen, 8)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = block(state, gen, 8)
            synced = None
        except RuntimeError as e:
            synced = str(e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(synced is None, f"a block of 8 steps synchronized: {synced}")
        debug.assert_finite(metrics, "block metrics")
        debug.assert_finite(state, "trainer state")
        print(f"[invert] one block of 8 steps under "
              f"set_sync_debug_mode('error'): no synchronizing call; "
              f"loss={metrics['loss'].tolist()}", flush=True)

        step = optim.make_train_step(scene, cfg, cam, target,
                                     optim.Adam(2e-2))
        with profiling.trace(str(tmp / "trace")) as prof:
            step(state, gen)
            torch.cuda.synchronize()
        text = (tmp / "trace" / profiling.TRACE_FILE).read_text()
        from torch.autograd import DeviceType
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"[invert] profiling.trace of one step: {len(text)} bytes; "
              "device ms by name: "
              + "; ".join(f"{n[:50]} {ms!r}" for n, ms in top), flush=True)
        for kernel in ("queue_trace_kernel", "fused_sweep_kernel"):
            check(kernel in text, f"the step's trace does not name {kernel}")

        n_timed = 16
        t_step = {}
        for k in (1, 8, 8, 1):
            best, _ = profiling.timed(
                lambda: optim.inverse_render(
                    scene, cfg, cam, target, init,
                    torch.Generator().manual_seed(0), steps=n_timed,
                    steps_per_call=k), warmup=1, reps=2)
            t_step.setdefault(k, []).append(best / n_timed)
        t_save, _ = profiling.timed(
            lambda: checkpoint.save_dir(str(tmp / "t"), state, gen),
            warmup=1, reps=5)
        # The same save from a copy of the state on the host: the file
        # write alone, without the reads from the card.
        host_state, _, _ = checkpoint.restore_dir(
            str(tmp / "t"), optim.init_state(Params(*(t.cpu()
                                                      for t in init))))
        t_host, _ = profiling.timed(
            lambda: checkpoint.save_dir(str(tmp / "h"), host_state, gen),
            warmup=1, reps=5)
        print(f"[time] trainer s/step at the CLI shape (inverse_render, "
              f"{n_timed} steps a call, best of 2 after a warm-up, in "
              f"turns 1, 8, 8, 1): steps_per_call=1 {t_step[1]!r}, "
              f"steps_per_call=8 {t_step[8]!r}; one save_dir "
              f"{t_save * 1e3!r} ms, of a host copy of the state "
              f"{t_host * 1e3!r} ms (best of 5) on {smi_line}", flush=True)
    print(f"[phase] 19 (invert): {time.time() - t_phase:.1f}s", flush=True)
    return {"fused_tracer": dict(invert_launches=counts["fused_tracer"]),
            "fused_collect": dict(invert_launches=counts["fused_collect"]),
            "fused_sweep": dict(invert_launches=counts["fused_sweep"])}


# Phase 20's tolerance of a sharded render's gradients against one
# device's: the same partials summed in another order.
MESH_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
# Phase 20's two-process leg: its ranks' time limit, in seconds.
MESH_WORKER_TIMEOUT = 300


def mesh_step(render_fn, p, s, tgt):
    """A forward + backward of the mean squared image loss: (loss,
    (d_albedo, d_emission), image)."""
    from drt_tpu_torch.scene import Params

    p = Params(*(t.detach().clone().requires_grad_() for t in p))
    img = render_fn(p, s)
    check(img.grad_fn is not None, "the image carries no grad_fn")
    loss = ((img - tgt) ** 2).mean()
    loss.backward()
    return loss.detach(), (p.albedo.grad, p.emission.grad), img.detach()


def grads_allclose(name: str, got, ref) -> float:
    """(d_albedo, d_emission) within MESH_GRAD_TOL of one device's;
    returns the larger max abs error."""
    torch.cuda.synchronize()
    worst = 0.0
    for label, g, r in zip(("d_albedo", "d_emission"), got, ref):
        err = (g - r).abs().max().item()
        print(f"[compare] {name}: {label} max_abs={err!r} max|ref|="
              f"{r.abs().max().item()!r}", flush=True)
        check(bool(r.abs().max() > 0), f"{name}: {label} is all zero")
        check(torch.allclose(g, r, **MESH_GRAD_TOL),
              f"{name}: {label} beyond rtol 2e-5 / atol 1e-7")
        worst = max(worst, err)
    return worst


def mesh_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 20: rendering over a device mesh (`parallel.mesh`,
    `parallel.multihost`), its shards on the one card: make_renderer on a
    mesh through "auto" and each "-sharded" backend and the wavefront,
    each against the same backend on one device (image bit for bit,
    stored and retrace gradients within rtol 2e-5 / atol 1e-7, a trainer's
    Adam steps), the launches of each path; two processes sharing the card
    over gloo (CUDA tensors); the tile scheduler with injected faults over
    the card. Returns, per kernel these paths launch, its launches here
    as `mesh_launches`."""
    import tempfile

    import numpy as np

    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.parallel.mesh import make_mesh
    from drt_tpu_torch.parallel.multihost import (TileScheduler,
                                                  make_tile_renderer)
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
    from drt_tpu_torch.renderer import render_image
    from drt_tpu_torch.scene import Params

    t_phase = time.time()
    mesh_launches: dict = {}
    seeds = seeds_from_generator(torch.Generator().manual_seed(0))

    def counted(label, fn, expected):
        """fn() with the launch counts set to 0 just before and read just
        after; they must be `expected`."""
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = mk.launch_counts()
        check(counts == only(**expected), f"{label} launched {counts}")
        for name, n in counts.items():
            if n:
                mesh_launches[name] = mesh_launches.get(name, 0) + n
        return out

    def host_ms(fn, reps=5):
        """Median of `reps` synchronized calls on the host clock, after
        two warm-ups."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def cell(label, scene, params, cam, cfg, mesh, backend, forward,
             stored, retrace, trainer_steps, one_backend=None,
             sharded_retrace=None, one_retrace=None):
        """One backend on `mesh` against one device: the forward image
        bit for bit, a stored-adjoint step's and a retrace step's image bit
        for bit and gradients within MESH_GRAD_TOL (`stored`, `retrace`:
        the launches each makes on the mesh; the retrace renderers by
        default the backend's own), and trainer_steps Adam steps on the
        mesh."""
        t0 = time.time()
        one_backend = one_backend or backend.replace("-sharded", "")
        fwd_one = make_renderer(scene, cfg, cam, differentiable=False,
                                backend=one_backend)
        fwd_mesh = make_renderer(scene, cfg, cam, mesh=mesh,
                                 differentiable=False, backend=backend)
        img_one = fwd_one(params, seeds)
        img = counted(f"{label}: forward", lambda: fwd_mesh(params, seeds),
                      forward)
        same_bits(f"{label}: {backend} forward on {mesh.size} shards = "
                  f"{one_backend}", (img,), (img_one,))
        reads_right(img, f"{label}: {backend} forward")
        target = img_one
        p_off = Params(params.albedo * 0.8, params.emission * 1.1)
        first = "step" if backend.endswith("wavefront") else "stored"
        forms = ((first, make_renderer(scene, cfg, cam, mesh=mesh,
                                          backend=backend),
                  make_renderer(scene, cfg, cam, backend=one_backend),
                  stored),
                 ("retrace", sharded_retrace, one_retrace, retrace))
        worst = 0.0
        for form, r_mesh, r_one, expected in forms:
            if r_mesh is None:
                continue
            loss1, g1, i1 = mesh_step(r_one, p_off, seeds, target)
            loss, g, i = counted(f"{label}: {form} step",
                                 lambda: mesh_step(r_mesh, p_off, seeds,
                                                   target), expected)
            same_bits(f"{label}: {form} step image on the mesh = one "
                      "device's", (i,), (i1,))
            worst = max(worst, grads_allclose(
                f"{label}: {form} step on the mesh vs one device", g, g1))
            if form == first:
                ms_mesh = host_ms(lambda: mesh_step(r_mesh, p_off, seeds,
                                                    target))
                ms_one = host_ms(lambda: mesh_step(r_one, p_off, seeds,
                                                   target))
                print(f"[time] {label}: {form} step {backend} on "
                      f"{mesh.size} shards of one card {ms_mesh!r} ms "
                      f"against {one_backend} {ms_one!r} ms (overhead "
                      f"{ms_mesh / ms_one - 1.0:+.1%}; host clock, median "
                      f"of 5) on {smi_line}", flush=True)
        if trainer_steps:
            start = params.albedo.clone()
            start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
            per_step = {k: 2 * trainer_steps * v for k, v in stored.items()}
            fitted, metrics = counted(
                f"{label}: trainer", lambda: optim.inverse_render(
                    scene, cfg, cam, target, Params(start, params.emission),
                    torch.Generator().manual_seed(5), steps=trainer_steps,
                    mesh=mesh, backend=backend), per_step)
            check(bool(torch.isfinite(metrics["loss"]).all())
                  and not torch.equal(fitted.albedo, start),
                  f"{label}: the trainer on the mesh took no finite step")
            print(f"[train] {label}: {trainer_steps} Adam steps on the mesh,"
                  f" loss={metrics['loss'].tolist()}", flush=True)
        print(f"[mesh] {label}: {time.time() - t0:.1f}s", flush=True)
        return worst

    # 20.1: the Cornell box at the main shape through "auto" on a mesh of
    # two shards of the card.
    mesh2 = make_mesh(devices=[dev, dev])
    scene, params, cam = cbox.build(device=dev)
    cfg_m = RenderConfig(**MAIN)
    check(resolve_backend(scene, cfg_m, "auto", mesh2) == "cuda-sharded",
          "'auto' on a mesh must take 'cuda-sharded'")
    cell("cbox 640x480x256 (16 chunks)", scene, params, cam, cfg_m, mesh2,
         "cuda-sharded", dict(fused_tracer=2),
         dict(fused_collect=2, fused_sweep=2),
         dict(fused_tracer=2, fused_adjoint=2), 3,
         sharded_retrace=fused.make_sharded_fused_image_renderer(
             scene, cam, cfg_m, mesh2, adjoint="retrace"),
         one_retrace=fused.make_fused_image_renderer(scene, cam, cfg_m,
                                                     adjoint="retrace"))
    # 20.2: the 1287-shape mesh over 4 shards.
    mesh4 = make_mesh(devices=[dev] * 4)
    m_scene, m_params, m_cam = gallery.build_mesh(3, device=dev)
    cfg_d = RenderConfig(**MESH_MAIN)
    check(resolve_backend(m_scene, cfg_d, "auto", mesh4)
          == "cuda-dyn-sharded", "'auto' must take 'cuda-dyn-sharded'")
    cell("mesh 640x480x64 (4 chunks)", m_scene, m_params, m_cam, cfg_d,
         mesh4, "cuda-dyn-sharded", dict(dyn_tracer=4),
         dict(dyn_collect=4, dyn_sweep=4), dict(dyn_tracer=4,
                                                 dyn_adjoint=4), 2,
         sharded_retrace=fused.make_sharded_dyn_image_renderer(
             m_scene, m_cam, cfg_d, mesh4, adjoint="retrace"),
         one_retrace=fused.make_dyn_image_renderer(m_scene, m_cam, cfg_d,
                                                   adjoint="retrace"))
    # 20.3: per-vertex splitting, 2 samples a vertex, 4 chunks of
    # 19,660,800 lanes over 2 shards.
    cfg_s = RenderConfig(width=640, height=480, spp=16, max_depth=5,
                         spp_chunks=4, bsdf_samples=2)
    check(resolve_backend(scene, cfg_s, "auto", mesh2)
          == "cuda-split-sharded", "'auto' must take 'cuda-split-sharded'")
    cell("cbox split 640x480x16 (4 chunks)", scene, params, cam, cfg_s,
         mesh2, "cuda-split-sharded", dict(fused_tracer=8),
         dict(fused_collect=8, fused_sweep=8),
         dict(fused_tracer=8, fused_adjoint=8), 2,
         sharded_retrace=fused.make_sharded_split_image_renderer(
             scene, cam, cfg_s, mesh2, adjoint="retrace"),
         one_retrace=fused.make_split_fused_image_renderer(
             scene, cam, cfg_s, adjoint="retrace"))
    # 20.4: both regeneration backends, each shard a range of pixels.
    cell("cbox regen 640x480x256 (16 chunks)", scene, params, cam, cfg_m,
         mesh2, "cuda-regen-sharded", dict(regen_tracer=2),
         dict(regen_collect=2, regen_sweep=2),
         dict(regen_tracer=2, regen_collect=32, regen_sweep=32), 2,
         sharded_retrace=fused.make_sharded_regen_image_renderer(
             scene, cam, cfg_m, mesh2, adjoint="retrace"),
         one_retrace=fused.make_regen_image_renderer(scene, cam, cfg_m,
                                                     adjoint="retrace"))
    cell("mesh regen 640x480x64 (4 chunks)", m_scene, m_params, m_cam,
         cfg_d, mesh4, "cuda-dyn-regen-sharded", dict(dyn_regen_tracer=4),
         dict(dyn_regen_collect=4, dyn_regen_sweep=4),
         dict(dyn_regen_tracer=4, dyn_regen_collect=16, dyn_regen_sweep=16),
         2, sharded_retrace=fused.make_sharded_dyn_regen_image_renderer(
             m_scene, m_cam, cfg_d, mesh4, adjoint="retrace"),
         one_retrace=fused.make_dyn_regen_image_renderer(
             m_scene, m_cam, cfg_d, adjoint="retrace"))
    # 20.5: the wavefront on a mesh, 16 chunks of 1,228,800 rays.
    cfg_w = RenderConfig(width=640, height=480, spp=64, max_depth=5,
                         spp_chunks=16)
    cell("cbox wavefront 640x480x64 (16 chunks)", scene, params, cam, cfg_w,
         mesh2, "cuda-wavefront", dict(ray_tracer=32),
         dict(ray_tracer=32, ray_adjoint=32), {}, 1)
    del m_scene, m_params, m_cam
    torch.cuda.empty_cache()

    # 20.6: two processes sharing the card over gloo: a mesh of one shard
    # each, at the main shape.
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--mesh-worker",
             str(rank), "2", init, tmp], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for rank in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
            print(out.decode().rstrip(), flush=True)
            check(p.returncode == 0, f"mesh worker {rank} exited "
                  f"{p.returncode}: {err.decode()[-2000:]}")
        r0, r1 = (dict(np.load(Path(tmp) / f"rank{r}.npz"))
                  for r in range(2))
    check(int(r0["heartbeat"]) == int(r1["heartbeat"]) == 2,
          f"heartbeat gave {r0['heartbeat']}, {r1['heartbeat']}")
    for key in ("img", "d_albedo", "d_emission", "adam_albedo",
                "adam_emission"):
        check(np.array_equal(r0[key], r1[key]),
              f"two processes: the ranks' {key} differ")
    check(np.array_equal(r0["img"], r0["img_one"]),
          "two processes: the image is not the one process's")
    grads_allclose("two processes vs one", tuple(
        torch.from_numpy(r0[k]) for k in ("d_albedo", "d_emission")),
        tuple(torch.from_numpy(r0[k + "_one"])
              for k in ("d_albedo", "d_emission")))
    print(f"[mesh] two processes over gloo on one card: heartbeat 2, "
          f"images bit-equal, Adam steps identical across the ranks, "
          f"launches rank 0 {str(r0['counts'])}, {time.time() - t0:.1f}s",
          flush=True)

    # 20.7: the tile scheduler with injected faults over the card.
    t0 = time.time()
    cfg_t = RenderConfig(width=640, height=480, spp=4, max_depth=5)
    sched = TileScheduler(640, 480, tile=128, fault_rate=0.25, fault_seed=0)
    tiles = make_tile_renderer(scene, cam, cfg_t, params)
    img = sched.run(tiles, seed=3)
    clean = TileScheduler(640, 480, tile=128).run(tiles, seed=3)
    check(sched.retries > 0, "no injected fault fired")
    check(np.array_equal(img, clean),
          "the tiles after faults differ from the fault-free run")
    mono = render_image(params, scene, cam, seeds_from_generator(
        torch.Generator().manual_seed(3)), cfg_t).cpu().numpy()
    print(f"[mesh] TileScheduler(fault_rate=0.25) over the card: "
          f"{len(sched.jobs)} tiles, {sched.retries} retries, image = the "
          f"fault-free run's bit for bit, max abs against the monolithic "
          f"wavefront {float(np.abs(img - mono).max())!r}, mean "
          f"{float(img.mean())!r}, {time.time() - t0:.1f}s", flush=True)
    print(f"[phase] 20 (mesh): {time.time() - t_phase:.1f}s", flush=True)
    # A regeneration tracer's collect form counts apart and reports in its
    # tracer's entry (collect_*).
    rows: dict = {}
    for name, n in mesh_launches.items():
        if name.endswith("regen_collect"):
            rows.setdefault(name.replace("collect", "tracer"), {})[
                "collect_mesh_launches"] = n
        else:
            rows.setdefault(name, {})["mesh_launches"] = n
    return rows


def mesh_worker(rank: str, world: str, init: str, out: str) -> int:
    """One rank of phase 20's two-process leg: a process group over gloo
    on the shared card, heartbeat, a mesh of one shard per rank on the
    card at the main shape: the image and a stored step's gradients, and
    3 Adam steps; rank 0 also renders on one process for the
    reference."""
    import numpy as np

    from drt_tpu_torch import optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.parallel.mesh import make_mesh
    from drt_tpu_torch.parallel.multihost import heartbeat, initialize
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    rank, world = int(rank), int(world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize(init_method=init, num_processes=world, process_id=rank,
               backend="gloo")
    res = dict(heartbeat=heartbeat(device=dev))
    mesh = make_mesh()
    assert mesh.size == world and mesh.local_shards() == [rank]
    scene, params, cam = cbox.build(device=dev)
    cfg = RenderConfig(**MAIN)
    seeds = seeds_from_generator(torch.Generator().manual_seed(0))
    target = make_renderer(scene, cfg, cam, mesh=mesh,
                           differentiable=False)(params, seeds)
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    render = make_renderer(scene, cfg, cam, mesh=mesh)
    mk.reset_launch_counts()
    _, grads, res["img"] = mesh_step(render, p_off, seeds, target)
    torch.cuda.synchronize()
    res["counts"] = json.dumps({k: v for k, v in mk.launch_counts().items()
                                if v})
    ts = []
    for _ in range(4):  # the first is a warm-up
        t0 = time.perf_counter()
        mesh_step(render, p_off, seeds, target)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] two processes over gloo on one card, rank {rank}: "
          f"stored step at the main shape {statistics.median(ts[1:])!r} ms "
          f"(host clock, median of 3: {ts[1:]!r})", flush=True)
    res["d_albedo"], res["d_emission"] = grads
    if rank == 0:
        _, grads, res["img_one"] = mesh_step(
            make_renderer(scene, cfg, cam), p_off, seeds, target)
        res["d_albedo_one"], res["d_emission_one"] = grads
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    fitted, _ = optim.inverse_render(
        scene, cfg, cam, target, Params(start, params.emission),
        torch.Generator().manual_seed(5), steps=3, mesh=mesh)
    res["adam_albedo"], res["adam_emission"] = fitted
    np.savez(Path(out) / f"rank{rank}.npz",
             **{k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in res.items()})
    print(f"[mesh] worker {rank}/{world}: heartbeat {res['heartbeat']}, "
          f"launches {res['counts']}", flush=True)
    return 0


# Phase 21: paths past the 32 rows a thread keeps and tables past the 144
# rows a block's shared memory accumulates (the adjoint kernels' deep
# forms, csrc/grad_accum.cuh). absorb_prob 0.1 keeps paths alive past
# bounce 32 (at the default 0.5 a path reaches bounce 33 with probability
# 2e-10); each check counts the live bounce-slots past 32.
DEEP_DEPTHS = (33, 40, 64)
DEEP_ABSORB = 0.1
# The lifted kernels of the full-width runs, with the row of each.
DEEP_KERNELS = ("fused_sweep", "fused_adjoint", "ray_adjoint",
                "segment_adjoint", "dyn_sweep", "dyn_adjoint",
                "regen_sweep", "dyn_regen_sweep")


def wide_tables(builder, n_alb: int, n_emi: int, faces):
    """Add to `builder` the box of gallery.build_mesh (red, green and white
    walls, the light) and the triangles `faces` (k, 3, 3), face k diffuse
    with albedo row 3 + k % (n_alb - 3) and every fifth face an emitter of
    row 1 + k // 5 % (n_emi - 1): a scene of n_alb + n_emi real table
    rows, of which the faces use as many as they reach (all of them with
    the 1280 faces of the icosphere)."""
    red = builder.albedo_param([0.5, 0.1, 0.1])
    green = builder.albedo_param([0.1, 0.5, 0.1])
    white = builder.albedo_param([0.5, 0.5, 0.5])
    light = builder.emission_param([2.0, 2.0, 2.0])
    mats = [builder.diffuse(builder.albedo_param(
        [0.2 + 0.6 * ((k * 37) % 11) / 10, 0.2 + 0.6 * ((k * 53) % 7) / 6,
         0.2 + 0.6 * ((k * 71) % 5) / 4])) for k in range(n_alb - 3)]
    emits = [builder.emission_param([0.02 * (1 + k % 3), 0.03, 0.02])
             for k in range(n_emi - 1)]
    for k, v in enumerate(faces):
        builder.triangle(*v, mats[k % len(mats)],
                         emits[k // 5 % len(emits)] if k % 5 == 0 else None)
    builder.plane([-1.0, 0.0, 0.0], -3.0, builder.diffuse(red))
    builder.plane([1.0, 0.0, 0.0], -3.0, builder.diffuse(green))
    for n, off in (([0.0, 0.0, -1.0], -6.5), ([0.0, 0.0, 1.0], 0.0),
                   ([0.0, 1.0, 0.0], -3.0), ([0.0, -1.0, 0.0], -3.0)):
        builder.plane(n, off, builder.diffuse(white))
    builder.sphere([0.0, 2.9, 3.8], 0.8, None, light)
    return builder


def deep_phase(dev, smi_line: str, timing: dict) -> dict:
    """Phase 21: deep paths and wide tables. Each lifted kernel (B3, B4,
    B5b, B4-seg, B8, B9, B11, B13) against its plain version or another
    form at depths 33, 40 and 64 (absorb_prob 0.1; every albedo 0.8 for
    the sweeps and the bit-equalities), per-ray and per-pixel cotangents,
    tape mode and the internal RNG in 2 chunks, the unbiased salted seed;
    retrace = sweep(collect) bit for bit; the memory-resident kernels at
    145 and 255 + 255 real table rows; then at full width: the Cornell
    box at 640x480x256 in 16 chunks, depth 64, through make_renderer
    "auto" (forward, a step in the mode "auto" picks, a step in the other
    mode, an unbiased step, 5 optim.inverse_render steps; a step of the
    compacted renderer and of "cuda-regen"); `cli invert` at the CLI's
    640x480x100, --max-depth 64 -p 0.1; "cuda-wavefront" at 640x480x64
    in 16 chunks, depth 64; the 1287-shape mesh with 255 + 255 real rows
    at 640x480x64 in 4 chunks, depth 64, through "auto" ("cuda-dyn"),
    stored and retrace, and "cuda-dyn-regen". Each lifted kernel timed
    (and its tables' digests printed) at depth 64 beside depth
    32 at one shape (the memory-resident ones also at 255 + 255 rows).
    Then B3, B8, B11 and B13 at full width on one chunk, past the items a
    deep form's grid holds, against their plain versions. Printed, not
    checked: `[witness]` lines of B4 against the plain retrace on bright
    glossy tables at depths 8-64 (ROADMAP C.4).
    Returns per lifted kernel `deep_launches` (its launches on the
    full-width paths), `deep_ms`, `deep_ms_at_32`, `deep_bound_ms` and,
    for B8, B9 and B13, `wide_ms` (255 + 255 rows, depth 64)."""
    import tempfile

    from drt_tpu_torch import cli, fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import (TRIANGLE, Params, SceneBuilder,
                                     albedo_table, emission_table)

    t_phase = time.time()
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {name: {} for name in DEEP_KERNELS}

    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    def bright(scene, params):
        """The tables with every albedo 0.8: a path keeps 0.8 / (1 - 0.1)
        of its throughput a bounce, so its rows past 32 weigh 2e-2 of its
        first in the gradients (at the scenes' own albedos of 0.5, 1e-8:
        below any tolerance)."""
        return tables(scene, Params(torch.full_like(params.albedo, 0.8),
                                    params.emission))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def nonzero(t):
        """Non-zero entries of t, counted a leading index at a time (a
        count over 40 GB of rows takes an int64 copy of them)."""
        return sum(int(torch.count_nonzero(x).item())
                   for x in (t if t.ndim == 3 else (t,)))

    def past_32(label, live):
        """Live bounce-slots past bounce 32 of rows live[..., D, N]."""
        n = nonzero(live[..., 32:, :])
        print(f"[deep] {label}: {n} live bounce-slots past bounce 32",
              flush=True)
        check(n > 0, f"{label}: no path lives past bounce 32")

    mesh_scene, _, mesh_cam = gallery.build_mesh(3, device=dev)
    tri = mesh_scene.shape_type == TRIANGLE
    mesh_faces = mesh_scene.shape_geo[tri][:, :9].reshape(-1, 3, 3).tolist()

    def wide(n_alb, n_emi, faces):
        scene, params = wide_tables(SceneBuilder(), n_alb, n_emi,
                                    faces).build(device=dev)
        return scene, params

    # Small shapes: 32x24x4 spp (3072 rays), tape mode.
    W, H, S = 32, 24, 4
    n, npix = W * H * S, W * H
    g_ray, g_pix = rand(3, n), rand(3, npix)
    cots = (("per ray", g_ray), ("per pixel", g_pix))
    seeds = torch.tensor([2026, -21], dtype=torch.int32)
    for label, build in (("cbox", cbox.build),
                         ("glossy", gallery.build_glossy)):
        scene, params, cam = build(device=dev)
        own = tables(scene, params)
        alb, emi = bright(scene, params)
        table = mk.scene_table(scene)
        cc = mk.camera_consts(cam, W, H)
        # The kernels against their plain versions where each reads the
        # other's rows (the sweeps; bright tables, so the rows past 32
        # weigh), and the retrace forms against the sweep or the queue
        # against the lockstep loop, bit for bit, bright too. Retrace
        # against the plain retrace: on the scenes' own tables, since over
        # 33-64 bright bounces the ulps of libm turn paths (0.1-0.8% of the
        # tables at 0.8). On the glossy scene the specular weight's
        # sqrt(1 - cos_h^2) loses digits as cos_h -> 1 (ROADMAP C.4): the
        # main shape's tolerance there.
        rtol = GRAD_RTOL_SMALL if label == "cbox" else GRAD_RTOL_MAIN
        for D in DEEP_DEPTHS:
            cfg = RenderConfig(width=W, height=H, spp=S, max_depth=D,
                               absorb_prob=DEEP_ABSORB)
            tag = f"{label}, depth {D}"
            cam_u, tape = rand(2, n), rand(D, 3, n)
            _, rsc, rbest = mk.make_fused_collect_tracer(
                scene, cam, cfg, rng="tape")(alb, emi, cam_u, tape)
            past_32(f"B2 rows, {tag}", rbest > 0)
            sweep = mk.make_fused_sweep_adjoint(scene, cfg)
            adj = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")
            plain = mk.make_fused_adjoint(scene, cam, cfg, rng="tape",
                                          plain=True)
            for cot, g in cots:
                d3 = sweep(alb, emi, rsc, rbest, g)
                compare_grads(f"B3 vs plain on its rows, {tag}, {cot}", d3,
                              mk.fused_sweep_plain(scene, cfg, alb, emi, rsc,
                                                   rbest, g),
                              rtol)
                same_bits(f"B4 = B3(B2), {tag}, {cot}",
                          adj(alb, emi, cam_u, tape, g), d3)
                compare_grads(f"B4 vs plain, own tables, {tag}, {cot}",
                              adj(*own, cam_u, tape, g),
                              plain(*own, cam_u, tape, g), rtol)
            # B5b on B4's own rays (divided as the kernel divides) = B4;
            # and against its plain version on the own tables.
            o, d = (torch.stack(tuple(v)) for v in mk.camera_ray_from_pix(
                cc._replace(width=torch.tensor(W, device=dev),
                            height=torch.tensor(H, device=dev)),
                torch.arange(n, device=dev) % npix, cam_u[0], cam_u[1]))
            same_bits(f"B5b = B4 on B4's rays, {tag}", mk.ray_adjoint(
                scene, table, cfg, alb, emi, o, d, tape, g_ray),
                adj(alb, emi, cam_u, tape, g_ray))
            compare_grads(f"B5b vs plain, own tables, {tag}", mk.ray_adjoint(
                scene, table, cfg, *own, o, d, tape, g_ray),
                mk.ray_adjoint_plain(scene, cfg, *own, o, d, tape, g_ray),
                rtol)
            # B4-seg: [0, 2) traced, then [2, D) (the queue's deep form) =
            # its lockstep build (the lockstep loop's deep form), and
            # against the plain version on the own tables; [0, D) from the
            # camera = B4.
            check(mk.segment_form(2, scene.num_shapes, alb.shape[0],
                                  emi.shape[0]) == "queue",
                  "segment [2, D) does not take the queue")
            u2 = tape[2:].contiguous()
            for tabs, name in (((alb, emi), "bright"), (own, "own tables")):
                _, (ray, alive) = mk.make_fused_segment_tracer(
                    scene, cam, cfg, 0, 2, rng="tape")(
                        *tabs, cam_u, tape[:2].contiguous())
                seg = [mk.make_fused_segment_adjoint(
                    scene, cam, cfg, 2, D, rng="tape", **kw)(
                        *tabs, u2, ray, alive, g_ray)
                    for kw in ({}, dict(build="lockstep"),
                               dict(plain=True))]
                same_bits(f"B4-seg [2, {D}) = its lockstep build, {name}, "
                          f"{label}", seg[0], seg[1])
                if name == "bright":
                    continue
                compare_grads(f"B4-seg [2, {D}) vs plain, {name}, {label}",
                              seg[0][:2], seg[2][:2], rtol)
                compare(f"B4-seg [2, {D}) S_start vs plain, {name}, "
                        f"{label}", seg[0][2], seg[2][2], EXACT_TOL, None)
            same_bits(f"B4-seg [0, {D}) = B4, {tag}",
                      mk.make_fused_segment_adjoint(
                          scene, cam, cfg, 0, D, rng="tape")(
                              alb, emi, cam_u, tape, g_ray),
                      adj(alb, emi, cam_u, tape, g_ray))
            # B11: the regeneration rows of the keyed draws.
            check(rg.regen_sweep_form(cfg, alb, emi) == "deep",
                  f"B11 at depth {D} does not take its deep form")
            _, rr_sc, rr_meta, trips = rg.regen_collect(
                scene, table, cc, cfg, alb, emi, seeds)
            compare_grads(f"B11 vs plain on its rows, {tag}", rg.regen_sweep(
                scene, table, cfg, alb, emi, rr_sc, rr_meta, trips, g_pix),
                rg.regen_sweep_plain(scene, cfg, alb, emi, rr_sc, rr_meta,
                                     trips, g_pix), rtol)
            del rsc, rbest, rr_sc, rr_meta
        # The internal RNG over 2 chunks, exact and fast, and the unbiased
        # salted seed.
        cfg2 = RenderConfig(width=W, height=H, spp=2 * S, spp_chunks=2,
                            max_depth=40, absorb_prob=DEEP_ABSORB)
        for fm in (False, True):
            kw2 = dict(n_chunks=2, fastmath=fm)
            _, rsc, rbest = mk.make_fused_collect_tracer(
                scene, cam, cfg2, **kw2)(alb, emi, seeds)
            past_32(f"B2 rows, {label}, internal RNG, 2 chunks, fast={fm}",
                    rbest > 0)
            for cot, g in cots:
                d3 = mk.make_fused_sweep_adjoint(scene, cfg2, n_chunks=2)(
                    alb, emi, rsc, rbest, g)
                same_bits(f"B4 = B3(B2), {label}, internal, 2 chunks, "
                          f"fast={fm}, {cot}",
                          mk.make_fused_adjoint(scene, cam, cfg2, **kw2)(
                              alb, emi, seeds, g), d3)
        cfg1 = RenderConfig(width=W, height=H, spp=S, max_depth=40,
                            absorb_prob=DEEP_ABSORB)
        salted = fused._salted(seeds, 1)
        s_u, s_t = hash_tapes(salted, npix, S, 40, device=dev)
        same_bits(f"salted B4 = tape B4 of hash_tapes(salted), {label}",
                  mk.make_fused_adjoint(scene, cam, cfg1)(alb, emi, salted,
                                                          g_pix),
                  mk.make_fused_adjoint(scene, cam, cfg1, rng="tape")(
                      alb, emi, s_u, s_t, g_pix))

    # A witness for the retrace-vs-plain checks' tables above: on bright
    # tables B4 parts from the plain retrace at depths 33-64. Printed, not
    # checked: the same comparison at depths 8-32, where every launch runs
    # the parent's in-thread instance, and the collect tracer's rows
    # against the plain collect's (the share of bounce-slots whose row
    # differs, and the first bounce at which one does), say whether the
    # tracer's paths turn (libm's ulps) or the deep form errs.
    scene, params, cam = gallery.build_glossy(device=dev)
    alb, emi = bright(scene, params)
    for D in (8, 16, 32, 33, 40, 64):
        cfg = RenderConfig(width=W, height=H, spp=S, max_depth=D,
                           absorb_prob=DEEP_ABSORB)
        cam_u, tape = rand(2, n), rand(D, 3, n)
        got = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
            alb, emi, cam_u, tape, g_ray)
        ref = mk.make_fused_adjoint(scene, cam, cfg, rng="tape",
                                    plain=True)(alb, emi, cam_u, tape, g_ray)
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, ref)]
        _, _, rbest = mk.make_fused_collect_tracer(
            scene, cam, cfg, rng="tape")(alb, emi, cam_u, tape)
        _, _, rbest_p = mk.make_fused_collect_tracer(
            scene, cam, cfg, rng="tape", plain=True)(alb, emi, cam_u, tape)
        differs = rbest != rbest_p
        at = differs.any(dim=1).nonzero()
        print(f"[witness] glossy, bright tables, depth {D}: B4 vs plain "
              f"retrace rel (d_albedo, d_emission) = {rel!r}; B2 rows vs "
              f"plain collect's: {differs.sum().item()} of "
              f"{nonzero(rbest_p)} live bounce-slots differ, first at "
              f"bounce {at[0].item() if at.numel() else None}", flush=True)

    # The memory-resident kernels: cbox at every depth, the wide tables at
    # depth 5 (the accumulator's deep form alone) and 40.
    scene, params, cam = cbox.build(device=dev)
    cases = [("cbox", scene, params, cam, DEEP_DEPTHS)]
    small_faces = mesh_faces[:320]
    for n_alb, n_emi in ((100, 45), (255, 255)):
        ws, wp = wide(n_alb, n_emi, small_faces)
        cases.append((f"{n_alb} + {n_emi} rows", ws, wp, mesh_cam, (5, 40)))
    for label, scene, params, cam, depths in cases:
        alb, emi = bright(scene, params)
        ds = dk.DynScene(scene)
        cc = mk.camera_consts(cam, W, H)
        for D in depths:
            cfg = RenderConfig(width=W, height=H, spp=S, max_depth=D,
                               absorb_prob=DEEP_ABSORB)
            tag = f"{label}, depth {D}"
            cam_u, tape = rand(2, n), rand(D, 3, n)
            _, rsc, rrow = dk.make_dyn_collect_tracer(
                ds, cam, cfg, rng="tape")(alb, emi, cam_u, tape)
            if D > 32:
                past_32(f"B7 rows, {tag}", (rrow >> 16) & 1)
            adj = dk.make_dyn_adjoint(ds, cam, cfg, rng="tape")
            for cot, g in cots:
                d8 = dk.make_dyn_sweep_adjoint(ds, cfg)(alb, emi, rsc, rrow,
                                                        g)
                compare_grads(f"B8 vs plain on its rows, {tag}, {cot}", d8,
                              dk.dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g),
                              GRAD_RTOL_SMALL)
                same_bits(f"B9 = B8(B7), {tag}, {cot}",
                          adj(alb, emi, cam_u, tape, g), d8)
            check(dr.dyn_regen_sweep_form(cfg, alb, emi) == "deep",
                  f"B13, {tag}, does not take its deep form")
            _, rr_sc, rr_row, trips = dr.dyn_regen_collect(
                ds, cc, cfg, alb, emi, seeds)
            compare_grads(f"B13 vs plain on its rows, {tag}",
                          dr.dyn_regen_sweep(cfg, alb, emi, rr_sc, rr_row,
                                             trips, g_pix),
                          dr.dyn_regen_sweep_plain(cfg, alb, emi, rr_sc,
                                                   rr_row, trips, g_pix),
                          GRAD_RTOL_SMALL)
            del rsc, rrow, rr_sc, rr_row
        cfg2 = RenderConfig(width=W, height=H, spp=2 * S, spp_chunks=2,
                            max_depth=40, absorb_prob=DEEP_ABSORB)
        for fm in (False, True):
            _, rsc, rrow = dk.make_dyn_collect_tracer(
                ds, cam, cfg2, n_chunks=2, fastmath=fm)(alb, emi, seeds)
            same_bits(f"B9 = B8(B7), {label}, internal RNG, 2 chunks, "
                      f"fast={fm}",
                      dk.make_dyn_adjoint(ds, cam, cfg2, n_chunks=2,
                                          fastmath=fm)(alb, emi, seeds,
                                                       g_pix),
                      dk.make_dyn_sweep_adjoint(ds, cfg2, n_chunks=2)(
                          alb, emi, rsc, rrow, g_pix))
            del rsc, rrow
    print(f"[deep] small shapes done in {time.time() - t_phase:.1f}s",
          flush=True)
    torch.cuda.empty_cache()

    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s, tgt):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - tgt) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad)

    def counted(label, fn, expected=None):
        """fn() with the launch counts set to 0 before and read after."""
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in mk.launch_counts().items() if v}
        print(f"[deep] {label}: {seconds!r} s, launches={counts}",
              flush=True)
        if expected is not None:
            check(counts == expected, f"{label} launched {counts}")
        for k, v in counts.items():
            if k in out:
                out[k]["deep_launches"] = out[k].get("deep_launches", 0) + v
        return res, seconds

    def bound(name, n_bytes, n_ops, note):
        t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_o = n_ops / PEAK_F32_OPS_PER_S * 1e3
        out[name]["deep_bound_ms"] = max(t_b, t_o)
        out[name]["deep_bound_by"] = "bytes" if t_b >= t_o else "operations"
        print(f"[bound] {name} at depth 64 ({note}): bytes={n_bytes} "
              f"({t_b!r} ms) operations={n_ops} ({t_o!r} ms)", flush=True)

    def timed(name, label, fn, key="deep_ms"):
        """fn's device ms as out[name][key], and the SHA-256 digests of
        its tables: at depth 32 those of the parent's instance."""
        ms, windows, res = cuda_ms(fn, **timing)
        out[name][key] = ms
        print(f"[time] {name} {label}: {ms!r} ms (windows {windows!r}) on "
              f"{smi_line}", flush=True)
        print(f"[digest] {name} {label}: {[digest(t) for t in res]}",
              flush=True)
        return res

    # The Cornell box at 640x480x256 in 16 chunks, depth 64.
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    cfg_c = RenderConfig(**{**MAIN, "max_depth": 64},
                         absorb_prob=DEEP_ABSORB)
    n_rays = cfg_c.width * cfg_c.height * cfg_c.spp
    mode = fused._resolve_adjoint(cfg_c, "auto", dev)
    other = "stored" if mode == "retrace" else "retrace"
    print(f"[deep] Cornell box 640x480x256 depth 64: residuals "
          f"{fused.stored_bytes(cfg_c)} B of a budget of "
          f"{fused.stored_budget_bytes(dev)} B; auto takes {mode!r}",
          flush=True)
    check(mode == "retrace", "auto should retrace 40 GB of rows")
    s_list = [seeds_from_generator(torch.Generator().manual_seed(k))
              for k in (0, 1)]
    render = make_renderer(scene, cfg_c, cam, differentiable=False)
    render(params, s_list[0])
    target, _ = counted("Cornell forward, depth 64",
                        lambda: render(params, s_list[1]),
                        dict(fused_tracer=1))
    reads_right(target, "Cornell, depth 64")
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    forms = {mode: make_renderer(scene, cfg_c, cam),
             other: fused.make_fused_image_renderer(scene, cam, cfg_c,
                                                    adjoint=other)}
    expect = {"retrace": dict(fused_tracer=1, fused_adjoint=1),
              "stored": dict(fused_collect=1, fused_sweep=1)}
    grads = {}
    for m, fn in forms.items():
        step(fn, p_off, s_list[0], target)
        (loss, grads[m]), _ = counted(
            f"Cornell step, depth 64, {m}{' (auto)' if m == mode else ''}",
            lambda: step(fn, p_off, s_list[0], target), expect[m])
        torch.cuda.empty_cache()
    same_bits("Cornell depth 64: stored step's grads = retrace step's",
              grads["stored"], grads["retrace"])
    # One chunk (640x480x16) against backend="torch".
    one = RenderConfig(width=640, height=480, spp=16, max_depth=64,
                       absorb_prob=DEEP_ABSORB)
    compare_grads("Cornell depth 64, one chunk: grads vs backend='torch'",
                  step(make_renderer(scene, one, cam), p_off, s_list[0],
                       target)[1],
                  step(make_renderer(scene, one, cam, backend="torch"),
                       p_off, s_list[0], target)[1], GRAD_RTOL_MAIN)
    # The other paths of the lifted kernels at this shape: unbiased (2
    # adjoint samples: B4's deep form on salted seeds), the compacted
    # renderer (B4-seg's queue over [2, 64) in its deep form) against the
    # exact retrace, and "cuda-regen" (B11's deep form, per chunk: 40 GB
    # of rows would exceed the stored budget).
    cfg_u = dataclasses.replace(cfg_c, unbiased=True, adjoint_samples=2)
    counted("Cornell step, depth 64, unbiased x 2",
            lambda: step(make_renderer(scene, cfg_u, cam), p_off, s_list[0],
                         target), dict(fused_tracer=1, fused_adjoint=2))
    compacted = fused.make_compacted_image_renderer(scene, cam, cfg_c)
    step(compacted, p_off, s_list[0], target)
    (_, g_cmp), _ = counted(
        "compacted step, depth 64, split at 2",
        lambda: step(compacted, p_off, s_list[0], target),
        dict(segment_tracer=2 * cfg_c.spp_chunks,
             segment_adjoint=2 * cfg_c.spp_chunks))
    compare_grads("compacted, depth 64: grads vs 'cuda' retrace (exact)",
                  g_cmp, step(fused.make_fused_image_renderer(
                      scene, cam, cfg_c, adjoint="retrace", fastmath=False),
                      p_off, s_list[0], target)[1], GRAD_RTOL_MAIN)
    del compacted
    regen = make_renderer(scene, cfg_c, cam, backend="cuda-regen")
    step(regen, p_off, s_list[0], target)
    counted("cuda-regen step, depth 64",
            lambda: step(regen, p_off, s_list[0], target))
    del regen
    torch.cuda.empty_cache()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    (fitted, metrics), t5 = counted(
        "Cornell depth 64: 5 optim.inverse_render steps",
        lambda: optim.inverse_render(scene, cfg_c, cam, target,
                                     Params(start, params.emission),
                                     torch.Generator().manual_seed(5),
                                     steps=5))
    check(bool(torch.isfinite(metrics["loss"]).all()),
          "the trainer's losses at depth 64 are not finite")
    print(f"[deep] trainer depth 64: {t5 / 5!r} s a step, loss "
          f"{metrics['loss'].tolist()}", flush=True)
    del forms, grads, target
    torch.cuda.empty_cache()
    # B4 and B3 at depth 64 beside depth 32, the main path's calls.
    g_main = rand(3, cfg_c.width * cfg_c.height) / cfg_c.spp
    kw_m = dict(fastmath=True, n_chunks=cfg_c.spp_chunks)
    for D, key in ((64, "deep_ms"), (32, "deep_ms_at_32")):
        cfg_d = dataclasses.replace(cfg_c, max_depth=D)
        adj = mk.make_fused_adjoint(scene, cam, cfg_d, **kw_m)
        d4 = timed("fused_adjoint", f"main shape, depth {D}",
                   lambda: adj(alb, emi, s_list[1], g_main), key)
        _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg_d,
                                                     **kw_m)(alb, emi,
                                                             s_list[1])
        sweep = mk.make_fused_sweep_adjoint(scene, cfg_d,
                                            n_chunks=cfg_c.spp_chunks)
        d3 = timed("fused_sweep", f"main shape, depth {D}",
                   lambda: sweep(alb, emi, rsc, rbest, g_main), key)
        same_bits(f"B4 = B3(B2) at the main shape, depth {D}", d4, d3)
        if D == 64:
            past_32("B2 rows, main shape, depth 64", rbest > 0)
            live = nonzero(rbest)
            need = 4 * (2 * live + sum(nonzero((c == 0).any(dim=0))
                                       for c in rbest))
            ops_hit = sum(OPS_SHAPE[t] for t in scene.shape_type.tolist())
            tb = 4 * (mk.scene_table(scene).numel() + 2 * alb.numel()
                      + 2 * emi.numel()) + 4 * g_main.numel()
            bound("fused_adjoint", tb, n_rays * OPS_CAMERA
                  + live * (ops_hit + OPS_SHADE + OPS_SWEEP),
                  f"{live} live bounce-rays")
            bound("fused_sweep", tb + need, live * OPS_SWEEP,
                  f"{need} bytes of rows up to each first dead row")
        del rsc, rbest
        torch.cuda.empty_cache()

    # B4-seg at depth 64 beside 32: one chunk of the main shape, [0, 2)
    # traced, then [2, D) over its 4,915,200 lanes (the queue).
    spp_c = cfg_c.spp // cfg_c.spp_chunks
    K = cfg_c.width * cfg_c.height * spp_c
    for D, key in ((64, "deep_ms"), (32, "deep_ms_at_32")):
        cfg_s = RenderConfig(width=640, height=480, spp=spp_c, max_depth=D,
                             absorb_prob=DEEP_ABSORB)
        _, (ray, alive) = mk.make_fused_segment_tracer(
            scene, cam, cfg_s, 0, 2)(alb, emi, s_list[1])
        idx = torch.arange(K, dtype=torch.int32, device=dev)
        g_k = rand(3, K)
        seg = mk.make_fused_segment_adjoint(scene, cam, cfg_s, 2, D)
        timed("segment_adjoint", f"[2, {D}) on one chunk of the main shape",
              lambda: seg(alb, emi, s_list[1], ray, alive, idx, g_k), key)
        if D == 64:
            # The segment's live bounces: the collect tracer's chunk 0 at
            # the same seeds from bounce 2 on.
            _, _, rbest = mk.make_fused_collect_tracer(scene, cam, cfg_s)(
                alb, emi, s_list[1])
            live = nonzero(rbest[2:])
            bound("segment_adjoint", tb + 4 * (9 * K + K + 3 * K + 3 * K),
                  live * (ops_hit + OPS_SHADE + OPS_SWEEP),
                  f"the lanes' state, g and S_start; {live} live bounces")
            del rbest
        del ray, alive
    torch.cuda.empty_cache()

    # cli invert at the CLI's default shape, --max-depth 64 -p 0.1.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "deep.json"
        rc, t_cli = counted(
            "cli invert 640x480x100 --max-depth 64 -p 0.1, 4 steps",
            lambda: cli.main(["invert", "-o", str(path), "--max-depth", "64",
                              "-p", str(DEEP_ABSORB), "--steps", "4",
                              "--log-every", "0"]))
        check(rc == 0, f"cli invert at depth 64 returned {rc}")
        res = json.loads(path.read_text())
        check(all(math.isfinite(v) for v in [res["final_loss"]]),
              "cli invert at depth 64: loss not finite")
        print(f"[deep] cli invert depth 64: {res}", flush=True)

    # "cuda-wavefront" at 640x480x64 in 16 chunks, depth 64: one step;
    # B5b at depth 64 beside 32 on one chunk.
    cfg_w = RenderConfig(width=640, height=480, spp=64, spp_chunks=16,
                         max_depth=64, absorb_prob=DEEP_ABSORB)
    wave = make_renderer(scene, cfg_w, cam, backend="cuda-wavefront")
    target = make_renderer(scene, cfg_w, cam, differentiable=False)(
        params, s_list[1])
    counted("cuda-wavefront 640x480x64 depth 64, one step",
            lambda: step(wave, p_off, s_list[0], target))
    del wave, target
    torch.cuda.empty_cache()
    table = mk.scene_table(scene)
    nw = 640 * 480 * 4
    cc = mk.camera_consts(cam, 640, 480)
    cu = rand(2, nw)
    o, d = (torch.stack(tuple(v)) for v in mk.camera_ray_from_pix(
        cc, torch.arange(nw, device=dev) % (640 * 480), cu[0], cu[1]))
    g_w = rand(3, nw)
    for D, key in ((64, "deep_ms"), (32, "deep_ms_at_32")):
        cfg_r = RenderConfig(width=640, height=480, spp=4, max_depth=D,
                             absorb_prob=DEEP_ABSORB)
        u = rand(D, 3, nw)
        timed("ray_adjoint", f"one chunk of 640x480x4 rays, depth {D}",
              lambda: mk.ray_adjoint(scene, table, cfg_r, alb, emi, o, d, u,
                                     g_w), key)
        if D == 64:
            # The same paths' live bounces: the tape-mode collect tracer
            # on the camera draws these rays were made from.
            _, _, rbest = mk.make_fused_collect_tracer(
                scene, cam, cfg_r, rng="tape")(alb, emi, cu, u)
            live = nonzero(rbest)
            bound("ray_adjoint", tb + 4 * (6 * nw + 3 * nw) + 12 * live,
                  live * (ops_hit + OPS_SHADE + OPS_SWEEP),
                  f"rays and g read once, the tape's 12 B for each of "
                  f"{live} live bounces")
            del rbest
    del u, o, d
    torch.cuda.empty_cache()

    # B11 at the CLI's shape (one chunk), depth 64 beside 32.
    seeds_r = torch.tensor([5, 6], dtype=torch.int32)
    cc = mk.camera_consts(cam, 640, 480)
    for D, key in ((64, "deep_ms"), (32, "deep_ms_at_32")):
        cfg_r = RenderConfig(**{**CLI_SHAPE, "max_depth": D},
                             absorb_prob=DEEP_ABSORB)
        _, r_sc, r_meta, trips = rg.regen_collect(scene, table, cc, cfg_r,
                                                  alb, emi, seeds_r)
        g_p = rand(3, 640 * 480)
        timed("regen_sweep", f"640x480x100, depth {D} ({rg.regen_sweep_form(cfg_r, alb, emi)})",
              lambda: rg.regen_sweep(scene, table, cfg_r, alb, emi, r_sc,
                                     r_meta, trips, g_p), key)
        if D == 64:
            n_trips = int(trips.sum().item())
            bound("regen_sweep", 8 * n_trips + 4 * (trips.numel() + 3 * 640
                                                    * 480),
                  n_trips * OPS_SWEEP, f"{n_trips} trips")
        del r_sc, r_meta
        torch.cuda.empty_cache()

    # The 1287-shape mesh with 255 + 255 real rows at 640x480x64 in 4
    # chunks, depth 64, through "auto" ("cuda-dyn"): stored and retrace.
    ws, wp = wide(255, 255, mesh_faces)
    walb, wemi = tables(ws, wp)
    cfg_m = RenderConfig(**{**MESH_MAIN, "max_depth": 64},
                         absorb_prob=DEEP_ABSORB)
    n_mesh = cfg_m.width * cfg_m.height * cfg_m.spp
    print(f"[deep] mesh of 255 + 255 rows at 640x480x64 depth 64: "
          f"residuals {fused.stored_bytes(cfg_m)} B, auto takes "
          f"{fused._resolve_adjoint(cfg_m, 'auto', dev)!r}", flush=True)
    target = make_renderer(ws, cfg_m, mesh_cam, differentiable=False)(
        wp, s_list[1])
    check(bool(torch.isfinite(target).all()), "wide mesh image not finite")
    wp_off = Params(wp.albedo * 0.8, wp.emission * 1.1)
    grads = {}
    for m, fn, expected in (
            ("stored (auto)", make_renderer(ws, cfg_m, mesh_cam),
             dict(dyn_collect=1, dyn_sweep=1)),
            ("retrace", fused.make_dyn_image_renderer(ws, mesh_cam, cfg_m,
                                                      adjoint="retrace"),
             dict(dyn_tracer=1, dyn_adjoint=1))):
        step(fn, wp_off, s_list[0], target)
        (_, grads[m]), _ = counted(f"wide mesh step, depth 64, {m}",
                                   lambda: step(fn, wp_off, s_list[0],
                                                target), expected)
    same_bits("wide mesh depth 64: stored grads = retrace grads",
              grads["stored (auto)"], grads["retrace"])
    dregen = make_renderer(ws, cfg_m, mesh_cam, backend="cuda-dyn-regen")
    step(dregen, wp_off, s_list[0], target)
    counted("wide mesh cuda-dyn-regen step, depth 64",
            lambda: step(dregen, wp_off, s_list[0], target))
    del dregen
    del target, grads
    torch.cuda.empty_cache()
    # B8, B9 and B13 at depth 64 beside 32 on the mesh's own 4 + 1 rows,
    # and at depth 64 with 255 + 255.
    ds_w = dk.DynScene(ws)
    mesh_scene, mesh_params, _ = gallery.build_mesh(3, device=dev)
    ds_m = dk.DynScene(mesh_scene)
    malb, memi = tables(mesh_scene, mesh_params)
    g_m = rand(3, 640 * 480) / cfg_m.spp
    cc_m = mk.camera_consts(mesh_cam, 640, 480)
    kw_d = dict(fastmath=True, n_chunks=cfg_m.spp_chunks)
    for ds, a, e, D, key in ((ds_m, malb, memi, 64, "deep_ms"),
                             (ds_m, malb, memi, 32, "deep_ms_at_32"),
                             (ds_w, walb, wemi, 64, "wide_ms")):
        cfg_d = dataclasses.replace(cfg_m, max_depth=D)
        tag = (f"mesh main shape, depth {D}, {a.shape[0] - 1} + "
               f"{e.shape[0] - 1} rows")
        adj = dk.make_dyn_adjoint(ds, mesh_cam, cfg_d, **kw_d)
        d9 = timed("dyn_adjoint", tag, lambda: adj(a, e, s_list[1], g_m),
                   key)
        _, rsc, rrow = dk.make_dyn_collect_tracer(ds, mesh_cam, cfg_d,
                                                  **kw_d)(a, e, s_list[1])
        sweep = dk.make_dyn_sweep_adjoint(ds, cfg_d,
                                          n_chunks=cfg_m.spp_chunks)
        d8 = timed("dyn_sweep", tag, lambda: sweep(a, e, rsc, rrow, g_m),
                   key)
        same_bits(f"B9 = B8(B7), {tag}", d9, d8)
        if key == "deep_ms":
            live_m = sum(nonzero((c >> 16) & 1) for c in rrow)
            need = 4 * (2 * live_m + sum(nonzero((((c >> 16) & 1) == 0).any(
                dim=0)) for c in rrow))
            tb = 4 * (2 * a.numel() + 2 * e.numel()) + 4 * g_m.numel()
            bound("dyn_sweep", tb + need, live_m * OPS_SWEEP,
                  f"{need} bytes of rows")
            cs = dk.dyn_cull_stats(ds, cc_m, cfg_d, a, e, s_list[1],
                                   n_chunks=cfg_m.spp_chunks)
            bound("dyn_adjoint", tb + sum(t.numel() * 4
                                          for t in ds.operands),
                  n_mesh * OPS_CAMERA + cs["lane_leaves"] * ds.cluster_k
                  * OPS_SHAPE[2] + live_m * (OPS_SHADE + OPS_SWEEP),
                  f"{live_m} live bounce-rays, {cs['lane_leaves']} leaf "
                  "tests (box tests not counted)")
        del rsc, rrow
        torch.cuda.empty_cache()
        _, r_sc, r_row, trips = dr.dyn_regen_collect(
            ds, cc_m, cfg_d, a, e, s_list[1], n_chunks=cfg_m.spp_chunks)
        timed("dyn_regen_sweep",
              f"{tag} ({dr.dyn_regen_sweep_form(cfg_d, a, e)})",
              lambda: dr.dyn_regen_sweep(cfg_d, a, e, r_sc, r_row, trips,
                                         g_m * cfg_m.spp,
                                         n_chunks=cfg_m.spp_chunks), key)
        if key == "deep_ms":
            n_trips = int(trips.sum().item())
            bound("dyn_regen_sweep", 8 * n_trips + 4 * (trips.numel()
                                                        + 3 * 640 * 480),
                  n_trips * OPS_SWEEP, f"{n_trips} trips")
        del r_sc, r_row
        torch.cuda.empty_cache()
    # The deep forms at full width against their plain versions on the
    # same inputs, one chunk each, on bright tables (so that the rows past
    # 32 weigh): a block of a deep form walks more than one 128-item group
    # only past deep_blocks x 128 items, and only these shapes pass it.
    props = torch.cuda.get_device_properties(dev)
    walk = props.multi_processor_count * (
        props.max_threads_per_multi_processor // mk.BLOCK) * mk.BLOCK
    print(f"[deep] a deep form's grid holds {walk} items; past them its "
          "blocks walk groups", flush=True)
    scene, params, cam = cbox.build(device=dev)
    table = mk.scene_table(scene)
    alb, emi = bright(scene, params)
    one = RenderConfig(width=640, height=480, spp=16, max_depth=64,
                       absorb_prob=DEEP_ABSORB)
    check(one.width * one.height * one.spp > walk, "B3's chunk is too small")
    g_1 = rand(3, 640 * 480) / one.spp
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, one,
                                                 fastmath=True)(
                                                     alb, emi, s_list[1])
    past_32("B2 rows, 640x480x16, depth 64, bright", rbest > 0)
    compare_grads("B3 deep form vs plain on its rows, 640x480x16, depth 64, "
                  "bright", mk.make_fused_sweep_adjoint(scene, one)(
                      alb, emi, rsc, rbest, g_1),
                  mk.fused_sweep_plain(scene, one, alb, emi, rsc, rbest, g_1),
                  GRAD_RTOL_MAIN)
    del rsc, rbest
    torch.cuda.empty_cache()
    cfg_r = RenderConfig(**{**CLI_SHAPE, "max_depth": 64},
                         absorb_prob=DEEP_ABSORB)
    check(cfg_r.width * cfg_r.height > walk, "B11's pixels are too few")
    _, r_sc, r_meta, trips = rg.regen_collect(
        scene, table, mk.camera_consts(cam, 640, 480), cfg_r, alb, emi,
        seeds_r)
    g_p = rand(3, 640 * 480)
    compare_grads("B11 deep form vs plain on its rows, 640x480x100, depth "
                  "64, bright", rg.regen_sweep(scene, table, cfg_r, alb, emi,
                                               r_sc, r_meta, trips, g_p),
                  rg.regen_sweep_plain(scene, cfg_r, alb, emi, r_sc, r_meta,
                                       trips, g_p), GRAD_RTOL_MAIN)
    del r_sc, r_meta, trips
    torch.cuda.empty_cache()
    one_m = dataclasses.replace(one, spp=cfg_m.spp // cfg_m.spp_chunks)
    g_1m = rand(3, 640 * 480) / one_m.spp
    for label, (s_m, p_m) in (("4 + 1 rows", (mesh_scene, mesh_params)),
                              ("255 + 255 rows", (ws, wp))):
        a, e = bright(s_m, p_m)
        ds = dk.DynScene(s_m)
        tag = f"mesh 640x480x{one_m.spp}, depth 64, {label}, bright"
        _, rsc, rrow = dk.make_dyn_collect_tracer(ds, mesh_cam, one_m,
                                                  fastmath=True)(
                                                      a, e, s_list[1])
        past_32(f"B7 rows, {tag}", (rrow >> 16) & 1)
        compare_grads(f"B8 deep form vs plain on its rows, {tag}",
                      dk.make_dyn_sweep_adjoint(ds, one_m)(a, e, rsc, rrow,
                                                           g_1m),
                      dk.dyn_sweep_plain(one_m, a, e, rsc, rrow, g_1m),
                      GRAD_RTOL_MAIN)
        del rsc, rrow
        torch.cuda.empty_cache()
        _, r_sc, r_row, trips = dr.dyn_regen_collect(ds, cc_m, one_m, a, e,
                                                     s_list[1])
        g_pm = g_1m * one_m.spp
        compare_grads(f"B13 deep form vs plain on its rows, {tag}",
                      dr.dyn_regen_sweep(one_m, a, e, r_sc, r_row, trips,
                                         g_pm),
                      dr.dyn_regen_sweep_plain(one_m, a, e, r_sc, r_row,
                                               trips, g_pm), GRAD_RTOL_MAIN)
        del r_sc, r_row, trips
        torch.cuda.empty_cache()
    print(f"[deep] phase 21 in {time.time() - t_phase:.1f}s; {out}",
          flush=True)
    for name in DEEP_KERNELS:
        check({"deep_ms", "deep_ms_at_32", "deep_bound_ms"} <= set(out[name]),
              f"{name}: phase 21 measured {sorted(out[name])}")
    return out


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import drt_tpu_torch
    check(Path(drt_tpu_torch.__file__).resolve().parent.parent == HERE,
          "drt_tpu_torch must be the package beside this script")
    from drt_tpu_torch import fused, optim
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.models import cbox, gallery
    # Importing them joins the regeneration wrappers to the launch counts.
    import drt_tpu_torch.ops.dynregen  # noqa: F401
    import drt_tpu_torch.ops.earlyexit  # noqa: F401
    import drt_tpu_torch.ops.regen  # noqa: F401
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table
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

    # Phase 2: build the kernels.
    t0 = time.time()
    built = native.build_all()
    print(f"[build] {sorted(built)} -> "
          f"{next(iter(built.values())).parent.relative_to(HERE)} in "
          f"{time.time() - t0:.1f}s", flush=True)
    for source in sorted(built):
        for line in native.log_path(source).read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[ptxas] {source}: {line.strip()}", flush=True)

    if ONLY:
        phase = {"dyn": dyn_phases, "regen": regen_phases,
                 "wavefront": wavefront_phase, "compact": compact_phase,
                 "fused": fused_phase, "sweep": sweep_phase,
                 "split": split_phase, "invert": invert_phase,
                 "mesh": mesh_phase, "deep": deep_phase}[ONLY]
        phase(dev, smi_line, dict(reps=10, warmup=10, windows=3))
        print(f"[partial] --only={ONLY}, {time.time() - t_start:.1f}s; "
              f"failed checks: {FAILED}", flush=True)
        return 1

    # Phase 3: the tracer against its twin.
    def tables(scene, params):
        return albedo_table(scene, params), emission_table(scene, params)

    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(1)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    g_small = torch.rand((3, n), generator=g, device=dev)
    small = (("cbox", cbox.build), ("glossy", gallery.build_glossy),
             ("tri", gallery.build_tri))
    for label, build in small:
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

        # Phase 4, small shapes: the collect tracer and the adjoints.
        for fm, L_b1 in ((False, got), (True, fast)):
            kw = dict(rng="tape", fastmath=fm)
            L, rsc, rbest = mk.make_fused_collect_tracer(
                scene, cam, cfg, **kw)(alb, emi, cam_u, tape)
            same_bits(f"collect radiance = tracer's, {label}, fast={fm}",
                      (L,), (L_b1,))
            sweep = mk.make_fused_sweep_adjoint(scene, cfg)
            d_sweep = sweep(alb, emi, rsc, rbest, g_small)
            d_adj = mk.make_fused_adjoint(scene, cam, cfg, **kw)(
                alb, emi, cam_u, tape, g_small)
            same_bits(f"retrace adjoint = sweep(collect), {label}, "
                      f"fast={fm}", d_adj, d_sweep)
            if fm:
                continue
            _, rsc_r, rbest_r = mk.make_fused_collect_tracer(
                scene, cam, cfg, rng="tape", plain=True)(alb, emi, cam_u,
                                                         tape)
            compare_residuals(f"collect exact vs twin, {label}",
                              (rsc, rbest), (rsc_r, rbest_r), EXACT_TOL, 0.0,
                              RSC_SHARE_SMALL)
            compare_grads(f"sweep vs twin on the kernel's residuals, "
                          f"{label}", d_sweep, mk.fused_sweep_plain(
                              scene, cfg, alb, emi, rsc, rbest, g_small),
                          GRAD_RTOL_SMALL)
            compare_grads(f"retrace adjoint exact vs twin, {label}", d_adj,
                          mk.make_fused_adjoint(
                              scene, cam, cfg, rng="tape", plain=True)(
                              alb, emi, cam_u, tape, g_small),
                          GRAD_RTOL_SMALL)
            same_bits(f"sweep twice, {label}",
                      sweep(alb, emi, rsc, rbest, g_small), d_sweep)

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
    cfg_1 = RenderConfig(width=32, height=24, spp=4, max_depth=5)
    one = mk.make_fused_tracer(scene, cam, cfg_1, rng="tape")(
        alb, emi, c_u, c_t)
    first = mk.make_fused_tracer(scene, cam, cfg_i, n_chunks=1)(
        alb, emi, seeds)  # chunk 0 only
    compare("internal rng = tape of hash_tapes, chunks 0+1", first + one,
            got, EXACT_TOL)
    # Unbiased mode: the retrace adjoint with the salted bounce seed of
    # adjoint sample 1 is the tape adjoint fed hash_tapes of that seed
    # (bit for bit), and agrees with the twin fed the same.
    salted = fused._salted(seeds, 1)
    g_pix = torch.rand((3, 32 * 24), generator=g, device=dev)
    d_salt = mk.make_fused_adjoint(scene, cam, cfg_1)(alb, emi, salted,
                                                      g_pix)
    s_u, s_t = hash_tapes(salted, 32 * 24, 4, 5, device=dev)
    check(torch.equal(s_u, hash_tapes(seeds, 32 * 24, 4, 5, device=dev)[0]),
          "the salt must leave the camera stream alone")
    same_bits("salted internal adjoint = tape adjoint of hash_tapes(salted)",
              mk.make_fused_adjoint(scene, cam, cfg_1, rng="tape")(
                  alb, emi, s_u, s_t, g_pix), d_salt)
    compare_grads("salted retrace adjoint vs twin on hash_tapes(salted)",
                  d_salt, mk.fused_adjoint_plain(
                      scene, mk.camera_consts(cam, 32, 24), cfg_1, alb, emi,
                      g_pix, cam_u=s_u, tape=s_t), GRAD_RTOL_SMALL)

    # The main path's own calls: fast variant, internal RNG, 16 chunks.
    cfg_m = RenderConfig(**MAIN)
    n_rays = cfg_m.width * cfg_m.height * cfg_m.spp
    npix = cfg_m.width * cfg_m.height
    n_slots = n_rays // cfg_m.spp_chunks
    scene, params, cam = cbox.build(device=dev)
    alb, emi = tables(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    kw_m = dict(fastmath=True, n_chunks=cfg_m.spp_chunks)
    main_trace = mk.make_fused_tracer(scene, cam, cfg_m, **kw_m)
    timing = dict(reps=10, warmup=20, windows=3)
    twin_timing = dict(reps=1, windows=3)
    ms, windows, plain_ms, plain_windows, err = {}, {}, {}, {}, {}
    ms["fused_tracer"], windows["fused_tracer"], got = cuda_ms(
        lambda: main_trace(alb, emi, seeds), **timing)
    cc = mk.camera_consts(cam, cfg_m.width, cfg_m.height)
    plain_ms["fused_tracer"], plain_windows["fused_tracer"], ref = cuda_ms(
        lambda: mk.fused_trace_plain(scene, cc, cfg_m, alb, emi, seeds=seeds,
                                     n_chunks=cfg_m.spp_chunks),
        **twin_timing)
    err["fused_tracer"] = compare(
        "main-path call (fast, internal, 640x480x256, 16 chunks) vs twin",
        got, ref, FAST_TOL)
    exact = mk.make_fused_tracer(scene, cam, cfg_m, n_chunks=cfg_m.spp_chunks)
    compare("exact variant at the main-path shape vs twin",
            exact(alb, emi, seeds), ref, EXACT_TOL)
    del ref, exact

    # Phase 4, main shape.
    main_collect = mk.make_fused_collect_tracer(scene, cam, cfg_m, **kw_m)
    ms["fused_collect"], windows["fused_collect"], (L, rsc, rbest) = cuda_ms(
        lambda: main_collect(alb, emi, seeds), **timing)
    same_bits("collect radiance = tracer's at the main-path shape", (L,),
              (got,))
    del got, L
    live = int((rbest > 0).sum().item())  # live bounce-rays of this run
    plain_ms["fused_collect"], plain_windows["fused_collect"], \
        (_, rsc_r, rbest_r) = cuda_ms(
            lambda: mk.fused_collect_plain(
                scene, cc, cfg_m, alb, emi, seeds=seeds,
                n_chunks=cfg_m.spp_chunks), **twin_timing)
    err["fused_collect"] = compare_residuals(
        "collect (fast) vs twin at the main-path shape", (rsc, rbest),
        (rsc_r, rbest_r), FAST_TOL, MAX_SHARE_BEYOND, MAX_SHARE_BEYOND)
    del rsc_r, rbest_r
    g_main = torch.rand((3, npix), generator=g, device=dev) / cfg_m.spp
    main_sweep = mk.make_fused_sweep_adjoint(scene, cfg_m,
                                             n_chunks=cfg_m.spp_chunks)
    ms["fused_sweep"], windows["fused_sweep"], d_sweep = cuda_ms(
        lambda: main_sweep(alb, emi, rsc, rbest, g_main), **timing)
    plain_ms["fused_sweep"], plain_windows["fused_sweep"], d_ref = cuda_ms(
        lambda: mk.fused_sweep_plain(scene, cfg_m, alb, emi, rsc, rbest,
                                     g_main), **twin_timing)
    err["fused_sweep"] = compare_grads(
        "sweep vs twin on the kernel's residuals at the main-path shape",
        d_sweep, d_ref, GRAD_RTOL_MAIN)
    same_bits("sweep twice at the main-path shape",
              main_sweep(alb, emi, rsc, rbest, g_main), d_sweep)
    print(f"[digest] B3 tables, main shape, fast: "
          f"{[digest(t) for t in d_sweep]}", flush=True)
    # The rows the sweep needs: each path's words up to its first dead row
    # and its rsc before it (csrc/sweep_rows.cuh).
    sweep_bytes = 4 * (2 * live + int((rbest == 0).any(dim=1).sum().item()))
    print(f"[rate] fused_sweep at the main-path shape: "
          f"{rsc.numel() * 8 / ms['fused_sweep'] / 1e6!r} GB/s of every row, "
          f"{sweep_bytes / ms['fused_sweep'] / 1e6!r} GB/s of the "
          f"{sweep_bytes} bytes it needs", flush=True)
    del rsc, rbest
    main_adj = mk.make_fused_adjoint(scene, cam, cfg_m, **kw_m)
    ms["fused_adjoint"], windows["fused_adjoint"], d_adj = cuda_ms(
        lambda: main_adj(alb, emi, seeds, g_main), **timing)
    same_bits("retrace adjoint = sweep(collect) at the main-path shape",
              d_adj, d_sweep)
    plain_ms["fused_adjoint"], plain_windows["fused_adjoint"], d_ref = \
        cuda_ms(lambda: mk.fused_adjoint_plain(
            scene, cc, cfg_m, alb, emi, g_main, seeds=seeds,
            n_chunks=cfg_m.spp_chunks), **twin_timing)
    err["fused_adjoint"] = compare_grads(
        "retrace adjoint (fast) vs twin at the main-path shape", d_adj,
        d_ref, GRAD_RTOL_MAIN)
    for name in ms:
        print(f"[time] {name} at the main-path shape: kernel {ms[name]!r} "
              f"ms ({n_rays / ms[name] / 1e3!r} Mrays/s), plain twin "
              f"{plain_ms[name]!r} ms on {smi_line}; window means: kernel "
              f"{windows[name]!r}, twin {plain_windows[name]!r}",
              flush=True)

    # The least time the card could take: bytes in and out once over the
    # memory rate, or this run's operations over the float32 rate.
    ops_hit = sum(OPS_SHAPE[t] for t in scene.shape_type.tolist())
    ops_trace = n_rays * OPS_CAMERA + live * (ops_hit + OPS_SHADE)
    table_bytes = 4 * (mk.scene_table(scene).numel() + alb.numel()
                       + emi.numel())
    res_bytes = 8 * n_rays * cfg_m.max_depth
    grad_bytes = 4 * (alb.numel() + emi.numel())
    work = {
        "fused_tracer": (table_bytes + 12 * n_slots, ops_trace),
        "fused_collect": (table_bytes + 12 * n_slots + res_bytes, ops_trace),
        "fused_sweep": (table_bytes + sweep_bytes + 4 * g_main.numel()
                        + grad_bytes, live * OPS_SWEEP),
        "fused_adjoint": (table_bytes + 4 * g_main.numel() + grad_bytes,
                          ops_trace + live * OPS_SWEEP),
    }
    bound = {}
    for name, (n_bytes, n_ops) in work.items():
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
        bound[name] = (max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"[bound] {name}: bytes={n_bytes} ({t_bytes!r} ms at "
              f"{PEAK_BYTES_PER_S:.3g} B/s) operations={n_ops} ({t_ops!r} "
              f"ms at {PEAK_F32_OPS_PER_S:.3g} op/s) live bounce-rays="
              f"{live} of {n_rays * cfg_m.max_depth}", flush=True)

    # Phase 5: the forward main path through the user's entry point.
    render = make_renderer(scene, cfg_m, cam, differentiable=False)
    twin = make_renderer(scene, cfg_m, cam, differentiable=False,
                         backend="torch")
    seed_list = [seeds_from_generator(torch.Generator().manual_seed(s))
                 for s in (0, 1, 2, 3)]
    launches = {}
    mk.reset_launch_counts()
    images = []
    t_imgs = []
    for s in seed_list:  # the first is the warm-up
        t0 = time.perf_counter()
        images.append(render(params, s))
        torch.cuda.synchronize()
        t_imgs.append(time.perf_counter() - t0)
    counts = mk.launch_counts()
    launches["fused_tracer"] = counts["fused_tracer"]
    print(f"[main] make_renderer(cuda, differentiable=False) 640x480x256spp "
          f"depth 5: launches={counts} seconds={t_imgs[1:]!r} Mrays/s="
          f"{[n_rays / t / 1e6 for t in t_imgs[1:]]!r}", flush=True)
    check(counts == only(fused_tracer=len(seed_list)),
          f"the forward path launched {counts}")
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
    target = images[1]
    del images

    # Phase 6: the differentiable main path, forward + backward.
    def leaves_of(p):
        return Params(*(t.detach().clone().requires_grad_() for t in p))

    def step(render_fn, p, s):
        p = leaves_of(p)
        img = render_fn(p, s)
        check(img.grad_fn is not None, "the image carries no grad_fn")
        loss = ((img - target) ** 2).mean()
        loss.backward()
        return loss.detach(), (p.albedo.grad, p.emission.grad)

    # Off the true parameters, so that the image loss has a gradient
    # beyond the Monte-Carlo noise.
    p_off = Params(params.albedo * 0.8, params.emission * 1.1)
    cfg_u = RenderConfig(**MAIN, unbiased=True, adjoint_samples=2)
    forms = (
        ("stored (default)", make_renderer(scene, cfg_m, cam),
         make_renderer(scene, cfg_m, cam, backend="torch"),
         only(fused_collect=1, fused_sweep=1)),
        ("retrace", fused.make_fused_image_renderer(
            scene, cam, cfg_m, adjoint="retrace"),
         fused.make_fused_image_renderer(scene, cam, cfg_m,
                                         adjoint="retrace", plain=True),
         only(fused_tracer=1, fused_adjoint=1)),
        ("unbiased, 2 adjoint samples", make_renderer(scene, cfg_u, cam),
         make_renderer(scene, cfg_u, cam, backend="torch"),
         only(fused_tracer=1, fused_adjoint=2)),
    )
    check(fused._resolve_adjoint(cfg_m, "auto", dev) == "stored",
          "adjoint='auto' must resolve to 'stored' at the main shape")
    print(f"[main] residuals {fused.stored_bytes(cfg_m)} B of a budget of "
          f"{fused.stored_budget_bytes(dev)} B", flush=True)
    n_steps = 5
    for label, render_fn, twin_fn, expected in forms:
        counts, (loss, grads) = time_steps(
            label, lambda: step(render_fn, p_off, seed_list[1]), mk,
            expected, n_rays, n_steps)
        if label.startswith("retrace"):
            launches["fused_adjoint"] = counts["fused_adjoint"]
        t0 = time.perf_counter()
        loss_t, grads_t = step(twin_fn, p_off, seed_list[1])
        torch.cuda.synchronize()
        print(f"[grad] {label}: twin loss={loss_t.item()!r} seconds="
              f"{time.perf_counter() - t0!r}", flush=True)
        compare_grads(f"{label}: make_renderer grads vs backend='torch'",
                      grads, grads_t, GRAD_RTOL_MAIN)

    # Phase 7: the trainer.
    true_red = params.albedo[cbox.RED].clone()
    start = params.albedo.clone()
    start[cbox.RED] = torch.tensor([0.2, 0.15, 0.1], device=dev)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    fitted, metrics = optim.inverse_render(
        scene, cfg_m, cam, target, Params(start, params.emission),
        torch.Generator().manual_seed(5), steps=n_steps)
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) / n_steps
    counts = mk.launch_counts()
    launches["fused_collect"] = counts["fused_collect"]
    launches["fused_sweep"] = counts["fused_sweep"]
    before = (start[cbox.RED] - true_red).norm().item()
    after = (fitted.albedo[cbox.RED] - true_red).norm().item()
    print(f"[train] inverse_render {n_steps} steps: launches={counts} "
          f"seconds per step={t_train!r} loss={metrics['loss'].tolist()} "
          f"grad_norm={metrics['grad_norm'].tolist()} red row "
          f"{start[cbox.RED].tolist()} -> {fitted.albedo[cbox.RED].tolist()}"
          f" (true {true_red.tolist()}): distance {before!r} -> {after!r}",
          flush=True)
    # The paired loss renders twice per step.
    check(counts == only(fused_collect=2 * n_steps,
                         fused_sweep=2 * n_steps),
          f"the trainer launched {counts}")
    check(bool(torch.isfinite(metrics["loss"]).all())
          and bool(torch.isfinite(metrics["grad_norm"]).all()),
          "the trainer's metrics are not finite")
    check(after < before, "the perturbed albedo row moved away from its "
          "true value")
    del target
    torch.cuda.empty_cache()
    fused_extra = fused_phase(dev, smi_line,
                              dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    sweep_extra = sweep_phase(dev, smi_line,
                              dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    dyn_rows = dyn_phases(dev, smi_line, dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    regen_rows = regen_phases(dev, smi_line,
                              dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    wave_rows = wavefront_phase(dev, smi_line,
                                dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    compact_rows = compact_phase(dev, smi_line,
                                 dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    split_extra = split_phase(dev, smi_line,
                              dict(reps=10, warmup=10, windows=3))
    torch.cuda.empty_cache()
    invert_extra = invert_phase(dev, smi_line, {})
    torch.cuda.empty_cache()
    mesh_extra = mesh_phase(dev, smi_line, {})
    torch.cuda.empty_cache()
    deep_extra = deep_phase(dev, smi_line, dict(reps=3, warmup=2, windows=3))
    print(f"[total] {time.time() - t_start:.1f}s", flush=True)
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} checks failed: {FAILED}")

    rows = {name: dict(launches=launches.get(name, 0),
                       max_abs_err=err[name], ms=ms[name],
                       plain_ms=plain_ms[name], bound_ms=bound[name][0],
                       bound_by=bound[name][1]) for name in ms}
    rows.update(dyn_rows)
    rows.update(regen_rows)
    rows.update(wave_rows)
    rows.update(compact_rows)
    for extra in (fused_extra, sweep_extra, split_extra, invert_extra,
                  mesh_extra, deep_extra):
        for name, keys in extra.items():
            rows[name].update(keys)
    # name -> (source under csrc/, the TPU kernel's file and def line)
    replaces = {"fused_tracer": ("fused_tracer.cu", "megakernel.py:1024"),
                "fused_collect": ("fused_tracer.cu", "megakernel.py:1211"),
                "fused_sweep": ("fused_adjoint.cu", "megakernel.py:1387"),
                "fused_adjoint": ("fused_adjoint.cu", "megakernel.py:1497"),
                "dyn_tracer": ("dyn_tracer.cu", "dynkernel.py:937"),
                "dyn_collect": ("dyn_tracer.cu", "dynkernel.py:1043"),
                "dyn_sweep": ("dyn_adjoint.cu", "dynkernel.py:1193"),
                "dyn_adjoint": ("dyn_adjoint.cu", "dynkernel.py:1300"),
                "regen_tracer": ("regen_tracer.cu", "regen.py:141"),
                "regen_sweep": ("regen_adjoint.cu", "regen.py:421"),
                "dyn_regen_tracer": ("dyn_regen_tracer.cu",
                                     "dynregen.py:46"),
                "dyn_regen_sweep": ("dyn_regen_adjoint.cu",
                                    "dynregen.py:316"),
                "ray_tracer": ("fused_tracer.cu", "megakernel.py:683"),
                "ray_adjoint": ("fused_adjoint.cu", "megakernel.py:912"),
                "segment_tracer": ("fused_tracer.cu", "megakernel.py:1024"),
                "segment_adjoint": ("fused_adjoint.cu",
                                    "megakernel.py:1497"),
                "earlyexit_tracer": ("fused_tracer.cu", "earlyexit.py:40")}
    check(tuple(replaces) == KERNELS and set(rows) == set(KERNELS),
          f"kernels measured: {sorted(rows)}")
    for name in KERNELS:
        check(rows[name]["launches"] >= 1
              and rows[name].get("collect_launches", 1) >= 1,
              f"{name} was launched no time on its path")
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} checks failed: {FAILED}")
    # No single PyTorch call computes any of these kernels: library_ms null.
    # split_launches are a kernel's launches on a lane-splitting path
    # (phase 18: a forward or a step), split_ms its time per launch on one
    # chunk of the Cornell box split cell, split_tape_ms that chunk's
    # split_prefix_tape. invert_launches are B1's, B2's and B3's launches
    # in one 60-step run of `cli invert` at the CLI's shape (phase 19).
    # mesh_launches are a kernel's launches on phase 20's mesh paths.
    # deep_launches are a lifted adjoint kernel's launches on phase 21's
    # full-width paths at depth 64 (absorb_prob 0.1), deep_ms its time at
    # depth 64 and deep_ms_at_32 at depth 32 on the same shape (B3, B4:
    # the main shape; B5b: one chunk of 640x480x4; B4-seg: [2, D) on one
    # chunk of the main shape; B11: 640x480x100; B8, B9, B13: the mesh's
    # main shape), deep_bound_ms / deep_bound_by the bound of the depth-64
    # work, wide_ms (B8, B9, B13) the time at depth 64 with 255 + 255 rows.
    # The dyn and regeneration kernels' plain_ms is of one chunk of `chunks`
    # (ms_one_chunk is the kernel on the same inputs); ms is the main path's
    # launch. A regeneration tracer's entry is its forward form; collect_*
    # are its collect form's numbers. The wavefront kernels launch once per
    # chunk: their ms and plain_ms are of one chunk. The segment kernels'
    # ms, plain_ms and bound are of one chunk's two launches (the segments
    # before and after the split).
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"drt_tpu_torch/csrc/{source}",
        "replaces": f"drt_tpu/ops/{tpu}",
        **rows[name],
        "library_ms": None,
    } for name, (source, tpu) in replaces.items()]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(*sys.argv[2:6]))
    sys.exit(main())
