"""Time the segment adjoint (B4-seg, `drt_fused_segment_adjoint` of
csrc/fused_adjoint.cu) with one part of its work taken out at a time, on
one NVIDIA GPU: the parts of its queue (`segment_queue_kernel`, past the
camera) and of its lockstep loop (`segment_adjoint_kernel`, from the
camera, and the checking build `build="lockstep"`), and the queue's
trips; and B1 and B4 exact in both of their builds at shallow depths.

  python3 tools/ablate_segment_queue.py [--root DIR] [--label NAME]
  python3 tools/ablate_segment_queue.py --tracer [--root DIR] [--label NAME]

Each variant is DIR's drt_tpu_torch with text edits of
csrc/fused_adjoint.cu (its gradients are wrong by design, except as is
and counted: it is timed, never checked), copied into
drt_tpu_torch/_build/ablate_queue/<variant>/ and built there
(tools/ablate_variants.py); the builds run at once. The variants are
then timed in turns, forward and backward (A B ... B A), each in a
process of its own. Printed, as JSON lines: "card" (nvidia-smi's name
and power limit); one "ablation" line per variant and run with device
ms per launch (CUDA events, the median of 3 windows of 10 after 20
warm-ups) on chunk 1 of the main shape (Cornell box 640x480x256 spp,
depth 5, exact, internal RNG, split before bounce 2) in the layouts of
`tools/bench_torch_fused.py:segment_layouts`: the entry point's [0, 2)
over every lane (the lockstep loop) and [2, 5) over every lane and
compacted (the queue), and the lockstep build's [2, 5) in both layouts;
for the variant "counted" the warp-trips and lane-trips of each queue
launch and its grid; and one "depths" line: B1 and B4 exact on one
chunk of 640x480x16 at depths 1, 2, 3, 5 in both builds.

With --tracer the same for the segment tracer (B1-seg,
`drt_fused_segment_trace` of csrc/fused_tracer.cu): the variants "as
is" (its queue past the camera, the lockstep loop from it) and "queue
from the camera" (the queue at every b_start), each timed on [0, 2)
from the camera and [2, 5) over every lane and compacted, in both
builds, with the loop each launch runs and the digests of [0, 2)'s
radiance, exit ray and alive.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

import ablate_variants as ablate

# The queue's parts.
SWEEP = "        sweep_segment_path(cfg, tab, rows, b0, bnc - b0, gv, S, acc);\n"
ROWS = "    r.put(b - b0, make_float4(Px, Py, Pz, sc), best);\n"
ADD = "          sum[e * 32] = sum[e * 32] + acc[e * DRT_BLOCK];\n"
LOADS = ("        gv[0] = g[i]; gv[1] = g[n + i]; gv[2] = g[2 * n + i];\n"
         "        if (s_end != nullptr) {\n")
OPEN = "        atomicOr(open_w + (at_m % SEGMENT_RING) * 32 + at_l, 1 << at_k);\n"
CLOSE = "        atomicAnd(open_w + slot * 32 + at_l, ~(1 << at_k));\n"
BARE = [(SWEEP, "        if (b0 < 0)\n" + SWEEP),
        (ROWS, "    if (b < 0) r.put(b - b0, make_float4(Px, Py, Pz, sc), "
               "best);\n"),
        (ADD, "          if (E < 0)\n" + ADD)]
KERNEL = ("__global__ void __launch_bounds__(DRT_BLOCK)\n"
          "segment_queue_kernel(")
LAUNCH = ("                                          s_end, next_group, partials,\n"
          "                                          s_start);\n")
COUNTER = """  {  // counted: the launch's trips, to stderr
    unsigned long long h[2] = {0, 0};
    cudaStreamSynchronize(s);
    cudaMemcpyFromSymbol(h, seg_trips, sizeof h);
    fprintf(stderr, "TRIPS warp=%llu lane=%llu K=%d b0=%d grid=%d\\n", h[0],
            h[1], K, b0, grid);
    const unsigned long long z[2] = {0, 0};
    cudaMemcpyToSymbol(seg_trips, z, sizeof z);
  }
"""
TRIP = ("    if (work) {\n      {\n        const SegmentQueueTape& tape = qt;\n")
# The lockstep loop's parts: its sweep of every row, and its block
# reduction with the reduction of the partials (an edit whose old text
# is at the third entry's first match after it).
L_SWEEP = ("    segment_sweep(cfg, tab, r, b1 - b0, gv, S, "
           "s_acc + threadIdx.x);\n")
L_NO_SWEEP = ("    if (b1 < 0) segment_sweep(cfg, tab, r, b1 - b0, gv, S, "
              "s_acc + threadIdx.x);\n")
L_KERNEL = "segment_adjoint_kernel(DrtTrace cfg"
L_BLOCK_REDUCE = ("  block_reduce_write(cfg.n_alb, cfg.n_emi, s_acc, partials);"
                  "\n}\n")
L_NO_BLOCK_REDUCE = ("  if (K < 0) block_reduce_write(cfg.n_alb, cfg.n_emi, "
                     "s_acc, partials);\n}\n")
L_LAUNCH = "segment_adjoint_kernel<FAST, INTERNAL><<<"
L_REDUCE = ("  rc = (int)cudaGetLastError();\n  if (rc) return rc;\n"
            "  return reduce_partials(cfg->n_rays, cfg->n_alb, cfg->n_emi, "
            "partials, da,\n                         de, s);\n}\n")
L_NO_REDUCE = "  return (int)cudaGetLastError();\n}\n"
L_NO_REDUCTIONS = [(L_BLOCK_REDUCE, L_NO_BLOCK_REDUCE, L_KERNEL),
                   (L_REDUCE, L_NO_REDUCE, L_LAUNCH)]
# name -> text edits (old, new[, anchor]) of csrc/fused_adjoint.cu
VARIANTS = {
    "as is": [],
    "queue: no sweep, rows or adds": BARE,
    "queue: no sweep, rows, adds, input loads or open-lane atomics": BARE + [
        (LOADS, "        if (i < 0) { gv[0] = g[i]; gv[1] = g[n + i]; "
                "gv[2] = g[2 * n + i]; }\n"
                "        if (s_end != nullptr && i < 0) {\n"),
        (OPEN, "        if (at_k < 0)\n" + OPEN),
        (CLOSE, "        if (at_k < 0)\n" + CLOSE)],
    "queue: one open group a warp": [("#define SEGMENT_RING 2\n",
                                      "#define SEGMENT_RING 1\n")],
    "queue: launch bounds (128, 9)": [(KERNEL, KERNEL.replace(
        "(DRT_BLOCK)", "(DRT_BLOCK, 9)"))],
    "lockstep: no sweep": [(L_SWEEP, L_NO_SWEEP)],
    "lockstep: no reductions": L_NO_REDUCTIONS,
    "lockstep: the retrace alone": [(L_SWEEP, L_NO_SWEEP)] + L_NO_REDUCTIONS,
    "counted": [
        ("#define SEGMENT_STAGE 11\n", "#define SEGMENT_STAGE 11\n"
         "#include <cstdio>\n__device__ unsigned long long seg_trips[2];\n"),
        (TRIP, "    {\n      const unsigned m = __ballot_sync(0xffffffffu, "
               "work);\n      if (lane == 0) {\n        atomicAdd(seg_trips, "
               "1ull);\n        atomicAdd(seg_trips + 1, (unsigned long long)"
               "__popc(m));\n      }\n    }\n" + TRIP),
        (LAUNCH, LAUNCH + COUNTER)],
}


# The segment tracer B1-seg (csrc/fused_tracer.cu): its entry point as
# is (the queue past the camera, the lockstep loop from it), and on the
# queue from the camera too.
TRACER_VARIANTS = {
    "as is": [],
    "queue from the camera": [
        ("static bool segment_trace_takes_queue(int b_start) { "
         "return b_start > 0; }",
         "static bool segment_trace_takes_queue(int b_start) { "
         "return b_start >= 0; }")],
}


def child_tracer(root: Path) -> None:
    """Time B1-seg of the variant whose package is under root on chunk 1
    of the main shape, split before bounce 2, in each build: [0, 2) from
    the camera, [2, 5) on every lane and compacted; one JSON object."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.scene import albedo_table, emission_table

    spec = importlib.util.spec_from_file_location(
        "bench_torch_fused", Path(__file__).with_name("bench_torch_fused.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    cfg = RenderConfig(**bench.MAIN)
    D, b, chunk = cfg.max_depth, 2, 1
    lay = bench.segment_layouts(torch, scene, cam, cfg, alb, emi, seeds, b,
                                chunk)
    out = {"loops": {f"[{b0}, {b1})": mk.segment_trace_form(b0)
                     for b0, b1 in ((0, b), (b, D))}}
    for build in mk.BUILDS:
        tag = "" if build == "queue" else ", lockstep build"
        seg = mk.make_fused_segment_tracer(scene, cam, cfg, 0, b, build=build)
        out[f"[0, {b}) every lane{tag}"], _, got = bench.cuda_ms(
            torch, lambda: seg(alb, emi, seeds, chunk=chunk))
        out[f"digests [0, {b}){tag}"] = [bench.digest(t) for t in (
            got[0], got[1][0], got[1][1])]
        for layout, (K, ray, alive, ridx, _, _) in lay["layouts"].items():
            seg = mk.make_fused_segment_tracer(scene, cam, cfg, b, D,
                                               n_rays=K, build=build)
            out[f"[{b}, {D}) {layout}{tag}"] = bench.cuda_ms(
                torch, lambda: seg(alb, emi, seeds, ray, alive, ridx,
                                   chunk=chunk))[0]
    print(json.dumps(out), flush=True)


def child(root: Path, depths: bool) -> None:
    """Time the variant whose package is under root; print one JSON
    object (and, with depths, a second)."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.scene import albedo_table, emission_table

    spec = importlib.util.spec_from_file_location(
        "bench_torch_fused", Path(__file__).with_name("bench_torch_fused.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    cfg = RenderConfig(**bench.MAIN)
    D, b, chunk = cfg.max_depth, 2, 1
    lay = bench.segment_layouts(torch, scene, cam, cfg, alb, emi, seeds, b,
                                chunk)

    def ms(fn):
        return bench.cuda_ms(torch, fn)[0]

    adjA = mk.make_fused_segment_adjoint(scene, cam, cfg, 0, b)
    S_A = torch.zeros((3, lay["n"]), device=dev)
    out = {f"[0, {b}) every lane": ms(lambda: adjA(
        alb, emi, seeds, lay["g_pix"], S_A, chunk=chunk))}
    for layout, (K, ray, alive, ridx, g, _) in lay["layouts"].items():
        for build in mk.BUILDS:
            adjB = mk.make_fused_segment_adjoint(scene, cam, cfg, b, D,
                                                 n_rays=K, build=build)
            name = f"[{b}, {D}) {layout}" + (", lockstep build" if
                                             build == "lockstep" else "")
            out[name] = ms(lambda: adjB(alb, emi, seeds, ray, alive, ridx, g,
                                        chunk=chunk))
    print(json.dumps(out), flush=True)
    if not depths:
        return
    table = mk.scene_table(scene)
    out = {}
    for d in (1, 2, 3, 5):
        c = RenderConfig(width=640, height=480, spp=16, max_depth=d)
        cc = mk.camera_consts(cam, 640, 480)
        g = torch.rand((3, 640 * 480 * 16), generator=torch.Generator(
            device=dev).manual_seed(d), device=dev)
        for build in mk.BUILDS:
            out[f"B1 depth {d}, {build}"] = ms(lambda: mk.fused_trace(
                scene, table, cc, c, alb, emi, seeds=seeds, build=build))
            out[f"B4 depth {d}, {build}"] = ms(lambda: mk.fused_adjoint(
                scene, table, cc, c, alb, emi, g, seeds=seeds, build=build))
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--tracer", action="store_true",
                    help="the segment tracer B1-seg's variants instead")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--depths", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        if args.tracer:
            child_tracer(Path(args.child))
        else:
            child(Path(args.child), args.depths)
        return 0
    if not ablate.card("ablate_segment_queue", args.label):
        return 2
    root = Path(args.root).resolve()
    if args.tracer:
        roots = {name: ablate.make_variant(root, "ablate_queue_tracer", name,
                                           {"fused_tracer.cu": edits})
                 for name, edits in TRACER_VARIANTS.items()}
        if not ablate.build_variants(roots.values(), ("fused_tracer.cu",)):
            return 1
        for run, name in enumerate(ablate.in_turns(TRACER_VARIANTS)):
            res = ablate.run_child(__file__, roots[name], "--tracer")
            if res is None:
                return 1
            print(json.dumps({"kind": "ablation", "label": args.label,
                              "variant": name, "run": run,
                              "ms": json.loads(res.stdout.splitlines()[0])}),
                  flush=True)
        return 0
    roots = {name: ablate.make_variant(root, "ablate_queue", name,
                                       {"fused_adjoint.cu": edits})
             for name, edits in VARIANTS.items()}
    if not ablate.build_variants(roots.values(),
                                 ("fused_adjoint.cu", "fused_tracer.cu")):
        return 1
    timed = [name for name in VARIANTS if name != "counted"]
    for run, name in enumerate(ablate.in_turns(timed) + ["counted"]):
        res = ablate.run_child(__file__, roots[name],
                               *(["--depths"] if run == 0 else []))
        if res is None:
            return 1
        lines = res.stdout.splitlines()
        rec = {"kind": "ablation", "label": args.label, "variant": name,
               "run": run, "ms": json.loads(lines[0])}
        if name == "counted":  # the first launch of each segment
            first = {}
            for ln in res.stderr.splitlines():
                m = re.match(r"TRIPS .* (K=\d+ b0=\d+)", ln)
                if m:
                    first.setdefault(m.group(1), ln)
            rec["trips"] = list(first.values())
        print(json.dumps(rec), flush=True)
        if len(lines) > 1:
            print(json.dumps({"kind": "depths", "label": args.label,
                              "ms": json.loads(lines[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
