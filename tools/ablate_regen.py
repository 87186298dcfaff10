"""Time the scene-table regeneration tracer (B10, csrc/regen_tracer.cu) in
both forms with parts of its work changed, on one NVIDIA GPU: what the
collect form's row stores cost, what writing a dying trip's row without
its bounce saves, and how the lanes take their units.

  python3 tools/ablate_regen.py [--root DIR] [--label NAME]
                                [--variants "as is,no row stores"]

Each variant is DIR's drt_tpu_torch with text edits of regen_tracer.cu
(tools/ablate_variants.py), built at once and timed in turns (A B ... B
A), each in a process of its own. JSON lines: "card"; "ablation": device
ms per call (CUDA events, 20 warm-ups, the median of 3 windows of 10) of
the tracer and the collect form at the main shape (Cornell box 640x480,
256 spp, depth 5, 16 chunks, fast, seeds (7, 8)), and the SHA-256
digests of their radiance, trips and rows up to each pixel's trips;
"ptxas": the registers of each variant's kernels.

Variants: "as is"; "no row stores" (the collect form stores no row);
"bounce the dying trip" (the roulette of the next bounce is left to the
bounce, as the per-pixel loop did); "grid of the units" (one lane per
unit, not a persistent grid); "collect: a batch when K lanes are idle"
(K = 1, 8, 16, 24: the collect form takes a warp's next batch when K of
its lanes wait for a unit, where it waits for all 32); "lane columns"
(lane l takes column l of the warp's batches warp, warp + W, ..., no
counter). --parent DIR times a checkout as it is among them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import ablate_variants as ablate

MAIN = dict(width=640, height=480, spp=256, max_depth=5, spp_chunks=16)
R = "regen_tracer.cu"

_HANDOUT_START = ("    // The warp's next units to the lanes without one, in "
                  "lane order.\n")
_HANDOUT_END = ("    if (!__any_sync(0xffffffffu, work)) {\n"
                "      if (dry && pool == pool_end) break;\n"
                "      continue;\n"
                "    }\n")
_COLUMNS = """    // Lane columns: lane l takes column l of batches warp + q W.
    if (!work && !dry) {
      const int batch = warp + pool * W;
      ++pool;
      dry = batch >= n_batches;
      if (!dry) {
        pix = ((batch / C) << 5) + lane;
        c = batch % C;
        work = pix < n;
        s = -1;
        trip = 0;
      }
    }
    if (!__any_sync(0xffffffffu, work || !dry)) break;
    if (!__any_sync(0xffffffffu, work)) continue;
"""
# A grid of one lane per unit (not persistent): each warp takes its own
# first batch and finds the counter dry.
_UNIT_GRID = (
    "  const int threads = ((n_pix + 31) >> 5) * 32 * n_chunks;\n",
    "  const int threads = ((n_pix + 31) >> 5) * 32 * n_chunks;\n"
    "  *grid = (threads + DRT_BLOCK - 1) / DRT_BLOCK;\n"
    "  if (*grid > 0) return cudaSuccess;\n")
_REFILL = "#define REFILL_COLLECT 32\n"


def variants_of(root: Path) -> dict:
    src = (root / "drt_tpu_torch" / "csrc" / R).read_text()
    start = src.index(_HANDOUT_START)
    end = src.index(_HANDOUT_END) + len(_HANDOUT_END)
    return {
        "as is": {},
        "no row stores": {R: [
            ("    sc[(size_t)trip * n] = sc_b;\n"
             "    meta[(size_t)trip * n] =\n"
             "        best | (want << 8) | ((b >= min_bounces ? 1 : 0) << 9)"
             ";\n",
             ""),
            ("      if (COLLECT) {\n"
             "        rsc[base + (size_t)trip * n] = 0.0f;\n"
             "        rmeta[base + (size_t)trip * n] = 1 << 9;\n"
             "      }\n", "")]},
        "bounce the dying trip": {R: [
            ("keyed_uniform(key, (uint32_t)bnc, 0u) < cfg.absorb", "false")]},
        "grid of the units": {R: [_UNIT_GRID]},
        **{f"collect: a batch when {k} lanes are idle": {R: [
            (_REFILL, f"#define REFILL_COLLECT {k}\n")]}
           for k in (1, 8, 16, 24)},
        "lane columns": {R: [
            (src[start:end], _COLUMNS),
            ("  int pool = warp << 5, pool_end = (warp + 1) << 5;\n"
             "  bool dry = warp >= n_batches;  // no batch left\n"
             "  if (dry) pool = pool_end = 0;\n",
             "  int pool = 0;  // the lane's next batch: warp + pool W\n"
             "  bool dry = false;\n")]},
    }


def cuda_ms(torch, fn, reps=10, warmup=20, windows=3):
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


def child(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    import drt_tpu_torch
    assert Path(drt_tpu_torch.__file__).resolve().parent.parent == root
    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.scene import albedo_table, emission_table

    dev = torch.device("cuda")
    cfg = RenderConfig(**MAIN)
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    kw = dict(fastmath=True, n_chunks=cfg.spp_chunks)
    out = {}
    ms, win, (L, trips) = cuda_ms(torch, lambda: rg.regen_trace(
        scene, table, cc, cfg, alb, emi, seeds, **kw))
    out["tracer"] = dict(ms=ms, windows=win, radiance=digest(L),
                         trips=digest(trips))
    ms, win, (L, rsc, rmeta, trips) = cuda_ms(
        torch, lambda: rg.regen_collect(scene, table, cc, cfg, alb, emi,
                                        seeds, **kw))
    own = (torch.arange(rsc.shape[1], device=dev)[None, :, None]
           < trips[:, None, :])
    out["collect"] = dict(
        ms=ms, windows=win, radiance=digest(L), trips=digest(trips),
        rows=[digest(torch.where(own, rsc, 0.0)),
              digest(torch.where(own, rmeta, 0))])
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--variants", default="")
    ap.add_argument("--parent", default="",
                    help="a checkout timed as it is beside the variants")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child))
        return 0
    if not ablate.card("ablate_regen", args.label):
        return 2
    root = Path(args.root).resolve()
    variants = variants_of(root)
    if args.variants:
        variants = {name: variants[name]
                    for name in args.variants.split(",")}
    roots = {name: ablate.make_variant(root, "ablate_regen", name, edits)
             for name, edits in variants.items()}
    if args.parent:
        roots["parent"] = Path(args.parent).resolve()
    if not ablate.build_variants(roots.values(), (R,)):
        return 1
    for run, name in enumerate(ablate.in_turns(roots)):
        res = ablate.run_child(__file__, roots[name])
        if res is None:
            return 1
        print(json.dumps({"kind": "ablation", "label": args.label,
                          "variant": name, "run": run,
                          "ms": json.loads(res.stdout.splitlines()[-1])}),
              flush=True)
    for name, r in roots.items():
        log = next((r / "drt_tpu_torch" / "_build").glob(
            f"*/{Path(R).stem}.log")).read_text().splitlines()
        print(json.dumps({"kind": "ptxas", "label": args.label,
                          "variant": name,
                          "lines": [ln.strip() for ln in log
                                    if "registers" in ln or "entry" in ln]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
