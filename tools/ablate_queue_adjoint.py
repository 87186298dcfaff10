"""Time the queue of the scene-table adjoints (B4 `drt_fused_adjoint`, B5b
`drt_ray_adjoint`, csrc/fused_adjoint.cu) with one part of its work taken
out at a time, on one NVIDIA GPU: what the sweep of a path's rows, the
flush of a slot's column and the rows themselves cost, and what the
one-chunk flush that skips words of +0 saves.

  python3 tools/ablate_queue_adjoint.py [--root DIR] [--label NAME]

Each variant is DIR's drt_tpu_torch with one text edit of
csrc/fused_adjoint.cu (its gradients are wrong by design: it is timed,
never checked), copied into drt_tpu_torch/_build/ablate/<variant>/ and
built there (tools/ablate_variants.py); the builds run at once. The
variants are then timed in turns, forward and backward (A B ... B A),
each in a process of its own, and the script prints JSON lines: "card"
(nvidia-smi's name and power limit) and one "ablation" line per variant
and run with device ms per call (CUDA events, 10 warm-ups, the mean of
10): B4 at the main shape
(Cornell box 640x480x256 spp, depth 5, 16 chunks, fast, internal RNG), at
the CLI's default shape (640x480x100, depth 32, one chunk) and on one
chunk of the main shape (exact, internal RNG and tape mode), and B5b on
that chunk (the retrace adjoint's rays and hash tapes).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import ablate_variants as ablate

SWEEP = "    sweep_path(cfg, tab, rows, bnc, gv, acc);\n"
NO_SWEEP = "    if (bnc < 0) sweep_path(cfg, tab, rows, bnc, gv, acc);\n"
FLUSH = "    for (int e = 0; e < E; e += 4) {\n      float4 v;"
NO_FLUSH = "    for (int e = 0; e < E && i < 0; e += 4) {\n      float4 v;"
ROWS = "    r.put(b, make_float4(Px, Py, Pz, sc), best);"
NO_ROWS = "    if (b < 0) r.put(b, make_float4(Px, Py, Pz, sc), best);"
# name -> text edits (old, new) of csrc/fused_adjoint.cu
VARIANTS = {
    "as is": [],
    "no sweep": [(SWEEP, NO_SWEEP)],
    "no flush": [(FLUSH, NO_FLUSH)],
    "no rows, no sweep": [(SWEEP, NO_SWEEP), (ROWS, NO_ROWS)],
    "dense flush at one chunk": [
        ("      if (C > 1 || (", "      if (true || ("),
        ("  if (cfg->n_chunks == 1 && slot_acc) {", "  if (false) {")],
}


def child(root: Path) -> None:
    """Time the variant whose package is under root; print one JSON
    object."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.ops.rng import hash_tapes
    from drt_tpu_torch.scene import albedo_table, emission_table

    dev = torch.device("cuda")
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 640, 480)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    npix = 640 * 480
    main = RenderConfig(width=640, height=480, spp=256, max_depth=5,
                        spp_chunks=16)
    cli = RenderConfig(width=640, height=480, spp=100, max_depth=32)
    chunk = RenderConfig(width=640, height=480, spp=16, max_depth=5)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_ray = torch.rand((3, npix * 16), generator=gen, device=dev)
    g_pix = torch.rand((3, npix), generator=gen, device=dev)
    cam_u, tape = hash_tapes(seeds, npix, 16, 5, device=dev)
    pix = torch.arange(npix * 16, device=dev) % npix
    o, d = mk.camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))

    def ms(fn, reps=10, warmup=10):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def b4(cfg, g, **kw):
        return lambda: mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g,
                                        **kw)

    out = {
        "B4 main shape, fast": ms(b4(main, g_pix / 256, seeds=seeds,
                                     fastmath=True, n_chunks=16)),
        "B4 CLI shape, fast": ms(b4(cli, g_pix / 100, seeds=seeds,
                                    fastmath=True)),
        "B4 one chunk, internal": ms(b4(chunk, g_ray, seeds=seeds)),
        "B4 one chunk, tape": ms(b4(chunk, g_ray, cam_u=cam_u, tape=tape)),
        "B5b one chunk": ms(lambda: mk.ray_adjoint(
            scene, table, chunk, alb, emi, o, d, tape, g_ray)),
    }
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child))
        return 0
    if not ablate.card("ablate_queue_adjoint", args.label):
        return 2
    root = Path(args.root).resolve()
    roots = {name: ablate.make_variant(root, "ablate", name,
                                       {"fused_adjoint.cu": edits})
             for name, edits in VARIANTS.items()}
    if not ablate.build_variants(roots.values(), ("fused_adjoint.cu",)):
        return 1
    for run, name in enumerate(ablate.in_turns(VARIANTS)):
        res = ablate.run_child(__file__, roots[name])
        if res is None:
            return 1
        print(json.dumps({"kind": "ablation", "label": args.label,
                          "variant": name, "run": run,
                          "ms": json.loads(res.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
