"""Time the stored-residual sweeps (B3 `drt_fused_sweep`,
csrc/fused_adjoint.cu; B8 `drt_dyn_sweep`, csrc/dyn_adjoint.cu) with
parts of their work taken out, on one NVIDIA GPU: what the residual
reads alone cost, the reads and the forward replay, and the whole kernel;
and what a residual sweep needs to read at all.

  python3 tools/ablate_sweep.py [--root DIR] [--label NAME]

Each variant is DIR's drt_tpu_torch with text edits of the sweeps'
sources (its gradients are wrong by design: it is timed, never
checked), copied into drt_tpu_torch/_build/ablate_sweep/<variant>/ and
built there (tools/ablate_variants.py); the builds run at once. The
variants are timed in turns, forward and backward (A B ... B A), each in
a process of its own. JSON lines:
  - "card": nvidia-smi's name and power limit;
  - "ptxas": registers, stack, spills and shared memory of both depth
    builds of both sweep kernels, from the compiler's report of each
    variant;
  - "ablation": device ms per call (CUDA events, 20 warm-ups, the median
    of 3 windows of 10) and GB/s of residuals read (8 bytes a
    bounce-ray, every row) of B3 at the main shape (Cornell box
    640x480x256 spp, depth 5, 16 chunks, fast, internal RNG), B3 at the
    CLI's default shape (640x480x100, depth 32, one chunk) and B8 at the
    mesh's main shape (icosphere level 3, 640x480x64, depth 5, 4 chunks),
    and B3 at the main shape with 63 + 63 real table rows (the
    accumulator's limit, one block an SM);
  - "rows" (once, from the variant "as is"): of the residual rows of
    each shape, the share after each slot's first dead row, the share
    that a sweep stopping at that row would still have to read (rbest /
    rrow up to and including the first dead row, rsc up to the last live
    one) per lane, per 32-byte sector (8 lanes) and per warp (32 lanes),
    and whether a live row ever follows a dead one;
  - "path" (once, from "as is"): the stored fwd+bwd step at the CLI
    shape (host clock, median of 5 after 2 warm-ups).

Variants, for a checkout whose sweeps are one thread per slot (before
csrc/sweep_rows.cuh): "as is"; "loads alone" (every row of rsc and
rbest / rrow read as the kernel reads them, summed into a dummy); "loads
and replay" (the forward replay's throughput chain, no sweep); "as is, 8
blocks an SM" (__launch_bounds__(128, 8), at most 64 registers). For the
persistent ring of csrc/sweep_rows.cuh: "as is"; "ring alone" (the head
rows through the ring, summed into a dummy); "ring and replay" (no
sweep); "no accumulator adds" (the sweep's S chain and table reads, no
read-modify-write of the accumulator column); "rows through registers"
(the kernels' register instance at every table size, no ring).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import ablate_variants as ablate

MAIN = dict(width=640, height=480, spp=256, max_depth=5, spp_chunks=16)
CLI = dict(width=640, height=480, spp=100, max_depth=32, spp_chunks=1)
MESH = dict(width=640, height=480, spp=64, max_depth=5, spp_chunks=4)

F, D = "fused_adjoint.cu", "dyn_adjoint.cu"
_LOADS = {
    F: ("      Residuals<DMAX> r;\n"
        "      const size_t base = (size_t)c * cfg.max_depth * N + i;\n",
        "rbest"),
    D: ("      DynResiduals<DMAX> r;\n"
        "      const size_t base = (size_t)c * cfg.max_depth * N + i;\n",
        "rrow"),
}
_SWEEP = {
    F: "      reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);\n",
    D: "      dyn_reverse_sweep(cfg, tab, r, gx, gy, gz, s_acc + threadIdx.x);"
       "\n",
}
_KERNEL = {F: "fused_sweep_kernel", D: "dyn_sweep_kernel"}


def _dummy(src: str) -> list:
    """Declare a dummy before the chunk loop and store it (never, in
    practice) after it, so that what feeds it is not dropped."""
    loop = "    for (int c = 0; c < cfg.n_chunks; ++c) {\n" + _LOADS[src][0]
    end = _SWEEP[src] + "    }\n  }\n"
    return [(loop, "    float dummy = 0.0f;\n" + loop),
            (end, _SWEEP[src] + "    }\n"
             "    if (dummy == 1234.5f) partials[0] = dummy;\n  }\n")]


def _loads_alone(src: str) -> list:
    text, rows = _LOADS[src]
    body = (text + "#pragma unroll\n"
            "      for (int b = 0; b < DMAX; ++b) {\n"
            "        if (b >= cfg.max_depth) continue;\n"
            "        dummy = dummy + rsc[base + (size_t)b * N]\n"
            f"                + (float){rows}[base + (size_t)b * N];\n"
            "      }\n"
            "      if (dummy != -1.0f) continue;\n")
    return _dummy(src) + [(text, body)]


def _replay(src: str) -> list:
    tail = "    }\n    if (dummy == 1234.5f)"
    return _dummy(src) + [(_SWEEP[src] + tail,
                           "      dummy = dummy + Tx + Ty + Tz;\n" + tail)]


def _bounds(src: str) -> list:
    k = _KERNEL[src]
    return [(f"__global__ void __launch_bounds__(DRT_BLOCK)\n{k}",
             f"__global__ void __launch_bounds__(DRT_BLOCK, 8)\n{k}")]


# name -> {source: [(old, new), ...]}: the one-thread-per-slot kernels
# that sweep_rows.cuh replaced (a checkout from before it) ...
PARENT_VARIANTS = {
    "as is": {},
    "loads alone": {F: _loads_alone(F), D: _loads_alone(D)},
    "loads and replay": {F: _replay(F), D: _replay(D)},
    "as is, 8 blocks an SM": {F: _bounds(F), D: _bounds(D)},
}

# ... and the persistent ring of csrc/sweep_rows.cuh.
S = "sweep_rows.cuh"
_RING_CALL = """      if (ok)
        sweep_item<TAIL>(cfg, decode, s_alb, s_emi, rsc, rword, base, H,
                         head, gv, acc, acc_e);
    } else {"""
_RING_ALONE = """      if (ok) {
        float d = 0.0f;
        for (int b = 0; b < H; ++b)
          d = d + head.sc_of(b) + (float)head.word_of(b);
        if (d == 1234.5f) acc[0] = d;
      }
    } else {"""
_SWEEP_END = """      sweep_row(cfg, s_alb, s_emi, acc, acc_e, b, code[b], P[b],
                head.sc_of(b), g, S);
}"""
_REPLAY_ALONE = """      if (b < 0)
        sweep_row(cfg, s_alb, s_emi, acc, acc_e, b, code[b], P[b],
                  head.sc_of(b), g, S);
  if (T[0] + T[1] + T[2] == 1234.5f) acc[0] = T[0];
}"""
_BOUNCE = "  sweep_bounce(acc, acc_e, arow, erow, a, e, P, sc, gate, g, S);"
_S_ONLY = """  S[0] = (e[0] + a[0] * sc * S[0]) * gate;
  S[1] = (e[1] + a[1] * sc * S[1]) * gate;
  S[2] = (e[2] + a[2] * sc * S[2]) * gate;"""
RING_VARIANTS = {
    "as is": {},
    "ring alone": {S: [(_RING_CALL, _RING_ALONE)]},
    "ring and replay": {S: [(_SWEEP_END, _REPLAY_ALONE)]},
    "no accumulator adds": {S: [
        (_SWEEP_END, _SWEEP_END[:-1]
         + "  if (S[0] + S[1] + S[2] == 1234.5f) acc[0] = S[0];\n}"),
        (_BOUNCE, _S_ONLY)]},
    "rows through registers": {S: [("  *stages = k < 2 ? 0 : k;\n",
                                    "  *stages = 0;\n")]},
}


def variants_of(root: Path) -> dict:
    """The variants for the design of root's kernels."""
    if (root / "drt_tpu_torch" / "csrc" / S).exists():
        return RING_VARIANTS
    return PARENT_VARIANTS


def ptxas_lines(log: str, kernel: str) -> list:
    """The report's lines of every instantiation of `kernel`."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            out.append(line.strip())
    return out


def cuda_ms(torch, fn, reps=10, warmup=20, windows=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[len(means) // 2], means


def row_shares(torch, live):
    """Shares of the rows of live bool[C, D, N] (see the module's doc)."""
    C, Dp, N = live.shape
    run = torch.cumprod(live.to(torch.int32), dim=1) > 0  # all rows <= b
    need_best = torch.ones_like(live)
    need_best[:, 1:] = run[:, :-1]  # up to and including the first dead
    need_sc = run

    def share(need, lanes):
        if lanes == 1:
            return float(need.float().mean())
        grouped = need.reshape(C, Dp, N // lanes, lanes).any(dim=3)
        return float(grouped.float().mean())

    out = {"after_first_dead": float((~need_best).float().mean()),
           "live_after_dead": int((live & ~need_best).sum())}
    for lanes, what in ((1, "lane"), (8, "sector"), (32, "warp")):
        out[f"read_by_{what}"] = (share(need_best, lanes)
                                  + share(need_sc, lanes)) / 2
    return out


def wide(t, n):
    """Table t with its real rows repeated up to n - 1, the sentinel
    last."""
    import torch
    reps = -(-(n - 1) // (t.shape[0] - 1))
    return torch.cat([torch.cat([t[:-1]] * reps)[:n - 1],
                      t[-1:]]).contiguous()


def child(root: Path, full: bool) -> None:
    """Time the variant whose package is under root; print one JSON
    object."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox, gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import megakernel as mk
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params, albedo_table, emission_table
    from drt_tpu_torch.utils import native

    dev = torch.device("cuda")
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(11)
    out, rows, paths = {}, {}, {}
    if full:
        out["ptxas"] = {src: ptxas_lines(native.log_path(src).read_text(),
                                         _KERNEL[src]) for src in (F, D)}
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    for name, shape, rows_to in (("B3 main shape", MAIN, 0),
                                 ("B3 CLI shape", CLI, 0),
                                 ("B3 main shape, 63 + 63 table rows", MAIN,
                                  64)):
        if rows_to:
            alb, emi = wide(alb, rows_to), wide(emi, rows_to)
        cfg = RenderConfig(**shape)
        C = cfg.spp_chunks
        _, rsc, rbest = mk.make_fused_collect_tracer(
            scene, cam, cfg, fastmath=True, n_chunks=C)(alb, emi, seeds)
        g = torch.rand((3, cfg.width * cfg.height), generator=gen,
                       device=dev) / cfg.spp
        sweep = mk.make_fused_sweep_adjoint(scene, cfg, n_chunks=C)
        ms, win = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rbest, g))
        out[name] = dict(ms=ms, windows=win,
                         gb_s=rsc.numel() * 8 / ms / 1e6)
        if full and not rows_to:
            rows[name] = row_shares(torch, (rbest > 0).reshape(
                C, cfg.max_depth, -1))
        del rsc, rbest
        torch.cuda.empty_cache()
    if full:
        cfg = RenderConfig(**CLI)
        render = make_renderer(scene, cfg, cam)
        s_img = torch.tensor([1, 2], dtype=torch.int32)
        with torch.no_grad():
            target = make_renderer(scene, cfg, cam, differentiable=False)(
                params, s_img)
        p_off = Params(params.albedo * 0.8, params.emission * 1.1)

        def step():
            p = Params(*(t.detach().clone().requires_grad_() for t in p_off))
            ((render(p, s_img) - target) ** 2).mean().backward()

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        paths["stored fwd+bwd step, CLI shape"] = dict(
            s=statistics.median(times), times=times)
        del render, target
        torch.cuda.empty_cache()
    scene, params, cam = gallery.build_mesh(3, device=dev)
    ds = dk.DynScene(scene)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    cfg = RenderConfig(**MESH)
    C = cfg.spp_chunks
    _, rsc, rrow = dk.make_dyn_collect_tracer(
        ds, cam, cfg, fastmath=True, n_chunks=C)(alb, emi, seeds)
    g = torch.rand((3, cfg.width * cfg.height), generator=gen,
                   device=dev) / cfg.spp
    sweep = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=C)
    ms, win = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rrow, g))
    out["B8 main shape"] = dict(ms=ms, windows=win,
                                gb_s=rsc.numel() * 8 / ms / 1e6)
    if full:
        rows["B8 main shape"] = row_shares(
            torch, ((rrow >> 16) > 0).reshape(C, cfg.max_depth, -1))
        out["rows"] = rows
        out["paths"] = paths
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--variants", default="",
                    help="comma-separated names of the variants to time "
                         "(default: all of the design's)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--full", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child), args.full)
        return 0
    if not ablate.card("ablate_sweep", args.label):
        return 2
    root = Path(args.root).resolve()
    variants = variants_of(root)
    if args.variants:
        variants = {name: variants[name]
                    for name in args.variants.split(",")}
    roots = {name: ablate.make_variant(root, "ablate_sweep", name, edits)
             for name, edits in variants.items()}
    if not ablate.build_variants(roots.values(), (F, D)):
        return 1
    for run, name in enumerate(ablate.in_turns(variants)):
        res = ablate.run_child(__file__, roots[name],
                               *(["--full"] if run == 0 else []))
        if res is None:
            return 1
        got = json.loads(res.stdout.splitlines()[-1])
        for what in ("ptxas", "rows", "paths"):
            if what in got:
                print(json.dumps({"kind": what, "label": args.label,
                                  "variant": name, what: got.pop(what)}),
                      flush=True)
        print(json.dumps({"kind": "ablation", "label": args.label,
                          "variant": name, "run": run, "ms": got}),
              flush=True)
    # The report of every variant's build, for the registers it took.
    for name, r in roots.items():
        for src in (F, D):
            log = next((r / "drt_tpu_torch" / "_build").glob(
                f"*/{Path(src).stem}.log")).read_text()
            print(json.dumps({"kind": "ptxas", "label": args.label,
                              "variant": name, "source": src,
                              "lines": ptxas_lines(log, _KERNEL[src])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
