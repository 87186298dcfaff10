"""Time the stored-residual sweeps (B3 `drt_fused_sweep`,
csrc/fused_adjoint.cu; B8 `drt_dyn_sweep`, csrc/dyn_adjoint.cu) with
parts of their work taken out, on one NVIDIA GPU: what the residual
reads alone cost, the reads and the forward replay, and the whole kernel;
and what a residual sweep needs to read at all.

  python3 tools/ablate_sweep.py [--root DIR] [--label NAME]
  python3 tools/ablate_sweep.py --kernel b11 [--root DIR] [--label NAME]
  python3 tools/ablate_sweep.py --kernel b13 [--root DIR] [--label NAME]

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

With --kernel b11 the same for the regeneration sweep B11
(`drt_regen_sweep`, csrc/regen_adjoint.cu) at the main shape (Cornell box
640x480x256 spp, depth 5, 16 chunks, fast, seeds (7, 8)) and at the CLI's
default shape (640x480x100, depth 32, one chunk): "ablation" lines with
ms, the rows the pixels ran (their trips) and GB/s of them (8 bytes a
row); once, "ptxas" (its kernels' registers and spills), "occupancy"
(resident blocks per SM of each kernel instance by the occupancy API)
and "rows" (of the trips per (pixel, chunk): the rows a window that runs
to the largest trips of a warp's 32 pixels, or of a 32-byte sector's 8,
spans against the rows needed; quantiles of the trips, of each warp's
largest and of the gap). Variants, for the one-thread-per-pixel kernel
(before the windows): "as is"; "rows alone" (each thread reads its rows
in the kernel's order, summed into a dummy); "rmeta chain alone" (only
the rmeta rows, each read after the one before has been compared);
"no accumulator adds" (the sweep's S chain without the read-modify-
writes of the accumulator column). For the window kernel: "as is";
"windows alone" (the copies and the rounds, each segment's rows read
from the ring for its length alone, no replay or sweep);
"no accumulator adds"; "3 windows" and "8 windows" (the 8-bounce
instance's ring; 4 as is); "3 windows, 6 | 7 blocks an SM"
(__launch_bounds__ that cap the registers); "rows preloaded" (the
8-bounce instance reads a segment's rows from the ring together before
its replay).

With --kernel b13 the same for the mesh regeneration sweep B13
(`drt_dyn_regen_sweep`, csrc/dyn_regen_adjoint.cu) at the mesh's main
shape (icosphere level 3, 640x480x64 spp, depth 5, 4 chunks, fast, seeds
(7, 8)), on chunk 1 of it alone (a retrace's one-chunk launch) and at
the 32-bounce shape (the mesh at 640x480x100, depth 32, one chunk), and
where the checkout has it its checking build (`lockstep_ms`) and the
kernel the entry point runs (`form`). Variants, for the per-pixel kernel:
"as is"; "rows alone"; "rrow chain alone"; "no accumulator adds" (as
B11's). For the window kernel, whose window sweep B11 shares
(csrc/regen_window.cuh): "as is"; "windows alone"; "no accumulator
adds".
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
        sweep_item<TAIL, DEEP>(cfg, decode, s_alb, s_emi, rsc, rword, base,
                               H, head, gv, acc, acc_e, deep);
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


# B11, the regeneration sweep (drt_regen_sweep, csrc/regen_adjoint.cu):
# its one-thread-per-pixel kernel (before the windows, and the checking
# build drt_regen_sweep_lockstep after them) ...
RA, RB = "regen_adjoint.cu", "regen_body.cuh"
_B11_CALL = """      regen_sweep_chunk<DMAX>(cfg, tab, decode, rsc + base, rmeta + base,
                              (size_t)n, trips[(size_t)c * n + pix], gp,
                              s_acc + threadIdx.x);
"""
_B11_ROWS = """      {
        const int ta = trips[(size_t)c * n + pix];
        float d = 0.0f;
        for (int t = 0; t < ta; ++t)
          d = d + rsc[base + (size_t)t * n]
              + (float)rmeta[base + (size_t)t * n];
        if (d == 1234.5f) s_acc[threadIdx.x] = d;
      }
"""
_B11_CHAIN = """      {
        const int ta = trips[(size_t)c * n + pix];
        int m = 0;
        for (int t = 0; t < ta; ++t) {
          const int v = rmeta[base + (size_t)t * n];
          if (v == 0x7fffffff) break;
          m = m + v;
        }
        if (m == 1234567) s_acc[threadIdx.x] = (float)m;
      }
"""
_B11_BOUNCE = """      sweep_bounce(acc, acc_e, arow[k], erow[k], a, e, P[k], sc[k], gate[k],
                   g, S);
"""
_B11_S_ONLY = """      S[0] = (e[0] + a[0] * sc[k] * S[0]) * gate[k];
      S[1] = (e[1] + a[1] * sc[k] * S[1]) * gate[k];
      S[2] = (e[2] + a[2] * sc[k] * S[2]) * gate[k];
      if (P[k][0] + P[k][1] + P[k][2] + g[0] == 1234.5f) acc[0] = S[0];
"""
B11_PIXEL_VARIANTS = {
    "as is": {},
    "rows alone": {RA: [(_B11_CALL, _B11_ROWS)]},
    "rmeta chain alone": {RA: [(_B11_CALL, _B11_CHAIN)]},
    "no accumulator adds": {RB: [(_B11_BOUNCE, _B11_S_ONLY)]},
}


# ... and its window kernel (regen_window_kernel), whose window sweep is
# csrc/regen_window.cuh since B13 shares it (regen_adjoint.cu before).
RW = "regen_window.cuh"
_W_SEGMENTS = """      if (work && (t + D < top || top >= tr))
        t += window_segment<DMAX>(cfg, s_alb, s_emi, decode, rows, t, tr,
                                  gp, acc, acc_e);
"""
_W_ROWS_ALONE = """      if (work && (t + D < top || top >= tr)) {
        int k = 1;  // the segment's rows, by the want bit of the next
        while (t + k < tr && !decode.want(rows.meta_of(t + k))) ++k;
        acc[0] = acc[0] + rows.sc_of(t);
        t += k;
      }
"""
_W_BOUNCE = """    sweep_bounce(acc, acc_e, arow[k], erow[k], a, e, P[k], sc[k], gate[k], g,
                 S);
"""
_W_S_ONLY = """    S[0] = (e[0] + a[0] * sc[k] * S[0]) * gate[k];
    S[1] = (e[1] + a[1] * sc[k] * S[1]) * gate[k];
    S[2] = (e[2] + a[2] * sc[k] * S[2]) * gate[k];
    if (P[k][0] + P[k][1] + P[k][2] + g[0] == 1234.5f) acc[0] = S[0];
"""
_W_RING = "  static constexpr int WINDOWS = DMAX <= DRT_SMALL_DEPTH ? 4 : 8;\n"
_W_KERNEL = "__global__ void __launch_bounds__(DRT_BLOCK)\nregen_window_kernel("


def _w_ring(small: int) -> tuple:
    return (_W_RING, _W_RING.replace("? 4 :", f"? {small} :"))


def _w_blocks(n: int) -> tuple:
    return (_W_KERNEL, _W_KERNEL.replace("(DRT_BLOCK)", f"(DRT_BLOCK, {n})"))


# The 8-bounce instance's replay with the segment's rows (and the row
# after them) read from the ring together before it starts, not one
# after the other as the replay reaches them.
_W_REPLAY_START = """  int meta = rows.meta_of(t);
  float P[DMAX][3], sc[DMAX], gate[DMAX];
"""
_W_PRELOAD = """  constexpr int PRE = DMAX <= 8 ? DMAX : 1;
  float pre_sc[PRE];
  int pre_meta[PRE + 1];
  if constexpr (DMAX <= 8) {
#pragma unroll
    for (int k = 0; k <= PRE; ++k) {
      pre_meta[k] = rows.meta_of(t + k);
      if (k < PRE) pre_sc[k] = rows.sc_of(t + k);
    }
  }
  auto sc_at = [&](int k) {
    if constexpr (DMAX <= 8) return pre_sc[k];
    else return rows.sc_of(t + k);
  };
  auto meta_at = [&](int k) {
    if constexpr (DMAX <= 8) return pre_meta[k];
    else return rows.meta_of(t + k);
  };
  int meta = meta_at(0);
  float P[DMAX][3], sc[DMAX], gate[DMAX];
"""
_W_PRELOADED = [
    (_W_REPLAY_START, _W_PRELOAD),
    ("    const float sc_k = rows.sc_of(t + k);\n",
     "    const float sc_k = sc_at(k);\n", "window_segment("),
    ("      meta = rows.meta_of(t + k + 1);\n",
     "      meta = meta_at(k + 1);\n", "window_segment("),
]


def b11_window_variants(ws: str) -> dict:
    """B11's window-kernel variants, with the window sweep's text in
    csrc/<ws>."""
    def at(*pairs):  # edits of the window sweep and of the kernel
        out: dict = {}
        for src, pair in pairs:
            out.setdefault(src, []).append(pair)
        return out

    return {
        "as is": {},
        "windows alone": at((ws, (_W_SEGMENTS, _W_ROWS_ALONE))),
        "no accumulator adds": at((ws, (_W_BOUNCE, _W_S_ONLY))),
        "3 windows": at((ws, _w_ring(3))),
        "3 windows, 6 blocks an SM": at((ws, _w_ring(3)),
                                        (RA, _w_blocks(6))),
        "3 windows, 7 blocks an SM": at((ws, _w_ring(3)),
                                        (RA, _w_blocks(7))),
        "8 windows": at((ws, _w_ring(8))),
        "rows preloaded": {ws: _W_PRELOADED},
    }


def window_source(root: Path) -> str:
    """The file of root's window sweep."""
    return RW if (root / "drt_tpu_torch" / "csrc" / RW).exists() else RA


def b11_variants_of(root: Path) -> dict:
    """B11's variants for the design of root's kernel."""
    text = (root / "drt_tpu_torch" / "csrc" / RA).read_text()
    if "regen_window_kernel" in text:
        return b11_window_variants(window_source(root))
    return B11_PIXEL_VARIANTS


# B13, the mesh regeneration sweep (drt_dyn_regen_sweep,
# csrc/dyn_regen_adjoint.cu): its per-pixel kernel (the first design, and
# the checking build drt_dyn_regen_sweep_lockstep after it) runs
# regen_body.cuh:regen_sweep_chunk as B11's did ...
DA = "dyn_regen_adjoint.cu"
_B13_CALL = _B11_CALL.replace("rmeta + base", "rrow + base")
B13_PIXEL_VARIANTS = {
    "as is": {},
    "rows alone": {DA: [(_B13_CALL, _B11_ROWS.replace("rmeta", "rrow"))]},
    "rrow chain alone": {DA: [(_B13_CALL,
                               _B11_CHAIN.replace("rmeta", "rrow"))]},
    "no accumulator adds": {RB: [(_B11_BOUNCE, _B11_S_ONLY)]},
}


def b13_variants_of(root: Path) -> dict:
    """B13's variants for the design of root's kernel: the per-pixel
    kernel's, or the window sweep's that it shares with B11."""
    text = (root / "drt_tpu_torch" / "csrc" / DA).read_text()
    if "dyn_regen_window_kernel" not in text:
        return B13_PIXEL_VARIANTS
    return {name: edits for name, edits in b11_window_variants(RW).items()
            if name in ("as is", "windows alone", "no accumulator adds")}


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


def trips_shares(torch, trips) -> dict:
    """Of trips i32[C, n_pix] (rows per (pixel, chunk)): the rows the
    pixels need, the rows a window that runs to the largest trips of 32
    (a warp) or 8 (a 32-byte sector) adjacent pixels spans, and
    quantiles of the trips, of each warp's largest and of the gap
    between them."""
    C, n = trips.shape
    t = trips[:, :n - n % 32].reshape(C, -1, 32).float()
    warp = t.amax(dim=2)
    sector = t.reshape(C, -1, 4, 8).amax(dim=3)
    q = torch.tensor([0.1, 0.5, 0.9, 0.99], device=t.device)
    need = float(t.sum())
    return dict(rows_needed=need,
                warp_window_rows=float(warp.sum()) * 32,
                sector_window_rows=float(sector.sum()) * 8,
                need_share_of_warp_window=need / (float(warp.sum()) * 32),
                need_share_of_sector_window=need
                / (float(sector.sum()) * 8),
                trips_quantiles=torch.quantile(t.flatten(), q).tolist(),
                warp_max_quantiles=torch.quantile(warp.flatten(),
                                                  q).tolist(),
                gap_quantiles=torch.quantile(
                    (warp[..., None] - t).flatten()[:1 << 24], q).tolist(),
                trips_max=float(t.max()))


def child_b11(root: Path, full: bool) -> None:
    """Time B11 of the variant whose package is under root at the main
    and CLI shapes; print one JSON object."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.scene import albedo_table, emission_table
    from drt_tpu_torch.utils import native

    dev = torch.device("cuda")
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(11)
    scene, params, cam = cbox.build(device=dev)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    out, trips_at = {}, {}
    window = hasattr(rg, "regen_sweep_form")
    if full:
        out["ptxas"] = {RA: ptxas_lines(native.log_path(RA).read_text(),
                                        "regen_")}
        acc = 4 * 128 * 3 * (alb.shape[0] - 1 + emi.shape[0] - 1)
        kernels = {f"regen_sweep_kernel<{d}>": (f"regen_sweep_kernel<{d}>",
                                                 acc) for d in (8, 32)}
        if window:  # its ring: 4 warps x (rsc, rmeta) x rows x 32 lanes
            kernels.update({
                f"regen_window_kernel<{d}>": (
                    f"regen_window_kernel<{d}>",
                    acc + 4 * 2 * rg.WINDOW_ROWS * rg.ring_windows(d) * 32
                    * 4) for d in (8, 32)})
        out["occupancy"] = ablate.occupancy(native, root, RA, kernels)
    for name, shape in (("B11 main shape", MAIN), ("B11 CLI shape", CLI)):
        cfg = RenderConfig(**shape)
        C = cfg.spp_chunks
        npix = cfg.width * cfg.height
        _, rsc, rmeta, trips = rg.make_regen_tracer(
            scene, cam, cfg, fastmath=True, collect=True, n_chunks=C)(
            alb, emi, seeds)
        g = torch.rand((3, npix), generator=gen, device=dev) / cfg.spp
        sweep = rg.make_regen_sweep_adjoint(scene, cfg, n_chunks=C)
        ms, win = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rmeta, trips,
                                               g))
        rows = int(trips.sum())
        out[name] = dict(ms=ms, windows=win, rows=rows,
                         gb_s=8 * rows / ms / 1e6)
        if window and full:
            out[name]["form"] = rg.regen_sweep_form(cfg, alb, emi)
        if full:
            trips_at[name] = trips_shares(torch, trips)
        del rsc, rmeta, trips
        torch.cuda.empty_cache()
    if full:
        out["rows"] = trips_at
    print(json.dumps(out), flush=True)


def child_b13(root: Path, full: bool) -> None:
    """Time B13 of the variant whose package is under root at the mesh's
    main shape, on one chunk of it (a retrace's launch) and at the
    32-bounce shape, and its checking build where the checkout has one;
    print one JSON object."""
    sys.path.insert(0, str(root))
    import torch

    from drt_tpu_torch.config import RenderConfig
    from drt_tpu_torch.models import gallery
    from drt_tpu_torch.ops import dynkernel as dk
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import regen as rg
    from drt_tpu_torch.scene import albedo_table, emission_table
    from drt_tpu_torch.utils import native

    dev = torch.device("cuda")
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(11)
    scene, params, cam = gallery.build_mesh(3, device=dev)
    ds = dk.DynScene(scene)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    out, trips_at = {}, {}
    window = hasattr(dr, "dyn_regen_sweep_form")
    if full:
        out["ptxas"] = {DA: ptxas_lines(native.log_path(DA).read_text(),
                                        "dyn_regen_")}
        acc = 4 * 128 * 3 * (alb.shape[0] - 1 + emi.shape[0] - 1)
        kernels = {f"dyn_regen_sweep_kernel<{d}>": (
            f"dyn_regen_sweep_kernel<{d}>", acc) for d in (8, 32)}
        if window:  # its ring, then its tables
            kernels.update({
                f"dyn_regen_window_kernel<{d}>": (
                    f"dyn_regen_window_kernel<{d}>",
                    acc + 4 * 2 * rg.WINDOW_ROWS * rg.ring_windows(d) * 32
                    * 4 + 12 * (alb.shape[0] + emi.shape[0]))
                for d in (8, 32)})
        out["occupancy"] = ablate.occupancy(native, root, DA, kernels)
    main = RenderConfig(**MESH)
    chunk = RenderConfig(width=main.width, height=main.height,
                         spp=main.spp // main.spp_chunks,
                         max_depth=main.max_depth)
    for name, cfg, base in (("B13 main shape", main, 0),
                            ("B13 one chunk (chunk 1)", chunk, chunk.spp),
                            ("B13 32-bounce shape", RenderConfig(**CLI), 0)):
        C = cfg.spp_chunks
        npix = cfg.width * cfg.height
        _, rsc, rrow, trips = dr.make_dyn_regen_tracer(
            ds, cam, cfg, fastmath=True, collect=True, n_chunks=C)(
            alb, emi, seeds, base)
        g = torch.rand((3, npix), generator=gen, device=dev) / cfg.spp
        sweep = dr.make_dyn_regen_sweep_adjoint(ds, cfg, n_chunks=C)
        ms, win = cuda_ms(torch, lambda: sweep(alb, emi, rsc, rrow, trips,
                                               g))
        rows = int(trips.sum())
        out[name] = dict(ms=ms, windows=win, rows=rows,
                         gb_s=8 * rows / ms / 1e6)
        if window:
            lock = dr.make_dyn_regen_sweep_adjoint(ds, cfg, n_chunks=C,
                                                   build="lockstep")
            ms, win = cuda_ms(torch, lambda: lock(alb, emi, rsc, rrow, trips,
                                                  g))
            out[name].update(form=dr.dyn_regen_sweep_form(cfg, alb, emi),
                             lockstep_ms=ms, lockstep_windows=win)
        if full:
            trips_at[name] = trips_shares(torch, trips)
        del rsc, rrow, trips
        torch.cuda.empty_cache()
    if full:
        out["rows"] = trips_at
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernel", default="b3", choices=("b3", "b11", "b13"),
                    help="b3: the stored-residual sweeps B3 and B8; b11: "
                         "the regeneration sweep; b13: the mesh "
                         "regeneration sweep")
    ap.add_argument("--variants", default="",
                    help="comma-separated names of the variants to time "
                         "(default: all of the design's)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--full", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    regen = args.kernel != "b3"
    if args.child:
        dict(b3=child, b11=child_b11, b13=child_b13)[args.kernel](
            Path(args.child), args.full)
        return 0
    if not ablate.card("ablate_sweep", args.label):
        return 2
    root = Path(args.root).resolve()
    variants = dict(b3=variants_of, b11=b11_variants_of,
                    b13=b13_variants_of)[args.kernel](root)
    if args.variants:
        variants = {name: variants[name]
                    for name in args.variants.split(",")}
    roots = {name: ablate.make_variant(root, "ablate_sweep", name, edits)
             for name, edits in variants.items()}
    sources = dict(b3=(F, D), b11=(RA, "regen_tracer.cu"),
                   b13=(DA, "dyn_regen_tracer.cu"))[args.kernel]
    kernels = {RA: "regen_", DA: "dyn_regen_", F: _KERNEL[F],
               D: _KERNEL[D]}
    if not ablate.build_variants(roots.values(), sources):
        return 1
    for run, name in enumerate(ablate.in_turns(variants)):
        res = ablate.run_child(__file__, roots[name], "--kernel",
                               args.kernel,
                               *(["--full"] if run == 0 else []))
        if res is None:
            return 1
        got = json.loads(res.stdout.splitlines()[-1])
        for what in ("ptxas", "rows", "paths", "occupancy"):
            if what in got:
                print(json.dumps({"kind": what, "label": args.label,
                                  "variant": name, what: got.pop(what)}),
                      flush=True)
        print(json.dumps({"kind": "ablation", "label": args.label,
                          "variant": name, "run": run, "ms": got}),
              flush=True)
    # The report of every variant's build, for the registers it took.
    for name, r in roots.items():
        for src in sources[:1] if regen else sources:
            log = next((r / "drt_tpu_torch" / "_build").glob(
                f"*/{Path(src).stem}.log")).read_text()
            print(json.dumps({"kind": "ptxas", "label": args.label,
                              "variant": name, "source": src,
                              "lines": ptxas_lines(log, kernels[src])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
