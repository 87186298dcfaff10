"""The benchmark of drt_tpu_torch: one run of one cell.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(`configs/<name>.json`: the scene, how the program and the reference
build it, and the render settings) and a traffic mix
(`traffic/<name>.json`: the loop driver `drivers/<driver>.py` and its
parameters); `checks/<cell>.json` holds how much of the window's output
the check compares and each compared number's limit; each per-layer
metric is read by `metrics/<metric>.py`. All are found by name, so a
later cell, mix, driver or metric is a new file.

A run: set-up (the driver builds the program's objects and warms every
shape the cell uses), a measured window of `--seconds`, with `--trace 1`
a profiled stretch after it, then the check of what the window produced
against the plain reference, and one result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "drtbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "drt_tpu")


def _process_age() -> float:
    """Seconds since this process started (/proc), 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0, _T0 = _process_age(), time.perf_counter()


def since_start() -> float:
    return _AGE0 + time.perf_counter() - _T0


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Cell:
    """Everything one cell's run reads from the benchmark's files."""

    def __init__(self, name: str, config_over=None, traffic_over=None,
                 checks_over=None):
        bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"drtbench: no workload {name!r} in "
                             f"BENCHMARK.json; it has {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = _merge(load_json(ROOT / conf["file"]), config_over)
        self.traffic = _merge(load_json(
            BENCH / "traffic" / f"{self.workload['traffic']}.json"),
            traffic_over)
        self.checks = _merge(load_json(BENCH / "checks" / f"{name}.json"),
                             checks_over)
        self.chips = int(self.workload["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def window(loop, seconds: float) -> dict:
    """Units back to back until `seconds` have passed; the window ends
    when the unit running at that moment completes."""
    import torch

    on_card = loop.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units.append(loop.unit())
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return {"seconds": t1 - t0, "units": units, "peak_bytes": peak}


def end_to_end(cell: Cell, loop, win: dict, setup_s: float) -> dict:
    """Every end-to-end metric that the loop's units give, over the whole
    window: rates are all the work over all the time, the tail is over
    every unit."""
    units = win["units"]
    done = sum(u["steps"] - u["failed"] for u in units)
    rays = loop.rays_per_step * done
    values = {"setup_s": setup_s,
              "peak_mem_gib": win["peak_bytes"] / 2 ** 30,
              f"{loop.kind}_mrays_s": rays / win["seconds"] / 1e6}
    if loop.kind == "render":
        values["render_p95_ms"] = 1e3 * percentile(
            [u["latency"] for u in units], 95)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def profiled(cell: Cell, loop, win: dict, reference) -> tuple[dict, dict]:
    """A profiled stretch of the traffic's `profile_units` units after the
    window, reduced to the record the metric readers read; and the
    breakdown of the result line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from drtbench import program, trace, work

    n = int(cell.traffic["profile_units"])
    renders = loop.next_renders()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_MARK):
            for _ in range(n):
                loop.unit()
            torch.cuda.synchronize()
    counts = {"renders": len(renders)}
    for seeds in renders:
        reference.paths(seeds, counts=counts)
    tmp = Path(tempfile.mkdtemp(prefix="drtbench-"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        names = trace.kernel_names(program.csrc())
        rec = trace.reduce(path, names)
    finally:
        for p in tmp.iterdir():
            p.unlink()
        tmp.rmdir()
    r = cell.config["render"]
    launches = work.kernels(
        loop.kind, counts, shapes=reference.scene.shape_type.shape[0],
        rows=reference.albedo.shape[0] + reference.emission.shape[0] + 2,
        slots=reference.npix * (r["spp"] // r.get("spp_chunks", 1)),
        pixels=reference.npix)
    bound_s, bound_by = work.bound_seconds(launches)
    steps = n * loop.steps_per_unit
    units = win["units"]
    rec.update(kind=loop.kind, units=n, steps=steps, counts=counts,
               bound_s_per_step=bound_s, bound_by=bound_by,
               enqueue_s_per_step=sum(u["enqueue"] for u in units)
               / sum(u["steps"] for u in units))
    breakdown = rec.pop("breakdown", None)
    return rec, breakdown


def per_layer(cell: Cell, rec: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py",
                          "drtbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def run(argv=None, device=None, config_over=None, traffic_over=None,
        checks_over=None):
    """One run; returns (exit code, result dict or None). device=None
    asks for the card and refuses to run without it; a test passes
    device="cpu" with small shapes and the plain backends."""
    ap = argparse.ArgumentParser(prog="drtbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, config_over, traffic_over, checks_over)
    t_start = since_start()

    import torch

    parts = {"interpreter": t_start, "import torch": since_start() - t_start}

    if device is None:
        if not torch.cuda.is_available():
            print("drtbench: no CUDA device is visible; the benchmark runs "
                  "on the card only", file=sys.stderr)
            return 1, None
        if torch.cuda.device_count() < cell.chips:
            print(f"drtbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} are visible",
                  file=sys.stderr)
            return 1, None
        device = "cuda"
    device = torch.device(device)
    t0 = since_start()
    torch.zeros(1, device=device)
    parts["device context"] = since_start() - t0
    if args.trace and device.type != "cuda":
        print("drtbench: --trace 1 reads the card's profiler trace",
              file=sys.stderr)
        return 1, None
    driver = load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                         "drtbench_driver_" + cell.traffic["driver"])
    loop = driver.Loop(cell, args.seed, device)
    setup_s = since_start()
    parts.update(loop.setup_parts)
    win = window(loop, args.seconds)
    from drtbench.reference.image import Reference

    result = {"correct": False, "attempted": sum(u["steps"] for u in
                                                 win["units"]),
              "failed": sum(u["failed"] for u in win["units"])}
    if args.trace:
        reference = Reference(cell.config, device)
        rec, breakdown = profiled(cell, loop, win, reference)
        metrics = per_layer(cell, rec)
    else:
        reference = None
        metrics = end_to_end(cell, loop, win, setup_s)
        breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": win["peak_bytes"]}
    loop.release()
    t_check = time.perf_counter()
    if reference is None:
        reference = Reference(cell.config, device)
    numbers = loop.judge(reference, cell.checks)
    del reference
    print(f"drtbench: {cell.name} seed {args.seed}: set-up {setup_s!r} s, "
          f"window {win['seconds']!r} s, {len(win['units'])} units, check "
          f"{time.perf_counter() - t_check!r} s; set-up parts (s) {parts}",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"drtbench: the run loaded {bad}; the benchmark measures "
              "drt_tpu_torch alone", file=sys.stderr)
        return 1, None
    checks = {k: {"value": v, "limit": cell.checks["limits"][k]}
              for k, v in numbers.items()}
    result["correct"] = (result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        dev_info.update(busy_s=rec.get("busy_s", 0.0),
                        window_s=rec.get("window_s", 0.0))
        result["breakdown"] = breakdown
        result["work"] = {k: rec[k] for k in ("counts", "bound_s_per_step",
                                              "bound_by")}
        print(f"drtbench: work a step {result['work']}", file=sys.stderr)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code
