"""Reduction of a `torch.profiler` trace to the record the per-layer
metric readers read: device time of the program's kernels and of the
other device operations, the busy and idle time of the profiled window,
the device operations that took most time, and the idle gaps by what the
host was doing."""

from __future__ import annotations

import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_MARK = "drtbench.profiled"


def kernel_names(csrc: Path) -> set:
    """The `__global__` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for path in sorted(csrc.glob("*.cu*")) + sorted(csrc.glob("*.inc")):
        names.update(pat.findall(path.read_text()))
    return names


def short(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(trace_file: Path, program_kernels: set) -> dict:
    """The record of one profiled window (times in seconds)."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    marks = [e for e in events if e.get("name") == WINDOW_MARK
             and e.get("ph") == "X"]
    if not marks:
        raise RuntimeError(f"no {WINDOW_MARK} span in the trace")
    w0 = min(float(m["ts"]) for m in marks)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and float(e["ts"]) >= w0]
    if not dev:
        return {"device_ops": 0}
    w1 = max(float(m["ts"]) + float(m["dur"]) for m in marks)
    w1 = max(w1, max(float(e["ts"]) + float(e["dur"]) for e in dev))
    pat = re.compile(r"\b(" + "|".join(sorted(program_kernels)) + r")\b") \
        if program_kernels else None
    program_s = other_s = 0.0
    by_name = {}
    for e in dev:
        d = float(e["dur"]) * 1e-6
        name = (short(e["name"]) if e["cat"] == "kernel"
                else e["name"].split(" (")[0])
        by_name[name] = by_name.get(name, 0.0) + d
        if e["cat"] == "kernel" and pat is not None and pat.search(e["name"]):
            program_s += d
        else:
            other_s += d
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    if busy and busy[0][0] > w0:
        gaps.insert(0, (w0, busy[0][0]))
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != WINDOW_MARK]
    host.sort(key=lambda e: float(e["ts"]))
    idle = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inner = [h for h in host if float(h["ts"]) <= mid
                 <= float(h["ts"]) + float(h["dur"])]
        label = (min(inner, key=lambda h: float(h["dur"]))["name"] if inner
                 else "host between calls")
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": len(dev), "program_kernel_s": program_s,
            "tensor_ops_s": other_s, "busy_s": busy_s,
            "window_s": (w1 - w0) * 1e-6,
            "breakdown": {"device_ops": [list(kv) for kv in top],
                          "idle_gaps": [list(kv) for kv in gaps_top]}}
