"""Profiling and throughput counters.

The port of `drt_tpu.utils.profiling`: a `torch.profiler` trace written
as a Chrome trace (Perfetto, chrome://tracing), a wall-clock timer that
waits for the device, and rays/s for renderer workloads.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch

from drt_tpu_torch.utils.debug import leaves_with_path

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's host operations and, where a card is visible,
    its kernels; write the Chrome trace to `logdir/trace.json` when the
    block ends. Yields the `torch.profiler.profile` (its `events()`,
    `key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))


def _wait_for(out) -> None:
    """Synchronize the device of each CUDA tensor in `out`; nothing for
    CPU tensors."""
    devices = {leaf.device for _, leaf in leaves_with_path(out)
               if torch.is_tensor(leaf) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn, *args, warmup: int = 1, reps: int = 3):
    """Best-of-reps wall-clock seconds of `fn(*args)`, each call ended by
    `torch.cuda.synchronize()` of its outputs' device (no synchronize for
    outputs on the CPU). Returns (best_seconds, last_output)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
        _wait_for(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _wait_for(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds


def mrays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds / 1e6
