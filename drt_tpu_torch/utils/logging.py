"""Structured metrics logging: per-step metrics to a stream and a JSONL
file, for the inverse-rendering loop and benches.

The port of `drt_tpu.utils.logging`, with the same record format: one
JSON object a line, `{"step", "t", **metrics}`, every value that has
`__float__` written through `float()`. `float()` of a CUDA tensor waits
for the device to finish the work that made it, so log after the work
you want to overlap, not inside it (see `optim.make_train_block`).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None,
                 stream: IO | None = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._stream = stream if stream is not None else sys.stderr
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._stream:
            parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in rec.items()
                             if k != "t")
            print(parts, file=self._stream)

    def close(self) -> None:
        if self._file:
            self._file.close()


class Progress:
    """Percent-complete progress line (reference: src/render.cpp:84-85)."""

    def __init__(self, total: int, stream: IO | None = None):
        self.total = total
        self._stream = stream if stream is not None else sys.stderr

    def update(self, done: int) -> None:
        pct = 100.0 * done / max(self.total, 1)
        print(f"{pct:5.2f}%", end="\r", file=self._stream, flush=True)

    def finish(self) -> None:
        print(file=self._stream)
