"""What the benchmark takes from the program: its scene constructors,
render configuration, renderers and trainer, built from a configuration
file; and the seeds the benchmark hands to both the program and the
reference."""

from __future__ import annotations

import importlib
import time
from pathlib import Path

import torch


def build(config: dict, device):
    """(scene, params, camera, RenderConfig) of the program, from the
    configuration's `scene.program` ("module:function") and `render`."""
    from drt_tpu_torch.config import RenderConfig

    mod, fn = config["scene"]["program"].split(":")
    scene, params, cam = getattr(importlib.import_module(mod), fn)(
        device=device, **config["scene"].get("kwargs", {}))
    return scene, params, cam, RenderConfig(**config["render"])


def csrc() -> Path:
    """The program's CUDA sources, whose kernel names the trace reads."""
    import drt_tpu_torch

    return Path(drt_tpu_torch.__file__).resolve().parent / "csrc"


def draw_seeds(gen: torch.Generator) -> torch.Tensor:
    """The (camera, bounce) seed pair i32[2] drawn from `gen`: the draw the
    program's trainer makes for each render (`cli` and `optim` take their
    seeds so), which the reference repeats to follow it."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen,
                         dtype=torch.int64).to(torch.int32)


class Stopwatch:
    """Seconds of each part of a set-up, the device synchronized at each
    lap."""

    def __init__(self, device):
        self.device, self.parts = device, {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now
