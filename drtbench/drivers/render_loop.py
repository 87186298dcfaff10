"""Closed loop of one client rendering images: each image at a new seed
pair drawn from the run's seed, through `make_renderer(...,
differentiable=False)`, synchronized before the next (`cli render` and
preview renders). A unit is one image."""

from __future__ import annotations

import time

import numpy as np
import torch

from drtbench import check, program


class Loop:
    kind = "render"
    steps_per_unit = 1

    def __init__(self, cell, seed: int, device):
        from drt_tpu_torch.parallel.render import make_renderer

        t = cell.traffic
        self.device, self.seed = device, seed
        clock = program.Stopwatch(device)
        self.scene, self.params, cam, self.cfg = program.build(
            cell.config, device)
        clock.lap("scene")
        self.render = make_renderer(self.scene, self.cfg, cam,
                                    differentiable=False,
                                    backend=t["backend"])
        clock.lap("renderer")
        self.rays_per_step = self.cfg.width * self.cfg.height * self.cfg.spp
        # Which images of the window the check keeps: drawn from the seed
        # among the first `image_span` (the window completes many more).
        ch = cell.checks
        rng = np.random.default_rng([seed, 2])
        self.keep = set(rng.choice(ch["image_span"], ch["images"],
                                   replace=False).tolist())
        self.kept = []
        warm = torch.Generator().manual_seed(seed ^ 0x5EED)
        for _ in range(int(t["warmup"])):
            self.render(self.params, program.draw_seeds(warm))
        clock.lap("warm-up (kernel build and load at the first call)")
        self.setup_parts = clock.parts
        self.gen = torch.Generator().manual_seed(seed)
        self.count = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self) -> dict:
        seeds = program.draw_seeds(self.gen)
        t0 = time.perf_counter()
        img = self.render(self.params, seeds)
        t1 = time.perf_counter()
        self._sync()
        t2 = time.perf_counter()
        if self.count in self.keep:
            # On the host, so that the window's memory peak is the
            # renderer's alone.
            self.kept.append((seeds.tolist(), img.cpu()))
        self.count += 1
        return {"latency": t2 - t0, "enqueue": t1 - t0, "steps": 1,
                "failed": 0}

    def next_renders(self) -> list:
        """The seed pairs of the next unit's renders."""
        g = torch.Generator()
        g.set_state(self.gen.get_state())
        return [program.draw_seeds(g).tolist()]

    def release(self):
        """Free the program's objects; the kept images stay."""
        del self.render, self.scene
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, reference, checks: dict, images=None) -> dict:
        """The compared numbers of the kept images (or of `images`, a list
        of (seeds, image) put in their place) against the reference."""
        return check.render_numbers(reference, images or self.kept,
                                    checks, self.seed)
