"""The `cli invert` loop: the target rendered once at set-up from the
true tables at seed + 1, the start at albedo 0.25 and emission 0.5, then
`optim.make_train_block` with the paired loss and Adam, blocks of
`steps_per_call` optimizer steps back to back, the losses read after
each block as `optim.inverse_render` reads them, no checkpoint. A unit
is one block. Set-up drives the same block function through its first
block, a call of the window's own size, which the check follows."""

from __future__ import annotations

import time

import torch

from drtbench import check, program


class Loop:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        from drt_tpu_torch.optim import Adam, init_state, make_train_block
        from drt_tpu_torch.parallel.render import make_renderer
        from drt_tpu_torch.scene import Params

        t = cell.traffic
        self.device, self.seed, self.traffic = device, seed, t
        clock = program.Stopwatch(device)
        scene, params, cam, self.cfg = program.build(cell.config, device)
        clock.lap("scene")
        self.rays_per_step = (2 * self.cfg.width * self.cfg.height
                              * self.cfg.spp)
        self.steps_per_unit = int(t["steps_per_call"])
        target = make_renderer(scene, self.cfg, cam, differentiable=False,
                               backend=t["backend"])(
            params,
            program.draw_seeds(torch.Generator().manual_seed(seed + 1)))
        clock.lap("target (tracer build and load at the first call)")
        init = Params(torch.full_like(params.albedo, t["init_albedo"]),
                      torch.full_like(params.emission, t["init_emission"]))
        self.run = make_train_block(scene, self.cfg, cam, target,
                                    Adam(t["lr"]), backend=t["backend"],
                                    paired=t["loss"] == "paired")
        self.gen = torch.Generator().manual_seed(seed)
        state = init_state(init)
        # The check's block: the window's own call at its own size.
        start = [p.detach().clone() for p in state.params]
        state, m = self.run(state, self.gen, self.steps_per_unit)
        self.first = check.Steps(
            m["loss"].tolist(), [x.clone() for x in state.opt_state.mu],
            [x.clone() for x in state.opt_state.nu], start,
            [p.detach().clone() for p in state.params])
        clock.lap("first block (adjoint build and load)")
        for _ in range(int(t["warmup_units"])):
            state, m = self.run(state, self.gen, self.steps_per_unit)
            m["loss"].cpu()
        clock.lap("warm-up")
        self.state = state
        self.setup_parts = clock.parts

    def unit(self) -> dict:
        t0 = time.perf_counter()
        self.state, m = self.run(self.state, self.gen, self.steps_per_unit)
        t1 = time.perf_counter()
        losses = m["loss"].cpu()
        t2 = time.perf_counter()
        return {"latency": t2 - t0, "enqueue": t1 - t0,
                "steps": self.steps_per_unit,
                "failed": int((~torch.isfinite(losses)).sum())}

    def next_renders(self) -> list:
        """The seed pairs of the next step's two renders."""
        g = torch.Generator()
        g.set_state(self.gen.get_state())
        return [program.draw_seeds(g).tolist() for _ in range(2)]

    def release(self):
        del self.run, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, reference, checks: dict, run=None, ref=None) -> dict:
        """The compared numbers of the set-up's first block (or of `run`,
        a `check.Steps` put in its place) against the reference following
        it (or `ref`, its steps already followed)."""
        return check.train_numbers(reference, run or self.first,
                                   self.traffic, self.seed, ref)
