"""Inverse rendering: recover scene parameters from a target image.

The port of `drt_tpu.optim`: Adam over the albedo and emission tables
against a ground-truth render, differentiated through radiative backprop.
Adam is written out here in optax's form (`optax.adam`: bias-corrected
moments, update `-lr * m_hat / (sqrt(v_hat) + eps)`), so a trajectory
follows the JAX package's step for step from the same state.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from drt_tpu_torch.camera import Camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import seeds_from_generator
from drt_tpu_torch.parallel.render import make_renderer
from drt_tpu_torch.scene import (DEFAULT_DEVICE, Params, Scene,
                                 checked_device)


class Adam(NamedTuple):
    """Hyperparameters of `optax.adam(learning_rate)` with its defaults."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class AdamState(NamedTuple):
    mu: Params  # first moments
    nu: Params  # second moments


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamState
    step: int


def init_state(params: Params, optimizer: Adam | None = None) -> TrainState:
    """Step 0 with zero Adam moments. `optimizer` is accepted for the JAX
    signature; the moments' shape does not depend on it."""
    zeros = Params(*(torch.zeros_like(p) for p in params))
    return TrainState(Params(*(p.detach() for p in params)),
                      AdamState(zeros, zeros), 0)


def state_from_numpy(albedo, emission,
                     device=DEFAULT_DEVICE) -> TrainState:
    """A fresh `TrainState` (moments zero, step 0) from numpy parameter
    arrays, dtypes kept: the start a JAX/optax trajectory also takes."""
    device = checked_device(device)
    return init_state(Params(
        torch.as_tensor(np.array(albedo), device=device),
        torch.as_tensor(np.array(emission), device=device)))


def _adam_update(opt: Adam, grads: Params, state: AdamState, count: int):
    """optax.scale_by_adam then scale(-lr); `count` is the step number
    after this update (1 on the first)."""
    mu = Params(*(opt.b1 * m + (1 - opt.b1) * g
                  for m, g in zip(state.mu, grads)))
    nu = Params(*(opt.b2 * v + (1 - opt.b2) * (g * g)
                  for v, g in zip(state.nu, grads)))
    c1 = 1 - opt.b1 ** count
    c2 = 1 - opt.b2 ** count
    updates = Params(*(-opt.learning_rate * (m / c1)
                       / (torch.sqrt(v / c2) + opt.eps)
                       for m, v in zip(mu, nu)))
    return updates, AdamState(mu, nu)


def make_train_step(scene: Scene, cfg: RenderConfig, cam: Camera,
                    target: torch.Tensor, optimizer: Adam, mesh=None,
                    paired: bool = True, backend: str = "auto",
                    render=None):
    """Build `(state, gen) -> (state, metrics)`: one Adam step on the L2
    image loss, differentiated through radiative backprop. `gen` is a
    `torch.Generator` that the step draws its render seeds from.

    paired=True uses the dual-buffer loss mean((X1-T)(X2-T)) with two
    independent renders per step: a plain MC-MSE loss mean((X-T)^2) also
    penalizes Var(X), which biases recovered albedos down at finite spp;
    the paired product is an unbiased estimator of the true
    expected-image loss.

    render: a differentiable `render(params, seeds) -> image` to use in
    place of `make_renderer(scene, cfg, cam, backend=backend)`, e.g. a
    tape-driven one that ignores the seeds.
    """
    if render is None:
        render = make_renderer(scene, cfg, cam, mesh=mesh,
                               differentiable=True, backend=backend)

    def loss_fn(params: Params, gen):
        if paired:
            img1 = render(params, seeds_from_generator(gen))
            img2 = render(params, seeds_from_generator(gen))
            return torch.mean((img1 - target) * (img2 - target))
        img = render(params, seeds_from_generator(gen))
        return torch.mean((img - target) ** 2)

    def step(state: TrainState, gen):
        leaves = Params(*(p.detach().requires_grad_() for p in state.params))
        loss = loss_fn(leaves, gen)
        grads = Params(*torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = _adam_update(optimizer, grads,
                                              state.opt_state,
                                              state.step + 1)
            # Albedo and emission are physically non-negative; albedo <= 1
            # for energy conservation (src/render.cpp:26-29 keeps its
            # sample params in [0, 1]).
            params = Params(
                albedo=(state.params.albedo + updates.albedo).clamp(0.0,
                                                                    1.0),
                emission=(state.params.emission
                          + updates.emission).clamp_min(0.0))
            grad_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_train_block(scene: Scene, cfg: RenderConfig, cam: Camera,
                     target: torch.Tensor, optimizer: Adam, mesh=None,
                     paired: bool = True, backend: str = "auto",
                     render=None):
    """Build `run(state, gen, length) -> (state, stacked_metrics)`:
    `length` optimizer steps in a row, bit-equal to `length` calls of the
    step (the same draws from `gen`). The JAX package's block is one
    `lax.scan` dispatch that syncs once; its counterpart here is that the
    host reads nothing from the device inside a block: the steps' kernels
    are enqueued back to back, each step's metrics stay on the device,
    and they are stacked there, for the caller to read (and log) after
    the block."""
    step = make_train_step(scene, cfg, cam, target, optimizer, mesh=mesh,
                           paired=paired, backend=backend, render=render)

    def run(state: TrainState, gen, length: int):
        metrics = []
        for _ in range(int(length)):
            state, m = step(state, gen)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in ("loss", "grad_norm")}

    return run


def inverse_render(scene: Scene, cfg: RenderConfig, cam: Camera,
                   target: torch.Tensor, init_params: Params, gen,
                   steps: int = 200, learning_rate: float = 2e-2,
                   mesh=None, log_every: int = 0, logger=None,
                   backend: str = "auto", checkpoint_dir: str | None = None,
                   checkpoint_every: int = 50,
                   metrics_jsonl: str | None = None,
                   steps_per_call: int = 1):
    """Run the recovery loop. Returns (final params, per-step metrics
    dict of stacked tensors `loss`, `grad_norm`: of the steps this call
    ran, none if a checkpoint was already past `steps`).

    gen: the `torch.Generator` the steps draw their seeds from.
    checkpoint_dir: if given, resumes from the latest checkpoint there
    (params, Adam moments, step and `gen`'s state: `utils.checkpoint`)
    and saves every `checkpoint_every` steps and at the last. A resume
    sets `gen` to the saved state (`gen.set_state`), so the steps after
    it draw the seeds an uninterrupted run draws, bit for bit: the seeds
    come from the generator's stream, not from (seed, step).
    log_every: log the loss every so many steps and at the last, to
    `metrics_jsonl` (a `MetricsLogger` JSONL file, the grad norm with
    it) if given, else as a line to `logger` (default print). Reading a
    loss waits for the device.
    steps_per_call: optimizer steps per block (`make_train_block`), in
    which the host reads nothing from the device; bit-equal to 1. Blocks
    shorten so that checkpoints still land exactly on `checkpoint_every`
    boundaries.
    """
    from drt_tpu_torch.utils import checkpoint
    from drt_tpu_torch.utils.logging import MetricsLogger

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    optimizer = Adam(learning_rate)
    block_fn = make_train_block(scene, cfg, cam, target, optimizer,
                                mesh=mesh, backend=backend)
    state = init_state(init_params, optimizer)
    start = 0
    if checkpoint_dir is not None:
        last = checkpoint.latest_step(checkpoint_dir)
        if last is not None:
            state, gen_state, start = checkpoint.restore_dir(
                checkpoint_dir, state, last)
            if gen_state is None:
                raise ValueError(f"checkpoint {last} under {checkpoint_dir} "
                                 "holds no generator state")
            gen.set_state(gen_state)

    losses, grad_norms = [], []
    with (contextlib.closing(MetricsLogger(metrics_jsonl)) if metrics_jsonl
          else contextlib.nullcontext()) as mlog:
        i = start
        while i < steps:
            n = min(steps - i, steps_per_call)
            if checkpoint_dir is not None and checkpoint_every:
                # Shorten the block so the save still lands exactly on the
                # checkpoint_every boundary (bit-exact resume).
                n = min(n, checkpoint_every - i % checkpoint_every)
            state, metrics = block_fn(state, gen, n)
            for j in range(n):  # after the block: reading a loss waits
                loss, grad_norm = metrics["loss"][j], metrics["grad_norm"][j]
                losses.append(loss)
                grad_norms.append(grad_norm)
                k = i + j
                if log_every and (k % log_every == 0 or k == steps - 1):
                    if mlog:
                        mlog.log(k, loss=loss, grad_norm=grad_norm)
                    else:
                        (logger or print)(f"step {k:4d} loss "
                                          f"{float(loss):.6g}")
            i += n
            if (checkpoint_dir is not None and checkpoint_every
                    and (i % checkpoint_every == 0 or i == steps)):
                checkpoint.save_dir(checkpoint_dir, state, gen, i)
    if not losses:
        empty = torch.zeros(0)
        return state.params, {"loss": empty, "grad_norm": empty}
    return state.params, {"loss": torch.stack(losses),
                          "grad_norm": torch.stack(grad_norms)}
