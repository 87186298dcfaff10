"""Inverse rendering: recover scene parameters from a target image.

The port of `drt_tpu.optim`: Adam over the albedo and emission tables
against a ground-truth render, differentiated through radiative backprop.
Adam is written out here in optax's form (`optax.adam`: bias-corrected
moments, update `-lr * m_hat / (sqrt(v_hat) + eps)`), so a trajectory
follows the JAX package's step for step from the same state.
"""

from __future__ import annotations

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
    `length` optimizer steps in a row. The JAX package folds them into
    one `lax.scan` dispatch; PyTorch launches eagerly and the host never
    waits for the device between steps, so there is no scan to fold on
    this side and this is the same loop as `length` calls of the step."""
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
                   metrics_jsonl: str | None = None):
    """Run the recovery loop as a host loop. Returns (final params,
    per-step metrics dict of stacked tensors `loss`, `grad_norm`).

    gen: the `torch.Generator` the steps draw their seeds from.
    log_every: print the loss every so many steps (reading it waits for
    the device). Checkpoints and the metrics file are not ported yet
    and raise; the JAX package's `steps_per_call` has no counterpart
    (see `make_train_block`).
    """
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint and resume are not ported "
                                  "yet: ROADMAP A9 (utils/checkpoint)")
    if metrics_jsonl is not None:
        raise NotImplementedError("the metrics JSONL stream is not ported "
                                  "yet: ROADMAP A10 (utils/logging)")
    optimizer = Adam(learning_rate)
    step_fn = make_train_step(scene, cfg, cam, target, optimizer, mesh=mesh,
                              backend=backend)
    state = init_state(init_params, optimizer)
    losses, grad_norms = [], []
    for i in range(steps):
        state, metrics = step_fn(state, gen)
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
        if log_every and (i % log_every == 0 or i == steps - 1):
            (logger or print)(f"step {i:4d} loss {float(losses[-1]):.6g}")
    if not losses:
        empty = torch.zeros(0)
        return state.params, {"loss": empty, "grad_norm": empty}
    return state.params, {"loss": torch.stack(losses),
                          "grad_norm": torch.stack(grad_norms)}
