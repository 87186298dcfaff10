"""Checkpoint and resume for the inverse-rendering loop.

The port of `drt_tpu.utils.checkpoint`: resumable state is the
parameters, the Adam moments, the step and the state of the generator
the steps draw their seeds from. One checkpoint is an npz file in the
JAX package's layout, leaf for leaf: `leaf_0` params.albedo, `leaf_1`
params.emission, `leaf_2` Adam's count (i32[], equal to the step),
`leaf_3`/`leaf_4` mu, `leaf_5`/`leaf_6` nu, `leaf_7` the step (i32[]),
the leaves of `jax.tree.flatten(init_state(params, optax.adam(lr)))`.
In place of the JAX package's `key_data` it stores `gen_state`, the
`torch.Generator.get_state()` bytes; `restore` also reads a file the
JAX package's `save` wrote, and returns no generator state for it.

The JAX package's orbax forms import jax; their counterpart here is a
directory of npz files, one a step (`save_dir`, `latest_step`,
`restore_dir`), written in the calling thread, so there is nothing to
close.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

from drt_tpu_torch.optim import AdamState, TrainState
from drt_tpu_torch.scene import Params

_STEP_FILE = re.compile(r"^(\d+)\.npz$")


def _leaves(state: TrainState) -> list:
    p, (mu, nu), step = state
    return [p.albedo, p.emission, step, mu.albedo, mu.emission, nu.albedo,
            nu.emission, step]


def save(path: str, state: TrainState, gen: torch.Generator) -> None:
    """Persist a TrainState and the generator's state (written to a
    temporary file, then renamed over `path`)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {f"leaf_{i}": (np.asarray(x, np.int32) if isinstance(x, int)
                             else x.detach().cpu().numpy())
               for i, x in enumerate(_leaves(state))}
    payload["gen_state"] = gen.get_state().numpy()
    tmp = p.parent / (p.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.replace(p)


def restore(path: str, like: TrainState):
    """(TrainState, gen_state) from a file `save` wrote (gen_state a
    uint8 tensor for `torch.Generator.set_state`), or from one the JAX
    package's `save` wrote (gen_state None). `like` gives the device and
    the shapes (build it with `optim.init_state` on the initial
    params)."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(8)]
        gen_state = (torch.from_numpy(data["gen_state"].copy())
                     if "gen_state" in data.files else None)
    for got, want in zip(leaves, _leaves(like)):
        shape = () if isinstance(want, int) else tuple(want.shape)
        if got.shape != shape:
            raise ValueError(f"{path}: a leaf of shape {got.shape} where "
                             f"the state has {shape}")
    count, step = int(leaves[2]), int(leaves[7])
    if count != step:
        raise ValueError(f"{path}: Adam's count {count} is not the step "
                         f"{step}")
    dev = like.params.albedo.device
    alb, emi, _, mu_a, mu_e, nu_a, nu_e, _ = (
        torch.as_tensor(a, device=dev) for a in leaves)
    state = TrainState(Params(alb, emi), AdamState(Params(mu_a, mu_e),
                                                   Params(nu_a, nu_e)), step)
    return state, gen_state


def _step_path(directory: str, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"{step}.npz"


def save_dir(directory: str, state: TrainState, gen: torch.Generator,
             step: int | None = None) -> None:
    """Persist a TrainState and the generator's state as checkpoint
    `step` (by default the state's) under `directory`."""
    save(str(_step_path(directory, state.step if step is None else step)),
         state, gen)


def latest_step(directory: str) -> int | None:
    """The highest step checkpointed under `directory`; None if none."""
    d = pathlib.Path(directory)
    if not d.is_dir():
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match,
                                          (p.name for p in d.iterdir()))
             if m]
    return max(steps, default=None)


def restore_dir(directory: str, like: TrainState, step: int | None = None):
    """(TrainState, gen_state, step) of the latest (or the given)
    checkpoint under `directory`. `like` as for `restore`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    state, gen_state = restore(str(_step_path(directory, step)), like)
    return state, gen_state, step
