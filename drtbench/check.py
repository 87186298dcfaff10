"""The comparison that decides `correct`: what the timed path produced,
against the plain reference on the same inputs.

Render cells: a sample of the window's images drawn from the seed, each
on a sample of its pixels drawn from the seed (every sample of those
pixels, at the cell's spp), against the reference's pixels:
  mean_gap   |mean(program) - mean(reference)| / mean(reference), the
             worst image;
  nonfinite  pixels of the sample that are inf or NaN (limit 0).
(A pixel-wise gap does not separate the program from the control: the
fast-math kernels move a few whole paths by turning them at an ulp, the
bfloat16 control moves every path a little; PERF.md gives the readings.)

Train cells: the reference follows the set-up's first block, a call of
the window's own size (`steps_per_call` steps), from the same start,
target seeds and generator. Each table row is a leaf (a gradient put
into the wrong row keeps a whole table's norm):
  loss_gap    |loss - reference loss| / |reference loss|, the worst step
              of the block;
  mu_gap      Adam's first moment after the block, by the worst leaf: the
              gap of the two norms over the reference leaf's norm or the
              median leaf's, whichever is larger;
  nu_gap      Adam's second moment after the block, by the same measure;
  change_gap  the tables' change over the block, by the same measure,
              over the leaves whose reference gradient (the root mean
              square over the block) is at least a thousandth of the
              median leaf's.
"""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import numpy as np
import torch

from drtbench import program

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def check_pixels(reference, checks: dict, seed: int) -> torch.Tensor:
    n = int(checks["pixels"])
    if n >= reference.npix:
        return torch.arange(reference.npix, device=reference.device)
    rng = np.random.default_rng([seed, 3])
    return torch.as_tensor(np.sort(rng.choice(reference.npix, n,
                                              replace=False)),
                           device=reference.device)


def render_numbers(reference, images, checks: dict, seed: int) -> dict:
    """images: (seeds, image f[H, W, 3]) of the program, or f[n_sel, 3] on
    the check's pixels where the reference is put in its place."""
    if not images:  # no image of the sample completed: nothing was shown
        return {"mean_gap": math.inf, "nonfinite": 0.0}
    pixels = check_pixels(reference, checks, seed)
    mean_gap = 0.0
    nonfinite = 0
    for seeds, img in images:
        img = img.to(reference.device).reshape(-1, 3)
        p = (img[pixels] if img.shape[0] == reference.npix else img).double()
        r = reference.image(reference.paths(seeds, pixels), reference.albedo,
                            reference.emission).double()
        nonfinite += int((~torch.isfinite(p)).sum())
        mean_gap = max(mean_gap, float((p.mean() - r.mean()).abs()
                                       / r.mean().abs()))
    return {"mean_gap": mean_gap, "nonfinite": float(nonfinite)}


def reference_pixels(reference, seeds_list, checks, seed, dtype=None):
    """The reference's images on the check's pixels, as (seeds, pixels)
    pairs that `render_numbers` takes in the program's place."""
    pixels = check_pixels(reference, checks, seed)
    return [(s, reference.image(reference.paths(s, pixels), reference.albedo,
                                reference.emission, dtype))
            for s in seeds_list]


class Steps(NamedTuple):
    """A block of optimizer steps as the check compares it: each step's
    loss, Adam's moments after the block, and the tables before and after
    it ([albedo, emission] each)."""

    losses: list
    mu: list
    nu: list
    start: list
    after: list


def reference_steps(reference, traffic: dict, seed: int, dtype=None,
                    grad_fault=None) -> Steps:
    """The trainer's first block, `steps_per_call` steps, in the
    reference. The target from the true tables at seed + 1, two renders a
    step at seeds drawn from the run's generator, the paired loss
    mean((X1 - T)(X2 - T)), Adam in optax's form, albedo kept in [0, 1]
    and emission >= 0. grad_fault(g) -> g plants a fault in each step's
    gradient [albedo, emission]."""
    if traffic["loss"] != "paired":
        raise ValueError(f"the reference has the paired loss, not "
                         f"{traffic['loss']!r}")
    target = reference.image(
        reference.paths(program.draw_seeds(
            torch.Generator().manual_seed(seed + 1)).tolist()),
        reference.albedo, reference.emission, dtype)
    params = [torch.full_like(reference.albedo, traffic["init_albedo"]),
              torch.full_like(reference.emission, traffic["init_emission"])]
    start = [p.clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    gen = torch.Generator().manual_seed(seed)
    lr = float(traffic["lr"])
    losses = []
    for k in range(int(traffic["steps_per_call"])):
        ta = reference.paths(program.draw_seeds(gen).tolist())
        tb = reference.paths(program.draw_seeds(gen).tolist())
        x1 = reference.image(ta, *params, dtype)
        x2 = reference.image(tb, *params, dtype)
        n = x1.numel()
        losses.append(float(((x1 - target) * (x2 - target)).mean()))
        ga = reference.vjp(ta, *params, (x2 - target) / n, dtype)
        gb = reference.vjp(tb, *params, (x1 - target) / n, dtype)
        g = [a + b for a, b in zip(ga, gb)]
        if grad_fault is not None:
            g = grad_fault(g)
        c1, c2 = 1 - ADAM_B1 ** (k + 1), 1 - ADAM_B2 ** (k + 1)
        for j in range(2):
            mu[j] = ADAM_B1 * mu[j] + (1 - ADAM_B1) * g[j]
            nu[j] = ADAM_B2 * nu[j] + (1 - ADAM_B2) * (g[j] * g[j])
            upd = -lr * (mu[j] / c1) / (torch.sqrt(nu[j] / c2) + ADAM_EPS)
            params[j] = params[j] + upd
        params = [params[0].clamp(0.0, 1.0), params[1].clamp_min(0.0)]
    return Steps(losses, mu, nu, start, params)


def _rows(tables, device) -> list:
    """Each row of each table, a leaf of its own."""
    return [r for t in tables for r in t.to(device).double().reshape(
        t.shape[0], -1)]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(got, ref, keep=None) -> float:
    """The worst leaf's |norm(got) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's."""
    gn, rn = [_norm(g) for g in got], [_norm(r) for r in ref]
    med = statistics.median(rn)
    keep = keep if keep is not None else [True] * len(rn)
    gaps = [abs(a - b) / max(b, med) for a, b, k in zip(gn, rn, keep) if k]
    return max(gaps) if gaps else 0.0


def train_numbers(reference, got: Steps, traffic: dict, seed: int,
                  ref: Steps | None = None) -> dict:
    """The compared numbers of a block `got` against the reference's
    (`ref`, followed here where not given)."""
    ref = ref or reference_steps(reference, traffic, seed)
    dev = reference.device
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses,
                                                        ref.losses))
    c2 = 1 - ADAM_B2 ** len(ref.losses)
    rms = [_norm(r) for r in _rows([torch.sqrt(v / c2) for v in ref.nu],
                                   dev)]
    med = statistics.median(rms)
    keep = [n >= 1e-3 * med for n in rms]

    def change(s):
        return _rows([a - b.to(a.device) for a, b in zip(s.after, s.start)],
                     dev)

    finite = all(math.isfinite(x) for x in got.losses)
    return {"loss_gap": loss_gap if finite else math.inf,
            "mu_gap": _leaf_gaps(_rows(got.mu, dev), _rows(ref.mu, dev)),
            "nu_gap": _leaf_gaps(_rows(got.nu, dev), _rows(ref.nu, dev)),
            "change_gap": _leaf_gaps(change(got), change(ref), keep)}
