"""The generic Monte-Carlo integration operator: the port of
`drt_tpu.integrate`.

The reference's public interface is one reusable function,
`integrate(forward, sampler, n_samples, unbiased)`
(include/drt/integrate.hpp:56-66), for any integrand; the path tracer is
one caller (pathtracer.hpp:96-112). This is its PyTorch form:

- biased (default): the estimate `mean_i f(params, x_i) / pdf(x_i)` is
  differentiated by replaying the same samples: plain autograd through the
  estimator, the semantics of `integrate_biased` (integrate.hpp:26-37);
- unbiased: the value is the same estimate, but the backward draws
  `n_samples` fresh samples and averages their parameter gradients
  (`internal::IntegrateBackward`, integrate.hpp:11-24).

`combine="sum"` keeps the reference's loops, which sum `forward / pdf`
with no 1/n (integrate.hpp:33-34, IntegrateBackward:15-18); the default
"mean" is the n-sample estimator of E[f/pdf]. At n_samples = 1 they
coincide.

The JAX operator's key becomes a `torch.Generator`: the sampler draws from
it, the forward's samples first and, in unbiased mode, the backward's
fresh samples when the backward runs.
"""

from __future__ import annotations

import torch


def _flatten(params):
    """(leaves, rebuild) of a tensor or a tuple (or NamedTuple) of
    tensors."""
    if torch.is_tensor(params):
        return [params], lambda leaves: leaves[0]
    if hasattr(params, "_fields"):
        return list(params), lambda leaves: type(params)(*leaves)
    return list(params), tuple


def integrate(forward, sampler, params, gen, n_samples: int = 1,
              unbiased: bool = False, combine: str = "mean"):
    """MC estimate of `E[forward(params, x) / pdf(x)]`, differentiable in
    `params` (a tensor, or a tuple or NamedTuple of tensors).

    forward(params, sample) -> tensor, differentiable in params (the
      reference's `forward` functor, pathtracer.hpp:97-105).
    sampler(gen) -> (sample, pdf), drawing from the `torch.Generator` gen
      (`sampler`, pathtracer.hpp:106-109); pdf a scalar or broadcastable.
    n_samples: draws of the estimate; in unbiased mode the backward draws
      as many fresh ones (integrate.hpp:15-19).
    combine: "mean" (default) averages the draws, "sum" adds them without
      1/n as the reference's loops do.
    unbiased: see the module docstring.
    """
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if combine not in ("mean", "sum"):
        raise ValueError("combine must be 'mean' or 'sum'")
    denom = n_samples if combine == "mean" else 1

    def estimate(p, draws):
        return sum(forward(p, x) / pdf for x, pdf in draws) / denom

    def draw():
        return [sampler(gen) for _ in range(n_samples)]

    if not unbiased:
        # Biased: autograd replays the forward's samples
        # (integrate.hpp:26-37).
        return estimate(params, draw())

    leaves, rebuild = _flatten(params)

    class Unbiased(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *ls):
            ctx.save_for_backward(*ls)
            return estimate(rebuild(list(ls)), draw())

        @staticmethod
        def backward(ctx, g):
            ls = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            # Fresh samples at backward time (integrate.hpp:11-24).
            with torch.enable_grad():
                value = estimate(rebuild(ls), draw())
            grads = torch.autograd.grad(value, ls, g, allow_unused=True)
            return tuple(torch.zeros_like(t) if d is None else d
                         for t, d in zip(ls, grads))

    return Unbiased.apply(*leaves)
