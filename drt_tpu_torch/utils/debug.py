"""Numerical sanitizers: host-side finiteness and index-range checks.

The port of `drt_tpu.utils.debug`. The hazard class is numerical: NaN or
Inf escaping masked lanes, out-of-range table indices feeding gathers.
These checks read their tensors on the host, so each waits for the
device: for tests and staging runs, not the hot path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from drt_tpu_torch.scene import Params, Scene


def leaves_with_path(tree, path: str = ""):
    """(path, leaf) for each leaf of nested tuples, lists, dicts and
    NamedTuples, in `jax.tree_util`'s order (dict keys sorted) and with
    its `keystr` paths: `[0]`, `['key']`, `.field`. None is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field, value in zip(tree._fields, tree):
            yield from leaves_with_path(value, f"{path}.{field}")
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from leaves_with_path(value, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], f"{path}[{key!r}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if torch.is_tensor(leaf):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf)
                                                    .all())
    a = np.asarray(leaf)
    return a.dtype.kind != "f" or bool(np.isfinite(a).all())


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming the path of the first leaf of
    `tree` that holds a NaN or an Inf (as `name` + `keystr`)."""
    for path, leaf in leaves_with_path(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked(fn):
    """Wrap `fn` so that a NaN or Inf in its outputs raises on call.

    The JAX package's form runs `fn` under `checkify`, which checks every
    operation inside; PyTorch has no counterpart, so this checks only the
    outputs (`assert_finite`), and reading them waits for the device.
    For every operation of a backward pass, see `nan_debug`.
    """
    name = getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, f"{name}()")
        return out

    return wrapped


def validate_scene(scene: Scene, params: Params) -> None:
    """Static index-range validation of the SoA scene: every gather the
    tracers perform must be in range (the functional analogue of the
    out-of-bounds class of sanitizer findings)."""
    n_mat = scene.mat_type.shape[0]
    n_alb = params.albedo.shape[0]
    n_emit = params.emission.shape[0]
    sm = scene.shape_mat.cpu()
    se = scene.shape_emit.cpu()
    ma = scene.mat_albedo.cpu()
    if not ((0 <= sm) & (sm < n_mat)).all():
        raise IndexError(f"shape_mat out of range [0, {n_mat})")
    if not ((0 <= se) & (se <= n_emit)).all():
        raise IndexError(f"shape_emit out of range [0, {n_emit}]")
    if not ((0 <= ma) & (ma <= n_alb)).all():
        raise IndexError(f"mat_albedo out of range [0, {n_alb}]")
    geo = scene.shape_geo.cpu()
    if not torch.isfinite(geo).all():
        raise FloatingPointError("non-finite scene geometry")
    sphere_r = geo[scene.shape_type.cpu() == 1, 3]
    if (sphere_r <= 0).any():
        raise ValueError("sphere with non-positive radius")


def nan_debug(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off globally: a backward
    operation that returns NaN raises, naming the forward operation that
    made it (coarse and slow, but zero-setup)."""
    torch.autograd.set_detect_anomaly(enable)
