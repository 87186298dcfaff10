"""drt_tpu_torch.utils on the CPU against drt_tpu.utils: the metrics
stream, the progress line, the timer and rates, the profiler trace, the
finiteness and scene checks (the same messages as the JAX package's), and
EXR files crossing between the two packages."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drt_tpu.models import cbox as jax_cbox
from drt_tpu.scene import Params as JaxParams
from drt_tpu.utils import debug as jax_debug
from drt_tpu.utils import image as jax_image
from drt_tpu_torch.models import cbox
from drt_tpu_torch.scene import Params
from drt_tpu_torch.utils import debug, image, profiling
from drt_tpu_torch.utils.logging import MetricsLogger, Progress


def test_metrics_logger_jsonl(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path), stream=sys.stderr)
    log.log(0, loss=1.5, note="warmup")
    log.log(1, loss=torch.tensor(0.25), grad_norm=torch.tensor(2.0))
    log.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[0]["loss"] == 1.5 and recs[0]["note"] == "warmup"
    assert recs[1]["loss"] == 0.25 and recs[1]["grad_norm"] == 2.0
    assert all(set(r) >= {"step", "t"} for r in recs)
    err = capsys.readouterr().err.splitlines()
    assert err == ["step=0 loss=1.5 note=warmup",
                   "step=1 loss=0.25 grad_norm=2"]


def test_progress_line(capsys):
    p = Progress(total=4, stream=sys.stderr)
    p.update(2)
    p.finish()
    assert "50.00%" in capsys.readouterr().err


def test_timed_and_rates():
    calls = []

    def fn(x):
        calls.append(x)
        return {"y": x + 1}

    best, out = profiling.timed(fn, torch.tensor(1.0), warmup=1, reps=2)
    assert float(out["y"]) == 2.0
    assert best >= 0 and len(calls) == 3
    assert profiling.rays_per_second(1_000_000, 2.0) == 500_000
    assert profiling.mrays_per_second(2_000_000, 1.0) == 2.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).cumsum(0)
    assert any("cumsum" in e.name for e in prof.events())
    events = json.load(open(tmp_path / "prof" / profiling.TRACE_FILE))
    assert any("cumsum" in e.get("name", "")
               for e in events["traceEvents"])


NAN = float("nan")


@pytest.mark.parametrize("tree", [
    {"a": [1.0, 2.0]},
    {"b": [[1.0], [2.0, NAN]], "a": [[0.0]]},
    [[1.0], {"k": [float("inf")]}],
    "params",
], ids=["finite", "dict-list", "list-dict", "params"])
def test_assert_finite_names_the_leaf_as_jax_does(tree):
    """The same tree of arrays in both packages: both pass, or both raise
    FloatingPointError with the same message (`jax.tree_util.keystr`
    paths: dict keys sorted, `.field` for a NamedTuple)."""
    def build(as_array):
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list) and t and isinstance(t[0], float):
                return as_array(t)
            return [walk(v) for v in t]
        return walk(tree)

    if tree == "params":  # NaN in the second field of a NamedTuple
        jax_tree = JaxParams(jnp.ones(3), jnp.asarray([0.0, NAN]))
        port_tree = Params(torch.ones(3), torch.tensor([0.0, NAN]))
    else:
        jax_tree = build(jnp.asarray)
        port_tree = build(torch.tensor)
    try:
        jax_debug.assert_finite(jax_tree, "params")
        want = None
    except FloatingPointError as e:
        want = str(e)
    if want is None:
        debug.assert_finite(port_tree, "params")
    else:
        with pytest.raises(FloatingPointError) as got:
            debug.assert_finite(port_tree, "params")
        assert str(got.value) == want
    debug.assert_finite({"i": torch.tensor([1, 2]), "none": None})


def test_checked_flags_nan():
    checked = debug.checked(torch.log)  # NaN for negative input
    with pytest.raises(FloatingPointError, match="log"):
        checked(torch.tensor([-1.0]))
    assert float(checked(torch.tensor([1.0]))[0]) == 0.0


def test_nan_debug_toggles_anomaly_detection():
    try:
        debug.nan_debug(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward"):
            torch.sqrt(x).sum().backward()
    finally:
        debug.nan_debug(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("fault,exc", [
    (None, None), ("shape_mat", IndexError), ("shape_emit", IndexError),
    ("mat_albedo", IndexError), ("geo", FloatingPointError),
    ("radius", ValueError)])
def test_validate_scene_as_jax_does(fault, exc):
    """Each fault raises the JAX package's exception and message on the
    same scene, and the Cornell box passes in both."""
    js, jp, _ = jax_cbox.build(dtype=jnp.float32)
    scene, params, _ = cbox.build(device="cpu")

    def broken(s, lib):
        if fault in ("shape_mat", "shape_emit", "mat_albedo"):
            return s._replace(**{fault: getattr(s, fault) + 100})
        geo = np.array(s.shape_geo)
        if fault == "geo":
            geo[0, 0] = np.inf
        elif fault == "radius":
            geo[np.asarray(s.shape_type) == 1, 3] = 0.0
        return s._replace(shape_geo=lib(geo)) if fault else s

    if exc is None:
        jax_debug.validate_scene(js, jp)
        debug.validate_scene(scene, params)
        return
    with pytest.raises(exc) as want:
        jax_debug.validate_scene(broken(js, jnp.asarray), jp)
    with pytest.raises(exc) as got:
        debug.validate_scene(broken(scene, torch.as_tensor), params)
    assert str(got.value) == str(want.value)


def test_exr_crosses_between_the_packages(tmp_path):
    """The port reads the JAX package's EXR and the JAX package reads the
    port's; both give the half-rounded array with alpha 1."""
    img = (np.random.default_rng(0).uniform(size=(5, 7, 3)) * 4
           ).astype(np.float32)
    want = np.concatenate([img.astype(np.float16).astype(np.float32),
                           np.ones((5, 7, 1), np.float32)], axis=2)
    jax_image.write_exr(str(tmp_path / "jax.exr"), img)
    image.write_exr(str(tmp_path / "port.exr"), img)
    np.testing.assert_array_equal(image.read_exr(str(tmp_path / "jax.exr")),
                                  want)
    np.testing.assert_array_equal(
        jax_image.read_exr(str(tmp_path / "port.exr")), want)
    assert (tmp_path / "jax.exr").read_bytes() == \
        (tmp_path / "port.exr").read_bytes()
    (tmp_path / "png").write_bytes(b"\x89PNG")
    with pytest.raises(ValueError, match="not an EXR"):
        image.read_exr(str(tmp_path / "png"))
