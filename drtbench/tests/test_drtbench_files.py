"""The benchmark's files: every cell's configuration, traffic mix, check
and driver, every per-layer metric's reader and every reference scene is
found by name and loads; nothing under drtbench/ imports JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

from drtbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    from drt_tpu_torch.config import RenderConfig

    c = harness.Cell(cell)
    RenderConfig(**c.config["render"])
    assert (harness.BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert (harness.BENCH / "reference" / "scenes"
            / f"{c.config['scene']['reference']}.py").is_file()
    assert set(c.checks["limits"]) and all(
        v >= 0 for v in c.checks["limits"].values())
    assert c.end_to_end and c.per_layer
    assert "setup_s" in [m["name"] for m in c.end_to_end]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    mod = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py",
                              "m_" + metric.replace(".", "_"))
    assert mod.read({}) is None  # nothing to read: no number


def test_names_and_paths():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("drtbench/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_reference_apart():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path)
        assert not found & {"jax", "jaxlib", "flax", "drt_tpu"}, path
        if "reference" in path.relative_to(harness.BENCH).parts:
            assert "drt_tpu_torch" not in found, path
    for path in sorted((harness.BENCH / "configs").glob("*.json")):
        mod = json.loads(path.read_text())["scene"]["program"].split(":")[0]
        assert mod.split(".")[0] == "drt_tpu_torch", path
