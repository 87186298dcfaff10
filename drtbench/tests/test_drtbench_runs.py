"""Whole runs of each cell at a small shape on the CPU, through the plain
versions of the kernels ("torch", "torch-dyn"): a sound run is correct;
a run with the timed path broken underneath (a fault planted in the
program), or with the reference in the nearest lower precision put in
the program's place (the control), is not; and the command refuses to
run without a card, or without the program beside it."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from drtbench import harness, readings

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 123  # more than 32 bits, as the runs' seeds are


def small(cell):
    """A shape the CPU holds: 24x16 at 16 spp (the mesh at level 1)."""
    render = {"width": 24, "height": 16, "spp": 16, "max_depth": 5}
    over = {"render": render}
    if cell.startswith("mesh"):
        render["spp_chunks"] = 2
        over["scene"] = {"kwargs": {"level": 1}}
    traffic = {"backend": "torch-dyn" if cell.startswith("mesh") else "torch",
               "warmup": 1, "warmup_units": 1}
    checks = {"image_span": 3, "images": 2}
    return over, traffic, checks


def run_small(cell, seconds=0.3):
    over, traffic, checks = small(cell)
    code, result = harness.run(
        ["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
         "--trace", "0"], device="cpu", config_over=over,
        traffic_over=traffic, checks_over=checks)
    assert code == 0
    return result


CELLS = ["cbox-train", "mesh-train", "cbox-render", "mesh-render"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def _wrap_renderer(monkeypatch, fn):
    """Plant a fault in every renderer the program's make_renderer makes
    (the trainer's too): fn(scene, cfg, cam, kw) -> render."""
    import drt_tpu_torch.optim as optim
    import drt_tpu_torch.parallel.render as routing

    real = routing.make_renderer

    def make(scene, cfg, cam, **kw):
        return fn(real, scene, cfg, cam, kw)

    monkeypatch.setattr(routing, "make_renderer", make)
    monkeypatch.setattr(optim, "make_renderer", make)


def _half_batch(real, scene, cfg, cam, kw):
    """Half of the samples left out, the mean taken over the rest."""
    return real(scene, dataclasses.replace(cfg, spp=cfg.spp // 2,
                                           spp_chunks=1), cam, **kw)


def _altered(real, scene, cfg, cam, kw):
    """The answer altered where it is produced: the image, 1% brighter."""
    render = real(scene, cfg, cam, **kw)
    return lambda params, seeds: render(params, seeds) * 1.01


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _altered],
                         ids=["half_batch", "altered"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    _wrap_renderer(monkeypatch, fault)
    assert not run_small(cell)["correct"]


def _wrap_block(monkeypatch, fn):
    """Plant a fault in the program's training block: fn(run) -> run."""
    import drt_tpu_torch.optim as optim

    real = optim.make_train_block
    monkeypatch.setattr(optim, "make_train_block",
                        lambda *a, **kw: fn(real(*a, **kw)))


def _stuck(monkeypatch):
    """A block that returns its state unchanged."""
    _wrap_block(monkeypatch, lambda run: lambda state, gen, length: (
        state, run(state, gen, length)[1]))


def _block_tail_stuck(monkeypatch):
    """A block whose steps after its first return the state unchanged:
    only a call of the window's own size shows it."""

    def tail(run):
        def block(state, gen, length):
            state, first = run(state, gen, 1)
            ms = [first] + [run(state, gen, 1)[1] for _ in range(length - 1)]
            return state, {k: torch.cat([m[k] for m in ms]) for k in first}

        return block

    _wrap_block(monkeypatch, tail)


class _NextRow(torch.autograd.Function):
    """The identity whose gradient lands one row down (the last row's in
    the first)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.roll(1, 0)


def _wrong_row(monkeypatch):
    """Each albedo row's gradient accumulated into the next row."""

    def make(real, scene, cfg, cam, kw):
        render = real(scene, cfg, cam, **kw)
        return lambda params, seeds: render(
            params._replace(albedo=_NextRow.apply(params.albedo)), seeds)

    _wrap_renderer(monkeypatch, make)


@pytest.mark.parametrize("cell", ["cbox-train", "mesh-train"])
@pytest.mark.parametrize("fault", [_stuck, _block_tail_stuck, _wrong_row],
                         ids=["state_unchanged", "block_tail_unchanged",
                              "gradient_in_wrong_row"])
def test_trainer_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, capsys):
    """The reference in bfloat16 in the program's place fails the cell's
    limits."""
    over, traffic, checks = small(cell)
    readings.main(["--workload", cell, "--seed0", str(SEED), "--seeds", "1",
                   "--faults", "1", "--seconds", "0.3", "--device", "cpu"],
                  config_over=over, traffic_over=traffic, checks_over=checks)
    import json

    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = harness.Cell(cell).checks["limits"]
    by = {x["what"]: x for x in lines}
    assert all(by["program"][k] <= v for k, v in limits.items())
    assert any(by["control"][k] > v for k, v in limits.items())


def _command(cwd):
    return subprocess.run(
        [sys.executable, "drtbench/run.py", "--workload", "cbox-render",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "drtbench", tmp_path / "drtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "drtbench/run.py", "--workload", "cbox-render",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """Each cell at its own size, briefly, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "drtbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    assert json.loads(proc.stdout.splitlines()[-1])["correct"]
