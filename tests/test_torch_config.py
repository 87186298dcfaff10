"""drt_tpu_torch.config against drt_tpu.config, and the port's import
boundary (it never imports jax)."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import drt_tpu_torch
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu_torch.config import RenderConfig

REPO = Path(__file__).resolve().parent.parent


def test_fields_and_defaults_match():
    jax_fields = [(f.name, f.type, f.default)
                  for f in dataclasses.fields(JaxConfig)]
    port_fields = [(f.name, f.type, f.default)
                   for f in dataclasses.fields(RenderConfig)]
    assert port_fields == jax_fields
    assert RenderConfig() == RenderConfig(**dataclasses.asdict(JaxConfig()))


@pytest.mark.parametrize("kw", [
    dict(width=0), dict(height=-1), dict(spp=0),
    dict(absorb_prob=1.0), dict(absorb_prob=-0.1),
    dict(min_bounces=-1), dict(max_depth=0),
    dict(min_bounces=5, max_depth=4),
    dict(spp=10, spp_chunks=3), dict(spp_chunks=0),
    dict(bsdf_samples=0), dict(adjoint_samples=0),
    dict(bsdf_samples=2, max_depth=32),
])
def test_validation_errors_match(kw):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        RenderConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_import_leaves_jax_out():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax (or the JAX package)."""
    mods = [m.name for m in pkgutil.walk_packages(
        drt_tpu_torch.__path__, "drt_tpu_torch.")]
    assert "drt_tpu_torch.ops.megakernel" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'drt_tpu.')) or m == 'drt_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
