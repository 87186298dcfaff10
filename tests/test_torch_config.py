"""drt_tpu_torch.config against drt_tpu.config, the port's import
boundary (it never imports jax), and the build key of its kernels."""

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
    pulling in jax (or the JAX package): among them the early-exit tracer
    and the segment forms (`ops.megakernel`, `fused`), the checkpoint,
    logging, profiling and debug utilities, and the device mesh and the
    multi-process runtime (`parallel.mesh`, `parallel.multihost`)."""
    mods = [m.name for m in pkgutil.walk_packages(
        drt_tpu_torch.__path__, "drt_tpu_torch.")]
    assert {"drt_tpu_torch.ops.megakernel", "drt_tpu_torch.ops.dynkernel",
            "drt_tpu_torch.ops.regen", "drt_tpu_torch.ops.dynregen",
            "drt_tpu_torch.ops.earlyexit",
            "drt_tpu_torch.adjoint", "drt_tpu_torch.gradcheck",
            "drt_tpu_torch.integrate", "drt_tpu_torch.renderer",
            "drt_tpu_torch.optim", "drt_tpu_torch.fused",
            "drt_tpu_torch.cli", "drt_tpu_torch.utils.native",
            "drt_tpu_torch.utils.checkpoint", "drt_tpu_torch.utils.logging",
            "drt_tpu_torch.utils.profiling",
            "drt_tpu_torch.utils.debug", "drt_tpu_torch.parallel.render",
            "drt_tpu_torch.parallel.mesh",
            "drt_tpu_torch.parallel.multihost"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'drt_tpu.')) or m == 'drt_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_build_key_covers_every_file_under_csrc(tmp_path, monkeypatch):
    """An edit to a header shared by the kernels, or to the flags, moves
    every library to a new build directory; nothing is compiled here."""
    from drt_tpu_torch.utils import native

    assert native.sources() == [
        "dyn_adjoint.cu", "dyn_regen_adjoint.cu", "dyn_regen_tracer.cu",
        "dyn_tracer.cu", "fused_adjoint.cu", "fused_tracer.cu",
        "regen_adjoint.cu", "regen_tracer.cu"]
    for header in ("drt_common.cuh", "grad_accum.cuh", "fused_body.cuh",
                   "dyn_body.cuh", "regen_body.cuh", "fused_bounce.inc",
                   "dyn_bounce.inc"):
        assert (native.CSRC_DIR / header).exists()
    a, b = native.library_path("fused_tracer.cu"), \
        native.library_path("fused_adjoint.cu")
    assert a.parent == b.parent and a.parent.parent == native.BUILD_DIR
    assert a.name == "fused_tracer.so" and native.log_path(
        "fused_tracer.cu").name == "fused_tracer.log"

    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#include "b.inc"\n')
    (tmp_path / "b.inc").write_text("// one\n")
    key = native.build_key()
    assert native.build_key() == key and native.sources() == ["k.cu"]
    (tmp_path / "b.inc").write_text("// two\n")
    key2 = native.build_key()
    assert key2 != key
    monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ["-g"])
    assert native.build_key() not in (key, key2)
