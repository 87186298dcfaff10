"""drt_tpu_torch.ops.earlyexit on the CPU, where the early-exit tracer's
wrapper runs its plain twin: against the JAX package's
`make_earlyexit_tracer` (tape mode, Pallas interpret mode, tile_rows=1, as
tests/test_earlyexit.py runs it: the Cornell box at 16x8x4, depth 6, on a
numpy-seeded tape) to rtol 2e-5 / atol 2e-6, and bit for bit against the
port's plain fused tracer, whose radiance early exit must not change. The
kernel itself is tested on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops.earlyexit import make_earlyexit_tracer as jax_earlyexit
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.earlyexit import make_earlyexit_tracer
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

TOL = dict(rtol=2e-5, atol=2e-6)
CFG = RenderConfig(width=16, height=8, spp=4, max_depth=6)
N = 16 * 8 * 4
BUILDERS = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy}


def _uniforms(seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(2, N)).astype(np.float32),
            r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32))


def _port(name):
    scene, params, cam = from_numpy(
        *([np.asarray(a) for a in t] for t in BUILDERS[name](
            dtype=jnp.float32)), device="cpu")
    return scene, cam, albedo_table(scene, params), emission_table(scene,
                                                                   params)


def test_matches_jax_earlyexit_tracer():
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    cam_u, tape = _uniforms()
    ref = jax_earlyexit(js, jc, JaxConfig(**dataclasses.asdict(CFG)),
                        tile_rows=1, rng="tape", interpret=True)(
        jax_albedo_table(js, jp), jax_emission_table(js, jp),
        jnp.asarray(cam_u), jnp.asarray(tape))
    ref = np.stack([np.asarray(c) for c in ref])
    scene, cam, alb, emi = _port("cbox")
    got = make_earlyexit_tracer(scene, cam, CFG, rng="tape")(
        alb, emi, torch.as_tensor(cam_u), torch.as_tensor(tape))
    assert ref.mean() > 0 and got.shape == (3, N)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_bit_equal_to_the_fused_tracer(name):
    """Tape mode, and the internal RNG over 2 chunks of 2 samples in one
    call: the plain early-exit tracer is the plain fused tracer's radiance
    bit for bit, and so is the wrapper's run on CPU tensors, which
    launches nothing."""
    scene, cam, alb, emi = _port(name)
    cam_u, tape = map(torch.as_tensor, _uniforms(1))
    ref = mk.make_fused_tracer(scene, cam, CFG, rng="tape", plain=True)(
        alb, emi, cam_u, tape)
    before = mk.launch_counts()
    for plain in (True, False):
        got = make_earlyexit_tracer(scene, cam, CFG, rng="tape",
                                    plain=plain)(alb, emi, cam_u, tape)
        assert torch.equal(got, ref)
    assert mk.launch_counts() == before
    cfg = dataclasses.replace(CFG, spp_chunks=2)
    seeds = torch.tensor([7, -8], dtype=torch.int32)
    ref = mk.make_fused_tracer(scene, cam, cfg, n_chunks=2, plain=True)(
        alb, emi, seeds)
    got = make_earlyexit_tracer(scene, cam, cfg, n_chunks=2)(alb, emi, seeds)
    assert ref.mean() > 0 and torch.equal(got, ref)


def test_exits_early_and_refuses_a_pixel_offset():
    """At depth 16 the plain loop leaves once no ray lives, and the
    radiance is the full loop's; a tile_base other than 0 raises, naming
    the ray offset the port's tracers take instead."""
    scene, cam, alb, emi = _port("cbox")
    cfg = dataclasses.replace(CFG, max_depth=16)
    r = np.random.default_rng(2)
    cam_u = torch.as_tensor(r.uniform(size=(2, N)).astype(np.float32))
    tape = torch.as_tensor(r.uniform(size=(16, 3, N)).astype(np.float32))
    trace = make_earlyexit_tracer(scene, cam, cfg, rng="tape")
    L = trace(alb, emi, cam_u, tape)
    assert torch.equal(L, mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape))
    with pytest.raises(ValueError, match="ray_base"):
        trace(alb, emi, cam_u, tape, tile_base=1)
