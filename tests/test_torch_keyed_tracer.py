"""The wavefront tracer's keyed form (B5a) on the CPU: its wrapper runs the
plain twin (key-mode `renderer.trace_rays`) for CPU tensors, which equals
the JAX package's `make_pallas_tracer` in interpret mode fed the tape of
the JAX package's keyed hash for the same (pixel, sample) (float32, the
tolerances of tests/test_megakernel.py: rtol 2e-5 / atol 2e-6); the
wrapper refuses a card call whose pixel or sample ids are malformed before
it launches; and `adjoint.make_wavefront_trace_fn` launches the keyed form
with the chunk's ids and draws no tape when the kernel is in use (a stub
library stands for the card). The kernel itself is tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.ops import regen as jax_regen
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import adjoint
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                    chunk_sample_ids)
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

F32 = dict(rtol=2e-5, atol=2e-6)  # tests/test_megakernel.py:51
CFG = RenderConfig(width=16, height=12, spp=2, max_depth=4)
SEEDS = torch.tensor([321, -654], dtype=torch.int32)
BUILDERS = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy}


@pytest.fixture(scope="module")
def scenes():
    """Per scene, once per module: the JAX scene, params and tables, its
    Pallas tracer in interpret mode, and the port's scene on the CPU."""
    out = {}
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    for name, build in BUILDERS.items():
        js, jp, jc = build(dtype=jnp.float32)
        port = from_numpy(*([np.asarray(a) for a in t]
                            for t in (js, jp, jc)), device="cpu")
        tracer = jax_mk.make_pallas_tracer(js, jcfg, tile_rows=8,
                                           interpret=True)
        out[name] = (tracer, jax_albedo_table(js, jp),
                     jax_emission_table(js, jp), port)
    return out


def _chunk(cam, chunk=1):
    """The rays f32[3, N] of a chunk of CFG and their (pixel, sample)."""
    xy = chunk_pixel_ids(CFG)
    pix, s = chunk_sample_ids(CFG, xy, chunk)
    o, d, _ = chunk_rays(cam, CFG, xy, SEEDS, chunk)
    return torch.stack(tuple(o)), torch.stack(tuple(d)), pix, s


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_keyed_twin_matches_pallas_kernel(scenes, name):
    tracer, jalb, jemi, (scene, params, cam) = scenes[name]
    o, d, pix, s = _chunk(cam)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    before = mk.ray_trace.launches
    got = mk.ray_trace(scene, mk.scene_table(scene), CFG, alb, emi, o, d,
                       seeds=SEEDS, pix=pix.int(), sample=s.int())
    assert mk.ray_trace.launches == before  # the twin: no launch
    jpix, js_ = jnp.asarray(pix.numpy()), jnp.asarray(s.numpy())
    tape = jnp.stack([
        jnp.stack([jax_regen.hash_uniform(int(SEEDS[1]), jpix, js_, b, dim,
                                          jnp.float32)
                   for dim in (0, 1, 2)])
        for b in range(CFG.max_depth)])
    ref = np.stack([np.asarray(v) for v in tracer(
        jalb, jemi, JV3(*map(jnp.asarray, o.numpy())),
        JV3(*map(jnp.asarray, d.numpy())), tape)])
    assert got.shape == (3, pix.shape[0]) and ref.mean() > 0
    np.testing.assert_allclose(got.numpy(), ref, **F32)
    # The factory's keyed form is the same call.
    again = mk.make_pallas_tracer(scene, CFG, keyed=True)(
        alb, emi, o, d, SEEDS, pix, s)
    assert torch.equal(again, got)


class _Lib(SimpleNamespace):
    """A stand-in for the tracer library: its entry points are names."""

    def __getattr__(self, name):
        if name.startswith("drt_"):
            return name
        raise AttributeError(name)


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card path on CPU tensors: the device test says
    "cuda", the library is a stub and `_launch` records what it would
    launch (the entry's name, its arguments and, for the keyed entry, the
    pixel and sample ids it would read) and counts it."""
    calls = []

    def launch(wrapper, what, error_string, entry, dev, *args):
        ids = None
        if entry == "drt_ray_trace_keyed":
            n = args[0]._obj.n_rays
            ids = [torch.tensor((ctypes.c_int32 * n).from_address(p))
                   for p in args[6:8]]
        calls.append((entry, args, ids))
        if wrapper is not None:
            wrapper.launches += 1

    monkeypatch.setattr(mk, "_device_of", lambda name, t: "cuda")
    monkeypatch.setattr(mk, "_library", lambda: _Lib())
    monkeypatch.setattr(mk, "_launch", launch)
    return calls


def _cbox_port(scenes):
    scene, params, cam = scenes["cbox"][3]
    return scene, params, cam, albedo_table(scene, params), \
        emission_table(scene, params)


def test_keyed_wrapper_refuses_bad_ids_before_launching(scenes, card):
    scene, params, cam, alb, emi = _cbox_port(scenes)
    o, d, pix, s = _chunk(cam)
    table = mk.scene_table(scene)
    pix, s = pix.int(), s.int()
    n = pix.shape[0]
    before = mk.ray_trace.launches
    for kw, err, match in (
            (dict(pix=pix[:-1], sample=s), ValueError, "shape"),
            (dict(pix=pix, sample=s[: n // 2]), ValueError, "shape"),
            (dict(pix=pix.reshape(2, -1), sample=s), ValueError, "shape"),
            (dict(pix=pix, sample=s.long()), TypeError, "int32"),
            (dict(pix=pix[::2], sample=s[::2]), ValueError, "shape")):
        with pytest.raises(err, match=match):
            mk.ray_trace(scene, table, CFG, alb, emi, o, d, seeds=SEEDS,
                         **kw)
    with pytest.raises(TypeError, match="seeds, pix and sample"):
        mk.ray_trace(scene, table, CFG, alb, emi, o, d, seeds=SEEDS,
                     pix=pix)
    with pytest.raises(TypeError, match="seeds, pix and sample"):
        mk.ray_trace(scene, table, CFG, alb, emi, o, d,
                     torch.zeros((4, 3, n)), seeds=SEEDS, pix=pix, sample=s)
    with pytest.raises(ValueError, match="lockstep build takes a tape"):
        mk.ray_trace(scene, table, CFG, alb, emi, o, d, seeds=SEEDS,
                     pix=pix, sample=s, build="lockstep")
    assert card == [] and mk.ray_trace.launches == before
    # Well-formed ids launch the keyed entry on them, once.
    mk.ray_trace(scene, table, CFG, alb, emi, o, d, seeds=SEEDS, pix=pix,
                 sample=s)
    ((entry, args, ids),) = card
    assert entry == "drt_ray_trace_keyed"
    assert torch.equal(ids[0], pix) and torch.equal(ids[1], s)
    tcfg = args[0]._obj
    assert tcfg.internal_rng == 1 and tcfg.fast == 0 and tcfg.n_rays == n
    assert tcfg.seed1 == int(SEEDS[1]) & 0xFFFFFFFF
    assert mk.ray_trace.launches == before + 1


def test_wavefront_trace_fn_takes_the_keyed_form(scenes, card,
                                                 monkeypatch):
    """On the card `make_wavefront_trace_fn` launches the keyed form on
    the chunk's rays and ids, and draws no tape."""
    scene, params, cam, alb, emi = _cbox_port(scenes)

    def no_tape(*args, **kw):
        raise AssertionError("a tape was drawn")

    monkeypatch.setattr(adjoint, "prefix_tape", no_tape)
    monkeypatch.setattr(mk, "bounce_tape", no_tape)
    trace_fn = adjoint.make_wavefront_trace_fn(scene, CFG)
    xy = chunk_pixel_ids(CFG)
    pix, s = chunk_sample_ids(CFG, xy, 1)
    o, d, _ = chunk_rays(cam, CFG, xy, SEEDS, 1)
    before = mk.ray_trace.launches
    L = trace_fn(params, o, d, SEEDS, pix, s)
    assert L.shape == (3, pix.shape[0])
    assert mk.ray_trace.launches == before + 1
    ((entry, args, ids),) = card
    assert entry == "drt_ray_trace_keyed"
    assert torch.equal(ids[0], pix.int()) and torch.equal(ids[1], s.int())
