"""drt_tpu_torch.ops.dynregen on the CPU, where the wrappers of the
path-regeneration kernels over memory-resident scenes run their plain
PyTorch versions, and `fused.make_dyn_regen_image_renderer` over them.

References: the Pallas kernels of `drt_tpu.ops.dynregen` in interpret mode,
once per module on one tile of the glossy scene at depth 3 (planes, a
sphere light, diffuse, specular with a per-ray exponent and mirror
materials; sums rtol 2e-5 / atol 2e-6, rows by sample on the slots that
matter, the sweep on the JAX kernel's rows rtol 2e-5 / atol 1e-7); and the
port's own plain versions: the dyn lockstep tracer, whose samples the
regeneration path reproduces bit for bit (also on the 87-shape mesh, which
never goes through interpret mode), and `ops.regen` on a scene both
families take. Float32 throughout. The kernels themselves are tested on
the card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import dynkernel as jax_dk
from drt_tpu.ops import dynregen as jax_dr
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import dynregen as dr
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.parallel.render import make_renderer
from drt_tpu_torch.scene import (Params, albedo_table, emission_table,
                                 from_numpy)

TOL = dict(rtol=2e-5, atol=2e-6)
FAST_TOL = dict(rtol=2e-3, atol=1e-4)
KERNEL_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
SEEDS = [2024, -77]
# One tile of 1024 lanes (tile_rows=8) holds the 512 pixels; 2 chunks of 2
# samples, depth 3: t_cap = 6.
CFG = RenderConfig(width=32, height=16, spp=4, spp_chunks=2, max_depth=3)
NPIX = CFG.width * CFG.height
SPP_C = CFG.spp // CFG.spp_chunks
LIVE, WANT = 16, 17


def _seeds():
    return torch.tensor(SEEDS, dtype=torch.int32)


def _tables(scene, params):
    return albedo_table(scene, params), emission_table(scene, params)


def _dead(alb, emi):
    return (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)


def _by_sample(cfg, alb, emi, rsc, rrow, trips):
    """Rows as the dyn lockstep collect tracer lays them: the want and
    rr_on bits dropped, the sentinel rows where a sample did not reach."""
    return rg.rows_by_sample(cfg, rsc, rrow, trips, WANT, 0x1FFFF,
                             _dead(alb, emi))


@pytest.fixture(scope="module")
def glossy():
    js, jp, jc = jax_gallery.build_glossy(dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


@pytest.fixture(scope="module")
def plain(glossy):
    """The port's collect form over both chunks, through the wrapper (CPU
    tensors run the plain version and count no launch)."""
    _, (scene, params, cam) = glossy
    alb, emi = _tables(scene, params)
    before = mk.launch_counts()
    out = dr.make_dyn_regen_tracer(scene, cam, CFG, collect=True,
                                   n_chunks=2)(alb, emi, _seeds())
    assert mk.launch_counts() == before
    return out


@pytest.fixture(scope="module")
def pallas(glossy):
    """The two Pallas kernels in interpret mode, each once: the collect
    tracer over both chunks and the sweep over its rows."""
    (js, jp, jc), _ = glossy
    jds = jax_dk.DynScene(js)
    ja, je = jax_albedo_table(js, jp), jax_emission_table(js, jp)
    cfg = JaxConfig(**dataclasses.asdict(CFG))
    kw = dict(tile_rows=8, interpret=True, n_chunks=2)
    L, rsc, rrow, trips = jax_dr.make_dyn_regen_tracer(
        jds, jc, cfg, collect=True, **kw)(
        ja, je, jds.operands, jnp.asarray(SEEDS, jnp.int32))
    g = np.random.default_rng(3).uniform(0.5, 1.5, (3, NPIX)).astype(
        np.float32)
    da, de = jax_dr.make_dyn_regen_sweep_adjoint(jds, cfg, **kw)(
        ja, je, rsc, rrow, trips, JV3(*map(jnp.asarray, g)))
    return dict(L=np.stack([np.asarray(c) for c in L]),
                rsc=np.asarray(rsc).copy(), rrow=np.asarray(rrow).copy(),
                trips=np.asarray(trips), g=g, da=np.asarray(da),
                de=np.asarray(de))


def test_plain_tracer_matches_pallas_sums_and_trips(plain, pallas):
    L, _, _, trips = plain
    assert L.shape == (3, NPIX) and pallas["L"].mean() > 0
    np.testing.assert_allclose(L.numpy(), pallas["L"], **TOL)
    assert trips.shape == (2, NPIX) and trips.dtype == torch.int32
    assert int(trips.min()) >= SPP_C and int(trips.max()) <= rg.t_cap(CFG)
    assert trips.amax(dim=1).tolist() == pallas["trips"][0].tolist()


def test_plain_rows_match_pallas_rows_by_sample(glossy, plain, pallas):
    """rrow = albedo row | emission row << 8 | live << 16 | want << 17 |
    rr_on << 18, one row per trip. Sample by sample, on the slots that
    matter (no earlier live bounce of zero weight in the sample), the rows
    are the JAX kernel's."""
    _, (scene, params, _) = glossy
    alb, emi = _tables(scene, params)
    _, rsc, rrow, trips = plain
    cap = rg.t_cap(CFG)
    t = torch.arange(cap)[None, :, None]
    own = t < trips[:, None, :]
    assert (rsc[~own] == 0).all() and (rrow[~own] == 0).all()
    assert ((rrow >> WANT) & 1)[:, 0].all()  # row 0 starts a sample
    live = ((rrow >> LIVE) & 1) > 0
    assert (live & own).any() and (~live & own).any()
    assert ((rrow[own & ~live] & 0xFFFF) == _dead(alb, emi)).all()
    # The JAX kernel's rows of a pixel end with its last live or want row.
    j_rsc, j_rrow = (torch.as_tensor(pallas[k]) for k in ("rsc", "rrow"))
    used = ((j_rrow >> LIVE) & 3) != 0
    j_trips = (used * (t + 1)).amax(dim=1).to(torch.int32)
    assert (j_trips <= torch.as_tensor(pallas["trips"][0].copy())[:, None]) \
        .all()
    sc_p, row_p = _by_sample(CFG, alb, emi, rsc, rrow, trips)
    sc_j, row_j = _by_sample(CFG, alb, emi, j_rsc, j_rrow, j_trips)
    zero = ((sc_j == 0) & ((row_j >> LIVE) > 0)).to(torch.int32)
    matters = (zero.cumsum(dim=1) - zero) == 0
    assert matters.float().mean() > 0.9
    assert torch.equal(row_p[matters], row_j[matters])
    # The specular weight divides by sqrt(1 - cos_h^2), which loses digits
    # as cos_h -> 1: the two libms' pow may differ by more than TOL on a
    # few glossy slots (tests/test_torch_dynkernel.py).
    got, ref = sc_p[matters].numpy(), sc_j[matters].numpy()
    assert (~np.isclose(got, ref, **TOL)).mean() <= 5e-3
    np.testing.assert_allclose(got, ref, **FAST_TOL)


def test_plain_sweep_matches_pallas_sweep_on_its_rows(glossy, pallas):
    """The port's sweep on the JAX kernel's rows and tile trips: only the
    summation order differs."""
    _, (scene, params, _) = glossy
    alb, emi = _tables(scene, params)
    trips = torch.as_tensor(pallas["trips"][0].copy())[:, None].expand(
        2, NPIX).contiguous()
    da, de = dr.make_dyn_regen_sweep_adjoint(scene, CFG, n_chunks=2)(
        alb, emi, torch.as_tensor(pallas["rsc"]),
        torch.as_tensor(pallas["rrow"]), trips, torch.as_tensor(pallas["g"]))
    assert np.abs(pallas["da"]).max() > 1 and (da[-1] == 0).all()
    np.testing.assert_allclose(da.numpy(), pallas["da"], **KERNEL_GRAD_TOL)
    np.testing.assert_allclose(de.numpy(), pallas["de"], **KERNEL_GRAD_TOL)


def test_sweep_reads_nothing_beyond_a_pixels_trips(glossy, plain):
    _, (scene, params, _) = glossy
    alb, emi = _tables(scene, params)
    _, rsc, rrow, trips = plain
    g = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (3, NPIX)).astype(np.float32))
    want = dr.dyn_regen_sweep_plain(CFG, alb, emi, rsc, rrow, trips, g)
    own = torch.arange(rg.t_cap(CFG))[None, :, None] < trips[:, None, :]
    got = dr.dyn_regen_sweep_plain(
        CFG, alb, emi, torch.where(own, rsc, float("nan")),
        torch.where(own, rrow, -1), trips, g)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


SCENES = {"glossy": partial(gallery.build_glossy, device="cpu"), "mesh87":
          lambda: gallery.build_mesh(1, device="cpu")}


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_samples_are_the_dyn_lockstep_tracers(name, fastmath):
    """Port against port: with one sample per chunk the radiance is the
    dyn lockstep plain tracer's bit for bit; in 2 chunks of 2 the rows by
    sample are its collect form's residuals, and one launch over the
    chunks is the per-chunk launches with sample_base."""
    scene, params, cam = SCENES[name]()
    ds = dk.DynScene(scene)
    alb, emi = _tables(scene, params)
    cfg_s = RenderConfig(width=16, height=8, spp=3, spp_chunks=3,
                         max_depth=4)
    cc = mk.camera_consts(cam, 16, 8)
    kw = dict(fastmath=fastmath)
    L, _ = dr.dyn_regen_trace_plain(ds, cc, cfg_s, alb, emi, SEEDS,
                                    n_chunks=3, **kw)
    assert L.mean() > 0
    assert torch.equal(L, dk.dyn_trace_plain(ds, cc, cfg_s, alb, emi,
                                             seeds=SEEDS, n_chunks=3, **kw))
    cfg = RenderConfig(width=16, height=8, spp=4, spp_chunks=2, max_depth=4)
    Lc, rsc, rrow, trips = dr.dyn_regen_collect_plain(
        ds, cc, cfg, alb, emi, SEEDS, n_chunks=2, **kw)
    _, rsc_l, rrow_l = dk.dyn_collect_plain(ds, cc, cfg, alb, emi,
                                            seeds=SEEDS, n_chunks=2, **kw)
    sc_u, row_u = _by_sample(cfg, alb, emi, rsc, rrow, trips)
    assert torch.equal(row_u, rrow_l) and torch.equal(sc_u, rsc_l)
    parts = [dr.dyn_regen_trace_plain(ds, cc, cfg, alb, emi, SEEDS,
                                      sample_base=c * 2, **kw)
             for c in range(2)]
    assert torch.equal(parts[0][0] + parts[1][0], Lc)
    assert torch.equal(torch.cat([p[1] for p in parts]), trips)
    g = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, (3, 128)).astype(np.float32))
    got = dr.dyn_regen_sweep_plain(cfg, alb, emi, rsc, rrow, trips, g)
    want = dk.dyn_sweep_plain(cfg, alb, emi, rsc_l, rrow_l, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-5)


def test_dyn_family_on_cbox_is_the_scene_table_family():
    """The Cornell box through both families on the same seeds: radiance
    sums within the kernels' tolerance, gradients through the renderers
    too."""
    scene, params, cam = cbox.build(device="cpu")
    outs = []
    for backend in ("torch-dyn-regen", "torch-regen"):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = make_renderer(scene, CFG, cam, backend=backend)(p, _seeds())
        (img ** 2).mean().backward()
        outs.append((img.detach(), p.albedo.grad, p.emission.grad))
    assert outs[0][0].mean() > 0
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(adjoint="stored"), dict(adjoint="retrace"),
    dict(adjoint="stored", chunked=False), dict(adjoint="auto")],
    ids=["stored", "retrace", "stored-per-chunk", "auto"])
def test_renderer_forms_agree_with_the_dyn_lockstep_renderer(glossy, kw):
    """Every form of the regeneration renderer against the dyn lockstep
    renderer at the same seeds: the same samples, summed in another
    order."""
    _, (scene, params, cam) = glossy
    ds = dk.DynScene(scene)
    outs = []
    for make, mkw in ((fused.make_dyn_regen_image_renderer, kw),
                      (fused.make_dyn_image_renderer, {})):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = make(ds, cam, CFG, plain=True, **mkw)(p, _seeds())
        (img ** 2).mean().backward()
        outs.append((img.detach(), p.albedo.grad, p.emission.grad))
    for a, b in zip(*outs):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("make,kw,err,match", [
    ("regen", dict(cfg=dict(unbiased=True)), ValueError, "biased-only"),
    ("regen", dict(cfg=dict(bsdf_samples=2)), ValueError,
     "'cuda-split' / 'cuda-split-dyn'"),
    ("router", dict(backend="pallas-dyn-regen"), ValueError,
     "'pallas-dyn-regen' is 'cuda-dyn-regen'"),
    ("router", dict(backend="cuda-dyn-regen"), ValueError, "CUDA device"),
    ("router", dict(backend="pallas-dyn-regen-sharded"), ValueError,
     "'pallas-dyn-regen-sharded' is 'cuda-dyn-regen-sharded'"),
])
def test_dyn_regen_renderers_refuse(glossy, make, kw, err, match):
    _, (scene, _, cam) = glossy
    cfg = dataclasses.replace(CFG, **kw.pop("cfg", {}))
    with pytest.raises(err, match=match):
        if make == "regen":
            fused.make_dyn_regen_image_renderer(scene, cam, cfg, **kw)
        else:
            make_renderer(scene, cfg, cam, **kw)


def test_collect_refuses_more_rows_than_the_packing_holds(glossy):
    _, (scene, _, cam) = glossy
    big = torch.zeros((257, 3))
    with pytest.raises(ValueError, match="8 bits"):
        dr.dyn_regen_collect(dk.DynScene(scene),
                             mk.camera_consts(cam, 32, 16), CFG, big, big,
                             _seeds())
