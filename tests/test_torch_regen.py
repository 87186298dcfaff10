"""drt_tpu_torch.ops.regen on the CPU, where the wrappers of the
path-regeneration kernels run their plain PyTorch versions, and
`fused.make_regen_image_renderer` over them.

References: the Pallas regeneration kernels of `drt_tpu.ops.regen` in
interpret mode on one tile of the Cornell box, each built and run once per
module (per-pixel sums rtol 2e-5 / atol 2e-6; rows equal up to each
pixel's own count, the JAX kernel's rows beyond it dead; the sweep on the
JAX kernel's rows rtol 2e-5 / atol 1e-7, both sides in the kernels' op
order); the JAX regeneration renderer's image and `jax.grad` (rtol 1e-4 /
atol 1e-5); and the port's own lockstep plain versions, whose samples the
regeneration path must reproduce bit for bit. Float32 throughout. The
kernels themselves are tested on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.fused import make_regen_image_renderer as jax_regen_renderer
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.ops import regen as jax_rg
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import Params as JaxParams
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.ops.rng import hash_uniform
from drt_tpu_torch.parallel.render import make_renderer
from drt_tpu_torch.scene import (Params, albedo_table, emission_table,
                                 from_numpy)

TOL = dict(rtol=2e-5, atol=2e-6)
KERNEL_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
SEEDS = [12345, 67890]
# One tile of 1024 lanes (tile_rows=8) holds the 960 pixels; 2 chunks of 3
# samples, depth 4: t_cap = 12.
CFG = RenderConfig(width=40, height=24, spp=6, spp_chunks=2, max_depth=4)
NPIX = CFG.width * CFG.height
SPP_C = CFG.spp // CFG.spp_chunks


def _jcfg(cfg=CFG, **kw):
    return JaxConfig(**{**dataclasses.asdict(cfg), **kw})


def _seeds():
    return torch.tensor(SEEDS, dtype=torch.int32)


def _np3(L):
    return np.stack([np.asarray(c) for c in L])


@pytest.fixture(scope="module")
def both():
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


@pytest.fixture(scope="module")
def tables(both):
    _, (scene, params, cam) = both
    return (albedo_table(scene, params), emission_table(scene, params),
            mk.camera_consts(cam, CFG.width, CFG.height))


@pytest.fixture(scope="module")
def plain(both, tables):
    """The port's collect form over both chunks, through the wrapper (CPU
    tensors run the plain version and count no launch)."""
    _, (scene, _, cam) = both
    alb, emi, _ = tables
    before = mk.launch_counts()
    out = rg.make_regen_tracer(scene, cam, CFG, collect=True, n_chunks=2)(
        alb, emi, _seeds())
    assert mk.launch_counts() == before
    return out


@pytest.fixture(scope="module")
def pallas(both):
    """The Pallas kernels in interpret mode, each once: the collect tracer
    over both chunks, the tracer on chunk 1 alone (sample_base), and the
    sweep over the collect tracer's rows."""
    (js, jp, jc), _ = both
    ja, je = jax_albedo_table(js, jp), jax_emission_table(js, jp)
    seeds = jnp.asarray(SEEDS, jnp.int32)
    kw = dict(tile_rows=8, interpret=True)
    L, rsc, rmeta, trips = jax_rg.make_regen_tracer(
        js, jc, _jcfg(), collect=True, n_chunks=2, **kw)(ja, je, seeds)
    L1, trips1 = jax_rg.make_regen_tracer(js, jc, _jcfg(), **kw)(
        ja, je, seeds, sample_base=SPP_C)
    g = np.random.default_rng(3).uniform(0.5, 1.5, (3, NPIX)).astype(
        np.float32)
    da, de = jax_rg.make_regen_sweep_adjoint(js, _jcfg(), n_chunks=2, **kw)(
        ja, je, rsc, rmeta, trips, JV3(*map(jnp.asarray, g)))
    return dict(L=_np3(L), rsc=np.asarray(rsc), rmeta=np.asarray(rmeta),
                trips=np.asarray(trips), L1=_np3(L1),
                trips1=np.asarray(trips1), g=g, da=np.asarray(da),
                de=np.asarray(de))


def test_hash_uniform_takes_per_lane_sample_and_bounce():
    """The draw of a lane at its own (sample, bounce), as the trip loop
    asks for it, is the JAX package's."""
    r = np.random.default_rng(0)
    pix = r.integers(0, 1 << 20, 257)
    s = r.integers(0, 1 << 10, 257)
    b = r.integers(0, 32, 257)
    for seed, dim in ((12345, 0), (-77, 2)):
        want = np.asarray(jax_rg.hash_uniform(
            seed, jnp.asarray(pix, jnp.int32), jnp.asarray(s, jnp.int32),
            jnp.asarray(b, jnp.int32), dim, jnp.float32))
        got = hash_uniform(seed, torch.as_tensor(pix), torch.as_tensor(s),
                           torch.as_tensor(b), dim).numpy()
        np.testing.assert_array_equal(got, want)


def test_plain_tracer_matches_pallas_sums(plain, pallas):
    L = plain[0].numpy()
    assert L.shape == (3, NPIX) and pallas["L"].mean() > 0
    np.testing.assert_allclose(L, pallas["L"], **TOL)


def test_trips_are_per_pixel_and_their_tile_maximum_is_pallas_trips(
        plain, pallas):
    trips = plain[3]
    assert trips.shape == (2, NPIX) and trips.dtype == torch.int32
    assert int(trips.min()) >= SPP_C and int(trips.max()) <= rg.t_cap(CFG)
    assert trips.amax(dim=1).tolist() == pallas["trips"][0].tolist()


def _by_sample(rsc, rcode, trips):
    """Rows as (sc, code) [C, D, spp_c * n] numpy, `code` with the want
    and rr_on bits kept."""
    sc, code = rg.rows_by_sample(CFG, torch.as_tensor(rsc.copy()),
                                 torch.as_tensor(rcode.copy()),
                                 torch.as_tensor(trips), 8, 0x3FF, 0)
    return sc.numpy(), code.numpy()


def _matters(sc, code):
    """Slots with no earlier live bounce of weight sc == 0 in their
    sample: what comes after (a ray that hit the light goes on with a zero
    direction) is cut off from the estimator and decided by an ulp, also
    whether the path takes one more trip."""
    zero = (sc == 0) & ((code & 0xFF) > 0)
    return (np.cumsum(zero, axis=1) - zero) == 0


def test_plain_rows_equal_pallas_rows_up_to_each_pixels_trips(plain, pallas):
    """One row per trip, the dying trip included, in the JAX kernel's
    packing. A pixel's rows end with its own trips; up to its tile's trips
    the JAX kernel wrote dead rows, which the port neither writes nor
    reads. Pixels all of whose slots matter agree row for row; the others
    sample by sample on the slots that matter."""
    _, rsc, rmeta, trips = (t.numpy() for t in plain)
    cap = rg.t_cap(CFG)
    assert rsc.shape == rmeta.shape == (2, cap, NPIX)
    t = np.arange(cap)[None, :, None]
    own = t < trips[:, None, :]
    assert (rsc[~own] == 0).all() and (rmeta[~own] == 0).all()
    assert ((rmeta >> 8) & 1)[:, 0].all()  # row 0 starts a sample
    # The JAX kernel's rows of a pixel end with its last live or want row
    # (a dying row after it looks like the dead rows that follow).
    j_rsc, j_rmeta = pallas["rsc"], pallas["rmeta"]
    used = (j_rmeta & 0x1FF) != 0
    j_trips = (used * (t + 1)).max(axis=1).astype(np.int32)
    assert (j_trips <= pallas["trips"][0][:, None]).all()

    sc_p, code_p = _by_sample(rsc, rmeta, trips)
    sc_j, code_j = _by_sample(j_rsc, j_rmeta, j_trips)
    matters = _matters(sc_j, code_j)
    assert matters.mean() > 0.9
    # best and want everywhere; rr_on on the live slots (a sample's last,
    # dying row looks like the dead rows after it in the JAX kernel's).
    np.testing.assert_array_equal(code_p[matters] & 0x1FF,
                                  code_j[matters] & 0x1FF)
    live = matters & ((code_j & 0xFF) > 0)
    np.testing.assert_array_equal(code_p[live], code_j[live])
    np.testing.assert_allclose(sc_p[matters], sc_j[matters], **TOL)

    whole = matters.reshape(2, CFG.max_depth, SPP_C, NPIX).all(axis=(1, 2))
    assert whole.mean() > 0.9
    rows = own & whole[:, None, :]
    np.testing.assert_array_equal(rmeta[rows], j_rmeta[rows])
    np.testing.assert_allclose(rsc[rows], j_rsc[rows], **TOL)
    beyond = (t < pallas["trips"][0][:, None, None]) & ~own \
        & whole[:, None, :]
    assert beyond.any() and ((j_rmeta[beyond] & 0x1FF) == 0).all()


def test_launch_with_sample_base_is_a_chunk_of_the_chunked_launch(
        both, tables, plain, pallas):
    _, (scene, _, cam) = both
    alb, emi, cc = tables
    one = rg.make_regen_tracer(scene, cam, CFG, n_chunks=1)
    L0, trips0 = one(alb, emi, _seeds(), 0)
    L1, trips1 = one(alb, emi, _seeds(), SPP_C)
    assert torch.equal(L0 + L1, plain[0])
    assert torch.equal(torch.cat([trips0, trips1]), plain[3])
    np.testing.assert_allclose(L1.numpy(), pallas["L1"], **TOL)
    assert int(trips1.max()) == int(pallas["trips1"][0])
    with pytest.raises(ValueError, match="31 bits"):
        one(alb, emi, _seeds(), -1)
    with pytest.raises(ValueError, match="keyed hash"):
        rg.regen_trace(scene, None, cc, CFG, alb, emi, None)


def test_plain_sweep_matches_pallas_sweep_on_its_rows(both, tables, pallas):
    """The port's sweep on the JAX kernel's rows and tile trips (the rows
    between a pixel's count and the tile's are dead there): only the
    summation order differs."""
    _, (scene, _, _) = both
    alb, emi, _ = tables
    trips = torch.as_tensor(pallas["trips"][0].copy())[:, None].expand(
        2, NPIX).contiguous()
    da, de = rg.make_regen_sweep_adjoint(scene, CFG, n_chunks=2)(
        alb, emi, torch.as_tensor(pallas["rsc"].copy()),
        torch.as_tensor(pallas["rmeta"].copy()), trips,
        torch.as_tensor(pallas["g"]))
    assert np.abs(pallas["da"]).max() > 1 and (da[-1] == 0).all()
    np.testing.assert_allclose(da.numpy(), pallas["da"], **KERNEL_GRAD_TOL)
    np.testing.assert_allclose(de.numpy(), pallas["de"], **KERNEL_GRAD_TOL)


def test_sweep_reads_nothing_beyond_a_pixels_trips(both, tables, plain):
    _, (scene, _, _) = both
    alb, emi, _ = tables
    _, rsc, rmeta, trips = plain
    g = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (3, NPIX)).astype(np.float32))
    want = rg.regen_sweep_plain(scene, CFG, alb, emi, rsc, rmeta, trips, g)
    own = torch.arange(rg.t_cap(CFG))[None, :, None] < trips[:, None, :]
    got = rg.regen_sweep_plain(
        scene, CFG, alb, emi, torch.where(own, rsc, float("nan")),
        torch.where(own, rmeta, -1), trips, g)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("spp,chunks", [(4, 4), (6, 2)])
def test_samples_are_the_lockstep_tracers(both, tables, spp, chunks):
    """Sample for sample the lockstep path: with one sample per chunk the
    radiance is the lockstep plain tracer's bit for bit, and in any
    chunking the rows laid out by sample are the lockstep collect
    tracer's residuals, so the sweeps agree to the summation order."""
    _, (scene, _, cam) = both
    alb, emi, cc = tables
    cfg = dataclasses.replace(CFG, spp=spp, spp_chunks=chunks)
    L, rsc, rmeta, trips = rg.regen_collect_plain(
        scene, cc, cfg, alb, emi, SEEDS, n_chunks=chunks)
    L_lock, rsc_l, rbest_l = mk.fused_collect_plain(
        scene, cc, cfg, alb, emi, seeds=SEEDS, n_chunks=chunks)
    if spp == chunks:
        assert torch.equal(L, L_lock)
    else:
        np.testing.assert_allclose(
            L.numpy(), L_lock.reshape(3, -1, NPIX).sum(1).numpy(), **TOL)
    sc_u, best_u = rg.rows_by_sample(cfg, rsc, rmeta, trips, 8, 0xFF, 0)
    assert torch.equal(best_u, rbest_l) and torch.equal(sc_u, rsc_l)
    g = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, (3, NPIX)).astype(np.float32))
    got = rg.regen_sweep_plain(scene, cfg, alb, emi, rsc, rmeta, trips, g)
    want = mk.fused_sweep_plain(scene, cfg, alb, emi, rsc_l, rbest_l, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jax_render(both):
    """Image and parameter gradients of the JAX regeneration renderer
    (stored adjoint; its retrace form gives the same, tests/test_regen.py)
    for a numpy cotangent."""
    (js, jp, jc), _ = both
    gw = np.random.default_rng(7).normal(size=(CFG.height, CFG.width, 3)) \
        .astype(np.float32)
    render = jax_regen_renderer(js, jc, _jcfg(), tile_rows=8, interpret=True,
                                adjoint="stored")
    seeds = jnp.asarray(SEEDS, jnp.int32)
    (_, img), grads = jax.value_and_grad(
        lambda p: ((render(p, seeds) * gw).sum(), render(p, seeds)),
        has_aux=True)(JaxParams(*jp))
    return gw, np.asarray(img), np.asarray(grads.albedo), \
        np.asarray(grads.emission)


@pytest.mark.parametrize("kw", [
    dict(adjoint="stored"), dict(adjoint="retrace"),
    dict(adjoint="stored", chunked=False), dict(adjoint="auto")],
    ids=["stored", "retrace", "stored-per-chunk", "auto"])
def test_renderer_matches_jax_renderer_and_grad(both, jax_render, kw):
    _, (scene, params, cam) = both
    gw, img_ref, da_ref, de_ref = jax_render
    p = Params(*(t.clone().requires_grad_() for t in params))
    img = fused.make_regen_image_renderer(scene, cam, CFG, plain=True, **kw)(
        p, _seeds())
    (img * torch.as_tensor(gw)).sum().backward()
    assert img.shape == (CFG.height, CFG.width, 3)
    np.testing.assert_allclose(img.detach().numpy(), img_ref, **RENDER_TOL)
    np.testing.assert_allclose(p.albedo.grad.numpy(), da_ref, **RENDER_TOL)
    np.testing.assert_allclose(p.emission.grad.numpy(), de_ref, **RENDER_TOL)


def test_retrace_backward_is_the_stored_one_launched_per_chunk(both):
    """Both run the collect form and the sweep chunk by chunk: the same
    bits. Under no_grad, or with differentiable=False, the forward is the
    tracer form and the image the same."""
    _, (scene, params, cam) = both
    outs = []
    for kw in (dict(adjoint="retrace"),
               dict(adjoint="stored", chunked=False)):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = fused.make_regen_image_renderer(scene, cam, CFG, **kw)(
            p, _seeds())
        (img ** 2).mean().backward()
        outs.append((img.detach(), p.albedo.grad, p.emission.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain_img = fused.make_regen_image_renderer(scene, cam, CFG)(
            params, _seeds())
    frozen = make_renderer(scene, CFG, cam, differentiable=False,
                           backend="torch-regen")(
        Params(params.albedo.clone().requires_grad_(), params.emission),
        _seeds())
    assert frozen.grad_fn is None
    assert torch.equal(plain_img, outs[0][0])
    assert torch.equal(frozen, outs[0][0])


def test_image_is_the_lockstep_image_up_to_summation_order(both):
    _, (scene, params, cam) = both
    regen = make_renderer(scene, CFG, cam, differentiable=False,
                          backend="torch-regen")(params, _seeds())
    lock = make_renderer(scene, CFG, cam, differentiable=False,
                         backend="torch")(params, _seeds())
    rel = (regen - lock).abs() / lock.clamp_min(lock.mean())
    assert lock.mean() > 0 and float(rel.max()) <= 1e-6


@pytest.mark.parametrize("make,kw,err,match", [
    ("regen", dict(cfg=dict(unbiased=True)), ValueError, "biased-only"),
    ("regen", dict(cfg=dict(unbiased=True), adjoint="retrace"), ValueError,
     "biased-only"),
    ("regen", dict(cfg=dict(bsdf_samples=2)), ValueError,
     "'cuda-split' / 'cuda-split-dyn'"),
    ("regen", dict(adjoint="bogus"), ValueError, "unknown adjoint"),
    ("router", dict(backend="pallas-regen"), ValueError,
     "'pallas-regen' is 'cuda-regen'"),
    ("router", dict(backend="cuda-regen"), ValueError, "CUDA device"),
    ("router", dict(backend="pallas-regen-sharded"), ValueError,
     "'pallas-regen-sharded' is 'cuda-regen-sharded'"),
])
def test_regen_renderers_refuse(both, make, kw, err, match):
    _, (scene, _, cam) = both
    cfg = dataclasses.replace(CFG, **kw.pop("cfg", {}))
    with pytest.raises(err, match=match):
        if make == "regen":
            fused.make_regen_image_renderer(scene, cam, cfg, **kw)
        else:
            make_renderer(scene, cfg, cam, **kw)


def test_stats_dict_counts_the_warp_trips():
    """`stats_dict`'s warp-trips from per-pixel trips, against a loop
    written out: 40 pixels (a warp of 32 and a partial one of 8) over 2
    chunks whose slowest pixels differ. The memory-resident regeneration
    tracer's checking build must run exactly `warp_trips`."""
    trips = torch.full((2, 40), 2, dtype=torch.int32)
    trips[0, 3] = 9     # warp 0's slowest pixel in chunk 0
    trips[1, 7] = 8     # ... and in chunk 1
    trips[1, 3] = 4
    trips[0, 35] = 6    # the partial warp
    trips[1, 38] = 7
    trips[1, 35] = 3
    stats = torch.arange(rg.N_STATS, dtype=torch.int64)
    d = rg.stats_dict(stats, trips, "radiance")
    warp_trips = by_chunk = 0
    for w0 in range(0, 40, 32):
        pixels = range(w0, min(w0 + 32, 40))
        warp_trips += max(int(trips[0, p]) + int(trips[1, p])
                          for p in pixels)
        by_chunk += sum(max(int(trips[c, p]) for p in pixels)
                        for c in range(2))
    assert (warp_trips, by_chunk) == (13 + 9, 17 + 13)
    assert d["warp_trips"] == warp_trips
    assert d["warp_trips_by_chunk"] == by_chunk
    assert d["trips_sum"] == int(trips.sum()) and d["trips_max"] == 9
    assert [d[k] for k in rg.STAT_NAMES] == list(range(rg.N_STATS))
    assert d["radiance"] == "radiance"
