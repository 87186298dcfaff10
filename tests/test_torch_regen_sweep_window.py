"""The window kernel of the regeneration sweep adjoint (B11,
csrc/regen_adjoint.cu: regen_window_kernel over csrc/regen_window.cuh)
as a model on the CPU (tests/regen_window_model.py), on the plain
collect form's rows.

The kernel copies each warp's rows in windows of REGEN_WIN rows of its
32 pixels into a ring in shared memory and sweeps each pixel's segments
from there once their rows have landed; the per-pixel kernel, its
checking build, reads them from device memory one at a time. The model
runs both schedules over the same rows with the same statements: every
pixel's accumulator column must come out bit for bit the same, and the
window schedule must read only rows that it copied, that landed and
that the ring still holds, never a row at or past a pixel's trips (those
hold NaN here). The models' op order is the kernels' (float32, no fused
multiply-add), so their columns summed are the plain version's tables
to the summation order; and the plain version on the same rows is held
to the JAX package's Pallas sweep in interpret mode (rtol 2e-5 / atol
1e-7, as tests/test_torch_regen.py holds it), built once per depth.
Cornell box, 16x12 pixels, 2 chunks; the collect form's plain version
has one variant, so fast and exact rows are the same rows."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.ops import regen as jax_rg
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

import regen_window_model as model

KERNEL_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
SEEDS = torch.tensor([2024, -77], dtype=torch.int32)
# (spp, max_depth): chunks of 2 samples (about 6 rows a
# pixel's chunk, one window), and chunks of 16 and 24 samples, whose
# 45-70 rows wrap the ring of the 8-bounce (32 rows) and 32-bounce (64
# rows) instances.
CASES = [(4, 5), (4, 32), (32, 5), (48, 32)]
CASE_IDS = ["spp4-depth5", "spp4-depth32", "spp32-depth5", "spp48-depth32"]


def _cfg(spp, depth):
    return RenderConfig(width=16, height=12, spp=spp, spp_chunks=2,
                        max_depth=depth)


@pytest.fixture(scope="module")
def both():
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


@pytest.fixture(scope="module")
def rows(both):
    """Per case: the plain collect form's rows with NaN (rsc) and -1
    (rmeta) at and past each pixel's trips, its trips and a per-pixel
    cotangent."""
    _, (scene, params, cam) = both
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    out = {}
    for spp, depth in CASES:
        cfg = _cfg(spp, depth)
        cc = mk.camera_consts(cam, cfg.width, cfg.height)
        _, rsc, rmeta, trips = rg.regen_collect_plain(
            scene, cc, cfg, alb, emi, SEEDS, n_chunks=2)
        own = torch.arange(rsc.shape[1])[None, :, None] < trips[:, None, :]
        g = torch.as_tensor(np.random.default_rng(depth + spp).uniform(
            0.5, 1.5, (3, cfg.width * cfg.height)).astype(np.float32))
        out[spp, depth] = dict(
            cfg=cfg, own=own, trips=trips, g=g, rsc=rsc, rmeta=rmeta,
            rsc_nan=torch.where(own, rsc, float("nan")),
            rmeta_nan=torch.where(own, rmeta, -1))
    return out


def _shape_codes(scene, n_alb, n_emi):
    """The window kernel's code word per shape: albedo row + 1 | emission
    row + 1 << 8, 0 for a sentinel row."""
    table = mk.scene_table(scene)
    ar = table[:, mk.R_ALB].long()
    er = table[:, mk.R_EMI].long()
    return (torch.where(ar < n_alb - 1, ar + 1, 0)
            | (torch.where(er < n_emi - 1, er + 1, 0) << 8))


def _tabs(scene, alb, emi):
    return alb, emi, model.table_decode(
        _shape_codes(scene, alb.shape[0], emi.shape[0]))


@pytest.mark.parametrize("spp,depth", CASES, ids=CASE_IDS)
def test_window_schedule_gives_the_per_pixel_columns(both, rows, spp, depth):
    _, (scene, params, _) = both
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    r = rows[spp, depth]
    cfg, trips, g = r["cfg"], r["trips"], r["g"]
    tabs = _tabs(scene, alb, emi)
    want = model.per_pixel_columns(cfg, r["rsc_nan"], r["rmeta_nan"], trips,
                                   tabs, g)
    got, (rounds, samples) = model.window_columns(
        cfg, r["rsc_nan"], r["rmeta_nan"], trips, tabs, g)
    # The lanes of a warp sweep their j-th segments together: a round per
    # sample of the chunk, a few more where the ring cannot hold the rows
    # of every lane's next segment at once.
    assert samples <= rounds <= 1.25 * samples
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all() and (got != 0).any()
    # The columns summed are the plain version's tables (sentinel rows
    # zero) to the summation order.
    da, de = rg.regen_sweep_plain(scene, cfg, alb, emi, r["rsc_nan"],
                                  r["rmeta_nan"], trips, g)
    n_a = (alb.shape[0] - 1) * 3
    sums = got.double().sum(dim=1).float()
    np.testing.assert_allclose(sums[:n_a].numpy(),
                               da[:-1].reshape(-1).numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sums[n_a:].numpy(),
                               de[:-1].reshape(-1).numpy(), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("depth", [5, 32])
def test_windows_wrap_the_ring(rows, depth):
    """The wrap cases hold more rows a pixel's chunk than the ring."""
    spp = 32 if depth == 5 else 48
    trips = rows[spp, depth]["trips"]
    ring = rg.WINDOW_ROWS * rg.ring_windows(depth)
    assert int(trips.max()) > ring + rg.WINDOW_ROWS
    assert int(trips.min()) >= spp // 2


@pytest.fixture(scope="module")
def pallas_sweeps(both, rows):
    """The JAX package's sweep in interpret mode on the 2-sample chunks' rows
    (one tile of 8 x 128 lanes): the port's rows with those past a
    pixel's trips dead (sc 0, meta 0) up to the tile's trips."""
    (js, jp, _), _ = both
    ja, je = jax_albedo_table(js, jp), jax_emission_table(js, jp)
    out = {}
    for spp, depth in CASES[:2]:
        r = rows[spp, depth]
        cfg = r["cfg"]
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        sweep = jax_rg.make_regen_sweep_adjoint(js, jcfg, tile_rows=8,
                                                interpret=True, n_chunks=2)
        rsc = torch.where(r["own"], r["rsc"], 0.0)
        rmeta = torch.where(r["own"], r["rmeta"], 0)
        tile_trips = r["trips"].max(dim=1).values[None, :].to(torch.int32)
        da, de = sweep(ja, je, jnp.asarray(rsc.numpy()),
                       jnp.asarray(rmeta.numpy()),
                       jnp.asarray(tile_trips.numpy()),
                       JV3(*map(jnp.asarray, r["g"].numpy())))
        out[spp, depth] = np.asarray(da), np.asarray(de)
    return out


@pytest.mark.parametrize("spp,depth", CASES[:2], ids=CASE_IDS[:2])
def test_plain_sweep_matches_pallas_sweep(both, rows, pallas_sweeps, spp,
                                          depth):
    _, (scene, params, _) = both
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    r = rows[spp, depth]
    da, de = rg.make_regen_sweep_adjoint(scene, r["cfg"], n_chunks=2)(
        alb, emi, r["rsc_nan"], r["rmeta_nan"], r["trips"], r["g"])
    j_da, j_de = pallas_sweeps[spp, depth]
    assert np.abs(j_da).max() > 0.1 and (da[-1] == 0).all()
    np.testing.assert_allclose(da.numpy(), j_da, **KERNEL_GRAD_TOL)
    np.testing.assert_allclose(de.numpy(), j_de, **KERNEL_GRAD_TOL)
