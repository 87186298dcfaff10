"""The window kernel of the mesh regeneration sweep adjoint (B13,
csrc/dyn_regen_adjoint.cu: dyn_regen_window_kernel over
csrc/regen_window.cuh, the window sweep it shares with B11) as a model on
the CPU (tests/regen_window_model.py, with the memory-resident family's
row decoder), on the plain collect form's rows.

The model runs the window schedule and the per-pixel schedule of the
checking build (drt_dyn_regen_sweep_lockstep) over the same rows with the
same statements: every pixel's accumulator column must come out bit for
bit the same, and the window schedule must read only rows that it
copied, that landed and that the ring still holds, never a row at or
past a pixel's trips (those hold NaN here, and rrow -1). The columns
summed are the plain version's tables to the summation order, and the
plain version on the rows of NaN equals itself on the clean rows. The
glossy scene and the 87-shape mesh, 16x12 pixels, 2 chunks; no JAX
callable runs here (the plain sweep is held to the JAX package's on
glossy in tests/test_torch_dynregen.py)."""

import numpy as np
import pytest
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import dynregen as dr
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.scene import albedo_table, emission_table

import regen_window_model as model

SEEDS = torch.tensor([2024, -77], dtype=torch.int32)
SCENES = {"glossy": gallery.build_glossy,
          "mesh87": lambda device: gallery.build_mesh(1, device=device)}
# (spp, max_depth): chunks of 2 samples (one window or two), and chunks
# of 12 and 18 samples, whose 47 and 83 rows at most wrap the ring of the
# 8-bounce (32 rows) and the 32-bounce (64 rows) instance.
CASES = [(4, 5), (4, 32), (24, 5), (36, 32)]
CASE_IDS = ["spp4-depth5", "spp4-depth32", "spp24-depth5", "spp36-depth32"]


def _cfg(spp, depth):
    return RenderConfig(width=16, height=12, spp=spp, spp_chunks=2,
                        max_depth=depth)


@pytest.fixture(scope="module")
def rows():
    """Per (scene, case): the tables, the plain collect form's rows (fast
    variant) with NaN (rsc) and -1 (rrow) at and past each pixel's trips,
    the clean rows, its trips and a per-pixel cotangent."""
    out = {}
    for name, build in SCENES.items():
        scene, params, cam = build(device="cpu")
        ds = dk.DynScene(scene)
        alb, emi = albedo_table(scene, params), emission_table(scene, params)
        for spp, depth in CASES:
            cfg = _cfg(spp, depth)
            cc = mk.camera_consts(cam, cfg.width, cfg.height)
            _, rsc, rrow, trips = dr.dyn_regen_collect_plain(
                ds, cc, cfg, alb, emi, SEEDS, n_chunks=2, fastmath=True)
            own = (torch.arange(rsc.shape[1])[None, :, None]
                   < trips[:, None, :])
            g = torch.as_tensor(np.random.default_rng(depth + spp).uniform(
                0.5, 1.5, (3, cfg.width * cfg.height)).astype(np.float32))
            out[name, spp, depth] = dict(
                cfg=cfg, alb=alb, emi=emi, trips=trips, g=g, rsc=rsc,
                rrow=rrow, rsc_nan=torch.where(own, rsc, float("nan")),
                rrow_nan=torch.where(own, rrow, -1))
    return out


def _tabs(r):
    alb, emi = r["alb"], r["emi"]
    return alb, emi, model.dyn_decode(alb.shape[0], emi.shape[0])


@pytest.mark.parametrize("spp,depth", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_window_schedule_gives_the_per_pixel_columns(rows, scene, spp,
                                                     depth):
    r = rows[scene, spp, depth]
    cfg, trips, g = r["cfg"], r["trips"], r["g"]
    tabs = _tabs(r)
    want = model.per_pixel_columns(cfg, r["rsc_nan"], r["rrow_nan"], trips,
                                   tabs, g)
    got, (rounds, samples) = model.window_columns(
        cfg, r["rsc_nan"], r["rrow_nan"], trips, tabs, g)
    # A round per sample of the chunk, a few more where the ring cannot
    # hold the rows of every lane's next segment at once.
    assert samples <= rounds <= 1.25 * samples
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all() and (got != 0).any()
    da, de = dr.dyn_regen_sweep_plain(cfg, r["alb"], r["emi"], r["rsc"],
                                      r["rrow"], trips, g)
    n_a = (r["alb"].shape[0] - 1) * 3
    sums = got.double().sum(dim=1).float()
    np.testing.assert_allclose(sums[:n_a].numpy(),
                               da[:-1].reshape(-1).numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sums[n_a:].numpy(),
                               de[:-1].reshape(-1).numpy(), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("depth", [5, 32])
def test_windows_wrap_the_ring(rows, scene, depth):
    """The wrap cases hold more rows a pixel's chunk than the ring of
    their instance."""
    spp = 24 if depth == 5 else 36
    trips = rows[scene, spp, depth]["trips"]
    ring = rg.WINDOW_ROWS * rg.ring_windows(depth)
    assert int(trips.max()) > ring + rg.WINDOW_ROWS
    assert int(trips.min()) >= spp // 2


@pytest.mark.parametrize("spp,depth", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_sweep_ignores_rows_past_the_trips(rows, scene, spp, depth):
    r = rows[scene, spp, depth]
    sweep = dr.make_dyn_regen_sweep_adjoint(None, r["cfg"], n_chunks=2)
    args = (r["alb"], r["emi"])
    clean = sweep(*args, r["rsc"], r["rrow"], r["trips"], r["g"])
    nan = sweep(*args, r["rsc_nan"], r["rrow_nan"], r["trips"], r["g"])
    assert all(torch.equal(a, b) for a, b in zip(nan, clean))
    assert (clean[0][:-1] != 0).any() and (clean[0][-1] == 0).all()
