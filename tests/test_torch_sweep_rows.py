"""The premise of the stored-residual sweeps' early stop (B3 `fused_sweep`,
B8 `dyn_sweep`, csrc/fused_adjoint.cu and csrc/dyn_adjoint.cu): a slot's
rows after its first dead row add nothing, so the kernels read a slot's
rows only up to that row.

- Dead rows are absorbing: in the rows of the JAX package's collect
  tracer (the Pallas kernel in interpret mode, tape mode, as
  tests/test_torch_trips.py runs it), of the port's plain collect tracer
  and of the port's plain mesh collect tracer, a dead row (rbest == 0, or
  the live bit of rrow clear) is followed only by dead rows, and every
  dead row's rsc is finite.
- The sweep does not look past the first dead row: the plain sweeps give
  the same tables, bit for bit, when every row after each slot's first
  dead row is overwritten (rbest = 0 and rsc = 0; or dead rows and
  random finite rsc), and when the rsc of every dead row is random; also
  on the port's plain collect rows at depths on both sides of the
  kernels' 8-row head (2 to 32).

The kernels themselves, and the ring stages they choose by table rows,
are held to their plain versions, to the retrace adjoints and to rows of
NaN after each slot's first dead row on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
          "tri": jax_gallery.build_tri}
CFG = RenderConfig(width=16, height=12, spp=2, max_depth=4)
N = CFG.width * CFG.height * CFG.spp
LIVE_BIT = 1 << 16  # rrow: albedo row | emission row << 8 | live << 16


def _dead_from(live: np.ndarray) -> np.ndarray:
    """Rows at or after each slot's first dead row, of live bool[..., D,
    N]."""
    return np.cumsum(~live, axis=-2) > 0


def _after_dead(live: np.ndarray) -> np.ndarray:
    """Rows after (not at) each slot's first dead row."""
    dead = _dead_from(live)
    return np.cumsum(dead, axis=-2) > 1


def _assert_absorbing(live: np.ndarray, rsc: np.ndarray) -> None:
    dead = _dead_from(live)
    assert not (live & dead).any(), "a live row follows a dead one"
    assert np.isfinite(rsc[dead]).all()
    # Both kinds occur, and some paths outlive their first bounce.
    assert dead.any() and live[..., 1:, :].any()


@pytest.fixture(scope="module", params=sorted(SCENES))
def fused_rows(request):
    """One scene's rows from the JAX collect tracer (one build per scene)
    and from the port's collect twin, on the same numpy uniforms, and the
    port's scene and tables."""
    js, jp, jc = SCENES[request.param](dtype=jnp.float32)
    scene, params, cam = from_numpy(
        *([np.asarray(a) for a in t] for t in (js, jp, jc)), device="cpu")
    r = np.random.default_rng(5)
    cam_u = r.uniform(size=(2, N)).astype(np.float32)
    tape = r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32)
    _, rsc, rbest = jax_mk.make_fused_collect_tracer(
        js, jc, JaxConfig(**dataclasses.asdict(CFG)), tile_rows=1,
        rng="tape", interpret=True)(
        jax_albedo_table(js, jp), jax_emission_table(js, jp),
        jnp.asarray(cam_u), jnp.asarray(tape))
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    _, p_rsc, p_rbest = mk.make_fused_collect_tracer(
        scene, cam, CFG, rng="tape")(alb, emi, torch.as_tensor(cam_u),
                                     torch.as_tensor(tape))
    return dict(scene=scene, alb=alb, emi=emi, rsc=np.array(rsc),
                rbest=np.array(rbest), p_rsc=p_rsc.numpy(),
                p_rbest=p_rbest.numpy(), g=r.uniform(
                    size=(3, N)).astype(np.float32))


@pytest.fixture(scope="module")
def mesh_rows():
    """The port's plain mesh collect tracer on a level-1 icosphere, two
    chunks, internal RNG."""
    cfg = RenderConfig(width=12, height=8, spp=4, spp_chunks=2, max_depth=5)
    scene, params, cam = gallery.build_mesh(level=1, device="cpu")
    ds = dk.DynScene(scene)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg, n_chunks=2)(
        alb, emi, torch.tensor([3, 4], dtype=torch.int32))
    r = np.random.default_rng(6)
    g = r.uniform(size=(3, cfg.width * cfg.height)).astype(np.float32)
    return dict(cfg=cfg, alb=alb, emi=emi, rsc=rsc.numpy(),
                rrow=rrow.numpy(), g=g)


def test_jax_collect_rows_dead_rows_are_absorbing(fused_rows):
    _assert_absorbing(fused_rows["rbest"] > 0, fused_rows["rsc"])


def test_port_collect_rows_dead_rows_are_absorbing(fused_rows):
    _assert_absorbing(fused_rows["p_rbest"] > 0, fused_rows["p_rsc"])


def test_mesh_collect_rows_dead_rows_are_absorbing(mesh_rows):
    live = (mesh_rows["rrow"] & LIVE_BIT) > 0
    assert live.shape == (2, 5, 12 * 8 * 2)
    _assert_absorbing(live, mesh_rows["rsc"])


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.numpy().view(np.int32),
                              y.numpy().view(np.int32))


def _overwrites(live: np.ndarray, rsc: np.ndarray, seed: int):
    """(mask of rows overwritten, rsc after) of the three overwrites: rows
    after the first dead row zeroed, rows after it given random finite
    rsc, and every dead row given random finite rsc."""
    r = np.random.default_rng(seed)
    noise = r.uniform(-4.0, 4.0, size=rsc.shape).astype(np.float32)
    after = _after_dead(live)
    dead = _dead_from(live)
    return [(after, np.where(after, np.float32(0.0), rsc)),
            (after, np.where(after, noise, rsc)),
            (dead, np.where(dead, noise, rsc))]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_fused_sweep_plain_ignores_rows_after_the_first_dead_row(
        fused_rows, source):
    pre = "" if source == "jax" else "p_"
    rsc, rbest = fused_rows[pre + "rsc"], fused_rows[pre + "rbest"]
    s, alb, emi = fused_rows["scene"], fused_rows["alb"], fused_rows["emi"]
    g = torch.as_tensor(fused_rows["g"])
    ref = mk.fused_sweep_plain(s, CFG, alb, emi, torch.as_tensor(rsc),
                               torch.as_tensor(rbest), g)
    assert any(t.abs().sum() > 0 for t in ref)
    for k, (mask, rsc2) in enumerate(_overwrites(rbest > 0, rsc, 7)):
        assert mask.any()
        rbest2 = np.where(mask, 0, rbest).astype(np.int32)
        _same_bits(mk.fused_sweep_plain(
            s, CFG, alb, emi, torch.as_tensor(rsc2), torch.as_tensor(rbest2),
            g), ref)


def test_dyn_sweep_plain_ignores_rows_after_the_first_dead_row(mesh_rows):
    cfg, rsc, rrow = mesh_rows["cfg"], mesh_rows["rsc"], mesh_rows["rrow"]
    alb, emi = mesh_rows["alb"], mesh_rows["emi"]
    g = torch.as_tensor(mesh_rows["g"])
    ref = dk.dyn_sweep_plain(cfg, alb, emi, torch.as_tensor(rsc),
                             torch.as_tensor(rrow), g)
    assert any(t.abs().sum() > 0 for t in ref)
    live = (rrow & LIVE_BIT) > 0
    # A dead row holds the sentinel rows (dyn_bounce.inc).
    sentinel = (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)
    assert (rrow[~live] == sentinel).all()
    for mask, rsc2 in _overwrites(live, rsc, 8):
        assert mask.any()
        rrow2 = np.where(mask, sentinel, rrow).astype(np.int32)
        _same_bits(dk.dyn_sweep_plain(cfg, alb, emi, torch.as_tensor(rsc2),
                                      torch.as_tensor(rrow2), g), ref)


DEPTHS = [2, 5, 8, 9, 32]  # 8 | 9: the kernels' head of a slot's rows


@pytest.mark.parametrize("depth", DEPTHS)
def test_fused_rows_after_the_first_dead_row_are_ignored_at_depth(depth):
    """The port's plain collect tracer on the Cornell box, internal RNG,
    3 chunks: its dead rows are absorbing, and the plain sweep gives the
    same bits with the rows after each slot's first dead row
    overwritten."""
    cfg = RenderConfig(width=8, height=6, spp=3, spp_chunks=3,
                       max_depth=depth)
    scene, params, cam = cbox.build(device="cpu")
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 n_chunks=3)(
        alb, emi, torch.tensor([depth, 9], dtype=torch.int32))
    rsc, rbest = rsc.numpy(), rbest.numpy()
    live = rbest > 0
    _assert_absorbing(live, rsc)
    g = torch.as_tensor(np.random.default_rng(depth).uniform(
        size=(3, cfg.width * cfg.height)).astype(np.float32))
    ref = mk.fused_sweep_plain(scene, cfg, alb, emi, torch.as_tensor(rsc),
                               torch.as_tensor(rbest), g)
    assert any(t.abs().sum() > 0 for t in ref)
    for mask, rsc2 in _overwrites(live, rsc, depth):
        rbest2 = np.where(mask, 0, rbest).astype(np.int32)
        _same_bits(mk.fused_sweep_plain(
            scene, cfg, alb, emi, torch.as_tensor(rsc2),
            torch.as_tensor(rbest2), g), ref)


@pytest.mark.parametrize("depth", DEPTHS)
def test_dyn_rows_after_the_first_dead_row_are_ignored_at_depth(depth):
    """The same for the port's plain mesh collect tracer on a level-1
    icosphere, 2 chunks."""
    cfg = RenderConfig(width=8, height=6, spp=2, spp_chunks=2,
                       max_depth=depth)
    scene, params, cam = gallery.build_mesh(level=1, device="cpu")
    ds = dk.DynScene(scene)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg, n_chunks=2)(
        alb, emi, torch.tensor([depth, 4], dtype=torch.int32))
    rsc, rrow = rsc.numpy(), rrow.numpy()
    live = (rrow & LIVE_BIT) > 0
    _assert_absorbing(live, rsc)
    g = torch.as_tensor(np.random.default_rng(depth).uniform(
        size=(3, cfg.width * cfg.height)).astype(np.float32))
    ref = dk.dyn_sweep_plain(cfg, alb, emi, torch.as_tensor(rsc),
                             torch.as_tensor(rrow), g)
    assert any(t.abs().sum() > 0 for t in ref)
    sentinel = (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)
    for mask, rsc2 in _overwrites(live, rsc, depth):
        rrow2 = np.where(mask, sentinel, rrow).astype(np.int32)
        _same_bits(dk.dyn_sweep_plain(cfg, alb, emi, torch.as_tensor(rsc2),
                                      torch.as_tensor(rrow2), g), ref)
