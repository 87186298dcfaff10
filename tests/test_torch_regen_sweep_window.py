"""The window kernel of the regeneration sweep adjoint (B11,
csrc/regen_adjoint.cu: regen_window_kernel) as a model on the CPU, on
the plain collect form's rows.

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

KERNEL_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
BLOCK, WARP = 128, 32
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


def _segments(m, t, t_act, read, tabs, g, acc, dmax, inv_keep):
    """One sample's segment of each lane in m, from its row t (a want
    row) of its t_act rows, replayed and swept into acc[E, lanes] by the
    statements of regen_sweep_chunk / window_segment, a lane per column.
    read(rows, mask) -> (sc, meta) at each lane's row. Returns each
    lane's segment length (0 outside m)."""
    alb, emi, code = tabs
    n_alb = alb.shape[0]
    lanes = torch.arange(m.shape[0])

    def decode(meta):
        best = meta & 0xFF
        cd = code[(best - 1).clamp(0, code.shape[0] - 1)]
        arow = torch.where(best > 0, (cd & 255) - 1, -1)
        erow = torch.where(best > 0, ((cd >> 8) & 255) - 1, -1)
        return (arow, erow, best > 0, ((meta >> 9) & 1) > 0,
                ((meta >> 8) & 1) > 0)

    def rows_of(tab, row, fill):
        return torch.where(row >= 0, tab[row.clamp(min=0)].T, fill)

    one = torch.tensor(1.0, dtype=torch.float32)
    zero = torch.tensor(0.0, dtype=torch.float32)
    inv_keep = torch.tensor(inv_keep, dtype=torch.float32)
    _, meta = read(t, m)
    T = torch.ones((3, m.shape[0]), dtype=torch.float32)
    steps, length, is_open = [], torch.zeros_like(t), m.clone()
    for k in range(dmax):
        on = is_open
        if not on.any():
            break
        arow, erow, live, rr_on, _ = decode(meta)
        sc, _ = read(t + k, on)
        gate = torch.where(live, torch.where(rr_on, inv_keep, one), zero)
        P = T * gate
        T = torch.where(on, P * rows_of(alb, arow, 1.0) * sc, T)
        steps.append((on, P, sc, gate, arow, erow))
        length = torch.where(on, k + 1, length)
        more = on & (t + k + 1 < t_act)
        _, nxt = read(t + k + 1, more)
        meta = torch.where(more, nxt, meta)
        is_open = more & ~decode(meta)[4]
    S = torch.zeros((3, m.shape[0]), dtype=torch.float32)
    for on, P, sc, gate, arow, erow in reversed(steps):
        e = rows_of(emi, erow, 0.0)
        a = rows_of(alb, arow, 1.0)
        gP = g * P
        for ch in range(3):
            ke = on & (erow >= 0)
            ie = (n_alb - 1) * 3 + erow[ke] * 3 + ch
            acc[ie, lanes[ke]] = acc[ie, lanes[ke]] + gP[ch][ke]
            ka = on & (arow >= 0)
            ia = arow[ka] * 3 + ch
            acc[ia, lanes[ka]] = (acc[ia, lanes[ka]]
                                  + gP[ch][ka] * sc[ka] * S[ch][ka])
        S = torch.where(on, (e + a * sc * S) * gate, S)
    return length


def _tabs(scene, alb, emi):
    return alb, emi, _shape_codes(scene, alb.shape[0], emi.shape[0])


def _dmax(depth):
    return 8 if depth <= 8 else 32


def per_pixel_columns(cfg, rsc, rmeta, trips, tabs, g):
    """The checking build's order: each pixel's chunks in order, its
    segments in row order, the rows read from the arrays themselves."""
    C, cap, n = rsc.shape
    alb, emi, _ = tabs
    E = (alb.shape[0] - 1 + emi.shape[0] - 1) * 3
    acc = torch.zeros((E, n), dtype=torch.float32)
    inv_keep = np.float32(1.0 / (1.0 - cfg.absorb_prob))
    pix = torch.arange(n)
    for c in range(C):
        tr = trips[c].long()

        def read(row, mask):
            at = row.clamp(max=cap - 1)
            sc, meta = rsc[c, at, pix], rmeta[c, at, pix].long()
            assert torch.isfinite(sc[mask]).all() and (meta[mask] >= 0).all()
            return sc, meta

        t = torch.zeros(n, dtype=torch.long)
        while (t < tr).any():
            m = t < tr
            t = t + _segments(m, t, tr, read, tabs, g, acc,
                              _dmax(cfg.max_depth), inv_keep)
    return acc


def window_columns(cfg, rsc, rmeta, trips, tabs, g):
    """The window kernel's schedule, warp by warp of each 128-pixel group
    and chunk by chunk: window v (rows [v W, v W + W) of the warp's 32
    pixels, a lane's only below its trips) copied into slots r % ROWS,
    the windows landing in order as ring_wait lets them; in rounds, each
    lane sweeps its next segment once the rows of every lane's next
    segment have landed (from t to t + max_depth, or all of its own), or,
    where the ring cannot take the window that needs, the lanes whose
    rows have; window v is copied once every lane still at work is past
    window v - WINDOWS. Every read is checked against the row the slot
    holds and whether it has landed. Returns the columns and (rounds run,
    samples a warp's lanes have)."""
    C, cap, n = rsc.shape
    alb, emi, _ = tabs
    E = (alb.shape[0] - 1 + emi.shape[0] - 1) * 3
    W, D = rg.WINDOW_ROWS, cfg.max_depth
    windows = rg.ring_windows(D)
    ROWS = windows * W
    groups = -(-n // BLOCK)
    acc = torch.zeros((E, groups * BLOCK), dtype=torch.float32)
    rounds = [0, 0]  # the warps' rounds, and the samples of their chunks
    inv_keep = np.float32(1.0 / (1.0 - cfg.absorb_prob))
    lane = torch.arange(WARP)
    for grp in range(groups):
        for c in range(C):
            for w0 in range(BLOCK // WARP):
                pix = grp * BLOCK + w0 * WARP + lane
                ok = pix < n
                tr = torch.where(ok, trips[c, pix.clamp(max=n - 1)].long(),
                                 0)
                n_win = -(-int(tr.max()) // W)
                ring_sc = torch.full((ROWS, WARP), float("nan"))
                ring_meta = torch.full((ROWS, WARP), -1, dtype=torch.long)
                tag = torch.full((ROWS, WARP), -1, dtype=torch.long)
                arrived = torch.ones((ROWS, WARP), dtype=torch.bool)
                pending = []

                def copy(v):
                    slots = []
                    for k in range(W):
                        r = v * W + k
                        s = r % ROWS
                        on = r < tr
                        at = min(r, cap - 1)
                        src = pix.clamp(max=n - 1)
                        ring_sc[s] = torch.where(on, rsc[c, at, src], 0.0)
                        ring_meta[s] = torch.where(
                            on, rmeta[c, at, src].long(), 0)
                        tag[s] = torch.where(on, r, -2)
                        arrived[s] = False
                        slots.append(s)
                    pending.append(slots)

                def wait(allowed):
                    while len(pending) > allowed:
                        arrived[pending.pop(0)] = True

                def read(row, mask):
                    s = row % ROWS
                    held = (tag[s, lane] == row) & arrived[s, lane]
                    assert held[mask].all(), "a row the ring does not hold"
                    sc, meta = ring_sc[s, lane], ring_meta[s, lane]
                    assert torch.isfinite(sc[mask]).all()
                    return sc, meta

                def may_copy(v, t_min):
                    return v < n_win and (v - windows + 1) * W <= t_min

                def lagging(t):
                    return int(torch.where(t < tr, t, 1 << 30).min())

                copied, landed = 0, 0
                while copied < min(n_win, windows):
                    copy(copied)
                    copied += 1
                t = torch.zeros(WARP, dtype=torch.long)
                col = torch.zeros((E, WARP), dtype=torch.float32)
                col[:] = acc[:, grp * BLOCK + w0 * WARP + lane]
                while (t < tr).any():
                    work = t < tr
                    need = int(torch.where(work, torch.minimum(
                        t + D + 1, tr), 0).max())
                    while landed * W < need:
                        if landed == copied:
                            if not may_copy(copied, lagging(t)):
                                break
                            copy(copied)
                            copied += 1
                        wait(copied - landed - 1)
                        landed += 1
                    top = landed * W
                    m = work & ((t + D < top) | (top >= tr))
                    assert m[t == lagging(t)].all(), "the last lane waits"
                    rounds[0] += 1
                    t = t + _segments(m, t, tr, read, tabs,
                                      g[:, pix.clamp(max=n - 1)], col,
                                      _dmax(D), inv_keep)
                    while may_copy(copied, lagging(t)):
                        copy(copied)
                        copied += 1
                rounds[1] += int(tr.gt(0).any()) * (
                    cfg.spp // cfg.spp_chunks)
                assert (t == tr).all(), "rows left unswept"
                acc[:, grp * BLOCK + w0 * WARP + lane] = col
    return acc[:, :n], rounds


@pytest.mark.parametrize("spp,depth", CASES, ids=CASE_IDS)
def test_window_schedule_gives_the_per_pixel_columns(both, rows, spp, depth):
    _, (scene, params, _) = both
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    r = rows[spp, depth]
    cfg, trips, g = r["cfg"], r["trips"], r["g"]
    tabs = _tabs(scene, alb, emi)
    want = per_pixel_columns(cfg, r["rsc_nan"], r["rmeta_nan"], trips, tabs,
                             g)
    got, (rounds, samples) = window_columns(cfg, r["rsc_nan"],
                                            r["rmeta_nan"], trips, tabs, g)
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
