"""The premise of the segment adjoint's queue (B4-seg,
`drt_fused_segment_adjoint`, csrc/fused_adjoint.cu:segment_queue_kernel):
a path that ends before the segment's end can stop its sweep at its last
trip if it seeds S by the rule the kernel uses.

The lockstep loop (its checking build `drt_fused_segment_adjoint_lockstep`)
sweeps all b1 - b0 rows of every lane from S_end. The queue takes a trip
only on a bounce a path enters alive, and sweeps the rows of its trips
from its last down, seeded by S_end where its last trip ran bounce
b1 - 1, and by what one dead row makes of S_end where it came earlier or
there was none; +0 without S_end. On the rows of the plain version
(`segment_trace_plain(collect=True)`, the rows `segment_adjoint_plain`
sweeps; held to the JAX package's segment kernels by
tests/test_torch_segments.py), in f32, with the kernels' statements per
lane (a column per lane, no real row for a dead row), this file checks:

- the trips are a prefix of the rows, and every row after a lane's trips
  is dead (gate = +0, sc = +0: no real row), the rows the queue skips;
- the two sweeps give the same columns and the same S at the segment's
  entry, bit for bit, for S_end of +0, -0, negative, large, NaN and inf;
- on paths whose last trip is a miss at b1 - 1, paths that Russian
  roulette ends inside the segment, lanes that enter dead and pad lanes
  (compacted chains, tape mode), on the Cornell box and the open
  triangle scene, each kind counted.

The kernels themselves are held to each other on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.scene import albedo_table, emission_table

CFG = RenderConfig(width=16, height=12, spp=2, max_depth=5)
N = CFG.width * CFG.height * CFG.spp
SPECIAL = np.array([0.0, -0.0, -3.0, 1e30, np.nan, np.inf, -np.inf],
                   np.float32)


def _chain(build, splits, seed):
    """The plain segment tracers of a chain split at `splits`, tape mode,
    the live lanes after each split gathered in order into (live + 37)
    lanes, the rest dead pad lanes on a zero state. Per segment (b0, b1,
    entry state or None, its tape, its rows)."""
    scene, params, cam = build(device="cpu")
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    cc = mk.camera_consts(cam, CFG.width, CFG.height)
    r = np.random.default_rng(seed)
    cam_u = torch.as_tensor(r.uniform(size=(2, N)).astype(np.float32))
    tape = torch.as_tensor(
        r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32))
    bounds = [0, *splits, CFG.max_depth]
    segs, state, idx = [], None, torch.arange(N)
    for b0, b1 in zip(bounds, bounds[1:]):
        u = torch.nn.functional.pad(tape[b0:b1], (0, 1))[..., idx]
        kw = (dict(cam_u=cam_u) if b0 == 0 else
              dict(ray=state[0], alive=state[1]))
        K = idx.shape[0]
        _, res = mk.segment_trace_plain(scene, cc, CFG, b0, b1, alb, emi,
                                        tape=u, n_rays=K, collect=True, **kw)
        segs.append((b0, b1, state, u, res))
        if b1 == CFG.max_depth:
            break
        _, (ray, alive) = mk.segment_trace_plain(
            scene, cc, CFG, b0, b1, alb, emi, tape=u, n_rays=K, **kw)
        on = torch.nonzero(alive > 0)[:, 0]
        keep = torch.cat([on, torch.full((37,), K)])
        state = (torch.nn.functional.pad(ray, (0, 1))[:, keep],
                 torch.nn.functional.pad(alive, (0, 1))[keep])
        idx = torch.nn.functional.pad(idx, (0, 1), value=N)[keep]
    return scene, alb, emi, segs


def _trips(b0, state, u, res):
    """The trips the queue takes per lane: the first at b0 if the lane
    enters alive and the roulette of b0 lets it live, each later one if
    the row before is live and the roulette of its bounce lets it live."""
    n_rows, K = res.gate.shape
    live = res.gate > 0
    entered = (torch.ones(K, dtype=torch.bool) if state is None else
               state[1] > 0)
    trip = torch.zeros((n_rows, K), dtype=torch.bool)
    for k in range(n_rows):
        passes = (~(u[k, 0] < CFG.absorb_prob) if b0 + k >= CFG.min_bounces
                  else torch.ones(K, dtype=torch.bool))
        trip[k] = (entered if k == 0 else live[k - 1]) & passes
    n = trip.sum(dim=0)
    # The trips are a prefix of the rows.
    assert torch.equal(trip, torch.arange(n_rows)[:, None] < n[None])
    return n


def _sweep(res, alb, emi, g, S, rows):
    """The kernels' sweep per lane (fused_adjoint.cu: segment_sweep,
    sweep_segment_path) over rows [0, rows[lane]) from the last down,
    from S f32[3, K]: a column per lane of the E accumulator entries and
    S at the first row. A row with gate 0 is dead: no real row."""
    n_alb, n_emi = alb.shape[0], emi.shape[0]
    K = S.shape[1]
    acc_a = torch.zeros((n_alb - 1, 3, K))
    acc_e = torch.zeros((n_emi - 1, 3, K))
    S = S.clone()
    lanes = torch.arange(K)
    for k in reversed(range(res.gate.shape[0])):
        on = k < rows
        live = res.gate[k] > 0
        aid, eid = res.aid[k].long(), res.eid[k].long()
        arow = torch.where(live & (aid < n_alb - 1), aid, -1)
        erow = torch.where(live & (eid < n_emi - 1), eid, -1)
        a = torch.where((arow >= 0)[None], alb[arow.clamp(min=0)].T, 1.0)
        e = torch.where((erow >= 0)[None], emi[erow.clamp(min=0)].T, 0.0)
        P = torch.stack(
            [res.P.x[k], res.P.y[k], res.P.z[k]])
        sc, gate = res.sc[k], res.gate[k]
        gP = g * P
        m = on & (erow >= 0)
        acc_e[erow[m], :, lanes[m]] = acc_e[erow[m], :, lanes[m]] + gP[:, m].T
        m = on & (arow >= 0)
        acc_a[arow[m], :, lanes[m]] = (acc_a[arow[m], :, lanes[m]]
                                       + (gP[:, m] * sc[m] * S[:, m]).T)
        S = torch.where(on[None], (e + a * sc * S) * gate, S)
    return acc_a, acc_e, S


def _dead_row(S):
    """What one dead row of the lockstep loop makes of S: e = 0, a = 1,
    sc = +0, gate = +0."""
    zero = torch.zeros_like(S)
    return (zero + torch.ones_like(S) * zero * S) * zero


def _bits(t):
    return t.contiguous().numpy().view(np.int32)


@pytest.mark.parametrize("build,splits", [
    (cbox.build, (2,)), (cbox.build, (1, 3)), (gallery.build_tri, (2,)),
    (gallery.build_tri, (1, 3)), (gallery.build_glossy, (3,))],
    ids=["cbox-2", "cbox-1-3", "tri-2", "tri-1-3", "glossy-3"])
def test_queue_sweep_is_the_lockstep_sweep(build, splits):
    scene, alb, emi, segs = _chain(build, splits, seed=len(splits) + 3)
    r = np.random.default_rng(11)
    kinds = dict(miss_at_end=0, roulette_inside=0, enter_dead=0,
                 end_early=0)
    for b0, b1, state, u, res in segs:
        n_rows, K = res.gate.shape
        n = _trips(b0, state, u, res)
        # The rows after a lane's trips are dead: gate and sc +0.
        after = torch.arange(n_rows)[:, None] >= n[None]
        assert (_bits(res.gate)[after.numpy()] == 0).all()
        assert (_bits(res.sc)[after.numpy()] == 0).all()
        g = torch.as_tensor(r.uniform(size=(3, K)).astype(np.float32))
        ends = [None] if b1 == CFG.max_depth else [
            torch.as_tensor(r.uniform(-2, 2, size=(3, K)).astype(
                np.float32)),
            torch.as_tensor(SPECIAL[r.integers(0, len(SPECIAL),
                                               size=(3, K))])]
        for S_end in ends:
            S0 = torch.zeros((3, K)) if S_end is None else S_end
            lockstep = _sweep(res, alb, emi, g, S0,
                              torch.full((K,), n_rows))
            seed = (S0 if S_end is None else
                    torch.where((n == n_rows)[None], S_end,
                                _dead_row(S_end)))
            queue = _sweep(res, alb, emi, g, seed, n)
            for x, y in zip(queue, lockstep):
                assert np.array_equal(_bits(x), _bits(y))
        # The kinds of path end this segment holds.
        last = torch.clamp(n - 1, min=0)
        last_live = res.gate[last, torch.arange(K)] > 0
        kinds["miss_at_end"] += int(((n == n_rows) & ~last_live).sum())
        kinds["end_early"] += int(((n > 0) & (n < n_rows)).sum())
        if b0 > 0:
            entered = state[1] > 0
            kinds["enter_dead"] += int((~entered).sum())  # pad lanes too
            # Alive at entry and into a trip, but no trip at a later
            # bounce whose row before is live: the roulette's.
            live = res.gate > 0
            kinds["roulette_inside"] += int(
                ((n > 0) & (n < n_rows)
                 & live[last, torch.arange(K)]).sum())
    assert kinds["end_early"] > 0 and kinds["enter_dead"] > 0
    if build is gallery.build_tri:
        assert kinds["miss_at_end"] > 0
    if build is cbox.build:
        assert kinds["roulette_inside"] > 0


def test_dead_row_seed_of_special_values():
    """One dead row: +0 for every finite S (the sign of a zero dropped),
    NaN for NaN and inf; a second dead row leaves it as it is."""
    S = torch.as_tensor(SPECIAL)[None].repeat(3, 1)
    once = _dead_row(S)
    finite = torch.isfinite(S)
    assert (_bits(once)[finite.numpy()] == 0).all()
    assert torch.isnan(once[~finite]).all()
    assert np.array_equal(_bits(_dead_row(once)), _bits(once))
