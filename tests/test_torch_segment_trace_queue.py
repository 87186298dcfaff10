"""The premise of the segment tracer's queue (B1-seg,
`drt_fused_segment_trace`, csrc/fused_tracer.cu:segment_queue_trace_kernel
over queue_trace.inc): a lane that takes a trip only on a bounce its path
enters alive leaves the segment with the lockstep loop's radiance, alive
flag and exit state.

The lockstep loop (its checking build `drt_fused_segment_trace_lockstep`,
and `segment_trace_plain`, its plain twin) runs every bounce of
[b_start, b_end) on every lane, dead or alive. The queue decides the
Russian roulette of bounce b_start when it hands a lane out and that of
each next bounce after a trip, so a lane that enters dead, or whose
roulette ends its path before a bounce, takes no trip there; a path
stops at b_end or when it dies, and a lane not alive at b_end writes +0
for its exit ray. The model here runs that schedule with the plain
twin's own bounce (`segment_trace_plain` over [b, b + 1) on the lanes
that enter bounce b alive, their draws by ray slot) and holds it to the
plain twin over the whole segment: radiance and alive bit for bit, the
exit ray bit for bit on the lanes alive at b_end and +0 = the twin's
value on the others. Chains split at (2,) and (1, 3) with the live lanes
compacted after each split and dead pad lanes behind them (and [2, 5) on
every lane, uncompacted), tape mode and the internal RNG, on the Cornell
box and the open triangle scene; lanes that enter dead, pad lanes, paths
that the roulette ends at a segment's first bounce, paths that die
inside a segment and paths alive at its end are each counted. The
kernels themselves are held to each other on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_uniform
from drt_tpu_torch.scene import albedo_table, emission_table

CFG = RenderConfig(width=16, height=12, spp=8, spp_chunks=2, max_depth=5)
CHUNK = 1
N = CFG.width * CFG.height * (CFG.spp // CFG.spp_chunks)
SEED = (11, -5)
KINDS = ("enter dead", "pad", "roulette at entry", "die inside",
         "alive at end")
SCENES = {"cbox": cbox.build, "tri": gallery.build_tri}


def _bits(t):
    return t.contiguous().view(torch.int32)


class Segment:
    """A segment's inputs in one RNG mode: the keyword arguments of
    `segment_trace_plain` for its K lanes, each lane's ray slot, its
    roulette draws and the sub-segment [b, b + 1) on a set of lanes."""

    def __init__(self, scene, cc, alb, emi, rng, b0, b1, K, slot, state,
                 cam_u, tape):
        self.scene, self.cc, self.alb, self.emi = scene, cc, alb, emi
        self.rng, self.b0, self.b1, self.K = rng, b0, b1, K
        self.slot, self.state, self.cam_u, self.tape = slot, state, cam_u, tape

    def whole(self):
        return mk.segment_trace_plain(self.scene, self.cc, CFG, self.b0,
                                      self.b1, self.alb, self.emi,
                                      **self._kw(self.b0, self.b1, None))

    def one_bounce(self, b, lanes, ray):
        """Bounce b of `lanes` (their ray f[9, n] as they enter it)."""
        kw = self._kw(b, b + 1, lanes)
        if b > 0:
            kw.update(ray=ray.contiguous(),
                      alive=torch.ones(lanes.shape[0], dtype=torch.int32))
        return mk.segment_trace_plain(self.scene, self.cc, CFG, b, b + 1,
                                      self.alb, self.emi, **kw)

    def u_rr(self, b, lanes):
        """The roulette draw of bounce b at `lanes`."""
        if self.rng == "tape":
            return self.tape[b, 0, self.slot[lanes]]
        npix = CFG.width * CFG.height
        s = self.slot[lanes].long()
        return hash_uniform(SEED[1] & 0xFFFFFFFF, s % npix,
                            CHUNK * (CFG.spp // CFG.spp_chunks) + s // npix,
                            b, 0, torch.float32, torch.device("cpu"))

    def _kw(self, b, b_end, lanes):
        """segment_trace_plain's inputs of [b, b_end) on `lanes` (None:
        the segment's own K lanes and state)."""
        pick = (slice(None) if lanes is None else lanes)
        n = self.K if lanes is None else lanes.shape[0]
        kw = dict(chunk=CHUNK, n_rays=n)
        if self.rng == "tape":
            kw["tape"] = self.tape[b:b_end][..., self.slot[pick]].contiguous()
            if b == 0:
                kw["cam_u"] = self.cam_u[:, self.slot[pick]].contiguous()
        else:
            kw["seeds"] = torch.tensor(SEED, dtype=torch.int32)
            if b > 0:
                kw["ray_idx"] = self.slot[pick].to(torch.int32).contiguous()
        if b > 0 and lanes is None:
            kw["ray"], kw["alive"] = self.state
        return kw


def queue_model(seg):
    """The queue's schedule over seg's lanes with the plain twin's bounce:
    (radiance f[3, K], (exit ray f[9, K], alive i32[K]) unless b_end ==
    max_depth), and the count of each kind of lane."""
    K, b0, b1 = seg.K, seg.b0, seg.b1
    D = CFG.max_depth
    L = torch.zeros((3, K), dtype=torch.float32)
    ray = torch.zeros((9, K), dtype=torch.float32)
    if b0 > 0:
        ray_in, alive_in = seg.state
        ray[:] = ray_in
        alive = alive_in > 0
    else:
        alive = torch.ones(K, dtype=torch.bool)
    entered = alive.clone()
    if b0 >= CFG.min_bounces:
        alive &= ~(seg.u_rr(b0, torch.arange(K)) < CFG.absorb_prob)
    kinds = dict.fromkeys(KINDS, 0)
    kinds["enter dead"] = int((~entered).sum())
    kinds["roulette at entry"] = int((entered & ~alive).sum())
    for b in range(b0, b1):
        lanes = torch.nonzero(alive)[:, 0]
        if lanes.numel() == 0:
            break
        if b == 0:  # from the camera: every lane's slot, all entering live
            assert bool(alive.all())
            out = seg.one_bounce(0, torch.arange(K), None)
        else:
            out = seg.one_bounce(b, lanes, ray[:, lanes])
        L_b, (ray_b, alive_b) = ((out, (None, None)) if b + 1 == D
                                 else out)
        L[:, lanes] = L[:, lanes] + L_b
        if b + 1 == D:
            break
        ray[:, lanes] = ray_b
        now = alive_b > 0
        # The roulette of the next bounce; none at b_end (the next
        # segment's).
        if b + 1 < b1 and b + 1 >= CFG.min_bounces:
            now &= ~(seg.u_rr(b + 1, lanes) < CFG.absorb_prob)
        alive[lanes] = now
    kinds["alive at end"] = int(alive.sum()) if b1 < D else 0
    kinds["die inside"] = int((entered & ~alive).sum()
                              - kinds["roulette at entry"])
    if b1 == D:
        return L, kinds
    ray[:, ~alive] = 0.0
    return L, (ray, alive.to(torch.int32)), kinds


def _chains(build, rng):
    """The segments of the chains of one scene and RNG mode: split at (2,)
    and (1, 3), compacted after each split into (live + 37) lanes with
    dead pad lanes (slot n, a zero state) behind; and [2, 5) on every
    lane of the (2,) chain, uncompacted."""
    scene, params, cam = build(device="cpu")
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    cc = mk.camera_consts(cam, CFG.width, CFG.height)
    r = np.random.default_rng(7)
    cam_u = torch.as_tensor(r.uniform(size=(2, N + 1)).astype(np.float32))
    tape = torch.as_tensor(
        r.uniform(size=(CFG.max_depth, 3, N + 1)).astype(np.float32))
    out = []
    for splits in ((2,), (1, 3)):
        bounds = [0, *splits, CFG.max_depth]
        slot, state, K = torch.arange(N), None, N
        for b0, b1 in zip(bounds, bounds[1:]):
            seg = Segment(scene, cc, alb, emi, rng, b0, b1, K, slot, state,
                          cam_u, tape)
            out.append(seg)
            if b1 == CFG.max_depth:
                break
            _, (ray, alive) = seg.whole()
            if splits == (2,):
                out.append(Segment(scene, cc, alb, emi, rng, b1,
                                   CFG.max_depth, K, slot, (ray, alive),
                                   cam_u, tape))
            on = alive > 0
            K_next = min(K, int(on.sum()) + 37)
            idx = fused.compact_lanes(on, K_next, K)
            pad = torch.nn.functional.pad
            state = (pad(ray, (0, 1))[:, idx].contiguous(),
                     pad(alive, (0, 1))[idx].contiguous())
            slot = pad(slot, (0, 1), value=N)[idx]
            K = K_next
    return out


@pytest.fixture(scope="module")
def chains():
    """Per (scene, RNG mode): each segment's queue model and plain twin,
    and the kinds of lanes met."""
    out = {}
    for name, build in SCENES.items():
        for rng in ("tape", "internal"):
            kinds = dict.fromkeys(KINDS, 0)
            pairs = []
            for seg in _chains(build, rng):
                *got, k = queue_model(seg)
                for kind, v in k.items():
                    kinds[kind] += v
                kinds["pad"] += int((seg.slot == N).sum())
                pairs.append((seg.b0, seg.b1, got, seg.whole()))
            out[name, rng] = pairs, kinds
    return out


@pytest.mark.parametrize("rng", ["tape", "internal"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_queue_model_leaves_the_lockstep_segment(chains, scene, rng):
    pairs, kinds = chains[scene, rng]
    for b0, b1, got, want in pairs:
        if b1 == CFG.max_depth:
            assert torch.equal(_bits(got[0]), _bits(want)), (b0, b1)
            continue
        L, (ray, alive) = got
        L_w, (ray_w, alive_w) = want
        assert torch.equal(_bits(L), _bits(L_w)), (b0, b1)
        assert torch.equal(alive, alive_w)
        on = alive_w > 0
        assert torch.equal(_bits(ray[:, on]), _bits(ray_w[:, on]))
        assert torch.equal(ray[:, ~on], ray_w[:, ~on])
    assert kinds["alive at end"] > 0 and kinds["die inside"] > 0
    assert kinds["enter dead"] > 0 and kinds["pad"] > 0


def test_every_kind_of_lane_is_met(chains):
    """Across the scenes and RNG modes each kind of lane occurs, the
    roulette at a segment's first bounce included (from bounce 1 =
    min_bounces on)."""
    total = {k: sum(kinds[k] for _, kinds in chains.values())
             for k in KINDS}
    assert all(v > 0 for v in total.values()), total
