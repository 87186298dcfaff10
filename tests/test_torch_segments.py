"""The segment forms of the fused tracer and retrace adjoint, and
`fused.make_compacted_image_renderer`, on the CPU, where the wrappers run
their plain PyTorch twins.

References: the Pallas segment kernels of `drt_tpu.ops.megakernel` in
interpret mode (tape mode, tile_rows=1), run as tests/test_segments.py
runs them: the Cornell box at 16x8x8, depth 5, the same numpy-seeded
camera offsets, tape and cotangent on both sides, split at (2,) and at
(1, 3), the live lanes compacted between segments into capacities of 640
(after bounce 2) and 384 (after bounce 3). Each segment of the port is fed
the JAX chain's own state, so that each is held alone: radiance and exit
state rtol 2e-5 / atol 2e-6 with `alive` equal, d_albedo, d_emission and
S_start rtol 1e-4 / atol 1e-5 (another summation order), leaving out the
lanes ROADMAP C.4 names (`_carries`). The JAX callables are built and run
once per module.

The JAX package's compacted image renderer draws zero uniforms in
interpret mode (its own test, tests/test_segments.py, asserts no values),
so the port's compacted renderer is held against the port's own lockstep
path (`make_fused_image_renderer(plain=True, fastmath=False)`) at the same
seeds: the segments draw the lockstep samples, so image and gradients
agree to the rounding of the split sums. The kernels themselves are tested
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_tapes
from drt_tpu_torch.scene import (Params, albedo_table, emission_table,
                                 from_numpy)

TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
W, H, SPP, D = 16, 8, 8, 5
N = W * H * SPP
CFG = RenderConfig(width=W, height=H, spp=SPP, max_depth=D)
# Lanes after each split of a chain (tests/test_segments.py: K = 640).
CAPS = {(2,): [N, 640], (1, 3): [N, N, 384]}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def jax_chains():
    """Per split: the JAX segment kernels' chain. For each segment its
    inputs (tape rows, state, g per lane, S_end) and outputs (radiance,
    exit state, d_albedo, d_emission, S_start), as numpy arrays."""
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    alb = jax_albedo_table(js, jp)
    emi = jax_emission_table(js, jp)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    r = np.random.default_rng(0)
    cam_u = r.uniform(size=(2, N)).astype(np.float32)
    tape = r.uniform(size=(D, 3, N)).astype(np.float32)
    g = r.uniform(size=(3, N)).astype(np.float32)
    chains = {}
    for splits, caps in CAPS.items():
        bounds = [0, *splits, D]
        segs = []
        state = None  # 10 arrays per lane, JAX layout
        idx_all = None  # ray slot of each lane
        for k, (b0, b1) in enumerate(zip(bounds, bounds[1:])):
            kw = dict(n_rays=caps[k], tile_rows=1, rng="tape",
                      interpret=True)
            u = tape[b0:b1] if k == 0 else np.pad(
                tape[b0:b1], ((0, 0), (0, 0), (0, 1)))[:, :, idx_all]
            g_k = g if k == 0 else np.pad(g, ((0, 0), (0, 1)))[:, idx_all]
            head = (cam_u,) if k == 0 else ()
            tr = jax_mk.make_fused_segment_tracer(js, jc, jcfg, b0, b1, **kw)
            out = tr(alb, emi, *head, u, *(state or ()))
            final = b1 == D
            L, nxt = (out, None) if final else out
            segs.append(dict(b=(b0, b1), head=head, u=u, g=g_k,
                             state=state, L=np.stack([_np(c) for c in L]),
                             exit=None if final else [_np(c) for c in nxt],
                             adj=jax_mk.make_fused_segment_adjoint(
                                 js, jc, jcfg, b0, b1, **kw)))
            if final:
                break
            alive = _np(nxt[9])
            n_alive = int((alive > 0).sum())
            assert 0 < n_alive <= caps[k + 1]
            idx = np.nonzero(alive > 0)[0]
            idx = np.concatenate(
                [idx, np.full(caps[k + 1] - idx.size, caps[k])])
            state = [np.pad(_np(c), (0, 1))[idx] for c in nxt]
            idx_all = idx if idx_all is None else np.pad(
                idx_all, (0, 1), constant_values=N)[idx]
            segs[-1]["idx"] = idx
        # The adjoints from the last segment to the first, S chained.
        S = None
        for k in reversed(range(len(segs))):
            s = segs[k]
            out = s["adj"](alb, emi, *s["head"], s["u"], *(s["state"] or ()),
                           *s["g"], *(S or ()))
            s["S_end"] = None if S is None else np.stack([_np(c)
                                                          for c in S])
            s["da"], s["de"] = _np(out[0]), _np(out[1])
            if k > 0:
                S_start = np.stack([_np(c) for c in out[2]])
                s["S_start"] = S_start
                prev = segs[k - 1]["idx"]
                full = np.zeros((3, caps[k - 1] + 1), np.float32)
                full[:, prev] = S_start
                S = tuple(JV3(*jnp.asarray(full[:, :caps[k - 1]])))
            del s["adj"]
        chains[splits] = segs
    return chains


def _port():
    scene, params, cam = from_numpy(
        *([np.asarray(a) for a in t] for t in jax_cbox.build(
            dtype=jnp.float32)), device="cpu")
    return (scene, cam, albedo_table(scene, params),
            emission_table(scene, params), params)


def _carries(ray):
    """Lanes whose throughput (rows 6:9 of a state) is not all zero. A
    lane of zero throughput (its path hit the light, whose sampling weight
    is 0) goes on with a zero direction from a point on the light, where
    an ulp decides hit or miss (ROADMAP C.4): its position, direction,
    liveness and S are what that ulp makes them, and nothing depends on
    them."""
    return (ray[6:9] != 0).any(axis=0)


def _state(s):
    """The JAX layout's 10 state arrays as the port's (ray, alive)."""
    return (_t(np.stack(s["state"][:9])),
            _t(s["state"][9].astype(np.int32)))


@pytest.mark.parametrize("splits", sorted(CAPS))
def test_segment_tracer_matches_jax(jax_chains, splits):
    scene, cam, alb, emi, _ = _port()
    for k, s in enumerate(jax_chains[splits]):
        b0, b1 = s["b"]
        trace = mk.make_fused_segment_tracer(scene, cam, CFG, b0, b1,
                                             n_rays=CAPS[splits][k],
                                             rng="tape")
        state = () if s["state"] is None else _state(s)
        out = trace(alb, emi, *map(_t, s["head"]), _t(s["u"]), *state)
        L = out if b1 == D else out[0]
        assert s["L"].max() > 0 or b0 > 0
        np.testing.assert_allclose(L.numpy(), s["L"], **TOL)
        if b1 == D:
            continue
        ray, alive = out[1]
        ref = np.stack(s["exit"][:9])
        np.testing.assert_allclose(ray.numpy()[6:], ref[6:], **TOL)
        matters = _carries(ref)
        assert matters.sum() >= 100
        np.testing.assert_allclose(ray.numpy()[:6, matters],
                                   ref[:6, matters], **TOL)
        assert alive.dtype == torch.int32
        np.testing.assert_array_equal(alive.numpy()[matters],
                                      s["exit"][9][matters])


@pytest.mark.parametrize("splits", sorted(CAPS))
def test_segment_adjoint_matches_jax(jax_chains, splits):
    scene, cam, alb, emi, _ = _port()
    for k, s in enumerate(jax_chains[splits]):
        b0, b1 = s["b"]
        adj = mk.make_fused_segment_adjoint(scene, cam, CFG, b0, b1,
                                            n_rays=CAPS[splits][k],
                                            rng="tape")
        state = () if s["state"] is None else _state(s)
        tail = () if s["S_end"] is None else (_t(s["S_end"]),)
        out = adj(alb, emi, *map(_t, s["head"]), _t(s["u"]), *state,
                  _t(s["g"]), *tail)
        assert len(out) == (2 if b0 == 0 else 3)
        for got, ref in zip(out, (s["da"], s["de"])):
            np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL)
        if b0 > 0:
            matters = _carries(np.stack(s["state"][:9]))
            np.testing.assert_allclose(out[2].numpy()[:, matters],
                                       s["S_start"][:, matters], **GRAD_TOL)


def _seeds():
    return torch.tensor([2024, -77], dtype=torch.int32)


def test_whole_depth_segment_is_the_tracer_and_its_adjoint():
    """[0, D) with the internal RNG is the plain tracer on each chunk's
    hash tapes bit for bit, and its adjoint the plain retrace adjoint's
    tables."""
    scene, cam, alb, emi, _ = _port()
    cfg = RenderConfig(width=W, height=H, spp=8, spp_chunks=2, max_depth=D)
    cc = mk.camera_consts(cam, W, H)
    g = torch.rand((3, W * H), generator=torch.Generator().manual_seed(3))
    for c in range(2):
        L = mk.make_fused_segment_tracer(scene, cam, cfg, 0, D)(
            alb, emi, _seeds(), chunk=c)
        cu, tp = hash_tapes(_seeds(), W * H, 4, D, sample_base=4 * c)
        assert torch.equal(L, mk.fused_trace_plain(scene, cc, cfg, alb, emi,
                                                   cam_u=cu, tape=tp))
        da, de = mk.make_fused_segment_adjoint(scene, cam, cfg, 0, D)(
            alb, emi, _seeds(), g, chunk=c)
        ref = mk.fused_adjoint_plain(scene, cc, cfg, alb, emi, g, cam_u=cu,
                                     tape=tp)
        np.testing.assert_allclose(da.numpy(), ref[0].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(de.numpy(), ref[1].numpy(), **GRAD_TOL)


def test_cpu_segments_launch_nothing_and_check_their_calls():
    scene, cam, alb, emi, _ = _port()
    before = mk.launch_counts()
    trace = mk.make_fused_segment_tracer(scene, cam, CFG, 0, 2)
    L, (ray, alive) = trace(alb, emi, _seeds())
    assert L.shape == (3, N) and ray.shape == (9, N) and alive.shape == (N,)
    adj = mk.make_fused_segment_adjoint(scene, cam, CFG, 2, D)
    with pytest.raises(TypeError):
        adj(alb, emi, _seeds(), ray, alive, torch.arange(N, dtype=torch.int32))
    assert mk.launch_counts() == before
    with pytest.raises(ValueError):
        mk.make_fused_segment_tracer(scene, cam, CFG, 3, 3)
    with pytest.raises(ValueError):
        mk.fused_segment_adjoint(scene, None, mk.camera_consts(cam, W, H),
                                 CFG, 0, 2, alb, emi, L, seeds=_seeds())


CCFG = RenderConfig(width=16, height=8, spp=4, max_depth=5)


@pytest.mark.parametrize("splits,chunks,caps", [
    (None, 1, [512, 384]), ((1, 3), 2, [256, 256, 128])])
def test_compacted_renderer_matches_the_lockstep_path(splits, chunks, caps):
    """The image and the gradients of the compacted renderer against the
    lockstep renderer's plain exact path at the same seeds: the default
    split (one chunk of 512 rays, 384 lanes after bounce 2) and (1, 3) in
    two chunks (256 rays, 128 lanes after bounce 3)."""
    scene, cam, _, _, params = _port()
    cfg = dataclasses.replace(CCFG, spp_chunks=chunks)
    target = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(1))
    render = fused.make_compacted_image_renderer(scene, cam, cfg,
                                                 splits=splits, tile_rows=1,
                                                 plain=True)
    ref = fused.make_fused_image_renderer(scene, cam, cfg, plain=True,
                                          fastmath=False)
    assert fused.compacted_capacities(cfg, splits or (2,), 1) == caps
    out = []
    for fn in (render, ref):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = fn(p, _seeds())
        ((img - target) ** 2).mean().backward()
        out.append((img.detach(), p.albedo.grad, p.emission.grad))
    assert out[1][0].mean() > 0
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(), **TOL)
    for got, want in zip(out[0][1:], out[1][1:]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(render(params, _seeds()).numpy(),
                                      out[0][0].numpy())


def test_compacted_renderer_is_biased_only_and_warns_on_overflow():
    scene, cam, _, _, params = _port()
    with pytest.raises(ValueError, match="biased"):
        fused.make_compacted_image_renderer(
            scene, cam, dataclasses.replace(CCFG, unbiased=True))
    render = fused.make_compacted_image_renderer(scene, cam, CCFG,
                                                 tile_rows=1, margin=-0.45,
                                                 plain=True)
    assert fused.compacted_capacities(CCFG, (2,), 1, -0.45) == [512, 128]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img = render(params, _seeds())
    msgs = [str(w.message) for w in caught]
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())
    assert len(msgs) == 1 and "> capacity 128" in msgs[0], msgs
