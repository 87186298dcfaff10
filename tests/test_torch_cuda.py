"""The CUDA kernels of both families, scene-table ("fused") and
memory-resident ("dyn"): tracer, collect tracer, sweep adjoint and retrace
adjoint, the path-regeneration tracers and sweep adjoints of both, the
key-driven wavefront tracer and adjoint, the segment forms of the tracer
and the retrace adjoint and the early-exit tracer, and the lane-splitting
renderers over the tape forms, against their plain PyTorch versions on
the card. Every test needs
an NVIDIA GPU, nvcc and sm_90a: marked `cuda`, they skip without a card.
Run them there with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`
(tests/conftest.py imports jax).

Tolerances: the exact variant (built without FMA contraction) to rtol
2e-5 / atol 2e-6 per ray, the fast variant against the exact one to
rtol 2e-3 / atol 1e-4; at most 0.1% of rays beyond, for the paths whose
hit or flip choice an ulp of libm difference turns. Gradient tables to
2e-5 of the table's largest entry (summation order)."""

import dataclasses

import pytest
import torch

from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_tapes
from drt_tpu_torch.scene import albedo_table, emission_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _share_beyond(got, ref, rtol, atol):
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    return bad.any(dim=0).float().mean().item()


def _setup(builder, dev):
    scene, params, cam = builder(device=dev)
    return scene, params, cam, albedo_table(scene, params), \
        emission_table(scene, params)


@pytest.mark.parametrize("builder", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_tape_exact_matches_twin(dev, builder):
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(builder, dev)
    n = 64 * 48 * 4
    g = torch.Generator(device=dev).manual_seed(0)
    cam_u = torch.rand((2, n), generator=g, device=dev)
    tape = torch.rand((5, 3, n), generator=g, device=dev)
    before = mk.fused_trace.launches
    got = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape)
    torch.cuda.synchronize()
    assert mk.fused_trace.launches == before + 1
    ref = mk.make_fused_tracer(scene, cam, cfg, rng="tape", plain=True)(
        alb, emi, cam_u, tape)
    assert torch.isfinite(got).all() and ref.mean() > 0
    assert _share_beyond(got, ref, 2e-5, 2e-6) <= 1e-3
    assert abs(got.mean() / ref.mean() - 1) < 1e-5


def test_fast_matches_exact(dev):
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(gallery.build_glossy, dev)
    cam_u, tape = hash_tapes([5, 6], 64 * 48, 4, 5, device=dev)
    fast = mk.make_fused_tracer(scene, cam, cfg, rng="tape", fastmath=True)
    exact = mk.make_fused_tracer(scene, cam, cfg, rng="tape")
    got, ref = fast(alb, emi, cam_u, tape), exact(alb, emi, cam_u, tape)
    assert _share_beyond(got, ref, 2e-3, 1e-4) <= 1e-3


def test_internal_rng_matches_twin_on_hash_tapes(dev):
    cfg = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                       max_depth=5)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([11, -12], dtype=torch.int32)
    got = mk.make_fused_tracer(scene, cam, cfg, rng="internal",
                               n_chunks=2)(alb, emi, seeds)
    ref = mk.make_fused_tracer(scene, cam, cfg, rng="internal", n_chunks=2,
                               plain=True)(alb, emi, seeds)
    assert _share_beyond(got, ref, 2e-5, 2e-6) <= 1e-3


def test_wrapper_checks_inputs(dev):
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    trace = mk.make_fused_tracer(scene, cam, cfg, rng="tape")
    n = 64
    cam_u = torch.rand((2, n), device=dev)
    tape = torch.rand((2, 3, n), device=dev)
    with pytest.raises(TypeError, match="float32"):
        trace(alb.double(), emi, cam_u, tape)
    with pytest.raises(ValueError, match="shape"):
        trace(alb, emi, cam_u[:, :32], tape)
    with pytest.raises(ValueError, match="contiguous"):
        trace(alb, emi, cam_u, tape.transpose(0, 1).contiguous()
              .transpose(0, 1))
    with pytest.raises(ValueError, match="is on"):
        trace(alb, emi, cam_u.cpu(), tape)


def _tape_inputs(dev, n, depth=5, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((2, n), generator=g, device=dev),
            torch.rand((depth, 3, n), generator=g, device=dev),
            torch.rand((3, n), generator=g, device=dev))


def _grads_close(got, ref, rtol=2e-5):
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and r.abs().max() > 0
        assert (g - r).abs().max() <= rtol * r.abs().max()


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_collect_and_adjoints_are_bit_consistent(dev, make, fastmath):
    """The collect tracer's radiance is the tracer's; the retrace adjoint
    is sweep(collect); two sweeps give the same bits."""
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, g = _tape_inputs(dev, 64 * 48 * 4)
    kw = dict(rng="tape", fastmath=fastmath)
    before = mk.launch_counts()
    L1 = mk.make_fused_tracer(scene, cam, cfg, **kw)(alb, emi, cam_u, tape)
    L, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg, **kw)(
        alb, emi, cam_u, tape)
    sweep = mk.make_fused_sweep_adjoint(scene, cfg)
    d_sweep = sweep(alb, emi, rsc, rbest, g)
    d_again = sweep(alb, emi, rsc, rbest, g)
    d_adj = mk.make_fused_adjoint(scene, cam, cfg, **kw)(alb, emi, cam_u,
                                                         tape, g)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(fused_tracer=1, fused_collect=1, fused_sweep=2,
                      fused_adjoint=1)
    assert torch.equal(L, L1)
    assert rbest.dtype == torch.int32 and rbest.max() <= scene.num_shapes
    for a, b, c in zip(d_sweep, d_again, d_adj):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert (a[-1] == 0).all()  # the sentinel row


@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_adjoints_match_twins(dev, make):
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, g = _tape_inputs(dev, 64 * 48 * 4)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 rng="tape")(alb, emi, cam_u,
                                                             tape)
    _, rsc_r, rbest_r = mk.make_fused_collect_tracer(
        scene, cam, cfg, rng="tape", plain=True)(alb, emi, cam_u, tape)
    # Slots after a live bounce of zero weight hold what an ulp decides and
    # nothing depends on them (chip_smoke.py: compare_residuals).
    zero = ((rsc_r == 0) & (rbest_r > 0)).int()
    matters = (zero.cumsum(0) - zero) == 0
    assert torch.equal(rbest[matters], rbest_r[matters])
    # The specular weight divides by sqrt(1 - cos_h^2), which loses digits
    # as cos_h -> 1: a slot in a few ten thousand lands beyond.
    far = (rsc - rsc_r).abs() > 1e-4 + 2e-3 * rsc_r.abs()
    assert (far & matters).float().mean() <= 1e-3
    _grads_close(mk.make_fused_sweep_adjoint(scene, cfg)(
        alb, emi, rsc, rbest, g),
        mk.fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest, g))
    _grads_close(mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape, g),
        mk.make_fused_adjoint(scene, cam, cfg, rng="tape", plain=True)(
            alb, emi, cam_u, tape, g))


@pytest.mark.parametrize("cfg_kw,adjoint", [
    (dict(), "stored"), (dict(), "retrace"),
    (dict(unbiased=True, adjoint_samples=2), "auto")])
def test_renderer_backward_matches_twin(dev, cfg_kw, adjoint):
    """make_fused_image_renderer, internal RNG with 2 chunks: image and
    grads of the mean squared image against the plain twins'."""
    from drt_tpu_torch.fused import make_fused_image_renderer
    from drt_tpu_torch.scene import Params

    cfg = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                       max_depth=5, **cfg_kw)
    scene, params, cam, _, _ = _setup(cbox.build, dev)
    seeds = torch.tensor([11, -12], dtype=torch.int32)
    out = []
    for plain in (False, True):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = make_fused_image_renderer(scene, cam, cfg, adjoint=adjoint,
                                        fastmath=False, plain=plain)(p, seeds)
        (img ** 2).mean().backward()
        out.append((img.detach(), p.albedo.grad, p.emission.grad))
    (img, *grads), (img_r, *grads_r) = out
    assert _share_beyond(img.permute(2, 0, 1).reshape(3, -1),
                         img_r.permute(2, 0, 1).reshape(3, -1),
                         2e-5, 2e-6) <= 1e-3
    _grads_close(grads, grads_r)


def test_adjoint_wrappers_check_inputs(dev):
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    n = 128
    cam_u, tape, g = _tape_inputs(dev, n, depth=3)
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 rng="tape")(alb, emi, cam_u,
                                                             tape)
    sweep = mk.make_fused_sweep_adjoint(scene, cfg)
    with pytest.raises(TypeError, match="int32"):
        sweep(alb, emi, rsc, rbest.long(), g)
    with pytest.raises(ValueError, match="shape"):
        sweep(alb, emi, rsc[:2], rbest, g)
    with pytest.raises(ValueError, match="per ray or"):
        sweep(alb, emi, rsc, rbest, g[:, :100])
    with pytest.raises(ValueError, match="is on"):
        sweep(alb, emi, rsc, rbest, g.cpu())
    # Deeper than the rows a thread keeps: the deep forms, bit-consistent.
    deep = RenderConfig(width=8, height=8, spp=2, max_depth=mk.MAX_DEPTH + 1,
                        absorb_prob=0.1)
    g_deep = torch.rand((3, 64), device=dev)
    _, rsc_d, rbest_d = mk.make_fused_collect_tracer(scene, cam, deep)(
        alb, emi, [1, 2])
    for a, b in zip(mk.make_fused_adjoint(scene, cam, deep)(alb, emi, [1, 2],
                                                            g_deep),
                    mk.make_fused_sweep_adjoint(scene, deep)(
                        alb, emi, rsc_d, rbest_d, g_deep)):
        assert torch.equal(a, b)
    # Per-pixel and per-ray cotangents agree bit for bit.
    g_pix = g[:, :64].contiguous()
    for a, b in zip(sweep(alb, emi, rsc, rbest, g_pix),
                    sweep(alb, emi, rsc, rbest, g_pix.repeat(1, 2))):
        assert torch.equal(a, b)


# The memory-resident kernels (ops.dynkernel).

def _mesh(level):
    def build(device=None):
        return gallery.build_mesh(level, device=device)
    return build


DYN_SCENES = {"cbox": cbox.build, "glossy": gallery.build_glossy,
              "tri": gallery.build_tri, "mesh87": _mesh(1)}
DYN_CFG = RenderConfig(width=64, height=48, spp=4, max_depth=5)
DYN_N = 64 * 48 * 4


@pytest.mark.parametrize("name", sorted(DYN_SCENES))
def test_dyn_tape_exact_matches_plain(dev, name):
    scene, params, cam, alb, emi = _setup(DYN_SCENES[name], dev)
    cam_u, tape, _ = _tape_inputs(dev, DYN_N)
    before = dk.dyn_trace.launches
    got = dk.make_dyn_tracer(scene, cam, DYN_CFG, rng="tape")(
        alb, emi, cam_u, tape)
    torch.cuda.synchronize()
    assert dk.dyn_trace.launches == before + 1
    ref = dk.make_dyn_tracer(scene, cam, DYN_CFG, rng="tape", plain=True)(
        alb, emi, cam_u, tape)
    assert torch.isfinite(got).all() and ref.mean() > 0
    assert _share_beyond(got, ref, 2e-5, 2e-6) <= 1e-3
    assert abs(got.mean() / ref.mean() - 1) < 1e-5
    fast = dk.make_dyn_tracer(scene, cam, DYN_CFG, rng="tape",
                              fastmath=True)(alb, emi, cam_u, tape)
    assert _share_beyond(fast, got, 2e-3, 1e-4) <= 1e-3


def test_dyn_tracer_traces_the_fused_tracer_paths(dev):
    """The same seeds give the same samples in both families."""
    cfg = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                       max_depth=5)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([11, -12], dtype=torch.int32)
    a = dk.make_dyn_tracer(scene, cam, cfg, n_chunks=2)(alb, emi, seeds)
    b = mk.make_fused_tracer(scene, cam, cfg, n_chunks=2)(alb, emi, seeds)
    assert _share_beyond(a, b, 2e-5, 2e-6) <= 1e-3
    ref = dk.make_dyn_tracer(scene, cam, cfg, n_chunks=2, plain=True)(
        alb, emi, seeds)
    assert _share_beyond(a, ref, 2e-5, 2e-6) <= 1e-3


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("name", sorted(DYN_SCENES))
def test_dyn_collect_and_adjoints_are_bit_consistent(dev, name, fastmath):
    """The collect tracer's radiance is the tracer's; the retrace adjoint
    is sweep(collect); two sweeps give the same bits."""
    scene, params, cam, alb, emi = _setup(DYN_SCENES[name], dev)
    ds = dk.DynScene(scene)
    cam_u, tape, g = _tape_inputs(dev, DYN_N)
    kw = dict(rng="tape", fastmath=fastmath)
    before = mk.launch_counts()
    L1 = dk.make_dyn_tracer(ds, cam, DYN_CFG, **kw)(alb, emi, cam_u, tape)
    L, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, DYN_CFG, **kw)(
        alb, emi, cam_u, tape)
    sweep = dk.make_dyn_sweep_adjoint(ds, DYN_CFG)
    d_sweep = sweep(alb, emi, rsc, rrow, g)
    d_again = sweep(alb, emi, rsc, rrow, g)
    d_adj = dk.make_dyn_adjoint(ds, cam, DYN_CFG, **kw)(alb, emi, cam_u,
                                                        tape, g)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(dyn_tracer=1, dyn_collect=1, dyn_sweep=2,
                      dyn_adjoint=1)
    assert torch.equal(L, L1)
    live = (rrow >> 16) > 0
    dead = (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)
    assert rrow.dtype == torch.int32 and (rrow[~live] == dead).all()
    for a, b, c in zip(d_sweep, d_again, d_adj):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert (a[-1] == 0).all()  # the sentinel row


@pytest.mark.parametrize("name", ["glossy", "mesh87"])
def test_dyn_adjoints_match_plain(dev, name):
    scene, params, cam, alb, emi = _setup(DYN_SCENES[name], dev)
    ds = dk.DynScene(scene)
    cam_u, tape, g = _tape_inputs(dev, DYN_N)
    _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, DYN_CFG, rng="tape")(
        alb, emi, cam_u, tape)
    _, rsc_r, rrow_r = dk.make_dyn_collect_tracer(
        ds, cam, DYN_CFG, rng="tape", plain=True)(alb, emi, cam_u, tape)
    zero = ((rsc_r == 0) & ((rrow_r >> 16) > 0)).int()
    matters = (zero.cumsum(0) - zero) == 0
    assert torch.equal(rrow[matters], rrow_r[matters])
    far = (rsc - rsc_r).abs() > 1e-4 + 2e-3 * rsc_r.abs()
    assert (far & matters).float().mean() <= 1e-3
    _grads_close(dk.make_dyn_sweep_adjoint(ds, DYN_CFG)(
        alb, emi, rsc, rrow, g),
        dk.dyn_sweep_plain(DYN_CFG, alb, emi, rsc, rrow, g))
    _grads_close(dk.make_dyn_adjoint(ds, cam, DYN_CFG, rng="tape")(
        alb, emi, cam_u, tape, g),
        dk.make_dyn_adjoint(ds, cam, DYN_CFG, rng="tape", plain=True)(
            alb, emi, cam_u, tape, g))


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_dyn_culling_gives_the_same_bits(dev, level, fastmath):
    """Two-level, one-level and no clustering: the same radiance, collect
    residuals and gradients bit for bit."""
    scene, params, cam, alb, emi = _setup(_mesh(level), dev)
    cam_u, tape, g = _tape_inputs(dev, DYN_N)
    kw = dict(rng="tape", fastmath=fastmath)
    outs = []
    for ds in (dk.DynScene(scene), dk.DynScene(scene, super_m=1),
               dk.DynScene(scene, cluster_min_tris=10 ** 9),
               dk.DynScene(scene, cluster_k=8, super_m=4)):
        outs.append((dk.make_dyn_tracer(ds, cam, DYN_CFG, **kw)(
            alb, emi, cam_u, tape), *dk.make_dyn_collect_tracer(
                ds, cam, DYN_CFG, **kw)(alb, emi, cam_u, tape),
            *dk.make_dyn_adjoint(ds, cam, DYN_CFG, **kw)(
                alb, emi, cam_u, tape, g)))
    assert outs[0][0].mean() > 0
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def _dyn_family(ds, cam, cfg, kw, alb, emi, cam_u, tape, g):
    """B6's radiance, B7's (radiance, rsc, rrow), B8 on B7's residuals and
    B9, on one layout."""
    L1 = dk.make_dyn_tracer(ds, cam, cfg, **kw)(alb, emi, cam_u, tape)
    L, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg, **kw)(
        alb, emi, cam_u, tape)
    d_sweep = dk.make_dyn_sweep_adjoint(ds, cfg)(alb, emi, rsc, rrow, g)
    d_adj = dk.make_dyn_adjoint(ds, cam, cfg, **kw)(alb, emi, cam_u, tape,
                                                    g)
    torch.cuda.synchronize()
    return L1, (L, rsc, rrow), d_sweep, d_adj


@pytest.mark.parametrize("fastmath", [False, True])
def test_dyn_tracers_with_a_partial_last_warp(dev, fastmath):
    """61x47x3 = 8601 ray slots, 25 in the last warp: every thread of a
    warp takes part in the warp's leaf loop, those past the last slot as
    dead paths that write nothing (B6, B7) or sweep nothing (B9). B6 and
    B7 against the plain versions (exact variant), against each other
    and against the per-thread reference build, B9 against B8 on B7's
    residuals, and the last slot's residuals are its own."""
    cfg = RenderConfig(width=61, height=47, spp=3, max_depth=5)
    n = 61 * 47 * 3
    assert n % 32 == 25
    scene, params, cam, alb, emi = _setup(_mesh(2), dev)
    ds = dk.DynScene(scene)
    cam_u, tape, g = _tape_inputs(dev, n, seed=4)
    kw = dict(rng="tape", fastmath=fastmath)
    L1, (L, rsc, rrow), d_sweep, d_adj = _dyn_family(
        ds, cam, cfg, kw, alb, emi, cam_u, tape, g)
    assert L1.shape == (3, n) and rrow.shape == (5, n)
    assert torch.equal(L, L1)
    cc = mk.camera_consts(cam, 61, 47)
    assert torch.equal(L1, dk.dyn_trace_lanes(
        ds, cc, cfg, alb, emi, cam_u=cam_u, tape=tape, fastmath=fastmath))
    for a, b in zip(d_adj, d_sweep):
        assert torch.equal(a, b)
    # The last slot's primary ray hits the box: live at bounce 0, not the
    # sentinel rows of a dead path.
    assert (rrow[0, -1] >> 16) == 1
    if fastmath:
        return
    plain = dict(rng="tape", plain=True)
    ref = dk.make_dyn_tracer(ds, cam, cfg, **plain)(alb, emi, cam_u, tape)
    assert torch.isfinite(L1).all() and ref.mean() > 0
    assert _share_beyond(L1, ref, 2e-5, 2e-6) <= 1e-3
    assert abs(L1.mean() / ref.mean() - 1) < 1e-5
    _, rsc_r, rrow_r = dk.make_dyn_collect_tracer(ds, cam, cfg, **plain)(
        alb, emi, cam_u, tape)
    zero = ((rsc_r == 0) & ((rrow_r >> 16) > 0)).int()
    matters = (zero.cumsum(0) - zero) == 0
    assert torch.equal(rrow[matters], rrow_r[matters])
    beyond = (rsc - rsc_r).abs() > 2e-6 + 2e-5 * rsc_r.abs()
    assert (beyond & matters).float().sum() <= 5e-3 * matters.sum()
    last = matters[:, -1]
    assert torch.equal(rrow[:, -1][last], rrow_r[:, -1][last])
    assert torch.allclose(rsc[:, -1][last], rsc_r[:, -1][last], rtol=2e-5,
                          atol=2e-6)
    assert torch.allclose(L1[:, -1], ref[:, -1], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fastmath", [False, True])
def test_dyn_cluster_sizes_give_the_same_bits(dev, fastmath):
    """Leaves of 8, 16, 32 and 48 triangles (48: two passes of the warp)
    on the 327-shape mesh. On each layout, bit for bit: B6's radiance is
    the per-thread reference build's (each thread tests its leaves alone),
    which holds the warp's fold order to the per-thread loop's; B7's
    radiance is B6's and B9 is B8 on B7's residuals; and B12, one sample
    per chunk, is B6 on the same seeds. In the exact variant every
    layout, and no clustering, give the same bits."""
    from drt_tpu_torch.ops import dynregen as dr

    scene, params, cam, alb, emi = _setup(_mesh(2), dev)
    cam_u, tape, g = _tape_inputs(dev, DYN_N, seed=5)
    kw = dict(rng="tape", fastmath=fastmath)
    cc = mk.camera_consts(cam, DYN_CFG.width, DYN_CFG.height)
    cfg_s = RenderConfig(width=64, height=48, spp=4, spp_chunks=4,
                         max_depth=5)  # one sample per chunk
    seeds = torch.tensor([31, -5], dtype=torch.int32)
    layouts = [dk.DynScene(scene, cluster_k=k) for k in (8, 16, 32, 48)]
    layouts.append(dk.DynScene(scene, cluster_min_tris=10 ** 9))
    assert [ds.cluster_k for ds in layouts[:4]] == [8, 16, 32, 48]
    assert all(ds.n_clusters > 0 for ds in layouts[:4])
    assert layouts[4].n_clusters == 0
    outs = []
    for ds in layouts:
        L1, (L, rsc, rrow), d_sweep, d_adj = _dyn_family(
            ds, cam, DYN_CFG, kw, alb, emi, cam_u, tape, g)
        assert L1.mean() > 0 and torch.equal(L, L1)
        assert torch.equal(L1, dk.dyn_trace_lanes(
            ds, cc, DYN_CFG, alb, emi, cam_u=cam_u, tape=tape,
            fastmath=fastmath))
        for a, b in zip(d_adj, d_sweep):
            assert torch.equal(a, b)
        L6 = dk.make_dyn_tracer(ds, cam, cfg_s, fastmath=fastmath,
                                n_chunks=4)(alb, emi, seeds)
        assert torch.equal(L6, dk.dyn_trace_lanes(
            ds, cc, cfg_s, alb, emi, seeds=seeds, fastmath=fastmath,
            n_chunks=4))
        L12, _ = dr.make_dyn_regen_tracer(ds, cam, cfg_s, fastmath=fastmath,
                                          n_chunks=4)(alb, emi, seeds)
        assert torch.equal(L12, L6)
        outs.append((L1, rsc, rrow, *d_adj))
    if fastmath:
        return
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("cfg_kw,adjoint", [
    (dict(), "stored"), (dict(), "retrace"),
    (dict(unbiased=True, adjoint_samples=2), "auto")])
def test_dyn_renderer_backward_matches_plain(dev, cfg_kw, adjoint):
    """make_dyn_image_renderer on the 87-shape mesh, internal RNG with 2
    chunks: image and grads of the mean squared image against the plain
    versions'."""
    from drt_tpu_torch.fused import make_dyn_image_renderer
    from drt_tpu_torch.scene import Params

    cfg = RenderConfig(width=32, height=24, spp=8, spp_chunks=2,
                       max_depth=5, **cfg_kw)
    scene, params, cam, _, _ = _setup(_mesh(1), dev)
    seeds = torch.tensor([11, -12], dtype=torch.int32)
    out = []
    for plain in (False, True):
        p = Params(*(t.clone().requires_grad_() for t in params))
        img = make_dyn_image_renderer(scene, cam, cfg, adjoint=adjoint,
                                      fastmath=False, plain=plain)(p, seeds)
        (img ** 2).mean().backward()
        out.append((img.detach(), p.albedo.grad, p.emission.grad))
    (img, *grads), (img_r, *grads_r) = out
    assert _share_beyond(img.permute(2, 0, 1).reshape(3, -1),
                         img_r.permute(2, 0, 1).reshape(3, -1),
                         2e-5, 2e-6) <= 1e-3
    _grads_close(grads, grads_r)


def test_make_renderer_routes_a_mesh_to_the_dyn_kernels(dev):
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend

    cfg = RenderConfig(width=32, height=24, spp=4, spp_chunks=2,
                       max_depth=4)
    scene, params, cam, _, _ = _setup(_mesh(1), dev)
    assert scene.num_shapes == 87
    assert resolve_backend(scene, cfg) == "cuda-dyn"
    small, _, _ = cbox.build(device=dev)
    assert resolve_backend(small, cfg) == "cuda"
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    before = mk.launch_counts()
    img = make_renderer(scene, cfg, cam, differentiable=False)(params, seeds)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert after["dyn_tracer"] == before["dyn_tracer"] + 1
    assert after["fused_tracer"] == before["fused_tracer"]
    assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
    ref = make_renderer(scene, cfg, cam, differentiable=False,
                        backend="torch-dyn")(params, seeds)
    assert abs(img.mean() / ref.mean() - 1) < 1e-4


def test_dyn_wrappers_check_inputs(dev):
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    scene, params, cam, alb, emi = _setup(_mesh(1), dev)
    n = 128
    cam_u, tape, g = _tape_inputs(dev, n, depth=3)
    trace = dk.make_dyn_tracer(scene, cam, cfg, rng="tape")
    with pytest.raises(TypeError, match="float32"):
        trace(alb.double(), emi, cam_u, tape)
    with pytest.raises(ValueError, match="shape"):
        trace(alb, emi, cam_u[:, :32], tape)
    with pytest.raises(ValueError, match="is on"):
        trace(alb, emi, cam_u.cpu(), tape)
    _, rsc, rrow = dk.make_dyn_collect_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape)
    sweep = dk.make_dyn_sweep_adjoint(scene, cfg)
    with pytest.raises(TypeError, match="int32"):
        sweep(alb, emi, rsc, rrow.long(), g)
    with pytest.raises(ValueError, match="per ray or"):
        sweep(alb, emi, rsc, rrow, g[:, :100])
    # More parameter rows than a block's shared memory accumulates: the
    # accumulator's deep form, against the plain version.
    wide = torch.cat([alb[:-1]] * 40 + [alb[-1:]])
    assert wide.shape[0] - 1 + emi.shape[0] - 1 > dk.MAX_GRAD_ROWS
    _grads_close(sweep(wide, emi, rsc, rrow, g),
                 dk.dyn_sweep_plain(cfg, wide, emi, rsc, rrow, g))
    # The forward kernels take them (up to 256 rows a table).
    assert torch.isfinite(trace(wide, emi, cam_u, tape)).all()
    # Deeper than the rows a thread keeps: the retrace adjoint's deep form
    # = the sweep's on the collect tracer's rows.
    deep = RenderConfig(width=8, height=8, spp=2, max_depth=mk.MAX_DEPTH + 1,
                        absorb_prob=0.1)
    g_deep = torch.rand((3, 64), device=dev)
    _, rsc_d, rrow_d = dk.make_dyn_collect_tracer(scene, cam, deep)(
        alb, emi, [1, 2])
    for a, b in zip(dk.make_dyn_adjoint(scene, cam, deep)(alb, emi, [1, 2],
                                                          g_deep),
                    dk.make_dyn_sweep_adjoint(scene, deep)(
                        alb, emi, rsc_d, rrow_d, g_deep)):
        assert torch.equal(a, b)
    # Per-pixel and per-ray cotangents agree bit for bit.
    g_pix = g[:, :64].contiguous()
    for a, b in zip(sweep(alb, emi, rsc, rrow, g_pix),
                    sweep(alb, emi, rsc, rrow, g_pix.repeat(1, 2))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The path-regeneration kernels of both families (ops.regen, ops.dynregen).

def _regen_family(name):
    """(prepare the scene, tracer factory, sweep factory, sweep's plain
    version, lockstep tracer and collect factories, want bit, kept bits,
    dead code of (alb, emi))."""
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import regen as rg

    if name == "regen":
        return (lambda scene: scene, rg.make_regen_tracer,
                rg.make_regen_sweep_adjoint,
                lambda ks, cfg, *a: rg.regen_sweep_plain(ks, cfg, *a),
                mk.make_fused_tracer, mk.make_fused_collect_tracer, 8, 0xFF,
                lambda alb, emi: 0)
    return (dk.DynScene, dr.make_dyn_regen_tracer,
            dr.make_dyn_regen_sweep_adjoint,
            lambda ks, cfg, *a: dr.dyn_regen_sweep_plain(cfg, *a),
            dk.make_dyn_tracer, dk.make_dyn_collect_tracer, 17, 0x1FFFF,
            lambda alb, emi: (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8))


REGEN_CASES = [("regen", cbox.build), ("regen", gallery.build_glossy),
               ("regen", gallery.build_tri), ("dyn_regen", cbox.build),
               ("dyn_regen", gallery.build_glossy),
               ("dyn_regen", lambda device: gallery.build_mesh(
                   1, device=device))]
REGEN_IDS = ["regen-cbox", "regen-glossy", "regen-tri", "dyn-cbox",
             "dyn-glossy", "dyn-mesh87"]


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("family,make", REGEN_CASES, ids=REGEN_IDS)
def test_regen_kernels_are_bit_consistent(dev, family, make, fastmath):
    """Collect radiance and trips = tracer's; one launch over the chunks =
    per-chunk launches with sample_base; per-sample radiance = the
    lockstep tracer's; the rows by sample = the lockstep collect tracer's
    residuals; two sweeps, and a sweep over rows of NaN beyond each
    pixel's trips, give the same bits."""
    from drt_tpu_torch.ops import regen as rg

    prep, tracer, sweeper, _, lock_tracer, lock_collect, want_bit, keep, \
        dead = _regen_family(family)
    cfg = RenderConfig(width=64, height=48, spp=4, spp_chunks=2, max_depth=5)
    cfg_s = RenderConfig(width=64, height=48, spp=4, spp_chunks=4,
                         max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    ks = prep(scene)
    seeds = torch.tensor([2024, -77], dtype=torch.int32)
    kw = dict(fastmath=fastmath)
    before = mk.launch_counts()
    L, trips = tracer(ks, cam, cfg, n_chunks=2, **kw)(alb, emi, seeds)
    Lc, rsc, rows, trips_c = tracer(ks, cam, cfg, collect=True, n_chunks=2,
                                    **kw)(alb, emi, seeds)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert after[f"{family}_tracer"] == before[f"{family}_tracer"] + 1
    assert after[f"{family}_collect"] == before[f"{family}_collect"] + 1
    assert torch.equal(Lc, L) and torch.equal(trips_c, trips)
    assert int(trips.min()) >= 2 and int(trips.max()) <= rg.t_cap(cfg)
    one = tracer(ks, cam, cfg, n_chunks=1, **kw)
    assert torch.equal(one(alb, emi, seeds, 0)[0]
                       + one(alb, emi, seeds, 2)[0], L)
    Ls, _ = tracer(ks, cam, cfg_s, n_chunks=4, **kw)(alb, emi, seeds)
    assert torch.equal(Ls, lock_tracer(ks, cam, cfg_s, n_chunks=4, **kw)(
        alb, emi, seeds))
    sc_u, code_u = rg.rows_by_sample(cfg, rsc, rows, trips, want_bit, keep,
                                     dead(alb, emi))
    _, rsc_l, rcode_l = lock_collect(ks, cam, cfg, n_chunks=2, **kw)(
        alb, emi, seeds)
    assert torch.equal(sc_u, rsc_l) and torch.equal(code_u, rcode_l)
    g = torch.rand((3, 64 * 48), device=dev)
    sweep = sweeper(ks, cfg, n_chunks=2)
    d = sweep(alb, emi, rsc, rows, trips, g)
    own = torch.arange(rg.t_cap(cfg), device=dev)[None, :, None] \
        < trips[:, None, :]
    d_nan = sweep(alb, emi, torch.where(own, rsc, float("nan")).contiguous(),
                  torch.where(own, rows, -1).contiguous(), trips, g)
    for a, b, c in zip(d, sweep(alb, emi, rsc, rows, trips, g), d_nan):
        assert torch.isfinite(a).all() and (a[-1] == 0).all()
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("fastmath", [False, True])
def test_dyn_regen_with_a_partial_last_warp(dev, fastmath):
    """B12 at 61x47 = 2867 pixels, 19 in the last warp, 2 chunks of 2
    samples: the warp steps through one trip loop over all chunks, and the
    threads past the last pixel take part with no work and write nothing.
    Radiance and trips = the collect form's and the per-chunk launches';
    per-sample radiance = B6's; rows by sample = B7's residuals and the
    per-chunk launches'; the last pixel's outputs are its own (against the
    plain version in the exact variant); the checking build runs exactly
    the warp-trips that `stats_dict` says the warps need."""
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import regen as rg

    W, H = 61, 47
    npix = W * H
    assert npix % 32 == 19
    cfg = RenderConfig(width=W, height=H, spp=4, spp_chunks=2, max_depth=5)
    cfg_1 = RenderConfig(width=W, height=H, spp=2, max_depth=5)
    cfg_s = RenderConfig(width=W, height=H, spp=4, spp_chunks=4,
                         max_depth=5)
    scene, params, cam, alb, emi = _setup(_mesh(2), dev)
    ds = dk.DynScene(scene)
    seeds = torch.tensor([606, 17], dtype=torch.int32)
    kw = dict(fastmath=fastmath)
    dead = (alb.shape[0] - 1) | ((emi.shape[0] - 1) << 8)

    def by_sample(c, rsc, rows, trips):
        return rg.rows_by_sample(c, rsc, rows, trips, 17, 0x1FFFF, dead)

    L, trips = dr.make_dyn_regen_tracer(ds, cam, cfg, n_chunks=2, **kw)(
        alb, emi, seeds)
    Lc, rsc, rows, trips_c = dr.make_dyn_regen_tracer(
        ds, cam, cfg, collect=True, n_chunks=2, **kw)(alb, emi, seeds)
    assert L.shape == (3, npix) and trips.shape == (2, npix)
    assert torch.equal(Lc, L) and torch.equal(trips_c, trips)
    assert int(trips.min()) >= 2 and int(trips.max()) <= rg.t_cap(cfg)
    one = dr.make_dyn_regen_tracer(ds, cam, cfg, collect=True, n_chunks=1,
                                   **kw)
    parts = [one(alb, emi, seeds, 2 * c) for c in range(2)]
    assert torch.equal(parts[0][0] + parts[1][0], L)
    assert torch.equal(torch.cat([q[3] for q in parts]), trips)
    sc_u, code_u = by_sample(cfg, rsc, rows, trips)
    per_chunk = [by_sample(cfg_1, q[1], q[2], q[3]) for q in parts]
    assert torch.equal(sc_u, torch.cat([q[0] for q in per_chunk]))
    assert torch.equal(code_u, torch.cat([q[1] for q in per_chunk]))
    _, rsc_l, rcode_l = dk.make_dyn_collect_tracer(
        ds, cam, cfg, n_chunks=2, **kw)(alb, emi, seeds)
    assert torch.equal(sc_u, rsc_l) and torch.equal(code_u, rcode_l)
    Ls, _ = dr.make_dyn_regen_tracer(ds, cam, cfg_s, n_chunks=4, **kw)(
        alb, emi, seeds)
    assert torch.equal(Ls, dk.make_dyn_tracer(ds, cam, cfg_s, n_chunks=4,
                                              **kw)(alb, emi, seeds))
    # The last pixel (slots npix - 1 and 2 npix - 1 of a chunk): its rows
    # are its samples' lockstep residuals, live at bounce 0, and its trips
    # are what those say: live bounces + 1, at most max_depth, a sample.
    last = [npix - 1, 2 * npix - 1]
    assert torch.equal(code_u[:, :, last], rcode_l[:, :, last])
    live = (rcode_l[:, :, last] >> 16) & 1
    assert (live[:, 0] == 1).all()
    assert torch.equal(trips[:, -1], (live.sum(dim=1) + 1).clamp_max(5)
                       .sum(dim=1).to(torch.int32))
    if fastmath:
        st = dr.dyn_regen_trip_stats(ds, mk.camera_consts(cam, W, H), cfg,
                                     alb, emi, seeds, n_chunks=2)
        assert torch.equal(st.pop("radiance"), L)
        assert st["trips_sum"] == int(trips.sum())
        assert st["lane_trips"] == st["trips_sum"]
        assert st["group_trips"] == st["warp_trips"]
        assert st["live_trips"] <= st["lane_trips"]
        return
    Lp, trips_p = dr.make_dyn_regen_tracer(ds, cam, cfg, n_chunks=2,
                                           plain=True)(alb, emi, seeds)
    assert _share_beyond(L, Lp, 2e-5, 2e-6) <= 1e-3
    assert (trips != trips_p).float().mean() <= 1e-2
    assert torch.allclose(L[:, -1], Lp[:, -1], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("family,make", REGEN_CASES, ids=REGEN_IDS)
def test_regen_kernels_match_plain_versions(dev, family, make):
    from drt_tpu_torch.ops import regen as rg

    prep, tracer, sweeper, sweep_plain, _, _, want_bit, keep, dead = \
        _regen_family(family)
    cfg = RenderConfig(width=64, height=48, spp=4, spp_chunks=2, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    ks = prep(scene)
    seeds = torch.tensor([2024, -77], dtype=torch.int32)
    L, rsc, rows, trips = tracer(ks, cam, cfg, collect=True, n_chunks=2)(
        alb, emi, seeds)
    Lp, rsc_p, rows_p, trips_p = tracer(ks, cam, cfg, collect=True,
                                        n_chunks=2, plain=True)(
        alb, emi, seeds)
    assert Lp.mean() > 0 and _share_beyond(L, Lp, 2e-5, 2e-6) <= 1e-3
    assert (trips != trips_p).float().mean() <= 1e-2
    # Sample by sample, on the slots with no earlier live bounce of zero
    # weight (what follows one is decided by an ulp).
    args = (want_bit, keep, dead(alb, emi))
    sc_u, code_u = rg.rows_by_sample(cfg, rsc, rows, trips, *args)
    sc_r, code_r = rg.rows_by_sample(cfg, rsc_p, rows_p, trips_p, *args)
    live = code_r > 0 if family == "regen" else (code_r >> 16) > 0
    zero = ((sc_r == 0) & live).to(torch.int32)
    matters = (zero.cumsum(dim=1) - zero) == 0
    assert torch.equal(code_u[matters], code_r[matters])
    diff = (sc_u - sc_r).abs()[matters]
    ref = sc_r.abs()[matters]
    assert (diff > 2e-6 + 2e-5 * ref).float().mean() <= 5e-3
    assert (diff > 1e-4 + 2e-3 * ref).float().mean() <= 1e-3
    g = torch.rand((3, 64 * 48), device=dev)
    _grads_close(sweeper(ks, cfg, n_chunks=2)(alb, emi, rsc, rows, trips, g),
                 sweep_plain(ks, cfg, alb, emi, rsc, rows, trips, g))


@pytest.mark.parametrize("backend,plain_backend,make", [
    ("cuda-regen", "torch-regen", cbox.build),
    ("cuda-dyn-regen", "torch-dyn-regen",
     lambda device: gallery.build_mesh(1, device=device))],
    ids=["regen-cbox", "dyn-mesh87"])
def test_regen_renderers_through_make_renderer(dev, backend, plain_backend,
                                               make):
    """Stored and retrace steps launch 2 and 1 + 2 * spp_chunks kernels;
    the retrace backward equals the stored one launched per chunk bit for
    bit; gradients agree with the plain backend; the image is the
    lockstep image up to the order of the per-pixel sum."""
    from drt_tpu_torch import fused
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    cfg = RenderConfig(width=64, height=48, spp=8, spp_chunks=2, max_depth=5)
    scene, params, cam, _, _ = _setup(make, dev)
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    family = "dyn_regen" if "dyn" in backend else "regen"
    make_image = (fused.make_dyn_regen_image_renderer if "dyn" in backend
                  else fused.make_regen_image_renderer)

    def step(render):
        p = Params(*(t.detach().clone().requires_grad_() for t in params))
        img = render(p, seeds)
        (img ** 2).mean().backward()
        torch.cuda.synchronize()
        return img.detach(), p.albedo.grad, p.emission.grad

    mk.reset_launch_counts()
    stored = step(make_renderer(scene, cfg, cam, backend=backend))
    counts = {k: v for k, v in mk.launch_counts().items() if v}
    assert counts == {f"{family}_collect": 1, f"{family}_sweep": 1}
    mk.reset_launch_counts()
    retrace = step(make_image(scene, cam, cfg, adjoint="retrace"))
    counts = {k: v for k, v in mk.launch_counts().items() if v}
    assert counts == {f"{family}_tracer": 1, f"{family}_collect": 2,
                      f"{family}_sweep": 2}
    per_chunk = step(make_image(scene, cam, cfg, adjoint="stored",
                                chunked=False))
    for a, b in zip(retrace, per_chunk):
        assert torch.equal(a, b)
    assert torch.equal(stored[0], retrace[0])
    _grads_close(stored[1:], retrace[1:])
    plain = step(make_renderer(scene, cfg, cam, backend=plain_backend))
    _grads_close(stored[1:], plain[1:], rtol=1e-4)
    lock = make_renderer(scene, cfg, cam, differentiable=False)(params,
                                                                 seeds)
    rel = (stored[0] - lock).abs() / lock.clamp_min(lock.mean())
    assert float(rel.max()) <= 1e-6
    with pytest.raises(ValueError, match="biased-only"):
        make_renderer(scene, RenderConfig(width=8, height=8, spp=2,
                                          max_depth=2, unbiased=True), cam,
                      backend=backend)


def test_regen_wrappers_check_inputs(dev):
    from drt_tpu_torch.ops import regen as rg

    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    trace = rg.make_regen_tracer(scene, cam, cfg, collect=True)
    with pytest.raises(TypeError, match="float32"):
        trace(alb.double(), emi, seeds)
    with pytest.raises(ValueError, match="31 bits"):
        trace(alb, emi, seeds, -3)
    _, rsc, rmeta, trips = trace(alb, emi, seeds)
    sweep = rg.make_regen_sweep_adjoint(scene, cfg)
    g = torch.rand((3, 64), device=dev)
    with pytest.raises(ValueError, match="shape"):
        sweep(alb, emi, rsc[:, :2], rmeta, trips, g)
    with pytest.raises(TypeError, match="int32"):
        sweep(alb, emi, rsc, rmeta, trips.long(), g)
    with pytest.raises(ValueError, match="shape"):
        sweep(alb, emi, rsc, rmeta, trips, g.repeat(1, 2))
    # Deeper than the rows a thread keeps: the deep form.
    deep = RenderConfig(width=8, height=8, spp=1, max_depth=33,
                        min_bounces=1, absorb_prob=0.1)
    _, rsc, rmeta, trips = rg.make_regen_tracer(scene, cam, deep,
                                                collect=True)(alb, emi, seeds)
    assert rg.regen_sweep_form(deep, alb, emi) == "deep"
    _grads_close(rg.make_regen_sweep_adjoint(scene, deep)(alb, emi, rsc,
                                                          rmeta, trips, g),
                 rg.regen_sweep_plain(scene, deep, alb, emi, rsc, rmeta,
                                      trips, g))


def _wavefront_rays(cam, cfg, cam_u, exact_division=False):
    """Primary rays f32[3, N] (o, d) of spp-outer ray slots through
    `ops.megakernel.camera_ray_from_pix`, the fused tracer's camera in its
    op order. On the card a tensor divided by a Python number is
    multiplied by the number's reciprocal; exact_division=True divides by
    a tensor, as the kernel does, so that the rays are the fused tracer's
    own bit for bit."""
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    if exact_division:
        cc = cc._replace(width=torch.tensor(cfg.width, device=cam_u.device),
                         height=torch.tensor(cfg.height,
                                             device=cam_u.device))
    pix = torch.arange(cam_u.shape[1], device=cam_u.device) % (
        cfg.width * cfg.height)
    o, d = mk.camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
    return torch.stack(tuple(o)), torch.stack(tuple(d))


@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_wavefront_kernels_match_twins(dev, make):
    """The wavefront tracer and adjoint (B5a, B5b) against their plain
    twins on rays from the camera and a random tape."""
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, g = _tape_inputs(dev, 64 * 48 * 4, seed=5)
    o, d = _wavefront_rays(cam, cfg, cam_u)
    before = (mk.ray_trace.launches, mk.ray_adjoint.launches)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, o, d, tape)
    grads = mk.make_pallas_adjoint(scene, cfg)(alb, emi, o, d, tape, g)
    torch.cuda.synchronize()
    assert (mk.ray_trace.launches, mk.ray_adjoint.launches) == (
        before[0] + 1, before[1] + 1)
    ref = mk.make_pallas_tracer(scene, cfg, plain=True)(alb, emi, o, d,
                                                        tape)
    assert torch.isfinite(L).all() and ref.mean() > 0
    assert _share_beyond(L, ref, 2e-5, 2e-6) <= 1e-3
    _grads_close(grads, mk.make_pallas_adjoint(scene, cfg, plain=True)(
        alb, emi, o, d, tape, g))


@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_wavefront_kernels_on_fused_rays_are_bit_equal(dev, make):
    """On the fused tracer's own primary rays and tape, B5a's radiance is
    B1's and B5b's tables are B4's, bit for bit: the same bounce text,
    sweep and accumulation on a ray read from memory."""
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, g = _tape_inputs(dev, 64 * 48 * 4, seed=6)
    o, d = _wavefront_rays(cam, cfg, cam_u, exact_division=True)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, o, d, tape)
    assert torch.equal(L, mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape))
    got = mk.make_pallas_adjoint(scene, cfg)(alb, emi, o, d, tape, g)
    ref = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(alb, emi, cam_u,
                                                             tape, g)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_wavefront_renderer_matches_plain_backend(dev):
    """make_renderer(backend="cuda-wavefront") against "torch-wavefront"
    at the same seeds: the image, and the biased and unbiased gradients."""
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([3, -4], dtype=torch.int32)
    for cfg in (RenderConfig(width=32, height=24, spp=4, spp_chunks=2,
                             max_depth=5),
                RenderConfig(width=32, height=24, spp=4, spp_chunks=2,
                             max_depth=5, unbiased=True, adjoint_samples=2)):
        out = []
        for backend in ("cuda-wavefront", "torch-wavefront"):
            p = Params(*(t.detach().clone().requires_grad_() for t in params))
            img = make_renderer(scene, cfg, cam, backend=backend)(p, seeds)
            (img * img).sum().backward()
            out.append((img.detach(), p.albedo.grad, p.emission.grad))
        assert _share_beyond(out[0][0].reshape(-1, 3).T,
                             out[1][0].reshape(-1, 3).T, 2e-5, 2e-6) <= 1e-3
        _grads_close(out[0][1:], out[1][1:], 1e-4)


def test_wavefront_wrappers_check_inputs(dev):
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cam_u, tape, g = _tape_inputs(dev, 64, depth=2)
    o, d = _wavefront_rays(cam, cfg, cam_u)
    trace = mk.make_pallas_tracer(scene, cfg)
    adj = mk.make_pallas_adjoint(scene, cfg)
    with pytest.raises(TypeError, match="float32"):
        trace(alb, emi, o.double(), d, tape)
    with pytest.raises(ValueError, match="shape"):
        trace(alb, emi, o, d[:, :32], tape)
    with pytest.raises(ValueError, match="shape"):
        adj(alb, emi, o, d, tape, g[:, :32])
    with pytest.raises(ValueError, match="is on"):
        adj(alb, emi, o, d, tape.cpu(), g)
    # Deeper than the rows a thread keeps: the deep form.
    deep = RenderConfig(width=8, height=8, spp=1, max_depth=33,
                        absorb_prob=0.1)
    u = torch.rand((33, 3, 64), device=dev)
    _grads_close(mk.make_pallas_adjoint(scene, deep)(alb, emi, o, d, u, g),
                 mk.make_pallas_adjoint(scene, deep, plain=True)(
                     alb, emi, o, d, u, g))


@pytest.mark.parametrize("depth", [1, 5, 32])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_ray_queue_equals_the_lockstep_build(dev, make, depth):
    """B5a's queue in both forms = its lockstep build
    (`drt_ray_trace_lockstep`) bit for bit, at 30x20x4 spp (a warp's last
    round of the queue is partial): on a random tape; on B1's own rays and
    hash tape, where the tape form, the keyed form (B1's spp-outer ids)
    and the lockstep build all equal B1 (exact, internal RNG); and on the
    wavefront's own rays and ids (spp-minor), where the keyed form equals
    the tape form and the lockstep build fed `bounce_tape` of those ids."""
    from drt_tpu_torch.ops.rng import bounce_tape
    from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                        chunk_sample_ids)

    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=depth)
    scene, params, cam, alb, emi = _setup(make, dev)
    table = mk.scene_table(scene)
    npix, n = 600, 2400

    def trace(o, d, *tape, **kw):
        return mk.ray_trace(scene, table, cfg, alb, emi, o, d, *tape, **kw)

    before = mk.ray_trace.launches
    cam_u, tape, _ = _tape_inputs(dev, n, depth=depth, seed=depth)
    o, d = _wavefront_rays(cam, cfg, cam_u, exact_division=True)
    L = trace(o, d, tape)
    assert torch.isfinite(L).all()
    assert torch.equal(L, trace(o, d, tape, build="lockstep"))
    seeds = torch.tensor([depth, -3], dtype=torch.int32)
    cam_h, tape_h = hash_tapes(seeds, npix, 4, depth, device=dev)
    o, d = _wavefront_rays(cam, cfg, cam_h, exact_division=True)
    i = torch.arange(n, dtype=torch.int32, device=dev)
    L_b1 = mk.make_fused_tracer(scene, cam, cfg)(alb, emi, seeds)
    assert torch.isfinite(L_b1).all() and (depth == 1 or L_b1.mean() > 0)
    for got in (trace(o, d, tape_h), trace(o, d, tape_h, build="lockstep"),
                trace(o, d, seeds=seeds, pix=i % npix, sample=i // npix)):
        assert torch.equal(got, L_b1)
    xy = chunk_pixel_ids(cfg, dev)
    pix, smp = chunk_sample_ids(cfg, xy, 0)
    o, d, _ = chunk_rays(cam, cfg, xy, seeds, 0)
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
    keyed = trace(o, d, seeds=seeds, pix=pix.int(), sample=smp.int())
    tape_w = bounce_tape(int(seeds[1]), pix, smp, depth)
    assert torch.equal(keyed, trace(o, d, tape_w))
    assert torch.equal(keyed, trace(o, d, tape_w, build="lockstep"))
    torch.cuda.synchronize()
    assert mk.ray_trace.launches == before + 5  # the lockstep build: none


@pytest.mark.parametrize("chunks", [1, 3, 16])
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("shape", ["61x47", "640x480"])
def test_regen_tracer_on_its_persistent_grid(dev, shape, fastmath, chunks):
    """B10's trip loop on a persistent grid at 61x47 = 2867 pixels (19 in
    the last batch of 32) with 2 samples a chunk and at the main shape's
    640x480 with 16, over 1, 3 and 16 chunks: the tracer = the collect
    form (radiance, trips) = per-chunk launches with sample_base (and
    their rows by sample); rows by sample = the lockstep collect tracer's
    residuals; per-sample radiance (one sample a chunk) = the lockstep
    tracer's; the checking build's radiance is the tracer's, it counts
    every trip, and its warp-trips run at most 32 bounces each."""
    from drt_tpu_torch.ops import regen as rg

    W, H, spp_c = (61, 47, 2) if shape == "61x47" else (640, 480, 16)
    npix = W * H
    cfg = RenderConfig(width=W, height=H, spp=spp_c * chunks,
                       spp_chunks=chunks, max_depth=5)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([606, 17], dtype=torch.int32)
    kw = dict(fastmath=fastmath, n_chunks=chunks)
    L, trips = rg.make_regen_tracer(scene, cam, cfg, **kw)(alb, emi, seeds)
    assert L.shape == (3, npix) and trips.shape == (chunks, npix)
    assert int(trips.min()) >= spp_c and int(trips.max()) <= rg.t_cap(cfg)
    Lc, rsc, rows, trips_c = rg.make_regen_tracer(
        scene, cam, cfg, collect=True, **kw)(alb, emi, seeds)
    assert torch.equal(Lc, L) and torch.equal(trips_c, trips)

    def by_sample(c, rsc, rows, trips):
        return rg.rows_by_sample(c, rsc, rows, trips, 8, 0xFF, 0)

    sc_u, code_u = by_sample(cfg, rsc, rows, trips)
    cfg_1 = RenderConfig(width=W, height=H, spp=spp_c, max_depth=5)
    one = rg.make_regen_tracer(scene, cam, cfg_1, collect=True,
                               fastmath=fastmath)
    L_sum = None
    for c in range(chunks):
        Lq, rsc_q, rows_q, trips_q = one(alb, emi, seeds, c * spp_c)
        L_sum = Lq if L_sum is None else L_sum + Lq
        assert torch.equal(trips_q[0], trips[c])
        for a, b in zip(by_sample(cfg_1, rsc_q, rows_q, trips_q),
                        (sc_u[c], code_u[c])):
            assert torch.equal(a[0], b)
        del rsc_q, rows_q
    assert torch.equal(L_sum, L)
    _, rsc_l, rcode_l = mk.make_fused_collect_tracer(scene, cam, cfg, **kw)(
        alb, emi, seeds)
    assert torch.equal(sc_u, rsc_l.reshape(sc_u.shape))
    assert torch.equal(code_u, rcode_l.reshape(code_u.shape))
    del rsc, rows, sc_u, code_u, rsc_l, rcode_l
    cfg_s = RenderConfig(width=W, height=H, spp=chunks, spp_chunks=chunks,
                         max_depth=5)
    Ls, _ = rg.make_regen_tracer(scene, cam, cfg_s, **kw)(alb, emi, seeds)
    assert torch.equal(Ls, mk.make_fused_tracer(scene, cam, cfg_s, **kw)(
        alb, emi, seeds))
    if fastmath:
        st = rg.regen_trip_stats(scene, mk.scene_table(scene),
                                 mk.camera_consts(cam, W, H), cfg, alb, emi,
                                 seeds, n_chunks=chunks)
        assert torch.equal(st.pop("radiance"), L)
        assert st["lane_trips"] == st["trips_sum"] == int(trips.sum())
        assert st["live_trips"] <= st["lane_bounces"] <= st["lane_trips"]
        assert 32 * st["group_trips"] >= st["lane_bounces"]
        assert st["group_trips"] >= -(-st["lane_bounces"] // 32)


def test_constructors_default_to_the_card(dev):
    from drt_tpu_torch.camera import default_camera

    scene, params, cam = cbox.build()
    assert all(t.device.type == "cuda"
               for t in (*scene, *params, *cam, *default_camera()))


def _split_chain(scene, cam, cfg, alb, emi, cam_u, tape, splits, plain):
    """The segments of a split chain in tape mode, each fed the kernel
    chain's state (no compaction): per segment (inputs, outputs)."""
    bounds = [0, *splits, cfg.max_depth]
    state, chain = (), []
    for b0, b1 in zip(bounds, bounds[1:]):
        head = (cam_u,) if b0 == 0 else ()
        args = (*head, tape[b0:b1].contiguous(), *state)
        out = mk.make_fused_segment_tracer(scene, cam, cfg, b0, b1,
                                           rng="tape", plain=plain)(
            alb, emi, *args)
        chain.append((args, out))
        if b1 < cfg.max_depth:
            state = out[1]
    return chain


@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_segment_kernels_match_twins(dev, make):
    """Tape mode, exact variant, split at (1, 3): each segment tracer and
    segment adjoint on the kernel chain's state against its twin; the
    segments' radiance sums to B1's, [0, D) is B1 bit for bit, and the
    stitched adjoints give B4's tables."""
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, g = _tape_inputs(dev, 64 * 48 * 4, seed=7)
    before = (mk.fused_segment_trace.launches,
              mk.fused_segment_adjoint.launches)
    chain = _split_chain(scene, cam, cfg, alb, emi, cam_u, tape, (1, 3),
                         False)
    L_b1 = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(alb, emi, cam_u,
                                                             tape)
    total = 0.0
    for (args, out), (b0, b1) in zip(chain, ((0, 1), (1, 3), (3, 5))):
        ref = mk.make_fused_segment_tracer(scene, cam, cfg, b0, b1,
                                           rng="tape", plain=True)(
            alb, emi, *args)
        L, L_ref = (out, ref) if b1 == 5 else (out[0], ref[0])
        assert _share_beyond(L, L_ref, 2e-5, 2e-6) <= 1e-3
        total = total + L
    assert _share_beyond(total, L_b1, 2e-5, 2e-6) <= 1e-3
    whole = mk.make_fused_segment_tracer(scene, cam, cfg, 0, 5, rng="tape")(
        alb, emi, cam_u, tape)
    assert torch.equal(whole, L_b1)
    S, da, de = None, 0.0, 0.0
    for (args, _), (b0, b1) in reversed(list(zip(chain, ((0, 1), (1, 3),
                                                          (3, 5))))):
        tail = () if S is None else (S,)
        for plain in (False, True):
            out = mk.make_fused_segment_adjoint(scene, cam, cfg, b0, b1,
                                                rng="tape", plain=plain)(
                alb, emi, *args, g, *tail)
            if not plain:
                got = out
        for a, r in zip(got[:2], out[:2]):
            # tri's last segment: no path of an open scene reaches the
            # light after bounce 3, and the twin's table is all zero.
            if r.any():
                _grads_close((a,), (r,))
            else:
                assert torch.equal(a, r)
        da, de = da + got[0], de + got[1]
        S = got[2] if b0 > 0 else None
    _grads_close((da, de), mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape, g), 1e-4)
    torch.cuda.synchronize()
    assert (mk.fused_segment_trace.launches,
            mk.fused_segment_adjoint.launches) == (before[0] + 4,
                                                   before[1] + 3)


@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                     gallery.build_tri])
def test_earlyexit_kernel_is_b1(dev, make):
    """B14 against B1 exact, bit for bit: tape mode at depth 5 and the
    internal RNG over 2 chunks at depth 16."""
    from drt_tpu_torch.ops import earlyexit

    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5)
    scene, params, cam, alb, emi = _setup(make, dev)
    cam_u, tape, _ = _tape_inputs(dev, 64 * 48 * 4, seed=8)
    before = earlyexit.earlyexit_trace.launches
    got = earlyexit.make_earlyexit_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape)
    assert torch.equal(got, mk.make_fused_tracer(scene, cam, cfg,
                                                 rng="tape")(
        alb, emi, cam_u, tape))
    deep = RenderConfig(width=64, height=48, spp=8, spp_chunks=2,
                        max_depth=16)
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    got = earlyexit.make_earlyexit_tracer(scene, cam, deep, n_chunks=2)(
        alb, emi, seeds)
    assert torch.equal(got, mk.make_fused_tracer(scene, cam, deep,
                                                 n_chunks=2)(alb, emi, seeds))
    torch.cuda.synchronize()
    assert earlyexit.earlyexit_trace.launches == before + 2


def test_compacted_renderer_matches_fused_exact(dev):
    """make_compacted_image_renderer against the fused renderer's exact
    retrace form at the same seeds: the image, and the gradients."""
    from drt_tpu_torch import fused
    from drt_tpu_torch.scene import Params

    cfg = RenderConfig(width=64, height=48, spp=8, spp_chunks=2,
                       max_depth=5)
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    seeds = torch.tensor([9, -10], dtype=torch.int32)
    out = []
    for fn in (fused.make_compacted_image_renderer(scene, cam, cfg,
                                                   tile_rows=1),
               fused.make_fused_image_renderer(scene, cam, cfg,
                                               adjoint="retrace",
                                               fastmath=False)):
        p = Params(*(t.detach().clone().requires_grad_() for t in params))
        img = fn(p, seeds)
        (img * img).sum().backward()
        out.append((img.detach(), p.albedo.grad, p.emission.grad))
    assert _share_beyond(out[0][0].reshape(-1, 3).T,
                         out[1][0].reshape(-1, 3).T, 2e-5, 2e-6) <= 1e-3
    _grads_close(out[0][1:], out[1][1:], 1e-4)


# The queue of the tracer B1 and the collect tracer B2 (persistent threads,
# one live bounce a trip) against the lockstep loop's checking builds.
QUEUE_RNG = ["tape", "internal-1", "internal-3", "internal-4",
             "internal-16"]


def _queue_and_lockstep(scene, cam, alb, emi, depth, fastmath, rng, dev,
                        seed=0):
    """B1 and B2 in the queue and in the lockstep builds, on 30x20 pixels:
    600 * 4 ray slots, so that a warp's last round of the queue is
    partial."""
    chunks = 1 if rng == "tape" else int(rng.split("-")[1])
    cfg = RenderConfig(width=30, height=20, spp=4 * chunks,
                       spp_chunks=chunks, max_depth=depth)
    n = 30 * 20 * 4
    g = torch.Generator(device=dev).manual_seed(seed)
    if rng == "tape":
        kw = dict(cam_u=torch.rand((2, n), generator=g, device=dev),
                  tape=torch.rand((depth, 3, n), generator=g, device=dev))
    else:
        kw = dict(seeds=torch.tensor([seed, -7], dtype=torch.int32))
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 30, 20)
    kw.update(fastmath=fastmath, n_chunks=chunks)
    out = {build: (mk.fused_trace(scene, table, cc, cfg, alb, emi,
                                  build=build, **kw),
                   *mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                     build=build, **kw))
           for build in ("queue", "lockstep")}
    return cfg, kw, out


@pytest.mark.parametrize("depth", [1, 5, 32])
@pytest.mark.parametrize("rng", QUEUE_RNG)
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_queue_tracers_equal_the_lockstep_builds(dev, make, fastmath, rng,
                                                 depth):
    scene, params, cam, alb, emi = _setup(make, dev)
    before = mk.launch_counts()
    _, _, out = _queue_and_lockstep(scene, cam, alb, emi, depth, fastmath,
                                    rng, dev)
    torch.cuda.synchronize()
    counts = mk.launch_counts()
    # Only the queue's launches count; the lockstep builds are checking
    # builds.
    assert counts["fused_tracer"] == before["fused_tracer"] + 1
    assert counts["fused_collect"] == before["fused_collect"] + 1
    for got, ref in zip(out["queue"], out["lockstep"]):
        assert torch.equal(got, ref)
    assert torch.equal(out["queue"][1], out["queue"][0])
    assert torch.isfinite(out["queue"][0]).all()
    if depth > 1:  # the tri scene's light is seen only after a bounce
        assert out["queue"][0].mean() > 0


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_retrace_adjoint_is_sweep_of_the_queue_rows(dev, make, fastmath):
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg, kw, out = _queue_and_lockstep(scene, cam, alb, emi, 32, fastmath,
                                       "tape", dev, seed=3)
    g = torch.rand((3, cfg.width * cfg.height * cfg.spp), device=dev)
    _, _, rsc, rbest = out["queue"]
    d_sweep = mk.make_fused_sweep_adjoint(scene, cfg)(alb, emi, rsc, rbest,
                                                      g)
    d_adj = mk.make_fused_adjoint(scene, cam, cfg, rng="tape",
                                  fastmath=fastmath)(
        alb, emi, kw["cam_u"], kw["tape"], g)
    for a, b in zip(d_adj, d_sweep):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_trip_counter_equals_trip_counts_plain(dev, make, chunks):
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg = RenderConfig(width=32, height=24, spp=4 * chunks,
                       spp_chunks=chunks, max_depth=8)
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 32, 24)
    before = mk.launch_counts()
    st = mk.fused_trace_stats(scene, table, cc, cfg, alb, emi, seeds,
                              n_chunks=chunks, collect=True)
    assert mk.launch_counts() == before  # a checking build
    L, rsc, rbest = mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                     seeds=seeds, fastmath=True,
                                     n_chunks=chunks)
    for got, ref in zip((st["radiance"], st["rsc"], st["rbest"]),
                        (L, rsc, rbest)):
        assert torch.equal(got, ref)
    ref = mk.trip_counts_plain(cfg, rbest, seeds=seeds)
    assert torch.equal(st["trips"], ref)
    assert st["lane_steps"] == int(ref.sum())
    assert st["lane_steps"] <= 32 * st["warp_steps"]
    assert st["live_lanes"] <= st["lane_steps"]
    assert all(v > 0 for v in st["cycles"].values())
    lock = mk.fused_trace_stats(scene, table, cc, cfg, alb, emi, seeds,
                                n_chunks=chunks, queue=False)
    assert torch.equal(lock["radiance"], L)
    n = cfg.width * cfg.height * cfg.spp // chunks
    assert lock["lane_steps"] == n * chunks * cfg.max_depth
    # Every warp-bounce is in the histogram of live lanes by bounce.
    assert int(lock["live_hist"].sum()) == lock["warp_steps"]


def test_queue_builds_check_their_arguments(dev):
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=16, height=8, spp=2, max_depth=3)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 16, 8)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    for fn in (mk.fused_trace, mk.fused_collect):  # no such build
        with pytest.raises(ValueError):
            fn(scene, table, cc, cfg, alb, emi, seeds=seeds,
               build="nonesuch")
    with pytest.raises(ValueError):
        mk.fused_trace_stats(scene, table, cc, cfg, alb.cpu(), emi.cpu(),
                             seeds)


# The queue of the retrace adjoint B4 and the wavefront adjoint B5b (one
# live bounce a trip, a column per ray slot flushed to scratch and summed
# in the lockstep loop's order) against their lockstep checking builds.

def _adjoint_inputs(cam, depth, rng, dev, seed=0, width=30, height=20):
    """The config, uniforms and per-ray and per-pixel cotangents of B4 on
    width x height x 4 ray slots a chunk (600 x 4 = 2400 slots at 30 x 20:
    neither a multiple of 32 nor of 128)."""
    chunks = 1 if rng == "tape" else int(rng.split("-")[1])
    cfg = RenderConfig(width=width, height=height, spp=4 * chunks,
                       spp_chunks=chunks, max_depth=depth)
    n = width * height * 4
    g = torch.Generator(device=dev).manual_seed(seed)
    if rng == "tape":
        kw = dict(cam_u=torch.rand((2, n), generator=g, device=dev),
                  tape=torch.rand((depth, 3, n), generator=g, device=dev))
    else:
        kw = dict(seeds=torch.tensor([seed, -9], dtype=torch.int32))
    kw.update(n_chunks=chunks)
    cots = (torch.rand((3, n), generator=g, device=dev),
            torch.rand((3, width * height), generator=g, device=dev))
    return cfg, kw, cots


def _b4_builds(scene, cam, alb, emi, cfg, kw, g, fastmath):
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    return {build: mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g,
                                    fastmath=fastmath, build=build, **kw)
            for build in ("queue", "lockstep")}


def _b5b_builds(scene, cam, alb, emi, cfg, kw, g):
    """B5b in both builds on B4's own rays and tape, and B4 on them."""
    o, d = _wavefront_rays(cam, cfg, kw["cam_u"], exact_division=True)
    table = mk.scene_table(scene)
    out = {build: mk.ray_adjoint(scene, table, cfg, alb, emi, o, d,
                                 kw["tape"], g, build=build)
           for build in ("queue", "lockstep")}
    out["B4"] = mk.fused_adjoint(scene, table,
                                 mk.camera_consts(cam, cfg.width, cfg.height),
                                 cfg, alb, emi, g, **kw)
    return out


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("depth", [1, 5, 32])
@pytest.mark.parametrize("rng", QUEUE_RNG)
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_queue_adjoint_equals_the_lockstep_build(dev, make, fastmath, rng,
                                                 depth):
    """B4's tables, per-ray and per-pixel cotangent, bit for bit."""
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg, kw, cots = _adjoint_inputs(cam, depth, rng, dev, seed=depth)
    for g in cots:
        out = _b4_builds(scene, cam, alb, emi, cfg, kw, g, fastmath)
        assert _same(out["queue"], out["lockstep"])
        assert all(torch.isfinite(t).all() for t in out["queue"])
    if depth > 1:  # the tri scene's light is seen only after a bounce
        assert out["queue"][1].abs().max() > 0


@pytest.mark.parametrize("depth", [1, 5, 32])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_queue_ray_adjoint_equals_the_lockstep_build(dev, make, depth):
    """B5b (exact, tape) in both builds, and B4 on the same rays and tape,
    bit for bit."""
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg, kw, (g, _) = _adjoint_inputs(cam, depth, "tape", dev, seed=depth)
    out = _b5b_builds(scene, cam, alb, emi, cfg, kw, g)
    assert _same(out["queue"], out["lockstep"])
    assert _same(out["queue"], out["B4"])


@pytest.mark.parametrize("fastmath", [False, True])
def test_queue_adjoints_with_many_table_rows(dev, fastmath):
    """61 real table rows (E = 183 accumulator entries a slot): B4 in 3
    chunks and in tape mode against its lockstep build and sweep(collect),
    B5b against its lockstep build, bit for bit."""
    scene, params, cam, alb, emi = _setup(gallery.build_rows, dev)
    assert alb.shape[0] - 1 + emi.shape[0] - 1 >= 40
    cfg, kw, (g, g_pix) = _adjoint_inputs(cam, 5, "internal-3", dev)
    out = _b4_builds(scene, cam, alb, emi, cfg, kw, g_pix, fastmath)
    assert _same(out["queue"], out["lockstep"])
    # Most rows take a gradient: the test reaches the large entries.
    assert int((out["queue"][0][:-1] != 0).any(dim=1).sum()) >= 30
    cfg, kw, (g, _) = _adjoint_inputs(cam, 5, "tape", dev, seed=1)
    out = _b4_builds(scene, cam, alb, emi, cfg, kw, g, fastmath)
    assert _same(out["queue"], out["lockstep"])
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    _, rsc, rbest = mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                     fastmath=fastmath, **kw)
    assert _same(out["queue"], mk.fused_sweep(scene, table, cfg, alb, emi,
                                              rsc, rbest, g))
    if not fastmath:
        out = _b5b_builds(scene, cam, alb, emi, cfg, kw, g)
        assert _same(out["queue"], out["lockstep"])
        assert _same(out["queue"], out["B4"])


def test_only_the_queue_adjoints_are_counted(dev):
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg, kw, (g, _) = _adjoint_inputs(cam, 5, "tape", dev)
    before = mk.launch_counts()
    _b5b_builds(scene, cam, alb, emi, cfg, kw, g)
    _b4_builds(scene, cam, alb, emi, cfg, kw, g, False)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(fused_adjoint=2, ray_adjoint=1)


def test_adjoint_timing_build_gives_b4s_tables(dev):
    """drt_fused_adjoint_stats in both loops: B4's tables bit for bit,
    not counted; the queue takes trip_counts_plain's lane-trips and the
    lockstep loop every bounce."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg, kw, (g, g_pix) = _adjoint_inputs(cam, 8, "internal-4", dev)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    ref = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g_pix,
                           fastmath=True, **kw)
    _, _, rbest = mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                   fastmath=True, **kw)
    trips = int(mk.trip_counts_plain(cfg, rbest, seeds=kw["seeds"]).sum())
    before = mk.launch_counts()
    for queue in (True, False):
        st = mk.fused_adjoint_stats(scene, table, cc, cfg, alb, emi, g_pix,
                                    kw["seeds"], n_chunks=kw["n_chunks"],
                                    queue=queue)
        assert _same(st["grads"], ref)
        assert all(v > 0 for v in st["cycles"].values())
        n_paths = 30 * 20 * 4 * kw["n_chunks"]
        assert st["lane_steps"] == (trips if queue
                                    else n_paths * cfg.max_depth)
    assert mk.launch_counts() == before


def test_adjoint_builds_check_their_names(dev):
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg, kw, (g, _) = _adjoint_inputs(cam, 3, "tape", dev)
    table = mk.scene_table(scene)
    o, d = _wavefront_rays(cam, cfg, kw["cam_u"])
    with pytest.raises(ValueError, match="nonesuch"):
        mk.fused_adjoint(scene, table, mk.camera_consts(cam, 30, 20), cfg,
                         alb, emi, g, build="nonesuch", **kw)
    with pytest.raises(ValueError, match="nonesuch"):
        mk.ray_adjoint(scene, table, cfg, alb, emi, o, d, kw["tape"], g,
                       build="nonesuch")
    with pytest.raises(ValueError, match="checking build"):
        mk.fused_adjoint_stats(scene, table, mk.camera_consts(cam, 30, 20),
                               cfg, alb.cpu(), emi.cpu(), g.cpu(), [1, 2])


# ---------------------------------------------------------------------------
# The stored-residual sweeps B3 and B8 (csrc/sweep_rows.cuh: a persistent
# grid over 128-slot groups, a slot's rows read up to its first dead row,
# through a ring in shared memory or through registers) against the
# retrace adjoints B4 and B9, bit for bit.

SWEEP_RNG = ["tape", "internal-3", "internal-16"]
SWEEP_DEPTHS = [1, 5, 8, 9, 32]  # 8 | 9: the head of a slot's rows


def _wide_tables(alb, emi, n_alb, n_emi):
    """alb and emi with their real rows repeated up to n_alb - 1 and
    n_emi - 1 real rows, the sentinel row last."""
    def wide(t, n):
        reps = -(-(n - 1) // (t.shape[0] - 1))
        return torch.cat([torch.cat([t[:-1]] * reps)[:n - 1],
                          t[-1:]]).contiguous()
    return wide(alb, n_alb), wide(emi, n_emi)


def _nan_after_dead(rsc, word, live):
    """rsc and the words with every row after each slot's first dead row
    overwritten: NaN in rsc, a NaN's bits in the words."""
    dead = torch.cumsum((~live).to(torch.int32), dim=-2) > 0
    after = torch.cumsum(dead.to(torch.int32), dim=-2) > 1
    return (torch.where(after, float("nan"), rsc),
            torch.where(after, 0x7FC00000, word).to(torch.int32))


def _b3_and_b4(scene, cam, alb, emi, cfg, kw, g, fastmath):
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    _, rsc, rbest = mk.fused_collect(scene, table, cc, cfg, alb, emi,
                                     fastmath=fastmath, **kw)
    b3 = mk.fused_sweep(scene, table, cfg, alb, emi, rsc, rbest, g,
                        n_chunks=kw["n_chunks"])
    b4 = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g,
                          fastmath=fastmath, **kw)
    return b3, b4, rsc, rbest


@pytest.mark.parametrize("depth", SWEEP_DEPTHS)
@pytest.mark.parametrize("rng", SWEEP_RNG)
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_sweep_equals_the_retrace_adjoint(dev, make, fastmath, rng, depth):
    """B3 = B4 with a per-ray and a per-pixel cotangent, and B3 on rows of
    NaN after each slot's first dead row = B3, bit for bit."""
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg, kw, cots = _adjoint_inputs(cam, depth, rng, dev, seed=depth)
    before = mk.launch_counts()
    for g in cots:
        b3, b4, rsc, rbest = _b3_and_b4(scene, cam, alb, emi, cfg, kw, g,
                                        fastmath)
        assert _same(b3, b4)
        assert all(torch.isfinite(t).all() for t in b3)
    torch.cuda.synchronize()
    assert mk.launch_counts()["fused_sweep"] == before["fused_sweep"] + 2
    rsc_n, rbest_n = _nan_after_dead(rsc, rbest, rbest > 0)
    assert _same(mk.fused_sweep(scene, mk.scene_table(scene), cfg, alb, emi,
                                rsc_n, rbest_n, g, n_chunks=kw["n_chunks"]),
                 b3)
    if depth > 1:  # the tri scene's light is seen only after a bounce
        assert b3[1].abs().max() > 0


@pytest.mark.parametrize("n", [1, 127, 129, 300])
def test_sweeps_with_a_partial_last_group(dev, n):
    """n ray slots a chunk (n x 1 pixels, 3 chunks): B3 = B4 and B8 = B9
    when the last 128-slot group is partial or the only one."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=n, height=1, spp=3, spp_chunks=3, max_depth=5)
    seeds = torch.tensor([n, 5], dtype=torch.int32)
    kw = dict(seeds=seeds, n_chunks=3)
    g = torch.rand((3, n), generator=torch.Generator(device=dev).manual_seed(
        n), device=dev)
    b3, b4, _, _ = _b3_and_b4(scene, cam, alb, emi, cfg, kw, g, True)
    assert _same(b3, b4)
    ds = dk.DynScene(scene)
    _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg, n_chunks=3)(
        alb, emi, seeds)
    b8 = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=3)(alb, emi, rsc, rrow,
                                                       g)
    b9 = dk.make_dyn_adjoint(ds, cam, cfg, n_chunks=3)(alb, emi, seeds, g)
    assert _same(b8, b9)


_DYN_SWEEP_SCENES = dict(DYN_SCENES, mesh327=_mesh(2), mesh1287=_mesh(3))


@pytest.mark.parametrize("depth", [5, 9, 32])
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("name", sorted(_DYN_SWEEP_SCENES))
def test_dyn_sweep_equals_the_retrace_adjoint(dev, name, fastmath, chunks,
                                              depth):
    """B8 = B9 with a per-ray and a per-pixel cotangent, and B8 on rows of
    NaN after each slot's first dead row = B8, bit for bit."""
    scene, params, cam, alb, emi = _setup(_DYN_SWEEP_SCENES[name], dev)
    ds = dk.DynScene(scene)
    cfg, kw, cots = _adjoint_inputs(cam, depth, f"internal-{chunks}", dev,
                                    seed=depth)
    coll = dk.make_dyn_collect_tracer(ds, cam, cfg, fastmath=fastmath,
                                      n_chunks=chunks)
    _, rsc, rrow = coll(alb, emi, kw["seeds"])
    sweep = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=chunks)
    adj = dk.make_dyn_adjoint(ds, cam, cfg, fastmath=fastmath,
                              n_chunks=chunks)
    for g in cots:
        b8 = sweep(alb, emi, rsc, rrow, g)
        assert _same(b8, adj(alb, emi, kw["seeds"], g))
        assert all(torch.isfinite(t).all() for t in b8)
    rsc_n, rrow_n = _nan_after_dead(rsc, rrow, (rrow >> 16) > 0)
    assert _same(sweep(alb, emi, rsc_n, rrow_n, g), b8)


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 8, 9, 32])
def test_sweep_stages_by_table_rows(dev, depth):
    """The ring takes what the accumulator leaves of a block's shared
    memory: 3 stages at E = 12 (the Cornell box) and at E = 378 (the
    scene-table limit, 63 + 63 real rows), and for the dyn family up to
    128 real rows; at E = 432 (the dyn family's 144 rows) 5 KB are left,
    which hold 3 stages of one row and 2 of two, and none of more: there
    the rows come through registers."""
    assert mk.fused_sweep_stages(4, 2, depth) == 3
    assert mk.fused_sweep_stages(64, 64, depth) == 3
    assert dk.dyn_sweep_stages(4, 2, depth) == 3
    assert dk.dyn_sweep_stages(65, 65, depth) == 3
    assert dk.dyn_sweep_stages(73, 73, depth) == {1: 3, 2: 2}.get(depth, 0)


@pytest.mark.parametrize("depth", [5, 9])
def test_sweeps_at_the_row_limits(dev, depth):
    """The accumulator at its limits: 63 + 63 real rows (E = 378) for B3,
    with a ring; 72 + 72 = 144 for B8, whose accumulator leaves no room for
    a ring, so its rows come through registers; and 64 + 64 for B8, with
    a ring. Each = its retrace adjoint, bit for bit."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg, kw, (g, g_pix) = _adjoint_inputs(cam, depth, "internal-3", dev)
    a63, e63 = _wide_tables(alb, emi, 64, 64)
    assert mk.fused_sweep_stages(64, 64, depth) == 3
    b3, b4, _, _ = _b3_and_b4(scene, cam, a63, e63, cfg, kw, g_pix, True)
    assert _same(b3, b4)
    assert int((b3[0][:-1] != 0).any(dim=1).sum()) >= 2
    ds = dk.DynScene(scene)
    for rows, stages in ((73, 0), (65, 3)):
        a, e = _wide_tables(alb, emi, rows, rows)
        assert dk.dyn_sweep_stages(rows, rows, depth) == stages
        _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, cfg,
                                                  n_chunks=3)(
            a, e, kw["seeds"])
        b8 = dk.make_dyn_sweep_adjoint(ds, cfg, n_chunks=3)(a, e, rsc, rrow,
                                                           g)
        b9 = dk.make_dyn_adjoint(ds, cam, cfg, n_chunks=3)(a, e, kw["seeds"],
                                                          g)
        assert _same(b8, b9)


# The segment adjoint B4-seg: its queue (one live bounce a trip, each
# warp's open groups of 128 lanes summed in shared memory), which it runs
# past the camera where those sums fit, against its lockstep checking
# build, bit for bit, on chains of segments with and without compaction
# between them; from the camera, and where the sums do not fit, it runs
# the lockstep loop itself.

def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    """Equal bit for bit, a NaN's bits included."""
    return len(a) == len(b) and all(torch.equal(_bits(x), _bits(y))
                                    for x, y in zip(a, b))


def _pad(t, value=0):
    return torch.nn.functional.pad(t, (0, 1), value=value)


def _special(S):
    """S with lanes of +0, -0, a negative, a large value, NaN and inf: the
    seeds of the paths that end before the segment's end."""
    S = S.clone()
    for step, v in ((5, 0.0), (7, -0.0), (11, float("nan")),
                    (13, float("inf")), (17, -3.0), (19, 1e30),
                    (23, float("-inf"))):
        S[:, ::step] = v
    return S


def _segment_chain(scene, cam, cfg, alb, emi, splits, rng, fastmath,
                   compact, dev, n=None, seed=0, chunk=0):
    """The segment tracers of a split chain on n lanes (default one
    chunk), each fed the previous one's exit state: as it is, or with its
    live lanes gathered in order into K = (live rounded up to 128) + 37
    lanes (at most the previous K), the rest dead pad lanes on a pad slot.
    Per segment (b0, b1, K, call args, kw, scatter index to the previous
    segment's lanes or None)."""
    D = cfg.max_depth
    npix = cfg.width * cfg.height
    n = npix * (cfg.spp // cfg.spp_chunks) if n is None else n
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = dict(rng="tape" if rng == "tape" else "internal",
                fastmath=fastmath)
    call = {} if rng == "tape" else dict(chunk=chunk)
    if rng == "tape":
        cam_u = torch.rand((2, n), generator=gen, device=dev)
        tape = torch.rand((D, 3, n), generator=gen, device=dev)
    seeds = torch.tensor([seed, -3], dtype=torch.int32)
    bounds = [0, *splits, D]
    state, cidx, scatter, K, segs = (), None, None, n, []
    for b0, b1 in zip(bounds, bounds[1:]):
        if rng == "tape":
            u = (tape[b0:b1] if cidx is None else
                 _pad(tape[b0:b1])[..., cidx.long()]).contiguous()
            args = ((cam_u,) if b0 == 0 else ()) + (u,) + tuple(state)
        else:
            ridx = ((torch.arange(K, dtype=torch.int32, device=dev)
                     if cidx is None else cidx),) if b0 > 0 else ()
            args = (seeds,) + tuple(state) + ridx
        kw = dict(base, n_rays=K)
        segs.append((b0, b1, K, args, kw, call, scatter))
        if b1 == D:
            break
        out = mk.make_fused_segment_tracer(scene, cam, cfg, b0, b1, **kw)(
            alb, emi, *args, **call)
        ray, alive = out[1]
        scatter = None
        if compact:
            on = alive > 0
            K_next = min(K, -(-int(on.sum()) // 128) * 128 + 37)
            idx = fused.compact_lanes(on, K_next, K)
            ray, alive = _pad(ray)[:, idx], _pad(alive)[idx]
            cidx = (idx if cidx is None else
                    _pad(cidx.long(), n)[idx]).to(torch.int32)
            scatter, K = idx, K_next
        state = (ray.contiguous(), alive.contiguous())
    return segs


def _check_segment_adjoints(scene, cam, cfg, alb, emi, segs, dev,
                            special=True, seed=0):
    """B4-seg = its lockstep build, bit for bit (tables and S_start),
    segment after segment from the last, each fed the queue's S_start of
    the next as S_end (scattered back to its lanes, with the
    values of `_special` on some lanes); a per-lane cotangent and, at
    b0 == 0, a per-pixel one. Returns the count of real table entries
    that took a gradient."""
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    npix = cfg.width * cfg.height
    S, taken = None, 0
    for b0, b1, K, args, kw, call, scatter in reversed(segs):
        cots = [torch.rand((3, K), generator=gen, device=dev)]
        if b0 == 0:
            cots.append(torch.rand((3, npix), generator=gen, device=dev))
        tail = () if S is None else (S,)
        for g in cots:
            out = {build: mk.make_fused_segment_adjoint(
                scene, cam, cfg, b0, b1, build=build, **kw)(
                    alb, emi, *args, g, *tail, **call)
                for build in mk.BUILDS}
            assert _same_bits(out["queue"], out["lockstep"]), (b0, b1, K)
            taken += int((out["queue"][0][:-1] != 0).sum()
                         + (out["queue"][1][:-1] != 0).sum())
        if b0 == 0:
            break
        S = out["queue"][2]
        if scatter is not None:
            K_prev = segs[[s[0] for s in segs].index(b0) - 1][2]
            full = torch.zeros((3, K_prev + 1), device=dev)
            full[:, scatter] = S
            S = full[:, :K_prev]
        S = (_special(S) if special else S).contiguous()
    return taken


SEGMENT_SPLITS = [(5, (2,)), (5, (1, 3)), (32, (16,))]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("depth,splits", SEGMENT_SPLITS,
                         ids=["5-2", "5-1-3", "32-16"])
@pytest.mark.parametrize("rng", ["tape", "internal"])
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_segment_queue_equals_the_lockstep_build(dev, make, fastmath, rng,
                                                 depth, splits, compact):
    """B4-seg on 30x20x4 lanes of chunk 1 (2400: neither a multiple of 32
    nor of 128), each segment's K lanes as the chain leaves them; on the
    compacted chains S_end holds the values of `_special` on some lanes."""
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg = RenderConfig(width=30, height=20, spp=8, spp_chunks=2,
                       max_depth=depth)
    segs = _segment_chain(scene, cam, cfg, alb, emi, splits, rng, fastmath,
                          compact, dev, seed=depth, chunk=1)
    assert _check_segment_adjoints(scene, cam, cfg, alb, emi, segs, dev,
                                   special=compact, seed=depth) > 0


@pytest.mark.parametrize("K", [1, 127, 129])
@pytest.mark.parametrize("rng", ["tape", "internal"])
def test_segment_queue_with_few_lanes(dev, rng, K):
    """K lanes in every segment of a chain split at (2,): a partial warp,
    a partial group of 128, one lane past a group."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    segs = _segment_chain(scene, cam, cfg, alb, emi, (2,), rng, False,
                          False, dev, n=K, seed=K)
    _check_segment_adjoints(scene, cam, cfg, alb, emi, segs, dev, seed=K)


@pytest.mark.parametrize("fastmath", [False, True])
def test_segment_queue_at_the_row_limits(dev, fastmath):
    """63 + 63 real table rows (E = 378): the queue's sums do not fit in
    shared memory, so B4-seg runs the lockstep loop past the camera too
    and = the lockstep build on a compacted chain split at (1, 3); with
    the Cornell box's tables it runs the queue past the camera, and the
    lockstep loop from it."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    a63, e63 = _wide_tables(alb, emi, 64, 64)
    n_shapes = mk.scene_table(scene).shape[0]
    assert [mk.segment_form(b0, n_shapes, alb.shape[0], emi.shape[0])
            for b0 in (0, 1, 3)] == ["lockstep", "queue", "queue"]
    assert [mk.segment_form(b0, n_shapes, 64, 64)
            for b0 in (0, 1, 3)] == ["lockstep"] * 3
    cfg = RenderConfig(width=30, height=20, spp=8, spp_chunks=2,
                       max_depth=5)
    for rng in ("tape", "internal"):
        segs = _segment_chain(scene, cam, cfg, a63, e63, (1, 3), rng,
                              fastmath, True, dev, chunk=1)
        assert _check_segment_adjoints(scene, cam, cfg, a63, e63, segs,
                                       dev) > 0


def test_only_the_segment_queue_is_counted(dev):
    """The entry point's launches count, whichever loop it runs; those of
    the lockstep checking build do not."""
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    segs = _segment_chain(scene, cam, cfg, alb, emi, (2,), "tape", False,
                          False, dev)
    before = mk.launch_counts()
    _check_segment_adjoints(scene, cam, cfg, alb, emi, segs, dev)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    # [2, 5) once, [0, 2) with a per-lane and a per-pixel cotangent.
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(segment_adjoint=3)


@pytest.mark.parametrize("depth", [1, 5, 16, 32])
@pytest.mark.parametrize("rng", ["tape", "internal-1", "internal-3",
                                 "internal-16"])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_earlyexit_queue_equals_the_lockstep_tracer(dev, make, rng, depth):
    """B14 (the tracer's queue, exact) against B1's lockstep build exact,
    bit for bit, on 30x20x4 ray slots a chunk."""
    from drt_tpu_torch.ops import earlyexit

    scene, params, cam, alb, emi = _setup(make, dev)
    cfg, kw, _ = _queue_and_lockstep(scene, cam, alb, emi, depth, False, rng,
                                     dev, seed=depth)
    ee_kw = {k: v for k, v in kw.items() if k != "fastmath"}
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    got = earlyexit.earlyexit_trace(scene, table, cc, cfg, alb, emi, **ee_kw)
    ref = mk.fused_trace(scene, table, cc, cfg, alb, emi, build="lockstep",
                         fastmath=False, **ee_kw)
    assert torch.equal(got, ref)


# The regeneration sweep B11: its window kernel (each warp's rows copied
# in windows of adjacent pixels' rows into a ring in shared memory)
# against its checking build, the per-pixel kernel, bit for bit.
def _regen_rows(scene, cam, alb, emi, cfg, chunks, fastmath, dev, seed):
    from drt_tpu_torch.ops import regen as rg

    _, rsc, rmeta, trips = rg.make_regen_tracer(
        scene, cam, cfg, collect=True, fastmath=fastmath, n_chunks=chunks)(
        alb, emi, torch.tensor([seed, 5], dtype=torch.int32))
    npix = cfg.width * cfg.height
    g = torch.rand((3, npix), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    return rsc, rmeta, trips, g


def _nan_beyond_trips(rsc, rmeta, trips):
    """The rows with NaN (and all bits set) wherever a pixel's trips
    end."""
    t = torch.arange(rsc.shape[1], device=rsc.device)[None, :, None]
    own = t < trips[:, None, :]
    return (torch.where(own, rsc, float("nan")).contiguous(),
            torch.where(own, rmeta, -1).contiguous())


@pytest.mark.parametrize("depth", [1, 5, 8, 9, 32])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("fastmath", [False, True])
def test_regen_sweep_windows_equal_the_per_pixel_kernel(dev, fastmath,
                                                        chunks, depth):
    """61x47 pixels (a partial warp and group), 24 samples a chunk (about
    70 rows a pixel's chunk: the ring of either instance wraps), one and
    two chunks, both instances (max_depth 8 | 9); also over rows of NaN
    beyond each pixel's trips."""
    from drt_tpu_torch.ops import regen as rg

    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=61, height=47, spp=24 * chunks,
                       spp_chunks=chunks, max_depth=depth)
    rsc, rmeta, trips, g = _regen_rows(scene, cam, alb, emi, cfg, chunks,
                                       fastmath, dev, depth)
    assert rg.regen_sweep_form(cfg, alb, emi) == "window"
    out = {build: rg.make_regen_sweep_adjoint(
        scene, cfg, n_chunks=chunks, build=build)(
            alb, emi, rsc, rmeta, trips, g) for build in mk.BUILDS}
    assert _same_bits(out["queue"], out["lockstep"])
    assert any((t[:-1] != 0).any() for t in out["queue"])
    nan_rows = _nan_beyond_trips(rsc, rmeta, trips)
    assert _same_bits(rg.make_regen_sweep_adjoint(
        scene, cfg, n_chunks=chunks)(alb, emi, *nan_rows, trips, g),
        out["lockstep"])


@pytest.mark.parametrize("depth", [5, 32])
def test_regen_sweep_at_the_row_limits(dev, depth):
    """63 + 63 real table rows (E = 378): the 8-bounce instance's ring
    still fits beside the accumulator, the 32-bounce one's does not, and
    there the launch takes the per-pixel kernel; both = the checking
    build, bit for bit, on 3 chunks."""
    from drt_tpu_torch.ops import regen as rg

    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    a63, e63 = _wide_tables(alb, emi, 64, 64)
    cfg = RenderConfig(width=61, height=47, spp=24, spp_chunks=3,
                       max_depth=depth)
    assert rg.regen_sweep_form(cfg, a63, e63) == (
        "window" if depth <= 8 else "per-pixel")
    rsc, rmeta, trips, g = _regen_rows(scene, cam, a63, e63, cfg, 3, True,
                                       dev, depth)
    out = [rg.make_regen_sweep_adjoint(scene, cfg, n_chunks=3, build=b)(
        a63, e63, rsc, rmeta, trips, g) for b in mk.BUILDS]
    assert _same_bits(*out)
    assert int((out[0][0][:-1] != 0).any(dim=1).sum()) >= 2


def test_only_the_regen_sweep_entry_point_is_counted(dev):
    from drt_tpu_torch.ops import regen as rg

    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    rsc, rmeta, trips, g = _regen_rows(scene, cam, alb, emi, cfg, 1, True,
                                       dev, 1)
    before = mk.launch_counts()
    for build in mk.BUILDS:
        rg.make_regen_sweep_adjoint(scene, cfg, build=build)(
            alb, emi, rsc, rmeta, trips, g)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(regen_sweep=1)


# The mesh regeneration sweep B13: its window kernel (B11's window sweep,
# csrc/regen_window.cuh, with the dyn family's row decoder) against its
# checking build, the per-pixel kernel, bit for bit; the kernel each
# launch runs, by name under torch.profiler.
def _dyn_regen_rows(make, cfg, chunks, dev, seed):
    from drt_tpu_torch.ops import dynregen as dr

    scene, params, cam, alb, emi = _setup(make, dev)
    _, rsc, rrow, trips = dr.make_dyn_regen_tracer(
        dk.DynScene(scene), cam, cfg, collect=True, fastmath=True,
        n_chunks=chunks)(alb, emi, torch.tensor([seed, 5], dtype=torch.int32))
    g = torch.rand((3, cfg.width * cfg.height), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    return alb, emi, rsc, rrow, trips, g


def _kernels_run(fn) -> set:
    """The names of the CUDA kernels fn() launches, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


DYN_SWEEP_SCENES = {"glossy": gallery.build_glossy, "mesh87": _mesh(1)}


@pytest.mark.parametrize("depth", [1, 5, 8, 9, 32])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("name", list(DYN_SWEEP_SCENES))
def test_dyn_regen_sweep_windows_equal_the_per_pixel_kernel(dev, name,
                                                            chunks, depth):
    """61x47 pixels (a partial warp and group), 24 samples a chunk (the
    ring of either instance wraps), one and two chunks, both instances
    (max_depth 8 | 9); also over rows of NaN beyond each pixel's
    trips."""
    from drt_tpu_torch.ops import dynregen as dr

    cfg = RenderConfig(width=61, height=47, spp=24 * chunks,
                       spp_chunks=chunks, max_depth=depth)
    alb, emi, rsc, rrow, trips, g = _dyn_regen_rows(
        DYN_SWEEP_SCENES[name], cfg, chunks, dev, depth)
    assert dr.dyn_regen_sweep_form(cfg, alb, emi) == "window"
    out = {build: dr.make_dyn_regen_sweep_adjoint(
        None, cfg, n_chunks=chunks, build=build)(
            alb, emi, rsc, rrow, trips, g) for build in mk.BUILDS}
    assert _same_bits(out["queue"], out["lockstep"])
    assert any((t[:-1] != 0).any() for t in out["queue"])
    nan_rows = _nan_beyond_trips(rsc, rrow, trips)
    assert _same_bits(dr.make_dyn_regen_sweep_adjoint(
        None, cfg, n_chunks=chunks)(alb, emi, *nan_rows, trips, g),
        out["lockstep"])


@pytest.mark.parametrize("depth", [5, 32])
def test_dyn_regen_sweep_runs_the_kernel_its_form_says(dev, depth):
    """On the mesh's tables the window kernel; on synthetic tables of
    100 + 40 real rows (the mesh's rows with their table rows drawn anew:
    B13 reads no scene) the ring does not fit beside the accumulator and
    the launch takes the per-pixel kernel. Each = the checking build, bit
    for bit, on 2 chunks."""
    from drt_tpu_torch.ops import dynregen as dr

    cfg = RenderConfig(width=61, height=47, spp=16, spp_chunks=2,
                       max_depth=depth)
    alb, emi, rsc, rrow, trips, g = _dyn_regen_rows(_mesh(1), cfg, 2, dev,
                                                    depth)
    gen = torch.Generator(device=dev).manual_seed(depth)
    a140 = torch.rand((101, 3), generator=gen, device=dev)
    e140 = torch.rand((41, 3), generator=gen, device=dev)
    ar = torch.randint(0, 101, rrow.shape, generator=gen, device=dev,
                       dtype=torch.int32)
    er = torch.randint(0, 41, rrow.shape, generator=gen, device=dev,
                       dtype=torch.int32)
    rrow140 = ((rrow & ~0xFFFF) | ar | (er << 8)).contiguous()
    for tables, rows, form in (((alb, emi), rrow, "window"),
                               ((a140, e140), rrow140, "per-pixel")):
        assert dr.dyn_regen_sweep_form(cfg, *tables) == form
        sweeps = {build: dr.make_dyn_regen_sweep_adjoint(
            None, cfg, n_chunks=2, build=build) for build in mk.BUILDS}
        out = {}
        names = _kernels_run(lambda: out.setdefault("queue", sweeps["queue"](
            *tables, rsc, rows, trips, g)))
        ran = {n for n in names if "dyn_regen_" in n}
        kernel = ("dyn_regen_window_kernel" if form == "window"
                  else "dyn_regen_sweep_kernel")
        assert ran and all(kernel in n for n in ran), ran
        ref = sweeps["lockstep"](*tables, rsc, rows, trips, g)
        assert _same_bits(out["queue"], ref)
        assert int((ref[0][:-1] != 0).any(dim=1).sum()) >= 2


def test_only_the_dyn_regen_sweep_entry_point_is_counted(dev):
    from drt_tpu_torch.ops import dynregen as dr

    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    alb, emi, rsc, rrow, trips, g = _dyn_regen_rows(_mesh(1), cfg, 1, dev, 1)
    before = mk.launch_counts()
    for build in mk.BUILDS:
        dr.make_dyn_regen_sweep_adjoint(None, cfg, build=build)(
            alb, emi, rsc, rrow, trips, g)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(dyn_regen_sweep=1)


# The segment tracer B1-seg: the queue of its lanes past the camera
# against its lockstep checking build, bit for bit.
def _check_segment_tracers(scene, cam, cfg, alb, emi, segs):
    """B1-seg = its lockstep build on each segment of a chain: radiance,
    alive and the exit ray bit for bit on the lanes alive at b_end, and
    +0 = the lockstep loop's values on the others. Returns the count of
    lanes alive at a segment's end."""
    alive_at_end = 0
    for b0, b1, K, args, kw, call, _ in segs:
        out = {build: mk.make_fused_segment_tracer(
            scene, cam, cfg, b0, b1, build=build, **kw)(
                alb, emi, *args, **call) for build in mk.BUILDS}
        q, ref = out["queue"], out["lockstep"]
        if b1 == cfg.max_depth:
            assert _same_bits((q,), (ref,)), (b0, b1, K)
            continue
        assert _same_bits((q[0], q[1][1]), (ref[0], ref[1][1])), (b0, b1, K)
        live = ref[1][1] > 0
        assert _same_bits((q[1][0][:, live],), (ref[1][0][:, live],))
        assert torch.equal(q[1][0][:, ~live], ref[1][0][:, ~live])
        assert not q[1][0][:, ~live].any()
        alive_at_end += int(live.sum())
    return alive_at_end


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("depth,splits", SEGMENT_SPLITS,
                         ids=["5-2", "5-1-3", "32-16"])
@pytest.mark.parametrize("rng", ["tape", "internal"])
@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_tri])
def test_segment_tracer_queue_equals_the_lockstep_build(dev, make, fastmath,
                                                        rng, depth, splits,
                                                        compact):
    """B1-seg on the chains of test_segment_queue_equals_the_lockstep_build
    (30x20x4 lanes of chunk 1; compacted or not)."""
    scene, params, cam, alb, emi = _setup(make, dev)
    cfg = RenderConfig(width=30, height=20, spp=8, spp_chunks=2,
                       max_depth=depth)
    segs = _segment_chain(scene, cam, cfg, alb, emi, splits, rng, fastmath,
                          compact, dev, seed=depth, chunk=1)
    alive = _check_segment_tracers(scene, cam, cfg, alb, emi, segs)
    # No path reaches bounce 16 (the roulette from bounce 1 on), and the
    # open triangle scene's paths rarely bounce on at all.
    assert alive > 0 or depth == 32 or make is gallery.build_tri


@pytest.mark.parametrize("K", [1, 127, 129])
@pytest.mark.parametrize("rng", ["tape", "internal"])
def test_segment_tracer_queue_with_few_lanes(dev, rng, K):
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    segs = _segment_chain(scene, cam, cfg, alb, emi, (2,), rng, False,
                          False, dev, n=K, seed=K)
    _check_segment_tracers(scene, cam, cfg, alb, emi, segs)


def test_segment_tracer_forms_and_counts(dev):
    """The queue past the camera, the lockstep loop from it; the entry
    point's launches count, the checking build's do not."""
    assert [mk.segment_trace_form(b0) for b0 in (0, 1, 2, 16)] == [
        "lockstep", "queue", "queue", "queue"]
    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=30, height=20, spp=4, max_depth=5)
    segs = _segment_chain(scene, cam, cfg, alb, emi, (2,), "tape", False,
                          False, dev)
    before = mk.launch_counts()
    _check_segment_tracers(scene, cam, cfg, alb, emi, segs)
    torch.cuda.synchronize()
    after = mk.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(segment_tracer=2)


# Per-vertex splitting (bsdf_samples > 1): the tape forms of B1-B4, B6-B9
# and B5a/B5b on M leaf lanes per camera sample.

SPLIT_FAMILIES = {
    "split": ("cuda-split", "torch-split", ("fused_tracer", "fused_collect",
                                            "fused_sweep", "fused_adjoint")),
    "split-dyn": ("cuda-split-dyn", "torch-split-dyn",
                  ("dyn_tracer", "dyn_collect", "dyn_sweep", "dyn_adjoint")),
}
SPLIT_CASES = [("split", cbox.build, 2, 1), ("split", gallery.build_glossy,
                                             3, 2),
               ("split-dyn", _mesh(1), 2, 2), ("split-dyn", _mesh(1), 3, 1)]
SPLIT_IDS = ["split-cbox-n2-c1", "split-glossy-n3-c2", "split-dyn-mesh87-n2-c2",
             "split-dyn-mesh87-n3-c1"]


def _split_cfg(n, chunks):
    return RenderConfig(width=16, height=12, spp=2 * chunks,
                        spp_chunks=chunks, max_depth=4 if n == 2 else 3,
                        bsdf_samples=n)


def _split_step(render, params, seeds):
    from drt_tpu_torch.scene import Params

    p = Params(*(t.clone().requires_grad_() for t in params))
    img = render(p, seeds)
    (img ** 2).mean().backward()
    return img.detach(), p.albedo.grad, p.emission.grad


@pytest.mark.parametrize("family,builder,n,chunks", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_split_kernels_match_plain_versions(dev, family, builder, n, chunks):
    """The "cuda-split*" renderer against its plain version at the same
    seeds (image per pixel, gradient tables), stored = retrace bit for
    bit, and each path's launch counts: one launch of each of its kernels
    per chunk."""
    from drt_tpu_torch.parallel.render import make_renderer, resolve_backend

    backend, plain, (tracer, collect, sweep, adjoint) = \
        SPLIT_FAMILIES[family]
    cfg = _split_cfg(n, chunks)
    scene, params, cam, _, _ = _setup(builder, dev)
    seeds = torch.tensor([13, -14], dtype=torch.int32)
    if family == "split":
        assert resolve_backend(scene, cfg) == backend
    mk.reset_launch_counts()
    img = make_renderer(scene, cfg, cam, differentiable=False,
                        backend=backend)(params, seeds)
    torch.cuda.synchronize()
    assert mk.launch_counts() == {**{k: 0 for k in mk.launch_counts()},
                                  tracer: chunks}
    ref = make_renderer(scene, cfg, cam, differentiable=False,
                        backend=plain)(params, seeds)
    assert torch.isfinite(img).all() and ref.mean() > 0
    assert _share_beyond(img.permute(2, 0, 1).reshape(3, -1),
                         ref.permute(2, 0, 1).reshape(3, -1),
                         2e-5, 2e-6) <= 1e-3
    steps = {}
    for adj, launched in (("stored", {collect: chunks, sweep: chunks}),
                          ("retrace", {tracer: chunks, adjoint: chunks})):
        make = (fused.make_split_fused_image_renderer if family == "split"
                else fused.make_split_dyn_image_renderer)
        mk.reset_launch_counts()
        steps[adj] = _split_step(make(scene, cam, cfg, adjoint=adj),
                                 params, seeds)
        torch.cuda.synchronize()
        assert mk.launch_counts() == {**{k: 0 for k in mk.launch_counts()},
                                      **launched}
    for a, b in zip(steps["stored"], steps["retrace"]):
        assert torch.equal(a, b)
    ref_step = _split_step(make_renderer(scene, cfg, cam, backend=plain),
                           params, seeds)
    _grads_close(steps["stored"][1:], ref_step[1:])


@pytest.mark.parametrize("n,chunks", [(2, 1), (3, 2)])
def test_split_wavefront_matches_plain_and_split(dev, n, chunks):
    """"cuda-wavefront" at bsdf_samples > 1: B5a's and B5b's tape forms on
    each chunk's ray-major lanes, against "torch-wavefront" (image and
    gradients), and its image against "cuda-split"'s at the same seeds
    (the same draws and paths in another lane order); one launch of each
    kernel per chunk."""
    from drt_tpu_torch.parallel.render import make_renderer

    cfg = _split_cfg(n, chunks)
    scene, params, cam, _, _ = _setup(cbox.build, dev)
    seeds = torch.tensor([15, 16], dtype=torch.int32)
    mk.reset_launch_counts()
    got = _split_step(make_renderer(scene, cfg, cam,
                                    backend="cuda-wavefront"), params, seeds)
    torch.cuda.synchronize()
    assert mk.launch_counts() == {**{k: 0 for k in mk.launch_counts()},
                                  "ray_tracer": chunks,
                                  "ray_adjoint": chunks}
    ref = _split_step(make_renderer(scene, cfg, cam,
                                    backend="torch-wavefront"), params,
                      seeds)
    split = make_renderer(scene, cfg, cam, differentiable=False,
                          backend="cuda-split")(params, seeds)
    for other in (ref[0], split):
        assert _share_beyond(got[0].permute(2, 0, 1).reshape(3, -1),
                             other.permute(2, 0, 1).reshape(3, -1),
                             2e-5, 2e-6) <= 1e-3
    _grads_close(got[1:], ref[1:])


def test_split_tape_on_the_card_is_the_cpu_tape(dev):
    cfg = _split_cfg(2, 2)
    for chunk in (0, 1):
        for a, b in zip(fused.split_prefix_tape([3, 4], chunk, cfg, dev),
                        fused.split_prefix_tape([3, 4], chunk, cfg)):
            assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# The global ray offset (ray_base): a shard's launch is the slice of the
# launch from 0.

OFFSET_SHARDS = 4


def _offset_family(family):
    """(scene constructor, prepare the scene, tracer, collect, sweep, retrace
    adjoint makers) of a lockstep family."""
    if family == "fused":
        return (cbox.build, lambda s: s, mk.make_fused_tracer,
                mk.make_fused_collect_tracer, mk.make_fused_sweep_adjoint,
                mk.make_fused_adjoint)
    return (_mesh(1), dk.DynScene, dk.make_dyn_tracer,
            dk.make_dyn_collect_tracer, dk.make_dyn_sweep_adjoint,
            dk.make_dyn_adjoint)


@pytest.mark.parametrize("rng", ["internal", "tape"])
@pytest.mark.parametrize("family", ["fused", "dyn"])
def test_ray_base_gives_the_slice_of_the_launch_from_0(dev, family, rng):
    """B1/B6 and B2/B7 at ray_base = k n / 4 on n / 4 slots equal the
    slice [k n / 4, (k + 1) n / 4) of their launch from 0 bit for bit
    (internal RNG over 2 chunks, and tape form); B4/B9 there equal B3/B8
    on that slice of B2/B7's residuals bit for bit; each matches its plain
    version at that offset (C.4 tolerances)."""
    build, prep, make_t, make_c, make_s, make_a = _offset_family(family)
    scene, params, cam, alb, emi = _setup(build, dev)
    ks = prep(scene)
    chunks = 2 if rng == "internal" else 1
    cfg = RenderConfig(width=64, height=48, spp=4 * chunks,
                       spp_chunks=chunks, max_depth=5)
    n = 64 * 48 * 4
    q = n // OFFSET_SHARDS
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.rand((3, 64 * 48), generator=gen, device=dev)
    g_ray = g.repeat(1, 4)
    if rng == "internal":
        uniforms = (torch.tensor([41, -42], dtype=torch.int32),)
    else:
        uniforms = (torch.rand((2, n), generator=gen, device=dev),
                    torch.rand((5, 3, n), generator=gen, device=dev))
    kw = dict(rng=rng, n_chunks=chunks)
    full_L = make_t(ks, cam, cfg, **kw)(alb, emi, *uniforms)
    full_c = make_c(ks, cam, cfg, **kw)(alb, emi, *uniforms)
    assert torch.equal(full_c[0], full_L) and full_L.mean() > 0
    for k in range(OFFSET_SHARDS):
        a, b = k * q, (k + 1) * q
        mine = tuple(u if rng == "internal" else u[..., a:b].contiguous()
                     for u in uniforms)
        shard = dict(n_rays=q, **kw)
        L = make_t(ks, cam, cfg, **shard)(alb, emi, *mine, ray_base=a)
        assert torch.equal(L, full_L[:, a:b])
        coll = make_c(ks, cam, cfg, **shard)(alb, emi, *mine, ray_base=a)
        for x, y in zip(coll, full_c):
            assert torch.equal(x, y[..., a:b])
        g_k = g_ray[:, a:b].contiguous()
        adj = make_a(ks, cam, cfg, **shard)(alb, emi, *mine, g_k,
                                            ray_base=a)
        sweep = make_s(ks, cfg, n_chunks=chunks, n_rays=q)(
            alb, emi, *(r.contiguous() for r in coll[1:]), g_k)
        for x, y in zip(adj, sweep):
            assert torch.equal(x, y)
        if k in (0, OFFSET_SHARDS - 1):
            ref = make_t(ks, cam, cfg, plain=True, **shard)(
                alb, emi, *mine, ray_base=a)
            assert _share_beyond(L, ref, 2e-5, 2e-6) <= 1e-3
            _grads_close(adj, make_a(ks, cam, cfg, plain=True, **shard)(
                alb, emi, *mine, g_k, ray_base=a))
    half = n // 2  # a per-pixel cotangent does not fit a shard's slots
    with pytest.raises(ValueError, match="per ray"):
        make_a(ks, cam, cfg, n_rays=half, **kw)(alb, emi, *(
            uniforms if rng == "internal" else
            (u[..., half:].contiguous() for u in uniforms)), g,
            ray_base=half)


def test_earlyexit_ray_base_gives_the_slice(dev):
    from drt_tpu_torch.ops.earlyexit import make_earlyexit_tracer

    scene, params, cam, alb, emi = _setup(cbox.build, dev)
    cfg = RenderConfig(width=64, height=48, spp=8, spp_chunks=2,
                       max_depth=5)
    n = 64 * 48 * 4
    q = n // OFFSET_SHARDS
    seeds = torch.tensor([5, 9], dtype=torch.int32)
    full = make_earlyexit_tracer(scene, cam, cfg, n_chunks=2)(alb, emi,
                                                               seeds)
    for k in range(OFFSET_SHARDS):
        got = make_earlyexit_tracer(scene, cam, cfg, n_rays=q, n_chunks=2)(
            alb, emi, seeds, ray_base=k * q)
        assert torch.equal(got, full[:, k * q:(k + 1) * q])


@pytest.mark.parametrize("family,make", [REGEN_CASES[0], REGEN_CASES[5]],
                         ids=["regen-cbox", "dyn-mesh87"])
def test_regen_ray_base_gives_the_pixel_slice(dev, family, make):
    """B10/B12 (tracer and collect forms) at the pixel offset k P / 4 on
    P / 4 pixels equal the slice of their launch from 0: radiance and
    trips bit for bit, and every row below each pixel's trips; their
    plain versions at that offset agree (C.4 tolerances)."""
    prep, make_t = _regen_family(family)[:2]
    scene, params, cam, alb, emi = _setup(make, dev)
    ks = prep(scene)
    cfg = RenderConfig(width=64, height=48, spp=8, spp_chunks=2,
                       max_depth=5)
    npix = 64 * 48
    q = npix // OFFSET_SHARDS
    seeds = torch.tensor([17, 18], dtype=torch.int32)
    full_L, full_trips = make_t(ks, cam, cfg, n_chunks=2)(alb, emi, seeds)
    full = make_t(ks, cam, cfg, collect=True, n_chunks=2)(alb, emi, seeds)
    for k in range(OFFSET_SHARDS):
        a, b = k * q, (k + 1) * q
        L, trips = make_t(ks, cam, cfg, n_chunks=2, n_pix=q)(
            alb, emi, seeds, ray_base=a)
        assert torch.equal(L, full_L[:, a:b])
        assert torch.equal(trips, full_trips[:, a:b])
        Lc, rsc, rows, trips_c = make_t(ks, cam, cfg, collect=True,
                                        n_chunks=2, n_pix=q)(
            alb, emi, seeds, ray_base=a)
        assert torch.equal(Lc, L) and torch.equal(trips_c, trips)
        own = (torch.arange(rsc.shape[1], device=dev)[None, :, None]
               < trips[:, None, :])
        assert torch.equal(rsc[own], full[1][..., a:b][own])
        assert torch.equal(rows[own], full[2][..., a:b][own])
        if k in (0, OFFSET_SHARDS - 1):
            ref = make_t(ks, cam, cfg, n_chunks=2, n_pix=q, plain=True)(
                alb, emi, seeds, ray_base=a)[0]
            assert _share_beyond(L, ref, 2e-5, 2e-6) <= 1e-3


# The deep forms of the adjoint kernels (csrc/grad_accum.cuh): paths past
# the 32 rows a thread keeps and tables past the 144 real rows whose
# accumulator a block's shared memory holds, against the plain versions.
# absorb_prob 0.1 keeps paths alive past bounce 32 (each test counts them)
# and albedo 0.8 (`_bright`) keeps their rows' weight.
DEEP_DEPTHS = [33, 40, 64]


def _deep_cfg(depth, **kw):
    return RenderConfig(width=16, height=12, spp=4, max_depth=depth,
                        absorb_prob=0.1, **kw)


def _wide_scene(dev, n_alb, n_emi):
    """A box of white walls around 60 triangles that use albedo rows
    spread over [0, n_alb) and emission rows over [0, n_emi)."""
    from drt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    alb = [b.albedo_param([0.3 + 0.4 * (k % 5) / 4, 0.5, 0.7 - 0.4 * (k % 3)
                           / 2]) for k in range(n_alb)]
    emi = [b.emission_param([0.05, 0.02 * (1 + k % 4), 0.05])
           for k in range(n_emi)]
    for n, off in (([-1.0, 0.0, 0.0], -3.0), ([1.0, 0.0, 0.0], -3.0),
                   ([0.0, 0.0, -1.0], -6.0), ([0.0, 0.0, 1.0], 0.0),
                   ([0.0, 1.0, 0.0], -3.0), ([0.0, -1.0, 0.0], -3.0)):
        b.plane(n, off, b.diffuse(alb[0]))
    for k in range(60):
        x, y = -2.5 + 0.5 * (k % 10), -2.5 + 0.8 * (k // 10)
        b.triangle([x, y, 5.0], [x + 0.5, y, 5.0], [x, y + 0.8, 5.0],
                   b.diffuse(alb[k * (n_alb - 1) // 59]),
                   emi[k * (n_emi - 1) // 59])
    scene, params = b.build(device=dev)
    _, _, cam = cbox.build(device=dev)
    return scene, params, cam, albedo_table(scene, params), \
        emission_table(scene, params)


def _past_32(live):
    assert int(live[..., 32:, :].sum()) > 0, "no path lives past bounce 32"


def _bright(alb):
    """The albedo table with every real row 0.8: a path keeps 0.8 / (1 -
    0.1) of its throughput a bounce, so its rows past 32 weigh 2e-2 of its
    first in the gradients (at albedo 0.5, 1e-8: below the tolerance)."""
    return torch.cat([torch.full_like(alb[:-1], 0.8), alb[-1:]])


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("depth", DEEP_DEPTHS)
def test_deep_fused_sweep_and_retrace_adjoint(dev, depth, per_pixel):
    """B3 past 32 bounces against the plain sweep on its rows, and B4 =
    sweep(collect) bit for bit, in tape mode and over 2 chunks of the
    internal RNG, on bright tables; B4 against the plain retrace on the
    scene's own (over 33-64 bright bounces the ulps of libm turn paths)."""
    cfg = _deep_cfg(depth)
    scene, params, cam, own_alb, emi = _setup(gallery.build_glossy, dev)
    alb = _bright(own_alb)
    n = 16 * 12 * 4
    cam_u, tape, g = _tape_inputs(dev, n, depth=depth, seed=depth)
    if per_pixel:
        g = g[:, :16 * 12].contiguous()
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 rng="tape")(alb, emi, cam_u,
                                                             tape)
    _past_32(rbest > 0)
    d3 = mk.make_fused_sweep_adjoint(scene, cfg)(alb, emi, rsc, rbest, g)
    _grads_close(d3, mk.fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest,
                                          g))
    adj = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")
    for a, b in zip(adj(alb, emi, cam_u, tape, g), d3):
        assert torch.equal(a, b)
    _grads_close(adj(own_alb, emi, cam_u, tape, g),
                 mk.make_fused_adjoint(scene, cam, cfg, rng="tape",
                                       plain=True)(own_alb, emi, cam_u, tape,
                                                   g), 1e-4)
    cfg2 = _deep_cfg(depth, spp_chunks=2)
    seeds = torch.tensor([depth, -7], dtype=torch.int32)
    g2 = g if per_pixel else g[:, :16 * 12 * 2].contiguous()  # a chunk's
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg2,
                                                 n_chunks=2)(alb, emi, seeds)
    for a, b in zip(mk.make_fused_adjoint(scene, cam, cfg2, n_chunks=2)(
            alb, emi, seeds, g2),
            mk.make_fused_sweep_adjoint(scene, cfg2, n_chunks=2)(
                alb, emi, rsc, rbest, g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth", DEEP_DEPTHS)
def test_deep_wavefront_adjoint_matches_plain(dev, depth):
    """B5b past 32 bounces on B4's own rays = B4 bit for bit (bright
    tables), and against its plain version on the scene's own."""
    cfg = _deep_cfg(depth)
    scene, params, cam, own_alb, emi = _setup(cbox.build, dev)
    alb = _bright(own_alb)
    cam_u, tape, g = _tape_inputs(dev, 16 * 12 * 4, depth=depth)
    o, d = _wavefront_rays(cam, cfg, cam_u, exact_division=True)
    adj = mk.make_pallas_adjoint(scene, cfg)
    for a, b in zip(adj(alb, emi, o, d, tape, g),
                    mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
                        alb, emi, cam_u, tape, g)):
        assert torch.equal(a, b)
    _grads_close(adj(own_alb, emi, o, d, tape, g),
                 mk.make_pallas_adjoint(scene, cfg, plain=True)(
                     own_alb, emi, o, d, tape, g))


@pytest.mark.parametrize("depth", DEEP_DEPTHS)
def test_deep_segment_adjoint_forms(dev, depth):
    """B4-seg over [2, D) (the queue's deep form) = its lockstep build
    (the lockstep loop's deep form) bit for bit, and [0, D) from the
    camera = B4, on bright tables; against the plain version on the
    scene's own."""
    cfg = _deep_cfg(depth)
    scene, params, cam, own_alb, emi = _setup(cbox.build, dev)
    cam_u, tape, g = _tape_inputs(dev, 16 * 12 * 4, depth=depth)
    u = tape[2:].contiguous()
    for alb in (_bright(own_alb), own_alb):
        _, (ray, alive) = mk.make_fused_segment_tracer(
            scene, cam, cfg, 0, 2, rng="tape")(alb, emi, cam_u,
                                                tape[:2].contiguous())
        got, lock, plain = (mk.make_fused_segment_adjoint(
            scene, cam, cfg, 2, depth, rng="tape", **kw)(alb, emi, u, ray,
                                                         alive, g)
            for kw in ({}, dict(build="lockstep"), dict(plain=True)))
        for a, b in zip(got, lock):
            assert torch.equal(a, b)
    _grads_close(got[:2], plain[:2])
    assert _share_beyond(got[2], plain[2], 2e-5, 2e-6) <= 1e-3
    alb = _bright(own_alb)
    for a, b in zip(mk.make_fused_segment_adjoint(
            scene, cam, cfg, 0, depth, rng="tape")(alb, emi, cam_u, tape, g),
            mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(
                alb, emi, cam_u, tape, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth,rows", [
    *((d, None) for d in DEEP_DEPTHS),
    *((d, r) for d in [5] + DEEP_DEPTHS
      for r in ((100, 45), (145, 1), (255, 255)))])
def test_deep_dyn_sweep_and_retrace_adjoint(dev, depth, rows):
    """B8 and B9 past 32 bounces and past 144 table rows (the mesh's own
    rows where `rows` is None) against the plain version; B9 =
    sweep(collect) bit for bit."""
    if rows is None:
        scene, params, cam, alb, emi = _setup(_mesh(1), dev)
    else:
        scene, params, cam, alb, emi = _wide_scene(dev, *rows)
        assert alb.shape[0] + emi.shape[0] - 2 > dk.MAX_GRAD_ROWS
    alb = _bright(alb)
    cfg = _deep_cfg(depth)
    cam_u, tape, g = _tape_inputs(dev, 16 * 12 * 4, depth=depth)
    _, rsc, rrow = dk.make_dyn_collect_tracer(scene, cam, cfg, rng="tape")(
        alb, emi, cam_u, tape)
    if depth > 32:
        _past_32((rrow >> 16) & 1)
    for g_k in (g, g[:, :16 * 12].contiguous()):
        d8 = dk.make_dyn_sweep_adjoint(scene, cfg)(alb, emi, rsc, rrow, g_k)
        _grads_close(d8, dk.dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g_k))
        for a, b in zip(dk.make_dyn_adjoint(scene, cam, cfg, rng="tape")(
                alb, emi, cam_u, tape, g_k), d8):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["fused", "dyn", "dyn wide"])
@pytest.mark.parametrize("depth", DEEP_DEPTHS)
def test_deep_regen_sweeps_match_plain(dev, depth, family):
    """B11 and B13 past 32 bounces (B13 also with 255 + 255 rows) against
    their plain versions; their checking builds take the same deep form."""
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import regen as rg

    cfg = _deep_cfg(depth, spp_chunks=2)
    seeds = torch.tensor([depth, 9], dtype=torch.int32)
    g = torch.rand((3, 16 * 12), device=dev)
    if family == "fused":
        scene, params, cam, alb, emi = _setup(cbox.build, dev)
        alb = _bright(alb)
        trace = rg.make_regen_tracer(scene, cam, cfg, collect=True,
                                     n_chunks=2)
        assert rg.regen_sweep_form(cfg, alb, emi) == "deep"
        _, rsc, rmeta, trips = trace(alb, emi, seeds)
        got = [rg.make_regen_sweep_adjoint(scene, cfg, n_chunks=2, **kw)(
            alb, emi, rsc, rmeta, trips, g)
            for kw in ({}, dict(build="lockstep"))]
        ref = rg.regen_sweep_plain(scene, cfg, alb, emi, rsc, rmeta, trips, g)
    else:
        scene, params, cam, alb, emi = (
            _setup(cbox.build, dev) if family == "dyn"
            else _wide_scene(dev, 255, 255))
        alb = _bright(alb)
        trace = dr.make_dyn_regen_tracer(scene, cam, cfg, collect=True,
                                         n_chunks=2)
        assert dr.dyn_regen_sweep_form(cfg, alb, emi) == "deep"
        _, rsc, rrow, trips = trace(alb, emi, seeds)
        got = [dr.make_dyn_regen_sweep_adjoint(scene, cfg, n_chunks=2, **kw)(
            alb, emi, rsc, rrow, trips, g)
            for kw in ({}, dict(build="lockstep"))]
        ref = dr.dyn_regen_sweep_plain(cfg, alb, emi, rsc, rrow, trips, g)
    for a, b in zip(*got):
        assert torch.equal(a, b)
    _grads_close(got[0], ref)


def _walk_items(dev):
    """Items a deep form's grid holds at once (deep_blocks x 128 in
    csrc/grad_accum.cuh); past them its blocks walk 128-item groups."""
    p = torch.cuda.get_device_properties(dev)
    return p.multi_processor_count * (
        p.max_threads_per_multi_processor // mk.BLOCK) * mk.BLOCK


@pytest.mark.parametrize("family", ["fused", "dyn", "regen", "dyn-regen"])
def test_deep_forms_walk_many_groups(dev, family):
    """The deep forms over 307,200 items in one launch, more than their
    grid holds (270,336 on an H100), so that each block walks more than
    one group, at depth 40 on bright tables (255 + 255 rows for the
    memory-resident family): B3, B8, B11 and B13 against their plain
    versions on their rows; B4 = B3, B4-seg [0, D) = B4 and [2, D) = its
    lockstep build, B9 = B8 and the checking builds of B11 and B13 = the
    fast ones, bit for bit."""
    from drt_tpu_torch.ops import dynregen as dr
    from drt_tpu_torch.ops import regen as rg

    depth = 40
    if family in ("fused", "regen"):
        scene, params, cam, alb, emi = _setup(cbox.build, dev)
    else:
        scene, params, cam, alb, emi = _wide_scene(dev, 255, 255)
    alb = _bright(alb)
    if family in ("regen", "dyn-regen"):
        cfg = _deep_cfg(depth)
        cfg = dataclasses.replace(cfg, width=640, height=480, spp=1)
        n = 640 * 480
        assert n > _walk_items(dev)
        seeds = torch.tensor([depth, 5], dtype=torch.int32)
        g = torch.rand((3, n), device=dev)
        if family == "regen":
            _, rsc, rmeta, trips = rg.make_regen_tracer(
                scene, cam, cfg, collect=True)(alb, emi, seeds)
            got = [rg.make_regen_sweep_adjoint(scene, cfg, **kw)(
                alb, emi, rsc, rmeta, trips, g)
                for kw in ({}, dict(build="lockstep"))]
            ref = rg.regen_sweep_plain(scene, cfg, alb, emi, rsc, rmeta,
                                       trips, g)
        else:
            _, rsc, rrow, trips = dr.make_dyn_regen_tracer(
                scene, cam, cfg, collect=True)(alb, emi, seeds)
            got = [dr.make_dyn_regen_sweep_adjoint(scene, cfg, **kw)(
                alb, emi, rsc, rrow, trips, g)
                for kw in ({}, dict(build="lockstep"))]
            ref = dr.dyn_regen_sweep_plain(cfg, alb, emi, rsc, rrow, trips,
                                           g)
        for a, b in zip(*got):
            assert torch.equal(a, b)
        _grads_close(got[0], ref, 1e-4)
        return
    cfg = dataclasses.replace(_deep_cfg(depth), width=320, height=240)
    n = 320 * 240 * 4
    assert n > _walk_items(dev)
    cam_u, tape, g = _tape_inputs(dev, n, depth=depth, seed=3)
    if family == "dyn":
        _, rsc, rrow = dk.make_dyn_collect_tracer(scene, cam, cfg,
                                                  rng="tape")(
                                                      alb, emi, cam_u, tape)
        _past_32((rrow >> 16) & 1)
        d8 = dk.make_dyn_sweep_adjoint(scene, cfg)(alb, emi, rsc, rrow, g)
        _grads_close(d8, dk.dyn_sweep_plain(cfg, alb, emi, rsc, rrow, g),
                     1e-4)
        for a, b in zip(dk.make_dyn_adjoint(scene, cam, cfg, rng="tape")(
                alb, emi, cam_u, tape, g), d8):
            assert torch.equal(a, b)
        return
    _, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, cfg,
                                                 rng="tape")(alb, emi, cam_u,
                                                             tape)
    _past_32(rbest > 0)
    d3 = mk.make_fused_sweep_adjoint(scene, cfg)(alb, emi, rsc, rbest, g)
    _grads_close(d3, mk.fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest,
                                          g), 1e-4)
    d4 = mk.make_fused_adjoint(scene, cam, cfg, rng="tape")(alb, emi, cam_u,
                                                            tape, g)
    for a, b in zip(d4, d3):
        assert torch.equal(a, b)
    for a, b in zip(mk.make_fused_segment_adjoint(
            scene, cam, cfg, 0, depth, rng="tape")(alb, emi, cam_u, tape, g),
            d4):
        assert torch.equal(a, b)
    _, (ray, alive) = mk.make_fused_segment_tracer(
        scene, cam, cfg, 0, 2, rng="tape")(alb, emi, cam_u,
                                            tape[:2].contiguous())
    u = tape[2:].contiguous()
    got, lock = (mk.make_fused_segment_adjoint(
        scene, cam, cfg, 2, depth, rng="tape", **kw)(alb, emi, u, ray, alive,
                                                     g)
        for kw in ({}, dict(build="lockstep")))
    for a, b in zip(got, lock):
        assert torch.equal(a, b)
