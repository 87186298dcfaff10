"""The fused CUDA kernels (tracer, collect tracer, sweep adjoint, retrace
adjoint) against their plain PyTorch twins on the card. Every test needs
an NVIDIA GPU, nvcc and sm_90a: marked `cuda`, they skip without a card.
Run them there with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`
(tests/conftest.py imports jax).

Tolerances: the exact variant (built without FMA contraction) to rtol
2e-5 / atol 2e-6 per ray, the fast variant against the exact one to
rtol 2e-3 / atol 1e-4; at most 0.1% of rays beyond, for the paths whose
hit or flip choice an ulp of libm difference turns. Gradient tables to
2e-5 of the table's largest entry (summation order)."""

import pytest
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
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
    assert {k: after[k] - before[k] for k in after} == dict(
        fused_tracer=1, fused_collect=1, fused_sweep=2, fused_adjoint=1)
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
    deep = RenderConfig(width=8, height=8, spp=2, max_depth=mk.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="exceeds the 32 bounces"):
        mk.make_fused_adjoint(scene, cam, deep)(
            alb, emi, [1, 2], torch.rand((3, 64), device=dev))
    # Per-pixel and per-ray cotangents agree bit for bit.
    g_pix = g[:, :64].contiguous()
    for a, b in zip(sweep(alb, emi, rsc, rbest, g_pix),
                    sweep(alb, emi, rsc, rbest, g_pix.repeat(1, 2))):
        assert torch.equal(a, b)
