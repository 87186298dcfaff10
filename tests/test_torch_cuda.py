"""The fused tracer's CUDA kernel against its plain PyTorch twin on the
card. Every test needs an NVIDIA GPU, nvcc and sm_90a: marked `cuda`,
they skip without a card. Run them there with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`
(tests/conftest.py imports jax).

Tolerances: the exact variant (built without FMA contraction) to rtol
2e-5 / atol 2e-6 per ray, the fast variant against the exact one to
rtol 2e-3 / atol 1e-4; at most 0.1% of rays beyond, for the paths whose
hit or flip choice an ulp of libm difference turns."""

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
