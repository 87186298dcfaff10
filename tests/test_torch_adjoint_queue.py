"""The `build=` switch of the retrace adjoint (`ops.megakernel.fused_adjoint`,
B4) and the wavefront adjoint (`ray_adjoint`, B5b) on the CPU, where both
wrappers run their plain twins: each build gives the twin's tables, and an
unknown build is refused before anything is dispatched. Both kernels, the
queue and its lockstep checking build, are held against each other on the
card by tests/test_torch_cuda.py and chip_smoke.py (phase 16); the twins
against the JAX package by tests/test_torch_fused_vjp.py and
tests/test_torch_wavefront.py. Small shapes: a few seconds in all."""

import numpy as np
import pytest
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.scene import albedo_table, emission_table

CFG = RenderConfig(width=16, height=12, spp=2, max_depth=4)
N = 16 * 12 * 2


def _inputs(make, seed=0):
    scene, params, cam = make(device="cpu")
    r = np.random.default_rng(seed)
    u = {k: torch.as_tensor(r.uniform(size=s).astype(np.float32))
         for k, s in (("cam_u", (2, N)), ("tape", (CFG.max_depth, 3, N)),
                      ("g", (3, N)))}
    return (scene, cam, albedo_table(scene, params),
            emission_table(scene, params), u)


@pytest.mark.parametrize("build", mk.BUILDS)
@pytest.mark.parametrize("make", [cbox.build, gallery.build_glossy,
                                  gallery.build_rows])
def test_retrace_adjoint_builds_run_the_twin_on_cpu(make, build):
    scene, cam, alb, emi, u = _inputs(make)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, CFG.width, CFG.height)
    before = mk.fused_adjoint.launches
    got = mk.fused_adjoint(scene, table, cc, CFG, alb, emi, u["g"],
                           cam_u=u["cam_u"], tape=u["tape"], build=build)
    ref = mk.fused_adjoint_plain(scene, cc, CFG, alb, emi, u["g"],
                                 cam_u=u["cam_u"], tape=u["tape"])
    assert mk.fused_adjoint.launches == before  # the twin is no launch
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    assert got[1].abs().max() > 0 and (got[0][-1] == 0).all()


@pytest.mark.parametrize("build", mk.BUILDS)
def test_retrace_adjoint_builds_internal_rng_on_cpu(build):
    scene, cam, alb, emi, _ = _inputs(cbox.build)
    cfg = RenderConfig(width=8, height=6, spp=4, spp_chunks=2, max_depth=3)
    g = torch.rand((3, 8 * 6), generator=torch.Generator().manual_seed(1))
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 8, 6)
    kw = dict(seeds=[5, -6], n_chunks=2)
    got = mk.fused_adjoint(scene, table, cc, cfg, alb, emi, g, build=build,
                           **kw)
    ref = mk.fused_adjoint_plain(scene, cc, cfg, alb, emi, g, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("build", mk.BUILDS)
@pytest.mark.parametrize("make", [cbox.build, gallery.build_rows])
def test_wavefront_adjoint_builds_run_the_twin_on_cpu(make, build):
    scene, cam, alb, emi, u = _inputs(make, seed=2)
    cc = mk.camera_consts(cam, CFG.width, CFG.height)
    pix = torch.arange(N) % (CFG.width * CFG.height)
    o, d = mk.camera_ray_from_pix(cc, pix, u["cam_u"][0], u["cam_u"][1])
    o, d = torch.stack(tuple(o)), torch.stack(tuple(d))
    before = mk.ray_adjoint.launches
    got = mk.ray_adjoint(scene, mk.scene_table(scene), CFG, alb, emi, o, d,
                         u["tape"], u["g"], build=build)
    ref = mk.ray_adjoint_plain(scene, CFG, alb, emi, o, d, u["tape"],
                               u["g"])
    assert mk.ray_adjoint.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wrapper", ["fused_adjoint", "ray_adjoint"])
def test_unknown_build_is_refused_before_dispatch(wrapper):
    """Even on a device no wrapper takes, the build name is checked
    first."""
    scene, cam, alb, emi, u = _inputs(cbox.build)
    table = mk.scene_table(scene)
    meta = [t.to("meta") for t in (alb, emi, u["g"], u["tape"])]
    with pytest.raises(ValueError, match="build 'nonesuch'"):
        if wrapper == "fused_adjoint":
            mk.fused_adjoint(scene, table, mk.camera_consts(cam, 16, 12), CFG,
                             *meta[:3], tape=meta[3], build="nonesuch")
        else:
            mk.ray_adjoint(scene, table, CFG, *meta[:2], meta[2], meta[2],
                           meta[3], meta[2], build="nonesuch")
    with pytest.raises(ValueError, match="cpu or cuda"):  # the build is fine
        mk.ray_adjoint(scene, table, CFG, *meta[:2], meta[2], meta[2],
                       meta[3], meta[2], build="lockstep")


def test_timing_build_and_scratch_are_of_the_card():
    scene, cam, alb, emi, u = _inputs(cbox.build)
    with pytest.raises(ValueError, match="checking build"):
        mk.fused_adjoint_stats(scene, mk.scene_table(scene),
                               mk.camera_consts(cam, 16, 12), CFG, alb, emi,
                               u["g"], [1, 2])
    # The queue's scratch: a row of E = 3 x 61 entries, padded to 184, per
    # ray slot.
    scene, _, alb, emi, _ = _inputs(gallery.build_rows)
    tcfg = mk._trace_config(CFG, mk.scene_table(scene), alb, emi)
    assert tuple(mk._slot_columns(tcfg, "cpu").shape) == (N, 184)
