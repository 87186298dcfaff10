"""drt_tpu_torch.ops.megakernel on the CPU, where the fused tracer's
wrapper runs its plain twin: against drt_tpu's camera_rays + trace_rays
fed `drt_tpu.ops.regen.hash_tapes` (the internal RNG, sample for
sample), against the JAX tape Pallas kernel in interpret mode, and at
boundary uniforms. Float32 to rtol 2e-5 / atol 2e-6, the tolerance of
tests/test_fused.py. The kernel itself is tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.ops.regen import hash_tapes as jax_hash_tapes
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import make_fused_image_renderer
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

TOL = dict(rtol=2e-5, atol=2e-6)


def _both(builder):
    js, jp, jc = builder(dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


def _tables(scene, params):
    return albedo_table(scene, params), emission_table(scene, params)


def test_internal_rng_matches_jax_on_hash_tapes():
    """spp_chunks=2 in one call: per-ray radiance summed over chunks, and
    the image, equal JAX camera_rays + trace_rays fed hash_tapes with
    sample_base = c * spp_c, reduced spp-outer."""
    cfg = RenderConfig(width=16, height=12, spp=4, spp_chunks=2,
                       max_depth=4)
    (js, jp, jc), (scene, params, cam) = _both(jax_cbox.build)
    seeds = [123, -456]
    npix, spp_c = 16 * 12, 2
    # One chunk's trace config (the jit of trace_rays is shared with
    # tests/test_torch_renderer.py's cbox float32 case).
    jcfg = JaxConfig(width=16, height=12, spp=spp_c, max_depth=4)
    xy = jnp.tile(jax_pixel_grid(16, 12), (spp_c, 1))
    ref_L = 0.0
    ref_img = 0.0
    for c in range(2):
        cam_u, tape = jax_hash_tapes(jnp.asarray(seeds, jnp.int32), npix,
                                     spp_c, cfg.max_depth, jnp.float32,
                                     sample_base=c * spp_c)
        o, d, _ = jax_camera_rays(jc, 16, 12, xy, cam_u.T)
        L = np.stack([np.asarray(ch) for ch in
                      jax_trace_rays(jp, js, o, d, None, jcfg, tape=tape)])
        ref_L = ref_L + L
        ref_img = ref_img + L.reshape(3, spp_c, 12, 16).mean(1)
    ref_img = np.moveaxis(ref_img / 2, 0, -1)

    trace = mk.make_fused_tracer(scene, cam, cfg, rng="internal",
                                 n_chunks=2)
    L = trace(*_tables(scene, params), torch.tensor(seeds))
    assert L.shape == (3, npix * spp_c) and ref_L.mean() > 0
    np.testing.assert_allclose(L.numpy(), ref_L, **TOL)
    img = make_fused_image_renderer(scene, cam, cfg)(
        params, torch.tensor(seeds, dtype=torch.int32))
    np.testing.assert_allclose(img.numpy(), ref_img, **TOL)


def test_tape_matches_jax_pallas_kernel_interpret():
    """Against the TPU kernel itself (Pallas interpret mode), as
    tests/test_fused.py:38-52 holds it against trace_rays."""
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=3)
    (js, jp, jc), (scene, params, cam) = _both(jax_cbox.build)
    n = 8 * 6 * 4
    r = np.random.default_rng(0)
    cam_u = r.uniform(size=(2, n)).astype(np.float32)
    tape = r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32)
    tracer = jax_mk.make_fused_tracer(
        js, jc, JaxConfig(**dataclasses.asdict(cfg)), tile_rows=8,
        rng="tape", interpret=True)
    ref = np.stack([np.asarray(c) for c in tracer(
        jax_albedo_table(js, jp), jax_emission_table(js, jp),
        jnp.asarray(cam_u), jnp.asarray(tape))])
    got = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        *_tables(scene, params), torch.as_tensor(cam_u),
        torch.as_tensor(tape))
    assert ref.mean() > 0
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_boundary_uniforms_stay_finite():
    """Uniforms of exactly 0 and 1 zero a sampling pdf; the guarded
    estimator drops those samples instead of returning 0/0
    (tests/test_fused.py:117-152)."""
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=4)
    _, (scene, params, cam) = _both(jax_gallery.build_glossy)
    n = 8 * 6 * 4
    r = np.random.default_rng(0)
    u = r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32)
    u[:, 1, ::7] = 1.0
    u[:, 1, 3::11] = 0.0
    u[:, 2, 5::13] = 0.0
    cam_u = r.uniform(size=(2, n)).astype(np.float32)
    cam_u[:, ::5] = 0.0
    cam_u[:, 2::5] = 1.0
    L = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        *_tables(scene, params), torch.as_tensor(cam_u), torch.as_tensor(u))
    assert torch.isfinite(L).all() and L.mean() > 0


@pytest.mark.parametrize("builder", [jax_gallery.build_glossy,
                                     jax_gallery.build_tri])
def test_scene_table_and_camera_fold_as_static_scene(builder):
    """The kernel's run-time tables hold what the TPU kernel bakes in as
    literals (StaticScene, StaticCamera)."""
    (js, _, jc), (scene, _, cam) = _both(builder)
    ss = jax_mk.StaticScene(js)
    tab = mk.scene_table(scene).numpy()
    f32 = np.float32
    np.testing.assert_array_equal(tab[:, mk.R_TYPE], ss.shape_type)
    np.testing.assert_array_equal(tab[:, mk.R_MAT], ss.mat_type)
    np.testing.assert_array_equal(tab[:, mk.R_ALB], ss.albedo_row)
    np.testing.assert_array_equal(tab[:, mk.R_EMI], ss.emit_row)
    np.testing.assert_array_equal(tab[:, mk.R_EXPO], f32(ss.exponent))
    np.testing.assert_array_equal(tab[:, mk.R_GEO:mk.R_GEO + 12],
                                  ss.geo.astype(f32))
    for s, st in enumerate(ss.shape_type):
        g = ss.geo[s]
        if st == 2:
            e1, e2 = g[3:6] - g[0:3], g[6:9] - g[0:3]
            nrm = np.cross(e1, e2)
            np.testing.assert_array_equal(tab[s, mk.R_E1:mk.R_E1 + 3],
                                          e1.astype(f32))
            np.testing.assert_array_equal(
                tab[s, mk.R_TRI_N:mk.R_TRI_N + 3],
                (nrm / np.linalg.norm(nrm)).astype(f32))
        if st == 1:
            assert tab[s, mk.R_R2] == f32(g[3] * g[3])
    sc = jax_mk.StaticCamera(jc, 16, 12)
    cc = mk.camera_consts(cam, 16, 12)
    assert cc.aspect_half == f32(sc.aspect * sc.half)
    assert cc.half == f32(sc.half)
    for got, ref in zip((cc.eye, cc.forward, cc.right, cc.up),
                        (sc.eye, sc.forward, sc.right, sc.up)):
        np.testing.assert_array_equal(got, ref.astype(f32))


def test_wrapper_runs_twin_only_on_cpu():
    """CPU tensors take the plain twin without counting a launch; other
    devices are refused, with no fallback."""
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=2)
    _, (scene, params, cam) = _both(jax_cbox.build)
    alb, emi = _tables(scene, params)
    table = mk.scene_table(scene)
    cc = mk.camera_consts(cam, 4, 4)
    before = mk.fused_trace.launches
    L = mk.fused_trace(scene, table, cc, cfg, alb, emi, seeds=[1, 2])
    assert L.shape == (3, 16) and mk.fused_trace.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        mk.fused_trace(scene, table, cc, cfg, alb.to("meta"),
                       emi.to("meta"), seeds=[1, 2])
