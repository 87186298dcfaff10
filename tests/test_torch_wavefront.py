"""The key-driven wavefront of drt_tpu_torch on the CPU: `default_camera`,
`chunk_pixel_ids`, `chunk_rays`, key-mode `trace_rays` and `render_image`
against the JAX package's camera_rays + trace_rays(tape=...) fed the
port's keyed draws (threefry is not reproduced), float64 to rtol 1e-10;
the plain twins of the wavefront tracer and adjoint kernels against the
JAX package's Pallas kernels in interpret mode (float32, the tolerances of
tests/test_megakernel.py); `make_diff_image_renderer` and key-mode
`make_diff_renderer` against autograd; boundary tapes, rays that miss
everything, and the routing of the "cuda-wavefront" / "torch-wavefront"
backends. The kernels themselves are tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.adjoint import _param_grads as jax_param_grads
from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import default_camera as jax_default_camera
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.ops import regen as jax_regen
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import chunk_pixel_ids as jax_chunk_pixel_ids
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.adjoint import make_diff_image_renderer, make_diff_renderer
from drt_tpu_torch.camera import default_camera
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import _salted
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import bounce_tape, camera_draws
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.parallel.render import make_renderer
from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                    chunk_sample_ids, render_image,
                                    trace_rays)
from drt_tpu_torch.scene import (Params, albedo_table, emission_table,
                                 from_numpy)

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)  # tests/test_megakernel.py:51
GRAD_F32 = dict(rtol=1e-4, atol=1e-5)  # tests/test_megakernel.py:74-77
CFG = RenderConfig(width=16, height=12, spp=4, spp_chunks=2, max_depth=4)
SEEDS = torch.tensor([123, -456], dtype=torch.int32)


def _both(builder, dtype=jnp.float64):
    js, jp, jc = builder(dtype=dtype)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


def _leaves(params):
    return Params(*(p.detach().clone().requires_grad_() for p in params))


def _chunk_draws(cfg, seeds, c, dtype=torch.float64):
    """The port's draws of chunk c: cam_u f[N, 2], tape f[D, 3, N]."""
    pix, s = chunk_sample_ids(cfg, chunk_pixel_ids(cfg), c)
    return (camera_draws(int(seeds[0]), pix, s, dtype).T,
            bounce_tape(int(seeds[1]), pix, s, cfg.max_depth, dtype))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX composition on the port's draws, once per module: per
    chunk camera_rays + trace_rays(tape=...), and the image."""
    (js, jp, jc), port = _both(jax_cbox.build)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    xy = jax_chunk_pixel_ids(jcfg)
    spp_c = CFG.spp // CFG.spp_chunks
    chunks, images = [], []
    for c in range(CFG.spp_chunks):
        cam_u, tape = _chunk_draws(CFG, SEEDS, c)
        o, d, pdf = jax_camera_rays(jc, CFG.width, CFG.height, xy,
                                    jnp.asarray(cam_u.numpy()))
        L = jax_trace_rays(jp, js, o, d, None, jcfg,
                           tape=jnp.asarray(tape.numpy()))
        chunks.append(([np.asarray(v) for v in o], [np.asarray(v) for v in d],
                       np.stack([np.asarray(v) for v in L])))
        images.append(np.stack([
            (np.asarray(v) / np.asarray(pdf)).reshape(
                CFG.height, CFG.width, spp_c).mean(axis=2) for v in L], -1))
    return port, chunks, np.stack(images).mean(axis=0)


def test_default_camera_matches_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        got = default_camera(dtype=dtype, vfov=1.1, device="cpu")
        ref = jax_default_camera(dtype=jdtype, vfov=1.1)
        for g, r in zip(got, ref):
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_chunk_pixel_ids_match_jax():
    got = chunk_pixel_ids(CFG)
    ref = np.asarray(jax_chunk_pixel_ids(JaxConfig(
        **dataclasses.asdict(CFG))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    pix, s = chunk_sample_ids(CFG, got, 1)
    np.testing.assert_array_equal(pix.numpy(), np.repeat(np.arange(192), 2))
    np.testing.assert_array_equal(s.numpy(), np.tile([2, 3], 192))


def test_chunk_rays_match_jax_camera_rays(jax_ref):
    (_, _, cam), chunks, _ = jax_ref
    xy = chunk_pixel_ids(CFG)
    for c, (jo, jd, _) in enumerate(chunks):
        o, d, pdf = chunk_rays(cam, CFG, xy, SEEDS, c)
        assert d.x.dtype == torch.float64 and (pdf == 1).all()
        np.testing.assert_allclose(torch.stack(tuple(o)).numpy(),
                                   np.stack(jo), **F64)
        np.testing.assert_allclose(torch.stack(tuple(d)).numpy(),
                                   np.stack(jd), **F64)


def test_key_draws_are_the_keyed_hash():
    """Ray r of chunk c draws (seeds[0], p, s, 0, dim) for the camera and
    (seeds[1], p, s, b, dim) per bounce, bit for bit the JAX package's
    hash; trace_rays without ids draws as pixel i at sample 0."""
    cam_u, tape = _chunk_draws(CFG, SEEDS, 1, torch.float32)
    pix, s = chunk_sample_ids(CFG, chunk_pixel_ids(CFG), 1)
    jpix, js_ = jnp.asarray(pix.numpy()), jnp.asarray(s.numpy())
    for dim in (0, 1):
        np.testing.assert_array_equal(cam_u[:, dim].numpy(), np.asarray(
            jax_regen.hash_uniform(123, jpix, js_, 0, dim, jnp.float32)))
    for b in (0, 3):
        for dim in (0, 1, 2):
            np.testing.assert_array_equal(tape[b, dim].numpy(), np.asarray(
                jax_regen.hash_uniform(-456, jpix, js_, b, dim,
                                       jnp.float32)))
    scene, params, _ = cbox.build(device="cpu")
    r = np.random.default_rng(1)
    o = V3(*(torch.zeros(50) for _ in range(3)))
    dn = r.normal(size=(3, 50))
    d = V3(*torch.as_tensor(dn / np.linalg.norm(dn, axis=0),
                            dtype=torch.float32))
    got = trace_rays(params, scene, o, d, CFG, seeds=SEEDS)
    i = torch.arange(50)
    ref = trace_rays(params, scene, o, d, CFG, tape=bounce_tape(
        -456, i, torch.zeros_like(i), CFG.max_depth))
    for g, rf in zip(got, ref):
        assert torch.equal(g, rf)
    with pytest.raises(TypeError, match="a tape or seeds"):
        trace_rays(params, scene, o, d, CFG)


def test_key_mode_trace_rays_and_render_image_match_jax(jax_ref):
    (scene, params, cam), chunks, ref_img = jax_ref
    xy = chunk_pixel_ids(CFG)
    for c, (_, _, ref_L) in enumerate(chunks):
        pix, s = chunk_sample_ids(CFG, xy, c)
        o, d, _ = chunk_rays(cam, CFG, xy, SEEDS, c)
        L = trace_rays(params, scene, o, d, CFG, seeds=SEEDS, pix=pix,
                       sample=s)
        assert ref_L.mean() > 0
        np.testing.assert_allclose(torch.stack(tuple(L)).numpy(), ref_L,
                                   **F64)
    img = render_image(params, scene, cam, SEEDS, CFG)
    assert img.shape == (12, 16, 3) and img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), ref_img, **F64)
    # The same image through the backends (the tracer kernel's twin).
    for backend in ("torch-wavefront",):
        for diff in (False, True):
            got = make_renderer(scene, CFG, cam, differentiable=diff,
                                backend=backend)(params, SEEDS)
            np.testing.assert_allclose(got.numpy(), ref_img, **F64)


def _pallas_rays(n, seed=0):
    """tests/test_megakernel.py's rays and tape: cbox, 8x8 pixels tiled
    to n rays, depth 4, float32 (numpy draws)."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=4)
    (js, jp, jc), (scene, params, cam) = _both(jax_cbox.build, jnp.float32)
    r = np.random.default_rng(seed)
    xy = np.tile(np.stack(np.meshgrid(np.arange(8), np.arange(8)),
                          -1).reshape(-1, 2), (-(-n // 64), 1))[:n]
    o, d, _ = jax_camera_rays(jc, 8, 8, jnp.asarray(xy, jnp.int32),
                              jnp.asarray(r.uniform(size=(n, 2)),
                                          jnp.float32))
    tape = r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32)
    g = r.uniform(size=(3, n)).astype(np.float32)
    return (cfg, (js, jp), (scene, params), np.stack([np.asarray(v)
                                                      for v in o]),
            np.stack([np.asarray(v) for v in d]), tape, g)


def test_tracer_twin_matches_pallas_kernel():
    cfg, (js, jp), (scene, params), o, d, tape, _ = _pallas_rays(300)
    tracer = jax_mk.make_pallas_tracer(js, JaxConfig(**dataclasses.asdict(
        cfg)), tile_rows=8, interpret=True)
    ref = np.stack([np.asarray(v) for v in tracer(
        jax_albedo_table(js, jp), jax_emission_table(js, jp),
        JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
        jnp.asarray(tape))])
    got = mk.make_pallas_tracer(scene, cfg)(
        albedo_table(scene, params), emission_table(scene, params),
        V3(*map(torch.as_tensor, o)), torch.as_tensor(d),
        torch.as_tensor(tape))
    assert got.shape == (3, 300) and ref.mean() > 0
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_adjoint_twin_matches_pallas_kernel():
    cfg, (js, jp), (scene, params), o, d, tape, g = _pallas_rays(777)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    adj = jax_mk.make_pallas_adjoint(js, jcfg, tile_rows=8, interpret=True)
    args = (JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
            jnp.asarray(tape))
    da_r, de_r = adj(jax_albedo_table(js, jp), jax_emission_table(js, jp),
                     *args, JV3(*map(jnp.asarray, g)))
    da, de = mk.make_pallas_adjoint(scene, cfg)(
        albedo_table(scene, params), emission_table(scene, params),
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tape),
        torch.as_tensor(g))
    assert da.shape == (4, 3) and de.shape == (2, 3)
    assert (da[-1] == 0).all() and (de[-1] == 0).all()
    np.testing.assert_allclose(da.numpy(), np.asarray(da_r), **GRAD_F32)
    np.testing.assert_allclose(de.numpy(), np.asarray(de_r), **GRAD_F32)
    # and the XLA path's _param_grads, which the Pallas kernel equals.
    _, res = jax_trace_rays(jp, js, *args[:2], None, jcfg, tape=args[2],
                            collect=True)
    gp = jax_param_grads(jp, js, res, JV3(*map(jnp.asarray, g)),
                         jnp.float32)
    np.testing.assert_allclose(da[:3].numpy(), np.asarray(gp.albedo),
                               **GRAD_F32)


def _image_grads(render, params, w):
    p = _leaves(params)
    (render(p) * w).sum().backward()
    return p.albedo.grad, p.emission.grad


@pytest.mark.parametrize("builder", [partial(cbox.build, device="cpu"),
                                     partial(gallery.build_glossy,
                                             device="cpu")])
def test_diff_image_renderer_matches_autograd(builder):
    """Biased: the chunk loop inside one autograd.Function (nothing per
    ray saved, the adjoint twin per chunk) equals autograd through the
    plain render_image at the same seeds, float64."""
    scene, params, cam = builder(dtype=torch.float64)
    w = torch.rand((12, 16, 3), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    diff = make_diff_image_renderer(scene, cam, CFG)
    got = _image_grads(lambda p: diff(p, SEEDS), params, w)
    ref = _image_grads(lambda p: render_image(p, scene, cam, SEEDS, CFG),
                       params, w)
    for g, r in zip(got, ref):
        assert r.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F64)
    img = diff(_leaves(params), SEEDS)
    assert img.grad_fn is not None
    np.testing.assert_array_equal(img.detach().numpy(), render_image(
        params, scene, cam, SEEDS, CFG).numpy())


def test_unbiased_retraces_on_salted_seeds():
    """Unbiased with 2 adjoint samples: the mean of the plain retraces on
    `fused._salted(seeds, s)`, which keep the camera stream, so each is
    autograd through render_image at the salted seeds."""
    scene, params, cam = cbox.build(dtype=torch.float64, device="cpu")
    cfg = dataclasses.replace(CFG, unbiased=True, adjoint_samples=2)
    w = torch.rand((12, 16, 3), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    got = _image_grads(lambda p: make_diff_image_renderer(scene, cam, cfg)(
        p, SEEDS), params, w)
    refs = [_image_grads(lambda p: render_image(
        p, scene, cam, torch.tensor(_salted(SEEDS, s), dtype=torch.int64),
        CFG), params, w) for s in range(2)]
    assert _salted(SEEDS, 0)[0] == 123 & 0xFFFFFFFF
    for k in range(2):
        ref = (refs[0][k] + refs[1][k]) / 2
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), **F64)
    biased = _image_grads(lambda p: make_diff_image_renderer(
        scene, cam, CFG)(p, SEEDS), params, w)
    assert not np.allclose(got[0].numpy(), biased[0].numpy())


def test_key_mode_diff_renderer():
    """make_diff_renderer(use_tape=False): the tape form fed the keyed
    tape of ray i at sample 0 (biased), and the mean over salted tapes
    (unbiased); both against autograd through trace_rays."""
    scene, params, cam = cbox.build(dtype=torch.float64, device="cpu")
    xy = chunk_pixel_ids(CFG)
    o, d, _ = chunk_rays(cam, CFG, xy, SEEDS, 0)
    n = d.x.shape[0]
    i = torch.arange(n)
    w = V3(*torch.rand((3, n), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2)))

    def grads(f, *args):
        p = _leaves(params)
        L = f(p, o, d, *args)
        (L.x * w.x + L.y * w.y + L.z * w.z).sum().backward()
        return p.albedo.grad, p.emission.grad

    def tape_of(sd):
        return bounce_tape(int(sd[1]), i, torch.zeros_like(i), 4,
                           torch.float64)

    got = grads(make_diff_renderer(scene, CFG), SEEDS)
    tape = grads(make_diff_renderer(scene, CFG, use_tape=True),
                 tape_of(SEEDS))
    ref = grads(lambda p, o, d, s: trace_rays(p, scene, o, d, CFG, seeds=s),
                SEEDS)
    for g, t, r in zip(got, tape, ref):
        assert torch.equal(g, t)
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F64)
    cfg_u = dataclasses.replace(CFG, unbiased=True, adjoint_samples=2)
    unb = grads(make_diff_renderer(scene, cfg_u), SEEDS)
    per = [grads(make_diff_renderer(scene, CFG, use_tape=True),
                 tape_of(_salted(SEEDS, s))) for s in range(2)]
    for k in range(2):
        np.testing.assert_allclose(unb[k].numpy(),
                                   ((per[0][k] + per[1][k]) / 2).numpy(),
                                   **F64)
    with pytest.raises(TypeError, match="key mode"):
        make_diff_renderer(scene, CFG)(params, o, d, SEEDS, SEEDS)


def test_boundary_tapes_stay_finite():
    """Tape entries of exactly 0 and 1 zero a sampling pdf; the guarded
    estimator drops those samples (tests/test_fused.py:117-152)."""
    scene, params, cam = gallery.build_glossy(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=4)
    xy = chunk_pixel_ids(cfg)
    o, d, _ = chunk_rays(cam, cfg, xy, SEEDS, 0)
    n = xy.shape[0]
    r = np.random.default_rng(0)
    u = r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32)
    u[:, 1, ::7] = 1.0
    u[:, 1, 3::11] = 0.0
    u[:, 2, 5::13] = 0.0
    u[:, 0, 2::9] = 0.0
    u = torch.as_tensor(u)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, o, d, u)
    da, de = mk.make_pallas_adjoint(scene, cfg)(alb, emi, o, d, u,
                                                torch.ones(3, n))
    assert torch.isfinite(L).all() and L.mean() > 0
    assert torch.isfinite(da).all() and torch.isfinite(de).all()


def test_rays_that_miss_everything():
    """Rays from outside the box pointing away from every shape: the dead
    lanes' hit data is zeroed before use, so radiance and gradients are
    exactly zero and finite."""
    scene, params, _ = cbox.build(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=4)
    n = 40
    r = np.random.default_rng(3)
    dn = np.abs(r.normal(size=(3, n))) * np.array([[1.0], [1.0], [-1.0]])
    o = torch.tensor([[100.0], [100.0], [-100.0]]).repeat(1, n)
    d = torch.as_tensor(dn / np.linalg.norm(dn, axis=0), dtype=torch.float32)
    u = torch.rand((cfg.max_depth, 3, n),
                   generator=torch.Generator().manual_seed(4))
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    L = mk.make_pallas_tracer(scene, cfg)(alb, emi, o, d, u)
    da, de = mk.make_pallas_adjoint(scene, cfg)(alb, emi, o, d, u,
                                                torch.ones(3, n))
    assert torch.equal(L, torch.zeros_like(L))
    assert torch.equal(da, torch.zeros_like(da))
    assert torch.equal(de, torch.zeros_like(de))


def test_routing_of_the_wavefront_backends():
    """"cuda-wavefront" needs the scene on a card; the JAX package's "xla"
    is named by its two ports; "torch-wavefront" renders with no history
    when not differentiable and counts no launch."""
    scene, params, cam = cbox.build(device="cpu")
    with pytest.raises(ValueError, match="'cuda-wavefront' needs the scene "
                       "on a CUDA device"):
        make_renderer(scene, CFG, cam, backend="cuda-wavefront")
    with pytest.raises(ValueError, match="'xla' is 'cuda-wavefront' or "
                       "'torch-wavefront'"):
        make_renderer(scene, CFG, cam, backend="xla")
    before = mk.launch_counts()
    img = make_renderer(scene, CFG, cam, differentiable=False,
                        backend="torch-wavefront")(_leaves(params), SEEDS)
    assert img.grad_fn is None and torch.isfinite(img).all()
    assert mk.launch_counts() == before
    # Splitting: the plain wavefront on M lanes a ray gives the image of
    # the plain split renderer at the same seeds, with no launch.
    cfg2 = dataclasses.replace(CFG, bsdf_samples=2, max_depth=3)
    img2 = make_renderer(scene, cfg2, cam, differentiable=False,
                         backend="torch-wavefront")(_leaves(params), SEEDS)
    ref2 = make_renderer(scene, cfg2, cam, differentiable=False,
                         backend="torch-split")(params, SEEDS)
    assert img2.grad_fn is None and mk.launch_counts() == before
    np.testing.assert_allclose(img2.numpy(), ref2.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_wrappers_run_twins_only_on_cpu():
    """CPU tensors take the plain twins without counting a launch; other
    devices are refused, with no fallback."""
    scene, params, _ = cbox.build(device="cpu")
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=2)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    table = mk.scene_table(scene)
    o = torch.zeros(3, 16)
    d = torch.tensor([[0.0], [0.0], [1.0]]).repeat(1, 16)
    u = torch.full((2, 3, 16), 0.5)
    before = (mk.ray_trace.launches, mk.ray_adjoint.launches)
    L = mk.ray_trace(scene, table, cfg, alb, emi, o, d, u)
    da, _ = mk.ray_adjoint(scene, table, cfg, alb, emi, o, d, u,
                           torch.ones(3, 16))
    assert L.shape == (3, 16) and L.mean() >= 0 and da.shape == (4, 3)
    assert (mk.ray_trace.launches, mk.ray_adjoint.launches) == before
    meta = [t.to("meta") for t in (alb, emi, o, d, u)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        mk.ray_trace(scene, table, cfg, *meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mk.ray_adjoint(scene, table, cfg, *meta, torch.ones(3, 16,
                                                            device="meta"))
