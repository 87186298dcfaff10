"""drt_tpu_torch.adjoint (and renderer.trace_rays(collect=True)) against
drt_tpu's on the same rays and uniform tapes, in float64 to rtol 1e-10,
and against torch.autograd through the port's own trace_rays: the
independent check tests/test_adjoint.py makes with jax.grad."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu.adjoint import make_diff_renderer as jax_make_diff_renderer
from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu_torch.adjoint import (_param_grads, make_diff_image_renderer,
                                   make_diff_renderer)
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.renderer import trace_rays
from drt_tpu_torch.scene import Params, from_numpy

SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
            "tri": jax_gallery.build_tri}
TOL = dict(rtol=1e-10, atol=1e-12)
CFG = RenderConfig(width=16, height=12, spp=2, max_depth=4)
N = CFG.width * CFG.height * CFG.spp


def _jcfg(cfg=CFG, **kw):
    return JaxConfig(**{**dataclasses.asdict(cfg), **kw})


def _setup(model, seed=11):
    """Both packages' scene, and numpy rays, tapes and a cotangent."""
    js, jp, jc = SCENES[model](dtype=jnp.float64)
    scene, params, _ = from_numpy(*([np.asarray(a) for a in t]
                                    for t in (js, jp, jc)), device="cpu")
    r = np.random.default_rng(seed)
    cam_u = r.uniform(size=(N, 2))
    tape = r.uniform(size=(CFG.max_depth, 3, N))
    tape2 = r.uniform(size=(CFG.max_depth, 3, N))
    w = r.uniform(0.5, 1.5, size=(3, N))
    xy = jnp.tile(jax_pixel_grid(CFG.width, CFG.height), (CFG.spp, 1))
    jo, jd, _ = jax_camera_rays(jc, CFG.width, CFG.height, xy,
                                jnp.asarray(cam_u))
    o = [np.array(c) for c in jo]
    d = [np.array(c) for c in jd]
    return (js, jp), (scene, params), o, d, tape, tape2, w


def _matters(sc, gate):
    """Bounce-slots [D, N] with no earlier live bounce of weight sc == 0.
    A zero weight cuts the path: the throughput after it and the suffix
    radiance before it are 0 whatever the later slots hold, and what they
    hold is decided by an ulp (a ray that hit the light goes on with a
    zero direction from a point on the sphere, where the sign of
    |p - c|^2 - r^2 says hit or miss)."""
    zero = (sc == 0) & (gate > 0)
    return (np.cumsum(zero, axis=0) - zero) == 0


def _jv3(a):
    return JV3(*map(jnp.asarray, a))


def _tv3(a):
    return V3(*map(torch.as_tensor, a))


def _leaves(params):
    return Params(*(p.clone().requires_grad_() for p in params))


def _port_grads(f, params, w, *args):
    p = _leaves(params)
    L = f(p, *args)
    sum(c @ torch.as_tensor(wc) for c, wc in zip(L, w)).backward()
    return p.albedo.grad.numpy(), p.emission.grad.numpy()


def _jax_grads(f, jp, w, *args):
    def loss(p):
        L = f(p, *args)
        return sum(jnp.dot(c, jnp.asarray(wc)) for c, wc in zip(L, w))
    g = jax.grad(loss)(jp)
    return np.asarray(g.albedo), np.asarray(g.emission)


def test_collect_residuals_match():
    (js, jp), (scene, params), o, d, tape, _, _ = _setup("cbox")
    ref_L, ref = jax_trace_rays(jp, js, _jv3(o), _jv3(d), None, _jcfg(),
                                tape=jnp.asarray(tape), collect=True)
    L, res = trace_rays(params, scene, _tv3(o), _tv3(d), CFG,
                        tape=torch.as_tensor(tape), collect=True)
    for got, want in zip(L, ref_L):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(res.P, ref.P):
        assert got.shape == (CFG.max_depth, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(res.sc.numpy(), np.asarray(ref.sc), **TOL)
    m = _matters(np.asarray(ref.sc), np.asarray(ref.gate))
    assert m.mean() > 0.9
    for got, want in ((res.gate, ref.gate), (res.aid, ref.aid),
                      (res.eid, ref.eid)):
        np.testing.assert_array_equal(got.numpy()[m], np.asarray(want)[m])
    assert (res.gate.numpy() > 0).any() and (res.gate.numpy() == 0).any()


def _autograd_grads(scene, params, w, o, d, tape):
    """Reverse mode through the port's own tracer."""
    return _port_grads(
        lambda p, *a: trace_rays(p, scene, *a[:2], CFG, tape=a[2]), params,
        w, _tv3(o), _tv3(d), torch.as_tensor(tape))


def test_tape_diff_renderer_matches_jax():
    """Radiative-backprop grads = the JAX package's custom VJP (f64,
    rtol 1e-10)."""
    (js, jp), (scene, params), o, d, tape, _, w = _setup("cbox")
    f = make_diff_renderer(scene, CFG, use_tape=True)
    got = _port_grads(f, params, w, _tv3(o), _tv3(d), torch.as_tensor(tape))
    jf = jax_make_diff_renderer(js, _jcfg(), use_tape=True)
    ref = _jax_grads(jf, jp, w, _jv3(o), _jv3(d), jnp.asarray(tape))
    assert np.abs(ref[0]).max() > 0 and np.abs(ref[1]).max() > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("model", sorted(SCENES))
def test_tape_diff_renderer_matches_autograd(model):
    """... = reverse mode through the port's own tracer, the independent
    check tests/test_adjoint.py makes with jax.grad (f64, rtol 1e-10)."""
    _, (scene, params), o, d, tape, _, w = _setup(model)
    f = make_diff_renderer(scene, CFG, use_tape=True)
    got = _port_grads(f, params, w, _tv3(o), _tv3(d), torch.as_tensor(tape))
    auto = _autograd_grads(scene, params, w, o, d, tape)
    assert np.abs(auto[0]).max() > 0 and np.abs(auto[1]).max() > 0
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g, a, **TOL)


def test_param_grads_from_residuals_match_autograd():
    """_param_grads alone, on the forward's own residuals."""
    _, (scene, params), o, d, tape, _, w = _setup("cbox", seed=3)
    tape = torch.as_tensor(tape)
    _, res = trace_rays(params, scene, _tv3(o), _tv3(d), CFG, tape=tape,
                        collect=True)
    got = _param_grads(params, scene, res, _tv3(w), torch.float64)
    auto = _autograd_grads(scene, params, w, o, d, tape)
    np.testing.assert_allclose(got.albedo.numpy(), auto[0], **TOL)
    np.testing.assert_allclose(got.emission.numpy(), auto[1], **TOL)


def test_bwd_tape_unbiased_matches_jax_and_reduces_to_biased():
    """bwd_tape=True retraces on the second tape; with tape_b == tape_f
    it is the biased replay exactly (tests/test_adjoint.py)."""
    (js, jp), (scene, params), o, d, tape, tape2, w = _setup("cbox")
    cfg_u = dataclasses.replace(CFG, unbiased=True)
    f2 = make_diff_renderer(scene, cfg_u, use_tape=True, bwd_tape=True)
    args = (_tv3(o), _tv3(d), torch.as_tensor(tape))
    got = _port_grads(f2, params, w, *args, torch.as_tensor(tape2))
    jf2 = jax_make_diff_renderer(js, _jcfg(unbiased=True), use_tape=True,
                                 bwd_tape=True)
    ref = _jax_grads(jf2, jp, w, _jv3(o), _jv3(d), jnp.asarray(tape),
                     jnp.asarray(tape2))
    same = _port_grads(f2, params, w, *args, torch.as_tensor(tape))
    biased = _port_grads(make_diff_renderer(scene, CFG, use_tape=True),
                         params, w, *args)
    for g, r, s, b in zip(got, ref, same, biased):
        np.testing.assert_allclose(g, r, **TOL)
        np.testing.assert_array_equal(s, b)
        assert not np.allclose(g, b)  # a fresh tape is a fresh estimate


@pytest.mark.parametrize("build,err,match", [
    (lambda s, c: make_diff_renderer(
        s, dataclasses.replace(CFG, bsdf_samples=2), use_tape=True),
     ValueError, "key-driven only"),
    (lambda s, c: make_diff_renderer(
        s, dataclasses.replace(CFG, bsdf_samples=2, unbiased=True),
        use_tape=True, bwd_tape=True), ValueError, "single-BSDF-sample only"),
    (lambda s, c: make_diff_renderer(s, CFG, use_tape=True, bwd_tape=True),
     ValueError, "bwd_tape requires"),
    (lambda s, c: make_diff_renderer(
        s, dataclasses.replace(CFG, unbiased=True), bwd_tape=True),
     ValueError, "bwd_tape requires"),
])
def test_forms_not_ported_or_invalid_raise(build, err, match):
    from drt_tpu_torch.models import cbox

    scene, _, cam = cbox.build(device="cpu")
    with pytest.raises(err, match=match):
        build(scene, cam)


@pytest.mark.parametrize("unbiased", [False, True])
def test_diff_image_renderer_splits_lanes(unbiased):
    """bsdf_samples > 1 on the wavefront image renderer (plain twins on the
    CPU): biased, its gradient is autograd's through the splitting
    `render_image` (float64); unbiased, the salted lanes' estimate, which
    differs from it."""
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.renderer import render_image

    scene, params, cam = cbox.build(dtype=torch.float64, device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=2, spp_chunks=2, max_depth=3,
                       bsdf_samples=2, unbiased=unbiased)
    seeds = (5, -6)
    p = _leaves(params)
    img = make_diff_image_renderer(scene, cam, cfg)(p, seeds)
    (img ** 2).sum().backward()
    p_ref = _leaves(params)
    ref = render_image(p_ref, scene, cam, seeds, cfg)
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    for a, b in ((p.albedo, p_ref.albedo), (p.emission, p_ref.emission)):
        assert torch.isfinite(a.grad).all() and b.grad.abs().max() > 0
        assert np.allclose(a.grad.numpy(), b.grad.numpy(),
                           **TOL) != unbiased


def test_no_grad_flows_to_rays_or_tape():
    _, (scene, params), o, d, tape, _, w = _setup("cbox")
    f = make_diff_renderer(scene, CFG, use_tape=True)
    ov = V3(*(torch.as_tensor(c).requires_grad_() for c in o))
    tp = torch.as_tensor(tape).requires_grad_()
    p = _leaves(params)
    L = f(p, ov, _tv3(d), tp)
    (L.x.sum() + L.y.sum() + L.z.sum()).backward()
    assert p.albedo.grad is not None and ov.x.grad is None
    assert tp.grad is None
