"""The backward of drt_tpu_torch's main path on the CPU, where every
wrapper runs its plain twin: the collect, sweep and retrace-adjoint twins
against the JAX Pallas kernels (tape mode, interpret mode, as
tests/test_fused.py runs them), and `fused.make_fused_image_renderer` as
a whole against the JAX package in tape mode, with the internal RNG (via
`drt_tpu.ops.regen.hash_tapes`) and in unbiased mode.

Float32. Radiance and residuals to rtol 2e-5 / atol 2e-6, gradients to
rtol 2e-5 / atol 1e-7 (tests/test_fused.py:350-356) where both sides run
the kernels' op order, and atol 2e-6 against the JAX wavefront path, whose
throughput product is associated differently."""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu import fused as jax_fused
from drt_tpu.adjoint import make_diff_renderer as jax_make_diff_renderer
from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.ops.regen import hash_tapes as jax_hash_tapes
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.scene import (Params, albedo_table, emission_table,
                                 from_numpy)

SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
            "tri": jax_gallery.build_tri}
TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
XLA_GRAD_TOL = dict(rtol=2e-5, atol=2e-6)
# tests/test_fused.py's shape: 512 rays = 4 tiles of 128 at tile_rows=1.
CFG = RenderConfig(width=16, height=8, spp=4, max_depth=4)
N = CFG.width * CFG.height * CFG.spp


def _jcfg(cfg=CFG, **kw):
    return JaxConfig(**{**dataclasses.asdict(cfg), **kw})


def _both(model):
    js, jp, jc = SCENES[model](dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(2, N)).astype(np.float32),
            r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32),
            r.uniform(0.5, 1.5, size=(3, N)).astype(np.float32))


def _matters(sc, best):
    """Bounce-slots with no earlier live bounce of weight sc == 0: what
    comes after is cut off from the estimator and decided by an ulp (see
    tests/test_torch_adjoint.py)."""
    zero = (sc == 0) & (best > 0)
    return (np.cumsum(zero, axis=0) - zero) == 0


def _leaves(params):
    return Params(*(p.clone().requires_grad_() for p in params))


@pytest.fixture(scope="module", params=sorted(SCENES))
def kernels(request):
    """The three JAX Pallas kernels run once per scene in interpret mode,
    and the port's twins on the same numpy inputs."""
    (js, jp, jc), (scene, params, cam) = _both(request.param)
    cam_u, tape, g = _inputs()
    kw = dict(tile_rows=1, rng="tape", interpret=True)
    ja, je = jax_albedo_table(js, jp), jax_emission_table(js, jp)
    jcu, jtp = jnp.asarray(cam_u), jnp.asarray(tape)
    jg = JV3(*map(jnp.asarray, g))
    L, rsc, rbest = jax_mk.make_fused_collect_tracer(js, jc, _jcfg(), **kw)(
        ja, je, jcu, jtp)
    ref = dict(L=np.stack([np.asarray(c) for c in L]),
               rsc=np.asarray(rsc), rbest=np.asarray(rbest))
    ref["adjoint"] = [np.asarray(x) for x in jax_mk.make_fused_adjoint(
        js, jc, _jcfg(), **kw)(ja, je, jcu, jtp, jg)]
    # The Pallas sweep kernel itself runs on the Cornell box; on the other
    # scenes its result is the retrace adjoint's, which the reference holds
    # bit-equal to it (tests/test_fused.py:359-391).
    ref["sweep"] = ref["adjoint"]
    if request.param == "cbox":
        ref["sweep"] = [np.asarray(x) for x in
                        jax_mk.make_fused_sweep_adjoint(
                            js, _jcfg(), tile_rows=1, interpret=True)(
                            ja, je, rsc, rbest, jg)]

    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    tcu, ttp, tg = (torch.as_tensor(x) for x in (cam_u, tape, g))
    before = mk.launch_counts()
    L, rsc, rbest = mk.make_fused_collect_tracer(scene, cam, CFG,
                                                 rng="tape")(alb, emi, tcu,
                                                             ttp)
    got = dict(L=L.numpy(), rsc=rsc.numpy(), rbest=rbest.numpy())
    # The sweep twin is fed the JAX kernel's residuals, so that only the
    # summation order differs.
    got["sweep"] = [x.numpy() for x in mk.make_fused_sweep_adjoint(
        scene, CFG)(alb, emi, torch.as_tensor(ref["rsc"].copy()),
                    torch.as_tensor(ref["rbest"].copy()), tg)]
    got["adjoint"] = [x.numpy() for x in mk.make_fused_adjoint(
        scene, cam, CFG, rng="tape")(alb, emi, tcu, ttp, tg)]
    assert mk.launch_counts() == before  # CPU tensors launch nothing
    return got, ref


def test_collect_twin_matches_pallas(kernels):
    got, ref = kernels
    assert ref["L"].mean() > 0 and got["rbest"].dtype == np.int32
    assert got["rsc"].shape == (CFG.max_depth, N)
    np.testing.assert_allclose(got["L"], ref["L"], **TOL)
    m = _matters(ref["rsc"], ref["rbest"])
    assert m.mean() > 0.9 and (ref["rbest"] > 0).any()
    np.testing.assert_array_equal(got["rbest"][m], ref["rbest"][m])
    # The specular weight divides by sin_h = sqrt(1 - cos_h^2), which
    # loses digits as cos_h -> 1: the two libms' pow then differ by more
    # than TOL on a few glossy slots.
    close = np.isclose(got["rsc"][m], ref["rsc"][m], **TOL)
    assert (~close).mean() <= 5e-3
    np.testing.assert_allclose(got["rsc"][m], ref["rsc"][m], rtol=2e-3,
                               atol=1e-4)


@pytest.mark.parametrize("which", ["sweep", "adjoint"])
def test_adjoint_twins_match_pallas(kernels, which):
    got, ref = kernels
    for g, r in zip(got[which], ref[which]):
        assert g.shape == r.shape and np.abs(r).max() > 0
        assert (g[-1] == 0).all()  # the sentinel row
        np.testing.assert_allclose(g, r, **GRAD_TOL)


def test_per_pixel_cotangent_equals_per_ray():
    """The adjoints take the image cotangent per pixel (`_g_pix_of`) and
    index it by pixel, or per ray slot (`_g_ray_of`, the JAX form)."""
    _, (scene, params, cam) = _both("cbox")
    cam_u, tape, _ = _inputs(1)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    g_img = np.random.default_rng(2).uniform(
        size=(CFG.height, CFG.width, 3)).astype(np.float32)
    g_pix = fused._g_pix_of(torch.as_tensor(g_img), CFG.spp, 1,
                            torch.float32)
    g_ray = fused._g_ray_of(torch.as_tensor(g_img), CFG.spp, 1,
                            torch.float32)
    ref = jax_fused._g_ray_of(jnp.asarray(g_img), CFG.spp, 1, jnp.float32)
    np.testing.assert_array_equal(g_ray.numpy(),
                                  np.stack([np.asarray(c) for c in ref]))
    assert g_pix.shape == (3, CFG.width * CFG.height)
    adj = mk.make_fused_adjoint(scene, cam, CFG, rng="tape")
    args = (alb, emi, torch.as_tensor(cam_u), torch.as_tensor(tape))
    for a, b in zip(adj(*args, g_pix), adj(*args, g_ray)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tape_renderers():
    (js, jp, jc), (scene, params, cam) = _both("cbox")
    cam_u, tape, _ = _inputs(3)
    jr = jax_fused.make_fused_image_renderer(
        js, jc, _jcfg(), tile_rows=1, rng="tape", adjoint="stored",
        interpret=True)
    loss, g = jax.value_and_grad(lambda p: jnp.sum(
        jr(p, jnp.asarray(cam_u), jnp.asarray(tape)) ** 2))(jp)
    ref = (float(loss), np.asarray(g.albedo), np.asarray(g.emission))
    got = {}
    for adjoint in ("stored", "retrace"):
        r = fused.make_fused_image_renderer(scene, cam, CFG, rng="tape",
                                            adjoint=adjoint)
        p = _leaves(params)
        img = r(p, torch.as_tensor(cam_u), torch.as_tensor(tape))
        assert img.grad_fn is not None and img.shape == (8, 16, 3)
        (img ** 2).sum().backward()
        got[adjoint] = (img.detach(), p.albedo.grad, p.emission.grad)
    return got, ref


@pytest.mark.parametrize("adjoint", ["stored", "retrace"])
def test_tape_renderer_matches_jax(tape_renderers, adjoint):
    """Image and grads of loss = sum(img^2) against the JAX renderer over
    its Pallas kernels."""
    got, (loss, da, de) = tape_renderers
    img, g_alb, g_emi = got[adjoint]
    assert loss > 0 and np.abs(da).max() > 0
    np.testing.assert_allclose((img ** 2).sum().item(), loss, rtol=2e-5)
    np.testing.assert_allclose(g_alb.numpy(), da, **GRAD_TOL)
    np.testing.assert_allclose(g_emi.numpy(), de, **GRAD_TOL)


def test_stored_equals_retrace_bit_for_bit(tape_renderers):
    got, _ = tape_renderers
    for s, r in zip(got["stored"], got["retrace"]):
        assert torch.equal(s, r)


CFG_I = RenderConfig(width=16, height=8, spp=4, spp_chunks=2, max_depth=4)
SEEDS = [123, -456]


@functools.lru_cache(maxsize=None)
def _jax_internal_grads(unbiased_samples=0):
    """Grads of loss = sum(img * W) for the internal-RNG renderer, rebuilt
    on the JAX side: per chunk c, hash tapes at sample_base = c * spp_c
    through camera_rays and the tape-driven make_diff_renderer. With
    unbiased_samples > 0 the backward tapes come from the salted bounce
    seed of each adjoint sample and the grads are averaged."""
    (js, jp, jc), _ = _both("cbox")
    cfg = CFG_I
    npix, spp_c = cfg.width * cfg.height, cfg.spp // cfg.spp_chunks
    w_img = np.random.default_rng(4).uniform(
        0.5, 1.5, size=(cfg.height, cfg.width, 3)).astype(np.float32)
    g_pix = w_img.reshape(-1, 3).T / (spp_c * cfg.spp_chunks)
    g_ray = JV3(*(jnp.asarray(np.tile(c, spp_c)) for c in g_pix))
    xy = jnp.tile(jax_pixel_grid(cfg.width, cfg.height), (spp_c, 1))
    one = _jcfg(dataclasses.replace(cfg, spp=spp_c, spp_chunks=1),
                unbiased=bool(unbiased_samples))
    diff = jax_make_diff_renderer(js, one, use_tape=True,
                                  bwd_tape=bool(unbiased_samples))

    @jax.jit
    def chunk_grads(p, o, d, *tapes):
        L, vjp = jax.vjp(lambda q: diff(q, o, d, *tapes), p)
        return L, vjp(g_ray)[0]

    def tapes_of(seeds, c):
        return jax_hash_tapes(jnp.asarray(seeds, jnp.int32), npix, spp_c,
                              cfg.max_depth, jnp.float32,
                              sample_base=c * spp_c)

    img = 0.0
    da = de = 0.0
    for c in range(cfg.spp_chunks):
        cam_u, tape = tapes_of(SEEDS, c)
        o, d, _ = jax_camera_rays(jc, cfg.width, cfg.height, xy, cam_u.T)
        backward = [()]
        if unbiased_samples:
            backward = [(tapes_of(fused._salted(SEEDS, s), c)[1],)
                        for s in range(unbiased_samples)]
        for tb in backward:
            L, g = chunk_grads(jp, o, d, tape, *tb)
            da = da + np.asarray(g.albedo) / len(backward)
            de = de + np.asarray(g.emission) / len(backward)
        L = np.stack([np.asarray(ch) for ch in L])
        img = img + np.moveaxis(L.reshape(3, spp_c, cfg.height,
                                          cfg.width).mean(1), 0, -1)
    return w_img, img / cfg.spp_chunks, da, de


@pytest.mark.parametrize("adjoint", ["stored", "retrace"])
def test_internal_rng_grads_match_jax_on_hash_tapes(adjoint):
    w_img, ref_img, da, de = _jax_internal_grads()
    _, (scene, params, cam) = _both("cbox")
    r = fused.make_fused_image_renderer(scene, cam, CFG_I, adjoint=adjoint)
    p = _leaves(params)
    img = r(p, torch.tensor(SEEDS, dtype=torch.int32))
    (img * torch.as_tensor(w_img)).sum().backward()
    assert np.abs(da).max() > 0 and np.abs(de).max() > 0
    np.testing.assert_allclose(img.detach().numpy(), ref_img, **TOL)
    np.testing.assert_allclose(p.albedo.grad.numpy(), da, **XLA_GRAD_TOL)
    np.testing.assert_allclose(p.emission.grad.numpy(), de, **XLA_GRAD_TOL)


def test_unbiased_grads_match_jax_on_salted_hash_tapes():
    """adjoint_samples=2: each backward sample retraces on the bounce seed
    seed1 + _BWD_SALT + s * _BWD_SAMPLE_STRIDE (mod 2^32) with the camera
    stream unchanged; the grads are the samples' mean."""
    assert (fused._BWD_SALT, fused._BWD_SAMPLE_STRIDE) == (
        int(jax_fused._BWD_SALT), int(jax_fused._BWD_SAMPLE_STRIDE))
    assert fused._salted([5, -1], 1) == [5, (0xFFFFFFFF + 0x0ADD + 0x51ED)
                                         & 0xFFFFFFFF]
    w_img, ref_img, da, de = _jax_internal_grads(unbiased_samples=2)
    _, (scene, params, cam) = _both("cbox")
    cfg = dataclasses.replace(CFG_I, unbiased=True, adjoint_samples=2)
    r = fused.make_fused_image_renderer(scene, cam, cfg)
    p = _leaves(params)
    img = r(p, torch.tensor(SEEDS, dtype=torch.int32))
    (img * torch.as_tensor(w_img)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), ref_img, **TOL)
    np.testing.assert_allclose(p.albedo.grad.numpy(), da, **XLA_GRAD_TOL)
    np.testing.assert_allclose(p.emission.grad.numpy(), de, **XLA_GRAD_TOL)
    biased = _leaves(params)
    (fused.make_fused_image_renderer(scene, cam, CFG_I)(
        biased, torch.tensor(SEEDS, dtype=torch.int32))
     * torch.as_tensor(w_img)).sum().backward()
    assert not torch.allclose(biased.albedo.grad, p.albedo.grad)


def test_resolve_adjoint_choices_and_messages():
    biased = RenderConfig(width=640, height=480, spp=256, spp_chunks=16,
                          max_depth=5)
    assert fused.stored_bytes(biased) == 4_915_200 * 16 * 5 * 8
    assert fused._resolve_adjoint(biased, "auto") == "stored"
    huge = dataclasses.replace(biased, spp=1024, max_depth=32)
    assert fused.stored_bytes(huge) > fused.stored_budget_bytes("cpu")
    assert fused._resolve_adjoint(huge, "auto") == "retrace"
    assert fused._resolve_adjoint(huge, "stored") == "stored"
    unbiased = dataclasses.replace(biased, unbiased=True)
    assert fused._resolve_adjoint(unbiased, "auto") == "retrace"
    assert fused._resolve_adjoint(unbiased, "retrace") == "retrace"
    for cfg, mode in ((unbiased, "stored"), (biased, "bogus")):
        with pytest.raises(ValueError) as port_err:
            fused._resolve_adjoint(cfg, mode)
        with pytest.raises(ValueError) as jax_err:
            jax_fused._resolve_adjoint(_jcfg(cfg), mode)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["no_grad", "no_leaf", "not_differentiable"])
def test_forward_without_grad_takes_the_tracer(monkeypatch, case):
    """When nothing asks for a gradient the forward is the plain tracer:
    no residuals are collected and the image has no history."""
    _, (scene, params, cam) = _both("cbox")
    calls = {"trace": 0, "collect": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mk, "fused_trace_plain",
                        counting("trace", mk.fused_trace_plain))
    monkeypatch.setattr(mk, "fused_collect_plain",
                        counting("collect", mk.fused_collect_plain))
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    r = fused.make_fused_image_renderer(
        scene, cam, CFG_I, adjoint="stored",
        differentiable=(case != "not_differentiable"))
    if case == "no_grad":
        with torch.no_grad():
            img = r(_leaves(params), seeds)
    elif case == "no_leaf":
        img = r(params, seeds)
    else:
        img = r(_leaves(params), seeds)
    assert calls == {"trace": 1, "collect": 0}
    assert img.grad_fn is None and not img.requires_grad
    img2 = r(_leaves(params), seeds) if case != "not_differentiable" else img
    assert calls["collect"] == (0 if case == "not_differentiable" else 1)
    assert torch.equal(img2.detach(), img)


def test_make_renderer_is_differentiable_by_default():
    from drt_tpu_torch.parallel.render import make_renderer

    _, (scene, params, cam) = _both("cbox")
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    for backend in ("auto", "torch"):
        p = _leaves(params)
        img = make_renderer(scene, CFG_I, cam, backend=backend)(p, seeds)
        assert img.grad_fn is not None
        img.mean().backward()
        assert p.albedo.grad.abs().max() > 0
        assert p.emission.grad.abs().max() > 0


def test_adjoint_kernels_refuse_deep_paths_and_bad_cotangents(monkeypatch):
    """Input checks of the CUDA branch that need no card: they run before
    any library is loaded. (The rest are in tests/test_torch_cuda.py.)
    Paths deeper than the MAX_DEPTH rows a thread keeps are taken, by the
    kernels' deep forms: their buffers are the in-thread forms', and only
    they need the device-memory scratch of `deep_scratch`, which is as
    large as the library says (none where it says 0)."""
    _, (scene, params, cam) = _both("cbox")
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    for depth in (mk.MAX_DEPTH + 1, 64):
        deep = RenderConfig(width=4, height=4, spp=1, max_depth=depth)
        tcfg = mk._trace_config(deep, mk.scene_table(scene), alb, emi)
        partials, da, de = mk._adjoint_buffers(deep, tcfg,
                                               torch.zeros(3, 16),
                                               alb.device)
        assert partials.shape == (1, (alb.shape[0] + emi.shape[0] - 2) * 3)
    # deep_scratch asks the library (a stub here: the size is the card's)
    # and allocates what it says; 0 bytes, the in-thread forms, no scratch.
    class Lib:
        def __init__(self, size):
            self.size, self.calls = size, []

        def drt_deep_bytes(self, *args):
            self.calls.append(args[:4])
            args[4]._obj.value = self.size
            return 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for size, depth in ((0, mk.MAX_DEPTH), (96, mk.MAX_DEPTH + 1)):
        lib = Lib(size)
        got = mk.deep_scratch(lib, 16, depth, alb.shape[0], emi.shape[0],
                              alb.device)
        assert lib.calls == [(16, depth, alb.shape[0], emi.shape[0])]
        assert got is None if size == 0 else (
            got.dtype == torch.uint8 and got.shape == (size,))
    ok = RenderConfig(width=4, height=4, spp=2, max_depth=3)
    tcfg = mk._trace_config(ok, mk.scene_table(scene), alb, emi)
    with pytest.raises(ValueError, match="per ray or"):
        mk._adjoint_buffers(ok, tcfg, torch.zeros(3, 7), alb.device)
    partials, da, de = mk._adjoint_buffers(ok, tcfg, torch.zeros(3, 16),
                                           alb.device)
    assert partials.shape == (1, (alb.shape[0] + emi.shape[0] - 2) * 3)
    assert da.shape == alb.shape and de.shape == emi.shape
