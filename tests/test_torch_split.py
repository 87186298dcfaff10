"""Per-vertex splitting (bsdf_samples > 1) in drt_tpu_torch on the CPU,
where every wrapper runs its plain version, held against the JAX package:

(a) `renderer.lane_count` against the JAX package's;
(b) which lanes share a draw, per bounce and slot, in the port's
    `fused.split_prefix_tape` against the JAX package's threefry form, and
    in the ray-major `ops.rng.prefix_tape` against the prefix formula of
    drt_tpu/renderer.py:_trace_rays_splitting; at M = 1 the draws are
    `hash_tapes`;
(c) the fused and dyn split renderers (plain) fed the JAX package's
    `split_prefix_tape` against the JAX wavefront `trace_rays(tape=...)` on
    the expanded lanes and their mean, and `jax.grad` of it (image rtol
    2e-5 / atol 2e-6, gradients rtol 2e-4 / atol 1e-5, the bounds of
    tests/test_fused.py:469-526); stored = retrace bit for bit;
(d) key-mode splitting in float64 against the JAX tracer on the port's
    lanes and draws, and `make_diff_renderer` against autograd (rtol 1e-10);
(e) "torch-split" = "torch-wavefront" at the same seeds; a tape whose M
    lanes are equal gives the one-sample renderer's image;
(f) `grad_image` = `grad_image_fwd`;
(g) routing, the refusals, and `cli --bsdf-samples`.
No Pallas interpret mode: each JAX callable is built once per module."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu import fused as jax_fused
from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import lane_count as jax_lane_count
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu_torch import fused
from drt_tpu_torch.adjoint import make_diff_renderer
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.gradcheck import grad_image, grad_image_fwd
from drt_tpu_torch.models import cbox
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.dynkernel import MAX_DYN_SHAPES
from drt_tpu_torch.ops.rng import hash_tapes, prefix_tape, split_lanes
from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
from drt_tpu_torch.renderer import (chunk_pixel_ids, chunk_rays,
                                    chunk_sample_ids, lane_count,
                                    trace_rays)
from drt_tpu_torch.scene import Params, from_numpy

TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
CFG = RenderConfig(width=8, height=8, spp=2, max_depth=3, bsdf_samples=2)
CFG_2CHUNKS = dataclasses.replace(CFG, spp=4, spp_chunks=2)
SEEDS = (3, 7)
JAX_SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
              "mesh1": functools.partial(jax_gallery.build_mesh, level=1)}


def _jcfg(cfg, **kw):
    return JaxConfig(**{**dataclasses.asdict(cfg), **kw})


def _leaves(params):
    return Params(*(p.detach().clone().requires_grad_() for p in params))


def _grads(render, params, seeds):
    p = _leaves(params)
    render(p, seeds).sum().backward()
    return p.albedo.grad, p.emission.grad


@functools.lru_cache(maxsize=None)
def _scenes(model):
    js, jp, jc = JAX_SCENES[model](dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


@functools.lru_cache(maxsize=None)
def _jax_reference(model):
    """JAX's lane-split image of one chunk, on the expanded lanes of
    `split_prefix_tape`, and the gradient of its sum by `jax.vjp`: one
    compiled callable per scene, for every chunk of CFG and CFG_2CHUNKS
    (the tracer reads only depth, roulette and bsdf_samples from its
    config)."""
    (js, _, jc), _ = _scenes(model)
    cfg1 = _jcfg(CFG, bsdf_samples=1)
    w, h = CFG.width, CFG.height
    npix = w * h

    def image(p, cam_u, tape):
        n_lanes = cam_u.shape[1]
        pix = jnp.arange(n_lanes) % npix
        xy = jnp.stack([pix % w, pix // w], -1).astype(jnp.int32)
        o, d, _ = jax_camera_rays(jc, w, h, xy, cam_u.T)
        L = jax_trace_rays(p, js, o, d, None, cfg1, tape=tape)
        return jnp.stack([c.reshape(n_lanes // npix, h, w).mean(axis=0)
                          for c in L], axis=-1)

    @jax.jit
    def image_and_grad(p, cam_u, tape):
        img, vjp = jax.vjp(lambda q: image(q, cam_u, tape), p)
        return img, vjp(jnp.ones_like(img))[0]

    return image_and_grad


def _jax_tapes(cfg):
    """The JAX package's split_prefix_tape of every chunk of cfg."""
    seeds = jnp.asarray(SEEDS, jnp.int32)
    return [jax_fused.split_prefix_tape(seeds, c, _jcfg(cfg))
            for c in range(cfg.spp_chunks)]


# (a) -----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_lane_count_matches_jax(n):
    for depth in range(1, 8):
        cfg = dict(width=2, height=2, spp=1, max_depth=depth,
                   min_bounces=min(1, depth), bsdf_samples=n)
        assert lane_count(RenderConfig(**cfg)) == jax_lane_count(
            JaxConfig(**cfg)) == split_lanes(n, depth)


# (b) -----------------------------------------------------------------------

def _shares(tape, M):
    """bool[D, 3, n_cam, M, M]: which lanes of a camera sample read equal
    draws, from an M-outer tape f[D, 3, M * n_cam]."""
    t = np.asarray(tape)
    t = t.reshape(t.shape[0], 3, M, -1).transpose(0, 1, 3, 2)
    return t[..., :, None] == t[..., None, :]


@pytest.mark.parametrize("n,depth", [(2, 3), (2, 4), (3, 3), (3, 4)])
def test_split_prefix_tape_shares_as_jax(n, depth):
    cfg = RenderConfig(width=4, height=2, spp=2, max_depth=depth,
                       bsdf_samples=n)
    M = lane_count(cfg)
    cam_u, tape = fused.split_prefix_tape(torch.tensor(SEEDS), 0, cfg)
    j_cam, j_tape = jax_fused.split_prefix_tape(
        jnp.asarray(SEEDS, jnp.int32), 0, _jcfg(cfg))
    n_lanes = 4 * 2 * 2 * M
    assert tuple(tape.shape) == tuple(j_tape.shape) == (depth, 3, n_lanes)
    assert tuple(cam_u.shape) == tuple(j_cam.shape) == (2, n_lanes)
    shares = _shares(tape, M)
    np.testing.assert_array_equal(shares, _shares(j_tape, M))
    # Every lane of a camera sample shares its camera draws.
    assert (cam_u.reshape(2, M, -1) == cam_u[:, None, :16]).all()
    # Some sharing and some not, at every bounce.
    assert shares.any(axis=(1, 2, 3, 4)).all()
    assert (~shares).any()


@pytest.mark.parametrize("n,depth", [(2, 3), (3, 4)])
def test_ray_major_draws_follow_the_prefix_formula(n, depth):
    """Lane r*M + m of the ray-major tape reads at bounce b the draw of
    prefix m // n^(D-1-b) (roulette) and m // n^(D-2-b) (u1, u2; m at the
    last bounce), drt_tpu/renderer.py:208-214; its values are those of
    the M-outer tape, transposed."""
    M = split_lanes(n, depth)
    pix = torch.arange(6) * 5
    s = torch.arange(6) % 2
    ray = prefix_tape(11, pix, s, n, depth)
    outer = prefix_tape(11, pix, s, n, depth, lanes_outer=True)
    np.testing.assert_array_equal(
        ray.reshape(depth, 3, 6, M).numpy(),
        outer.reshape(depth, 3, M, 6).transpose(2, 3).numpy())
    t = ray.reshape(depth, 3, 6, M).numpy()
    m = np.arange(M)
    for b in range(depth):
        rr = m // n ** (depth - 1 - b)
        uu = m // n ** (depth - 2 - b) if b < depth - 1 else m
        for k, prefix in ((0, rr), (1, uu), (2, uu)):
            same = prefix[:, None] == prefix[None, :]
            got = t[b, k][:, :, None] == t[b, k][:, None, :]
            np.testing.assert_array_equal(got, np.broadcast_to(same,
                                                               got.shape))


@pytest.mark.parametrize("n,depth,chunk", [(1, 4, 1), (2, 1, 0)])
def test_one_lane_draws_are_hash_tapes(n, depth, chunk):
    cfg = RenderConfig(width=4, height=3, spp=4, spp_chunks=2,
                       max_depth=depth, min_bounces=min(1, depth),
                       bsdf_samples=n)
    assert lane_count(cfg) == 1
    cam_u, tape = fused.split_prefix_tape(SEEDS, chunk, cfg)
    ref = hash_tapes(SEEDS, 12, 2, depth, sample_base=2 * chunk)
    torch.testing.assert_close(cam_u, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(tape, ref[1], rtol=0, atol=0)


# (c) -----------------------------------------------------------------------

SPLIT_CASES = [("cbox", CFG), ("glossy", CFG), ("mesh1", CFG),
               ("cbox", CFG_2CHUNKS)]


@pytest.fixture(scope="module")
def split_runs():
    """Per case: the port's plain split renderer fed JAX's tapes (image,
    stored and retrace gradients) and JAX's reference image and
    gradients."""
    out = {}
    for model, cfg in SPLIT_CASES:
        (_, jp, _), (scene, params, cam) = _scenes(model)
        tapes = _jax_tapes(cfg)

        def tape_fn(seeds, chunk, tapes=tapes):
            return tuple(torch.tensor(np.asarray(t)) for t in tapes[chunk])

        make = (fused.make_split_dyn_image_renderer if model == "mesh1"
                else fused.make_split_fused_image_renderer)
        seeds = torch.tensor(SEEDS, dtype=torch.int32)
        img = make(scene, cam, cfg, plain=True, tape_fn=tape_fn)(params,
                                                                  seeds)
        grads = {adj: _grads(make(scene, cam, cfg, adjoint=adj, plain=True,
                                  tape_fn=tape_fn), params, seeds)
                 for adj in ("stored", "retrace")}
        refs = [_jax_reference(model)(jp, *t) for t in tapes]
        ref_img = sum(np.asarray(r[0]) for r in refs) / len(refs)
        ref_g = [sum(np.asarray(getattr(r[1], f)) for r in refs) / len(refs)
                 for f in ("albedo", "emission")]
        out[model, cfg.spp_chunks] = (img, grads, ref_img, ref_g)
    return out


@pytest.mark.parametrize("model,cfg", SPLIT_CASES)
def test_split_renderer_matches_jax_expanded_lanes(split_runs, model, cfg):
    img, grads, ref_img, ref_g = split_runs[model, cfg.spp_chunks]
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), ref_img, **TOL)
    assert np.abs(ref_g[0]).max() > 1e-3
    for got, ref in zip(grads["stored"], ref_g):
        np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL)


@pytest.mark.parametrize("model,cfg", SPLIT_CASES)
def test_split_stored_equals_retrace(split_runs, model, cfg):
    _, grads, _, _ = split_runs[model, cfg.spp_chunks]
    for a, b in zip(grads["stored"], grads["retrace"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (d) -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def f64_cbox():
    scene, params, cam = cbox.build(dtype=torch.float64, device="cpu")
    js64, jp64, _ = jax_cbox.build(dtype=jnp.float64)
    return scene, params, cam, js64, jp64


def test_key_mode_splitting_matches_jax_on_its_lanes(f64_cbox):
    scene, params, cam, js, jp = f64_cbox
    cfg = dataclasses.replace(CFG, spp=2, spp_chunks=2)
    M = lane_count(cfg)
    xy = chunk_pixel_ids(cfg)
    pix, s = chunk_sample_ids(cfg, xy, 1)
    o, d, _ = chunk_rays(cam, cfg, xy, SEEDS, 1)
    L, res = trace_rays(params, scene, o, d, cfg, collect=True, seeds=SEEDS,
                        pix=pix, sample=s)
    tape = prefix_tape(SEEDS[1], pix, s, 2, cfg.max_depth, torch.float64)
    assert res.sc.shape == (cfg.max_depth, pix.shape[0] * M)
    lanes = [JV3(*(jnp.asarray(c.repeat_interleave(M).numpy()) for c in v))
             for v in (o, d)]
    ref = jax_trace_rays(jp, js, *lanes, None, _jcfg(cfg, bsdf_samples=1),
                         tape=jnp.asarray(tape.numpy()))
    for got, r in zip(L, ref):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(
            got.numpy(), np.asarray(r).reshape(-1, M).mean(axis=1), **F64)
    assert float(sum(c.sum() for c in L)) > 0
    with pytest.raises(ValueError, match="key-driven only"):
        trace_rays(params, scene, o, d, cfg, tape=tape)


@pytest.mark.parametrize("unbiased", [False, True])
def test_diff_renderer_splitting_matches_autograd(f64_cbox, unbiased):
    """Biased: the radiative backprop of the M-lane estimator equals
    autograd through the splitting forward (tests/test_adjoint.py:197-214).
    Unbiased: the same identity on the salted bounce seed's lanes."""
    from drt_tpu_torch.adjoint import _bwd_seeds

    scene, params, cam, _, _ = f64_cbox
    cfg = dataclasses.replace(CFG, unbiased=unbiased)
    xy = chunk_pixel_ids(cfg)
    o, d, _ = chunk_rays(cam, cfg, xy, SEEDS, 0)
    w = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, size=(3, o.x.shape[0])))
    p = _leaves(params)
    L = make_diff_renderer(scene, cfg)(p, o, d, SEEDS)
    sum((w[k] * L[k]).sum() for k in range(3)).backward()
    p_ref = _leaves(params)
    (sd,) = _bwd_seeds(dataclasses.replace(cfg, adjoint_samples=1), SEEDS)
    L_ref = trace_rays(p_ref, scene, o, d, cfg, seeds=sd)
    sum((w[k] * L_ref[k]).sum() for k in range(3)).backward()
    if not unbiased:
        for a, b in zip(L, L_ref):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), **F64)
    for a, b in ((p.albedo, p_ref.albedo), (p.emission, p_ref.emission)):
        assert b.grad.abs().max() > 0
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **F64)


# (e) -----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, CFG_2CHUNKS])
def test_torch_split_equals_torch_wavefront(cfg):
    _, (scene, params, cam) = _scenes("cbox")
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    split = make_renderer(scene, cfg, cam, differentiable=False)(params,
                                                                 seeds)
    wave = make_renderer(scene, cfg, cam, differentiable=False,
                         backend="torch-wavefront")(params, seeds)
    assert split.grad_fn is None and split.mean() > 0
    np.testing.assert_allclose(split.numpy(), wave.numpy(), **TOL)


def test_equal_lanes_give_the_one_sample_image():
    _, (scene, params, cam) = _scenes("glossy")
    M = lane_count(CFG)
    cam_u, tape = hash_tapes(SEEDS, 64, CFG.spp, CFG.max_depth)
    split = fused.make_split_fused_image_renderer(
        scene, cam, CFG, plain=True, differentiable=False,
        tape_fn=lambda seeds, c: (cam_u.repeat(1, M), tape.repeat(1, 1, M)))
    one = fused.make_fused_image_renderer(
        scene, cam, dataclasses.replace(CFG, bsdf_samples=1), rng="tape",
        plain=True, differentiable=False)
    got = split(params, SEEDS)
    np.testing.assert_allclose(got.numpy(),
                               one(params, cam_u, tape).numpy(), rtol=1e-6)
    assert got.mean() > 0


# (f) -----------------------------------------------------------------------

@pytest.mark.parametrize("param", ["albedo:0", "emission:0"])
def test_grad_image_equals_forward_mode_when_split(f64_cbox, param):
    scene, params, cam, _, _ = f64_cbox
    cfg = dataclasses.replace(CFG, spp=2, spp_chunks=2)
    bp = grad_image(scene, cam, cfg, params, SEEDS, param)
    fw = grad_image_fwd(scene, cam, cfg, params, SEEDS, param)
    assert bp.shape == (8, 8, 3) and fw.abs().max() > 0
    np.testing.assert_allclose(bp.numpy(), fw.numpy(), **F64)


# (g) -----------------------------------------------------------------------

def _on_card(num_shapes):
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 num_shapes=num_shapes,
                                 shape_geo=torch.zeros(0))


def test_routing_of_split_configs():
    _, (scene, params, cam) = _scenes("cbox")
    assert resolve_backend(scene, CFG) == "torch-split"
    assert resolve_backend(_on_card(9), CFG) == "cuda-split"
    assert resolve_backend(_on_card(mk.MAX_SHAPES), CFG) == "cuda-split"
    assert resolve_backend(_on_card(mk.MAX_SHAPES + 1),
                           CFG) == "cuda-split-dyn"
    assert resolve_backend(_on_card(MAX_DYN_SHAPES), CFG) == "cuda-split-dyn"
    with pytest.raises(ValueError, match="backend='torch-wavefront'"):
        resolve_backend(_on_card(MAX_DYN_SHAPES + 1), CFG)
    # One sample per vertex keeps the unsplit backends.
    one = dataclasses.replace(CFG, bsdf_samples=1)
    assert resolve_backend(_on_card(9), one) == "cuda"
    assert resolve_backend(scene, one) == "torch"
    before = mk.launch_counts()
    img = make_renderer(scene, CFG, cam, backend="torch-split-dyn")(
        _leaves(params), torch.tensor(SEEDS))
    img.mean().backward()
    assert mk.launch_counts() == before


@pytest.mark.parametrize("kw,match", [
    (dict(backend="cuda-split"), "'cuda-split' needs the scene on a CUDA"),
    (dict(backend="cuda-split-dyn"), "needs the scene on a CUDA device"),
    (dict(backend="pallas-split"), "'pallas-split' is 'cuda-split'"),
    (dict(backend="pallas-split-dyn"), "'pallas-split-dyn' is "
     "'cuda-split-dyn'"),
    (dict(backend="torch"), "'cuda-split' / 'cuda-split-dyn'"),
    (dict(backend="torch-regen"), "'cuda-split' / 'cuda-split-dyn'"),
    (dict(cfg=dict(unbiased=True)), "'cuda-wavefront' backend keeps "
     "unbiased"),
    (dict(cfg=dict(bsdf_samples=1), backend="torch-split"),
     "bsdf_samples == 1"),
])
def test_split_refusals(kw, match):
    _, (scene, _, cam) = _scenes("cbox")
    cfg = dataclasses.replace(CFG, **kw.pop("cfg", {}))
    with pytest.raises(ValueError, match=match):
        make_renderer(scene, cfg, cam, **kw)


def test_sample_index_stays_in_31_bits():
    cfg = RenderConfig(width=1, height=1, spp=2 ** 27, spp_chunks=2 ** 27,
                       max_depth=6, bsdf_samples=2)  # spp * M = 2^32
    with pytest.raises(ValueError, match="31 bits"):
        fused.split_prefix_tape(SEEDS, 0, cfg)
    fused.split_prefix_tape(SEEDS, 0, dataclasses.replace(
        cfg, spp=2 ** 26, spp_chunks=2 ** 26))  # 2^31: the limit itself
    with pytest.raises(ValueError, match="31 bits"):
        prefix_tape(1, torch.zeros(1, dtype=torch.int64),
                    torch.full((1,), 2 ** 26, dtype=torch.int64), 2, 6)


def test_tape_forms_of_splitting_are_refused():
    _, (scene, _, _) = _scenes("cbox")
    with pytest.raises(ValueError, match="key-driven only"):
        make_diff_renderer(scene, CFG, use_tape=True)
    with pytest.raises(ValueError, match="single-BSDF-sample only"):
        make_diff_renderer(scene, dataclasses.replace(CFG, unbiased=True),
                           use_tape=True, bwd_tape=True)


def test_cli_takes_bsdf_samples(tmp_path):
    from drt_tpu_torch import cli

    out = tmp_path / "split.png"
    assert cli.main(["render", "-x", "8", "-y", "6", "-n", "1",
                     "--max-depth", "3", "--bsdf-samples", "2",
                     "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    grads = tmp_path / "grads.json"
    assert cli.main(["grad", "-x", "8", "-y", "6", "-n", "1",
                     "--max-depth", "3", "--bsdf-samples", "2",
                     "--device", "cpu", "-o", str(grads)]) == 0
    import json

    got = json.loads(grads.read_text())
    assert got["backend"] == "torch-split"
    assert np.abs(np.asarray(got["d_albedo"])).max() > 0
