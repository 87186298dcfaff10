"""drt_tpu_torch.parallel.mesh and the sharded renderers on the CPU, where
every kernel wrapper runs its plain PyTorch version.

On a virtual mesh of 8 CPU shards (one device repeated, the counterpart
of the JAX tests' 8-device CPU mesh) each of the six sharded families
gives the unsharded port image bit for bit and its gradients within rtol
2e-5 / atol 1e-7 (the shards' partials summed in another order): the
scene-table, memory-resident and lane-splitting renderers, stored and
retrace, at 16x8x8 spp, depth 3; the regeneration pair; the wavefront on
a mesh. The plain versions at a ray offset give the slice of their
offset-0 output bit for bit, as a shard's split lanes give the slice of
the chunk's (and follow the prefix formula); the stored adjoint's rows
are saved tensors, which the backward frees. The parity of the sharded renderers with the
JAX package's is tests/test_torch_mesh_jax_fused.py and
tests/test_torch_mesh_jax_regen.py (each JAX build takes seconds)."""

import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch

from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import dynregen as dr
from drt_tpu_torch.ops import earlyexit as ee
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.ops.rng import hash_uniform, prefix_tape, split_lanes
from drt_tpu_torch.parallel.mesh import (local_count, make_mesh,
                                         pad_to_multiple, ray_range,
                                         shard_index)
from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
from drt_tpu_torch.scene import Params, albedo_table, emission_table

GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
CFG = RenderConfig(width=16, height=8, spp=8, spp_chunks=2, max_depth=3)
SEEDS = torch.tensor([12345, -678], dtype=torch.int32)
MESH8 = make_mesh(devices=["cpu"] * 8)


def _leaves(params):
    return Params(*(t.detach().clone().requires_grad_() for t in params))


def _image_and_grads(render, params, *uniforms):
    p = _leaves(params)
    img = render(p, *uniforms)
    (img ** 2).sum().backward()
    return img.detach(), p.albedo.grad, p.emission.grad


def _same(a, b):
    img_a, *g_a = a
    img_b, *g_b = b
    assert img_a.mean() > 0
    assert torch.equal(img_b, img_a)
    for x, y in zip(g_a, g_b):
        assert x.abs().max() > 0
        np.testing.assert_allclose(y.numpy(), x.numpy(), **GRAD_TOL)


@pytest.fixture(scope="module")
def cornell():
    return cbox.build(device="cpu")


@pytest.fixture(scope="module")
def ico():
    return gallery.build_mesh(1, device="cpu")


def test_make_mesh_shapes():
    assert MESH8.size == 8 and MESH8.shape == (4, 2)
    assert MESH8.axis_names == ("tiles", "spp") and MESH8.group is None
    assert make_mesh(shape=(8, 1), devices=["cpu"] * 8).shape == (8, 1)
    assert make_mesh(devices=["cpu"] * 6).shape == (3, 2)
    assert make_mesh(devices=["cpu"] * 3).shape == (3, 1)
    assert make_mesh(devices=["cpu"] * 2).shape == (2, 1)
    assert make_mesh(shape=(8,), axis_names=("rays",),
                     devices=["cpu"] * 8).shape == (8,)
    with pytest.raises(ValueError, match="holds 4 shards"):
        make_mesh(shape=(2, 2), devices=["cpu"] * 8)
    assert MESH8.local_shards() == list(range(8))
    assert [shard_index(MESH8, (t, s)) for t in range(4) for s in range(2)] \
        == list(range(8))
    assert pad_to_multiple(1001, MESH8) == 1008
    assert [ray_range(1024, MESH8, k) for k in (0, 7)] == [(0, 128),
                                                           (896, 1024)]
    with pytest.raises(ValueError, match="divide evenly"):
        local_count(1001, MESH8)


FAMILIES = {
    # name: (sharded factory, unsharded factory, scene, cfg changes)
    "fused": (fused.make_sharded_fused_image_renderer,
              fused.make_fused_image_renderer, "cornell", {}),
    "dyn": (fused.make_sharded_dyn_image_renderer,
            fused.make_dyn_image_renderer, "ico", {}),
    "split": (fused.make_sharded_split_image_renderer,
              fused.make_split_fused_image_renderer, "cornell",
              dict(bsdf_samples=2)),
    "split-dyn": (lambda *a, **k: fused.make_sharded_split_image_renderer(
        *a, dyn=True, **k), fused.make_split_dyn_image_renderer, "ico",
        dict(bsdf_samples=2)),
    "regen": (fused.make_sharded_regen_image_renderer,
              fused.make_regen_image_renderer, "cornell", {}),
    "dyn-regen": (fused.make_sharded_dyn_regen_image_renderer,
                  fused.make_dyn_regen_image_renderer, "ico", {}),
}


@pytest.mark.parametrize("adjoint", ["stored", "retrace"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_equals_unsharded(family, adjoint, request):
    sharded, single, scene_name, kw = FAMILIES[family]
    scene, params, cam = request.getfixturevalue(scene_name)
    cfg = dataclasses.replace(CFG, **kw)
    if family.startswith("split"):
        cfg = dataclasses.replace(cfg, width=8, height=4)
    one = single(scene, cam, cfg, adjoint=adjoint, plain=True)
    many = sharded(scene, cam, cfg, MESH8, adjoint=adjoint, plain=True)
    _same(_image_and_grads(one, params, SEEDS),
          _image_and_grads(many, params, SEEDS))


def test_sharded_unbiased_and_tape_forms(cornell):
    scene, params, cam = cornell
    cfg_u = dataclasses.replace(CFG, unbiased=True, adjoint_samples=2)
    _same(_image_and_grads(fused.make_fused_image_renderer(
        scene, cam, cfg_u, plain=True), params, SEEDS),
        _image_and_grads(fused.make_sharded_fused_image_renderer(
            scene, cam, cfg_u, MESH8, plain=True), params, SEEDS))
    cfg_t = dataclasses.replace(CFG, spp_chunks=1)
    n = 16 * 8 * 8
    r = np.random.default_rng(5)
    cam_u = torch.as_tensor(r.uniform(size=(2, n)).astype(np.float32))
    tape = torch.as_tensor(r.uniform(size=(3, 3, n)).astype(np.float32))
    for adjoint in ("stored", "retrace"):
        _same(_image_and_grads(fused.make_fused_image_renderer(
            scene, cam, cfg_t, rng="tape", adjoint=adjoint, plain=True),
            params, cam_u, tape), _image_and_grads(
            fused.make_sharded_fused_image_renderer(
                scene, cam, cfg_t, MESH8, rng="tape", adjoint=adjoint,
                plain=True), params, cam_u, tape))


def test_wavefront_on_a_mesh(cornell):
    scene, params, cam = cornell
    one = make_renderer(scene, CFG, cam, backend="torch-wavefront")
    many = make_renderer(scene, CFG, cam, mesh=MESH8,
                         backend="torch-wavefront")
    _same(_image_and_grads(one, params, SEEDS),
          _image_and_grads(many, params, SEEDS))


def test_routing_on_a_mesh(cornell):
    scene, params, cam = cornell
    assert resolve_backend(scene, CFG, "auto", MESH8) == "torch-sharded"
    split = dataclasses.replace(CFG, bsdf_samples=2)
    assert resolve_backend(scene, split, "auto", MESH8) == \
        "torch-split-sharded"

    def on_card(num_shapes):
        return types.SimpleNamespace(
            device=torch.device("cuda"), num_shapes=num_shapes,
            shape_geo=torch.zeros(0))

    assert resolve_backend(on_card(64), CFG, "auto", MESH8) == "cuda-sharded"
    assert resolve_backend(on_card(65), CFG, "auto", MESH8) == \
        "cuda-dyn-sharded"
    assert resolve_backend(on_card(2048), split, "auto", MESH8) == \
        "cuda-split-dyn-sharded"
    assert resolve_backend(on_card(9), split, "auto", MESH8) == \
        "cuda-split-sharded"
    img = make_renderer(scene, CFG, cam, mesh=MESH8,
                        differentiable=False)(params, SEEDS)
    assert torch.equal(img, make_renderer(scene, CFG, cam,
                                          differentiable=False)(params,
                                                                SEEDS))
    for backend, err, match in (
            ("pallas-sharded", ValueError, "'pallas-sharded' is "
             "'cuda-sharded'"),
            ("pallas-split-dyn-sharded", ValueError,
             "'cuda-split-dyn-sharded'"),
            ("cuda-sharded", ValueError, "CUDA device"),
            ("torch", ValueError, "'torch-sharded'")):
        with pytest.raises(err, match=match):
            make_renderer(scene, CFG, cam, mesh=MESH8, backend=backend)
    with pytest.raises(ValueError, match="needs a device mesh"):
        make_renderer(scene, CFG, cam, backend="torch-regen-sharded")
    # 15*7 pixels, 15*7*2 rays a chunk: neither splits over 8 shards.
    odd = dataclasses.replace(CFG, width=15, height=7, spp=2, spp_chunks=1)
    with pytest.raises(ValueError, match="divide evenly"):
        make_renderer(scene, odd, cam, mesh=MESH8)
    with pytest.raises(ValueError, match="divide evenly"):
        make_renderer(scene, odd, cam, mesh=MESH8,
                      backend="torch-regen-sharded")


def test_plain_versions_at_a_ray_offset_give_the_slice(cornell, ico):
    """Shard k of 4 (ray_base = k * n / 4) of each family's tracer and
    collect tracer, the early-exit tracer and the regeneration tracers:
    the slice [k n / 4, (k + 1) n / 4) of the launch from 0, bit for
    bit; the retrace adjoints' partials add up to the whole's."""
    scene, params, cam = cornell
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    cc = mk.camera_consts(cam, CFG.width, CFG.height)
    n = 16 * 8 * 4
    q = n // 4
    g = torch.rand((3, 16 * 8), generator=torch.Generator().manual_seed(1))
    g_ray = g.repeat(1, 4)
    full = mk.fused_collect_plain(scene, cc, CFG, alb, emi, seeds=SEEDS,
                                  n_chunks=2)
    full_ee = ee.earlyexit_trace_plain(scene, cc, CFG, alb, emi, seeds=SEEDS,
                                       n_chunks=2)
    ds = dk.DynScene(ico[0])
    a2, e2 = albedo_table(ico[0], ico[1]), emission_table(ico[0], ico[1])
    full_dyn = dk.dyn_collect_plain(ds, cc, CFG, a2, e2, seeds=SEEDS,
                                    n_chunks=2)
    parts = []
    for k in range(4):
        kw = dict(seeds=SEEDS, n_chunks=2, ray_base=k * q, n_rays=q)
        part = mk.fused_collect(scene, None, cc, CFG, alb, emi, **kw)
        for x, y in zip(part, full):
            assert torch.equal(x, y[..., k * q:(k + 1) * q])
        assert torch.equal(ee.earlyexit_trace(scene, None, cc, CFG, alb, emi,
                                              **kw),
                           full_ee[:, k * q:(k + 1) * q])
        for x, y in zip(dk.dyn_collect(ds, cc, CFG, a2, e2, **kw), full_dyn):
            assert torch.equal(x, y[..., k * q:(k + 1) * q])
        parts.append(mk.fused_adjoint(scene, None, cc, CFG, alb, emi,
                                      g_ray[:, k * q:(k + 1) * q], **kw))
    whole = mk.fused_adjoint(scene, None, cc, CFG, alb, emi, g, seeds=SEEDS,
                             n_chunks=2)
    for k in range(2):
        np.testing.assert_allclose(sum(p[k] for p in parts).numpy(),
                                   whole[k].numpy(), **GRAD_TOL)
    npix = 16 * 8
    for fn, args in ((rg.regen_collect, (scene, None, cc, CFG, alb, emi)),
                     (dr.dyn_regen_collect, (ds, cc, CFG, a2, e2))):
        whole = fn(*args, SEEDS, n_chunks=2)
        for k in range(4):
            part = fn(*args, SEEDS, n_chunks=2, ray_base=k * npix // 4,
                      n_pix=npix // 4)
            for x, y in zip(part, whole):
                assert torch.equal(x, y[..., k * 32:(k + 1) * 32])


@pytest.mark.parametrize("n_split,depth", [(2, 4), (3, 3)])
def test_a_shards_split_tape_is_the_slice_of_the_chunks(n_split, depth):
    """`split_prefix_tape(..., lanes=)` draws a shard's lanes alone, bit
    for bit the slice of the whole chunk's: shards of whole leaves (S
    dividing M), of parts of leaves, and single lanes."""
    cfg = RenderConfig(width=6, height=4, spp=4, spp_chunks=2,
                       max_depth=depth, bsdf_samples=n_split)
    cam_u, tape = fused.split_prefix_tape([5, -7], 1, cfg)
    n = cam_u.shape[1]
    n_cam = n // n_split ** (depth - 1)
    cuts = [(k * n // s, (k + 1) * n // s) for s in (n_split, 3, 8)
            for k in range(s)] + [(n_cam, 3 * n_cam), (5, 77), (17, 18)]
    for a, b in cuts:
        part = fused.split_prefix_tape([5, -7], 1, cfg, lanes=(a, b))
        assert torch.equal(part[0], cam_u[:, a:b])
        assert torch.equal(part[1], tape[..., a:b])


@pytest.mark.parametrize("n_split,depth", [(2, 4), (3, 3)])
def test_a_lane_range_follows_the_prefix_formula(n_split, depth):
    """Lane l = m * N + r of `prefix_tape(..., lanes_outer=True, lanes=)`
    reads at bounce b, slot k the draw hash_uniform(seed, pix[r], s[r] * M
    + m0, b, k) of its group, m0 = m - m % size (size the lanes that share
    the slot: n^(D-1-b) for the roulette, n^(D-2-b) for (u1, u2), one at
    the last bounce), over ranges in one leaf, across leaves and whole."""
    M = split_lanes(n_split, depth)
    N = 10
    pix = torch.arange(N, dtype=torch.int64) * 7
    s = torch.arange(N, dtype=torch.int64) % 3
    for a, b in ((0, N * M), (3, 8), (N, 3 * N), (7, N * M - 4)):
        got = prefix_tape(9, pix, s, n_split, depth, lanes_outer=True,
                          lanes=(a, b))
        lane = torch.arange(a, b)
        m, r = lane // N, lane % N
        for bounce in range(depth):
            for k in range(3):
                size = M // min(n_split ** (bounce + (k > 0)), M)
                want = hash_uniform(9, pix[r], s[r] * M + m - m % size,
                                    bounce, k)
                assert torch.equal(got[bounce, k], want), (a, b, bounce, k)


@pytest.mark.parametrize("mesh", [None, MESH8], ids=["one", "mesh8"])
@pytest.mark.parametrize("family", ["fused", "regen"])
def test_the_stored_rows_are_freed_by_the_backward(family, mesh, cornell):
    """The stored adjoint keeps its residual rows as saved tensors: a
    saved-tensor hook sees them, and the backward frees them while the
    image (and so its graph) is still held."""
    scene, params, cam = cornell
    sharded, single = FAMILIES[family][:2]
    render = (single(scene, cam, CFG, adjoint="stored", plain=True)
              if mesh is None else
              sharded(scene, cam, CFG, mesh, adjoint="stored", plain=True))
    p = _leaves(params)
    seen = []

    def pack(t):
        if t is not p.albedo and t is not p.emission:
            seen.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        img = render(p, SEEDS)
    assert len(seen) >= 2 * (1 if mesh is None else MESH8.size)
    (img ** 2).sum().backward()
    gc.collect()
    assert img.grad_fn is not None
    assert all(ref() is None for ref in seen)
