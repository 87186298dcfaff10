"""drt_tpu_torch.ops.dynkernel on the CPU, where the wrappers of the
memory-resident kernels run their plain PyTorch versions, and
`fused.make_dyn_image_renderer` over them.

References, cheapest first: the JAX wavefront path (`camera_rays` +
`trace_rays` on one tape, and `jax.vjp` of it), which is what
tests/test_dynkernel.py holds the Pallas dyn kernels against (radiance
rtol 2e-5 / atol 2e-6, gradients rtol 1e-4 / atol 1e-5); the Pallas dyn
kernels themselves in interpret mode, once per module on one tile of the
glossy scene (tables rtol 2e-5 / atol 1e-7, where both sides run the
kernels' op order); and the port's own `adjoint.make_diff_renderer` fed
`hash_tapes` for the internal-RNG and unbiased forms. Float32 throughout.
The kernels themselves are tested on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import dynkernel as jax_dk
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch import fused
from drt_tpu_torch.adjoint import make_diff_renderer
from drt_tpu_torch.camera import camera_rays, pixel_grid
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.models import gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_tapes
from drt_tpu_torch.parallel.render import (MAX_DYN_SHAPES, make_renderer,
                                           resolve_backend)
from drt_tpu_torch.scene import (TRIANGLE, Params, SceneBuilder,
                                 albedo_table, emission_table, from_numpy)

SCENES = {
    "cbox": lambda: jax_cbox.build(dtype=jnp.float32),
    "glossy": lambda: jax_gallery.build_glossy(dtype=jnp.float32),
    "tri": lambda: jax_gallery.build_tri(dtype=jnp.float32),
    "mesh1": lambda: jax_gallery.build_mesh(level=1, dtype=jnp.float32),
}
TOL = dict(rtol=2e-5, atol=2e-6)
FAST_TOL = dict(rtol=2e-3, atol=1e-4)
XLA_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
KERNEL_GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
# 512 rays, the shape of tests/test_dynkernel.py.
CFG = RenderConfig(width=16, height=8, spp=4, max_depth=4)
N = CFG.width * CFG.height * CFG.spp


def _jcfg(cfg=CFG, **kw):
    return JaxConfig(**{**dataclasses.asdict(cfg), **kw})


def _both(name):
    js, jp, jc = SCENES[name]()
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


def _inputs(seed=0, cfg=CFG):
    n = cfg.width * cfg.height * cfg.spp
    r = np.random.default_rng(seed)
    return (r.uniform(size=(2, n)).astype(np.float32),
            r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32),
            r.uniform(0.5, 1.5, size=(3, n)).astype(np.float32))


def _tables(scene, params):
    return albedo_table(scene, params), emission_table(scene, params)


def _leaves(params):
    return Params(*(p.clone().requires_grad_() for p in params))


def _matters(sc, rrow):
    """Bounce-slots with no earlier live bounce of weight sc == 0: what
    comes after is cut off from the estimator and decided by an ulp (see
    tests/test_torch_adjoint.py)."""
    zero = (sc == 0) & ((rrow >> 16) > 0)
    return (np.cumsum(zero, axis=0) - zero) == 0


@pytest.fixture(scope="module", params=sorted(SCENES))
def xla(request):
    """Per scene: radiance and parameter gradients of the JAX wavefront
    path on one numpy tape (one jit of forward and VJP), and the port's
    plain versions on the same numbers."""
    (js, jp, jc), (scene, params, cam) = _both(request.param)
    cam_u, tape, g = _inputs()
    xy = jnp.tile(jax_pixel_grid(CFG.width, CFG.height), (CFG.spp, 1))
    o, d, _ = jax_camera_rays(jc, CFG.width, CFG.height, xy,
                              jnp.asarray(cam_u).T)

    @jax.jit
    def ref_fn(p, gx, gy, gz):
        L, vjp = jax.vjp(lambda q: jax_trace_rays(
            q, js, o, d, None, _jcfg(), tape=jnp.asarray(tape)), p)
        return L, vjp(JV3(gx, gy, gz))[0]

    L, grads = ref_fn(jp, *map(jnp.asarray, g))
    ref = dict(L=np.stack([np.asarray(c) for c in L]),
               da=np.asarray(grads.albedo), de=np.asarray(grads.emission))

    alb, emi = _tables(scene, params)
    tcu, ttp, tg = (torch.as_tensor(x) for x in (cam_u, tape, g))
    ds = dk.DynScene(scene)
    before = mk.launch_counts()
    got = {}
    for fm in (False, True):
        kw = dict(rng="tape", fastmath=fm)
        L = dk.make_dyn_tracer(ds, cam, CFG, **kw)(alb, emi, tcu, ttp)
        Lc, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, CFG, **kw)(
            alb, emi, tcu, ttp)
        got[fm] = dict(
            L=L, Lc=Lc, rsc=rsc, rrow=rrow,
            sweep=dk.make_dyn_sweep_adjoint(ds, CFG)(alb, emi, rsc, rrow,
                                                     tg),
            adjoint=dk.make_dyn_adjoint(ds, cam, CFG, **kw)(alb, emi, tcu,
                                                            ttp, tg))
    assert mk.launch_counts() == before  # CPU tensors launch nothing
    return got, ref, params


def test_plain_tracer_matches_jax_trace_rays(xla):
    got, ref, _ = xla
    assert ref["L"].mean() > 0 and got[False]["L"].shape == (3, N)
    np.testing.assert_allclose(got[False]["L"].numpy(), ref["L"], **TOL)


def test_plain_fast_matches_exact(xla):
    """The ratio form of the nearest hit, rsqrt and the cancelled shading
    quotients keep the estimator (tests/test_dynkernel.py:365-390)."""
    got, _, _ = xla
    np.testing.assert_allclose(got[True]["L"].numpy(),
                               got[False]["L"].numpy(), **FAST_TOL)


@pytest.mark.parametrize("fastmath", [False, True])
def test_plain_collect_and_adjoint_are_bit_consistent(xla, fastmath):
    """Collect radiance == tracer radiance and retrace adjoint ==
    sweep(collect), bit for bit; residual rows are packed 8 bits each with
    the sentinel rows on dead lanes."""
    got, _, params = xla
    r = got[fastmath]
    assert torch.equal(r["Lc"], r["L"])
    assert r["rsc"].shape == r["rrow"].shape == (CFG.max_depth, N)
    assert r["rrow"].dtype == torch.int32
    for a, b in zip(r["adjoint"], r["sweep"]):
        assert torch.equal(a, b) and (a[-1] == 0).all()
    rrow = r["rrow"]
    live = (rrow >> 16) > 0
    dead = (params.albedo.shape[0]) | (params.emission.shape[0] << 8)
    assert live.any() and (~live).any()
    assert (rrow[~live] == dead).all() and (r["rsc"][~live] == 0).all()
    assert ((rrow[live] & 255) <= params.albedo.shape[0]).all()


def test_plain_adjoint_matches_jax_grad(xla):
    got, ref, params = xla
    k, l = params.albedo.shape[0], params.emission.shape[0]
    da, de = (t.numpy() for t in got[False]["adjoint"])
    assert np.abs(ref["da"]).max() > 1e-3 and np.abs(ref["de"]).max() > 0
    assert da.shape == (k + 1, 3) and de.shape == (l + 1, 3)
    np.testing.assert_allclose(da[:k], ref["da"], **XLA_GRAD_TOL)
    np.testing.assert_allclose(de[:l], ref["de"], **XLA_GRAD_TOL)


# One tile of 1024 lanes (tile_rows=8), depth 3: each interpret-mode call
# costs seconds whatever the size, so each kernel is built and run once.
CFG_P = RenderConfig(width=16, height=8, spp=4, max_depth=3)


@pytest.fixture(scope="module")
def pallas():
    """The four Pallas dyn kernels in interpret mode on the glossy scene
    (planes, a sphere light, diffuse, specular with a per-ray exponent and
    mirror materials), and the port's plain versions on the same inputs.
    The sweep is fed the JAX kernel's residuals, so that only the
    summation order differs."""
    (js, jp, jc), (scene, params, cam) = _both("glossy")
    cam_u, tape, g = _inputs(5, CFG_P)
    jds = jax_dk.DynScene(js)
    kw = dict(tile_rows=8, rng="tape", interpret=True, n_rays=N)
    ja, je = jax_albedo_table(js, jp), jax_emission_table(js, jp)
    jcu, jtp = jnp.asarray(cam_u), jnp.asarray(tape)
    jg = JV3(*map(jnp.asarray, g))
    cfg = _jcfg(CFG_P)
    ref = {}
    ref["L"] = np.stack([np.asarray(c) for c in jax_dk.make_dyn_tracer(
        jds, jc, cfg, **kw)(ja, je, jds.operands, jcu, jtp)])
    Lc, rsc, rrow = jax_dk.make_dyn_collect_tracer(jds, jc, cfg, **kw)(
        ja, je, jds.operands, jcu, jtp)
    ref.update(Lc=np.stack([np.asarray(c) for c in Lc]),
               rsc=np.asarray(rsc), rrow=np.asarray(rrow))
    ref["sweep"] = [np.asarray(x) for x in jax_dk.make_dyn_sweep_adjoint(
        jds, cfg, tile_rows=8, interpret=True)(ja, je, rsc, rrow, jg)]
    ref["adjoint"] = [np.asarray(x) for x in jax_dk.make_dyn_adjoint(
        jds, jc, cfg, **kw)(ja, je, jds.operands, jcu, jtp, jg.x, jg.y,
                            jg.z)]

    alb, emi = _tables(scene, params)
    tcu, ttp, tg = (torch.as_tensor(x) for x in (cam_u, tape, g))
    ds = dk.DynScene(scene)
    got = {}
    got["L"] = dk.make_dyn_tracer(ds, cam, CFG_P, rng="tape")(
        alb, emi, tcu, ttp).numpy()
    _, rsc, rrow = dk.make_dyn_collect_tracer(ds, cam, CFG_P, rng="tape")(
        alb, emi, tcu, ttp)
    got.update(rsc=rsc.numpy(), rrow=rrow.numpy())
    got["sweep"] = [x.numpy() for x in dk.make_dyn_sweep_adjoint(ds, CFG_P)(
        alb, emi, torch.as_tensor(ref["rsc"].copy()),
        torch.as_tensor(ref["rrow"].copy()), tg)]
    got["adjoint"] = [x.numpy() for x in dk.make_dyn_adjoint(
        ds, cam, CFG_P, rng="tape")(alb, emi, tcu, ttp, tg)]
    return got, ref


def test_plain_tracer_matches_pallas_dyn_tracer(pallas):
    got, ref = pallas
    assert ref["L"].mean() > 0
    np.testing.assert_array_equal(ref["Lc"], ref["L"])
    np.testing.assert_allclose(got["L"], ref["L"], **TOL)


def test_plain_residuals_match_pallas_collect_tracer(pallas):
    got, ref = pallas
    assert got["rrow"].dtype == np.int32
    assert got["rsc"].shape == ref["rsc"].shape == (CFG_P.max_depth, N)
    m = _matters(ref["rsc"], ref["rrow"])
    assert m.mean() > 0.9 and ((ref["rrow"] >> 16) > 0).any()
    # Rows and live bit, on the slots that matter.
    np.testing.assert_array_equal(got["rrow"][m], ref["rrow"][m])
    # The specular weight divides by sqrt(1 - cos_h^2), which loses digits
    # as cos_h -> 1: the two libms' pow may differ by more than TOL on a
    # few glossy slots (tests/test_torch_fused_vjp.py).
    close = np.isclose(got["rsc"][m], ref["rsc"][m], **TOL)
    assert (~close).mean() <= 5e-3
    np.testing.assert_allclose(got["rsc"][m], ref["rsc"][m], **FAST_TOL)


@pytest.mark.parametrize("which", ["sweep", "adjoint"])
def test_plain_adjoints_match_pallas(pallas, which):
    got, ref = pallas
    for g, r in zip(got[which], ref[which]):
        assert g.shape == r.shape and np.abs(r).max() > 0
        assert (g[-1] == 0).all()  # the sentinel row
        np.testing.assert_allclose(g, r, **KERNEL_GRAD_TOL)


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("level", [1, 2])
def test_culling_and_levels_give_the_same_bits(level, fastmath):
    """Cluster culling only skips work: two-level, one-level and no
    clustering give bit-equal radiance and gradients on these rays. In the
    exact variant the winner is the (t, original index) minimum whatever
    the visit order, and padded slots never win
    (tests/test_dynkernel.py:246-362); the fast variant's order is not
    transitive on near-ties, which random camera rays rarely meet (rays
    aimed at mesh vertices do: test_nearest_hit_across_layouts). Level 2
    has 20 leaves padded to 24 under 3 super boxes; level 1 has 5 leaves
    and no second level."""
    scene, params, cam = gallery.build_mesh(level, device="cpu")
    alb, emi = _tables(scene, params)
    cam_u, tape, g = (torch.as_tensor(x) for x in _inputs(3))
    variants = (dk.DynScene(scene), dk.DynScene(scene, super_m=1),
                dk.DynScene(scene, cluster_min_tris=10 ** 9),
                dk.DynScene(scene, cluster_k=8, super_m=4))
    assert variants[0].n_clusters > 0 and variants[1].n_super == 0
    assert (variants[0].n_super > 0) == (level == 2)
    assert variants[2].n_clusters == 0 and variants[3].n_super > 0
    outs = []
    for ds in variants:
        kw = dict(rng="tape", fastmath=fastmath)
        L = dk.make_dyn_tracer(ds, cam, CFG, **kw)(alb, emi, cam_u, tape)
        da, de = dk.make_dyn_adjoint(ds, cam, CFG, **kw)(alb, emi, cam_u,
                                                         tape, g)
        outs.append((L, da, de))
    assert outs[0][0].mean() > 0
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def _rays_at_mesh_vertices(scene, seed):
    """Rays from points near the box centre (inside the icosphere) towards
    each face's first vertex and its three edge midpoints: 4 per face, and
    each target is shared by two or more faces."""
    geo = scene.shape_geo.numpy().astype(np.float64)
    tri = geo[scene.shape_type.numpy() == TRIANGLE]
    v0, v1, v2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    targets = np.concatenate([v0, (v0 + v1) / 2, (v1 + v2) / 2,
                              (v2 + v0) / 2])
    r = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 3.25]) + r.uniform(-0.05, 0.05, targets.shape)
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(tuple(torch.from_numpy(np.ascontiguousarray(a[:, k],
                                                             np.float32))
                       for k in range(3)) for a in (o, d))


@pytest.mark.parametrize("fastmath", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_nearest_hit_across_layouts(level, fastmath):
    """The nearest hit of rays aimed at the mesh's vertices and edge
    midpoints, where several triangles tie, on the default, one-level,
    unclustered and 8-triangle-leaf layouts. The exact variant gives the
    same (t, winner) bits on all of them: its winner is the (t, original
    index) minimum. The fast variant compares candidates by rounded
    cross-products, an order that is not transitive on near-ties, so its
    winner may depend on the visit order (as in the JAX kernel); the
    kernels keep one visit order, so they agree with each other on one
    layout. Here at most 0.5% of the rays differ across layouts, and then
    both winners' t agree to 2e-7 relative."""
    scene, _, _ = gallery.build_mesh(level, device="cpu")
    layouts = (dk.DynScene(scene), dk.DynScene(scene, super_m=1),
               dk.DynScene(scene, cluster_min_tris=10 ** 9),
               dk.DynScene(scene, cluster_k=8))
    o, d = _rays_at_mesh_vertices(scene, seed=level)
    n = d[0].shape[0]
    assert n == 4 * layouts[0].n_tri
    assert layouts[0].n_super > 0 and layouts[1].n_super == 0
    assert layouts[2].n_clusters == 0 and layouts[3].cluster_k == 8
    hits = []
    for ds in layouts:
        t, hit, row = dk.dyn_intersect(ds, o, d, fastmath=fastmath)
        assert hit.all()
        hits.append((t, ds.operands[2][row]))
    t_ref, w_ref = hits[0]
    for t, w in hits[1:]:
        differ = (t != t_ref) | (w != w_ref)
        if not fastmath:
            assert not differ.any()
            continue
        assert differ.sum() <= 0.005 * n
        assert ((t - t_ref).abs() <= 2e-7 * t_ref).all()


def _rays_at(target, n=64, seed=0):
    """n rays from points around the origin towards jittered points near
    `target`."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.2, 0.2, size=(3, n)).astype(np.float32)
    d = (np.asarray(target, np.float32)[:, None]
         + r.uniform(-0.3, 0.3, size=(3, n)).astype(np.float32) - o)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (tuple(torch.as_tensor(c) for c in o),
            tuple(torch.as_tensor(c) for c in d.astype(np.float32)))


@pytest.mark.parametrize("fastmath", [False, True])
def test_tie_goes_to_the_lower_original_index(fastmath):
    """Two coincident triangles: whichever is visited first, the one with
    the lower original index wins, as the reference's keep-first scan
    decides (pathtracer.hpp:78-80)."""
    b = SceneBuilder()
    first = b.diffuse(b.albedo_param([0.9, 0.1, 0.1]))
    second = b.diffuse(b.albedo_param([0.1, 0.9, 0.1]))
    tri = ([-2.0, -2.0, 4.0], [2.0, -2.0, 4.0], [0.0, 2.5, 4.0])
    b.triangle(*tri, first)
    b.triangle(*tri, second)
    b.plane([0.0, 0.0, -1.0], -6.0, first)
    scene, _ = b.build(device="cpu")
    ds = dk.DynScene(scene)
    assert ds.operands[2].tolist() == [2, 0, 1]  # plane, then the two
    o, d = _rays_at([0.0, 0.0, 4.0])
    t, hit, row = dk.dyn_intersect(ds, o, d, fastmath=fastmath)
    assert hit.all() and (ds.operands[2][row] == 0).all()
    # Visit them in the other order: swap the two triangle rows.
    swapped = dk.DynScene(scene)
    order = [0, 2, 1]
    swapped.operands_numpy = tuple(
        a[order] if a.shape[0] == 3 else a for a in ds.operands_numpy)
    swapped.operands = tuple(torch.as_tensor(a)
                             for a in swapped.operands_numpy)
    assert swapped.operands[2].tolist() == [2, 1, 0]
    t2, hit2, row2 = dk.dyn_intersect(swapped, o, d, fastmath=fastmath)
    assert hit2.all() and (row2 == 2).all()
    assert (swapped.operands[2][row2] == 0).all() and torch.equal(t2, t)


@pytest.mark.parametrize("fastmath", [False, True])
def test_padded_rows_never_produce_a_hit(fastmath):
    """Level 2: 20 leaves padded to 24 with inverted boxes, which a min/max
    slab test does not reject; their triangle slots are degenerate and the
    leaf rows are skipped by index."""
    scene, _, _ = gallery.build_mesh(2, device="cpu")
    ds = dk.DynScene(scene)
    assert ds.n_clusters_pad > ds.n_clusters
    t0 = ds.n_plane + ds.n_sphere
    o, d = _rays_at([0.0, -0.6, 3.8], n=256, seed=1)
    stats = {}
    t, hit, row = dk.dyn_intersect(ds, o, d, fastmath=fastmath, stats=stats)
    orig = ds.operands[2][row]
    assert hit.all() and (orig < ds.n_shapes).all()
    assert (row < t0 + ds.n_clusters * ds.cluster_k).all()
    assert (row >= t0).any()  # some rays do hit the mesh
    # Each ray tested 3 super boxes and the leaves of those it entered,
    # never a padded leaf.
    assert stats["rays"] == 256
    assert 256 * ds.n_super <= stats["box"] <= 256 * (
        ds.n_super + ds.n_clusters)
    assert 0 < stats["tri"] < 256 * ds.n_tri
    # The same hits with culling off.
    off = dk.DynScene(scene, cluster_min_tris=10 ** 9)
    t_off, _, row_off = dk.dyn_intersect(off, o, d, fastmath=fastmath)
    assert torch.equal(t, t_off)
    assert torch.equal(orig, off.operands[2][row_off])


CFG_T = RenderConfig(width=16, height=8, spp=1, max_depth=3)


@pytest.fixture(scope="module")
def tape_images():
    """`make_dyn_image_renderer` in tape mode on the 87-shape mesh, stored
    and retrace, and the JAX wavefront image and its gradient."""
    (js, jp, jc), (scene, params, cam) = _both("mesh1")
    cam_u, tape, _ = _inputs(7, CFG_T)
    n = CFG_T.width * CFG_T.height
    xy = jax_pixel_grid(CFG_T.width, CFG_T.height)
    o, d, _ = jax_camera_rays(jc, CFG_T.width, CFG_T.height, xy,
                              jnp.asarray(cam_u).T)

    def img_ref(p):
        L = jax_trace_rays(p, js, o, d, None, _jcfg(CFG_T),
                           tape=jnp.asarray(tape))
        return jnp.stack([c.reshape(CFG_T.height, CFG_T.width) for c in L],
                         axis=-1)

    img, grads = jax.jit(lambda p: (img_ref(p), jax.grad(
        lambda q: img_ref(q).sum())(p)))(jp)
    ref = (np.asarray(img), np.asarray(grads.albedo),
           np.asarray(grads.emission))
    got = {}
    for adjoint in ("stored", "retrace"):
        render = fused.make_dyn_image_renderer(scene, cam, CFG_T, rng="tape",
                                               adjoint=adjoint)
        p = _leaves(params)
        out = render(p, torch.as_tensor(cam_u), torch.as_tensor(tape))
        assert out.grad_fn is not None and out.shape == (8, 16, 3)
        out.sum().backward()
        got[adjoint] = (out.detach(), p.albedo.grad, p.emission.grad)
    assert n == 128
    return got, ref


@pytest.mark.parametrize("adjoint", ["stored", "retrace"])
def test_tape_image_renderer_matches_jax(tape_images, adjoint):
    """tests/test_dynkernel.py:163-178 and its tolerances."""
    got, (img, da, de) = tape_images
    out, g_alb, g_emi = got[adjoint]
    assert img.mean() > 0 and np.abs(da).max() > 1e-3
    np.testing.assert_allclose(out.numpy(), img, **TOL)
    np.testing.assert_allclose(g_alb.numpy(), da, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(g_emi.numpy(), de, rtol=2e-4, atol=1e-5)


def test_tape_image_renderer_stored_equals_retrace(tape_images):
    got, _ = tape_images
    for s, r in zip(got["stored"], got["retrace"]):
        assert torch.equal(s, r)


CFG_I = RenderConfig(width=16, height=8, spp=4, spp_chunks=2, max_depth=4)
SEEDS = [123, -456]


def _port_internal_grads(scene, params, cam, unbiased_samples=0):
    """Image and grads of loss = sum(img * W) for the internal-RNG
    renderer, rebuilt from the port's wavefront path: per chunk c, hash
    tapes at sample_base = c * spp_c through camera_rays and the
    tape-driven make_diff_renderer. With unbiased_samples > 0 the backward
    tapes come from the salted bounce seed of each adjoint sample and the
    grads are averaged."""
    cfg = CFG_I
    npix, spp_c = cfg.width * cfg.height, cfg.spp // cfg.spp_chunks
    w_img = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, size=(cfg.height, cfg.width, 3)).astype(np.float32))
    one = dataclasses.replace(cfg, spp=spp_c, spp_chunks=1,
                              unbiased=bool(unbiased_samples))
    diff = make_diff_renderer(scene, one, use_tape=True,
                              bwd_tape=bool(unbiased_samples))
    xy = pixel_grid(cfg.width, cfg.height).repeat(spp_c, 1)
    p = _leaves(params)
    img = 0.0
    for s in range(max(unbiased_samples, 1)):
        for c in range(cfg.spp_chunks):
            cam_u, tape = hash_tapes(SEEDS, npix, spp_c, cfg.max_depth,
                                     sample_base=c * spp_c)
            o, d, _ = camera_rays(cam, cfg.width, cfg.height, xy, cam_u.T)
            extra = ()
            if unbiased_samples:
                extra = (hash_tapes(fused._salted(SEEDS, s), npix, spp_c,
                                    cfg.max_depth,
                                    sample_base=c * spp_c)[1],)
            L = torch.stack(list(diff(p, o, d, tape, *extra)))
            img = img + fused._chunk_img(L, spp_c, cfg.height, cfg.width)
    img = img / (cfg.spp_chunks * max(unbiased_samples, 1))
    (img * w_img).sum().backward()
    return w_img, img.detach(), p.albedo.grad, p.emission.grad


@pytest.mark.parametrize("mode", ["stored", "retrace", "unbiased"])
def test_internal_rng_renderer_matches_wavefront_on_hash_tapes(mode):
    """The internal RNG draws chunk c's samples from c * spp_c on, and
    unbiased mode retraces each adjoint sample on the salted bounce seed:
    image and gradients equal the port's wavefront renderer fed
    `hash_tapes` (rtol 1e-4 / atol 1e-5 on the gradients: another
    association of the throughput product and another summation order)."""
    _, (scene, params, cam) = _both("mesh1")
    samples = 2 if mode == "unbiased" else 0
    w_img, ref_img, da, de = _port_internal_grads(scene, params, cam,
                                                  samples)
    cfg, kw = CFG_I, dict(adjoint=mode)
    if mode == "unbiased":
        cfg = dataclasses.replace(CFG_I, unbiased=True, adjoint_samples=2)
        kw = {}
    render = fused.make_dyn_image_renderer(scene, cam, cfg, fastmath=False,
                                           **kw)
    p = _leaves(params)
    img = render(p, torch.tensor(SEEDS, dtype=torch.int32))
    (img * w_img).sum().backward()
    assert da.abs().max() > 0 and de.abs().max() > 0
    np.testing.assert_allclose(img.detach().numpy(), ref_img.numpy(), **TOL)
    np.testing.assert_allclose(p.albedo.grad.numpy(), da.numpy(),
                               **XLA_GRAD_TOL)
    np.testing.assert_allclose(p.emission.grad.numpy(), de.numpy(),
                               **XLA_GRAD_TOL)


def test_dyn_and_fused_families_trace_the_same_paths():
    """The same seeds give the same samples in both kernel families: on a
    scene both take, the plain versions agree ray for ray; a prebuilt
    DynScene with the caller's own cluster_k renders the same image."""
    _, (scene, params, cam) = _both("tri")
    alb, emi = _tables(scene, params)
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    a = dk.make_dyn_tracer(scene, cam, CFG_I, n_chunks=2)(alb, emi, seeds)
    b = mk.make_fused_tracer(scene, cam, CFG_I, n_chunks=2)(alb, emi, seeds)
    assert a.mean() > 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    mesh, mesh_params, mesh_cam = gallery.build_mesh(1, device="cpu")
    img = fused.make_dyn_image_renderer(mesh, mesh_cam, CFG_I)(mesh_params,
                                                               seeds)
    own = fused.make_dyn_image_renderer(
        dk.DynScene(mesh, cluster_k=8), mesh_cam, CFG_I)(mesh_params, seeds)
    assert img.grad_fn is None and torch.equal(img, own)
    for bad in (dict(spp_chunks=2), dict(unbiased=True)):
        with pytest.raises(ValueError, match="tape-mode"):
            fused.make_dyn_image_renderer(mesh, mesh_cam, RenderConfig(
                width=8, height=6, spp=2, max_depth=3, **bad), rng="tape")


def test_routing_of_mesh_scenes():
    """A CPU scene resolves to "torch" whatever its size; "torch-dyn" runs
    the plain versions of the memory-resident kernels on it and gives the
    "torch" image (the same samples); "cuda-dyn" needs a card. On a card,
    "auto" takes "cuda" up to 64 shapes, "cuda-dyn" up to 2048, and raises
    above."""
    scene, params, cam = gallery.build_mesh(1, device="cpu")
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    assert resolve_backend(scene, CFG_I) == "torch"
    img = make_renderer(scene, CFG_I, cam, differentiable=False)(params,
                                                                 seeds)
    before = mk.launch_counts()
    p = _leaves(params)
    dyn = make_renderer(scene, CFG_I, cam, backend="torch-dyn")(p, seeds)
    dyn.mean().backward()
    assert mk.launch_counts() == before
    assert set(before) >= {"dyn_tracer", "dyn_collect", "dyn_sweep",
                           "dyn_adjoint"}
    assert p.albedo.grad.abs().max() > 0 and p.emission.grad.abs().max() > 0
    np.testing.assert_allclose(dyn.detach().numpy(), img.numpy(), **FAST_TOL)
    with pytest.raises(ValueError, match="'cuda-dyn' needs the scene on a "
                       "CUDA device"):
        make_renderer(scene, CFG_I, cam, backend="cuda-dyn")

    def on_card(num_shapes, dtype=torch.float32):
        return types.SimpleNamespace(
            device=torch.device("cuda"), num_shapes=num_shapes,
            shape_geo=torch.zeros(0, dtype=dtype))

    assert MAX_DYN_SHAPES == dk.MAX_DYN_SHAPES == 2048
    assert resolve_backend(on_card(mk.MAX_SHAPES), CFG_I) == "cuda"
    assert resolve_backend(on_card(mk.MAX_SHAPES + 1), CFG_I) == "cuda-dyn"
    assert resolve_backend(on_card(MAX_DYN_SHAPES), CFG_I) == "cuda-dyn"
    with pytest.raises(ValueError, match="backend='torch-wavefront'"):
        resolve_backend(on_card(MAX_DYN_SHAPES + 1), CFG_I)
    with pytest.raises(ValueError, match="float32"):
        resolve_backend(on_card(100, torch.float64), CFG_I)


def test_wrappers_run_plain_versions_only_on_cpu_and_check_limits():
    """CPU tensors take the plain versions without counting a launch; any
    other device than cpu or cuda is refused; the limits of the CUDA
    branch that need no card (they are checked before a library loads):
    2048 shapes and 256 table rows. Tables whose gradient accumulator does
    not fit a block's shared memory (above MAX_GRAD_ROWS real rows, up to
    255 + 255) are taken, by the adjoint kernels' deep forms."""
    scene, params, cam = gallery.build_mesh(1, device="cpu")
    ds = dk.DynScene(scene)
    alb, emi = _tables(scene, params)
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=2)
    cc = mk.camera_consts(cam, 4, 4)
    before = mk.launch_counts()
    L = dk.dyn_trace(ds, cc, cfg, alb, emi, seeds=[1, 2])
    assert L.shape == (3, 16) and mk.launch_counts() == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        dk.dyn_trace(ds, cc, cfg, alb.to("meta"), emi.to("meta"),
                     seeds=[1, 2])

    b = SceneBuilder()
    mat = b.diffuse(b.albedo_param([0.5, 0.5, 0.5]))
    for k in range(MAX_DYN_SHAPES + 1):
        b.plane([0.0, 1.0, 0.0], -1.0 - k, mat)
    with pytest.raises(ValueError, match="2049 shapes exceed the 2048"):
        dk._scene_structs(dk.DynScene(b.build(device="cpu")[0]), alb.device)

    wide = torch.zeros((dk._ROW_CAP + 1, 3))
    with pytest.raises(ValueError, match="pack rows into 8 bits: 257 albedo"):
        dk.dyn_collect(ds, cc, cfg, wide, emi, seeds=[1, 2])
    with pytest.raises(ValueError, match="1..256 rows"):
        dk._dyn_config(cfg, ds.n_shapes, wide, emi)
    for n_rows in (dk.MAX_GRAD_ROWS + 1, dk._ROW_CAP):
        rows = torch.zeros((n_rows, 3))
        tcfg = dk._dyn_config(cfg, ds.n_shapes, rows, rows)
        partials, _, _ = mk._adjoint_buffers(cfg, tcfg, torch.zeros(3, 16),
                                             alb.device)
        assert partials.shape == (1, (n_rows - 1) * 6)
    tcfg = dk._dyn_config(cfg, ds.n_shapes, alb, emi)
    partials, da, de = mk._adjoint_buffers(cfg, tcfg, torch.zeros(3, 16),
                                           alb.device)
    assert partials.shape == (1, (alb.shape[0] + emi.shape[0] - 2) * 3)
    assert da.shape == alb.shape and de.shape == emi.shape
    huge = RenderConfig(width=8192, height=8192, spp=8, max_depth=5)
    with pytest.raises(ValueError, match="32-bit indexing"):
        dk._dyn_config(huge, ds.n_shapes, alb, emi)
