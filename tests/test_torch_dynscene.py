"""drt_tpu_torch's host side of the memory-resident kernels against the
JAX package: `models.gallery.build_mesh` array for array, and
`ops.dynkernel.DynScene`, whose operands must equal
`drt_tpu.ops.dynkernel.DynScene`'s bit for bit so that both packages trace
the same scene. Everything here is numpy on both sides; no kernel runs."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import dynkernel as jax_dk
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.scene import SceneBuilder, from_numpy

JAX_SCENES = {
    "cbox": lambda: jax_cbox.build(dtype=jnp.float32),
    "glossy": lambda: jax_gallery.build_glossy(dtype=jnp.float32),
    "tri": lambda: jax_gallery.build_tri(dtype=jnp.float32),
    "mesh1": lambda: jax_gallery.build_mesh(level=1, dtype=jnp.float32),
    "mesh2": lambda: jax_gallery.build_mesh(level=2, dtype=jnp.float32),
    "mesh3": lambda: jax_gallery.build_mesh(level=3, dtype=jnp.float32),
}
PORT_SCENES = {
    "cbox": partial(cbox.build, device="cpu"),
    "glossy": partial(gallery.build_glossy, device="cpu"),
    "tri": partial(gallery.build_tri, device="cpu"),
    "mesh1": lambda: gallery.build_mesh(level=1, device="cpu"),
    "mesh2": lambda: gallery.build_mesh(level=2, device="cpu"),
    "mesh3": lambda: gallery.build_mesh(level=3, device="cpu"),
}
FACTS = ("n_plane", "n_sphere", "n_tri", "n_tri_pad", "n_shapes",
         "cluster_k", "n_clusters", "n_clusters_pad", "n_super", "super_m",
         "have_diffuse", "have_specular", "have_mirror")


def _assert_same(ds, jds):
    for name in FACTS:
        assert getattr(ds, name) == getattr(jds, name), name
    assert len(ds.operands) == len(jds.operands) == 6
    for got, ref in zip(ds.operands, jds.operands):
        ref = np.asarray(ref)
        assert got.dtype == torch.from_numpy(ref).dtype
        assert tuple(got.shape) == ref.shape
        # Bit for bit: compare the bytes, so that -0.0 and 0.0 differ.
        assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ds.geo_vertex, np.asarray(jds.geo_vertex))


@pytest.mark.parametrize("level,shapes", [(1, 87), (2, 327), (3, 1287)])
def test_build_mesh_equals_jax(level, shapes):
    jax_out = jax_gallery.build_mesh(level=level, dtype=jnp.float32)
    port_out = gallery.build_mesh(level=level, device="cpu")
    assert port_out[0].num_shapes == shapes
    for port_t, jax_t in zip(port_out, jax_out):
        for name, got, ref in zip(jax_t._fields, port_t, jax_t):
            ref = np.asarray(ref)
            assert tuple(got.shape) == ref.shape, name
            assert got.numpy().tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_operands_equal_jax_bit_for_bit(name):
    """From the port's own scene and from the JAX scene carried over."""
    js, jp, jc = JAX_SCENES[name]()
    jds = jax_dk.DynScene(js)
    _assert_same(dk.DynScene(PORT_SCENES[name]()[0]), jds)
    carried, _, _ = from_numpy(*([np.asarray(a) for a in t]
                                 for t in (js, jp, jc)), device="cpu")
    _assert_same(dk.DynScene(carried), jds)


@pytest.mark.parametrize("kw", [
    dict(cluster_k=8), dict(cluster_k=16), dict(cluster_k=32),
    dict(super_m=1), dict(super_m=8), dict(cluster_k=8, super_m=4),
    dict(cluster_min_tris=10 ** 9)])
@pytest.mark.parametrize("level", [2, 3])
def test_operands_equal_jax_for_cluster_options(level, kw):
    js, _, _ = JAX_SCENES[f"mesh{level}"]()
    scene, _, _ = PORT_SCENES[f"mesh{level}"]()
    _assert_same(dk.DynScene(scene, **kw), jax_dk.DynScene(js, **kw))


def test_pack_meta_and_constants_match_jax():
    assert (dk._ROW_BITS, dk._ROW_CAP, dk._AUTO_K32_TRIS) == (
        jax_dk._ROW_BITS, jax_dk._ROW_CAP, jax_dk._AUTO_K32_TRIS)
    r = np.random.default_rng(0)
    args = (r.integers(0, 256, 64), r.integers(0, 256, 64),
            r.integers(0, 4, 64), r.integers(0, 3, 64))
    packed = dk._pack_meta(*args)
    np.testing.assert_array_equal(packed, jax_dk._pack_meta(*args))
    for got, ref in zip(dk._unpack_meta(torch.as_tensor(packed)), args):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_cluster_k_auto_adapts_to_mesh_size():
    small, big = (PORT_SCENES[k]()[0] for k in ("mesh1", "mesh3"))
    ds_small, ds_big = dk.DynScene(small), dk.DynScene(big)
    assert ds_small.n_tri < dk._AUTO_K32_TRIS <= ds_big.n_tri
    assert ds_small.cluster_k == 16 and ds_big.cluster_k == 32
    assert dk.DynScene(big, cluster_k=16).cluster_k == 16
    assert ds_big.n_clusters * 32 >= ds_big.n_tri
    assert dk.DynScene.of(ds_big) is ds_big
    assert dk.DynScene.of(small).n_shapes == 87


def test_cluster_build_invariants():
    """Every triangle appears in exactly one slot, and each cluster's box
    contains all of its triangles' vertices."""
    scene, _, _ = PORT_SCENES["mesh2"]()
    ds0 = dk.DynScene(scene, cluster_min_tris=10 ** 9)  # just for the sort
    assert ds0.n_clusters == 0 and ds0.n_tri_pad == ds0.n_tri == 320
    t0 = ds0.n_plane + ds0.n_sphere
    tri_geo = ds0.geo_vertex[t0:]
    K = 16
    slots, aabbs = dk._cluster_tris(tri_geo, K)
    assert slots.size == aabbs.shape[0] * K
    real = slots[slots >= 0]
    assert sorted(real.tolist()) == list(range(tri_geo.shape[0]))
    v = tri_geo[:, :9].reshape(-1, 3, 3)
    for c in range(aabbs.shape[0]):
        idx = slots[c * K:(c + 1) * K]
        idx = idx[idx >= 0]
        lo, hi = aabbs[c, :3], aabbs[c, 3:]
        assert (v[idx] >= lo - 1e-7).all() and (v[idx] <= hi + 1e-7).all()


def test_supercluster_build_invariants():
    """Super row s unites leaves [s*M, (s+1)*M); padding leaves are
    inverted boxes after the real ones; every triangle slot that can be
    indexed, the padded clusters' too, is a real row, and the padded ones
    are degenerate (all zero) with the original index S."""
    scene, _, _ = PORT_SCENES["mesh2"]()
    ds = dk.DynScene(scene)  # 320 tris / K=16 -> 20 leaves -> supers on
    assert ds.n_clusters > ds.super_m and ds.n_super > 0
    assert ds.n_clusters_pad == ds.n_super * ds.super_m
    assert ds.n_clusters_pad > ds.n_clusters  # 20 leaves pad to 24
    geo, _, orig, meta, _, caabb = (t.numpy() for t in ds.operands)
    assert caabb.shape[0] == ds.n_clusters_pad + ds.n_super
    leaves = caabb[:ds.n_clusters_pad].reshape(ds.n_super, ds.super_m, 6)
    sup = caabb[ds.n_clusters_pad:]
    np.testing.assert_array_equal(sup[:, :3], leaves[:, :, :3].min(1))
    np.testing.assert_array_equal(sup[:, 3:], leaves[:, :, 3:].max(1))
    pad = caabb[ds.n_clusters:ds.n_clusters_pad]
    assert (pad[:, :3] > pad[:, 3:]).all()
    t0 = ds.n_plane + ds.n_sphere
    assert geo.shape[0] - t0 == ds.n_clusters_pad * ds.cluster_k
    first_pad = t0 + ds.n_clusters * ds.cluster_k
    np.testing.assert_array_equal(geo[first_pad:], 0.0)
    assert (orig[first_pad:] == ds.n_shapes).all()
    _, _, mt, st = dk._unpack_meta(torch.as_tensor(meta[first_pad:]))
    assert (mt == 3).all() and (st == 2).all()  # null material, triangle


def test_dynscene_rejects_f64():
    scene, _, _ = cbox.build(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        dk.DynScene(scene)


def test_dynscene_rejects_more_than_256_rows():
    """Row indices are packed into 8 bits; the message is the JAX
    package's."""
    def many(cls, **kw):
        b = cls()
        for k in range(257):
            b.plane([0.0, 1.0, 0.0], -1.0 - k,
                    b.diffuse(b.albedo_param([0.5, 0.5, 0.5])))
        return b.build(**kw)[0]

    from drt_tpu.scene import SceneBuilder as JaxSceneBuilder

    with pytest.raises(ValueError) as port_err:
        dk.DynScene(many(SceneBuilder, device="cpu"))
    with pytest.raises(ValueError) as jax_err:
        jax_dk.DynScene(many(JaxSceneBuilder))
    assert str(port_err.value) == str(jax_err.value)
    assert "max row is 256 >= 256" in str(port_err.value)
