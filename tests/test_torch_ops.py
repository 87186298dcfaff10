"""drt_tpu_torch.ops (intersect, bxdf, rng) against drt_tpu.ops on the
same random inputs: float64 to rtol 1e-10 / atol 1e-12, the hash bit for
bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reference_impl as ref
from drt_tpu.ops import bxdf as jax_bxdf
from drt_tpu.ops import intersect as jax_intersect
from drt_tpu.ops import regen as jax_regen
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.scene import make_scene as jax_make_scene
from drt_tpu_torch.ops import bxdf, intersect, rng
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.scene import (DIFFUSE, MIRROR, NULL_BXDF, SPECULAR,
                                 make_scene)

RTOL, ATOL = 1e-10, 1e-12

SPEC = [
    {"kind": "plane", "normal": [0, 1, 0], "offset": -1.0,
     "diffuse": [0.5, 0.5, 0.5]},
    {"kind": "plane", "normal": [1, 0, 0.1], "offset": -2.0,
     "diffuse": [0.1, 0.5, 0.1]},
    {"kind": "sphere", "center": [0, 0, 3], "radius": 1.0,
     "specular": ([0.4, 0.4, 0.4], 12.0)},
    {"kind": "sphere", "center": [1, 0.5, 2], "radius": 0.5, "mirror": True},
    {"kind": "triangle", "v0": [-1, -1, 4], "v1": [1, -1, 4],
     "v2": [0, 1, 3.5], "emission": [2, 2, 2]},
    {"kind": "triangle", "v0": [-1, -1, 4], "v1": [0, 1, 3.5],
     "v2": [1, -1, 4]},
]


def _v3(a):
    return V3(*(torch.as_tensor(c) for c in a))


def _jv3(a):
    return JV3(*(jnp.asarray(c) for c in a))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _unit(rng_, n):
    v = rng_.normal(size=(3, n))
    return v / np.linalg.norm(v, axis=0)


def test_intersect_matches():
    r = np.random.default_rng(0)
    n = 512
    o = r.uniform(-1.5, 1.5, size=(3, n))
    o[2] = r.uniform(0.0, 2.0, size=n)
    d = _unit(r, n)
    d[:, :8] = [[0.0] * 8, [0.0] * 8, [1.0] * 8]  # axis-aligned rays
    js, _ = jax_make_scene(SPEC, jnp.float64)
    scene, _ = make_scene(SPEC, torch.float64, device="cpu")
    ref = jax_intersect.intersect_scene(js, _jv3(o), _jv3(d),
                                        emit_sentinel=1)
    hit = intersect.intersect_scene(scene, _v3(o), _v3(d), emit_sentinel=1)
    valid = np.asarray(ref.valid)
    assert 0.3 < valid.mean() < 1.0
    np.testing.assert_array_equal(hit.valid.numpy(), valid)
    np.testing.assert_array_equal(hit.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_array_equal(hit.emit.numpy(), np.asarray(ref.emit))
    _close(hit.t, ref.t)
    for g, rr in zip((*hit.point, *hit.normal), (*ref.point, *ref.normal)):
        _close(g.numpy()[valid], np.asarray(rr)[valid])


def test_intersect_ties_keep_first():
    """Two coincident planes: the first in scene order wins."""
    spec = [{"kind": "plane", "normal": [0, 0, -1], "offset": -5.0,
             "diffuse": [0.1, 0.1, 0.1]},
            {"kind": "plane", "normal": [0, 0, -1], "offset": -5.0,
             "diffuse": [0.9, 0.9, 0.9], "emission": [1, 1, 1]}]
    scene, _ = make_scene(spec, torch.float64, device="cpu")
    o = _v3(np.zeros((3, 4)))
    d = _v3(np.tile([[0.0], [0.0], [1.0]], (1, 4)))
    hit = intersect.intersect_scene(scene, o, d, emit_sentinel=1)
    np.testing.assert_array_equal(hit.mat.numpy(), 0)
    np.testing.assert_array_equal(hit.emit.numpy(), 1)  # sentinel


def _bxdf_inputs(seed=1, n=400):
    r = np.random.default_rng(seed)
    normal = _unit(r, n)
    normal[:, :50] *= r.uniform(0.5, 1.5, size=50)  # raw plane normals
    d_in = _unit(r, n)
    u1 = r.uniform(size=n)
    u2 = r.uniform(size=n)
    mat = r.integers(0, 4, size=n).astype(np.int32)
    expo = r.choice([0.0, 3.0, 7.5, 30.0], size=n)
    return normal, d_in, u1, u2, mat, expo


def test_make_frame_matches():
    normal = _bxdf_inputs()[0]
    for g, rr in zip(bxdf.make_frame(_v3(normal)),
                     jax_bxdf.make_frame(_jv3(normal))):
        for gc, rc in zip(g, rr):
            _close(gc, rc)


def test_sample_and_eval_match():
    normal, d_in, u1, u2, mat, expo = _bxdf_inputs()
    ref_dir, ref_pdf = jax_bxdf.sample_bxdf(
        jnp.asarray(mat), jnp.asarray(expo), _jv3(normal), _jv3(d_in),
        jnp.asarray(u1), jnp.asarray(u2))
    got_dir, got_pdf = bxdf.sample_bxdf(
        torch.as_tensor(mat), torch.as_tensor(expo), _v3(normal),
        _v3(d_in), torch.as_tensor(u1), torch.as_tensor(u2))
    _close(got_pdf, ref_pdf)
    for g, rr in zip(got_dir, ref_dir):
        _close(g, rr)
    ref_s = jax_bxdf.eval_scale(jnp.asarray(mat), jnp.asarray(expo),
                                _jv3(normal), _jv3(d_in), ref_dir)
    got_s = bxdf.eval_scale(torch.as_tensor(mat), torch.as_tensor(expo),
                            _v3(normal), _v3(d_in), got_dir)
    # NaN where a non-integral exponent meets a negative cos (C++ pow):
    # same places in both.
    assert np.isfinite(np.asarray(ref_s)).mean() > 0.9
    _close(got_s, ref_s)


def test_pow_cpp_negative_base():
    base = np.array([-0.5, -0.5, -0.5, 0.5, -2.0, 0.0])
    expo = np.array([3.0, 2.0, 2.5, 2.5, 1.0, 0.0])
    got = bxdf._pow_cpp(torch.as_tensor(base), torch.as_tensor(expo))
    ref = jax_bxdf._pow_cpp(jnp.asarray(base), jnp.asarray(expo))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), equal_nan=True)
    np.testing.assert_allclose(got.numpy()[[0, 1, 4]], [-0.125, 0.25, -2.0])
    assert np.isnan(got.numpy()[2])


@pytest.mark.parametrize("seeds,sample_base", [([123, 456], 0),
                                               ([-7, -2 ** 31], 5)])
def test_hash_tapes_bit_equal(seeds, sample_base):
    npix, spp, depth = 16 * 12, 3, 4
    ref_cam, ref_tape = jax_regen.hash_tapes(
        jnp.asarray(seeds, jnp.int32), npix, spp, depth, jnp.float32,
        sample_base=sample_base)
    cam, tape = rng.hash_tapes(seeds, npix, spp, depth, torch.float32,
                               sample_base=sample_base)
    np.testing.assert_array_equal(cam.numpy(), np.asarray(ref_cam))
    np.testing.assert_array_equal(tape.numpy(), np.asarray(ref_tape))
    assert 0.0 < tape.min() and tape.max() < 1.0


def test_hash_bits_bit_equal():
    r = np.random.default_rng(4)
    vals = r.integers(-2 ** 31, 2 ** 31, size=(4, 256)).astype(np.int32)
    u32 = lambda v: jnp.asarray(v, jnp.int32).view(jnp.uint32)  # noqa: E731
    for dim in range(3):
        ref = jax_regen._hash_bits(*(u32(v) for v in vals), dim)
        got = rng.hash_bits(*(torch.as_tensor(v) for v in vals), dim)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref).astype(np.int64))


# The pdf checks of tests/test_bxdf.py, on the port, against the NumPy
# oracle of the reference's BxDFs (tests/reference_impl.py).


@pytest.mark.parametrize("kind", ["diffuse", "specular"])
def test_bxdf_matches_numpy_oracle(kind):
    n = 64
    r = np.random.default_rng(5)
    normals = _unit(r, n).T
    d_in = _unit(r, n).T
    u1, u2 = r.random(n), r.random(n)
    if kind == "diffuse":
        code, expo, mat = DIFFUSE, 0.0, ref.Diffuse([0.5, 0.25, 0.125])
    else:
        flip = np.sum(normals * d_in, -1) < 0
        d_in[flip] = -d_in[flip]
        code, expo, mat = SPECULAR, 30.0, ref.Specular([0.5, 0.5, 0.5],
                                                       30.0)
    mt = torch.full((n,), code, dtype=torch.int32)
    mex = torch.full((n,), expo, dtype=torch.float64)
    nv, dv = _v3(normals.T), _v3(d_in.T)
    dirs, pdf = bxdf.sample_bxdf(mt, mex, nv, dv, torch.as_tensor(u1),
                                 torch.as_tensor(u2))
    s = bxdf.eval_scale(mt, mex, nv, dv, dirs).numpy()
    dirs = dirs.to_array().numpy()
    for i in range(n):
        draws = iter([u1[i], u2[i]])
        md, mpdf = mat.sample(normals[i], d_in[i], lambda _: next(draws))
        np.testing.assert_allclose(dirs[i], md, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(pdf[i].item(), mpdf, rtol=1e-10)
        np.testing.assert_allclose(s[i] * mat.color,
                                   mat.eval(normals[i], d_in[i], md),
                                   rtol=1e-9, atol=1e-12)


def test_mirror_and_null():
    normals = _v3(np.array([[0.0, 1.0, 0.0]] * 2).T)
    d_in = _v3(np.array([[1.0, 1.0, 0.0]] * 2).T / np.sqrt(2))
    mt = torch.tensor([MIRROR, NULL_BXDF], dtype=torch.int32)
    mex = torch.zeros(2, dtype=torch.float64)
    u = torch.tensor([0.3, 0.7], dtype=torch.float64)
    dirs, pdf = bxdf.sample_bxdf(mt, mex, normals, d_in, u, u)
    d = dirs.to_array().numpy()
    np.testing.assert_allclose(d[0], [-1 / np.sqrt(2), 1 / np.sqrt(2), 0])
    np.testing.assert_allclose(d[1], 0.0)  # null fallback
    np.testing.assert_allclose(pdf.numpy(), [1.0, 1.0])
    s = bxdf.eval_scale(mt, mex, normals, d_in, dirs).numpy()
    np.testing.assert_allclose(s[0], np.sqrt(2.0), rtol=1e-12)
    assert s[1] == 0.0


def test_diffuse_pdf_integrates_to_one():
    """Samples drawn from their own pdf: the estimate of the hemisphere
    integral of cos/pi is 1."""
    n = 200_000
    r = np.random.default_rng(8)
    z = torch.zeros(n, dtype=torch.float64)
    normal = V3(z, z, torch.ones_like(z))
    mt = torch.full((n,), DIFFUSE, dtype=torch.int32)
    dirs, pdf = bxdf.sample_bxdf(mt, z,
                                 normal, normal,
                                 torch.as_tensor(r.random(n)),
                                 torch.as_tensor(r.random(n)))
    est = (dirs.z / np.pi / pdf).mean().item()
    np.testing.assert_allclose(est, 1.0, rtol=1e-2)
