"""drt_tpu_torch scene, camera and model builders against drt_tpu's."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.scene import make_scene as jax_make_scene
from drt_tpu_torch import optim
from drt_tpu_torch.camera import (camera_rays, default_camera, look_at,
                                  pixel_grid)
from drt_tpu_torch.models import cbox, gallery
from drt_tpu_torch.scene import (SceneBuilder, albedo_table, emission_table,
                                 from_numpy, make_scene)

MODELS = {
    "cbox": (jax_cbox.build, partial(cbox.build, device="cpu")),
    "glossy": (jax_gallery.build_glossy,
               partial(gallery.build_glossy, device="cpu")),
    "tri": (jax_gallery.build_tri, partial(gallery.build_tri, device="cpu")),
}


def _flat(scene, params, cam):
    return [np.asarray(a) for a in (*scene, *params, *cam)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_arrays_match(model, dtype):
    jax_build, port_build = MODELS[model]
    ref = _flat(*jax_build(dtype=getattr(jnp, dtype)))
    got = _flat(*port_build(dtype=getattr(torch, dtype)))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_from_numpy_and_padded_tables():
    js, jp, jc = jax_gallery.build_glossy(dtype=jnp.float32)
    scene, params, cam = from_numpy(*([np.asarray(a) for a in t]
                                      for t in (js, jp, jc)), device="cpu")
    ref = _flat(*gallery.build_glossy(dtype=torch.float32, device="cpu"))
    for g, r in zip(_flat(scene, params, cam), ref):
        np.testing.assert_array_equal(g, r)
    alb = albedo_table(scene, params).numpy()
    emi = emission_table(scene, params).numpy()
    np.testing.assert_array_equal(alb[-1], [1, 1, 1])
    np.testing.assert_array_equal(emi[-1], [0, 0, 0])
    np.testing.assert_array_equal(alb[:-1], np.asarray(jp.albedo))


def test_make_scene_matches():
    spec = [
        {"kind": "plane", "normal": [0, 1, 0], "offset": -1.0,
         "diffuse": [0.5, 0.5, 0.5]},
        {"kind": "sphere", "center": [0, 0, 3], "radius": 1.0,
         "specular": ([0.4, 0.4, 0.4], 12.0)},
        {"kind": "sphere", "center": [1, 0, 3], "radius": 0.5,
         "mirror": True},
        {"kind": "triangle", "v0": [0, 0, 4], "v1": [1, 0, 4],
         "v2": [0, 1, 4], "emission": [2, 2, 2]},
    ]
    ref = [np.asarray(a) for t in jax_make_scene(spec, jnp.float64)
           for a in t]
    got = [a.numpy() for t in make_scene(spec, torch.float64, device="cpu")
           for a in t]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="unknown shape kind"):
        make_scene([{"kind": "cone"}])


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-6)])
@pytest.mark.parametrize("model", ["cbox", "tri"])
def test_camera_rays_match(model, dtype, rtol):
    w, h, spp = 16, 12, 2
    jax_build, port_build = MODELS[model]
    _, _, jcam = jax_build(dtype=getattr(jnp, dtype))
    _, _, cam = port_build(dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(pixel_grid(w, h).numpy(),
                                  np.asarray(jax_pixel_grid(w, h)))
    xy = np.tile(np.asarray(jax_pixel_grid(w, h)), (spp, 1))
    u = np.random.default_rng(3).uniform(size=(xy.shape[0], 2)).astype(
        dtype)
    ro, rd, rp = jax_camera_rays(jcam, w, h, jnp.asarray(xy),
                                 jnp.asarray(u))
    o, d, p = camera_rays(cam, w, h, torch.as_tensor(xy),
                          torch.as_tensor(u))
    for g, r in zip((*o, *d, p), (*ro, *rd, rp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=rtol * 1e-2)


def _sphere_builder(**kw):
    b = SceneBuilder()
    b.sphere([0.0, 0.0, 3.0], 1.0, b.diffuse(b.albedo_param([0.5] * 3)))
    return b.build(**kw)


# The public constructors of a scene, its parameters and its camera.
CONSTRUCTORS = {
    "cbox.build": cbox.build,
    "gallery.build_glossy": gallery.build_glossy,
    "gallery.build_mesh": partial(gallery.build_mesh, 1),
    "gallery.build_tri": gallery.build_tri,
    "make_scene": partial(make_scene, [{"kind": "sphere", "center": [0, 0, 3],
                                        "radius": 1.0}]),
    "SceneBuilder.build": _sphere_builder,
    "from_numpy": lambda **kw: from_numpy(
        *([np.asarray(a) for a in t] for t in jax_cbox.build()), **kw),
    "default_camera": default_camera,
    "look_at": partial(look_at, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
    "state_from_numpy": partial(optim.state_from_numpy,
                                np.full((3, 3), 0.5, np.float32),
                                np.ones((1, 3), np.float32)),
}


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_put_tensors_on_the_card_by_default(name):
    """Without a card a constructor asked for no device raises, naming
    device='cpu', instead of building on the CPU; with device='cpu' every
    tensor it returns lies there. tests/test_torch_cuda.py checks the
    default on the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is checked on it by "
                    "tests/test_torch_cuda.py")
    build = CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    got = _tensors(build(device="cpu"))
    assert got and all(t.device.type == "cpu" for t in got)
