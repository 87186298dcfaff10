"""drt_tpu_torch.renderer.trace_rays against drt_tpu.renderer.trace_rays
on the same rays and uniform tape: float64 to rtol 1e-10, float32 to the
megakernel tests' rtol 2e-5 / atol 2e-6 (tests/test_megakernel.py:51)."""

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
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.renderer import trace_rays
from drt_tpu_torch.scene import from_numpy

BUILDERS = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
            "tri": jax_gallery.build_tri}
TOL = {"float64": dict(rtol=1e-10, atol=1e-12),
       "float32": dict(rtol=2e-5, atol=2e-6)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_trace_rays_tape_matches(model, dtype):
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4)
    n = cfg.width * cfg.height * cfg.spp
    js, jp, jc = BUILDERS[model](dtype=getattr(jnp, dtype))
    scene, params, _ = from_numpy(*([np.asarray(a) for a in t]
                                    for t in (js, jp, jc)), device="cpu")
    r = np.random.default_rng(11)
    cam_u = r.uniform(size=(n, 2)).astype(dtype)
    tape = r.uniform(size=(cfg.max_depth, 3, n)).astype(dtype)
    xy = jnp.tile(jax_pixel_grid(cfg.width, cfg.height), (cfg.spp, 1))
    jo, jd, _ = jax_camera_rays(jc, cfg.width, cfg.height, xy,
                                jnp.asarray(cam_u))
    o = [np.array(c) for c in jo]
    d = [np.array(c) for c in jd]

    ref = jax_trace_rays(jp, js, JV3(*map(jnp.asarray, o)),
                         JV3(*map(jnp.asarray, d)), None,
                         JaxConfig(**dataclasses.asdict(cfg)),
                         tape=jnp.asarray(tape))
    got = trace_rays(params, scene, V3(*map(torch.as_tensor, o)),
                     V3(*map(torch.as_tensor, d)), cfg,
                     tape=torch.as_tensor(tape))
    ra = np.stack([np.asarray(c) for c in ref])
    ga = np.stack([c.numpy() for c in got])
    assert ga.dtype == np.dtype(dtype)
    assert np.isfinite(ga).all() and ra.mean() > 0
    np.testing.assert_allclose(ga, ra, **TOL[dtype])


def test_bsdf_splitting_not_ported():
    """Splitting (bsdf_samples > 1) is key mode only, as in the JAX
    package: a tape raises; key mode traces M lanes a ray and returns
    each ray's lane mean (tests/test_torch_split.py holds it against the
    JAX tracer)."""
    from drt_tpu_torch.models import cbox
    from drt_tpu_torch.renderer import chunk_pixel_ids, chunk_rays

    scene, params, cam = cbox.build(device="cpu")
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=2,
                       bsdf_samples=2)
    z = torch.zeros(16)
    with pytest.raises(ValueError, match="key-driven only"):
        trace_rays(params, scene, V3(z, z, z), V3(z, z, z), cfg,
                   tape=torch.zeros(2, 3, 16))
    o, d, _ = chunk_rays(cam, cfg, chunk_pixel_ids(cfg), (1, 2), 0)
    L, res = trace_rays(params, scene, o, d, cfg, seeds=(1, 2),
                        collect=True)
    assert L.x.shape == (16,) and res.sc.shape == (2, 32)
    assert all(torch.isfinite(c).all() for c in L)
    assert float(L.x.sum() + L.y.sum() + L.z.sum()) > 0
