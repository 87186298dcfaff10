"""The port's sharded tape-form scene-table renderer against the JAX
package's `make_sharded_fused_image_renderer(..., tile_rows=1,
rng="tape")` on its virtual 8-device CPU mesh (tests/conftest.py), at the
config of tests/test_fused.py:318-356 (the Cornell box at 16x8x8 spp,
depth 3) on the same numpy-made uniforms, the port on a mesh of 8 CPU
shards running its plain versions: image rtol 2e-5 / atol 2e-6,
gradients rtol 1e-4 / atol 1e-6 (both sides' kernels in their own op
order, the partials summed in their own order). The JAX side is built
and run once."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.fused import make_sharded_fused_image_renderer as jax_sharded
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.scene import Params as JaxParams
from drt_tpu_torch import fused
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.parallel.mesh import make_mesh
from drt_tpu_torch.scene import Params, from_numpy


@pytest.fixture(scope="module")
def both():
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    port = from_numpy(*([np.asarray(a) for a in t] for t in (js, jp, jc)),
                      device="cpu")
    return (js, jp, jc), port


def _image_and_grads(render, params, *uniforms):
    p = Params(*(t.detach().clone().requires_grad_() for t in params))
    img = render(p, *uniforms)
    (img ** 2).sum().backward()
    return img.detach(), p.albedo.grad, p.emission.grad


def _jax_image_and_grads(render, params, *uniforms):
    img, vjp = jax.vjp(lambda p: render(p, *uniforms), params)
    (g,) = vjp(2.0 * img)  # the cotangent of sum(img ** 2)
    return np.asarray(img), np.asarray(g.albedo), np.asarray(g.emission)


def _against_jax(port, ref, img_tol, grad_tol):
    img, *grads = port
    img_j, *grads_j = ref
    assert img_j.mean() > 0
    np.testing.assert_allclose(img.numpy(), img_j, **img_tol)
    for x, y in zip(grads, grads_j):
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x.numpy(), y, **grad_tol)


def test_sharded_tape_renderer_matches_jax(both):
    (js, jp, jc), (scene, params, cam) = both
    cfg = RenderConfig(width=16, height=8, spp=8, max_depth=3)
    n = cfg.width * cfg.height * cfg.spp
    r = np.random.default_rng(21)
    cam_u = r.uniform(size=(2, n)).astype(np.float32)
    tape = r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]), ("rays",))
    ref = _jax_image_and_grads(
        jax_sharded(js, jc, JaxConfig(**dataclasses.asdict(cfg)), mesh,
                    tile_rows=1, rng="tape"),
        JaxParams(*(jnp.asarray(t) for t in jp)), jnp.asarray(cam_u),
        jnp.asarray(tape))
    port = _image_and_grads(
        fused.make_sharded_fused_image_renderer(
            scene, cam, cfg, make_mesh(shape=(8,), axis_names=("rays",),
                                       devices=["cpu"] * 8), rng="tape"),
        params, torch.as_tensor(cam_u), torch.as_tensor(tape))
    _against_jax(port, ref, dict(rtol=2e-5, atol=2e-6),
                 dict(rtol=1e-4, atol=1e-6))
