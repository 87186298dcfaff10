"""drt_tpu_torch.gradcheck, drt_tpu_torch.integrate and `cli grad-image`
on the CPU: the backprop gradient image against the forward-mode one
(float64, rtol 1e-10) and against `jax.jvp` of the JAX package's
camera_rays + trace_rays(tape=...) fed the port's draws;
`check_gradients`; `_parse_param` against the JAX package's messages; the
integration operator on tests/test_integrate.py's integrand, fed the
samples the JAX operator draws."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.gradcheck import _parse_param as jax_parse_param
from drt_tpu.integrate import _BWD_SALT as JAX_BWD_SALT
from drt_tpu.integrate import integrate as jax_integrate
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.renderer import chunk_pixel_ids as jax_chunk_pixel_ids
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu.scene import Params as JaxParams
from drt_tpu_torch import cli
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.gradcheck import (_parse_param, check_gradients,
                                     grad_image, grad_image_fwd)
from drt_tpu_torch.integrate import integrate
from drt_tpu_torch.models import cbox
from drt_tpu_torch.ops.rng import bounce_tape, camera_draws
from drt_tpu_torch.renderer import chunk_pixel_ids, chunk_sample_ids
from drt_tpu_torch.scene import Params

F64 = dict(rtol=1e-10, atol=1e-12)
CFG = RenderConfig(width=16, height=12, spp=4, spp_chunks=2, max_depth=4)
SEEDS = torch.tensor([7, -8], dtype=torch.int32)


@pytest.fixture(scope="module")
def images():
    """Both gradient images of the port for two rows, float64."""
    scene, params, cam = cbox.build(dtype=torch.float64, device="cpu")
    out = {}
    for param in ("albedo:0", "emission:0"):
        out[param] = (grad_image(scene, cam, CFG, params, SEEDS, param),
                      grad_image_fwd(scene, cam, CFG, params, SEEDS, param))
    return out


@pytest.mark.parametrize("param", ["albedo:0", "emission:0"])
def test_grad_image_equals_forward_mode(images, param):
    bp, fw = images[param]
    assert bp.shape == (12, 16, 3) and fw.dtype == torch.float64
    assert fw.abs().max() > 0 and torch.isfinite(bp).all()
    np.testing.assert_allclose(bp.numpy(), fw.numpy(), **F64)


def test_grad_image_fwd_equals_jax_jvp(images):
    """jax.jvp of the JAX composition on the port's draws (chunk by
    chunk: camera_rays + trace_rays(tape=...), the mean of the chunk
    images) gives the port's forward-mode image."""
    js, jp, jc = jax_cbox.build(dtype=jnp.float64)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    xy = jax_chunk_pixel_ids(jcfg)
    xy_t = chunk_pixel_ids(CFG)
    draws = []
    for c in range(CFG.spp_chunks):
        pix, s = chunk_sample_ids(CFG, xy_t, c)
        draws.append((jnp.asarray(camera_draws(7, pix, s,
                                               torch.float64).T.numpy()),
                      jnp.asarray(bounce_tape(-8, pix, s, CFG.max_depth,
                                              torch.float64).numpy())))

    def render(p):
        imgs = []
        for cam_u, tape in draws:
            o, d, pdf = jax_camera_rays(jc, 16, 12, xy, cam_u)
            L = jax_trace_rays(p, js, o, d, None, jcfg, tape=tape)
            imgs.append(jnp.stack([(v / pdf).reshape(12, 16, 2).mean(axis=2)
                                   for v in L], -1))
        return jnp.stack(imgs).mean(axis=0)

    tangent = JaxParams(albedo=jnp.zeros_like(jp.albedo).at[0].set(1.0),
                        emission=jnp.zeros_like(jp.emission))
    _, ref = jax.jvp(render, (jp,), (tangent,))
    np.testing.assert_allclose(images["albedo:0"][1].numpy(),
                               np.asarray(ref), **F64)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
def test_check_gradients_passes(dtype, rtol):
    scene, params, cam = cbox.build(dtype=dtype, device="cpu")
    res = check_gradients(scene, cam, CFG, params, SEEDS, n_directions=3,
                          rtol=rtol)
    assert len(res) == 3 and all(math.isfinite(a) for a, _ in res)
    assert all(abs(a) > 0 for a, _ in res)


@pytest.mark.parametrize("fn", [grad_image, grad_image_fwd, check_gradients])
def test_biased_only_and_one_lane(fn):
    scene, params, cam = cbox.build(device="cpu")
    with pytest.raises(ValueError, match="unbiased=False"):
        fn(scene, cam, dataclasses.replace(CFG, unbiased=True), params,
           SEEDS)
    # bsdf_samples > 1 runs on each ray's lanes (checked against forward
    # mode in tests/test_torch_split.py).
    out = fn(scene, cam, dataclasses.replace(CFG, bsdf_samples=2,
                                             max_depth=3), params, SEEDS)
    assert all(np.isfinite(np.asarray(x)).all() for x in
               (out if isinstance(out, list) else [out]))


@pytest.mark.parametrize("param", ["albedo:3", "albedo:-1", "emission:1",
                                   "normal:0"])
def test_parse_param_errors_match_jax(param):
    _, params, _ = cbox.build(device="cpu")
    _, jp, _ = jax_cbox.build()
    with pytest.raises(ValueError) as port_err:
        _parse_param(params, param)
    with pytest.raises(ValueError) as jax_err:
        jax_parse_param(jp, param)
    assert str(port_err.value) == str(jax_err.value)
    assert _parse_param(params, "emission") == ("emission", 0)
    assert _parse_param(params, "albedo:2") == ("albedo", 2)


def test_cli_grad_image_writes_both_images(tmp_path):
    out = tmp_path / "g.exr"
    rc = cli.main(["grad-image", "-x", "8", "-y", "6", "-n", "2",
                   "--max-depth", "3", "--device", "cpu", "--param",
                   "albedo:1", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes()[:4] == b"\x76\x2f\x31\x01"  # EXR magic
    assert (tmp_path / "g-gt.exr").read_bytes()[:4] == b"\x76\x2f\x31\x01"
    png = tmp_path / "g.png"
    assert cli.main(["grad-image", "-x", "8", "-y", "6", "-n", "2",
                     "--max-depth", "3", "--device", "cpu",
                     "--backend", "torch-wavefront", "-o", str(png)]) == 0
    assert (tmp_path / "g-gt.png").read_bytes()[:8] == \
        b"\x89PNG\r\n\x1a\n"
    for backend in ("cuda", "cuda-wavefront", "torch"):
        assert cli.main(["grad-image", "-x", "8", "-y", "6", "-n", "2",
                         "--device", "cpu", "--backend", backend,
                         "-o", str(tmp_path / "x.exr")]) == 2
    assert not (tmp_path / "x.exr").exists()


# The integration operator on tests/test_integrate.py's integrand:
# f(theta, x) = theta x^2, x = sqrt(u) with pdf 2x: E = theta/3,
# dE/dtheta = 1/3.

def _forward(theta, x):
    return theta * x * x


def _jax_sampler(key):
    u = jax.random.uniform(key, (), dtype=jnp.float64)
    x = jnp.sqrt(u)
    return x, 2.0 * x


def _jax_draws(key, n, unbiased):
    """The uniforms the JAX operator draws for key: the forward's, then
    (unbiased) the backward's fresh ones."""
    keys = [jax.random.fold_in(key, i) for i in range(n)]
    if unbiased:
        bk = jax.random.fold_in(key, JAX_BWD_SALT)
        keys += [jax.random.fold_in(bk, i) for i in range(n)]
    return [float(jax.random.uniform(k, (), dtype=jnp.float64))
            for k in keys]


def _fed(uniforms):
    """A port sampler that takes the given uniforms in order."""
    it = iter(uniforms)

    def sampler(gen):
        x = torch.sqrt(torch.tensor(next(it), dtype=torch.float64))
        return x, 2.0 * x

    return sampler


def _port(theta, uniforms, **kw):
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    v = integrate(_forward, _fed(uniforms), t, torch.Generator(), **kw)
    (g,) = torch.autograd.grad(v, t)
    return float(v.detach()), float(g)


def _jax(theta, key, **kw):
    def f(t):
        return jax_integrate(_forward, _jax_sampler, t, key, **kw)

    t = jnp.asarray(theta, jnp.float64)
    return float(f(t)), float(jax.grad(f)(t))


@pytest.mark.parametrize("kw", [dict(n_samples=4), dict(n_samples=2),
                                dict(n_samples=3, combine="sum"),
                                dict(n_samples=2, unbiased=True),
                                dict(n_samples=4, unbiased=True,
                                     combine="sum")])
def test_integrate_matches_jax_on_the_same_samples(kw):
    key = jax.random.key(11)
    u = _jax_draws(key, kw["n_samples"], kw.get("unbiased", False))
    got = _port(1.7, u, **kw)
    np.testing.assert_allclose(got, _jax(1.7, key, **kw), rtol=1e-12)
    if not kw.get("unbiased"):
        # Biased mode is plain autograd on the forward's samples: the
        # integrand is linear in theta.
        np.testing.assert_allclose(got[1], got[0] / 1.7, rtol=1e-12)


def test_integrate_unbiased_draws_fresh_samples():
    """The value is the biased estimate on the same samples; the gradient
    comes from fresh draws at backward time and is unbiased."""
    u = [0.3, 0.8, 0.1, 0.6]
    v_b, g_b = _port(1.0, u[:2], n_samples=2)
    v_u, g_u = _port(1.0, u, n_samples=2, unbiased=True)
    assert v_u == v_b and abs(g_u - g_b) > 1e-6
    np.testing.assert_allclose(g_u, _port(1.0, u[2:], n_samples=2)[1],
                               rtol=1e-15)
    gen = torch.Generator().manual_seed(0)

    def sampler(g):
        x = torch.sqrt(torch.rand((), generator=g, dtype=torch.float64))
        return x, 2.0 * x

    grads = []
    for _ in range(400):
        t = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        integrate(_forward, sampler, t, gen, n_samples=2,
                  unbiased=True).backward()
        grads.append(float(t.grad))
    se = np.std(grads) / np.sqrt(len(grads))
    assert abs(np.mean(grads) - 1.0 / 3.0) < 4 * se + 1e-12


def test_integrate_takes_params_tuples_and_validates():
    p = Params(torch.tensor([1.0, 2.0], dtype=torch.float64,
                            requires_grad=True),
               torch.tensor([3.0], dtype=torch.float64, requires_grad=True))

    def forward(q, x):
        return q.albedo.sum() * x * x + q.emission[0] * 0.0

    # The value from the forward's x = 0.5, the gradient from the fresh
    # x = 0.9: f / pdf = sum(albedo) x / 2.
    v = integrate(forward, _fed([0.25, 0.81]), p, torch.Generator(),
                  unbiased=True)
    v.backward()
    assert float(v.detach()) == pytest.approx(3.0 * 0.5 / 2.0, rel=1e-15)
    np.testing.assert_allclose(p.albedo.grad.numpy(), [0.45, 0.45],
                               rtol=1e-12)
    assert float(p.emission.grad[0]) == 0.0
    with pytest.raises(ValueError, match="n_samples"):
        integrate(_forward, _fed([]), torch.tensor(1.0), None, n_samples=0)
    with pytest.raises(ValueError, match="combine"):
        integrate(_forward, _fed([]), torch.tensor(1.0), None,
                  combine="median")
