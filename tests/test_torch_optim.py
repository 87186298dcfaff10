"""drt_tpu_torch.optim on the CPU: the Adam step against optax.adam over
the JAX tape renderer from the same numpy state (float32, parameters to
rtol 1e-5 after 3 steps), the physical clip, and the host loop of
inverse_render (its checkpoints: tests/test_torch_checkpoint.py)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from drt_tpu.adjoint import make_diff_renderer as jax_make_diff_renderer
from drt_tpu.camera import camera_rays as jax_camera_rays
from drt_tpu.camera import pixel_grid as jax_pixel_grid
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.scene import Params as JaxParams
from drt_tpu_torch import optim
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import make_fused_image_renderer
from drt_tpu_torch.models import cbox
from drt_tpu_torch.scene import Params, from_numpy

CFG = RenderConfig(width=16, height=8, spp=4, max_depth=4)
N = CFG.width * CFG.height * CFG.spp


def _tapes(seed):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(2, N)).astype(np.float32),
            r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32))


def test_adam_steps_match_optax_on_a_tape_loss():
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    scene, params, cam = from_numpy(*([np.asarray(a) for a in t]
                                      for t in (js, jp, jc)), device="cpu")
    cam_u, tape = _tapes(0)
    tcu, ttp = torch.as_tensor(cam_u), torch.as_tensor(tape)
    tape_render = make_fused_image_renderer(scene, cam, CFG, rng="tape")
    target = tape_render(params, *map(torch.as_tensor, _tapes(1)))
    start_alb = np.asarray(jp.albedo) * 0.6 + 0.1
    start_emi = np.asarray(jp.emission) * 1.5
    lr = 2e-2

    # The port: the step under test, over the tape renderer (the seeds the
    # step draws are ignored: the tape is the sample stream).
    step = optim.make_train_step(
        scene, CFG, cam, target, optim.Adam(lr), paired=False,
        render=lambda p, seeds: tape_render(p, tcu, ttp))
    state = optim.state_from_numpy(start_alb, start_emi, device="cpu")
    assert state.step == 0 and not state.opt_state.mu.albedo.any()
    gen = torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        state, metrics = step(state, gen)
        got.append((state.params.albedo.numpy().copy(),
                    state.params.emission.numpy().copy(),
                    float(metrics["loss"]), float(metrics["grad_norm"])))
    assert state.step == 3

    # The reference: optax.adam over the JAX tape renderer.
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    diff = jax_make_diff_renderer(js, jcfg, use_tape=True)
    xy = jnp.tile(jax_pixel_grid(CFG.width, CFG.height), (CFG.spp, 1))
    o, d, _ = jax_camera_rays(jc, CFG.width, CFG.height, xy,
                              jnp.asarray(cam_u).T)
    jtarget = jnp.asarray(target.numpy())

    def loss_fn(p):
        L = diff(p, o, d, jnp.asarray(tape))
        img = jnp.stack([c.reshape(CFG.spp, CFG.height, CFG.width).mean(0)
                         for c in L], axis=-1)
        return jnp.mean((img - jtarget) ** 2)

    opt = optax.adam(lr)
    p = JaxParams(jnp.asarray(start_alb), jnp.asarray(start_emi))
    opt_state = opt.init(p)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for k in range(3):
        loss, grads = grad_fn(p)
        updates, opt_state = opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        p = JaxParams(jnp.clip(p.albedo, 0.0, 1.0),
                      jnp.maximum(p.emission, 0.0))
        alb, emi, got_loss, got_norm = got[k]
        np.testing.assert_allclose(alb, np.asarray(p.albedo), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(emi, np.asarray(p.emission), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4)
        np.testing.assert_allclose(
            got_norm, float(optax.global_norm(grads)), rtol=1e-4)
    assert np.abs(got[2][0] - start_alb).max() > 0.03  # it moved


def test_step_clips_to_the_physical_range():
    """albedo in [0, 1], emission >= 0, whatever the update. The first
    Adam step moves every entry by the learning rate against the sign of
    its gradient."""
    scene, _, cam = cbox.build(device="cpu")
    shape = (CFG.height, CFG.width, 3)

    def render(p, seeds):  # an image that grows with every parameter
        return (p.albedo.sum() + p.emission.sum()).expand(shape)

    gen = torch.Generator().manual_seed(0)
    for target, start, want_alb, want_emi in ((0.0, 0.2, 0.0, 0.0),
                                              (50.0, 0.8, 1.0, 1.3)):
        step = optim.make_train_step(
            scene, CFG, cam, torch.full(shape, target), optim.Adam(0.5),
            paired=False, render=render)
        state = optim.init_state(Params(torch.full((3, 3), start),
                                        torch.full((1, 3), start)))
        state, _ = step(state, gen)
        assert torch.allclose(state.params.albedo,
                              torch.full((3, 3), want_alb))
        assert torch.allclose(state.params.emission,
                              torch.full((1, 3), want_emi))


@pytest.mark.parametrize("paired", [True, False])
def test_train_block_is_the_step_loop(paired):
    scene, params, cam = cbox.build(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=2, spp_chunks=2, max_depth=3)
    from drt_tpu_torch.parallel.render import make_renderer
    target = make_renderer(scene, cfg, cam, differentiable=False)(
        params, torch.tensor([1, 2], dtype=torch.int32))
    start = Params(params.albedo * 0.5, params.emission)
    kw = dict(paired=paired)
    step = optim.make_train_step(scene, cfg, cam, target, optim.Adam(1e-2),
                                 **kw)
    block = optim.make_train_block(scene, cfg, cam, target,
                                   optim.Adam(1e-2), **kw)
    s1 = optim.init_state(start)
    g1 = torch.Generator().manual_seed(3)
    for _ in range(2):
        s1, m1 = step(s1, g1)
    s2, m2 = block(optim.init_state(start), torch.Generator().manual_seed(3),
                   2)
    assert s2.step == 2 and m2["loss"].shape == (2,)
    assert torch.equal(s1.params.albedo, s2.params.albedo)
    assert torch.equal(m2["loss"][1], m1["loss"])


def test_inverse_render_returns_stacked_metrics(tmp_path):
    scene, params, cam = cbox.build(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=4, spp_chunks=2, max_depth=3)
    from drt_tpu_torch.parallel.render import make_renderer
    target = make_renderer(scene, cfg, cam, differentiable=False)(
        params, torch.tensor([1, 2], dtype=torch.int32))
    start = Params(params.albedo * 0.5, params.emission)
    lines = []
    fitted, metrics = optim.inverse_render(
        scene, cfg, cam, target, start, torch.Generator().manual_seed(0),
        steps=4, log_every=2, logger=lines.append)
    assert metrics["loss"].shape == (4,) and metrics["grad_norm"].shape == (4,)
    assert torch.isfinite(metrics["loss"]).all()
    assert (metrics["grad_norm"] > 0).all()
    assert len(lines) == 3 and lines[0].startswith("step    0 loss")
    assert not fitted.albedo.requires_grad
    assert not torch.equal(fitted.albedo, start.albedo)
    _, empty = optim.inverse_render(scene, cfg, cam, target, start,
                                    torch.Generator(), steps=0)
    assert empty["loss"].shape == (0,)
    # With a metrics file the logged steps go there, not to the logger.
    jsonl = tmp_path / "m.jsonl"
    lines.clear()
    optim.inverse_render(scene, cfg, cam, target, start, torch.Generator(),
                         steps=2, log_every=1, logger=lines.append,
                         metrics_jsonl=str(jsonl))
    assert not lines
    assert [json.loads(line)["step"] for line in open(jsonl)] == [0, 1]
