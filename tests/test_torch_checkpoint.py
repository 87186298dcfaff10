"""drt_tpu_torch.utils.checkpoint and the resumable recovery loop on the
CPU: a checkpoint the JAX package wrote restores into the port's state
bit for bit and the next step follows optax (rtol 1e-5); the port's own
files round-trip bit for bit; a resumed run, blocked steps and `cli
invert` with a checkpoint directory equal the uninterrupted single-step
run bit for bit."""

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
from drt_tpu.optim import TrainState as JaxTrainState
from drt_tpu.optim import init_state as jax_init_state
from drt_tpu.scene import Params as JaxParams
from drt_tpu.utils import checkpoint as jax_checkpoint
from drt_tpu_torch import cli, optim
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import make_fused_image_renderer
from drt_tpu_torch.models import cbox
from drt_tpu_torch.parallel.render import make_renderer
from drt_tpu_torch.scene import Params, from_numpy
from drt_tpu_torch.utils import checkpoint

TAPE_CFG = RenderConfig(width=16, height=8, spp=4, max_depth=4)
LR = 2e-2


def _tapes(seed):
    n = TAPE_CFG.width * TAPE_CFG.height * TAPE_CFG.spp
    r = np.random.default_rng(seed)
    return (r.uniform(size=(2, n)).astype(np.float32),
            r.uniform(size=(TAPE_CFG.max_depth, 3, n)).astype(np.float32))


def _leaves(state):
    """The port state's tensors in the npz layout's order, and its step."""
    p, (mu, nu), step = state
    return [p.albedo, p.emission, mu.albedo, mu.emission, nu.albedo,
            nu.emission], step


def test_jax_checkpoint_restores_and_steps_on(tmp_path):
    """optax.adam over the JAX tape renderer for 2 steps, saved by
    drt_tpu.utils.checkpoint.save: the port restores params, moments and
    step bit for bit, and one more port step from it matches one more
    optax step (the loss of tests/test_torch_optim.py)."""
    js, jp, jc = jax_cbox.build(dtype=jnp.float32)
    scene, _, cam = from_numpy(*([np.asarray(a) for a in t]
                                 for t in (js, jp, jc)), device="cpu")
    cam_u, tape = _tapes(0)
    tape_render = make_fused_image_renderer(scene, cam, TAPE_CFG,
                                            rng="tape")
    target = tape_render(Params(*(torch.as_tensor(np.array(a))
                                  for a in jp)),
                         *map(torch.as_tensor, _tapes(1)))
    start = (np.asarray(jp.albedo) * 0.6 + 0.1,
             np.asarray(jp.emission) * 1.5)

    jcfg = JaxConfig(**dataclasses.asdict(TAPE_CFG))
    diff = jax_make_diff_renderer(js, jcfg, use_tape=True)
    xy = jnp.tile(jax_pixel_grid(TAPE_CFG.width, TAPE_CFG.height),
                  (TAPE_CFG.spp, 1))
    o, d, _ = jax_camera_rays(jc, TAPE_CFG.width, TAPE_CFG.height, xy,
                              jnp.asarray(cam_u).T)
    jtarget = jnp.asarray(target.numpy())

    def loss_fn(p):
        L = diff(p, o, d, jnp.asarray(tape))
        img = jnp.stack([c.reshape(TAPE_CFG.spp, TAPE_CFG.height,
                                   TAPE_CFG.width).mean(0) for c in L],
                        axis=-1)
        return jnp.mean((img - jtarget) ** 2)

    opt = optax.adam(LR)
    grad_fn = jax.jit(jax.grad(loss_fn))

    def jax_step(st):
        updates, opt_state = opt.update(grad_fn(st.params), st.opt_state,
                                        st.params)
        p = optax.apply_updates(st.params, updates)
        p = JaxParams(jnp.clip(p.albedo, 0.0, 1.0),
                      jnp.maximum(p.emission, 0.0))
        return JaxTrainState(p, opt_state, st.step + 1)

    jstate = jax_init_state(JaxParams(*map(jnp.asarray, start)), opt)
    for _ in range(2):
        jstate = jax_step(jstate)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, jstate, jax.random.key(7))

    like = optim.state_from_numpy(*start, device="cpu")
    state, gen_state = checkpoint.restore(path, like)
    assert gen_state is None and state.step == 2
    adam = jstate.opt_state[0]
    want = [jstate.params.albedo, jstate.params.emission, adam.mu.albedo,
            adam.mu.emission, adam.nu.albedo, adam.nu.emission]
    got, _ = _leaves(state)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    step = optim.make_train_step(
        scene, TAPE_CFG, cam, target, optim.Adam(LR), paired=False,
        render=lambda p, seeds: tape_render(p, *map(torch.as_tensor,
                                                    (cam_u, tape))))
    state, _ = step(state, torch.Generator())
    jstate = jax_step(jstate)
    adam = jstate.opt_state[0]
    assert state.step == int(jstate.step) == 3
    got, _ = _leaves(state)
    for g, w in zip(got, [jstate.params.albedo, jstate.params.emission,
                          adam.mu.albedo, adam.mu.emission, adam.nu.albedo,
                          adam.nu.emission]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_port_checkpoints_round_trip(tmp_path):
    """save/restore and save_dir/latest_step/restore_dir give back every
    leaf, the step and the generator's state bit for bit; a malformed
    file raises."""
    r = np.random.default_rng(3)
    t = [torch.as_tensor(r.normal(size=s).astype(np.float32))
         for s in ((3, 3), (1, 3)) * 3]
    state = optim.TrainState(Params(t[0], t[1]), optim.AdamState(
        Params(t[2], t[3]), Params(t[4], t[5])), 17)
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    like = optim.init_state(Params(torch.zeros(3, 3), torch.zeros(1, 3)))

    def same(a, b):
        (la, sa), (lb, sb) = _leaves(a), _leaves(b)
        assert sa == sb
        for x, y in zip(la, lb):
            assert torch.equal(x, y)

    checkpoint.save(str(tmp_path / "one.npz"), state, gen)
    back, gen_state = checkpoint.restore(str(tmp_path / "one.npz"), like)
    same(back, state)
    assert torch.equal(gen_state, gen.get_state())
    nxt = torch.rand(3, generator=gen)
    gen.set_state(gen_state)
    assert torch.equal(torch.rand(3, generator=gen), nxt)

    d = str(tmp_path / "ck")
    assert checkpoint.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_dir(d, like)
    checkpoint.save_dir(d, state._replace(step=3), gen)
    checkpoint.save_dir(d, state, gen)
    (tmp_path / "ck" / "40.npz.tmp").write_bytes(b"")  # a torn write
    assert checkpoint.latest_step(d) == 17
    back, gen_state, step = checkpoint.restore_dir(d, like)
    assert step == 17 and torch.equal(gen_state, gen.get_state())
    same(back, state)
    back, _, step = checkpoint.restore_dir(d, like, step=3)
    assert step == 3 and back.step == 3

    bad = dict(np.load(str(tmp_path / "one.npz")))
    bad["leaf_2"] = np.asarray(16, np.int32)
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="count 16 is not the step 17"):
        checkpoint.restore(str(tmp_path / "bad.npz"), like)
    wide = optim.init_state(Params(torch.zeros(4, 3), torch.zeros(1, 3)))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "one.npz"), wide)


@pytest.fixture(scope="module")
def problem():
    """The Cornell box at 8x6x4 spp, depth 3, on the plain backend (the
    seeds matter: every step draws two renders' seeds from `gen`)."""
    scene, params, cam = cbox.build(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=3)
    target = make_renderer(scene, cfg, cam, differentiable=False,
                           backend="torch")(
        params, torch.tensor([5, 6], dtype=torch.int32))
    init = Params(torch.full_like(params.albedo, 0.25),
                  torch.full_like(params.emission, 0.5))
    return scene, cfg, cam, target, init


def _run(problem, steps, **kw):
    scene, cfg, cam, target, init = problem
    return optim.inverse_render(scene, cfg, cam, target, init,
                                torch.Generator().manual_seed(3),
                                steps=steps, backend="torch", **kw)


def _saved(directory, step, init):
    state, gen_state, _ = checkpoint.restore_dir(
        str(directory), optim.init_state(init), step)
    return _leaves(state), gen_state


def _same_saves(d1, d2, init):
    """Both directories hold the same steps, each with the same bits."""
    names = sorted(p.name for p in d1.iterdir())
    assert names == sorted(p.name for p in d2.iterdir())
    for name in names:
        step = int(name.split(".")[0])
        (l1, s1), g1 = _saved(d1, step, init)
        (l2, s2), g2 = _saved(d2, step, init)
        assert s1 == s2 == step and torch.equal(g1, g2)
        for a, b in zip(l1, l2):
            assert torch.equal(a, b)
    return names


def test_resume_equals_the_uninterrupted_run(problem, tmp_path):
    """6 steps == 3 steps, a checkpoint, then a fresh state and generator
    resumed from it for 3 more: params, moments, step, generator state
    and losses bit for bit; a run already past `steps` returns the saved
    params and no metrics."""
    full, part = tmp_path / "full", tmp_path / "part"
    p6, m6 = _run(problem, 6, checkpoint_dir=str(full), checkpoint_every=3)
    _, m3 = _run(problem, 3, checkpoint_dir=str(part), checkpoint_every=3)
    p_res, m_res = _run(problem, 6, checkpoint_dir=str(part),
                        checkpoint_every=3)
    assert torch.equal(p_res.albedo, p6.albedo)
    assert torch.equal(p_res.emission, p6.emission)
    for k in ("loss", "grad_norm"):
        assert torch.equal(torch.cat([m3[k], m_res[k]]), m6[k])
    assert _same_saves(full, part, problem[4]) == ["3.npz", "6.npz"]
    p_past, m_past = _run(problem, 5, checkpoint_dir=str(part))
    assert m_past["loss"].shape == (0,)
    assert torch.equal(p_past.albedo, p6.albedo)


def test_blocked_steps_equal_single_steps(problem, tmp_path):
    """steps_per_call=4 == 1 with checkpoint_every=3: the blocks shorten
    so that the saves land on 3, 6 and the last step, 7."""
    p1, m1 = _run(problem, 7, checkpoint_dir=str(tmp_path / "one"),
                  checkpoint_every=3)
    p4, m4 = _run(problem, 7, checkpoint_dir=str(tmp_path / "four"),
                  checkpoint_every=3, steps_per_call=4)
    assert torch.equal(p1.albedo, p4.albedo)
    assert torch.equal(p1.emission, p4.emission)
    assert torch.equal(m1["loss"], m4["loss"])
    assert _same_saves(tmp_path / "one", tmp_path / "four",
                       problem[4]) == ["3.npz", "6.npz", "7.npz"]
    with pytest.raises(ValueError, match="steps_per_call"):
        _run(problem, 1, steps_per_call=0)


def test_cli_invert_resumes(tmp_path):
    """`invert --device cpu` writes the five keys and the metrics lines
    that --log-every selects; a second call with --steps 8 on the same
    checkpoint directory resumes at 6 and equals an 8-step run in a fresh
    directory."""
    small = ["-x", "8", "-y", "6", "-n", "4", "--max-depth", "3",
             "--device", "cpu", "--steps-per-call", "4", "--log-every", "2"]
    ck, jsonl = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")

    def invert(name, steps, directory, *extra):
        out = str(tmp_path / name)
        assert cli.main(["invert", "-o", out, "--steps", str(steps),
                         "--checkpoint-dir", directory, *small,
                         *extra]) == 0
        return json.load(open(out))

    first = invert("a.json", 6, ck, "--metrics-jsonl", jsonl)
    assert set(first) == {"true_albedo", "recovered_albedo",
                          "true_emission", "recovered_emission",
                          "final_loss"}
    assert checkpoint.latest_step(ck) == 6
    resumed = invert("b.json", 8, ck, "--metrics-jsonl", jsonl)
    assert checkpoint.latest_step(ck) == 8
    fresh = invert("c.json", 8, str(tmp_path / "fresh"))
    assert resumed == fresh and resumed != first
    recs = [json.loads(line) for line in open(jsonl)]
    assert [r["step"] for r in recs] == [0, 2, 4, 5, 6, 7]
    assert all({"step", "t", "loss", "grad_norm"} <= set(r) for r in recs)
