"""drt_tpu_torch.parallel.multihost on the CPU: the elastic tile scheduler
against the JAX package's, the tile renderer against the monolithic
render, and two processes over gloo rendering and training on a mesh of
one shard each.

The scheduler's tiles and fault draws are the JAX package's
(`drt_tpu.parallel.multihost.TileScheduler`): the same jobs and the same
`retries` for a fault_seed. The tiled image equals the monolithic one bit
for bit, both with the caller's global tapes and with the keyed draws at
the tiles' global ray ids. The two-process run (this file's `__main__`,
one worker per rank over a `file://` rendezvous) gives heartbeat() == 2,
the one-process image bit for bit, gradients within rtol 2e-5 / atol 1e-7
of it (the same partials summed in another order), and Adam steps
identical across the ranks."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drt_tpu.parallel import multihost as jax_mh
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import seeds_from_generator
from drt_tpu_torch.models import cbox
from drt_tpu_torch.parallel.multihost import (TileFailure, TileScheduler,
                                              heartbeat, make_tile_renderer)
from drt_tpu_torch.renderer import chunk_pixel_ids, render_image, trace_rays

GRAD_TOL = dict(rtol=2e-5, atol=1e-7)
REPO = Path(__file__).resolve().parents[1]
# The two-process run: Cornell box, 16x8 x 8 spp in 2 chunks, depth 3.
MP_CFG = dict(width=16, height=8, spp=8, spp_chunks=2, max_depth=3)
MP_SEEDS = [31, -4]


@pytest.mark.parametrize("w,h,tile", [(100, 70, 32), (64, 64, 16)])
def test_tiles_cover_the_image_as_the_jax_package_splits_it(w, h, tile):
    mine = TileScheduler(width=w, height=h, tile=tile)
    ref = jax_mh.TileScheduler(width=w, height=h, tile=tile)
    seen = np.zeros((h, w), np.int32)
    for j in mine.jobs:
        seen[j.y0:j.y0 + j.height, j.x0:j.x0 + j.width] += 1
    assert (seen == 1).all()
    assert [(j.index, j.y0, j.x0, j.height, j.width) for j in mine.jobs] == \
        [(j.index, j.y0, j.x0, j.height, j.width) for j in ref.jobs]
    parts = [mine.local_jobs(process_id=p, process_count=3)
             for p in range(3)]
    assert sorted(j.index for js in parts for j in js) == \
        [j.index for j in mine.jobs]
    assert [j.index for j in mine.local_jobs()] == \
        [j.index for j in mine.jobs]  # one process holds every tile


@pytest.mark.parametrize("fault_seed", [0, 1, 7])
def test_fault_draws_and_retries_are_the_jax_packages(fault_seed):
    """The same injected faults, so the same retries, for a fault_seed;
    the image is the fault-free run's."""
    def tile_of(job, seed):
        return np.full((job.height, job.width, 3), job.index + seed,
                       np.float32)

    mine = TileScheduler(48, 40, tile=8, fault_rate=0.3,
                         fault_seed=fault_seed)
    ref = jax_mh.TileScheduler(48, 40, tile=8, fault_rate=0.3,
                               fault_seed=fault_seed)
    img = mine.run(tile_of, seed=2)
    img_ref = ref.run(tile_of, seed=2)
    assert mine.retries == ref.retries > 0
    np.testing.assert_array_equal(img, img_ref)
    np.testing.assert_array_equal(
        img, TileScheduler(48, 40, tile=8).run(tile_of, seed=2))


def test_persistent_failure_raises():
    sched = TileScheduler(width=8, height=8, tile=8, max_attempts=2)

    def bad_tile(job, seed):
        raise TileFailure("always down")

    with pytest.raises(TileFailure):
        sched.run(bad_tile, seed=0)


def test_heartbeat_single_process():
    assert heartbeat() == 1


@pytest.fixture(scope="module")
def cornell():
    return cbox.build(device="cpu")


def test_tiles_with_global_tapes_equal_the_monolithic_render(cornell):
    scene, params, cam = cornell
    cfg = RenderConfig(width=32, height=24, spp=4, max_depth=3)
    n = cfg.width * cfg.height * cfg.spp
    r = np.random.default_rng(3)
    cam_u = torch.as_tensor(r.uniform(size=(n, 2)).astype(np.float32))
    tape = torch.as_tensor(
        r.uniform(size=(cfg.max_depth, 3, n)).astype(np.float32))
    from drt_tpu_torch.camera import camera_rays

    o, d, pdf = camera_rays(cam, cfg.width, cfg.height, chunk_pixel_ids(cfg),
                            cam_u)
    L = trace_rays(params, scene, o, d, cfg, tape=tape)
    mono = torch.stack([(c / pdf).reshape(cfg.height, cfg.width, cfg.spp)
                        .mean(-1) for c in L], -1).numpy()
    sched = TileScheduler(cfg.width, cfg.height, tile=16)
    img = sched.run(make_tile_renderer(scene, cam, cfg, params, cam_u=cam_u,
                                       tape=tape), seed=0)
    np.testing.assert_array_equal(img, mono)


def test_keyed_tiles_with_faults_equal_the_monolithic_render(cornell):
    """Without tapes each ray draws at its global (pixel, sample) ids:
    the tiles, retried after injected faults, are `render_image`'s image
    at the seed's pair, bit for bit."""
    scene, params, cam = cornell
    cfg = RenderConfig(width=32, height=24, spp=4, max_depth=3)
    sched = TileScheduler(cfg.width, cfg.height, tile=8, fault_rate=0.25,
                          fault_seed=1)
    img = sched.run(make_tile_renderer(scene, cam, cfg, params), seed=5)
    assert sched.retries > 0
    mono = render_image(params, scene, cam, seeds_from_generator(
        torch.Generator().manual_seed(5)), cfg)
    assert mono.mean() > 0
    np.testing.assert_array_equal(img, mono.numpy())
    with pytest.raises(ValueError, match="together"):
        make_tile_renderer(scene, cam, cfg, params, cam_u=torch.zeros(1))


def _spawn(tmp_path: Path, world: int):
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world), init,
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=120)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def test_two_processes_over_gloo_render_and_train_as_one(tmp_path):
    r0, r1 = _spawn(tmp_path, 2)
    assert int(r0["heartbeat"]) == int(r1["heartbeat"]) == 2
    assert json.loads(str(r0["mesh"])) == {"size": 2, "world": 2,
                                           "local": [0]}
    assert json.loads(str(r1["mesh"]))["local"] == [1]
    assert r0["img"].mean() > 0
    for key in ("img", "d_albedo", "d_emission", "adam_albedo",
                "adam_emission", "wf_img"):
        np.testing.assert_array_equal(r0[key], r1[key])
    np.testing.assert_array_equal(r0["img"], r0["img_one"])
    np.testing.assert_array_equal(r0["wf_img"], r0["wf_img_one"])
    assert np.abs(r0["d_albedo"]).max() > 0
    for name in ("d_albedo", "d_emission"):
        np.testing.assert_allclose(r0[name], r0[name + "_one"], **GRAD_TOL)
    assert not np.array_equal(r0["adam_albedo"], r0["albedo0"])


def _worker(rank: int, world: int, init: str, out: Path) -> None:
    """One rank of the two-process run: a mesh of one CPU shard per rank
    ("torch-sharded" and the wavefront), a forward + backward, 2 Adam
    steps; rank 0 also renders on one process for the reference."""
    from drt_tpu_torch import optim
    from drt_tpu_torch.parallel.mesh import make_mesh
    from drt_tpu_torch.parallel.multihost import initialize
    from drt_tpu_torch.parallel.render import make_renderer
    from drt_tpu_torch.scene import Params

    torch.set_num_threads(1)
    initialize(init_method=init, num_processes=world, process_id=rank)
    res = dict(heartbeat=heartbeat())
    mesh = make_mesh()
    res["mesh"] = json.dumps(dict(size=mesh.size, world=mesh.world,
                                  local=mesh.local_shards()))
    scene, params, cam = cbox.build(device="cpu")
    cfg = RenderConfig(**MP_CFG)
    seeds = torch.tensor(MP_SEEDS, dtype=torch.int32)

    def grads(render):
        p = Params(*(t.detach().clone().requires_grad_() for t in params))
        img = render(p, seeds)
        (img ** 2).sum().backward()
        return img.detach(), p.albedo.grad, p.emission.grad

    res["img"], res["d_albedo"], res["d_emission"] = grads(
        make_renderer(scene, cfg, cam, mesh=mesh))
    res["wf_img"] = make_renderer(scene, cfg, cam, mesh=mesh,
                                  differentiable=False,
                                  backend="torch-wavefront")(params, seeds)
    if rank == 0:
        res["img_one"], res["d_albedo_one"], res["d_emission_one"] = grads(
            make_renderer(scene, cfg, cam))
        res["wf_img_one"] = make_renderer(
            scene, cfg, cam, differentiable=False,
            backend="torch-wavefront")(params, seeds)
    start = Params(params.albedo * 0.7, params.emission)
    res["albedo0"] = start.albedo
    fitted, _ = optim.inverse_render(scene, cfg, cam, res["img"], start,
                                     torch.Generator().manual_seed(9),
                                     steps=2, mesh=mesh)
    res["adam_albedo"], res["adam_emission"] = fitted
    np.savez(out / f"rank{rank}.npz",
             **{k: (v.detach().numpy() if torch.is_tensor(v) else v)
                for k, v in res.items()})


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
            Path(sys.argv[4]))
