"""Multi-process runtime: process groups, liveness, elastic tiles.

The port of `drt_tpu.parallel.multihost`. The reference has no
distributed anything (SURVEY.md §2/§5: one OS thread,
src/render.cpp:72-86). Here:

- `initialize` starts `torch.distributed`: NCCL when each rank has a card
  of its own, gloo on the CPU and for ranks that share a card (NCCL
  refuses two ranks on one device; gloo takes CUDA tensors in broadcast
  and all_reduce, which is all the mesh's gather and gradient sum use).
- `heartbeat`: an all_reduce of one mark per process, which counts the
  processes; a peer that is gone makes it raise after the group's timeout
  rather than hang, the signal for re-sharding or restart.
- `TileScheduler`: elastic, idempotent tile rendering. The image is split
  into pixel tiles whose jobs are pure functions of (params, tile, seed),
  so a failed tile is simply dispatched again; `fault_rate` injects
  failures to exercise that (the same draws as the JAX package's).
- `make_tile_renderer`: a tile job over the wavefront (`camera.camera_rays`
  + `renderer.trace_rays`), whose draws are the keyed hash at the tile's
  global (pixel, sample) ids, so that the tiled image is the monolithic
  wavefront render's.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Callable

import numpy as np
import torch

# How long a collective waits for a peer before it raises.
TIMEOUT = datetime.timedelta(seconds=120)


def initialize(init_method: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               coordinator_address: str | None = None) -> None:
    """Start the process group of `num_processes` ranks, this one
    `process_id` (a no-op for one process). init_method is a URL
    ("tcp://host:port", "file:///path"); coordinator_address ("host:port",
    the JAX package's argument) stands for "tcp://host:port". backend
    defaults to NCCL when this process's card is its own (fewer ranks on
    the host than cards), else gloo. A collective waits `TIMEOUT` for a
    peer. A group that fails to start raises."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("pass init_method or coordinator_address")
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and num_processes <= torch.cuda.device_count())
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def heartbeat(device=None) -> int:
    """All-reduce a liveness mark across processes: the number of
    processes that took part (1 without a group). The mark lies on
    `device` (by default the card when there is one, as NCCL needs).
    Raises, after the group's timeout, if a peer is gone."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1
    if device is None:
        device = "cuda" if (dist.get_backend() == "nccl") else "cpu"
    mark = torch.ones(1, dtype=torch.int32, device=device)
    dist.all_reduce(mark)
    return int(mark.item())


@dataclasses.dataclass
class TileJob:
    index: int
    y0: int
    x0: int
    height: int
    width: int
    attempts: int = 0


class TileFailure(RuntimeError):
    pass


class TileScheduler:
    """Elastic tile-based render loop (drt_tpu/parallel/multihost.py:
    62-140).

    render_tile(job, seed) -> f[th, tw, 3] must be pure and idempotent
    (same job + seed -> same tile), which makes re-dispatch after any
    failure trivially correct. Non-finite outputs and exceptions both
    count as failures; tiles are retried up to `max_attempts` times.
    """

    def __init__(self, width: int, height: int, tile: int = 128,
                 max_attempts: int = 3, fault_rate: float = 0.0,
                 fault_seed: int = 0):
        self.width = width
        self.height = height
        self.tile = tile
        self.max_attempts = max_attempts
        self.fault_rate = fault_rate
        self._fault_rng = np.random.default_rng(fault_seed)
        self.jobs = []
        idx = 0
        for y0 in range(0, height, tile):
            for x0 in range(0, width, tile):
                self.jobs.append(TileJob(
                    index=idx, y0=y0, x0=x0,
                    height=min(tile, height - y0),
                    width=min(tile, width - x0)))
                idx += 1
        self.retries = 0

    def run(self, render_tile: Callable[[TileJob, int], np.ndarray],
            seed: int = 0) -> np.ndarray:
        """Render all tiles, re-dispatching failures. Returns f[H,W,3]."""
        img = np.zeros((self.height, self.width, 3), np.float32)
        queue = list(self.jobs)
        while queue:
            job = queue.pop(0)
            job.attempts += 1
            try:
                if (self.fault_rate > 0.0 and job.attempts == 1
                        and self._fault_rng.uniform() < self.fault_rate):
                    raise TileFailure(
                        f"injected fault on tile {job.index}")
                out = render_tile(job, seed)
                out = np.asarray(out.detach().cpu() if torch.is_tensor(out)
                                 else out)
                if out.shape != (job.height, job.width, 3):
                    raise TileFailure(
                        f"tile {job.index}: bad shape {out.shape}")
                if not np.isfinite(out).all():
                    raise TileFailure(f"tile {job.index}: non-finite")
            except Exception:
                if job.attempts >= self.max_attempts:
                    raise
                self.retries += 1
                queue.append(job)
                continue
            img[job.y0:job.y0 + job.height,
                job.x0:job.x0 + job.width] = out
        return img

    def local_jobs(self, process_id: int | None = None,
                   process_count: int | None = None) -> list[TileJob]:
        """Static round-robin assignment of tiles to this process (its
        rank and the world size by default); the orchestration layer
        re-runs `run` over a dead peer's jobs."""
        pid = _rank() if process_id is None else process_id
        n = _world() if process_count is None else process_count
        return [j for j in self.jobs if j.index % n == pid]


def make_tile_renderer(scene, cam, base_cfg, params, cam_u=None, tape=None):
    """Build a `render_tile(job, seed) -> f[th, tw, 3]` for TileScheduler
    over the wavefront (`camera.camera_rays` + `renderer.trace_rays` on
    the camera's device): each tile is a sub-image at its own pixels.

    cam_u/tape: optional GLOBAL uniforms (f[N, 2] camera jitter, f[D, 3,
    N] bounce tape, N = W*H*spp in the monolithic raster pixel-major /
    spp-minor ray order); each tile reads its rays' slice of them, so the
    tiled image equals the monolithic render exactly. Without them each
    ray draws from the keyed hash at its global (pixel, sample) ids under
    the seed pair `fused.seeds_from_generator(Generator().manual_seed(
    seed))`, which makes each tile pure in (job, seed) and the tiled image
    `renderer.render_image`'s at that pair in one chunk. (The JAX package
    draws a tile from fold_in(key(seed), tile), which ties the draws to
    the tiling.)"""
    from drt_tpu_torch.camera import camera_rays
    from drt_tpu_torch.fused import seeds_from_generator
    from drt_tpu_torch.ops.rng import camera_draws
    from drt_tpu_torch.renderer import trace_rays

    spp = base_cfg.spp
    use_tape = tape is not None
    if use_tape != (cam_u is not None):
        raise ValueError("pass cam_u and tape together (or neither)")
    dev = cam.forward.device

    def render_tile(job: TileJob, seed: int) -> torch.Tensor:
        ys, xs = np.mgrid[job.y0:job.y0 + job.height,
                          job.x0:job.x0 + job.width]
        pix = torch.as_tensor(ys.ravel() * base_cfg.width + xs.ravel(),
                              device=dev).repeat_interleave(spp)
        s = torch.arange(spp, device=dev).repeat(job.height * job.width)
        xy = torch.stack([pix % base_cfg.width, pix // base_cfg.width],
                         -1).to(torch.int32)
        kw = {}
        if use_tape:
            gid = pix * spp + s  # global ray ids, pixel-major, spp minor
            cu = cam_u[gid.to(cam_u.device)].to(dev)
            kw["tape"] = tape[:, :, gid.to(tape.device)].to(dev)
        else:
            seeds = seeds_from_generator(
                torch.Generator().manual_seed(int(seed))).tolist()
            cu = camera_draws(seeds[0], pix, s, cam.forward.dtype).T
            kw.update(seeds=seeds, pix=pix, sample=s)
        o, d, pdf = camera_rays(cam, base_cfg.width, base_cfg.height, xy, cu)
        L = trace_rays(params, scene, o, d, base_cfg, **kw)
        return torch.stack([(c / pdf).reshape(job.height, job.width, spp)
                            .mean(-1) for c in L], -1)

    return render_tile
