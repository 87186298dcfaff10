"""A device mesh for the renderers: the port of `drt_tpu.parallel.mesh`.

The JAX package shards the flat ray axis of a chunk over every device of
a (tiles, spp) mesh and lets the SPMD partitioner insert the gathers and
the all-reduce of the parameter-gradient partials (the analogue of the
reference's single-heap `m_grad += grad`, vector.hpp:185-191). Here the
same decomposition is explicit:

  a shard's rays   -> `ray_range`: shard k of S owns the contiguous slots
                      [k n / S, (k + 1) n / S) of a chunk (or pixels, for
                      the regeneration kernels), in the flat order of the
                      JAX package's `_dev_index` (row-major over the axes);
                      `per_shard` runs a function on each of them;
  per-ray outputs  -> `gather`: the shards' outputs concatenated in global
                      order, so that an image is reduced exactly as on one
                      device;
  gradient partials -> `sum_partials`: summed shard after shard in one
                      process, then `all_reduce`d across processes;
  scene + params   -> replicated: each shard reads them on its device.

A `Mesh` lists one `torch.device` per shard. The list may repeat a device:
shards on one card run one after the other (the counterpart of the JAX
tests' virtual 8-device CPU mesh). With a process group (`multihost`),
rank r owns the shards [r S / P, (r + 1) S / P) of P processes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape: the extent of each axis; axis_names: their names; devices:
    one per shard in flat order (row-major over the axes); group: the
    torch.distributed process group the shards span, or None for one
    process."""

    shape: tuple
    axis_names: tuple
    devices: tuple
    group: object = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        """The processes the mesh spans."""
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def owner(self, shard: int) -> int:
        """The rank of the process that runs `shard`."""
        return shard // (self.size // self.world)

    def local_shards(self) -> list:
        """The shards this process runs, in flat order."""
        return [k for k in range(self.size) if self.owner(k) == self.rank]


def _default_devices(group) -> list:
    """One device per rank when `group` spans processes (each rank's own:
    its current card, or the CPU), else every visible card."""
    if group is not None:
        import torch.distributed as dist

        own = (f"cuda:{torch.cuda.current_device()}"
               if torch.cuda.is_available() else "cpu")
        names = [None] * dist.get_world_size(group)
        dist.all_gather_object(names, own, group=group)
        return [torch.device(n) for n in names]
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device visible: pass devices, e.g. "
                         "[torch.device('cpu')] * 8")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_mesh(shape: tuple | None = None,
              axis_names: tuple = ("tiles", "spp"), devices=None) -> Mesh:
    """Build a (tiles, spp) mesh over `devices` (drt_tpu/parallel/mesh.py:
    make_mesh). Default factorization: an spp axis of 2 when the device
    count is even and at least 4, else 1.

    devices: one per shard, and may repeat a device. By default one per
    rank when torch.distributed is initialized (the mesh then spans its
    world), else every visible card. With processes, every rank passes
    the same global list, rank r's shards after rank r - 1's."""
    import torch.distributed as dist

    group = None
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        group = dist.group.WORLD
    if devices is None:
        devices = _default_devices(group)
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if shape is None:
        spp_ax = 2 if (n >= 4 and n % 2 == 0) else 1
        shape = (n // spp_ax, spp_ax)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} has {len(shape)} axes, names "
                         f"{tuple(axis_names)} {len(axis_names)}")
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh shape {shape} holds {size} shards, not the "
                         f"{n} devices given")
    mesh = Mesh(shape, tuple(axis_names), devices, group)
    if n % mesh.world:
        raise ValueError(f"{n} shards do not split over {mesh.world} "
                         "processes")
    return mesh


def shard_index(mesh: Mesh, coords) -> int:
    """The flat index of the shard at `coords` (one per axis): the JAX
    package's `_dev_index` (drt_tpu/fused.py:1079-1083)."""
    idx = 0
    for size, c in zip(mesh.shape, coords):
        idx = idx * size + int(c)
    return idx


def pad_to_multiple(n: int, mesh: Mesh) -> int:
    """Ray counts must divide evenly over the mesh; pad up."""
    m = mesh.size
    return ((n + m - 1) // m) * m


def local_count(n: int, mesh: Mesh, what: str = "rays per chunk") -> int:
    """The slots of one shard: n must split into whole shards (the JAX
    package raises the same way, drt_tpu/parallel/render.py:232-238)."""
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) must divide evenly over the "
                         f"{mesh.size}-shard mesh; adjust width/height/spp")
    return n // mesh.size


def ray_range(n: int, mesh: Mesh, shard: int) -> tuple:
    """[start, stop) of shard `shard`'s slots among n."""
    local = local_count(n, mesh)
    return shard * local, (shard + 1) * local


def per_shard(mesh: Mesh, n: int, run) -> dict:
    """{shard: run(shard, start, stop, device)} for each of this process's
    shards of `mesh`, [start, stop) its slots among n (`ray_range`)."""
    return {k: run(k, *ray_range(n, mesh, k), mesh.devices[k])
            for k in mesh.local_shards()}


def take(t: torch.Tensor, start: int, stop: int, device) -> torch.Tensor:
    """The slots [start, stop) of the last axis of `t`, on `device`."""
    return t[..., start:stop].to(device).contiguous()


def gather(mesh: Mesh, parts: dict, device) -> torch.Tensor:
    """The per-slot outputs of every shard (`parts`: this process's
    shards -> a tensor whose last axis is the shard's slots), joined along
    the last axis in global order on `device`. Across processes each rank
    broadcasts its shards' block in turn (gloo takes CUDA tensors in
    broadcast and all_reduce only), so every rank holds the whole."""
    mine = torch.cat([parts[k].to(device) for k in sorted(parts)], dim=-1)
    if mesh.group is None:
        return mine
    import torch.distributed as dist

    blocks = []
    for r in range(mesh.world):
        block = mine if r == mesh.rank else torch.empty_like(mine)
        dist.broadcast(block, src=dist.get_global_rank(mesh.group, r),
                       group=mesh.group)
        blocks.append(block)
    return torch.cat(blocks, dim=-1)


def sum_partials(mesh: Mesh, parts: dict, device) -> tuple:
    """The gradient partials of every shard (`parts`: this process's
    shards -> a tuple of tensors) summed: shard after shard in flat order
    here, then across processes by all_reduce, whose result every rank
    shares."""
    total = None
    for k in sorted(parts):
        p = tuple(t.to(device) for t in parts[k])
        total = p if total is None else tuple(a + b for a, b in zip(total, p))
    if mesh.group is not None:
        import torch.distributed as dist

        for t in total:
            dist.all_reduce(t, group=mesh.group)
    return total
