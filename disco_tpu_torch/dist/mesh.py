"""A one-axis mesh of shards and its collectives over lists of per-shard
tensors (the counterpart of the `jax.sharding.Mesh` and the `jax.lax`
collectives that disco_tpu/dist/overlap_shard.py runs under
`jax.shard_map`).

A mesh has `size` shards in all.  A process holds a contiguous block of
them, its local shards: `shards` are their global ids and `devices` their
`torch.device`s.  Two layouts:

- one process holds every shard (`make_mesh`): `make_mesh(n)` puts n
  shards round-robin over the visible CUDA cards, so on a one-card machine
  all n shards are on cuda:0;
- one process per rank (`process_mesh`, dist/multiproc.py): rank r of a
  `torch.distributed` world of R ranks holds shards r * L .. r * L + L - 1
  of R * L, all on one device, process-major as disco_tpu's multiproc
  slices its devices.

Each collective takes one tensor per local shard, in shard order, and
returns one per local shard, each on its shard's device:

- `all_to_all`: tiled on dim 0 — shard d receives block d of every shard
  s, in global shard order (`jax.lax.all_to_all(x, axis, 0, 0,
  tiled=True)`);
- `all_gather`: every shard's tensor concatenated on dim 0 in global shard
  order (`tiled=True`), built once per distinct device and shared by the
  local shards on it;
- `psum(1)` is `mesh.size`.

With one process the collectives are copies; across processes they are
one `torch.distributed` call each over the mesh's process group
(`all_to_all_single`, `all_gather_into_tensor`), which the engines'
per-shard pieces between them never see.  NCCL and gloo both take the
tensors where they lie, on a card too (gloo moves a card's tensors
through host memory itself)."""
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..overlap.relation import _default_device


class Mesh:
    """This process's shards of a mesh of `size`: shard shards[i] runs on
    devices[i].  `group` is the process group of a mesh that spans
    processes (None: every shard is in this process)."""

    def __init__(self, devices: Sequence, size: int = None, first: int = 0,
                 group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.size = len(self.devices) if size is None else size
        self.shards = list(range(first, first + len(self.devices)))
        self.group = group
        if self.shards[-1] >= self.size:
            raise ValueError(f"shards {self.shards} of a mesh of "
                             f"{self.size}")
        if group is not None and len(self.distinct()) != 1:
            raise ValueError("a process holds its shards on one device")

    def distinct(self) -> List[torch.device]:
        """The distinct devices, in first-shard order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def replicate(self, x) -> List[torch.Tensor]:
        """x (a tensor or numpy array) once per distinct device, handed to
        every local shard on that device."""
        per_dev = {d: torch.as_tensor(x).to(d) for d in self.distinct()}
        return [per_dev[d] for d in self.devices]

    def split(self, x) -> List[torch.Tensor]:
        """x cut on dim 0 into `size` equal blocks, block s on shard s's
        device for each local shard s (a `P(AXIS)` input)."""
        t = torch.as_tensor(x)
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {self.size} shards")
        blocks = t.chunk(self.size)
        return [blocks[s].to(d) for s, d in zip(self.shards, self.devices)]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, shards "
                f"{self.shards} of {self.size})")


def make_mesh(n: int, device=None) -> Mesh:
    """n shards in this process.  With no `device`, round-robin over the
    visible CUDA cards; without a card this raises (no fallback to the
    CPU).  With a device ("cpu" in the tests), all n shards on it."""
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    if device is not None:
        return Mesh([device] * n)
    _default_device()          # raises without a card
    cards = torch.cuda.device_count()
    return Mesh([torch.device("cuda", s % cards) for s in range(n)])


def process_mesh(local: int, device) -> Mesh:
    """This rank's `local` shards on `device`, of a mesh of world * local
    shards over the default process group (initialised by the caller):
    rank r holds shards r * local .. r * local + local - 1."""
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh([device] * local, size=world * local, first=rank * local,
                group=dist.group.WORLD if world > 1 else None)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the collectives carry it: bool as uint8 (a view), which every
    backend exchanges."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Local shard d gets cat over all s of block d of shard s's tensor
    (dim 0 cut into mesh.size equal blocks), on d's device."""
    n = mesh.size
    if mesh.group is None:
        blocks = [x.chunk(n) for x in xs]
        return [torch.cat([blocks[s][d].to(dev) for s in range(n)])
                for d, dev in enumerate(mesh.devices)]
    # every peer's blocks must have one shape (route_cap and fetch_cap fix
    # it): all_to_all_single takes equal splits, and a rank whose split
    # differed would wait for bytes that never come
    local = len(xs)
    shape = xs[0].shape
    if any(x.shape != shape for x in xs) or shape[0] % n:
        raise ValueError("unequal all_to_all blocks: "
                         f"{[tuple(x.shape) for x in xs]} over {n} shards")
    block = (shape[0] // n, *shape[1:])
    # send[r, s, d]: local shard s's block for shard d of rank r
    send = torch.stack([_wire(x).reshape(n // local, local, *block)
                        for x in xs], 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[r, s, d]: shard s of rank r's block for local shard d
    return [recv[:, :, d].reshape(-1, *block[1:]).view(xs[0].dtype)
            for d in range(local)]


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every local shard gets cat over all shards' tensors (global shard
    order) on its device; local shards on one device share one tensor."""
    if mesh.group is None:
        per_dev = {d: torch.cat([x.to(d) for x in xs])
                   for d in mesh.distinct()}
        return [per_dev[d] for d in mesh.devices]
    local = _wire(torch.cat(list(xs)))
    out = local.new_empty((mesh.size // len(xs) * local.shape[0],
                           *local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=mesh.group)
    return [out.view(xs[0].dtype)] * len(xs)


def barrier(mesh: Mesh) -> None:
    """Every process of a mesh that spans processes waits for the others;
    nothing in one process."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def gather_host(mesh: Mesh, xs: Sequence[torch.Tensor]) -> np.ndarray:
    """Every shard's tensor, in global shard order, concatenated on dim 0
    on the host (disco_tpu's global array as numpy): across processes
    through one `all_gather`, so that every rank holds the whole."""
    if mesh.group is None:
        return torch.cat([x.cpu() for x in xs]).numpy()
    return all_gather(mesh, xs)[0].cpu().numpy()
