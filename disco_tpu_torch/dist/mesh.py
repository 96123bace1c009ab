"""A one-axis mesh of shards in one process, and its collectives over lists
of per-shard tensors (the counterpart of the `jax.sharding.Mesh` and the
`jax.lax` collectives that disco_tpu/dist/overlap_shard.py runs under
`jax.shard_map`).

A mesh is a list of `torch.device`s, one per shard.  Several shards may
share one device: `make_mesh(n)` puts n shards round-robin over the
visible CUDA cards, so on a one-card machine all n shards are on cuda:0.
Each collective takes one tensor per shard, in shard order, and returns
one per shard, each on its shard's device:

- `all_to_all`: tiled on dim 0 — shard d receives block d of every shard
  s, in shard order (`jax.lax.all_to_all(x, axis, 0, 0, tiled=True)`);
- `all_gather`: the shards' tensors concatenated on dim 0 (`tiled=True`),
  built once per distinct device and shared by the shards on it;
- `psum(1)` is `mesh.size`.

The engines' per-shard pieces between two collectives are plain functions
of one shard's tensors, so a launcher with one process per rank can run them
with `torch.distributed` collectives in place of these."""
from typing import List, Sequence

import torch

from ..overlap.relation import _default_device


class Mesh:
    """One torch.device per shard (shard s runs on devices[s])."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The distinct devices, in first-shard order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def replicate(self, x) -> List[torch.Tensor]:
        """x (a tensor or numpy array) once per distinct device, handed to
        every shard on that device."""
        per_dev = {d: torch.as_tensor(x).to(d) for d in self.distinct()}
        return [per_dev[d] for d in self.devices]

    def split(self, x) -> List[torch.Tensor]:
        """x cut on dim 0 into `size` equal blocks, block s on shard s's
        device (a `P(AXIS)` input)."""
        t = torch.as_tensor(x)
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {self.size} shards")
        return [b.to(d) for b, d in zip(t.chunk(self.size), self.devices)]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n: int, device=None) -> Mesh:
    """n shards.  With no `device`, round-robin over the visible CUDA cards;
    without a card this raises (no fallback to the CPU).  With a device
    ("cpu" in the tests), all n shards on it."""
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    if device is not None:
        return Mesh([device] * n)
    _default_device()          # raises without a card
    cards = torch.cuda.device_count()
    return Mesh([torch.device("cuda", s % cards) for s in range(n)])


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Shard d gets cat over s of block d of xs[s] (dim 0 cut into
    mesh.size equal blocks), on d's device."""
    n = mesh.size
    blocks = [x.chunk(n) for x in xs]
    return [torch.cat([blocks[s][d].to(dev) for s in range(n)])
            for d, dev in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard gets cat(xs) on its device; shards on one device share
    one tensor."""
    per_dev = {d: torch.cat([x.to(d) for x in xs]) for d in mesh.distinct()}
    return [per_dev[d] for d in mesh.devices]
