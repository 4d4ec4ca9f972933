"""The device grid and element sharding (port of
admm_optim_tpu/parallel/sharding.py).

A JAX ``Mesh`` of ("batch", "space") devices becomes a grid of
torch.distributed ranks: rank r sits at batch row r // n_space and space
column r % n_space, and the ranks of one batch row form a space group, the
group the patch exchange and the reductions of a sharded solve run in
(parallel.patch_shard).  The batch axis shards a design sweep of problem
instances; the space axis shards elements or patches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_batch, n_space) grid of ranks."""

    n_batch: int
    n_space: int
    batch_index: int
    space_index: int
    space_group: Any  # torch.distributed ProcessGroup of this rank's batch row
    device: torch.device


def make_mesh(n_space: int, n_batch: int = 1, device="cpu") -> Mesh:
    """The calling rank's Mesh in a default group of n_batch * n_space
    ranks.  Every rank must call it: each space group is created by all
    ranks, in one order."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world != n_space * n_batch:
        raise ValueError(f"need {n_space * n_batch} ranks, the group has {world}")
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(b * n_space, (b + 1) * n_space))) for b in range(n_batch)]
    b, s = divmod(rank, n_space)
    return Mesh(n_batch, n_space, b, s, groups[b], torch.device(device))


def _block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous part of n items split over the space axis."""
    if n % mesh.n_space:
        raise ValueError(f"{n} items do not split over {mesh.n_space} ranks (pad_elements)")
    per = n // mesh.n_space
    return slice(mesh.space_index * per, (mesh.space_index + 1) * per)


def shard_elements(mesh: Mesh, *arrays):
    """This rank's contiguous block of element-indexed arrays (leading dim
    E, a multiple of the space axis' size), on the mesh's device."""
    out = [torch.as_tensor(np.ascontiguousarray(np.asarray(a)[_block(mesh, len(a))]), device=mesh.device)
           for a in arrays]
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    """The whole arrays on the mesh's device, as every rank holds them."""
    out = [torch.as_tensor(np.asarray(a), device=mesh.device) for a in arrays]
    return out if len(out) > 1 else out[0]


def pad_elements(elems_np: np.ndarray, multiple: int):
    """Pad the element list to a multiple of the space-axis size with
    degenerate copies of element 0 carrying zero weight downstream."""
    E = len(elems_np)
    pad = (-E) % multiple
    if pad == 0:
        return elems_np, np.ones(E, bool)
    padded = np.concatenate([elems_np, np.repeat(elems_np[:1], pad, axis=0)])
    valid = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    return padded, valid
