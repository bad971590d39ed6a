"""Process meshes, batch sharding and the gradient all-reduce of
data-parallel training.

Counterpart of storygen_tpu/parallel/mesh.py. The JAX package runs one
process over all its chips and lets XLA insert the gradient psum; the port
runs one process per rank over torch.distributed and issues every
collective itself. A `Mesh` names the world's ranks by coordinates,
row-major over its shape (rank = d * tensor + t on a (data, tensor) mesh),
and holds one process group per slice of each axis (and of the batch axes
together), made by every rank with `dist.new_group` in one order. Without
an initialized process group a mesh has one rank, and its collectives do
nothing.

The batch shards over every axis but "tensor": on a hybrid (dcn, data)
mesh over both, as `batch_sharding` does there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DCN_AXIS = "dcn"
TENSOR_AXIS = "tensor"

# Batch keys whose arrays are ref-major (N_refs, B, ...): their batch axis
# is axis 1 (data/loader.py's collate layout).
REF_MAJOR_KEYS = frozenset(
    {"ref_images", "ref_input_ids", "ref_latent_moments", "ref_masks"})


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """The world's ranks as an array of `shape` with named axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} with axes {names}")
        rank, size = world()
        if math.prod(shape) != size:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks;"
                             f" the world has {size}")
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.axis_names = names
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(names, (
            int(c) for c in np.unravel_index(rank, shape))))
        self.batch_axes = tuple(a for a in names if a != TENSOR_AXIS)
        self._groups = {}
        for axes in [(a,) for a in names] + [self.batch_axes]:
            if axes not in self._groups:
                self._groups[axes] = self._new_group(axes)

    def _new_group(self, axes: Tuple[str, ...]):
        """Every rank makes every slice's group (dist.new_group is
        collective); this rank keeps the one it belongs to."""
        if not dist.is_initialized():
            return None
        names = self.axis_names
        ids = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        inner = [i for i, a in enumerate(names) if a in axes]
        outer = [i for i, a in enumerate(names) if a not in axes]
        mine = None
        for ranks in ids.transpose(outer + inner).reshape(
                -1, self.size(*axes)):
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = group
        return mine

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's position among the ranks that differ only on
        `axes` (row-major over them)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group of this rank's slice along `axes` (None
        without a process group)."""
        return self._groups[tuple(axes)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the world (n_devices, if given, must be
    its size)."""
    n = world()[1] if n_devices is None else n_devices
    return Mesh((n,), (DATA_AXIS,))


def make_hybrid_mesh(n_slices: int) -> Mesh:
    """2-D (dcn, data) mesh: axis 0 spans the slices (hosts), axis 1 the
    ranks within one; the batch shards over both."""
    n = world()[1]
    if n % n_slices:
        raise ValueError(f"{n} ranks not divisible into {n_slices} slices")
    return Mesh((n_slices, n // n_slices), (DCN_AXIS, DATA_AXIS))


def batch_rows(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch that this rank holds: a contiguous block
    per position along the batch axes."""
    n = mesh.size(*mesh.batch_axes)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not split over {n} "
                         "ranks")
    b = global_batch // n
    i = mesh.index(*mesh.batch_axes)
    return slice(i * b, (i + 1) * b)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays, tensors or
    lists). Decided by key name, not shape: REF_MAJOR_KEYS shard on axis
    1, everything else on axis 0."""
    out = {}
    for key, x in batch.items():
        axis = 1 if key in REF_MAJOR_KEYS else 0
        rows = batch_rows(mesh, len(x) if axis == 0 else x.shape[1])
        out[key] = x[rows] if axis == 0 else x[:, rows]
    return out


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values of every tensor in `tree` (a module, or dicts and
    lists of tensors) on every rank, in place; returns `tree`."""
    if dist.is_initialized() and mesh.size(*mesh.axis_names) > 1:
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0)
    return tree


@torch.no_grad()
def allreduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over `group`, in place, through one
    fp32 all-reduce of one flat buffer: the counterpart of the psum that
    XLA puts into the JAX package's data-parallel step. Without a process
    group it does nothing."""
    if not dist.is_initialized() or not tensors:
        return
    n = dist.get_world_size(group)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(n)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
