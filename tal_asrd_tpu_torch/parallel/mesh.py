"""Process mesh and sharding layout.

Counterpart of tal_asrd_tpu/parallel/mesh.py. The JAX package lays a
('data', 'model') mesh over its devices and lets XLA emit the collectives
from sharding annotations. Here the mesh is a `DeviceMesh` over the
processes of a `torch.distributed` group (one process a card, launched by
torchrun, or spawned by the caller), with the JAX axis names, and the
collectives are explicit (parallel/tensor.py, train/system.py):

  * data axis: each process takes its rows of the global batch
    (`shard_batch`), in JAX's device order; the gradients, the loss's token
    count, the frontend's mean and the batch's longest audio are reduced
    over it;
  * model axis: Megatron-style tensor parallelism of the decoder's
    attention and feed-forward projections, the TDS blocks' pointwise
    feed-forward and the token embedding (vocabulary rows), with the
    reference's rules (`_PARAM_RULES`, matched against each parameter's
    flax path), placed in PyTorch's layout: a flax `P(None, 'model')` on a
    Dense kernel [in, out] is `Shard(0)` of the Linear weight [out, in].

A multi-slice mesh ('dcn', 'data', 'model') shards the batch over ('dcn',
'data') jointly, as JAX's does.

`MeshLayout` is a mesh's shape alone (axis names and sizes), so the plan
(`batch_sharding`, `param_shardings`, `opt_state_shardings`) can be read
without a process group; every function here takes a `DeviceMesh` or a
`MeshLayout`.
"""
from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from tal_asrd_tpu_torch.core.convert import reference_dim_to_torch, unconvert_entry

logger = logging.getLogger(__name__)


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group (once) and return this process's device.

    The group is the one torchrun describes in the environment, or the
    caller's (`init_method`, `rank`, `world_size`). The backend is NCCL for
    a CUDA device (with gloo beside it for CPU tensors: the asynchronous
    checkpoint's background writes need one) and gloo for the CPU, unless
    `backend` names one: gloo on CUDA tensors runs several processes on one
    card, which NCCL refuses. A CUDA device without an index becomes the
    card of LOCAL_RANK (0 without torchrun)."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if backend is None:
            backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
        kwargs: Dict[str, Any] = {}
        if init_method is not None:
            kwargs["init_method"] = init_method
        if rank is not None:
            kwargs.update(rank=rank, world_size=world_size)
        dist.init_process_group(backend, **kwargs)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes; rank r sits at the row-major
    coordinates of r, as `init_device_mesh` lays ranks out."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def coords(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names, np.unravel_index(rank, self.sizes)))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("dcn", "data") if a in self.axis_names)

    @property
    def data_size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.data_axes]))

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def data_index(self, rank: int) -> int:
        """The rank's position along the data axes taken jointly (dcn
        major), JAX's order of the batch's shards."""
        c = self.coords(rank)
        index = 0
        for a in self.data_axes:
            index = index * self.shape[a] + int(c[a])
        return index

    def model_index(self, rank: int) -> int:
        return int(self.coords(rank).get("model", 0))


MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", MeshLayout]


def layout_of(mesh: MeshLike) -> MeshLayout:
    if isinstance(mesh, MeshLayout):
        return mesh
    return MeshLayout(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.mesh.shape))


def _resolve(world: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """Fill one -1 (the data axis) with world / the rest, and check the
    product against the world, as JAX asserts it against its devices."""
    sizes = list(sizes)
    rest = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if world % rest:
            raise ValueError(f"{world} processes do not split over the other axes ({rest})")
        sizes[sizes.index(-1)] = world // rest
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {world} processes")
    return tuple(sizes)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: launch with torchrun --nproc-per-node N "
                           "or call parallel.init_distributed first")
    return dist.get_world_size()


def _device_mesh(device_type: Optional[str], sizes, names):
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    _attach_groups(mesh)
    return mesh


def make_mesh(data: int = -1, model: int = 1, device_type: Optional[str] = None):
    """A ('data', 'model') DeviceMesh over every process of the group."""
    return _device_mesh(device_type, _resolve(_world(), (data, model)), ("data", "model"))


def make_multislice_mesh(dcn: int, data: int = -1, model: int = 1,
                         device_type: Optional[str] = None):
    """A ('dcn', 'data', 'model') DeviceMesh: the outer axis spans slices
    (hosts), the inner ones stay within a slice; the batch shards over
    ('dcn', 'data') jointly, the parameters over 'model'."""
    world = _world()
    if world % dcn:
        raise ValueError(f"{world} processes do not split into {dcn} slices")
    sizes = (dcn,) + _resolve(world // dcn, (data, model))
    return _device_mesh(device_type, sizes, ("dcn", "data", "model"))


def _attach_groups(mesh) -> None:
    """Build the mesh's two groups on every process (new_group is
    collective): the data axes taken jointly, and the model axis. Kept on
    the mesh as `tal_groups`."""
    lay = layout_of(mesh)
    ranks = np.arange(lay.size).reshape(lay.sizes)
    me = dist.get_rank()
    groups = {}
    for axes in (lay.data_axes, ("model",)):
        keep = [lay.axis_names.index(a) for a in axes]
        others = [i for i in range(len(lay.sizes)) if i not in keep]
        moved = np.moveaxis(ranks, keep, list(range(len(others), len(lay.sizes))))
        for members in moved.reshape(-1, int(np.prod([lay.sizes[i] for i in keep]))):
            members = [int(r) for r in members]
            group = dist.new_group(members) if len(members) > 1 else None
            if me in members:
                groups[axes] = (group, members)
    mesh.tal_groups = {"data": groups[lay.data_axes], "model": groups[("model",)]}


def mesh_group(mesh, axis: str):
    """(process group or None for one process, its ranks in axis order) of
    this process along 'data' (the data axes jointly) or 'model'."""
    return mesh.tal_groups[axis]


# ---------------------------------------------------------------------------
# Batch sharding
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over the data axes, the rest
    replicated: the rank at data index i of n takes rows [i B/n, (i+1) B/n)."""

    layout: MeshLayout
    ndim: int = 1

    @property
    def spec(self) -> Tuple:
        axes = self.layout.data_axes
        return (axes if len(axes) > 1 else axes[0],) + (None,) * (self.ndim - 1)

    def rows(self, batch_size: int, rank: Optional[int] = None) -> slice:
        n = self.layout.data_size
        if batch_size % n:
            raise ValueError(f"a batch of {batch_size} does not split over the data "
                             f"axes ({n})")
        i = self.layout.data_index(dist.get_rank() if rank is None else rank)
        part = batch_size // n
        return slice(i * part, (i + 1) * part)


def batch_sharding(mesh: MeshLike, ndim: int = 1) -> BatchSharding:
    return BatchSharding(layout_of(mesh), ndim)


def replicated_sharding(mesh: MeshLike) -> Replicate:
    return Replicate()


def shard_batch(mesh: MeshLike, batch, rank: Optional[int] = None):
    """This rank's rows of every array of a batch dict (numpy arrays or
    tensors, sliced where they are)."""
    def rows(x):
        sl = batch_sharding(mesh).rows(len(x), rank)
        return x[sl]

    return {k: rows(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------
# (regex over the flax path 'a/b/kernel', PartitionSpec in the reference's
# layout); first match wins. Megatron layout: column-parallel first FF and
# QKV projections, row-parallel second FF and attention output.
_PARAM_RULES = [
    (r".*linear1/kernel$", (None, "model")),
    (r".*linear1/bias$", ("model",)),
    (r".*linear2/kernel$", ("model", None)),
    (r".*linear2/bias$", ()),
    (r".*(self_attn|cross_attn|attn)/qkv/kernel$", (None, "model")),
    (r".*(self_attn|cross_attn|attn)/qkv/bias$", ("model",)),
    (r".*(self_attn|cross_attn|attn)/(kv|q)/kernel$", (None, "model")),
    (r".*(self_attn|cross_attn|attn)/(kv|q)/bias$", ("model",)),
    (r".*(self_attn|cross_attn|attn)/out_proj/kernel$", ("model", None)),
    (r".*(self_attn|cross_attn|attn)/out_proj/bias$", ()),
    (r".*embedding/embedding$", ("model", None)),
    (r".*fc1/kernel$", (None, None, "model")),
    (r".*fc1/bias$", ("model",)),
    (r".*fc2/kernel$", (None, "model", None)),
    (r".*fc2/bias$", ()),
]


def spec_for_path(path: str) -> Tuple:
    """The reference's PartitionSpec (a tuple) of a flax path."""
    for pattern, spec in _PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return ()


@dataclass(frozen=True)
class LeafPlan:
    """One parameter's placement: `path` its flax path, `spec` the
    reference's PartitionSpec (after the divisibility fallback), `ref_dim`
    the sharded axis in the reference's layout and `dim` in PyTorch's
    (None when replicated), `shape` and `ref_shape` the full shapes in
    PyTorch's and the reference's layouts."""

    path: str
    spec: Tuple
    ref_dim: Optional[int]
    dim: Optional[int]
    shape: Tuple[int, ...]
    ref_shape: Tuple[int, ...]

    @property
    def placement(self):
        return Replicate() if self.dim is None else Shard(self.dim)


def param_plan(mesh: MeshLike, named_shapes) -> Dict[str, LeafPlan]:
    """{PyTorch parameter name: LeafPlan} for (name, shape) pairs (or a
    module's named_parameters). A leaf whose sharded axis does not divide
    by the axis's size is replicated, with one warning naming it, as the
    reference does."""
    lay = layout_of(mesh)
    if hasattr(named_shapes, "named_parameters"):
        named_shapes = [(n, p.shape) for n, p in named_shapes.named_parameters()]
    plans = {}
    for name, shape in named_shapes:
        path, ref = unconvert_entry(name, torch.empty(tuple(shape), device="meta"))
        ps = "/".join(path)
        spec = spec_for_path(ps)
        ok = True
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            size = lay.shape.get(axis, 1)
            if dim >= ref.dim() or ref.shape[dim] % size:
                ok = False
                break
        if not ok:
            logger.warning("param_shardings: %s shape=%s indivisible by %s on mesh %s - "
                           "falling back to full replication", ps, tuple(ref.shape), spec,
                           lay.shape)
            spec = ()
        ref_dim = next((d for d, a in enumerate(spec) if a == "model"), None)
        if ref_dim is not None and lay.model_size == 1:
            ref_dim = None
        dim = None if ref_dim is None else reference_dim_to_torch(name, len(shape), ref_dim)
        plans[name] = LeafPlan(ps, spec, ref_dim, dim, tuple(shape), tuple(ref.shape))
    return plans


def param_shardings(mesh: MeshLike, model) -> Dict[str, Any]:
    """{parameter name: Shard(dim) or Replicate()} in PyTorch's layout."""
    return {n: p.placement for n, p in param_plan(mesh, model).items()}


def opt_state_shardings(mesh: MeshLike, optimizer, model) -> Dict[str, Any]:
    """Placements of the optimizer's state in the layout of its
    `reference_state()`: every moment tree that mirrors the parameters
    (LAMB's and RAdam's mu and nu, Lookahead's slow weights) follows the
    parameters' placements; Adafactor's factored moments follow the axis
    they keep of their parameter's; step counts and scalars are
    replicated."""
    from tal_asrd_tpu_torch.core.checkpoint import tree_from_leaves, tree_leaves
    plans = param_plan(mesh, model)
    by_path = {tuple(p.path.split("/")): p for p in plans.values()}

    def of_state(state):
        if not isinstance(state, dict):
            return Replicate()
        out = {}
        for key, value in state.items():
            if key in ("mu", "nu", "slow"):
                out[key] = tree_from_leaves(
                    (path, Replicate() if by_path[path].ref_dim is None
                     else Shard(by_path[path].ref_dim)) for path, _ in tree_leaves(value))
            elif key == "moments":
                out[key] = tree_from_leaves(
                    (path, _factored_placement(by_path[path[:-1]], path[-1]))
                    for path, _ in tree_leaves(value))
            else:
                out[key] = of_state(value)
        return out

    return of_state(optimizer.reference_state())


def _factored_placement(plan: LeafPlan, moment: str):
    """Placement, in the reference's layout, of Adafactor's `moment` (vr:
    the leaf less its last axis; vc: less its second last; v and m: the
    leaf's own) of a leaf sharded on `plan.ref_dim`."""
    a = plan.ref_dim
    if a is None:
        return Replicate()
    n = len(plan.ref_shape)
    if moment == "vr":
        return Replicate() if a == n - 1 else Shard(a)
    if moment == "vc":
        return Replicate() if a == n - 2 else Shard(a if a < n - 2 else n - 2)
    return Shard(a)
