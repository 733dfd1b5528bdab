"""Tensor parallelism over the mesh's 'model' axis, with explicit
collectives (Megatron's layout).

`parallelize(model, mesh)` keeps, on each process, its shard of every
parameter that `param_plan` shards, and marks the layers that use them:

  * a column-parallel `Linear` (weight `Shard(0)`: the decoder's `qkv`,
    `q`, `kv`, `linear1`, the TDS blocks' `fc1`) takes the replicated
    input through `copy_to_model` (identity forward, gradient summed over
    the axis) and gives its shard of the output features;
  * a row-parallel `Linear` (weight `Shard(1)`: `out_proj`, `linear2`,
    `fc2`) sums its partial products over the axis (`reduce_from_model`,
    in float32, rounded once) and adds the replicated bias after the sum;
  * attention runs on the process's heads; the mean over heads of the
    attention weights is summed over the axis;
  * the token embedding keeps its vocabulary rows: a lookup takes the
    rows it holds and zeros, summed over the axis; the tied output head
    gives the rows' logits, gathered along the vocabulary.

The fused projections (`qkv` [3D, D], `kv` [2D, D]) keep, on each process,
the Q, K and V rows of its heads: the shard of a row permutation of the
full weight (`fused_perm`), so that the split of the local output into Q,
K and V is the split of the full one restricted to the process's heads.
The reference shards those kernels contiguously, which is only a layout
to XLA; `gather` undoes the permutation, so the gathered parameters and
moments are the reference's.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from tal_asrd_tpu_torch.parallel.mesh import LeafPlan, mesh_group, param_plan

_FUSED = re.compile(r"(^|\.)(self_attn\.qkv|cross_attn\.kv|attn\.qkv)\.(weight|bias)$")


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over `group` (a no-op without one)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    out = t.to(torch.float32, copy=True).contiguous()
    all_reduce_(out, group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.size = dist.get_world_size(group)
        # in float32, as the sums: a bf16 tensor comes back the same bits
        x32 = x.to(torch.float32).contiguous()
        parts = [torch.empty_like(x32) for _ in range(ctx.size)]
        dist.all_gather(parts, x32, group=group)
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate the processes' x along the last axis, in axis order."""
    return x if group is None else _GatherFromModel.apply(x, group)


def fused_perm(name: str, size: int, parts: int) -> Optional[torch.Tensor]:
    """Row order of a fused projection under which chunk r of `parts` holds
    rank r's heads of each of its blocks (Q, K, V or K, V); None for any
    other parameter."""
    m = _FUSED.search(name)
    if m is None:
        return None
    blocks = 3 if m.group(2).endswith("qkv") else 2
    width = size // blocks
    step = width // parts
    return torch.cat([torch.arange(b * width + r * step, b * width + (r + 1) * step)
                      for r in range(parts) for b in range(blocks)])


class ModelShards:
    """The model axis's plan for one model on this process: `local` cuts a
    full tensor to this process's shard, `gather` joins the shards (a
    collective over the axis)."""

    def __init__(self, plans: Dict[str, LeafPlan], group, size: int, rank: int):
        self.plans = plans
        self.group = group
        self.size = size
        self.rank = rank

    def sharded(self, name: str) -> bool:
        plan = self.plans.get(name)
        return plan is not None and plan.dim is not None

    def local(self, name: str, full: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """The shard of `full` (the parameter `name`, or a tensor whose axis
        `dim` is that parameter's sharded axis) this process keeps."""
        dim = self.plans[name].dim if dim is None else dim
        perm = fused_perm(name, full.shape[dim], self.size)
        if perm is not None:
            full = full.index_select(dim, perm.to(full.device))
        return full.chunk(self.size, dim=dim)[self.rank].contiguous()

    def gather(self, name: str, local: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """The full tensor from every process's shard along `dim` (default
        the parameter's sharded axis); every process of the axis calls it."""
        dim = self.plans[name].dim if dim is None else dim
        moved = local.movedim(dim, -1).contiguous()
        full = gather_from_model(moved, self.group).movedim(-1, dim)
        perm = fused_perm(name, full.shape[dim], self.size)
        if perm is not None:
            full = full.index_select(dim, torch.argsort(perm).to(full.device))
        return full.contiguous()


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    mod._parameters[leaf] = nn.Parameter(value, requires_grad=True)


def parallelize(model: nn.Module, mesh) -> Optional[ModelShards]:
    """Cut `model`'s parameters to this process's shards along the mesh's
    'model' axis (every process must hold the same full parameters) and
    mark its layers; returns the `ModelShards`, also kept as `model.tp`
    (None on a model axis of one)."""
    from tal_asrd_tpu_torch.models.decoder import CrossAttention, SelfAttention
    from tal_asrd_tpu_torch.models.layers import Linear

    group, members = mesh_group(mesh, "model")
    model.tp = None
    if len(members) == 1:
        return None
    plans = param_plan(mesh, model)
    shards = ModelShards(plans, group, len(members), members.index(dist.get_rank()))
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if shards.sharded(name):
                _set_param(model, name, shards.local(name, p.detach()))
    for mname, mod in model.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(mod, Linear) and shards.sharded(prefix + "weight"):
            mod.tp_mode = "col" if plans[prefix + "weight"].dim == 0 else "row"
            mod.tp_group = group
        if isinstance(mod, (SelfAttention, CrossAttention)):
            projections = ("qkv", "out_proj") if isinstance(mod, SelfAttention) else (
                "q", "kv", "out_proj")
            cut = [shards.sharded(f"{prefix}{p}.weight") for p in projections]
            if any(cut):
                if not all(cut) or mod.n_head % shards.size:
                    raise ValueError(f"{mname}: {mod.n_head} heads do not split over a "
                                     f"model axis of {shards.size}")
                mod.head_group = group
    if shards.sharded("embedding.weight"):
        rows = plans["embedding.weight"].shape[0] // shards.size
        model.vocab_shard = (group, shards.rank * rows, rows)
    model.tp = shards
    return shards
