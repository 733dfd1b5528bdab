"""Carry the reference's parameter trees into the port's modules.

The reference stores parameters as a nested dict (flax naming and layouts);
the port's modules are `nn.Module`s with PyTorch layouts. This module is the
one place where names and layouts are translated:

  reference leaf                          port state_dict entry
  --------------------------------------  ------------------------------------
  .../kernel  [in, out]      (Dense)      ....weight  [out, in]
  .../kernel  [1, in, out]   (1x1 conv)   ....weight  [out, in]     (nn.Linear)
  .../kernel  [K, C_in/G, C_out], K > 1   ....weight  [C_out, C_in/G, K]
  .../bias                                ....bias
  embedding/embedding  [V, E]             embedding.weight
  embedding_proj  [E, D]                  embedding_proj   (bare parameter,
                                          used in both directions)
  resweight, resweight_src, mem_pos_alpha same name (0-dim)
  layers_<i>                              layers.<i>       (nn.ModuleList)

A 3-D kernel with one tap is taken for a pointwise conv: the model has no
grouped conv with kernel 1, and `load_into` checks every shape against the
module it fills.

Leaves may be float arrays or bfloat16 bit patterns as `core/checkpoint.py`
returns them; the latter become `torch.bfloat16` through a view, without a
round trip through float32.

`state_dict_to_params` is the inverse, for the checkpoint writer and the
gradient-parity tests: a 2-D weight under `encoder.` goes back to a 1x1 conv
kernel [1, in, out] (the encoder's only dense layers are the TDS blocks'
pointwise convs), any other 2-D weight to a Dense kernel [in, out], a 3-D
weight to a grouped-conv kernel [K, C_in/G, C_out]. bfloat16 tensors become
bfloat16 bit patterns (`core/checkpoint.py`), every other tensor a numpy
array of its dtype.

`unconvert_entry` is that inverse for one entry, as a view (the optimizers
factor and update a parameter in the reference's layout through it).
`params_spec` gives the tree's shapes and dtypes alone (the target of a
partial load), and `load_partial_into` copies in what such a load returned.
"""
from __future__ import annotations

import functools
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from tal_asrd_tpu_torch.core.checkpoint import (
    BFLOAT16_BITS, LeafSpec, to_numpy, to_tensor, tree_from_leaves, tree_leaves)

_LAYER_RE = re.compile(r"^layers_(\d+)$")


def _convert_leaf(path: Tuple[str, ...], value: Any) -> Tuple[str, torch.Tensor]:
    parts = []
    for part in path[:-1]:
        m = _LAYER_RE.match(part)
        parts.extend(["layers", m.group(1)] if m else [part])
    leaf = path[-1]
    t = to_tensor(value)
    if leaf == "kernel":
        if t.dim() == 2:                       # Dense [in, out]
            t = t.T
        elif t.dim() == 3 and t.shape[0] == 1:  # pointwise conv [1, in, out]
            t = t[0].T
        elif t.dim() == 3:                     # grouped conv [K, C_in/G, C_out]
            t = t.permute(2, 1, 0)
        else:
            raise ValueError(f"kernel {'/'.join(path)} has rank {t.dim()}")
        parts.append("weight")
    elif leaf == "embedding" and path[:-1] and path[-2] == "embedding":
        parts.append("weight")
    else:
        parts.append(leaf)
    return ".".join(parts), t.contiguous()


def params_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference parameter tree (with or without a top-level 'params') ->
    state_dict of the port's ASRModel, of its sub-modules, or of the
    DecoderLMModel (models/lm.py: the same names, `layers_<i>` blocks)."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in tree_leaves(tree):
        name, tensor = _convert_leaf(path, value)
        if name in out:
            raise ValueError(f"two leaves map to {name}")
        out[name] = tensor
    return out


def load_into(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Fill `model` from a reference parameter tree, casting to the model's
    dtype and device. Raises if a leaf is left over, a parameter is left
    unfilled, or a shape disagrees."""
    model.load_state_dict(params_to_state_dict(tree), strict=True)
    return model


def params_spec(model) -> Dict[str, Any]:
    """The model's parameter tree (or a state_dict's) in the reference's
    names and layouts with a `LeafSpec` (shape, numpy dtype) for each leaf,
    read from the parameters' metadata: nothing is copied from the
    device."""
    leaves = []
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    for name, t in sd.items():
        path, t = unconvert_entry(name, t.detach().to("meta"))
        dtype = BFLOAT16_BITS if t.dtype == torch.bfloat16 else np.dtype(
            str(t.dtype).replace("torch.", ""))
        leaves.append((path, LeafSpec(t.shape, dtype)))
    return tree_from_leaves(leaves)


def load_partial_into(model: nn.Module, tree: Dict[str, Any], localize=None) -> None:
    """Fill `model` from a tree that `load_params_partial` returned on its
    `params_spec`: every array leaf is converted and copied in; a `LeafSpec`
    leaf (a parameter the load kept) leaves the parameter as it is.
    `localize` maps the converted state_dict to the model's own (a
    tensor-parallel model's shards)."""
    loaded = params_to_state_dict(tree_from_leaves(
        (path, v) for path, v in tree_leaves(tree) if not isinstance(v, LeafSpec)))
    if localize is not None:
        loaded = localize(loaded)
    own = model.state_dict()
    unknown = sorted(set(loaded) - set(own))
    if unknown:
        raise KeyError(f"leaves with no parameter: {unknown}")
    model.load_state_dict(loaded, strict=False)     # shapes checked


@functools.lru_cache(maxsize=None)
def _reference_path(name: str) -> Tuple[Tuple[str, ...], str]:
    """A state_dict key -> (the reference's module path, the leaf's name)."""
    parts = name.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "layers" and parts[i + 1].isdigit():
            path.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return tuple(path), parts[-1]


def unconvert_entry(name: str, t: torch.Tensor) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """A state_dict entry -> (the reference's key path, `t` in the
    reference's layout). The layout is a view of `t` (a transpose or a
    permutation), so writing into it writes into `t`."""
    path, leaf = _reference_path(name)
    path = list(path)
    if leaf == "weight" and path and path[-1] == "embedding":
        return tuple(path) + ("embedding",), t
    if leaf == "weight":
        if t.dim() == 2 and path[:1] == ["encoder"]:  # pointwise conv
            t = t.T[None]
        elif t.dim() == 2:                           # Dense
            t = t.T
        elif t.dim() == 3:                           # grouped conv
            t = t.permute(2, 1, 0)
        else:
            raise ValueError(f"weight {name} has rank {t.dim()}")
        return tuple(path) + ("kernel",), t
    return tuple(path) + (leaf,), t


def reference_dim_to_torch(name: str, ndim: int, ref_dim: int) -> int:
    """The axis of a state_dict entry of rank `ndim` that is axis `ref_dim`
    of its layout in the reference (`unconvert_entry`'s view)."""
    path, leaf = _reference_path(name)
    if leaf != "weight" or path[-1:] == ("embedding",):
        return ref_dim
    if ndim == 2 and path[:1] == ("encoder",):      # [out, in] <- [1, in, out]
        return {1: 1, 2: 0}[ref_dim]
    return ndim - 1 - ref_dim                       # a transpose or a reversal


def state_dict_to_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict of the port's ASRModel or DecoderLMModel (or any tensors
    keyed the same way)
    -> the reference's parameter tree (no top-level 'params') of numpy
    arrays; `params_to_state_dict` of the result gives the tensors back."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        path, t = unconvert_entry(name, t)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise ValueError(f"two entries map to {'/'.join(path)}")
        node[path[-1]] = to_numpy(t)
    return tree
