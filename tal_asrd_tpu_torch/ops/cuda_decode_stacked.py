"""Stacked decoder step: one CUDA kernel per token for every layer (K3).

Replaces the TPU kernel `stacked_decoder_step` / `_stacked_step_kernel` of
tal_asrd_tpu/ops/pallas_decode_stacked.py: the layer step of
ops/cuda_decode.py for all L layers in one launch, the hidden carried from
layer to layer on chip and the cross-attention probabilities meaned over
heads AND layers. Weights, biases (and w8 scales) are stacked along a
leading layer axis (`pack_decoder_stacked`), the caches are [L, B, cap, D] and the
cross K/V [L, B, S, D] (+ [L, D] scales under kv8).

What bounds it on an H100: bytes — the weights once per step, the cross K/V
and the live self cache. The kernel (csrc/stacked_step.cu) is the cluster
kernel of csrc/cluster_step.cuh that K1 also runs, with n_layers layers
(design, launch plan and the tensor-core order of the weights:
ops/cuda_decode.py). The rounding points are this kernel's own, not the
layer step's: the self cache and cross K/V are upcast to f32 and the
attention products are f32, the scaled query and the probabilities are not
rounded to the storage dtype, under kv8 the cross K/V is dequantized
(k * sk, v * sv) inside the products, and the hidden is rounded to the
storage dtype at the end of each layer and re-read by the next. The plain
version mirrors these points.

`stacked_decoder_step` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback from a failed build,
a failed launch or a cluster size the card does not take.
`stacked_decoder_step.launches` counts kernel launches and
`stacked_decoder_step.last_plan` holds the plan of the last launch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tal_asrd_tpu_torch.ops.cuda_decode import (  # noqa: F401 (the plan helpers re-exported)
    BIAS_KEYS,
    MAX_GROUP,
    NEG_INF,
    SCALE_KEYS,
    TC_KEYS,
    WEIGHT_KEYS,
    LaunchPlan,
    fragment_order,
    fragment_unorder,
    int8_mode,
    launch_step,
    pack_layer,
    quantize_packed,
    stacked_launch_plan,
    with_fragments,
)


def stack_packed(layers) -> Dict[str, torch.Tensor]:
    """Per-layer packed weights (pack_layer, or quantize_packed for w8) ->
    each key stacked along a new leading layer axis: weights [L, in, out],
    biases [L, out] f32, rw [L, 2], and under w8 the weight scales [L, out]
    f32. bf16 and int8 weights are also stored in the kernel's tensor-core
    order (`fragment_order`) under the `tc_*` keys; the plain version and the
    f32 kernel read [L, in, out]. (The reference adds all-ones scales without
    w8 so that its TPU kernel has one signature; the kernel here reads scales
    only for int8 weights.)"""
    keys = WEIGHT_KEYS + BIAS_KEYS + ("rw",)
    if SCALE_KEYS[0] in layers[0]:
        keys += SCALE_KEYS
    return with_fragments({k: torch.stack([w[k] for w in layers]).contiguous() for k in keys})


def pack_decoder_stacked(decoder: torch.nn.Module, dtype: torch.dtype = torch.bfloat16,
                         w8: bool = False) -> Dict[str, torch.Tensor]:
    """Pack every layer of an RZDecoder (taken by its `layers`), int8 under
    w8, and stack them (`stack_packed`)."""
    layers = [pack_layer(layer, dtype) for layer in decoder.layers]
    if w8:
        layers = [quantize_packed(w) for w in layers]
    return stack_packed(layers)


def stacked_step_plain(
    x: torch.Tensor, stacked: Dict[str, torch.Tensor],
    cache_k: torch.Tensor, cache_v: torch.Tensor,
    mem_k: torch.Tensor, mem_v: torch.Tensor,
    mem_bias: torch.Tensor, index: int, n_head: int,
    mem_k_scale: Optional[torch.Tensor] = None,
    mem_v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the stacked step, with the kernel's rounding
    points (see the module note)."""
    cdt = x.dtype
    b, d = x.shape
    n_layers = mem_k.shape[0]
    h = n_head
    dh = d // h
    scale = 1.0 / (dh ** 0.5)
    f32 = torch.float32
    pos = torch.arange(cache_k.shape[2], device=x.device)
    self_bias = torch.where(pos <= index, 0.0, NEG_INF)[None, :]
    cross_bias = mem_bias.to(f32)

    def attend(q, keys, values, bias):
        # q [B, D] f32; keys/values [B, N, D] f32
        n = keys.shape[1]
        qh = (q * scale).reshape(b, h, dh)
        logits = torch.einsum("bhd,bnhd->bhn", qh, keys.reshape(b, n, h, dh))
        p = torch.softmax(logits + bias[:, None, :], dim=-1)     # f32 [B, H, N]
        out = torch.einsum("bhn,bnhd->bhd", p, values.reshape(b, n, h, dh))
        return out.reshape(b, d), p

    attn = torch.zeros((b, mem_k.shape[2]), dtype=f32, device=x.device)
    for li in range(n_layers):
        def proj(inp, i):
            y = inp.to(cdt).to(f32) @ stacked[WEIGHT_KEYS[i]][li].to(f32)
            if SCALE_KEYS[i] in stacked:
                y = y * stacked[SCALE_KEYS[i]][li]
            return y + stacked[BIAS_KEYS[i]][li]

        rw, rw_src = stacked["rw"][li, 0], stacked["rw"][li, 1]
        # ---- self-attention over the cached history ----------------------
        qkv = proj(x, 0)
        q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        cache_k[li, :, index] = k.to(cache_k.dtype)
        cache_v[li, :, index] = v.to(cache_v.dtype)
        sa, _ = attend(q, cache_k[li].to(f32), cache_v[li].to(f32), self_bias)
        x1 = x.to(f32) + proj(sa, 1) * rw

        # ---- cross-attention over the layer's window K/V (dequantized) ----
        qc = proj(x1, 2)
        mk = mem_k[li].to(f32)
        mv = mem_v[li].to(f32)
        if mem_k_scale is not None:
            mk = mk * mem_k_scale[li]
        if mem_v_scale is not None:
            mv = mv * mem_v_scale[li]
        ca, p = attend(qc, mk, mv, cross_bias)
        attn = attn + p.sum(dim=1) / (h * n_layers)     # mean over heads and layers
        x2 = x1 + proj(ca, 3) * rw_src

        # ---- feed-forward ---------------------------------------------------
        ffh = torch.relu(proj(x2, 4))
        x = (x2 + proj(ffh, 5) * rw).to(cdt)          # the next layer reads it rounded
    return x, attn, cache_k, cache_v


def stacked_decoder_step(
    x: torch.Tensor,                    # [B, D]
    stacked: Dict[str, torch.Tensor],   # pack_decoder_stacked
    cache_k: torch.Tensor,              # [L, B, cap, D]
    cache_v: torch.Tensor,
    mem_k: torch.Tensor,                # [L, B, S, D] storage dtype or int8
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,             # [B, S] f32, additive 0 / -1e9
    index: int,                         # cache write position (host integer)
    n_head: int,
    mem_k_scale: Optional[torch.Tensor] = None,   # [L, D] f32 (kv8)
    mem_v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the whole decoder stack. Returns (x_out [B, D], attn
    [B, S] f32 meaned over heads and layers, cache_k, cache_v); the caches
    are UPDATED IN PLACE at `index` and returned, as in `fused_layer_step`."""
    index = int(index)
    d = x.shape[1]
    cap = cache_k.shape[2]
    if d % n_head:
        raise ValueError(f"n_head {n_head} does not divide D {d}")
    if not 0 <= index < cap:
        raise ValueError(f"index {index} outside the cache of length {cap}")
    w8 = int8_mode("weights", [stacked[k] for k in WEIGHT_KEYS],
                   [stacked.get(k) for k in SCALE_KEYS])
    kv8 = int8_mode("mem_k/mem_v", (mem_k, mem_v), (mem_k_scale, mem_v_scale))

    if x.device.type == "cpu":
        return stacked_step_plain(x, stacked, cache_k, cache_v, mem_k, mem_v,
                                  mem_bias, index, n_head, mem_k_scale, mem_v_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")
    x_out, attn, plan = launch_step("tal_stacked_step", x, stacked, cache_k, cache_v, mem_k,
                                    mem_v, mem_bias, index, n_head, mem_k_scale, mem_v_scale,
                                    w8, kv8)
    stacked_decoder_step.launches += 1
    stacked_decoder_step.last_plan = plan
    return x_out, attn, cache_k, cache_v


stacked_decoder_step.launches = 0
stacked_decoder_step.last_plan = None
