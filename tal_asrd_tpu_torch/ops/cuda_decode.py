"""Fused decoder layer step: one CUDA kernel per (layer, token).

Replaces the TPU kernel `fused_layer_step` / `_layer_step_kernel` of
tal_asrd_tpu/ops/pallas_decode.py: one ReZero decoder layer for one new token
per lane — fused QKV projection, in-place write of k, v into the self cache
at `index`, per-head causal softmax over positions <= index, out-projection,
`x1 = x + sa*rw`; cross-q projection, per-head softmax over the window with
an additive pad bias (mean-over-heads probabilities returned), out-projection,
`x2 = x1 + ca*rw_src`; feed-forward with ReLU, `x3 = x2 + ff*rw`. Semantics
follow models/decoder.py RZDecoderLayer with a cache.

What bounds it on an H100: bytes. One launch does about 2 operations per
weight byte per lane (a GEMV per lane), far below the card's ~295
operations per byte in bf16, so the floor is the traffic: the layer's
weights (14*D^2 elements: 3+1+1+1+4+4), the lanes' cross K/V (2*B*S*D) and the live part
of the self cache. The design (csrc/layer_step.cu) therefore keeps every
intermediate — qkv, both logit rows, the FF hidden, the f32 residual stream —
in shared memory, one thread block per lane, writes the cache with an indexed
store of one row, reads only the live rows of it, and streams weights and K/V
with coalesced 16-byte loads. Weights do not fit an SM's shared memory (a 2x
layer has 6.3 MB in bf16), so every block re-reads them through L2; with one
block per lane only B of the card's SMs are busy. Both are what a later,
faster version changes.

Rounding points (mirrored exactly by the plain version so kernel-vs-plain on
the card is tight in bf16): every product takes operands in the storage
dtype with f32 accumulation; `q*scale`, the probabilities and the input of
each weight product are rounded to the storage dtype first; the residual
stream is f32 until the final store.

`fused_layer_step` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback from a failed build or
launch. `fused_layer_step.launches` counts kernel launches. int8 cross K/V
and int8 weights (the reference's kv8 / w8 modes) are not ported yet and
raise NotImplementedError.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tal_asrd_tpu_torch.ops import _build

NEG_INF = -1e9

_WEIGHT_KEYS = ("wqkv", "wso", "wcq", "wco", "wf1", "wf2")
_BIAS_KEYS = ("bqkv", "bso", "bcq", "bco", "bf1", "bf2")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_THREADS = 768     # NTHREADS of csrc/layer_step.cu


def pack_layer(layer: torch.nn.Module,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A models/decoder.py RZDecoderLayer (taken by its attributes, so this
    module needs nothing of models/) -> packed kernel weights: matrices [in, out] in `dtype`,
    biases f32, `rw` = (resweight, resweight_src) as one f32 tensor [2] (the
    kernel reads it from device memory, so no step waits on the host);
    `resweight` / `resweight_src` are views of it."""
    def w(linear):
        return linear.weight.detach().to(dtype).T.contiguous()

    def b(linear):
        return linear.bias.detach().to(torch.float32).contiguous()

    sa, ca = layer.self_attn, layer.cross_attn
    rw = torch.stack([layer.resweight.detach(),
                      layer.resweight_src.detach()]).to(torch.float32)
    return {
        "wqkv": w(sa.qkv), "bqkv": b(sa.qkv),
        "wso": w(sa.out_proj), "bso": b(sa.out_proj),
        "wcq": w(ca.q), "bcq": b(ca.q),
        "wco": w(ca.out_proj), "bco": b(ca.out_proj),
        "wf1": w(layer.linear1), "bf1": b(layer.linear1),
        "wf2": w(layer.linear2), "bf2": b(layer.linear2),
        "rw": rw, "resweight": rw[0], "resweight_src": rw[1],
    }


def pack_decoder(decoder: torch.nn.Module, dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Pack all layers of an RZDecoder."""
    return tuple(pack_layer(layer, dtype) for layer in decoder.layers)


def layer_step_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor],
    cache_k: torch.Tensor, cache_v: torch.Tensor,
    mem_k: torch.Tensor, mem_v: torch.Tensor,
    mem_bias: torch.Tensor, index: int, n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused layer step, with the kernel's
    rounding points. All arithmetic is f32 on values rounded to the storage
    dtype, which equals products in that dtype with f32 accumulation."""
    cdt = x.dtype
    b, d = x.shape
    h = n_head
    dh = d // h
    scale = 1.0 / (dh ** 0.5)
    f32 = torch.float32

    def rt(t):  # round to the storage dtype, continue in f32
        return t.to(cdt).to(f32)

    def proj(inp, wk, bk):
        return rt(inp) @ weights[wk].to(f32) + weights[bk]

    def attend(q, keys, values, bias):
        # q [B, D] f32, keys/values [B, N, D] storage dtype, bias [B or 1, N]
        n = keys.shape[1]
        qh = rt(q * scale).reshape(b, h, dh)
        logits = torch.einsum("bhd,bnhd->bhn", qh,
                              keys.to(f32).reshape(b, n, h, dh))
        logits = logits + bias[:, None, :]
        p = torch.softmax(logits, dim=-1)                       # f32 [B, H, N]
        out = torch.einsum("bhn,bnhd->bhd", rt(p),
                           values.to(f32).reshape(b, n, h, dh))
        return out.reshape(b, d), p

    rw = weights["rw"][0]
    rw_src = weights["rw"][1]

    # ---- self-attention --------------------------------------------------
    qkv = proj(x, "wqkv", "bqkv")
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    cache_k[:, index] = k.to(cache_k.dtype)
    cache_v[:, index] = v.to(cache_v.dtype)
    pos = torch.arange(cache_k.shape[1], device=x.device)
    self_bias = torch.where(pos <= index, 0.0, NEG_INF)[None, :]
    sa, _ = attend(q, cache_k, cache_v, self_bias)
    x1 = x.to(f32) + proj(sa, "wso", "bso") * rw

    # ---- cross-attention over the precomputed window K/V -------------------
    qc = proj(x1, "wcq", "bcq")
    ca, p = attend(qc, mem_k, mem_v, mem_bias.to(f32))
    attn = p.sum(dim=1) / h                                     # mean over heads
    x2 = x1 + proj(ca, "wco", "bco") * rw_src

    # ---- feed-forward ------------------------------------------------------
    ffh = torch.relu(proj(x2, "wf1", "bf1"))
    x3 = x2 + proj(ffh, "wf2", "bf2") * rw
    return x3.to(cdt), attn, cache_k, cache_v


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library().tal_layer_step
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 21
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def fused_layer_step(
    x: torch.Tensor,                    # [B, D]
    weights: Dict[str, torch.Tensor],   # packed layer weights (pack_layer)
    cache_k: torch.Tensor,              # [B, L, D] (flattened heads)
    cache_v: torch.Tensor,
    mem_k: torch.Tensor,                # [B, S, D]
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,             # [B, S] f32, additive 0 / -1e9
    index: int,                         # cache write position (host integer)
    n_head: int,
    mem_k_scale: Optional[torch.Tensor] = None,
    mem_v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decoder layer step. Returns (x_out [B, D], attn_mean [B, S]
    f32, cache_k, cache_v).

    The caches are UPDATED IN PLACE at `index` and returned (the reference
    aliases them); positions > index may hold zeros or stale rows and are
    ignored. Nothing is assumed about where a lane's cache lived in the
    previous step, so a caller may gather cache rows between steps."""
    if mem_k_scale is not None or mem_v_scale is not None \
            or mem_k.dtype == torch.int8 or mem_v.dtype == torch.int8:
        raise NotImplementedError("int8 cross K/V (kv8) is not ported yet")
    if any(weights[k].dtype == torch.int8 for k in _WEIGHT_KEYS):
        raise NotImplementedError("int8 weights (w8) are not ported yet")
    index = int(index)
    b, d = x.shape
    l_buf = cache_k.shape[1]
    s = mem_k.shape[1]
    f_dim = weights["wf1"].shape[1]
    if d % n_head:
        raise ValueError(f"n_head {n_head} does not divide D {d}")
    if not 0 <= index < l_buf:
        raise ValueError(f"index {index} outside the cache of length {l_buf}")

    if x.device.type == "cpu":
        return layer_step_plain(x, weights, cache_k, cache_v, mem_k, mem_v,
                                mem_bias, index, n_head)
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")

    dt, dev = x.dtype, x.device
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused_layer_step stores float32 or bfloat16, got {dt}")
    vec = 16 // x.element_size()
    dh = d // n_head
    lph = dh // vec
    if d % vec or f_dim % vec or dh % vec or lph > 32 or lph & (lph - 1) \
            or d // vec > _KERNEL_THREADS:
        raise ValueError(
            f"kernel needs D, F and head_dim divisible by {vec}, head_dim/{vec} "
            f"a power of two <= 32 and D <= {_KERNEL_THREADS * vec}; got D={d}, F={f_dim}, "
            f"head_dim={dh}")
    _check("x", x, (b, d), dt, dev)
    for wk, shape in zip(_WEIGHT_KEYS, ((d, 3 * d), (d, d), (d, d), (d, d),
                                        (d, f_dim), (f_dim, d))):
        _check(wk, weights[wk], shape, dt, dev)
    for bk, n in zip(_BIAS_KEYS, (3 * d, d, d, d, f_dim, d)):
        _check(bk, weights[bk], (n,), torch.float32, dev)
    _check("rw", weights["rw"], (2,), torch.float32, dev)
    _check("cache_k", cache_k, (b, l_buf, d), dt, dev)
    _check("cache_v", cache_v, (b, l_buf, d), dt, dev)
    _check("mem_k", mem_k, (b, s, d), dt, dev)
    _check("mem_v", mem_v, (b, s, d), dt, dev)
    _check("mem_bias", mem_bias, (b, s), torch.float32, dev)

    x_out = torch.empty_like(x)
    attn = torch.empty((b, s), dtype=torch.float32, device=dev)
    w = weights
    with torch.cuda.device(dev):
        err = _kernel()(
            _DTYPE_CODE[dt], x.data_ptr(),
            w["wqkv"].data_ptr(), w["bqkv"].data_ptr(),
            w["wso"].data_ptr(), w["bso"].data_ptr(),
            w["wcq"].data_ptr(), w["bcq"].data_ptr(),
            w["wco"].data_ptr(), w["bco"].data_ptr(),
            w["wf1"].data_ptr(), w["bf1"].data_ptr(),
            w["wf2"].data_ptr(), w["bf2"].data_ptr(),
            w["rw"].data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(),
            mem_k.data_ptr(), mem_v.data_ptr(), mem_bias.data_ptr(),
            x_out.data_ptr(), attn.data_ptr(),
            b, d, f_dim, n_head, l_buf, s, index, 1.0 / (dh ** 0.5),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tal_layer_step launch failed: CUDA error {err}")
    fused_layer_step.launches += 1
    return x_out, attn, cache_k, cache_v


fused_layer_step.launches = 0
