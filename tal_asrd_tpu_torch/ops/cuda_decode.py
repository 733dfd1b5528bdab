"""Fused decoder layer step: one CUDA kernel per (layer, token).

Replaces the TPU kernel `fused_layer_step` / `_layer_step_kernel` of
tal_asrd_tpu/ops/pallas_decode.py: one ReZero decoder layer for one new token
per lane — fused QKV projection, in-place write of k, v into the self cache
at `index`, per-head causal softmax over positions <= index, out-projection,
`x1 = x + sa*rw`; cross-q projection, per-head softmax over the window with
an additive pad bias (mean-over-heads probabilities returned), out-projection,
`x2 = x1 + ca*rw_src`; feed-forward with ReLU, `x3 = x2 + ff*rw`. Semantics
follow models/decoder.py RZDecoderLayer with a cache.

Two optional int8 operand modes, as in the reference: int8 cross K/V with
per-channel f32 scales (`quantize_mem_kv`, kv8) and int8 weights with
per-output-channel f32 scales (`quantize_packed`, w8).

What bounds it on an H100: bytes. One launch does about 2 operations per
weight byte per lane (a GEMV per lane), far below the card's ~295
operations per byte in bf16, so the floor is the traffic: the layer's
weights (14*D^2 elements: 3+1+1+1+4+4), the lanes' cross K/V (2*B*S*D) and the live part
of the self cache. The design (csrc/layer_step.cu, csrc/decode_step.cuh)
therefore keeps every intermediate — qkv, both logit rows, the FF hidden, the
f32 residual stream — in shared memory, one thread block per lane, writes the
cache with an indexed store of one row, reads only the live rows of it, and
streams weights and K/V with coalesced 16-byte loads. Weights do not fit an
SM's shared memory (a 2x layer has 6.3 MB in bf16), so every block re-reads
them through L2; with one block per lane only B of the card's SMs are busy.
Both are what a later, faster version changes.

Rounding points (mirrored exactly by the plain version so kernel-vs-plain on
the card is tight in bf16): every product takes operands in the storage
dtype with f32 accumulation; `q*scale`, the probabilities and the input of
each weight product are rounded to the storage dtype first; the residual
stream is f32 until the final store. int8 values are exact in the storage
dtype; a weight scale multiplies the f32 sum (`* s + b`), never the weights;
the K scale folds into the query before its rounding and the V scale
multiplies the f32 PV sum.

`fused_layer_step` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback from a failed build or
launch. `fused_layer_step.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from tal_asrd_tpu_torch.ops import _build

NEG_INF = -1e9

WEIGHT_KEYS = ("wqkv", "wso", "wcq", "wco", "wf1", "wf2")
BIAS_KEYS = ("bqkv", "bso", "bcq", "bco", "bf1", "bf2")
SCALE_KEYS = ("sqkv", "sso", "scq", "sco", "sf1", "sf2")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_THREADS = 768     # NTHREADS of csrc/decode_step.cuh


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


def _quantize(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: scale = max |x| over `dims` / 127 (at least 1e-8),
    values round(x / scale) half to even, clipped to +-127."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=tuple(dims)) / 127.0, 1e-8)
    xi = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xi, s


def quantize_mem_kv(mem_k: torch.Tensor, mem_v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 quantization of the precomputed cross K/V
    (kv8). Returns (k_int8, k_scale [D], v_int8, v_scale [D]).

    The scales are reduced over EVERY leading axis — for [B, S, D] over the
    whole request batch and the window, as the reference does — so a lane's
    int8 values depend on its batch mates. Runs once per window, never in the
    token loop."""
    dims = tuple(range(mem_k.ndim - 1))
    k8, sk = _quantize(mem_k, dims)
    v8, sv = _quantize(mem_v, dims)
    return k8, sk, v8, sv


def quantize_packed(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of one packed layer's
    weight matrices (w8): each [in, out] matrix becomes int8 with its scales
    [out] under the s* keys. Biases and `rw` pass through unchanged."""
    out = dict(packed)
    for wk, sk in zip(WEIGHT_KEYS, SCALE_KEYS):
        out[wk], out[sk] = _quantize(packed[wk], (0,))
    return out


def layer_step_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor],
    cache_k: torch.Tensor, cache_v: torch.Tensor,
    mem_k: torch.Tensor, mem_v: torch.Tensor,
    mem_bias: torch.Tensor, index: int, n_head: int,
    mem_k_scale: Optional[torch.Tensor] = None,
    mem_v_scale: Optional[torch.Tensor] = None,
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

    def proj(inp, i):
        y = rt(inp) @ weights[WEIGHT_KEYS[i]].to(f32)
        s = weights.get(SCALE_KEYS[i])
        if s is not None:
            y = y * s
        return y + weights[BIAS_KEYS[i]]

    def attend(q, keys, values, bias, kscale=None, vscale=None):
        # q [B, D] f32, keys/values [B, N, D] storage dtype or int8, bias [B or 1, N]
        n = keys.shape[1]
        q = q * scale
        if kscale is not None:          # the K scale folds into the query
            q = q * kscale
        qh = rt(q).reshape(b, h, dh)
        logits = torch.einsum("bhd,bnhd->bhn", qh,
                              keys.to(f32).reshape(b, n, h, dh))
        logits = logits + bias[:, None, :]
        p = torch.softmax(logits, dim=-1)                       # f32 [B, H, N]
        out = torch.einsum("bhn,bnhd->bhd", rt(p),
                           values.to(f32).reshape(b, n, h, dh)).reshape(b, d)
        if vscale is not None:          # the V scale multiplies the f32 sum
            out = out * vscale
        return out, p

    rw = weights["rw"][0]
    rw_src = weights["rw"][1]

    # ---- self-attention --------------------------------------------------
    qkv = proj(x, 0)
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    cache_k[:, index] = k.to(cache_k.dtype)
    cache_v[:, index] = v.to(cache_v.dtype)
    pos = torch.arange(cache_k.shape[1], device=x.device)
    self_bias = torch.where(pos <= index, 0.0, NEG_INF)[None, :]
    sa, _ = attend(q, cache_k, cache_v, self_bias)
    x1 = x.to(f32) + proj(sa, 1) * rw

    # ---- cross-attention over the precomputed window K/V -------------------
    qc = proj(x1, 2)
    ca, p = attend(qc, mem_k, mem_v, mem_bias.to(f32), mem_k_scale, mem_v_scale)
    attn = p.sum(dim=1) / h                                     # mean over heads
    x2 = x1 + proj(ca, 3) * rw_src

    # ---- feed-forward ------------------------------------------------------
    ffh = torch.relu(proj(x2, 4))
    x3 = x2 + proj(ffh, 5) * rw
    return x3.to(cdt), attn, cache_k, cache_v


# ---------------------------------------------------------------------------
# Launch plumbing. The C entry point takes (dtype, w8, kv8, pointer table,
# dims, scale, stream); the table's order is params_from's in
# csrc/decode_step.cuh, which ops/cuda_decode_stacked.py's entry point shares.
# ---------------------------------------------------------------------------
_N_PTRS = 29
_fns: Dict[str, object] = {}


def kernel_fn(name: str):
    """The C entry point `name` of the kernels' library, built at first use."""
    if name not in _fns:
        fn = getattr(_build.load_library(), name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def int8_mode(name: str, tensors, scales) -> bool:
    """Whether a group of operands is int8. The kernels read scales only for
    int8 operands: every scale must then be given, and otherwise none may be."""
    kinds = {t.dtype == torch.int8 for t in tensors}
    if len(kinds) > 1:
        raise TypeError(f"{name}: mixes int8 and float operands")
    is8 = kinds.pop()
    if is8 and any(s is None for s in scales):
        raise ValueError(f"{name}: int8 operands need their f32 scales")
    if not is8 and any(s is not None for s in scales):
        raise ValueError(f"{name}: scales are read only with int8 operands")
    return is8


def check_kernel_shape(dt: torch.dtype, w8: bool, kv8: bool,
                       d: int, f_dim: int, n_head: int) -> None:
    """The shapes the kernels take (shapes_ok in csrc/decode_step.cuh): 16-byte
    rows and column groups in each operand's type, a head spanning a power of
    two <= 32 lanes of 16-byte groups, and at most NTHREADS groups a row."""
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the decode kernels store float32 or bfloat16, got {dt}")
    vec = 16 // torch.empty((), dtype=dt).element_size()
    vec_w = 16 if w8 else vec
    vec_kv = 16 if kv8 else vec
    dh = d // n_head

    def rows_ok(v):
        lph = dh // v
        return (d % v == 0 and dh % v == 0 and 1 <= lph <= 32
                and lph & (lph - 1) == 0 and d // v <= _KERNEL_THREADS)

    if not (rows_ok(vec) and rows_ok(vec_kv) and d % vec_w == 0
            and f_dim % vec_w == 0 and f_dim % vec == 0):
        raise ValueError(
            f"kernel needs D, F and head_dim divisible by the 16-byte vector width of "
            f"each operand ({vec} for {dt}, 16 for int8), head_dim / width a power of "
            f"two <= 32 and D / width <= {_KERNEL_THREADS}; got D={d}, F={f_dim}, "
            f"head_dim={dh}, w8={w8}, kv8={kv8}")


def launch(name: str, dt: torch.dtype, w8: bool, kv8: bool, ptrs, dims,
           scale: float) -> None:
    """Launches the kernel `name` on the current stream; raises on a refused
    launch."""
    table = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    dims_c = (ctypes.c_int * 8)(*dims)
    err = kernel_fn(name)(_DTYPE_CODE[dt], int(w8), int(kv8), table, dims_c,
                          scale, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_layer_step(
    x: torch.Tensor,                    # [B, D]
    weights: Dict[str, torch.Tensor],   # packed layer weights (pack_layer / quantize_packed)
    cache_k: torch.Tensor,              # [B, L, D] (flattened heads)
    cache_v: torch.Tensor,
    mem_k: torch.Tensor,                # [B, S, D] storage dtype or int8
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,             # [B, S] f32, additive 0 / -1e9
    index: int,                         # cache write position (host integer)
    n_head: int,
    mem_k_scale: Optional[torch.Tensor] = None,   # [D] f32 (kv8)
    mem_v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decoder layer step. Returns (x_out [B, D], attn_mean [B, S]
    f32, cache_k, cache_v).

    The caches are UPDATED IN PLACE at `index` and returned (the reference
    aliases them); positions > index may hold zeros or stale rows and are
    ignored. Nothing is assumed about where a lane's cache lived in the
    previous step, so a caller may gather cache rows between steps. int8
    weights need their s* scales and int8 cross K/V their [D] scales."""
    index = int(index)
    b, d = x.shape
    l_buf = cache_k.shape[1]
    s = mem_k.shape[1]
    f_dim = weights["wf1"].shape[1]
    if d % n_head:
        raise ValueError(f"n_head {n_head} does not divide D {d}")
    if not 0 <= index < l_buf:
        raise ValueError(f"index {index} outside the cache of length {l_buf}")
    scales = [weights.get(k) for k in SCALE_KEYS]
    w8 = int8_mode("weights", [weights[k] for k in WEIGHT_KEYS], scales)
    kv8 = int8_mode("mem_k/mem_v", (mem_k, mem_v), (mem_k_scale, mem_v_scale))

    if x.device.type == "cpu":
        return layer_step_plain(x, weights, cache_k, cache_v, mem_k, mem_v,
                                mem_bias, index, n_head, mem_k_scale, mem_v_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")

    dt, dev = x.dtype, x.device
    check_kernel_shape(dt, w8, kv8, d, f_dim, n_head)
    wt = torch.int8 if w8 else dt
    kvt = torch.int8 if kv8 else dt
    check("x", x, (b, d), dt, dev)
    outs = (3 * d, d, d, d, f_dim, d)
    for wk, shape in zip(WEIGHT_KEYS, ((d, 3 * d), (d, d), (d, d), (d, d),
                                        (d, f_dim), (f_dim, d))):
        check(wk, weights[wk], shape, wt, dev)
    for bk, sc, n in zip(BIAS_KEYS, SCALE_KEYS, outs):
        check(bk, weights[bk], (n,), torch.float32, dev)
        if weights.get(sc) is not None:
            check(sc, weights[sc], (n,), torch.float32, dev)
    check("rw", weights["rw"], (2,), torch.float32, dev)
    check("cache_k", cache_k, (b, l_buf, d), dt, dev)
    check("cache_v", cache_v, (b, l_buf, d), dt, dev)
    check("mem_k", mem_k, (b, s, d), kvt, dev)
    check("mem_v", mem_v, (b, s, d), kvt, dev)
    for name, t in (("mem_k_scale", mem_k_scale), ("mem_v_scale", mem_v_scale)):
        if t is not None:
            check(name, t, (d,), torch.float32, dev)
    check("mem_bias", mem_bias, (b, s), torch.float32, dev)

    x_out = torch.empty_like(x)
    attn = torch.empty((b, s), dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    w = weights
    ptrs = ([x.data_ptr()] + [w[k].data_ptr() for k in WEIGHT_KEYS]
            + [w[k].data_ptr() for k in BIAS_KEYS] + [ptr(t) for t in scales]
            + [w["rw"].data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
               mem_k.data_ptr(), mem_v.data_ptr(), ptr(mem_k_scale), ptr(mem_v_scale),
               mem_bias.data_ptr(), x_out.data_ptr(), attn.data_ptr()])
    with torch.cuda.device(dev):
        launch("tal_layer_step", dt, w8, kv8, ptrs,
               (b, d, f_dim, n_head, l_buf, s, index, 1), 1.0 / (d // n_head) ** 0.5)
    fused_layer_step.launches += 1
    return x_out, attn, cache_k, cache_v


fused_layer_step.launches = 0
