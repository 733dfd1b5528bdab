"""Stacked decoder step: one CUDA kernel per token for every layer (K3).

Replaces the TPU kernel `stacked_decoder_step` / `_stacked_step_kernel` of
tal_asrd_tpu/ops/pallas_decode_stacked.py: the layer step of
ops/cuda_decode.py for all L layers in one launch, the hidden carried from
layer to layer on chip and the cross-attention probabilities meaned over
heads AND layers. Weights, biases (and w8 scales) are stacked along a
leading layer axis (`pack_decoder_stacked`), the caches are [L, B, cap, D] and the
cross K/V [L, B, S, D] (+ [L, D] scales under kv8).

What bounds it on an H100: bytes — the weights once per step, the cross K/V
and the live self cache. The kernel (csrc/stacked_step.cu) runs on
thread-block clusters: a cluster of C CTAs owns a group of G lanes
(`stacked_launch_plan` picks G and C so that about one CTA sits on every SM),
splits each weight product's output columns and each attention's (lane,
head) items across its CTAs, reads every weight once per cluster, and
exchanges the lane vectors through distributed shared memory. In bf16 the
weight products run on the tensor cores, from weights that `stack_packed`
also stores in the order of the mma A fragment (`fragment_order`, keys
`tc_*`). The rounding points are this kernel's own, not the layer step's:
the self cache and cross K/V are upcast to f32 and the attention products
are f32, the scaled query and the probabilities are not rounded to the
storage dtype, under kv8 the cross K/V is dequantized (k * sk, v * sv)
inside the products, and the hidden is rounded to the storage dtype at the
end of each layer and re-read by the next. The plain version mirrors these
points.

`stacked_decoder_step` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback from a failed build,
a failed launch or a cluster size the card does not take.
`stacked_decoder_step.launches` counts kernel launches and
`stacked_decoder_step.last_plan` holds the plan of the last launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from tal_asrd_tpu_torch.ops import _build
from tal_asrd_tpu_torch.ops.cuda_decode import (
    _DTYPE_CODE,
    _N_PTRS,
    BIAS_KEYS,
    NEG_INF,
    SCALE_KEYS,
    WEIGHT_KEYS,
    check,
    int8_mode,
    pack_layer,
    quantize_packed,
)

TC_KEYS = tuple("tc_" + k for k in WEIGHT_KEYS)
MAX_GROUP = 8                 # lanes of a cluster: the N = 8 of mma.m16n8k16
CLUSTER_SIZES = (16, 8)       # CTAs of a cluster, in order of preference


def _fragment_index(kpack: int, device) -> torch.Tensor:
    """Position inside a [16, 16 * kpack] (column, k) tile of each of the
    32 x 8 * kpack values that the threads of a warp hold as mma.m16n8k16 A
    fragments (thread lane = 4 g + t): value e of k-step s = e // 8 is
    a[e % 8] at column g + 8 * ((e % 8) // 2 % 2) and
    k = 16 s + 2 t + e % 2 + 8 * ((e % 8) // 4)."""
    lane = torch.arange(32, device=device)[:, None]
    e = torch.arange(8 * kpack, device=device)[None, :]
    g, t, e8 = lane // 4, lane % 4, e % 8
    col = g + 8 * ((e8 // 2) % 2)
    k = 16 * (e // 8) + 2 * t + e8 % 2 + 8 * (e8 // 4)
    return (col * 16 * kpack + k).reshape(-1)


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """[L, K, N] weights -> [L, K * N] in the order K3's tensor cores read
    them: 16-column tiles, each a run of 16-byte loads along K, one per
    thread of a warp per load (K-groups of 16 for bf16, 32 for int8, so a
    load holds 8 or 16 values)."""
    nl, k, n = w.shape
    kpack = 2 if w.dtype == torch.int8 else 1
    kg = 16 * kpack
    if k % kg or n % 16:
        raise ValueError(f"fragment_order needs K % {kg} == 0 and N % 16 == 0, got {k}, {n}")
    tiles = (w.reshape(nl, k // kg, kg, n // 16, 16).permute(0, 3, 1, 4, 2)
             .reshape(nl, n // 16, k // kg, 16 * kg))         # [L, col tile, k group, (col, k)]
    idx = _fragment_index(kpack, w.device)
    return tiles[..., idx].reshape(nl, k * n).contiguous()


def fragment_unorder(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of `fragment_order`: [L, K * N] -> [L, K, N]."""
    nl = f.shape[0]
    kpack = 2 if f.dtype == torch.int8 else 1
    kg = 16 * kpack
    tiles = torch.empty((nl, n // 16, k // kg, 16 * kg), dtype=f.dtype, device=f.device)
    tiles[..., _fragment_index(kpack, f.device)] = f.reshape(nl, n // 16, k // kg, 16 * kg)
    return (tiles.reshape(nl, n // 16, k // kg, 16, kg).permute(0, 2, 4, 1, 3)
            .reshape(nl, k, n))


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
    out = {k: torch.stack([w[k] for w in layers]).contiguous() for k in keys}
    if out[WEIGHT_KEYS[0]].dtype in (torch.bfloat16, torch.int8):
        out.update({tk: fragment_order(out[wk]) for tk, wk in zip(TC_KEYS, WEIGHT_KEYS)})
    return out


def pack_decoder_stacked(decoder: torch.nn.Module, dtype: torch.dtype = torch.bfloat16,
                         w8: bool = False) -> Dict[str, torch.Tensor]:
    """Pack every layer of an RZDecoder (taken by its `layers`), int8 under
    w8, and stack them (`stack_packed`)."""
    layers = [pack_layer(layer, dtype) for layer in decoder.layers]
    if w8:
        layers = [quantize_packed(w) for w in layers]
    return stack_packed(layers)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How K3 covers B lanes: `clusters` clusters of `cluster` CTAs, cluster k
    owning lanes [k * B // clusters, (k + 1) * B // clusters), at most `group`
    of them. `slots` clusters fit on the card at once; `waves` > 1 says that
    the clusters do not all fit and run in turns."""
    group: int
    cluster: int
    clusters: int
    slots: int

    @property
    def ctas(self) -> int:
        return self.clusters * self.cluster

    @property
    def waves(self) -> int:
        return -(-self.clusters // self.slots)

    def groups(self, b: int):
        return [range(k * b // self.clusters, (k + 1) * b // self.clusters)
                for k in range(self.clusters)]


def stacked_launch_plan(b: int, sm_count: int, slots: Optional[Dict[int, int]] = None,
                        sizes: Tuple[int, ...] = CLUSTER_SIZES) -> LaunchPlan:
    """K3's launch plan for b lanes. At the first cluster size C of `sizes`
    of which the card holds at least one cluster at once (`slots[C]`, from
    the device's occupancy query; without it sm_count // C), the lanes are
    spread evenly over min(slots, b) clusters, unless that puts more than
    MAX_GROUP lanes in a cluster; then the next size is tried. The largest
    cluster reads every weight the fewest times: on an H100 (7 slots of 16
    CTAs, 15 of 8) B = 32 gives 7 clusters of 16 CTAs (4-5 lanes each, 112
    CTAs), measured faster than 15 clusters of 8 (2-3 lanes, 120 CTAs); B = 8
    gives 7 clusters of 16 (1-2 lanes). When every size would need more than
    MAX_GROUP lanes a cluster, the clusters hold MAX_GROUP lanes and run in
    waves, at the size that needs the fewest."""
    if b < 1:
        raise ValueError(f"batch {b} < 1")
    fitting = []
    for c in sizes:
        n_slots = slots.get(c, 0) if slots is not None else sm_count // c
        if n_slots < 1:
            continue
        fitting.append((c, n_slots))
        n = min(n_slots, b)
        if -(-b // n) <= MAX_GROUP:
            return LaunchPlan(-(-b // n), c, n, n_slots)
    if not fitting:
        raise RuntimeError(f"no cluster size of {sizes} fits a card of {sm_count} SMs")
    n = -(-b // MAX_GROUP)
    c, n_slots = min(fitting, key=lambda cs: -(-n // cs[1]))     # the fewest waves
    return LaunchPlan(MAX_GROUP, c, n, n_slots)


_fns: Dict[str, object] = {}
_plans: Dict[tuple, LaunchPlan] = {}


def _kernel_fn(name: str):
    if name not in _fns:
        fn = getattr(_build.load_library(), name)
        if name == "tal_stacked_step":
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
        else:   # tal_stacked_cluster_slots
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def cluster_slots(dt: torch.dtype, w8: bool, kv8: bool, dims) -> Dict[int, int]:
    """How many clusters of each size of CLUSTER_SIZES the current device
    holds at once for this instantiation and shape (with the shared memory of
    MAX_GROUP lanes)."""
    dims_c = (ctypes.c_int * 8)(*dims)
    slots = {}
    for c in CLUSTER_SIZES:
        n = ctypes.c_int(0)
        err = _kernel_fn("tal_stacked_cluster_slots")(
            _DTYPE_CODE[dt], int(w8), int(kv8), dims_c, MAX_GROUP, c, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"tal_stacked_cluster_slots({c}) failed: CUDA error {err}")
        slots[c] = n.value
    return slots


def launch_plan(dev: torch.device, dt: torch.dtype, w8: bool, kv8: bool, dims) -> LaunchPlan:
    """The plan for one shape on one card, kept after the first call."""
    key = (dev.index, dt, w8, kv8, tuple(dims[:6]) + tuple(dims[7:]))
    if key not in _plans:
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _plans[key] = stacked_launch_plan(dims[0], sm, cluster_slots(dt, w8, kv8, dims))
    return _plans[key]


def check_stacked_shape(dt: torch.dtype, kv8: bool, d: int, f_dim: int, n_head: int) -> None:
    """The shapes K3 takes (k3_shapes_ok in csrc/stacked_step.cu): D and F in
    32s (16-column tiles, K in 32s), and a head of 16 to 256 channels that
    spans a power of two <= 32 of 16-byte groups in the cache's and the cross
    K/V's types."""
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the stacked kernel stores float32 or bfloat16, got {dt}")
    dh = d // n_head
    vecs = (16 // torch.empty((), dtype=dt).element_size(), 16 if kv8 else None)
    ok = d % 32 == 0 and f_dim % 32 == 0 and 16 <= dh <= 256
    for v in filter(None, vecs):
        lph = dh // v
        ok = ok and dh % v == 0 and 1 <= lph <= 32 and lph & (lph - 1) == 0
    if not ok:
        raise ValueError(
            f"stacked kernel needs D and F divisible by 32, 16 <= head_dim <= 256 and head_dim / "
            f"(16-byte width) a power of two <= 32; got D={d}, F={f_dim}, head_dim={dh}, kv8={kv8}")


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
    b, d = x.shape
    n_layers, _, cap, _ = cache_k.shape
    s = mem_k.shape[2]
    f_dim = stacked["wf1"].shape[-1]
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

    dt, dev = x.dtype, x.device
    check_stacked_shape(dt, kv8, d, f_dim, n_head)
    wt = torch.int8 if w8 else dt
    kvt = torch.int8 if kv8 else dt
    check("x", x, (b, d), dt, dev)
    outs = (3 * d, d, d, d, f_dim, d)
    for wk, shape in zip(WEIGHT_KEYS, ((d, 3 * d), (d, d), (d, d), (d, d),
                                        (d, f_dim), (f_dim, d))):
        check(wk, stacked[wk], (n_layers, *shape), wt, dev)
    tc = dt == torch.bfloat16          # tensor-core weights in fragment order
    if tc:
        for tk, wk in zip(TC_KEYS, WEIGHT_KEYS):
            if tk not in stacked:
                raise ValueError(f"{tk} missing: pack the weights with stack_packed")
            check(tk, stacked[tk], (n_layers, stacked[wk][0].numel()), wt, dev)
    for bk, sk, n in zip(BIAS_KEYS, SCALE_KEYS, outs):
        check(bk, stacked[bk], (n_layers, n), torch.float32, dev)
        if w8:
            check(sk, stacked[sk], (n_layers, n), torch.float32, dev)
    check("rw", stacked["rw"], (n_layers, 2), torch.float32, dev)
    check("cache_k", cache_k, (n_layers, b, cap, d), dt, dev)
    check("cache_v", cache_v, (n_layers, b, cap, d), dt, dev)
    check("mem_k", mem_k, (n_layers, b, s, d), kvt, dev)
    check("mem_v", mem_v, (n_layers, b, s, d), kvt, dev)
    for name, t in (("mem_k_scale", mem_k_scale), ("mem_v_scale", mem_v_scale)):
        if t is not None:
            check(name, t, (n_layers, d), torch.float32, dev)
    check("mem_bias", mem_bias, (b, s), torch.float32, dev)

    x_out = torch.empty_like(x)
    attn = torch.empty((b, s), dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    w = stacked
    ptrs = ([x.data_ptr()] + [w[k].data_ptr() for k in (TC_KEYS if tc else WEIGHT_KEYS)]
            + [w[k].data_ptr() for k in BIAS_KEYS]
            + [ptr(w.get(k)) for k in SCALE_KEYS]
            + [w["rw"].data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
               mem_k.data_ptr(), mem_v.data_ptr(), ptr(mem_k_scale), ptr(mem_v_scale),
               mem_bias.data_ptr(), x_out.data_ptr(), attn.data_ptr()])
    dims = (b, d, f_dim, n_head, cap, s, index, n_layers)
    with torch.cuda.device(dev):
        plan = launch_plan(dev, dt, w8, kv8, dims)
        err = _kernel_fn("tal_stacked_step")(
            _DTYPE_CODE[dt], int(w8), int(kv8), (ctypes.c_void_p * _N_PTRS)(*ptrs),
            (ctypes.c_int * 8)(*dims), 1.0 / (d // n_head) ** 0.5, plan.group,
            plan.cluster, plan.clusters, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tal_stacked_step launch failed ({plan}): CUDA error {err}")
    stacked_decoder_step.launches += 1
    stacked_decoder_step.last_plan = plan
    return x_out, attn, cache_k, cache_v


stacked_decoder_step.launches = 0
stacked_decoder_step.last_plan = None
