"""Fused decoder layer step (K1): one CUDA kernel per (layer, token), and
what it shares with the stacked step (K3, ops/cuda_decode_stacked.py).

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
weight byte per lane, far below the card's ~295 operations per byte in bf16,
so the floor is the traffic: the layer's weights (14*D^2 elements:
3+1+1+1+4+4), the lanes' cross K/V (2*B*S*D) and the live part of the self
cache. K1 and K3 are one cluster kernel (csrc/cluster_step.cuh) at two sets
of rounding points, K1 with one layer: a cluster of up to 16 CTAs owns a
group of lanes (`stacked_launch_plan`, the same rule for both), splits each
weight product's output columns and each attention's (lane, head) items
across its CTAs, reads every weight once per cluster, and exchanges the
lane vectors through distributed shared memory. In bf16 the weight products
run on the tensor cores, from weights that `pack_layer` / `quantize_packed`
(and `stack_packed` for K3) also store in the order of the mma A fragment
(`fragment_order`, keys `tc_*`); the f32 kernel and the plain versions read
the [in, out] matrices.

K1's rounding points (mirrored exactly by the plain version so kernel-vs-plain
on the card is tight in bf16): every product takes operands in the storage
dtype with f32 accumulation; `q*scale`, the probabilities and the input of
each weight product are rounded to the storage dtype first; the residual
stream is f32 until the final store. int8 values are exact in the storage
dtype; a weight scale multiplies the f32 sum (`* s + b`), never the weights;
the K scale folds into the query before its rounding and the V scale
multiplies the f32 PV sum.

`fused_layer_step` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback from a failed build, a
failed launch or a shape the kernel does not take.
`fused_layer_step.launches` counts kernel launches and
`fused_layer_step.last_plan` holds the plan of the last launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from tal_asrd_tpu_torch.ops import _build

NEG_INF = -1e9

WEIGHT_KEYS = ("wqkv", "wso", "wcq", "wco", "wf1", "wf2")
BIAS_KEYS = ("bqkv", "bso", "bcq", "bco", "bf1", "bf2")
SCALE_KEYS = ("sqkv", "sso", "scq", "sco", "sf1", "sf2")
TC_KEYS = tuple("tc_" + k for k in WEIGHT_KEYS)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8                 # lanes of a cluster: the N = 8 of mma.m16n8k16
CLUSTER_SIZES = (16, 8)       # CTAs of a cluster, in order of preference


# ---------------------------------------------------------------------------
# Weights in the order the tensor cores read them
# ---------------------------------------------------------------------------
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
    """[..., K, N] weights -> [..., K * N] in the order the cluster kernel's
    tensor cores read them: 16-column tiles, each a run of 16-byte loads
    along K, one per thread of a warp per load (K-groups of 16 for bf16, 32
    for int8, so a load holds 8 or 16 values)."""
    *lead, k, n = w.shape
    kpack = 2 if w.dtype == torch.int8 else 1
    kg = 16 * kpack
    if k % kg or n % 16:
        raise ValueError(f"fragment_order needs K % {kg} == 0 and N % 16 == 0, got {k}, {n}")
    tiles = (w.reshape(-1, k // kg, kg, n // 16, 16).permute(0, 3, 1, 4, 2)
             .reshape(-1, n // 16, k // kg, 16 * kg))          # [., col tile, k group, (col, k)]
    idx = _fragment_index(kpack, w.device)
    return tiles[..., idx].reshape(*lead, k * n).contiguous()


def fragment_unorder(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of `fragment_order`: [..., K * N] -> [..., K, N]."""
    lead = f.shape[:-1]
    kpack = 2 if f.dtype == torch.int8 else 1
    kg = 16 * kpack
    tiles = torch.empty((f[..., 0].numel(), n // 16, k // kg, 16 * kg), dtype=f.dtype,
                        device=f.device)
    tiles[..., _fragment_index(kpack, f.device)] = f.reshape(-1, n // 16, k // kg, 16 * kg)
    return (tiles.reshape(-1, n // 16, k // kg, 16, kg).permute(0, 2, 4, 1, 3)
            .reshape(*lead, k, n))


def with_fragments(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`packed` with each bf16 or int8 weight matrix [..., in, out] also in
    fragment order under its `tc_*` key (what the bf16 kernels read), where
    the shape is one the kernels take (in and out in 32s); float32 weights
    get none (the f32 kernel reads [in, out])."""
    out = dict(packed)
    ws = [packed[k] for k in WEIGHT_KEYS]
    if ws[0].dtype in (torch.bfloat16, torch.int8) and \
            all(w.shape[-2] % 32 == 0 and w.shape[-1] % 32 == 0 for w in ws):
        out.update({tk: fragment_order(w) for tk, w in zip(TC_KEYS, ws)})
    return out


# ---------------------------------------------------------------------------
# Packing and quantization
# ---------------------------------------------------------------------------
def pack_layer(layer: torch.nn.Module,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A models/decoder.py RZDecoderLayer (taken by its attributes, so this
    module needs nothing of models/) -> packed kernel weights: matrices [in, out] in `dtype`
    (in bf16 also in fragment order under `tc_*`, `with_fragments`),
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
    return with_fragments({
        "wqkv": w(sa.qkv), "bqkv": b(sa.qkv),
        "wso": w(sa.out_proj), "bso": b(sa.out_proj),
        "wcq": w(ca.q), "bcq": b(ca.q),
        "wco": w(ca.out_proj), "bco": b(ca.out_proj),
        "wf1": w(layer.linear1), "bf1": b(layer.linear1),
        "wf2": w(layer.linear2), "bf2": b(layer.linear2),
        "rw": rw, "resweight": rw[0], "resweight_src": rw[1],
    })


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
    [out] under the s* keys, and its `tc_*` fragments are made anew from the
    int8 values. Biases and `rw` pass through unchanged."""
    out = dict(packed)
    for wk, sk in zip(WEIGHT_KEYS, SCALE_KEYS):
        out[wk], out[sk] = _quantize(packed[wk], (0,))
    return with_fragments(out)


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
# The launch plan of the cluster kernel (K1 and K3 alike)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the cluster kernel covers B lanes: `clusters` clusters of
    `cluster` CTAs, cluster k owning lanes [k * B // clusters, (k + 1) * B //
    clusters), at most `group` of them. `slots` clusters fit on the card at
    once; `waves` > 1 says that the clusters do not all fit and run in turns."""
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

    def as_dict(self) -> Dict[str, int]:
        return {"group": self.group, "cluster": self.cluster, "clusters": self.clusters,
                "ctas": self.ctas, "slots": self.slots, "waves": self.waves}


def stacked_launch_plan(b: int, sm_count: int, slots: Optional[Dict[int, int]] = None,
                        sizes: Tuple[int, ...] = CLUSTER_SIZES) -> LaunchPlan:
    """The cluster kernel's launch plan for b lanes (K1's and K3's). At the
    first cluster size C of `sizes` of which the card holds at least one
    cluster at once (`slots[C]`, from the device's occupancy query; without
    it sm_count // C), the lanes are spread evenly over min(slots, b)
    clusters, unless that puts more than MAX_GROUP lanes in a cluster; then
    the next size is tried. The largest cluster reads every weight the
    fewest times: on an H100 (7 slots of 16 CTAs, 15 of 8) B = 32 gives 7
    clusters of 16 CTAs (4-5 lanes each, 112 CTAs), measured faster for K3
    than 15 clusters of 8 (2-3 lanes, 120 CTAs); B = 8 gives 7 clusters of 16
    (1-2 lanes). When every size would need more than MAX_GROUP lanes a
    cluster, the clusters hold MAX_GROUP lanes and run in waves, at the size
    that needs the fewest."""
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


# ---------------------------------------------------------------------------
# Launch plumbing. Each kernel has two C entry points: the step, which takes
# (dtype, w8, kv8, pointer table, dims, scale, group, cluster, clusters,
# stream), the table in the order of params_from in csrc/decode_step.cuh;
# and its occupancy query (dtype, w8, kv8, dims, group, cluster, *slots).
# ---------------------------------------------------------------------------
SLOTS_FN = {"tal_layer_step": "tal_layer_cluster_slots",
            "tal_stacked_step": "tal_stacked_cluster_slots"}
_N_PTRS = 29
_fns: Dict[str, object] = {}
_plans: Dict[tuple, LaunchPlan] = {}


def kernel_fn(name: str):
    """The C entry point `name` of the kernels' library, built at first use."""
    if name not in _fns:
        fn = getattr(_build.load_library(), name)
        c_int, p_int = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        if name in SLOTS_FN:
            fn.argtypes = [c_int, c_int, c_int, ctypes.POINTER(ctypes.c_void_p), p_int,
                           ctypes.c_float, c_int, c_int, c_int, ctypes.c_void_p]
        else:           # an occupancy query
            fn.argtypes = [c_int, c_int, c_int, p_int, c_int, c_int, p_int]
        fn.restype = c_int
        _fns[name] = fn
    return _fns[name]


def cluster_slots(kernel: str, dt: torch.dtype, w8: bool, kv8: bool, dims) -> Dict[int, int]:
    """How many clusters of each size of CLUSTER_SIZES the current device
    holds at once for `kernel`'s instantiation and shape (with the shared
    memory of MAX_GROUP lanes)."""
    dims_c = (ctypes.c_int * 8)(*dims)
    slots = {}
    for c in CLUSTER_SIZES:
        n = ctypes.c_int(0)
        err = kernel_fn(SLOTS_FN[kernel])(
            _DTYPE_CODE[dt], int(w8), int(kv8), dims_c, MAX_GROUP, c, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"{SLOTS_FN[kernel]}({c}) failed: CUDA error {err}")
        slots[c] = n.value
    return slots


def launch_plan(kernel: str, dev: torch.device, dt: torch.dtype, w8: bool, kv8: bool,
                dims) -> LaunchPlan:
    """The plan of `kernel` for one shape on one card, kept after the first
    call (the index does not change it)."""
    key = (kernel, dev.index, dt, w8, kv8, tuple(dims[:6]) + tuple(dims[7:]))
    if key not in _plans:
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _plans[key] = stacked_launch_plan(dims[0], sm, cluster_slots(kernel, dt, w8, kv8, dims))
    return _plans[key]


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


def check_cluster_shape(dt: torch.dtype, kv8: bool, d: int, f_dim: int, n_head: int) -> None:
    """The shapes the cluster kernel takes, K1's and K3's alike (shapes_ok in
    csrc/cluster_step.cuh): D and F in 32s (16-column tiles, K in 32s), and a
    head of 16 to 192 channels (a thread per channel in half a CTA of 384)
    that spans a power of two <= 32 of 16-byte groups in the cache's and the
    cross K/V's types."""
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the decode kernels store float32 or bfloat16, got {dt}")
    dh = d // n_head
    vecs = (16 // torch.empty((), dtype=dt).element_size(), 16 if kv8 else None)
    ok = d % n_head == 0 and d % 32 == 0 and f_dim % 32 == 0 and 16 <= dh <= 192
    for v in filter(None, vecs):
        lph = dh // v
        ok = ok and dh % v == 0 and 1 <= lph <= 32 and lph & (lph - 1) == 0
    if not ok:
        raise ValueError(
            f"the decode kernels need D and F divisible by 32, 16 <= head_dim <= 192 and "
            f"head_dim / (16-byte width) a power of two <= 32; got D={d}, F={f_dim}, "
            f"head_dim={dh}, {dt}, kv8={kv8}")


def check_operands(x, w, cache_k, cache_v, mem_k, mem_v, mem_bias, index: int, n_head: int,
                   mem_k_scale, mem_v_scale, w8: bool, kv8: bool) -> Tuple[int, ...]:
    """Checks the operands of a decode kernel on x's device: K1's, or K3's
    with a leading layer axis on every weight, bias, cache, cross K/V and
    scale. bf16 storage also needs each `tc_*` fragment copy, of its
    weight's dtype and element count. Returns the kernel's dims (B, D, F, H,
    L, S, index, n_layers); the wrappers have checked the index."""
    lead = tuple(cache_k.shape[:-3])          # () for K1, (n_layers,) for K3
    b, d = x.shape
    cap, s = cache_k.shape[-2], mem_k.shape[-2]
    f_dim = w["wf1"].shape[-1]
    dt, dev = x.dtype, x.device
    check_cluster_shape(dt, kv8, d, f_dim, n_head)
    wt = torch.int8 if w8 else dt
    kvt = torch.int8 if kv8 else dt
    check("x", x, (b, d), dt, dev)
    outs = (3 * d, d, d, d, f_dim, d)
    for wk, shape in zip(WEIGHT_KEYS, ((d, 3 * d), (d, d), (d, d), (d, d),
                                        (d, f_dim), (f_dim, d))):
        check(wk, w[wk], lead + shape, wt, dev)
        if dt == torch.bfloat16:             # the tensor cores read the fragments
            tk = "tc_" + wk
            if tk not in w:
                raise ValueError(f"{tk} missing: pack the weights with pack_layer, "
                                 f"quantize_packed or stack_packed (with_fragments)")
            check(tk, w[tk], lead + (shape[0] * shape[1],), wt, dev)
    for bk, sk, n in zip(BIAS_KEYS, SCALE_KEYS, outs):
        check(bk, w[bk], lead + (n,), torch.float32, dev)
        if w8:
            check(sk, w[sk], lead + (n,), torch.float32, dev)
    check("rw", w["rw"], lead + (2,), torch.float32, dev)
    check("cache_k", cache_k, lead + (b, cap, d), dt, dev)
    check("cache_v", cache_v, lead + (b, cap, d), dt, dev)
    check("mem_k", mem_k, lead + (b, s, d), kvt, dev)
    check("mem_v", mem_v, lead + (b, s, d), kvt, dev)
    for name, t in (("mem_k_scale", mem_k_scale), ("mem_v_scale", mem_v_scale)):
        if t is not None:
            check(name, t, lead + (d,), torch.float32, dev)
    check("mem_bias", mem_bias, (b, s), torch.float32, dev)
    return (b, d, f_dim, n_head, cap, s, index, lead[0] if lead else 1)


def launch_step(kernel: str, x, w, cache_k, cache_v, mem_k, mem_v, mem_bias, index: int,
                n_head: int, mem_k_scale, mem_v_scale, w8: bool, kv8: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, LaunchPlan]:
    """Checks the operands of `kernel` (tal_layer_step or tal_stacked_step)
    and launches it on the current stream under its launch plan. Returns
    (x_out, attn, plan); raises on a refused launch."""
    dims = check_operands(x, w, cache_k, cache_v, mem_k, mem_v, mem_bias, index, n_head,
                          mem_k_scale, mem_v_scale, w8, kv8)
    dt, dev = x.dtype, x.device
    x_out = torch.empty_like(x)
    attn = torch.empty((x.shape[0], mem_k.shape[-2]), dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    ptrs = ([x.data_ptr()]
            + [w[k].data_ptr() for k in (TC_KEYS if dt == torch.bfloat16 else WEIGHT_KEYS)]
            + [w[k].data_ptr() for k in BIAS_KEYS] + [ptr(w.get(k)) for k in SCALE_KEYS]
            + [w["rw"].data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
               mem_k.data_ptr(), mem_v.data_ptr(), ptr(mem_k_scale), ptr(mem_v_scale),
               mem_bias.data_ptr(), x_out.data_ptr(), attn.data_ptr()])
    with torch.cuda.device(dev):
        plan = launch_plan(kernel, dev, dt, w8, kv8, dims)
        err = kernel_fn(kernel)(
            _DTYPE_CODE[dt], int(w8), int(kv8), (ctypes.c_void_p * _N_PTRS)(*ptrs),
            (ctypes.c_int * 8)(*dims), 1.0 / (dims[1] // n_head) ** 0.5, plan.group,
            plan.cluster, plan.clusters, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed ({plan}): CUDA error {err}")
    return x_out, attn, plan


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
    d = x.shape[1]
    l_buf = cache_k.shape[1]
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
    x_out, attn, plan = launch_step("tal_layer_step", x, weights, cache_k, cache_v, mem_k,
                                    mem_v, mem_bias, index, n_head, mem_k_scale, mem_v_scale,
                                    w8, kv8)
    fused_layer_step.launches += 1
    fused_layer_step.last_plan = plan
    return x_out, attn, cache_k, cache_v


fused_layer_step.launches = 0
fused_layer_step.last_plan = None
