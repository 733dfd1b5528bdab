"""The reference's four optimizers, with its exact update rules.

Counterpart of tal_asrd_tpu/train/optimizers.py (`lamb`, `radam`,
`adafactor`, `lookahead`), each a `torch.optim.Optimizer` whose step gives
the optax transformation's update on the same parameters and gradients:

  * `LAMB` (the optimizer the reference trains with):
        m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2   (no bias correction)
        adam_step = m / (sqrt(v) + eps) + weight_decay * p   (eps after the sqrt)
        trust = clamp(||p||, 0, 10) / ||adam_step||, or 1 when either norm is 0
        p <- p - lr * trust * adam_step
    with `always_adam` forcing trust to 1;
  * `RAdam`: the rectified step when N_sma >= 5, else -lr / (1 - b1^t) * m
    (no second moment, no eps); weight decay -wd * lr * p on the parameter
    before the step;
  * `Adafactor` (fairseq's order): the relative step scaled by RMS(p), the
    factored second moment, the RMS clip, then the lr, the optional first
    moment on the post-lr update, weight decay -wd * lr * p;
  * `Lookahead(inner)`: after each inner step, if counter == 0: slow +=
    alpha (fast - slow) and the parameter becomes slow; counter = (counter
    + 1) % k, so syncs fire on steps 1, k + 1, 2k + 1, ...

`lr` is a number or a schedule step -> lr; step counts the updates made
before this one, so the first update uses lr(0).

What JAX gives every leaf, these give every parameter: a parameter whose
`.grad` is None is stepped as if its gradient were zero (its moments decay,
weight decay and Lookahead's sync move it).

Scalars in float32, in JAX's order. The step's scalars (t, b2^t, RAdam's
N_sma and rectifier, Adafactor's beta2_t and relative step) are float32
arrays in JAX; here they are numpy float32 on the host, op for op, so the
card and the CPU take the same values (XLA's float32 `pow` gives the bits
numpy's does). N_sma = N_max - 2 t b2^t / (1 - b2^t) cancels: in float64
it parts from float32 by 0.1 % at t = 6, which the rectifier carries into
the step. A number `lr` stays a Python float (JAX's weak type), so
`weight_decay * lr` is a double product there and a float32 one for a
schedule's value, as in JAX.

Adafactor factors a leaf of rank >= 2 over the last two axes of the
reference's layout, not of PyTorch's: a grouped-conv weight [C_out,
C_in/G, K] is the reference's kernel [K, C_in/G, C_out], a Dense weight
[out, in] its [in, out]. Each parameter is updated through
`core.convert.unconvert_entry`'s view, keyed by the name PyTorch keeps in
its group's `param_names` (build the optimizer from
`model.named_parameters()`); its `vr` / `vc` keep the reference's shapes.
An unnamed parameter is factored in its own layout.

`reference_state()` gives each optimizer's state as numpy trees in the
layout of JAX's state NamedTuple, under the reference's parameter names:
LAMB and RAdam {"count", "mu", "nu"}, Adafactor {"count", "moments"},
Lookahead {"inner", "slow", "counter"}.

On a tensor-parallel model (`shards`, the model's
`parallel.tensor.ModelShards`) a sharded parameter and its moments hold
this process's shard: LAMB's norms, Adafactor's factored means over the
sharded axis and its RMS values are summed over the model axis, and
`reference_state()` gathers whole leaves (a collective: every process of
the axis calls it). LAMB takes its norms in a first pass over the
parameters and steps them in a second, so that one all-reduce carries
every sharded parameter's norms.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from tal_asrd_tpu_torch.core.checkpoint import to_numpy, tree_from_leaves
from tal_asrd_tpu_torch.core.convert import state_dict_to_params, unconvert_entry
from tal_asrd_tpu_torch.parallel.tensor import all_reduce_

LearningRate = Union[float, Callable[[int], float]]
f32 = np.float32


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _lr_at(lr: LearningRate, count: int):
    """The learning rate of the update after `count` updates, typed as JAX
    types it: a schedule's value is a float32 array, a number a Python
    float."""
    return f32(lr(count)) if callable(lr) else lr


def _times(a: float, lr) -> float:
    """a * lr as JAX computes `a * lr`: in double for a Python float lr,
    in float32 for an array. The result is a float32 value."""
    if isinstance(lr, torch.Tensor):
        return a * lr
    return float(f32(a * lr) if isinstance(lr, float) else f32(a) * lr)


class _ReferenceOptimizer(torch.optim.Optimizer):
    """Each parameter's state holds `step`, the updates made (the same for
    every parameter: all are stepped each time), and for LAMB and RAdam
    `exp_avg` / `exp_avg_sq` (m, v)."""

    shards = None       # the model's ModelShards on a tensor-parallel model

    def _shard_of(self, name: Optional[str]):
        """The ModelShards when parameter `name` is sharded, else None."""
        if self.shards is not None and name is not None and self.shards.sharded(name):
            return self.shards
        return None

    def set_shards(self, shards) -> None:
        """Step the shards of a tensor-parallel model (its ModelShards)."""
        self.shards = shards

    def _full(self, name: str, t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """`t` (a state tensor of parameter `name`, sharded on `dim`, by
        default the parameter's axis) gathered whole."""
        sh = self._shard_of(name)
        return t if sh is None else sh.gather(name, t, dim)

    def update_count(self) -> int:
        for state in self.state.values():
            return int(state["step"])
        return 0

    def reset_state(self) -> None:
        """Forget every moment and the update count: the state of a new
        optimizer."""
        self.state.clear()

    def copy_state_from(self, other: "_ReferenceOptimizer") -> None:
        """Take a copy of `other`'s state, `other` an optimizer of the same
        configuration whose parameters stand in the same order as this
        one's (on any device)."""
        self.state.clear()
        mine = [p for group in self.param_groups for p in group["params"]]
        theirs = [p for group in other.param_groups for p in group["params"]]
        for p, q in zip(mine, theirs):
            if q in other.state:
                self.state[p] = {k: v.detach().to(p.device, copy=True)
                                 if isinstance(v, torch.Tensor) else v
                                 for k, v in other.state[q].items()}

    def _named(self) -> Iterator[Tuple[Dict, str, torch.Tensor]]:
        """(group, name, parameter) of every parameter."""
        for group in self.param_groups:
            names = group.get("param_names")
            if names is None:
                raise ValueError(f"{type(self).__name__}.reference_state needs the "
                                 "parameters' names: build it from named_parameters()")
            for name, p in zip(names, group["params"]):
                yield group, name, p

    def _moment_tree(self, key: str) -> Dict:
        return state_dict_to_params({
            n: self._full(n, self.state[p][key] if p in self.state else torch.zeros_like(p))
            for _, n, p in self._named()})

    def reference_state(self) -> Dict:
        """JAX's LambState / RAdamState: count, mu, nu."""
        return {"count": np.asarray(self.update_count(), np.int32),
                "mu": self._moment_tree("exp_avg"), "nu": self._moment_tree("exp_avg_sq")}


class LAMB(_ReferenceOptimizer):
    """Per-parameter state: `step`, `exp_avg` (m) and `exp_avg_sq` (v), in
    the parameter's dtype."""

    def __init__(self, params: Iterable, lr: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                 always_adam: bool = False, clamp_weight_norm: float = 10.0):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        always_adam=always_adam, clamp_weight_norm=clamp_weight_norm)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.update_count()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd = group["weight_decay"]
            lr = group["lr"]
            lr = lr(count) if callable(lr) else lr
            params = group["params"]
            names = group.get("param_names") or [None] * len(params)

            def adam_step(p):
                m, v = self.state[p]["exp_avg"], self.state[p]["exp_avg_sq"]
                out = m / (v.sqrt() + eps)
                return out + wd * p if wd != 0.0 else out

            # pass 1: the moments, and each leaf's squared norms
            sq = []
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                g = _grad(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_(b1 * m + (1.0 - b1) * g)
                v.copy_(b2 * v + (1.0 - b2) * (g * g))
                if not group["always_adam"]:
                    sq.append((p.float().pow(2).sum(), adam_step(p).float().pow(2).sum()))
            cut = [self._shard_of(n) is not None for n in names]
            if sq and any(cut):     # the sharded leaves' norms summed over the model axis
                both = torch.stack([torch.stack(pair) for pair, c in zip(sq, cut) if c])
                all_reduce_(both, self.shards.group)
                parts = iter(both)
                sq = [tuple(next(parts)) if c else pair for pair, c in zip(sq, cut)]
            # pass 2: the steps
            for i, p in enumerate(params):
                step = adam_step(p)
                if group["always_adam"]:
                    scale = torch.tensor(-lr, dtype=torch.float32, device=p.device)
                else:
                    w_norm = sq[i][0].sqrt().clamp(0.0, group["clamp_weight_norm"])
                    a_norm = sq[i][1].sqrt()
                    trust = torch.where((w_norm == 0.0) | (a_norm == 0.0),
                                        torch.ones_like(w_norm), w_norm / a_norm)
                    scale = -lr * trust
                p.add_((scale * step).to(p.dtype))
                self.state[p]["step"] += 1
        return loss


class RAdam(_ReferenceOptimizer):
    """Per-parameter state: `step`, `exp_avg` (m) and `exp_avg_sq` (v), in
    the parameter's dtype."""

    def __init__(self, params: Iterable, lr: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def step_scalars(count: int, lr: LearningRate, b1: float, b2: float):
        """(use_rect, -lr * rect / (1 - b1^t) or -lr / (1 - b1^t), lr) of
        the update after `count` updates, in float32 in JAX's order. The
        rectifier's root is NaN for t = 3, 4 (a negative radicand); it is
        taken only where N_sma >= 5."""
        t = f32(count + 1)
        lr = _lr_at(lr, count)
        b2_t = f32(b2) ** t
        n_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = f32(n_max) - f32(2.0) * t * b2_t / (f32(1.0) - b2_t)
        bias1 = f32(1.0) - f32(b1) ** t
        use_rect = bool(n_sma >= f32(5.0))
        if use_rect:
            rect = np.sqrt((f32(1.0) - b2_t) * (n_sma - f32(4.0)) / f32(n_max - 4.0)
                           * (n_sma - f32(2.0)) / n_sma * f32(n_max) / f32(n_max - 2.0))
            scale = -(f32(lr) * rect / bias1)
        else:
            scale = -(f32(lr) / bias1)
        return use_rect, float(scale), lr

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.update_count()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd = group["weight_decay"]
            use_rect, scale, lr = self.step_scalars(count, group["lr"], b1, b2)
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                g = _grad(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_(b1 * m + (1.0 - b1) * g)
                v.copy_(b2 * v + (1.0 - b2) * (g * g))
                delta = scale * m / (v.sqrt() + eps) if use_rect else scale * m
                if wd != 0.0:
                    delta = delta - _times(wd, lr) * p
                p.add_(delta.to(p.dtype))
                state["step"] += 1
        return loss


class Adafactor(_ReferenceOptimizer):
    """Per-parameter state, in the reference's layout and in float32 (as
    JAX's after its first update): `step`, `vr` and `vc` (rank >= 2) or
    `v`, and `exp_avg` (m) with `beta1`."""

    def __init__(self, params: Iterable, lr: Optional[LearningRate] = None,
                 eps: Tuple[float, float] = (1e-30, 1e-3), clip_threshold: float = 1.0,
                 decay_rate: float = -0.8, beta1: Optional[float] = None,
                 weight_decay: float = 0.0, scale_parameter: bool = True,
                 relative_step: bool = True, warmup_init: bool = False):
        if not relative_step and lr is None:
            raise ValueError("Adafactor without relative_step needs lr")
        super().__init__(params, dict(
            lr=lr, eps=eps, clip_threshold=clip_threshold, decay_rate=decay_rate,
            beta1=beta1, weight_decay=weight_decay, scale_parameter=scale_parameter,
            relative_step=relative_step, warmup_init=warmup_init))

    @staticmethod
    def step_scalars(count: int, group: Dict):
        """(beta2_t, the step before RMS(p) scaling) of the update after
        `count` updates, as JAX types them."""
        t = f32(count + 1)
        beta2t = f32(1.0) - t ** f32(group["decay_rate"])
        if group["relative_step"]:
            min_step = f32(1e-6) * t if group["warmup_init"] else f32(1e-2)
            rel_step = min(min_step, f32(1.0) / np.sqrt(t))
        else:
            rel_step = _lr_at(group["lr"], count)
        return beta2t, rel_step

    @staticmethod
    def _rms(x: torch.Tensor, sh=None) -> torch.Tensor:
        """RMS over the whole leaf (its shards summed over the model axis)."""
        if sh is None:
            return x.float().pow(2).mean().sqrt()
        total = all_reduce_(x.float().pow(2).sum(), sh.group)
        return (total / (x.numel() * sh.size)).sqrt()

    @staticmethod
    def _mean(x: torch.Tensor, dim: int, sh=None, keepdim: bool = False) -> torch.Tensor:
        """Mean along `dim`; `sh` when that axis is the sharded one (equal
        shards: the mean of the processes' means)."""
        m = x.mean(dim=dim, keepdim=keepdim)
        if sh is None:
            return m
        return all_reduce_(m, sh.group) / sh.size

    @staticmethod
    def _layout(name: Optional[str], t: torch.Tensor) -> torch.Tensor:
        return t if name is None else unconvert_entry(name, t)[1]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.update_count()
        for group in self.param_groups:
            eps0, eps1 = group["eps"]
            beta1, wd = group["beta1"], group["weight_decay"]
            beta2t, rel_step = self.step_scalars(count, group)
            b_new, b_old = float(f32(1.0) - beta2t), float(beta2t)
            names = group.get("param_names") or [None] * len(group["params"])
            for name, param in zip(names, group["params"]):
                p = self._layout(name, param)
                sh = self._shard_of(name)
                a = None if sh is None else sh.plans[name].ref_dim
                n = p.dim()
                state = self.state[param]
                if not state:
                    state["step"] = 0
                    if beta1 is not None:
                        state["exp_avg"] = torch.zeros(p.shape, device=p.device)
                    if p.dim() >= 2:
                        state["vr"] = torch.zeros(p.shape[:-1], device=p.device)
                        state["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                                  device=p.device)
                    else:
                        state["v"] = torch.zeros(p.shape, device=p.device)
                g = self._layout(name, _grad(param)).float()
                p32 = p.float()
                lr = rel_step
                if group["scale_parameter"]:
                    lr = torch.clamp_min(self._rms(p32, sh), eps1) * float(rel_step)
                sq = g * g + eps0
                if p.dim() >= 2:
                    vr, vc = state["vr"], state["vc"]
                    vr.copy_(b_old * vr + b_new * self._mean(sq, -1, sh if a == n - 1 else None))
                    vc.copy_(b_old * vc + b_new * self._mean(sq, -2, sh if a == n - 2 else None))
                    r = torch.rsqrt(vr / self._mean(vr, -1, sh if a == n - 2 else None,
                                                    keepdim=True))[..., None]
                    c = torch.rsqrt(vc)[..., None, :]
                    upd = r * c * g
                else:
                    v = state["v"]
                    v.copy_(b_old * v + b_new * sq)
                    upd = torch.rsqrt(v) * g
                upd = upd / torch.clamp_min(self._rms(upd, sh) / group["clip_threshold"], 1.0)
                upd = upd * (lr if isinstance(lr, torch.Tensor) else float(lr))
                if beta1 is not None:
                    m = state["exp_avg"]
                    upd = beta1 * m + (1.0 - beta1) * upd
                    m.copy_(upd)
                delta = -upd
                if wd != 0.0:
                    delta = delta - _times(wd, lr) * p32
                p.add_(delta.to(p.dtype))
                state["step"] += 1
        return loss

    def reference_state(self) -> Dict:
        """JAX's AdafactorState: count, and each leaf's moments {vr, vc} or
        {v} (and m)."""
        leaves = []
        keys = {"vr": "vr", "vc": "vc", "v": "v", "exp_avg": "m"}
        for group, name, param in self._named():
            path, p = unconvert_entry(name, param)
            state = self.state.get(param) or {}
            if not state:       # the reference's init
                state = {"v": torch.zeros(p.shape)} if p.dim() < 2 else {
                    "vr": torch.zeros(p.shape[:-1]),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:])}
                if group["beta1"] is not None:
                    state["exp_avg"] = torch.zeros(p.shape)
            sh = self._shard_of(name)
            if sh is not None:  # each moment's sharded axis, in the reference's layout
                a, n = sh.plans[name].ref_dim, p.dim()
                axis = {"vr": None if a == n - 1 else a,
                        "vc": None if a == n - 2 else min(a, n - 2)}
                state = {k: t if k not in keys or axis.get(k, a) is None
                         else self._full(name, t, axis.get(k, a)) for k, t in state.items()}
            leaves += [(path + (keys[k],), to_numpy(t)) for k, t in state.items()
                       if k in keys]
        return {"count": np.asarray(self.update_count(), np.int32),
                "moments": tree_from_leaves(leaves)}


class Lookahead(_ReferenceOptimizer):
    """Wraps one of the port's optimizers (`inner`), sharing its parameter
    groups. Per-parameter state: `slow` (in the parameter's layout) and
    `counter`.

    JAX takes the slow copy at `init`. PyTorch builds the optimizer before a
    checkpoint is loaded into the model, so a copy taken here would be of
    the initial weights: the slow copy is taken at the first `step()`,
    when the state is empty (and again after the state is cleared), from
    the weights that step starts from.

    The parameter ends a step at p + (out - p), out the new slow weights on
    a sync and the inner step's p + d otherwise: JAX's `out - p` added back
    by `optax.apply_updates`, in f32 not always out itself."""

    def __init__(self, inner: torch.optim.Optimizer, k: int = 5, alpha: float = 0.5):
        self.inner = inner
        super().__init__(inner.param_groups, dict(k=k, alpha=alpha))

    def update_count(self) -> int:
        return self.inner.update_count()

    def set_shards(self, shards) -> None:
        super().set_shards(shards)
        self.inner.set_shards(shards)

    def reset_state(self) -> None:
        super().reset_state()
        self.inner.reset_state()

    def copy_state_from(self, other: "Lookahead") -> None:
        super().copy_state_from(other)
        self.inner.copy_state_from(other.inner)

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        if not self.state:
            for p in params:
                self.state[p] = {"slow": p.detach().clone(), "counter": 0}
        before = iter([p.detach().clone() for p in params])
        loss = self.inner.step(closure)
        for group in self.param_groups:
            k, alpha = group["k"], group["alpha"]
            for p, p0 in zip(group["params"], before):
                state = self.state[p]
                if state["counter"] == 0:
                    slow = state["slow"]
                    slow.copy_(slow + alpha * (p - slow))
                    p.copy_(p0 + (slow - p0))
                else:
                    p.copy_(p0 + (p - p0))
                state["counter"] = 0 if state["counter"] + 1 >= k else state["counter"] + 1
        return loss

    def reference_state(self) -> Dict:
        """JAX's LookaheadState: inner, slow, counter."""
        counter = next((s["counter"] for s in self.state.values()), 0)
        return {"inner": self.inner.reference_state(),
                "slow": state_dict_to_params({
                    n: self._full(n, self.state[p]["slow"] if p in self.state else p)
                    for _, n, p in self._named()}),
                "counter": np.asarray(counter, np.int32)}
