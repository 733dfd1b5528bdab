"""The loop of `kind: train` mixes: training steps of the program's
`ASRSystem.train_step`, as many as the window holds, each on `batch`
utterances collated inside the timed loop by the program's
`BucketedCollater` (int16 audio, its buckets) and uploaded by its
`to_device`. Utterances are a pool of `pool`, their lengths drawn from the
seed in [min_seconds, max_seconds], their targets a start token, one speaker
token and `tokens_per_second` text tokens a second, then an end token; the
pool is dealt in a seeded order, epoch after epoch.

Set-up builds the system once (float32 parameters, the configuration's
compute dtype, LAMB, the mix's `train` settings as TrainConfig), drives it
through `checked_steps` steps of the window's own call and feed on rows
that all differ, recording the masks its dropout drew, then `warm_steps`
more, and hands the same object to the window.

What is measured: the unpadded audio of all steps over all of the window.
What is checked: the reference follows the checked steps (same weights,
batches, SpecAugment seeds and token replacements from the step's
generator, dropout masks) in float32: each step's loss, the norm of each
leaf's first gradient as LAMB holds it (its first moment over 1 - b1), and
the norm of each leaf's change over the checked steps, on the elements
whose reference gradient is not nought to rounding.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import build, counts, reference
from benchmark.audio import speechlike
from benchmark.spy import DropoutRecorder

SR = 16000
START, END = 1, 2
ROWS_PER_BLOCK = 16


class Run:
    metric = "train_audio_s_per_s"

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.shape = counts.Shape.of(config)
        self.losses: List[torch.Tensor] = []
        self._ref = None

    # -- set-up ----------------------------------------------------------
    def _pool(self) -> None:
        mix, dev = self.mix, self.device
        rng = np.random.default_rng([self.seed, 1])
        n = mix["pool"]
        secs = rng.uniform(mix["min_seconds"], mix["max_seconds"], n)
        lens = np.round(secs * SR).astype(np.int64)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        audio = speechlike(gen, n, int(lens.max()), mix["audio"], dev).cpu().numpy()
        v, s = self.shape.vocab_size, self.shape.num_speakers
        self.utts = []
        for i in range(n):
            k = int(round(mix["tokens_per_second"] * secs[i]))
            text = np.concatenate([[START, v + rng.integers(s)],
                                   rng.integers(3, v, k), [END]]).astype(np.int32)
            self.utts.append((audio[i, :lens[i]], text, np.zeros(len(text), np.int32), i))
        self.order: List[int] = []
        self.epoch = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.mix["batch"]
        while len(self.order) < b:
            self.epoch += 1
            rng = np.random.default_rng([self.seed, 3, self.epoch])
            self.order.extend(rng.permutation(len(self.utts)).tolist())
        take, self.order = self.order[:b], self.order[b:]
        return self.collate([self.utts[i] for i in take])

    def setup(self) -> None:
        from tal_asrd_tpu_torch.data.collate import BucketedCollater
        from tal_asrd_tpu_torch.data.loader import to_device
        cfg, mix, dev = self.config, self.mix, self.device
        self.to_device = lambda batch: to_device(batch, dev)
        self.collate = BucketedCollater(pad_id=0, audio_bucket_seconds=mix["audio_buckets"],
                                        text_buckets=mix["text_buckets"],
                                        audio_int16=mix["audio_int16"])
        self.names = build.shapes_of(cfg)
        weights = build.draw_weights(self.names, self.seed, dev, cfg["embed_size"])
        train_kw = dict(mix["train"], batch_size=mix["batch"], seed=self.seed)
        self.system = build.training_system(cfg, train_kw, weights)
        self._pool()
        torch.manual_seed(self.seed)
        opt = self.system.optimizer
        b1 = opt.param_groups[0]["b1"]
        params = dict(self.system.model.named_parameters())
        self.checked, self.prog_losses = [], []
        for k in range(mix["checked_steps"]):
            batch = self.next_batch()
            with DropoutRecorder() as rec:
                metrics = self.system.train_step(self.to_device(batch))
            self.prog_losses.append(float(metrics["loss"]))
            self.checked.append((batch, rec))
            if k == 0:
                # an optimizer that kept no moment held no gradient: 0
                self.prog_grad = {n: float(opt.state[p]["exp_avg"].norm()) / (1.0 - b1)
                                  if "exp_avg" in opt.state.get(p, {}) else 0.0
                                  for n, p in params.items()}
        with torch.no_grad():
            self.prog_change = {n: (p - weights[n]).cpu() for n, p in params.items()}
        del weights
        for _ in range(mix["warm_steps"]):
            self.system.train_step(self.to_device(self.next_batch()))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the timed path ----------------------------------------------------
    def step(self, spans: Dict[str, List[float]] = None, ranges: bool = False):
        t0 = time.perf_counter()
        batch = self.next_batch()
        on_device = self.to_device(batch)
        if spans is not None:
            spans.setdefault("collate", []).append(time.perf_counter() - t0)
        if ranges:
            with record_function("bench.step"):
                metrics = self.system.train_step(on_device)
        else:
            metrics = self.system.train_step(on_device)
        self.losses.append(metrics["loss"])
        return batch

    def window(self, seconds: float, spans: Dict[str, List[float]] = None) -> Dict:
        self.losses = []
        shapes, audio_s = [], 0.0
        t0 = time.perf_counter()
        while True:
            batch = self.step(spans)
            audio_s += float(batch["audio_lens"].sum()) / SR
            shapes.append((batch["audio"].shape[1], batch["text"].shape[1] - 1))
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        return {"attempted": len(shapes), "wall_s": wall, "audio_s": audio_s, "shapes": shapes}

    def end_to_end(self, stats: Dict) -> Dict[str, float]:
        return {self.metric: stats["audio_s"] / stats["wall_s"]}

    def traced(self) -> int:
        k = self.mix["trace_steps"]
        for _ in range(k):
            self.step(ranges=True)
        return k

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        self.losses = [x.cpu() for x in self.losses]
        del self.system
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def _noise(self, step: int, b: int, l: int):
        """The step's draws as ASRSystem.draw_noise makes them: a device
        generator seeded by (seed, step); SpecAugment seeds, then the token
        replacement of the inputs."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 2 ** 32 + step) % 2 ** 63)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (b,), generator=gen, device=self.device,
                              dtype=torch.int32)
        p = self.mix["train"]["token_replace_prob"]
        replace = torch.rand((b, l - 1), generator=gen, device=self.device) < p
        tok = torch.randint(0, self.shape.vocab_size, (b, l - 1), generator=gen,
                            device=self.device)
        return seeds, replace, tok

    def _follow(self, prec: reference.Precision) -> Dict:
        """The reference's checked steps: losses, first gradients, changes."""
        cfg, dev, mix = self.config, self.device, self.mix
        w0 = build.draw_weights(self.names, self.seed, dev, cfg["embed_size"])
        params = {n: t.clone().requires_grad_(True) for n, t in w0.items()}
        lr = float(np.float32(mix["train"]["lr"] * math.sqrt(mix["batch"])))
        smoothing = mix["train"].get("smoothing", 0.0)
        state: Dict = {}
        losses, first = [], None
        for k, (batch, rec) in enumerate(self.checked):
            audio = torch.as_tensor(batch["audio"], device=dev)
            lens = torch.as_tensor(batch["audio_lens"], device=dev).long()
            y = torch.as_tensor(batch["text"], device=dev).long()
            tmask = torch.as_tensor(batch["text_mask"], device=dev)[:, 1:]
            b, l = y.shape
            seeds, replace, tok = self._noise(k, b, l)
            masks = rec.keep_masks(dev)
            with torch.no_grad():
                frames = audio.shape[1] // reference.model.HOP + 1
                feats = reference.features(audio, lens, keep=reference.specaug_keep(
                    seeds, frames, cfg["n_mels"]))
            y_prev = torch.where(replace, tok, y[:, :-1])
            count = tmask.to(torch.float32).sum()
            total = 0.0
            for r in range(0, b, ROWS_PER_BLOCK):
                rows = slice(r, r + ROWS_PER_BLOCK)
                drops = reference.Drops(masks, rows)
                mem = reference.encode(params, feats[rows], cfg["tds_depths"], cfg["n_mels"],
                                       prec, drops)
                mmask = reference.padding_mask(lens[rows], audio.shape[1], mem.shape[1])
                logits = reference.decoder_logits(params, y_prev[rows], mem, mmask,
                                                  self.shape.n_decoder_layers,
                                                  cfg["n_head"], prec, drops)
                loss = reference.token_loss(logits, y[rows, 1:], tmask[rows], smoothing, count)
                loss.backward()
                total += float(loss.detach())
                if not drops.done():
                    raise RuntimeError("the reference left recorded dropout masks unused")
            losses.append(total)
            grads = {n: p.grad for n, p in params.items()}
            if first is None:
                first = {n: g.clone() for n, g in grads.items()}
            reference.lamb_step({n: p.data for n, p in params.items()}, grads, state, lr)
            for p in params.values():
                p.grad = None
        change = {n: (params[n].detach() - w0[n]) for n in params}
        return {"losses": losses, "grad": first, "change": change}

    def check(self, control: bool = False, detail: bool = False) -> Dict:
        with reference.exact():
            if self._ref is None:
                self._ref = self._follow(reference.Precision("float32"))
            ref = self._ref
            if control:
                low = self._follow(reference.Precision("fp8"))
                side = {"losses": low["losses"],
                        "grad": {n: float(g.norm()) for n, g in low["grad"].items()},
                        "change": low["change"]}
            else:
                side = {"losses": self.prog_losses, "grad": self.prog_grad,
                        "change": self.prog_change}
        return compare(ref, side, detail)


def compare(ref: Dict, side: Dict, detail: bool = False) -> Dict:
    """The three numbers of a training check (see the module's notes).
    Leaves count by the worst: the gap between the two norms over the
    reference's norm of that leaf or of the median leaf, whichever is the
    larger. The change leaves out the elements whose first reference
    gradient lies under 1e-3 of the median leaf's RMS gradient."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"]))
    ref_grad = {n: float(g.norm()) for n, g in ref["grad"].items()}
    med = float(np.median(list(ref_grad.values())))
    grad_gap = max(abs(side["grad"][n] - g) / max(g, med) for n, g in ref_grad.items())
    rms = float(np.median([float(g.pow(2).mean().sqrt()) for g in ref["grad"].values()]))
    norms = {}
    for n, g in ref["grad"].items():
        kept = g.abs() >= 1e-3 * rms
        if bool(kept.any()):
            a = side["change"][n].to(g.device)[kept]
            norms[n] = (float(a.norm()), float(ref["change"][n][kept].norm()))
    med_c = float(np.median([r for _, r in norms.values()]))
    change = {n: abs(a - r) / max(r, med_c) for n, (a, r) in norms.items()}
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": max(change.values())}
    if detail:
        grads = {n: abs(side["grad"][n] - g) / max(g, med) for n, g in ref_grad.items()}
        out["detail"] = {
            "losses": [side["losses"], ref["losses"]],
            "grad_median": float(np.median(list(grads.values()))),
            "change_median": float(np.median(list(change.values()))),
            "grad_worst": [(n, v, side["grad"][n], ref_grad[n]) for n, v in
                           sorted(grads.items(), key=lambda kv: -kv[1])[:6]],
            "change_worst": [(n, v) + norms[n] for n, v in
                             sorted(change.items(), key=lambda kv: -kv[1])[:6]],
            "grad_median_leaf": med, "change_median_leaf": med_c,
            "leaves_kept": len(norms)}
    return out
