"""The loop of `kind: generate` mixes: a closed loop of calls to the program's
serving entry, `make_generate_fn` with the fused decoder (kernel K1), each
call a batch of `batch` windows of `window_seconds`, `beam` lanes a window,
`max_new_tokens` new tokens with EOS off (eos_id -1, force_output), the
search primed with token 1. The audio is a pool of `pool` batches made on
the device at set-up; calls take them in turn.

What is measured: all audio decoded over all of the window (audio-s/s).
What is checked: a sample of the windows the window's calls finished (one
row from each of `check_rows` equal strata of the batch, each from another
of the window's first `check_calls` calls, drawn from the seed before the
window). In a drawn call the fused step's logits of the drawn window's lanes
and the search's choice at every step are copied to the host as they come
(`StepRecorder`), so that the check can follow the served row back through
the beams. The plain float32 reference decodes the same audio and the
served tokens again:
  * score_gap: the widest gap between the program's score of a row (the sum
    of its tokens' log-probabilities) and the reference's;
  * logit_err: the widest over the rows of the mean, over a row's positions,
    of the distance between the fused step's logits and the reference's,
    over the spread of the reference's;
  * token_gap: the widest gap by which a served token's reference logit
    lies below the reference's `beam`-th best at its position (a search
    keeps only candidates among the `beam` best continuations of their own
    row; with `beam` 1, below the reference's best).
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import build, counts, reference
from benchmark.audio import speechlike

PRIME = 1


class StepRecorder:
    """For one call: the logits of every decoder step on the `beam` lanes of
    window `row`, and the search's choice for that window at every step (its
    flat (lane, token) index), copied as they come into host buffers made at
    set-up (pinned on the card), so that recording holds no device memory.
    Set on the decoder instance and on the search's `top_k` while the call
    runs."""

    def __init__(self, row: int, beam: int, steps: int, vocab: int, dtype, device):
        self.row, self.beam, self.vocab = row, beam, vocab
        pin = device.type == "cuda"
        self.logits = torch.empty((steps, beam, vocab), dtype=dtype, pin_memory=pin)
        self.choices = torch.empty((steps, beam), dtype=torch.int64, pin_memory=pin)
        self.steps = self.chosen = 0

    @contextlib.contextmanager
    def on(self, decoder):
        from tal_asrd_tpu_torch.decode import beam as search
        step, top_k = decoder.decode_step, search.top_k
        lanes = slice(self.row * self.beam, (self.row + 1) * self.beam)
        self.steps = self.chosen = 0

        def recording_step(y_tok, state):
            out = step(y_tok, state)
            self.logits[self.steps].copy_(out[0][lanes], non_blocking=True)
            self.steps += 1
            return out

        def recording_top_k(x, k):
            values, index = top_k(x, k)
            self.choices[self.chosen].copy_(index[self.row], non_blocking=True)
            self.chosen += 1
            return values, index
        decoder.decode_step, search.top_k = recording_step, recording_top_k
        try:
            yield
        finally:
            del decoder.decode_step
            search.top_k = top_k

    def path(self, tokens: torch.Tensor) -> Optional[torch.Tensor]:
        """Once the call has ended: the logits [steps, V] that scored each of
        the window's served tokens (`tokens` [B, P + steps]), followed back
        through the beams from the final lane whose choices spell the served
        row; None where no lane's do."""
        if self.steps != len(self.logits) or self.chosen != len(self.choices):
            return None
        served = tokens[self.row, -self.chosen:].cpu().tolist()
        for last in range(self.beam):
            lane, lanes, toks = last, [], []
            for t in range(self.chosen - 1, -1, -1):
                flat = int(self.choices[t, lane])
                toks.append(flat % self.vocab)
                lane = flat // self.vocab
                lanes.append(lane)
            if toks[::-1] == served:
                return self.logits[torch.arange(self.steps), torch.tensor(lanes[::-1])].float()
        return None


class Run:
    metric = "decode_audio_s_per_s"

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.shape = counts.Shape.of(config)
        self.n = int(round(mix["window_seconds"] * 16000))
        self.outputs: List[Dict] = []
        self.picks = self.sample()
        self.recorded: Dict[Tuple[int, int], Optional[torch.Tensor]] = {}

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
        from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
        cfg, mix, dev = self.config, self.mix, self.device
        self.names = build.shapes_of(cfg)
        weights = build.draw_weights(self.names, self.seed, dev, cfg["embed_size"])
        self.model = build.serving_model(cfg, weights)
        del weights
        self.decoder = FusedASRDecoder(self.model)
        self.spec = BeamSearchSpec(
            beam_size=mix["beam"], max_new_tokens=mix["max_new_tokens"], eos_id=-1,
            vocab_size=self.shape.num_tokens, text_vocab_size=self.shape.vocab_size,
            force_output=True)
        self.generate = make_generate_fn(self.model, self.spec, decoder=self.decoder,
                                         device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        b = mix["batch"]
        self.pool = [speechlike(gen, b, self.n, mix["audio"], dev) for _ in range(mix["pool"])]
        self.lens = torch.full((b,), self.n, dtype=torch.int64, device=dev)
        self.prime = torch.full((b, 1), PRIME, dtype=torch.int64, device=dev)
        self.recorders = {call: StepRecorder(row, mix["beam"], mix["max_new_tokens"],
                                             self.shape.num_tokens,
                                             getattr(torch, cfg["compute_dtype"]), dev)
                          for call, row in self.picks}
        self.call(0)                 # builds the kernels at first use, warms every shape
        self.outputs.clear()

    # -- the timed path ----------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int, spans: Dict[str, List[float]] = None) -> None:
        """One closed-loop call on pool batch i, its output kept. With
        `spans`, the two calls `generate` makes are made here, in its order
        and under inference_mode, each in a host range with its host time."""
        audio = self.pool[i % len(self.pool)]
        if spans is None:
            out = self.generate(audio, self.lens, self.prime)
        else:
            from tal_asrd_tpu_torch.decode.beam import beam_search
            with torch.inference_mode():
                t0 = time.perf_counter()
                with record_function("bench.encode"):
                    enc = self.model.encode(audio, self.lens)
                    self._sync()
                t1 = time.perf_counter()
                with record_function("bench.search"):
                    out = beam_search(self.decoder, enc, self.prime, self.spec)
                    self._sync()
                t2 = time.perf_counter()
            spans.setdefault("encode", []).append(t1 - t0)
            spans.setdefault("search", []).append(t2 - t1)
        self._sync()
        self.outputs.append({"pool": i % len(self.pool), "tokens": out["tokens"],
                             "scores": out["scores"], "lengths": out["lengths"]})

    def window(self, seconds: float, spans: Dict[str, List[float]] = None) -> Dict:
        from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
        launches0 = fused_layer_step.launches
        self.outputs.clear()
        self.recorded.clear()
        t0 = time.perf_counter()
        i, ends = 0, []
        while True:
            rec = self.recorders.get(i)
            if rec is None:
                self.call(i, spans)
            else:
                with rec.on(self.decoder):
                    self.call(i, spans)
                self.recorded[(i, rec.row)] = rec.path(self.outputs[-1]["tokens"])
            i += 1
            wall = time.perf_counter() - t0
            ends.append(wall)
            if wall >= seconds:
                break
        b = self.mix["batch"]
        return {"calls": i, "wall_s": wall, "attempted": i * b,
                "call_s": np.diff([0.0] + ends).tolist(),
                "audio_s": i * b * self.n / 16000.0,
                "k1_launches": fused_layer_step.launches - launches0}

    def end_to_end(self, stats: Dict) -> Dict[str, float]:
        return {self.metric: stats["audio_s"] / stats["wall_s"]}

    def traced(self) -> int:
        """The profiled stretch: `trace_calls` calls, with host ranges."""
        k = self.mix["trace_calls"]
        spans: Dict[str, List[float]] = {}
        for i in range(k):
            self.call(i, spans)
        return k

    def failed(self) -> int:
        """Windows whose output is malformed: a row of another length, a
        token outside the vocabulary, a score that is not finite."""
        want = 1 + self.mix["max_new_tokens"]
        bad = 0
        for o in self.outputs:
            t = o["tokens"]
            row_bad = (o["lengths"] != want) | ~torch.isfinite(o["scores"]) \
                | (t < 0).any(dim=1) | (t >= self.shape.num_tokens).any(dim=1)
            bad += int(row_bad.sum())
        return bad

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.outputs = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in o.items()}
                        for o in self.outputs]
        del self.generate, self.decoder, self.model, self.recorders
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def sample(self) -> List[tuple]:
        """(call, row) pairs drawn from the seed: one row from each of
        `check_rows` equal strata of the batch, each from another of the
        window's first `check_calls` calls, so that every drawn call records
        as much."""
        rng = np.random.default_rng([self.seed, 2])
        b, r, c = self.mix["batch"], self.mix["check_rows"], self.mix["check_calls"]
        if r > c:
            raise ValueError(f"check_rows {r} > check_calls {c}: one row is checked a call")
        calls = rng.permutation(c)[:r]
        return [(int(calls[s]), int(rng.integers(s * b // r, (s + 1) * b // r)))
                for s in range(r)]

    def check(self, control: bool = False, detail: bool = False) -> Dict:
        """The check's numbers (see the module's notes). With `control`, the
        reference in fp8 takes the program's place: its own logits at the
        served rows' positions, the token it puts `beam`-th there, and its
        score of the served tokens."""
        cfg, dev = self.config, self.device
        dtype = getattr(torch, cfg["compute_dtype"])
        w = {k: v.to(dtype).to(torch.float32) for k, v in
             build.draw_weights(self.names, self.seed, dev, cfg["embed_size"]).items()}
        feats = {}
        token_gap = score_gap = logit_err = 0.0
        f32, low = reference.Precision("float32"), reference.Precision("fp8")
        k = self.mix["beam"]
        rows, missing = [], 0
        with torch.no_grad(), reference.exact():
            for call, row in self.picks:
                if call >= len(self.outputs) or (call, row) not in self.recorded:
                    missing += 1                   # a drawn call the window never made
                    continue
                o = self.outputs[call]
                if o["pool"] not in feats:
                    feats[o["pool"]] = reference.features(self.pool[o["pool"]], self.lens)
                toks = o["tokens"][row:row + 1].to(dev)
                x = feats[o["pool"]][row:row + 1]
                mem = self._memory(w, x, f32)
                ref = self._decode(w, mem, toks[:, :-1], f32)[0]            # [L, V]
                served = toks[0, 1:]
                ref_lp = torch.log_softmax(ref, -1).gather(-1, served[:, None])[:, 0]
                spread = (ref - ref.mean(-1, keepdim=True)).norm(dim=-1)
                kth = ref.topk(k, dim=-1).values[:, -1]
                if control:
                    side = self._decode(w, self._memory(w, x, low), toks[:, :-1], low)[0]
                    kept = side.topk(k, dim=-1).indices[:, -1]
                    other = torch.log_softmax(side, -1).gather(-1, served[:, None])[:, 0]
                    score = (other.sum() - ref_lp.sum()).abs()
                else:
                    side = self.recorded[(call, row)]
                    kept = served
                    row_len = served.shape[0] + 1
                    score = (float(o["scores"][row]) * row_len - ref_lp.sum()).abs()
                gap = (kth - ref.gather(-1, kept[:, None])[:, 0]).clamp(min=0).max()
                err = math.inf if side is None else \
                    float(((side.to(dev) - ref).norm(dim=-1) / spread).mean())
                token_gap = max(token_gap, float(gap))
                score_gap = max(score_gap, float(score))
                logit_err = max(logit_err, err)
                rows.append([call, row, float(gap), float(score), err, float(ref_lp.sum())])
        if missing == len(self.picks):
            score_gap = logit_err = math.inf          # nothing was left to compare
        out = {"score_gap": score_gap, "logit_err": logit_err, "token_gap": token_gap}
        if detail:
            out["detail"] = {"rows": rows, "missing": missing}
        return out

    def _memory(self, w, feats, prec) -> torch.Tensor:
        cfg = self.config
        return reference.encode(w, feats, cfg["tds_depths"], cfg["n_mels"], prec,
                                reference.Drops())

    def _decode(self, w, mem, prefixes, prec) -> torch.Tensor:
        """Logits [n, t, V] of `prefixes` [n, t] over one window's memory."""
        n = prefixes.shape[0]
        mask = reference.padding_mask(self.lens[:1], self.n, mem.shape[1]).expand(n, -1)
        return reference.decoder_logits(w, prefixes, mem.expand(n, -1, -1), mask,
                                        self.shape.n_decoder_layers, self.config["n_head"],
                                        prec, reference.Drops())
