"""PyTorch / CUDA port of the tal_asrd_tpu joint ASR + diarization framework.

The JAX package `tal_asrd_tpu` is the reference; this package mirrors its
sub-package names (core, ops, models, decode, train, eval, data, text, cli,
utils) so the counterpart of a module is found under the same path. It
imports torch, numpy and scipy only.

Ported so far: the serving path (log-mel frontend, TDS encoder, ReZero
decoder, fused decode steps, beam search), the training path (ASRSystem,
LAMB, Trainer, checkpoints), the aligned and long-form evaluation
(tokenizer, data pipeline, EvalRunner, the state machine, VAD, WER / WDER,
`python -m tal_asrd_tpu_torch.cli.test`), the training CLI, LM shallow
fusion, the separate speaker head, the non-causal reference decode and the
sharded decode, and the speaker-embedding export and metric head
(`cli.gen_embed`, `cli.train_embed`), with four hand-written CUDA kernels
(ops/cuda_*.py; sources in csrc/).
Every entry point takes `device`, which defaults to "cuda".
"""

__version__ = "0.1.0"
