"""PyTorch / CUDA port of the tal_asrd_tpu joint ASR + diarization framework.

The JAX package `tal_asrd_tpu` is the reference; this package mirrors its
sub-package names (core, ops, models, decode, train, eval, data, text, cli,
utils) so the counterpart of a module is found under the same path. It
imports torch, numpy and scipy only.

Ported so far: the serving path (log-mel frontend, TDS encoder, ReZero
decoder, fused decode steps, beam search), the training path (ASRSystem,
LAMB, Trainer, checkpoints), and the aligned evaluation (tokenizer, data
pipeline, EvalRunner, WER / WDER, `python -m tal_asrd_tpu_torch.cli.test`),
with four hand-written CUDA kernels (ops/cuda_*.py; sources in csrc/).
Every entry point takes `device`, which defaults to "cuda".
"""

__version__ = "0.1.0"
