"""PyTorch / CUDA port of the tal_asrd_tpu joint ASR + diarization framework.

The JAX package `tal_asrd_tpu` is the reference; this package mirrors its
sub-package names (core, ops, models, decode, train, eval, data, text, cli,
utils, vad, align, diarization, baseline, parallel) so the counterpart of a module is
found under the same path, and each sub-package exports the JAX one's
names. It imports torch, numpy and scipy only.

Ported so far: the serving path (log-mel frontend, TDS encoder, ReZero
decoder, fused decode steps, beam search), the training path (ASRSystem,
LAMB, Trainer, checkpoints), the aligned and long-form evaluation
(tokenizer, data pipeline, EvalRunner, the state machine, VAD, WER / WDER,
`python -m tal_asrd_tpu_torch.cli.test`), the training CLI, LM shallow
fusion, the separate speaker head, the non-causal reference decode and the
sharded decode, the speaker-embedding export and metric head
(`cli.gen_embed`, `cli.train_embed`), clustering and the WDER tools
(`cli.wder`, `cli.wder_search`), the speaker baseline and neural SAD
(`cli.train_sd`, `cli.sad`), UIS-RNN diarization (`cli.uisrnn`) and forced
alignment, RAdam, Adafactor and Lookahead, and the utilities (`utils.flops`
at the H100's peaks, `utils.profiling` on torch.profiler, the
sentencepiece importer, the GPT-2 tokenizer), and data- and
tensor-parallel training on a torch.distributed mesh (`parallel`,
`cli.train --mesh-data / --mesh-model` under torchrun, the sharded
checkpoint manager), with four hand-written CUDA kernels (ops/cuda_*.py;
sources in csrc/). Every entry point takes `device`, which defaults to
"cuda".
"""

from tal_asrd_tpu_torch.core.utils import (
    count_parameters,
    debug_log,
    set_seed,
    SuppressPrint,
)

__version__ = "0.1.0"

__all__ = [
    "count_parameters",
    "debug_log",
    "set_seed",
    "SuppressPrint",
    "__version__",
]
