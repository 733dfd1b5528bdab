"""PyTorch / CUDA port of the tal_asrd_tpu joint ASR + diarization framework.

The JAX package `tal_asrd_tpu` is the reference; this package mirrors its
sub-package names (core, ops, models, decode) so the counterpart of a module
is found under the same path. It imports torch and numpy only.

Ported so far: the serving path — log-mel frontend, TDS encoder, ReZero
decoder, fused per-layer decode step, beam search — with two hand-written
CUDA kernels (ops/cuda_kernels.py, ops/cuda_decode.py; sources in csrc/).
Every entry point takes `device`, which defaults to "cuda".
"""

__version__ = "0.1.0"
