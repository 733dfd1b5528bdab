from tal_asrd_tpu_torch.utils.logging import MetricsLogger
from tal_asrd_tpu_torch.utils.profiling import StepTimer, sync, trace
from tal_asrd_tpu_torch.utils.wordtok import (
    PUNCTUATOR,
    detokenize,
    tweet_tokenize,
    word_tokenize,
)

__all__ = [
    "MetricsLogger",
    "StepTimer",
    "sync",
    "trace",
    "PUNCTUATOR",
    "detokenize",
    "tweet_tokenize",
    "word_tokenize",
]
