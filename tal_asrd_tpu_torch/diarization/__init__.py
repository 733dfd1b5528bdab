"""Diarization (counterpart of tal_asrd_tpu/diarization): UIS-RNN with its
GRU, its evaluation and experiment runners, and the wav2vec-style feature
extractor."""
from tal_asrd_tpu_torch.diarization.uisrnn import (
    UISRNN,
    UISRNNConfig,
    UISRNNInferenceConfig,
    UISRNNTrainConfig,
    estimate_transition_bias,
    resize_sequence,
)
from tal_asrd_tpu_torch.diarization.evals import diarization_error_rate, evaluate_result
from tal_asrd_tpu_torch.diarization.gru import GRU, GRUCell
from tal_asrd_tpu_torch.diarization.wav2vec import (
    ConvAggregator,
    ConvFeatureExtractor,
    Wav2VecFeatures,
    extract_corpus_features,
    extract_utterance_features,
    init_wav2vec,
)
from tal_asrd_tpu_torch.diarization.experiment import kfold_experiment, streaming_fit

__all__ = [
    "UISRNN",
    "UISRNNConfig",
    "UISRNNInferenceConfig",
    "UISRNNTrainConfig",
    "estimate_transition_bias",
    "resize_sequence",
    "diarization_error_rate",
    "evaluate_result",
    "GRU",
    "GRUCell",
    "ConvAggregator",
    "ConvFeatureExtractor",
    "Wav2VecFeatures",
    "extract_corpus_features",
    "extract_utterance_features",
    "init_wav2vec",
    "kfold_experiment",
    "streaming_fit",
]
