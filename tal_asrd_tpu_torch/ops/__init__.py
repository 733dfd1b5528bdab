from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram, mel_filterbank, num_frames
from tal_asrd_tpu_torch.ops.specaug import spec_augment
from tal_asrd_tpu_torch.ops.ngram import ngram_repeat_mask

__all__ = [
    "log_mel_spectrogram",
    "mel_filterbank",
    "num_frames",
    "spec_augment",
    "ngram_repeat_mask",
]
