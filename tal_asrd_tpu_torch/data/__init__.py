from tal_asrd_tpu_torch.data.audio_io import (
    DEFAULT_SR,
    get_audio_info,
    get_duration,
    load_audio_segment,
    resample,
    write_wav,
)
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.segment import SegmentDataset
from tal_asrd_tpu_torch.data.audio import RandomSegmentDataset
from tal_asrd_tpu_torch.data.baseline_speaker import SDUtteranceDataset
from tal_asrd_tpu_torch.data.collate import BucketedCollater, SDCollater, pick_bucket
from tal_asrd_tpu_torch.data.loader import DataLoader, DevicePrefetcher, ShardedSampler
from tal_asrd_tpu_torch.data.format import tokenize_utterances, tokenize_utterances_word_align
from tal_asrd_tpu_torch.data.transcript import (
    SpeakerIds,
    build_episode_durations,
    build_index,
    is_valid_segment,
    is_valid_utterance,
    load_speaker_map,
    load_transcripts,
)

__all__ = [
    "DEFAULT_SR",
    "AlignedDataset",
    "SegmentDataset",
    "RandomSegmentDataset",
    "SDUtteranceDataset",
    "BucketedCollater",
    "SDCollater",
    "pick_bucket",
    "DataLoader",
    "DevicePrefetcher",
    "ShardedSampler",
    "tokenize_utterances",
    "tokenize_utterances_word_align",
    "SpeakerIds",
    "build_episode_durations",
    "build_index",
    "is_valid_segment",
    "is_valid_utterance",
    "load_speaker_map",
    "load_transcripts",
    "get_audio_info",
    "get_duration",
    "load_audio_segment",
    "resample",
    "write_wav",
]
