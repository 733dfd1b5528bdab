from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search, make_generate_fn
from tal_asrd_tpu_torch.decode.unaligned import (
    UnalignedSpec,
    unaligned_decode,
    unaligned_decode_batched,
)
from tal_asrd_tpu_torch.decode.transcribe import (
    TranscribeConfig,
    Transcriber,
    splice_strings,
)
from tal_asrd_tpu_torch.decode.reference_mode import greedy_noncausal
from tal_asrd_tpu_torch.decode.sharded import make_sharded_decode, make_sharded_unaligned

__all__ = [
    "BeamSearchSpec",
    "beam_search",
    "make_generate_fn",
    "UnalignedSpec",
    "unaligned_decode",
    "unaligned_decode_batched",
    "TranscribeConfig",
    "Transcriber",
    "splice_strings",
    "greedy_noncausal",
    "make_sharded_decode",
    "make_sharded_unaligned",
]
