from tal_asrd_tpu_torch.eval.editdist import eval_distance, opcodes
from tal_asrd_tpu_torch.eval.wder import (
    calculate_wder,
    compute_sequence_match,
    convert_to_wder_format,
    corpus_wder,
    wder_segment,
)
from tal_asrd_tpu_torch.eval.convert import convert_results, score_test_result
from tal_asrd_tpu_torch.eval.gen_embed import generate_speaker_embeddings, save_split
from tal_asrd_tpu_torch.eval.runner import EvalRunner

__all__ = [
    "eval_distance",
    "opcodes",
    "calculate_wder",
    "compute_sequence_match",
    "convert_to_wder_format",
    "corpus_wder",
    "wder_segment",
    "convert_results",
    "score_test_result",
    "generate_speaker_embeddings",
    "save_split",
    "EvalRunner",
]
