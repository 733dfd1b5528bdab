from tal_asrd_tpu_torch.eval.editdist import eval_distance, opcodes
from tal_asrd_tpu_torch.eval.wder import (
    calculate_wder,
    calculate_wer,
    compute_sequence_match,
    convert_to_wder_format,
    corpus_wder,
    wder_segment,
)
from tal_asrd_tpu_torch.eval.clustering import (
    cluster_embeddings,
    cosine_distance,
    cosine_distance_matrix,
    cosine_similarity,
    inverse_dot_product,
    make_cluster_fn,
    neg_dot_product,
)
from tal_asrd_tpu_torch.eval.convert import convert_results, score_test_result
from tal_asrd_tpu_torch.eval.gen_embed import generate_speaker_embeddings, save_split
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.eval.wder_search import (
    corpus_wder_map,
    default_param_grid,
    get_wder,
    get_wder_edits,
    get_word_speakers,
    wder_segment_grid,
)
from tal_asrd_tpu_torch.eval.tools import (
    apply_role_names,
    eval_transcripts,
    export_tsne,
    merge_outputs,
    prune_bad_utterances,
    splice_at_eot,
    strip_output,
)

__all__ = [
    "eval_distance",
    "opcodes",
    "calculate_wder",
    "calculate_wer",
    "compute_sequence_match",
    "convert_to_wder_format",
    "corpus_wder",
    "wder_segment",
    "cluster_embeddings",
    "cosine_distance",
    "cosine_distance_matrix",
    "cosine_similarity",
    "inverse_dot_product",
    "make_cluster_fn",
    "neg_dot_product",
    "convert_results",
    "score_test_result",
    "generate_speaker_embeddings",
    "save_split",
    "EvalRunner",
    "corpus_wder_map",
    "default_param_grid",
    "get_wder",
    "get_wder_edits",
    "get_word_speakers",
    "wder_segment_grid",
    "apply_role_names",
    "eval_transcripts",
    "export_tsne",
    "merge_outputs",
    "prune_bad_utterances",
    "splice_at_eot",
    "strip_output",
]
