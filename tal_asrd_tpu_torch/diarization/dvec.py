"""d-vector feature sources (counterpart of tal_asrd_tpu/diarization/dvec.py).

The reference keeps an empty d-vector module: Google's d-vector model is
proprietary, so the d-vectors must come from an external system. Any
[N, D] per-utterance embedding matrix can feed UIS-RNN
(`tal_asrd_tpu_torch.diarization.UISRNN`); the port's own sources are the
wav2vec-style extractor (diarization/wav2vec.py), the SD baseline's frame
embeddings (baseline/sd_system.py) and the joint model's expected speaker
embeddings (eval/gen_embed.py).
"""

DVEC_SOURCES = (
    "tal_asrd_tpu_torch.diarization.wav2vec",
    "tal_asrd_tpu_torch.baseline.sd_system",
    "tal_asrd_tpu_torch.eval.gen_embed",
)
