"""Command-line entry points (python -m tal_asrd_tpu_torch.cli.<name>), each
the counterpart of tal_asrd_tpu.cli.<name> with the same flags plus
--device (default cuda):

  train        — ASR training
  test         — aligned / unaligned evaluation
  transcribe   — windowed long-audio transcription
  gen_embed    — speaker-embedding export
  train_embed  — contrastive metric head
  train_lm     — shallow-fusion LM training
  vad          — batch VAD + eval
  tools        — tokenizer training, audio chunking, checkpoint averaging,
                 speaker expansion, the synthetic corpus

Not ported yet: wder and wder_search (ROADMAP A16.2), uisrnn (A17).
"""
