"""Command-line entry points (python -m tal_asrd_tpu_torch.cli.<name>), each
the counterpart of tal_asrd_tpu.cli.<name> with the same flags plus
--device (default cuda):

  train        — ASR training
  test         — aligned / unaligned evaluation
  transcribe   — windowed long-audio transcription
  gen_embed    — speaker-embedding export
  train_embed  — contrastive metric head
  train_lm     — shallow-fusion LM training
  wder         — WER / WDER scoring, with clustering of the embeddings
  wder_search  — clustering grid search
  vad          — batch VAD + eval
  tools        — tokenizer training, audio conversion / chunking, checkpoint
                 averaging, speaker expansion, output merging, LibriSpeech
                 and wder-ready formats, the synthetic corpus

Not ported yet: uisrnn (ROADMAP A17).
"""
