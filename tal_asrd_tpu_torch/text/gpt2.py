"""GPT-2 (HuggingFace) tokenizer backend.

Counterpart of tal_asrd_tpu/text/gpt2.py: the reference's GPT-2 tokenizer
variant for LM-pretrained decoders, with bos = eot = 49129 (the reference
reuses one high id for both). It is built from a local pretrained
directory (vocab.json, merges.txt), never fetched. `transformers` is
imported when a tokenizer is built, not with this module: an installed
`transformers` can pull in JAX or flax, which the port never imports
otherwise.
"""
from __future__ import annotations

from typing import List, Sequence

from tal_asrd_tpu_torch.text.tokenizer import Tokenizer


class Gpt2Tokenizer(Tokenizer):
    eot_token_id = 49129
    bos_token_id = 49129

    def __init__(self, pretrained_path: str):
        from transformers import GPT2TokenizerFast  # local files only

        self.tk = GPT2TokenizerFast.from_pretrained(
            pretrained_path, local_files_only=True
        )
        self.pad_token_id = self.tk.pad_token_id or 2
        self.eos_token_id = self.tk.eos_token_id or 1

    def __len__(self) -> int:
        return len(self.tk)

    def _encode(self, sentence: str) -> List[int]:
        return self.tk.encode(sentence, add_special_tokens=False)

    def decode_pieces(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids))
