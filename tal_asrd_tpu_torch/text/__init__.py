from tal_asrd_tpu_torch.text.tokenizer import Tokenizer
from tal_asrd_tpu_torch.text.bpe import BpeModel, BpeTokenizer, BpeTrainer
from tal_asrd_tpu_torch.text.spm_import import load_sentencepiece_model

__all__ = [
    "Tokenizer",
    "BpeModel",
    "BpeTokenizer",
    "BpeTrainer",
    "load_sentencepiece_model",
]
