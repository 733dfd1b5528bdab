"""Host-side word tokenizers for evaluation.

Counterpart of tal_asrd_tpu/utils/wordtok.py: self-contained regex
approximations of nltk's punkt `word_tokenize` and `TweetTokenizer` (nltk is
not a dependency), splitting words from punctuation and keeping
contractions whole, plus the punctuation re-attachment of word-aligned
truncation.
"""
from __future__ import annotations

import re
from typing import List

# Words (apostrophe contractions included), numbers, or single non-space
# symbols. The punkt approximation uses the same pattern.
_TWEET_RE = re.compile(r"[A-Za-z]+(?:['’][A-Za-z]+)*|\d+(?:[.,]\d+)*|\S")
_WORD_RE = _TWEET_RE

PUNCTUATOR = re.compile(r"\s+([?.,!'])")


def tweet_tokenize(text: str) -> List[str]:
    return _TWEET_RE.findall(text)


def word_tokenize(text: str) -> List[str]:
    """Approximation of nltk punkt word_tokenize sufficient for WER/WDER
    scoring: separates punctuation from words; contractions kept whole."""
    return _WORD_RE.findall(text)


def detokenize(words: List[str]) -> str:
    """Join words re-attaching punctuation (PUNCTUATOR semantics)."""
    return PUNCTUATOR.sub(r"\1", " ".join(words))
