"""Dependency-free text tokenizer (counterpart: sopro_tpu/tokenizer.py
SimpleCharTokenizer). The BPE `TextTokenizer` needs `transformers` and a
checkpoint snapshot, and is not ported yet."""

from __future__ import annotations

from typing import List


class SimpleCharTokenizer:
    """Byte-level ids offset by 3, BOS=1, EOS=2, PAD=0."""

    def __init__(self, add_bos_eos: bool = True):
        self.add_bos_eos = add_bos_eos
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.vocab_size = 256 + 3

    def encode(self, text: str) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if self.add_bos_eos:
            ids = [self.bos_id] + ids + [self.eos_id]
        return ids
