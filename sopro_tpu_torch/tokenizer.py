"""Host-side text tokenizers (counterpart: sopro_tpu/tokenizer.py).

`TextTokenizer` is the BPE tokenizer of a checkpoint snapshot (the
Llama-3.2 vocabulary ships inside the Sopro repository), loaded through
`transformers.AutoTokenizer` from the snapshot directory; `transformers` is
imported only when one is built. `SimpleCharTokenizer` needs nothing: byte
ids for random-weight models.
"""

from __future__ import annotations

from typing import List


class TextTokenizer:
    def __init__(self, model_name: str, add_bos_eos: bool = True):
        from transformers import AutoTokenizer
        from transformers import logging as hf_logging

        hf_logging.set_verbosity_error()
        self.tok = AutoTokenizer.from_pretrained(model_name, use_fast=True)
        self.add_bos_eos = add_bos_eos
        if self.tok.pad_token_id is None:  # add <|pad|> where the vocabulary lacks one
            self.tok.add_special_tokens({"pad_token": "<|pad|>"})
        self.pad_id = int(self.tok.pad_token_id)
        self.bos_id = int(self.tok.bos_token_id) if self.tok.bos_token_id is not None else None
        self.eos_id = int(self.tok.eos_token_id) if self.tok.eos_token_id is not None else None
        self.vocab_size = int(self.tok.vocab_size + len(self.tok.get_added_vocab()))

    def encode(self, text: str) -> List[int]:
        """BPE ids, wrapped in BOS / EOS where the vocabulary has both."""
        ids = self.tok.encode(text, add_special_tokens=False)
        if self.add_bos_eos and self.bos_id is not None and self.eos_id is not None:
            ids = [self.bos_id] + ids + [self.eos_id]
        return ids


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
