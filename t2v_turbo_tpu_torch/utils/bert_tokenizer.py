"""Self-contained BERT wordpiece tokenizer (a copy of
t2v_turbo_tpu/utils/bert_tokenizer.py, which imports nothing of JAX; the
port keeps its own copy rather than importing the JAX package).

Serves the med-BERT text towers (ImageReward's BLIP text encoder and
InternVideo2's BERT-large — the reference loads HF BertTokenizer for these).
Takes a standard `vocab.txt` (one token per line); path via argument or the
T2V_TPU_BERT_VOCAB env var. Implements the bert-base-uncased pipeline:
lowercase + accent strip, punctuation split, CJK spacing, greedy
longest-match wordpiece with '##' continuations, [CLS] ... [SEP] framing and
zero ([PAD]) padding.
"""

from __future__ import annotations

import os
import unicodedata
from typing import List, Optional, Sequence

import numpy as np


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x20000 <= cp <= 0x2A6DF
    )


class BertWordPieceTokenizer:
    def __init__(
        self,
        vocab_path: Optional[str] = None,
        max_length: int = 40,  # reference max_txt_l for InternVideo2
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        vocab_path = vocab_path or os.environ.get("T2V_TPU_BERT_VOCAB")
        if not vocab_path or not os.path.exists(vocab_path):
            raise FileNotFoundError(
                "BERT vocab.txt not found; pass vocab_path or set "
                "T2V_TPU_BERT_VOCAB"
            )
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(tokens)}
        self.max_length = max_length
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get("[UNK]", 100)

    # ------------------------------------------------------------------
    def _basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
                continue
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punct(ch) or _is_cjk(cp):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    # ------------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts: str | Sequence[str]):
        """-> (ids (B, max_length) int32, attention_mask (B, max_length))."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.cls_id] + self.encode(t)[: self.max_length - 2] + [self.sep_id]
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return out, mask
