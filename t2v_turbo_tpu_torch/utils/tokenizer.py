"""CLIP BPE tokenizer on the standard library (port of
t2v_turbo_tpu/utils/tokenizer.py, which needs the third-party `regex`
package for `\\p{L}` / `\\p{N}`; the card's Python has no `regex`).

The JAX package pre-tokenises with

  <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
  |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+            (case-insensitive)

`_pretokenize` scans the same alternatives in the same order, classing each
character with `unicodedata.category` (L* is \\p{L}, N* is \\p{N}) and
`str.isspace` (\\s), so numbers that are not decimal digits (superscripts,
fractions, Roman numerals) split from the letters they touch, as they do
with `regex`.

The merges vocabulary is the port's own copy of the public
`bpe_simple_vocab_16e6.txt.gz` (the standard OpenAI CLIP vocabulary), in
t2v_turbo_tpu_torch/assets/.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_FIXED = (SOT, EOT, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _class(ch: str) -> str:
    """'L' (\\p{L}), 'N' (\\p{N}), 'S' (\\s) or '' (anything else)."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return "S" if ch.isspace() else ""


def _pretokenize(text: str) -> List[str]:
    """The JAX package's `regex` findall, alternative by alternative."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        fixed = next((f for f in _FIXED if text[i:i + len(f)].lower() == f), None)
        if fixed is not None:
            out.append(text[i:i + len(fixed)])
            i += len(fixed)
            continue
        cls = _class(text[i])
        if cls == "S":  # matched by no alternative: skipped
            i += 1
            continue
        if cls == "N":  # one number character per token
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        if cls == "L":
            while j < n and _class(text[j]) == "L":
                j += 1
        else:
            while j < n and _class(text[j]) == "":
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2 scheme)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    """context_length=77, zero-padded after EOT, as open_clip's `tokenize`."""

    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77):
        path = bpe_path or DEFAULT_BPE_PATH
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _pretokenize(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        """(B, context_length) int32 ids; long prompts are cut with EOT last."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode_text(text) + [self.eot_id]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot_id
            result[i, : len(ids)] = ids
        return result
