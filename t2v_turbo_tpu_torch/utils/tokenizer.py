"""CLIP BPE tokenizer on the standard library's `re`.

Port of t2v_turbo_tpu/utils/tokenizer.py, which needs the third-party `regex`
package for `\\p{L}` / `\\p{N}`. Here the pre-tokenising pattern is written
with stdlib classes:

  [\\p{L}]+          -> [^\\W\\d_]+          word characters minus digits and "_"
  [\\p{N}]           -> \\d                  one decimal digit
  [^\\s\\p{L}\\p{N}]+  -> (?:[^\\s\\w]|_)+     anything else but whitespace

They agree on letters of every script (accented Latin included) and on
decimal digits. They differ on numbers that are not decimal digits
(Unicode No/Nl, e.g. superscripts "²", fractions "½", Roman numerals "Ⅻ"):
`regex` splits each into its own \\p{N} token, stdlib `\\w` counts them as
word characters and joins them to the letters around them.

The merges vocabulary is the JAX package's asset
`t2v_turbo_tpu/assets/bpe_simple_vocab_16e6.txt.gz` (read as a file; the
JAX package is not imported).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "t2v_turbo_tpu", "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


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
        for tok in PATTERN.findall(_clean(text)):
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
