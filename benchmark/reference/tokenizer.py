"""CLIP's byte-level BPE tokenizer for the plain reference.

A frozen copy of ``fairfedmed_tpu_torch/models/tokenizer.py`` (itself
OpenAI's ``clip/simple_tokenizer.py``), cut to what the reference needs:
ASCII prompts, so the ftfy-style text repair is left out and non-ASCII input
raises.  The merge table beside this file is a copy of OpenAI's
``bpe_simple_vocab_16e6.txt.gz``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List

import numpy as np

BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")
SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CONTEXT_LENGTH = 77
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2 convention)."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    mapped, offset = keep[:], 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            mapped.append(256 + offset)
            offset += 1
    return dict(zip(keep, (chr(c) for c in mapped)))


def _kind(ch: str) -> str:
    cat = unicodedata.category(ch)[0]
    if cat in ("L", "N"):
        return cat
    return "S" if ch.isspace() else "O"


def _split_words(text: str) -> List[str]:
    """The pieces of CLIP's word pattern, left to right."""
    out, i, n = [], 0, len(text)
    while i < n:
        special = next((t for t in (SOT, EOT, *_CONTRACTIONS) if text.startswith(t, i)), None)
        if special is not None:
            out.append(special)
            i += len(special)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class Tokenizer:
    def __init__(self, bpe_path: str = BPE_PATH):
        self.byte_encoder = _byte_unicode_table()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [tok + "</w>" for tok in vocab]
        vocab += ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}

    def _bpe(self, token: str) -> List[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return list(word)

    def encode(self, text: str) -> List[int]:
        if not text.isascii():
            raise ValueError(f"the reference tokenizer takes ASCII text, got {text!r}")
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
        ids = []
        for piece in _split_words(text):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(piece))
        return ids


@functools.lru_cache()
def get_tokenizer() -> Tokenizer:
    return Tokenizer()


def tokenize(texts: List[str]) -> np.ndarray:
    """``[len(texts), 77]`` int64: SOT, the tokens, EOT, zeros."""
    tok = get_tokenizer()
    out = np.zeros((len(texts), CONTEXT_LENGTH), dtype=np.int64)
    for i, text in enumerate(texts):
        ids = [tok.encoder[SOT]] + tok.encode(text) + [tok.encoder[EOT]]
        out[i, :len(ids)] = ids
    return out
