"""CLIP byte-level BPE tokenizer (the port's own copy, stdlib and numpy only).

Same vocabulary and output as ``fairfedmed_tpu/models/tokenizer.py`` (and the
reference clip/simple_tokenizer.py): OpenAI's 16e6 merge table, bundled under
``assets/``, and a 77-token context with SOT/EOT markers.  The JAX package
splits words with the third-party ``regex`` module (``\\p{L}``/``\\p{N}``
classes); this copy walks the text with ``unicodedata`` categories instead,
which gives the same pieces, so it needs nothing beyond the standard library.
"""

from __future__ import annotations

import codecs
import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List, Union

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
DEFAULT_BPE_PATH = os.path.join(_ASSET_DIR, "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2 convention)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapped = keep[:]
    offset = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            mapped.append(256 + offset)
            offset += 1
    return dict(zip(keep, (chr(c) for c in mapped)))


def _symbol_pairs(word: tuple) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


# --- ftfy.fix_text subset (reference: clip/simple_tokenizer.py:50-53) -----
_TERMINAL_ESCAPES = re.compile(r"\x1b\[((?:\d|;)*)([a-zA-Z])")
_SINGLE_QUOTES = re.compile("[\u2018-\u201b]")
_DOUBLE_QUOTES = re.compile("[\u201c-\u201f]")
_LINE_BREAKS = re.compile("\r\n|[\r\x0b\x0c\x85\u2028\u2029]")
_CONTROL_CHARS = re.compile(r"[\x00-\x08\x0e-\x1f\x7f]")
_SURROGATES = re.compile("[\ud800-\udbff][\udc00-\udfff]|[\ud800-\udfff]")
_LIGATURES = {ord("Ĳ"): "IJ", ord("ĳ"): "ij", ord("ﬀ"): "ff", ord("ﬁ"): "fi",
              ord("ﬂ"): "fl", ord("ﬃ"): "ffi", ord("ﬄ"): "ffl",
              ord("ﬅ"): "ſt", ord("ﬆ"): "st"}


@functools.lru_cache()
def _width_map() -> dict:
    """Full/half-width -> canonical forms (ftfy fix_character_width)."""
    table = {}
    for cp in range(0xFF01, 0xFFEF):
        ch = chr(cp)
        if unicodedata.east_asian_width(ch) in ("F", "H"):
            norm = unicodedata.normalize("NFKC", ch)
            if norm != ch:
                table[cp] = norm
    return table


def _non_ascii_count(text: str) -> int:
    return sum(1 for ch in text if ord(ch) > 0x7F)


def _sloppy_cp1252_errors(exc):
    """The five bytes cp1252 leaves undefined round-trip through the C1
    controls with the same code points (ftfy's "sloppy-windows-1252")."""
    obj = exc.object[exc.start:exc.end]
    if isinstance(obj, str) and all(ch in "\x81\x8d\x8f\x90\x9d" for ch in obj):
        return bytes(ord(c) for c in obj), exc.end
    raise exc


codecs.register_error("ffm_torch_sloppy_cp1252", _sloppy_cp1252_errors)


def _fix_mojibake(text: str, max_passes: int = 3) -> str:
    """UTF-8-read-as-cp1252/latin-1 repair, accepted only when the byte
    round trip is exact and the non-ASCII count strictly drops."""
    for _ in range(max_passes):
        repaired = None
        for enc in ("windows-1252", "latin-1"):
            try:
                candidate = text.encode(enc, "ffm_torch_sloppy_cp1252").decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
            if candidate != text and _non_ascii_count(candidate) < _non_ascii_count(text):
                repaired = candidate
                break
        if repaired is None:
            return text
        text = repaired
    return text


def fix_text_lite(text: str) -> str:
    """Deterministic subset of ``ftfy.fix_text`` in ftfy's pipeline order;
    identity on printable-ASCII text without HTML entities."""
    if "<" not in text:
        text = html.unescape(text)
    text = _TERMINAL_ESCAPES.sub("", text)
    if not text.isascii():
        text = _fix_mojibake(text)
        text = text.translate(_LIGATURES)
        text = text.translate(_width_map())
        text = _SINGLE_QUOTES.sub("'", text)
        text = _DOUBLE_QUOTES.sub('"', text)
        text = _SURROGATES.sub(
            lambda m: (chr(0x10000 + (ord(m.group(0)[0]) - 0xD800) * 0x400
                           + (ord(m.group(0)[1]) - 0xDC00))
                       if len(m.group(0)) == 2 else "�"), text)
    text = _LINE_BREAKS.sub("\n", text)
    text = _CONTROL_CHARS.sub("", text)
    if not text.isascii():
        text = unicodedata.normalize("NFC", text)
    return text


def _clean_text(text: str) -> str:
    text = fix_text_lite(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _kind(ch: str) -> str:
    cat = unicodedata.category(ch)[0]
    if cat in ("L", "N"):
        return cat
    return "S" if ch.isspace() else "O"


def split_words(text: str) -> List[str]:
    """The pieces CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|
    've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` finds, left to right,
    on lower-cased text."""
    out, i, n = [], 0, len(text)
    while i < n:
        special = next((t for t in (SOT_TOKEN, EOT_TOKEN, *_CONTRACTIONS)
                        if text.startswith(t, i)), None)
        if special is not None:
            out.append(special)
            i += len(special)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and other symbols run; a number is one char
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """Byte-level BPE with the OpenAI CLIP merge table (49,408 entries)."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # the reference's slice: skip the header, keep 49152 - 256 - 2 + 1 rules
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        vocab = list(self.byte_encoder.values())
        vocab += [tok + "</w>" for tok in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _symbol_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _symbol_pairs(word)

        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in split_words(_clean_text(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer(bpe_path: str = DEFAULT_BPE_PATH) -> SimpleTokenizer:
    return SimpleTokenizer(bpe_path)


def tokenize(texts: Union[str, List[str]], context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize into a ``[len(texts), context_length]`` int32 array (SOT +
    tokens + EOT, zero padded)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.encoder[SOT_TOKEN], tok.encoder[EOT_TOKEN]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + tok.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {texts[i]!r} is too long for context length "
                                   f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out
