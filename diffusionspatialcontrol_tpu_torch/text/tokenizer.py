"""Self-contained CLIP BPE tokenizer (no transformers dependency at runtime).

Loads the standard ``vocab.json`` + ``merges.txt`` files shipped with every SD
checkpoint's tokenizer directory. Implements the CLIP variant of byte-level
BPE: lowercasing, whitespace collapse, the end-of-word ``</w>`` marker, and
``<|startoftext|>`` / ``<|endoftext|>`` specials.

For environments without vocab files (unit tests, offline CI) a deterministic
``HashTokenizer`` provides the same interface; region-map token matching and
prompt chunking only require *consistent* ids, not CLIP's exact vocabulary.

A copy of ``diffusionspatialcontrol_tpu/text/tokenizer.py``: that module is
pure Python, but importing it runs the JAX package's ``__init__``, which
loads JAX. Its ids must stay identical to the JAX package's, because region
matching runs on them (tests/test_torch_pipeline.py holds them equal).
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

# CLIP's original pattern uses \p{L}/\p{N}; Python's re has no \p classes, so
# use a close ASCII+Latin-supplement approximation (identical behavior on
# typical English SD prompts).
_WORD_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-ZÀ-￿]+|[0-9]|[^\sa-zA-Z0-9À-￿]+"
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
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


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    """CLIP byte-level BPE. Interface mirrors the small subset of the HF
    tokenizer the reference touches: ``encode``, ``__call__`` with truncation,
    ``model_max_length``, ``bos/eos_token_id``, ``decode``."""

    model_max_length = 77

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = vocab.get("<|startoftext|>", 49406)
        self.eos_token_id = vocab.get("<|endoftext|>", 49407)
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, str] = {}
        # A1111 comma token for chunk backtracking (prompt_parser.py:233).
        self.comma_token_id = vocab.get(",</w>")

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """Load from a directory containing vocab.json + merges.txt (the
        layout of every HF SD checkpoint's ``tokenizer/`` folder)."""
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f.read().split("\n"):
                if line.startswith("#version") or not line.strip():
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word) if len(word) > 1 else set()
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
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
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize_to_ids(self, text: str) -> List[int]:
        text = _basic_clean(text).lower()
        ids: List[int] = []
        for tok in _WORD_PAT.findall(text):
            tok_bytes = "".join(
                self.byte_encoder[b] for b in tok.encode("utf-8")
            )
            for bpe_tok in self.bpe(tok_bytes).split(" "):
                ids.append(self.encoder[bpe_tok])
        return ids

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        ids = self.tokenize_to_ids(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if truncation:
            ids = ids[: max_length or self.model_max_length]
        return ids

    def __call__(self, text, max_length=None, truncation=False,
                 add_special_tokens=True, padding=False):
        class _Out:
            pass

        out = _Out()
        out.input_ids = self.encode(
            text, add_special_tokens=add_special_tokens,
            truncation=truncation, max_length=max_length,
        )
        if padding == "max_length" and max_length:
            out.input_ids = out.input_ids + [self.pad_token_id] * (
                max_length - len(out.input_ids)
            )
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        byts = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        )
        return byts.decode("utf-8", errors="replace").replace("</w>", " ")


class HashTokenizer:
    """Deterministic fallback tokenizer for tests/offline runs: each
    whitespace word maps to a stable id via FNV-1a. Multi-word phrases map to
    the concatenation of word ids, so n-gram region matching behaves exactly
    as with real BPE ids."""

    model_max_length = 77
    bos_token_id = 49406
    eos_token_id = 49407
    pad_token_id = 49407
    comma_token_id = 264

    def tokenize_to_ids(self, text: str) -> List[int]:
        ids = []
        for word in _basic_clean(text).lower().split(" "):
            if not word:
                continue
            # split trailing commas into their own token, like BPE would
            n_commas = 0
            while word.endswith(","):
                word = word[:-1]
                n_commas += 1
            if word:
                h = 2166136261
                for ch in word.encode("utf-8"):
                    h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
                ids.append(int(h % 49000))
            ids.extend([self.comma_token_id] * n_commas)
        return ids

    def encode(self, text, add_special_tokens=True, truncation=False,
               max_length=None):
        ids = self.tokenize_to_ids(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if truncation:
            ids = ids[: max_length or self.model_max_length]
        return ids

    def __call__(self, text, max_length=None, truncation=False,
                 add_special_tokens=True, padding=False):
        class _Out:
            pass

        out = _Out()
        out.input_ids = self.encode(
            text, add_special_tokens=add_special_tokens,
            truncation=truncation, max_length=max_length,
        )
        return out


def load_tokenizer(path: Optional[str] = None):
    if path and os.path.exists(os.path.join(path, "vocab.json")):
        return CLIPTokenizer.from_pretrained(path)
    return HashTokenizer()
