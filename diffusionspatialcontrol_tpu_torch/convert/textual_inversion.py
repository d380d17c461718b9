"""Textual-inversion embeddings (port of ``convert/textual_inversion.py``).

The reference's TI loader (source/app.py:499-520 setup_tokenizer, :759-785
add_embedding): each embedding file contributes N vectors; the trigger word
is rewritten in prompts to N synthetic tokens ``<emb-{name}-{i}>`` whose
ids map to rows of the CLIP token-embedding table past the vocabulary
(``convert_clip(n_extra_tokens=...)`` leaves zero rows there).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from .safetensors import load_file


def load_embedding_file(path: str) -> Dict[str, np.ndarray]:
    """{name: (N, dim) fp32 array}, from a ``.safetensors`` file or an A1111
    ``.pt`` (``string_to_param``)."""
    if path.endswith(".safetensors"):
        return {k: v.float().numpy() for k, v in load_file(path).items()}
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if "string_to_param" in loaded:
        loaded = loaded["string_to_param"]["*"]
    if hasattr(loaded, "numpy"):
        return {"*": loaded.float().numpy()}
    return {k: v.float().numpy() for k, v in loaded.items()}


class EmbeddingTokenizer:
    """Wraps a tokenizer; rewrites registered trigger words into their
    synthetic token sequences before encoding (the reference's
    prepare_for_tokenization patch, app.py:506-519)."""

    def __init__(self, base):
        self.base = base
        self._patterns: List = []  # (compiled regex, replacement ids)
        self._extra_ids: Dict[str, int] = {}
        self.next_id = getattr(base, "vocab_size", 49408)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def register(self, name: str, n_vectors: int) -> List[int]:
        ids = list(range(self.next_id, self.next_id + n_vectors))
        self.next_id += n_vectors
        self._patterns.append(
            (re.compile(rf"(?:^|(?<=\s|,)){re.escape(name)}(?=,|\s|$)"),
             ids))
        for i, tid in enumerate(ids):
            self._extra_ids[f"<emb-{name}-{i}>"] = tid
        return ids

    def tokenize_to_ids(self, text: str) -> List[int]:
        # split on registered triggers, encode plain spans with the base
        spans = [(text, None)]
        for pat, ids in self._patterns:
            new_spans = []
            for s, sid in spans:
                if sid is not None:
                    new_spans.append((s, sid))
                    continue
                pos = 0
                for m in pat.finditer(s):
                    if m.start() > pos:
                        new_spans.append((s[pos:m.start()], None))
                    new_spans.append(("", ids))
                    pos = m.end()
                if pos < len(s):
                    new_spans.append((s[pos:], None))
            spans = new_spans
        out: List[int] = []
        for s, sid in spans:
            if sid is not None:
                out.extend(sid)
            elif s.strip():
                out.extend(self.base.tokenize_to_ids(s))
        return out

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False, max_length=None) -> List[int]:
        ids = self.tokenize_to_ids(text)
        if add_special_tokens:
            ids = [self.base.bos_token_id] + ids + [self.base.eos_token_id]
        if truncation:
            ids = ids[: max_length or self.base.model_max_length]
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


def add_embeddings(clip_params: Dict[str, Any], tokenizer,
                   embeddings: Dict[str, np.ndarray], vocab_size: int
                   ) -> "tuple[Dict[str, Any], EmbeddingTokenizer]":
    """(new clip params, wrapping tokenizer) with the TI vectors
    (``embeddings``: name -> (N, dim)) in a copy of the token-embedding
    table; the given params and their table stay as they were."""
    wrapped = (
        tokenizer
        if isinstance(tokenizer, EmbeddingTokenizer)
        else EmbeddingTokenizer(tokenizer)
    )
    wrapped.next_id = max(wrapped.next_id, vocab_size)

    table = clip_params["token_embedding"].clone()
    for name, vecs in embeddings.items():
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        ids = wrapped.register(name, vecs.shape[0])
        if ids[-1] >= table.shape[0]:
            raise ValueError(
                f"embedding table too small ({table.shape[0]}) for TI ids up"
                f" to {ids[-1]}; reconvert with larger n_extra_tokens"
            )
        table[ids] = torch.from_numpy(vecs).to(table.dtype).to(table.device)
    clip_params = dict(clip_params)
    clip_params["token_embedding"] = table
    return clip_params, wrapped
