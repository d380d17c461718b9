"""A1111 prompt weighting and long-prompt encoding (port of
``text/prompt_parser.py``).

* ``parse_prompt_attention``: the AUTOMATIC1111 emphasis grammar: (), [],
  (text:w), backslash escapes and BREAK.
* A1111 chunked encoding (``encode_prompt_a1111``): 75-token chunks with a
  comma backtrack of 20 tokens, BREAK starts a new chunk, each chunk wrapped
  in bos/eos and encoded on its own; z *= multiplier, then the mean of the
  whole [uncond, cond] pair is restored (fp32).
* Long-prompt encoding (``encode_prompt_long``): the community lpw
  semantics, weighted tokens over up to 3 chunks of 77, each chunk re-wrapped
  in bos/eos, the mean restored per sample.

Both return ``(context, cond_ids_per_prompt)`` with context stacked
[uncond..., cond...]; the ids (with specials and padding) feed the region
map's n-gram matcher. The grammar and the chunking are pure Python and
reproduce the JAX package's ids and multipliers token for token.

Context length: A1111 gives 77 per chunk (S = 154, 231, 308). Long mode
also gives 77 per chunk, but returns the 75 n + 2 ids of its un-rewrapped
layout (152, 227), as the JAX package does; a region map built from those
ids does not match the context's length, and the pipeline refuses it.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import CLIPTextConfig
from ..models.clip import clip_apply

CHUNK_LEN = 75
COMMA_PADDING_BACKTRACK = 20

re_attention = re.compile(
    r"""
\\\(|
\\\)|
\\\[|
\\]|
\\\\|
\\|
\(|
\[|
:([+-]?[.\d]+)\)|
\)|
]|
[^\\()\[\]:]+|
:
""",
    re.X,
)

re_break = re.compile(r"\s*\bBREAK\b\s*", re.S)


def parse_prompt_attention(text: str) -> List[List]:
    """[[text, weight], ...] for an A1111 prompt; ["BREAK", -1] marks a
    chunk break. Adjacent runs of equal weight are merged."""
    res: List[List] = []
    round_brackets: List[int] = []
    square_brackets: List[int] = []

    round_bracket_multiplier = 1.1
    square_bracket_multiplier = 1 / 1.1

    def multiply_range(start_position, multiplier):
        for p in range(start_position, len(res)):
            res[p][1] *= multiplier

    for m in re_attention.finditer(text):
        tok = m.group(0)
        weight = m.group(1)

        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), round_bracket_multiplier)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), square_bracket_multiplier)
        else:
            parts = re.split(re_break, tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(["BREAK", -1])
                res.append([part, 1.0])

    for pos in round_brackets:
        multiply_range(pos, round_bracket_multiplier)

    for pos in square_brackets:
        multiply_range(pos, square_bracket_multiplier)

    if len(res) == 0:
        res = [["", 1.0]]

    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i][0] += res[i + 1][0]
            res.pop(i + 1)
        else:
            i += 1

    return res


# ---------------------------------------------------------------------------
# A1111 chunked tokenization
# ---------------------------------------------------------------------------


class PromptChunk:
    def __init__(self):
        self.tokens: List[int] = []
        self.multipliers: List[float] = []


def _empty_chunk(id_start, id_end):
    c = PromptChunk()
    c.tokens = [id_start] + [id_end] * (CHUNK_LEN + 1)
    c.multipliers = [1.0] * (CHUNK_LEN + 2)
    return c


def tokenize_line(tokenizer, line: str,
                  enable_emphasis: bool = True
                  ) -> Tuple[List[PromptChunk], int]:
    """A prompt as 77-token chunks (bos, 75 tokens, eos) with their
    multipliers, and the token count."""
    id_start = tokenizer.bos_token_id
    id_end = tokenizer.eos_token_id
    comma_token = getattr(tokenizer, "comma_token_id", None)

    parsed = parse_prompt_attention(line) if enable_emphasis else [[line, 1.0]]
    tokenized = [tokenizer.encode(text, add_special_tokens=False)
                 for text, _ in parsed]

    chunks: List[PromptChunk] = []
    chunk = PromptChunk()
    token_count = 0
    last_comma = -1

    def next_chunk(is_last=False):
        nonlocal token_count, last_comma, chunk
        if is_last:
            token_count += len(chunk.tokens)
        else:
            token_count += CHUNK_LEN

        to_add = CHUNK_LEN - len(chunk.tokens)
        if to_add > 0:
            chunk.tokens += [id_end] * to_add
            chunk.multipliers += [1.0] * to_add

        chunk.tokens = [id_start] + chunk.tokens + [id_end]
        chunk.multipliers = [1.0] + chunk.multipliers + [1.0]

        last_comma = -1
        chunks.append(chunk)
        chunk = PromptChunk()

    for tokens, (text, weight) in zip(tokenized, parsed):
        if text == "BREAK" and weight == -1:
            next_chunk()
            continue

        position = 0
        while position < len(tokens):
            token = tokens[position]

            if token == comma_token:
                last_comma = len(chunk.tokens)
            elif (COMMA_PADDING_BACKTRACK != 0
                  and len(chunk.tokens) == CHUNK_LEN
                  and last_comma != -1
                  and len(chunk.tokens) - last_comma
                  <= COMMA_PADDING_BACKTRACK):
                break_location = last_comma + 1
                reloc_tokens = chunk.tokens[break_location:]
                reloc_mults = chunk.multipliers[break_location:]
                chunk.tokens = chunk.tokens[:break_location]
                chunk.multipliers = chunk.multipliers[:break_location]
                next_chunk()
                chunk.tokens = reloc_tokens
                chunk.multipliers = reloc_mults

            if len(chunk.tokens) == CHUNK_LEN:
                next_chunk()

            chunk.tokens.append(token)
            chunk.multipliers.append(weight)
            position += 1

    if len(chunk.tokens) > 0 or len(chunks) == 0:
        next_chunk(is_last=True)

    return chunks, token_count


def _device_of(clip_params, device):
    return clip_params["token_embedding"].device if device is None else device


def _encode(clip_params, clip_cfg, ids: np.ndarray, clip_skip: int,
            device) -> torch.Tensor:
    """CLIP on an (N, 77) id array, fp32 out."""
    t = torch.from_numpy(ids.astype(np.int64)).to(device)
    return clip_apply(clip_params, clip_cfg, t, clip_skip=clip_skip).float()


def encode_prompt_a1111(
    clip_params,
    clip_cfg: CLIPTextConfig,
    tokenizer,
    prompts: Sequence[str],
    negative_prompts: Sequence[str],
    clip_skip: int = 2,
    num_images_per_prompt: int = 1,
    device=None,
) -> Tuple[torch.Tensor, List[List[int]]]:
    """Mode "a1111". Per batch item the [uncond_i, cond_i] pair is chunked
    and CLIP runs once per chunk on the pair; z is weighted and the mean of
    the whole (2, 77, C) pair is restored, in fp32; the chunks are
    concatenated on the sequence axis. Every item is padded with empty
    chunks to the batch's largest chunk count."""
    if len(negative_prompts) == 1 and len(prompts) > 1:
        negative_prompts = list(negative_prompts) * len(prompts)
    device = _device_of(clip_params, device)
    id_start, id_end = tokenizer.bos_token_id, tokenizer.eos_token_id

    per_item = []
    max_chunks = 1
    for neg, pos in zip(negative_prompts, prompts):
        c_neg, _ = tokenize_line(tokenizer, neg)
        c_pos, _ = tokenize_line(tokenizer, pos)
        max_chunks = max(max_chunks, len(c_neg), len(c_pos))
        per_item.append((c_neg, c_pos))

    uncond_out, cond_out, cond_ids = [], [], []
    for c_neg, c_pos in per_item:
        zs, toks = [], []
        for i in range(max_chunks):
            pair = [c[i] if i < len(c) else _empty_chunk(id_start, id_end)
                    for c in (c_neg, c_pos)]
            tokens = np.asarray([c.tokens for c in pair], np.int64)
            mults = torch.tensor([c.multipliers for c in pair],
                                 dtype=torch.float32, device=device)
            z = _encode(clip_params, clip_cfg, tokens, clip_skip, device)
            original_mean = z.mean()
            z = z * mults[..., None]
            z = z * (original_mean / z.mean())
            zs.append(z)
            toks.append(tokens)
        z_full = torch.cat(zs, dim=1)  # (2, 77 * chunks, C)
        uncond_out.append(z_full[0])
        cond_out.append(z_full[1])
        cond_ids.append([int(i) for i in np.concatenate(toks, axis=1)[1]])

    context = torch.stack(uncond_out + cond_out)
    if num_images_per_prompt > 1:
        context = torch.repeat_interleave(context, num_images_per_prompt,
                                          dim=0)
    return context, cond_ids


# ---------------------------------------------------------------------------
# Long-prompt (lpw) encoding
# ---------------------------------------------------------------------------


def _get_prompts_with_weights(tokenizer, prompts, max_length):
    tokens, weights = [], []
    for text in prompts:
        text_token: List[int] = []
        text_weight: List[float] = []
        for word, weight in parse_prompt_attention(text):
            tok = tokenizer.encode(word, add_special_tokens=False)
            text_token += tok
            text_weight += [weight] * len(tok)
            if len(text_token) > max_length:
                break
        tokens.append(text_token[:max_length])
        weights.append(text_weight[:max_length])
    return tokens, weights


def _pad_tokens_and_weights(tokens, weights, max_length, bos, eos, pad,
                            chunk_length=77):
    """The no_boseos_middle=False layout: ids [bos, tokens, pad..., eos] of
    ``max_length``, weights per 77-position chunk."""
    max_embeddings_multiples = (max_length - 2) // (chunk_length - 2)
    weights_length = max_embeddings_multiples * chunk_length
    for i in range(len(tokens)):
        tokens[i] = ([bos] + tokens[i]
                     + [pad] * (max_length - 1 - len(tokens[i]) - 1) + [eos])
        w: List[float] = []
        if len(weights[i]) == 0:
            w = [1.0] * weights_length
        else:
            for j in range(max_embeddings_multiples):
                w.append(1.0)
                w += weights[i][j * (chunk_length - 2):
                                min(len(weights[i]),
                                    (j + 1) * (chunk_length - 2))]
                w.append(1.0)
            w += [1.0] * (weights_length - len(w))
        weights[i] = w[:]
    return tokens, weights


def _encode_chunked(clip_params, clip_cfg, token_array: np.ndarray,
                    clip_skip: int, device, chunk_length: int = 77):
    """Encode each 75-token chunk re-wrapped in bos/eos and keep all 77
    positions of each (no_boseos_middle=False)."""
    n_chunks = (token_array.shape[1] - 2) // (chunk_length - 2)
    if n_chunks <= 1:
        return _encode(clip_params, clip_cfg, token_array, clip_skip, device)
    outs = []
    bos = token_array[0, 0]
    eos = token_array[0, -1]
    for i in range(n_chunks):
        chunk = token_array[
            :, i * (chunk_length - 2): (i + 1) * (chunk_length - 2) + 2
        ].copy()
        chunk[:, 0] = bos
        chunk[:, -1] = eos
        outs.append(_encode(clip_params, clip_cfg, chunk, clip_skip, device))
    return torch.cat(outs, dim=1)


def encode_prompt_long(
    clip_params,
    clip_cfg: CLIPTextConfig,
    tokenizer,
    prompts: Sequence[str],
    negative_prompts: Sequence[str],
    clip_skip: int = 2,
    num_images_per_prompt: int = 1,
    max_embeddings_multiples: int = 3,
    device=None,
) -> Tuple[torch.Tensor, List[List[int]]]:
    """Mode "long": context (2B, 77 n, C) for n = 1..3 chunks, each sample's
    mean restored over its own (S, C) after weighting; cond ids of length
    75 n + 2."""
    if len(negative_prompts) == 1 and len(prompts) > 1:
        negative_prompts = list(negative_prompts) * len(prompts)
    device = _device_of(clip_params, device)
    chunk_length = 77
    max_length = (chunk_length - 2) * max_embeddings_multiples + 2

    p_tokens, p_weights = _get_prompts_with_weights(tokenizer, prompts,
                                                    max_length - 2)
    u_tokens, u_weights = _get_prompts_with_weights(
        tokenizer, negative_prompts, max_length - 2)

    longest = max(max(len(t) for t in p_tokens),
                  max(len(t) for t in u_tokens))
    mult = min(max_embeddings_multiples,
               (longest - 1) // (chunk_length - 2) + 1)
    mult = max(1, mult)
    max_length = (chunk_length - 2) * mult + 2

    bos, eos = tokenizer.bos_token_id, tokenizer.eos_token_id
    pad = getattr(tokenizer, "pad_token_id", eos)
    p_tokens, p_weights = _pad_tokens_and_weights(
        p_tokens, p_weights, max_length, bos, eos, pad, chunk_length)
    u_tokens, u_weights = _pad_tokens_and_weights(
        u_tokens, u_weights, max_length, bos, eos, pad, chunk_length)

    p_arr = np.asarray(p_tokens, np.int64)
    u_arr = np.asarray(u_tokens, np.int64)
    p_emb = _encode_chunked(clip_params, clip_cfg, p_arr, clip_skip, device,
                            chunk_length)
    u_emb = _encode_chunked(clip_params, clip_cfg, u_arr, clip_skip, device,
                            chunk_length)

    def reweight(emb, weights):
        w = torch.tensor(weights, dtype=torch.float32, device=device)[..., None]
        prev_mean = emb.mean(dim=(-2, -1), keepdim=True)
        emb = emb * w
        cur_mean = emb.mean(dim=(-2, -1), keepdim=True)
        return emb * (prev_mean / cur_mean)

    context = torch.cat([reweight(u_emb, u_weights),
                         reweight(p_emb, p_weights)], dim=0)
    if num_images_per_prompt > 1:
        context = torch.repeat_interleave(context, num_images_per_prompt,
                                          dim=0)
    return context, [[int(i) for i in r] for r in p_arr]
