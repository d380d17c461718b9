"""The port's A1111 prompt parser and its "a1111" and "long" prompt modes
against the JAX package, on the CPU.

The grammar and the chunking must give the same text runs, weights, ids and
multipliers exactly. The encoders run the tiny config's CLIP on shared fp32
parameters; tolerance as the CLIP parity test's (rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.ops import region_map as jregion
from diffusionspatialcontrol_tpu.text import encoder as jencoder
from diffusionspatialcontrol_tpu.text import prompt_parser as jpp
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import clip as tclip
from diffusionspatialcontrol_tpu_torch.ops import region_map as tregion
from diffusionspatialcontrol_tpu_torch.text import encoder as tencoder
from diffusionspatialcontrol_tpu_torch.text import prompt_parser as tpp
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

GRAMMAR = [
    "normal text", "an (important) word", "(unbalanced", r"\(literal\]",
    "(unnecessary)(parens)",
    "a (((house:1.3)) [on] a (hill:0.5), sun, (((sky))).",
    "(word:3.12)", "before BREAK after", "", "[[faded]] (x:0.5) \\\\ end",
    "a BREAK BREAK b", "(a:1.2) [b c] ((d)) (e:-0.5) :colon",
]


def _words(prefix, n):
    return " ".join(f"{prefix}{i}" for i in range(n))


# One chunk, two, three, BREAK, and the comma backtrack near the 75 mark.
PROMPTS = {
    "1 chunk": "a (red:1.3) cat on a [wooden] bench",
    "2 chunks": "a (red cat:1.3), " + _words("w", 90) + ", [blue] bird",
    "3 chunks": _words("w", 100) + " BREAK " + "(" + _words("x", 60) + ")",
    "break": "first part BREAK second (part:0.7)",
    "comma": _words("w", 70) + ", " + _words("x", 10),
}


@pytest.mark.parametrize("text", GRAMMAR)
def test_parse_prompt_attention_matches_jax(text):
    assert tpp.parse_prompt_attention(text) == jpp.parse_prompt_attention(
        text)


@pytest.mark.parametrize("key", sorted(PROMPTS))
def test_tokenize_line_matches_jax(key):
    text = PROMPTS[key]
    want, want_count = jpp.tokenize_line(jtok.HashTokenizer(), text)
    got, got_count = tpp.tokenize_line(ttok.HashTokenizer(), text)
    assert got_count == want_count
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.multipliers for c in got] == [c.multipliers for c in want]
    assert all(len(c.tokens) == 77 for c in got)
    n = {"1 chunk": 1, "2 chunks": 2, "3 chunks": 3, "break": 2,
         "comma": 2}[key]
    assert len(got) == n


@pytest.fixture(scope="module")
def clip():
    """The port's tiny CLIP init (the JAX init's tree and bounds) with a
    random final LayerNorm bias, shared by both packages. The init's zero
    bias gives every output row a mean of 0 up to rounding, and both modes
    divide by such means; trained weights have a nonzero bias (the modes
    were written for them)."""
    cfg = jcfg.tiny_config().clip
    jp = to_jax(tclip.clip_init(torch.Generator().manual_seed(3),
                                tcfg.tiny_config().clip, torch.float32,
                                "cpu"))
    bias = np.random.default_rng(3).standard_normal(cfg.hidden_size)
    jp["final_layer_norm"]["bias"] = jnp.asarray(0.5 * bias, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


CASES = [  # (prompts, negatives): 1, 2 and 3 chunks; a batch of 2 uneven
    ([PROMPTS["1 chunk"]], ["bad quality"]),
    ([PROMPTS["2 chunks"]], ["bad quality, (blurry:1.2)"]),
    ([PROMPTS["3 chunks"]], [""]),
    ([PROMPTS["2 chunks"], PROMPTS["1 chunk"]], ["bad quality"]),
]


@pytest.mark.parametrize("mode", ["a1111", "long"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_encoders_match_jax(clip, mode, case):
    jp, tp = clip
    prompts, negs = CASES[case]
    want, want_ids = jencoder.encode_prompts(
        jp, jcfg.tiny_config().clip, jtok.HashTokenizer(), prompts, negs,
        mode=mode, num_images_per_prompt=2 if case == 3 else 1)
    got, got_ids = tencoder.encode_prompts(
        tp, tcfg.tiny_config().clip, ttok.HashTokenizer(), prompts, negs,
        mode=mode, num_images_per_prompt=2 if case == 3 else 1)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert got_ids == [[int(i) for i in r] for r in want_ids]
    chunks = {0: 1, 1: 2, 2: 3, 3: 2}[case]
    assert got.shape[1] == 77 * chunks
    assert len(got_ids[0]) == (77 * chunks if mode == "a1111"
                               else 75 * chunks + 2)


def test_automatic1111_is_a1111(clip):
    _, tp = clip
    args = (tp, tcfg.tiny_config().clip, ttok.HashTokenizer(),
            [PROMPTS["2 chunks"]], ["bad"])
    a, ia = tencoder.encode_prompts(*args, mode="a1111")
    b, ib = tencoder.encode_prompts(*args, mode="automatic1111")
    assert torch.equal(a, b) and ia == ib


@pytest.mark.parametrize("mode", ["a1111", "long"])
def test_returned_ids_build_the_jax_region_biases(clip, mode):
    """The ids of a two-chunk prompt feed ``encode_region_state`` to the
    JAX package's biases, whose S is the number of ids."""
    jp, tp = clip
    text = "a red cat, " + _words("w", 80) + ", a blue bird"
    _, jids = jencoder.encode_prompts(
        jp, jcfg.tiny_config().clip, jtok.HashTokenizer(), [text], ["bad"],
        mode=mode)
    _, tids = tencoder.encode_prompts(
        tp, tcfg.tiny_config().clip, ttok.HashTokenizer(), [text], ["bad"],
        mode=mode)
    m1 = np.zeros((64, 64), np.float32)
    m1[:, :32] = 1.0
    state = {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
             "blue bird": {"mask": 1 - m1, "weight": 0.7,
                           "mask_outsides": 0.1}}
    tok = jtok.HashTokenizer()

    def phrase(p):
        return tok.encode(p, add_special_tokens=False)

    want = jregion.encode_region_state([state], jids, phrase, height=64,
                                       width=64)
    got = tregion.encode_region_state([state], tids, phrase, height=64,
                                      width=64)
    s = 154 if mode == "a1111" else 152
    for a, b in zip(want, got):
        assert b.shape[-1] == s
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    assert float(got[0].abs().max()) > 0
