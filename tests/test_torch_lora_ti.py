"""The port's LoRA merge, textual inversion and ``ModelManager.get_variant``
against the JAX package's, on the CPU, at the tiny config.

* ``_module_index`` / ``_clip_module_index``: the same names to the same
  paths;
* ``merge_lora`` on a LoRA of every kernel of the UNet and the text
  encoder (linears, 1x1 and 3x3 convs, a linear pair on a 1x1 conv), kohya
  and PEFT names, fp32 and bf16: every merged leaf bit for bit (both merge
  in numpy fp32 and cast once); the unmatched ``ValueError``; a conv pair
  on a linear kernel (where the packages differ);
* ``EmbeddingTokenizer`` ids on 300 random prompts with trigger words, and
  ``add_embeddings`` rows, bit for bit; the "table too small" error;
* ``load_embedding_file`` on A1111 ``.pt`` files and ``.safetensors``;
* ``get_variant`` on a checkpoint directory and on a random model (whose
  table grows by concatenation): the JAX package's trees, one variant per
  combination, the base tree and tokenizer untouched;
* one ``inference()`` from the directory with a LoRA and a trigger word,
  bit for bit the port's ``inference()`` on the tree converted from the JAX
  package's variant (no JAX sampling program is compiled).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.convert import lora as jlora
from diffusionspatialcontrol_tpu.convert import textual_inversion as jti
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.convert import lora as tlora
from diffusionspatialcontrol_tpu_torch.convert import textual_inversion as tti
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import factory
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.models.ip_adapter import (
    copy_tree_containers,
)
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax
from tests.test_torch_convert import (
    DTYPES,
    JTINY,
    TTINY,
    assert_same,
    randomized,
    write_checkpoint,
)

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

RANK = 4
PROMPT = "a red cat, mystyle sitting on a bench"


@pytest.fixture(scope="module")
def base():
    """The tiny pipeline with random values everywhere, fp32."""
    return randomized(factory.init_pipeline_params(
        0, TTINY, torch.float32, device="cpu"), 11)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda t: t.to(dtype), tree)


def lora_state_dict(tree, naming="kohya", seed=0):
    """A rank-4 LoRA of every kernel of ``tree``'s UNet and text encoder:
    conv pairs (4-d) on convs, but a linear pair on the 1x1 ``proj_out``
    convs; with ``.alpha`` keys (skipped), one module without its up half
    and one the model lacks (both skipped)."""
    rng = np.random.default_rng(seed)
    names = {"down": "lora_A" if naming == "peft" else "lora_down",
             "up": "lora_B" if naming == "peft" else "lora_up"}
    sd = {}
    for prefix, index, sub in (
            ("lora_unet", tlora._module_index(tree["unet"]), tree["unet"]),
            ("lora_te", tlora._clip_module_index(tree["clip"]),
             tree["clip"])):
        for name, path in sorted(index.items()):
            k = tlora._get(sub, path)["kernel"]
            o, i = k.shape[:2]
            mod = f"{prefix}_{tlora._normalize(name)}"
            if k.dim() == 4 and not name.endswith("proj_out"):
                down = rng.standard_normal((RANK, i) + tuple(k.shape[2:]))
                up = rng.standard_normal((o, RANK, 1, 1))
            else:
                down = rng.standard_normal((RANK, i))
                up = rng.standard_normal((o, RANK))
            sd[f"{mod}.{names['down']}.weight"] = (0.1 * down).astype(
                np.float32)
            sd[f"{mod}.{names['up']}.weight"] = (0.1 * up).astype(np.float32)
            sd[f"{mod}.alpha"] = np.float32(RANK)
    sd[f"lora_te2_text_model_encoder_layers_0_mlp_fc1.{names['down']}"
       ".weight"] = np.ones((RANK, 4), np.float32)
    sd[f"lora_unet_no_such_module.{names['down']}.weight"] = np.ones(
        (RANK, 4), np.float32)
    sd[f"lora_unet_no_such_module.{names['up']}.weight"] = np.ones(
        (4, RANK), np.float32)
    return sd


def test_module_index_matches_jax(base):
    linear = tunet.unet_init(torch.Generator().manual_seed(0),
                             dataclasses.replace(TTINY.unet,
                                                 use_linear_projection=True),
                             torch.float32, "cpu")
    for unet in (base["unet"], linear):
        got = tlora._module_index(unet)
        assert got == jlora._module_index(to_jax(unet))
        assert len(got) > 100
        assert "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0" \
               ".proj" in got and "mid_block.attentions.0.proj_in" in got
    got = tlora._clip_module_index(base["clip"])
    assert got == jlora._clip_module_index(to_jax(base["clip"]))
    assert "text_model.encoder.layers.0.self_attn.q_proj" in got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("naming", ["kohya", "peft"])
def test_merge_lora_matches_jax(base, naming, dtype):
    tdt, jdt = DTYPES[dtype]
    tree = _cast({"unet": base["unet"], "clip": base["clip"]}, tdt)
    # cast on the host (numpy, round to nearest even as the port's cast):
    # a JAX cast compiles a program a shape
    jtree = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jdt),
                                   to_jax({"unet": base["unet"],
                                           "clip": base["clip"]}))
    sd = lora_state_dict(base, naming)
    merged = tlora.merge_lora(copy_tree_containers(tree), sd, scale=0.7)
    want = jlora.merge_lora(jtree, sd, scale=0.7)
    assert_same(merged, want, tdt)
    # every kernel was merged into a new tensor; the rest is shared
    for a, b in zip(jax.tree_util.tree_leaves_with_path(tree),
                    jax.tree_util.tree_leaves(merged)):
        is_kernel = getattr(a[0][-1], "key", None) == "kernel"
        assert (a[1] is not b) == is_kernel, jax.tree_util.keystr(a[0])
        if is_kernel:
            assert not torch.equal(a[1], b)
            if b.dim() == 4:
                assert b.is_contiguous(memory_format=torch.channels_last)


def test_conv_pair_on_a_linear_kernel():
    """A 1x1 conv pair on SD2.1's linear proj_in merges into the 2-d kernel
    (the JAX package's merge leaves a 4-d leaf there: ROADMAP.md §3); a
    linear pair on SD1.5's 1x1 conv broadcasts as the JAX package's does
    (``test_merge_lora_matches_jax``)."""
    rng = np.random.default_rng(9)
    kernel = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    up = rng.standard_normal((6, 2, 1, 1)).astype(np.float32)
    down = rng.standard_normal((2, 5, 1, 1)).astype(np.float32)
    got = tlora.merged_kernel(kernel, up, down, 0.5)
    want = kernel.numpy() + 0.5 * (up[:, :, 0, 0] @ down[:, :, 0, 0])
    assert got.shape == (6, 5) and np.array_equal(got.numpy(), want)
    tree = {"unet": {"proj_in": {"kernel": jnp.asarray(kernel.numpy().T)}},
            "clip": {}}
    jlora.merge_lora(tree, {"lora_unet_proj_in.lora_down.weight": down,
                            "lora_unet_proj_in.lora_up.weight": up}, 0.5)
    assert tree["unet"]["proj_in"]["kernel"].shape == (1, 1, 5, 6)


def test_unmatched_lora_raises_as_jax(base):
    sd = {"lora_unet_nope.lora_down.weight": np.ones((2, 4), np.float32),
          "lora_unet_nope.lora_up.weight": np.ones((4, 2), np.float32)}
    errors = []
    for merge, tree in ((tlora.merge_lora, copy_tree_containers(base)),
                        (jlora.merge_lora, to_jax(base))):
        with pytest.raises(ValueError) as e:
            merge(tree, sd)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "no LoRA modules matched" in errors[0]
    assert tlora.merge_lora(copy_tree_containers(base), {}) is not None


_WORDS = ["a", "red", "cat", "mystyle", "mystyles", "char-x", "xchar-x",
          "emb", "(emb:1.2)", "emb,", ",emb", "sitting", "on", "bench", ",",
          "  ", "mystyle,mystyle", "char-x.", "EMB", "é"]


def test_embedding_tokenizer_ids_match_jax():
    rng = np.random.default_rng(0)
    wrapped = []
    for mod, tok in ((tti, ttok.HashTokenizer()), (jti, jtok.HashTokenizer())):
        w = mod.EmbeddingTokenizer(tok)
        assert w.register("mystyle", 2) == [49408, 49409]
        w.register("char-x", 3)
        w.register("emb", 1)
        wrapped.append(w)
    t, j = wrapped
    assert t.next_id == j.next_id and t._extra_ids == j._extra_ids
    for _ in range(300):
        n = int(rng.integers(1, 12))
        text = " ".join(_WORDS[int(i)] for i in rng.integers(0, len(_WORDS),
                                                             n))
        assert t.tokenize_to_ids(text) == j.tokenize_to_ids(text), text
        for kw in ({}, {"add_special_tokens": False},
                   {"truncation": True, "max_length": 6}):
            assert t.encode(text, **kw) == j.encode(text, **kw), text
        assert t(text).input_ids == j(text).input_ids
    assert t.bos_token_id == j.bos_token_id  # the base's, through getattr


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_embeddings_matches_jax(base, dtype):
    tdt, jdt = DTYPES[dtype]
    vocab = TTINY.clip.vocab_size
    table = torch.cat([base["clip"]["token_embedding"],
                       torch.zeros(8, TTINY.clip.hidden_size)])
    clip = {**base["clip"], "token_embedding": table.to(tdt)}
    jclip = {"token_embedding": jnp.asarray(table.numpy(), jdt)}
    rng = np.random.default_rng(1)
    embs = {"mystyle": rng.standard_normal((2, TTINY.clip.hidden_size)),
            "emb": rng.standard_normal(TTINY.clip.hidden_size)}
    before = clip["token_embedding"].clone()
    got, ttk = tti.add_embeddings(clip, ttok.HashTokenizer(), embs, vocab)
    want, jtk = jti.add_embeddings(jclip, jtok.HashTokenizer(), embs, vocab)
    g, w = got["token_embedding"], want["token_embedding"]
    assert g.dtype == tdt and g.shape == w.shape
    assert torch.equal(g.float(), torch.from_numpy(np.array(w, np.float32)))
    assert torch.equal(clip["token_embedding"], before)  # a new table
    assert got["layers"] is base["clip"]["layers"]
    assert ttk.encode("mystyle emb") == jtk.encode("mystyle emb")
    big = {"x": np.ones((9, TTINY.clip.hidden_size))}
    errors = []
    for mod, c, tk in ((tti, clip, ttok.HashTokenizer()),
                       (jti, jclip, jtok.HashTokenizer())):
        with pytest.raises(ValueError) as e:
            mod.add_embeddings(c, tk, big, vocab)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "table too small" in errors[0]


def test_load_embedding_file_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    vec = rng.standard_normal((3, 8)).astype(np.float32)
    files = {
        "a1111.pt": {"string_to_param": {"*": torch.from_numpy(vec)}},
        "named.pt": {"x": torch.from_numpy(vec), "y": torch.from_numpy(
            vec[:1].astype(np.float16))},
    }
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
    safetensors.numpy.save_file({"z": vec.astype(np.float16), "w": vec},
                                str(tmp_path / "st.safetensors"))
    for name in list(files) + ["st.safetensors"]:
        path = str(tmp_path / name)
        got, want = tti.load_embedding_file(path), jti.load_embedding_file(
            path)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == np.float32
            assert np.array_equal(got[k], want[k]), (name, k)


@pytest.fixture(scope="module")
def disk(base, tmp_path_factory):
    """A tiny diffusers directory (fp16 safetensors), a kohya LoRA of every
    kernel, an A1111 ``.pt`` embedding of 2 vectors (its trigger word is
    the file stem) and a ``.safetensors`` one of 1."""
    root = tmp_path_factory.mktemp("variant")
    ckpt = write_checkpoint(root / "ckpt", base, "fp16")
    lora = str(root / "style.safetensors")
    safetensors.numpy.save_file(
        {k: v for k, v in lora_state_dict(base, seed=3).items()
         if v.ndim}, lora)
    rng = np.random.default_rng(4)
    width = TTINY.clip.hidden_size
    ti_pt = str(root / "mystyle.pt")
    torch.save({"string_to_param": {"*": torch.from_numpy(
        rng.standard_normal((2, width)).astype(np.float32))}}, ti_pt)
    ti_st = str(root / "named.safetensors")
    safetensors.numpy.save_file(
        {"emb": rng.standard_normal((1, width)).astype(np.float16)}, ti_st)
    return ckpt, lora, ti_pt, ti_st


def _managers(path, tdt=torch.float32, jdt=jnp.float32):
    t = tapi.ModelManager(dtype=tdt, device="cpu")
    j = japi.ModelManager(dtype=jdt)
    t.register("disk", path, TTINY)
    j.register("disk", path, JTINY)
    return t, j


def _snapshot(tree):
    return [(id(x), x.clone()) for x in jax.tree_util.tree_leaves(tree)]


def _unchanged(tree, snap):
    leaves = jax.tree_util.tree_leaves(tree)
    return len(leaves) == len(snap) and all(
        id(x) == i and torch.equal(x, y) for x, (i, y) in zip(leaves, snap))


@pytest.mark.parametrize("dtype", DTYPES)
def test_get_variant_matches_jax_and_keeps_the_base(disk, dtype):
    ckpt, lora, ti_pt, ti_st = disk
    t, j = _managers(ckpt, *DTYPES[dtype])
    _, tbase, ttok_base = t.get("disk")
    snap = _snapshot(tbase)
    kw = dict(loras=[(lora, 0.6)], ti_embeddings=[ti_pt, ti_st])
    cfg, params, tok = t.get_variant("disk", **kw)
    _, jparams, jtk = j.get_variant("disk", **kw)
    assert_same(params, jparams, DTYPES[dtype][0])
    for text in (PROMPT, "emb, mystyle", "mystyles emb"):
        assert tok.encode(text) == jtk.encode(text)
    assert tok.encode("mystyle")[1:3] == [TTINY.clip.vocab_size,
                                          TTINY.clip.vocab_size + 1]
    assert _unchanged(tbase, snap) and t.get("disk")[2] is ttok_base
    assert not isinstance(ttok_base, tti.EmbeddingTokenizer)
    assert t.get_variant("disk", **kw)[1] is params  # cached
    assert t.get_variant("disk", loras=[lora])[1] is not params
    assert t.get_variant("disk")[1] is tbase
    assert len(t._adapters) == 2


def test_get_variant_pads_a_random_models_table(base, tmp_path):
    """A random model's table has no spare rows: the variant's grows by
    concatenation, as the JAX package's does."""
    t = tapi.ModelManager(dtype=torch.float32, device="cpu")
    j = japi.ModelManager(dtype=jnp.float32)
    t._dirs["r"], j._dirs["r"] = ("", TTINY), ("", JTINY)
    t._cache["r"], j._cache["r"] = base, to_jax(base)
    t._tokenizers["r"] = ttok.HashTokenizer()
    j._tokenizers["r"] = jtok.HashTokenizer()
    vecs = np.random.default_rng(5).standard_normal(
        (3, TTINY.clip.hidden_size)).astype(np.float32)
    path = str(tmp_path / "three.pt")
    torch.save({"string_to_param": {"*": torch.from_numpy(vecs)}}, path)
    got = t.get_variant("r", ti_embeddings=[path])
    want = j.get_variant("r", ti_embeddings=[path])
    table = got[1]["clip"]["token_embedding"]
    assert table.shape[0] == TTINY.clip.vocab_size + 3
    assert torch.equal(table[-3:], torch.from_numpy(vecs))
    assert_same(got[1]["clip"], want[1]["clip"], torch.float32)
    assert base["clip"]["token_embedding"].shape[0] == TTINY.clip.vocab_size


def test_inference_with_lora_and_ti_from_disk(disk):
    """inference() from the directory with a LoRA and both trigger words
    gives, bit for bit, the image of inference() on the tree converted from
    the JAX package's variant (the port's own tokenizer wrapper)."""
    ckpt, lora, ti_pt, ti_st = disk
    t, j = _managers(ckpt)
    kw = dict(loras=[(lora, 0.6)], ti_embeddings=[ti_pt, ti_st])
    _, jparams, _ = j.get_variant("disk", **kw)
    tok = t.get_variant("disk", **kw)[2]
    ref = tapi.ModelManager(dtype=torch.float32, device="cpu")
    ref._dirs["conv"] = ("", TTINY)
    ref._cache["conv"] = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ref._tokenizers["conv"] = tok
    req = dict(prompt="mystyle, a red cat, emb", steps=2, width=64,
               height=64, sampler="Euler", encoding_mode="short",
               dtype=torch.float32)
    got = tapi.inference(t, model="disk", **req, **kw)["images"]
    want = tapi.inference(ref, model="conv", **req)["images"]
    assert got.shape == (1, 64, 64, 3) and np.array_equal(got, want)
    plain = tapi.inference(t, model="disk", **req)["images"]
    assert not np.array_equal(got, plain)
