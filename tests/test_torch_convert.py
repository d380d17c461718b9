"""The port's weight loading against the JAX package's, on the CPU, at the
tiny config, in fp32 and bf16.

Checkpoints of random weights in the published layouts are written here:
a diffusers directory (unet/, vae/, text_encoder/) as safetensors in fp32,
fp16 and bf16 (by the ``safetensors`` package) and as ``.bin`` pickles, an
SD2.1-style UNet (linear ``proj_in``/``proj_out``), an asymmetric VAE, a
ControlNet, a T2I-Adapter, a CLIP-vision tower, ArcFace and SCRFD
``.pth`` files and an IP-Adapter file of each variant (a Plus of depth 4
among them). Both packages load each file; the port's tree must
equal ``params_from_jax`` of the JAX package's bit for bit, in the dtype
asked for, its conv kernels ``channels_last``. The names come from
``chip_smoke.py``'s inverse of the converters' naming (the JAX package has
no exporter), whose UNet names are held to the JAX package's own inverse
(``tests/test_convert.py``). The port's safetensors reader and writer are
held to the ``safetensors`` package over every dtype they share.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import chip_smoke
from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.convert import hf as jhf
from diffusionspatialcontrol_tpu.models import arcface as jaf
from diffusionspatialcontrol_tpu.models import clip_vision as jcv
from diffusionspatialcontrol_tpu.models import face_detect as jfd
from diffusionspatialcontrol_tpu.models import ip_adapter as jipa
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.convert import cache as tcache
from diffusionspatialcontrol_tpu_torch.convert import hf as thf
from diffusionspatialcontrol_tpu_torch.convert import safetensors as tst
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import arcface as taf
from diffusionspatialcontrol_tpu_torch.models import clip_vision as tcv
from diffusionspatialcontrol_tpu_torch.models import controlnet as tcn
from diffusionspatialcontrol_tpu_torch.models import face_detect as tfd
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import ip_adapter as tipa
from diffusionspatialcontrol_tpu_torch.models import t2i_adapter as tt2i
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_convert import _unet_state_dict
from tests.test_torch_controlnet import to_jax
from tests.test_torch_face import _arcface_sd, _scrfd_sd
from tests.test_torch_vae import _asym

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

TTINY, JTINY = tcfg.tiny_config(), jcfg.tiny_config()
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
_ST_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
              torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
              torch.bool]


def randomized(tree, seed):
    """``tree`` with every tensor drawn anew (fp32, numpy from ``seed``), so
    that biases and norm scales count as much as the kernels."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        return torch.from_numpy(
            (0.5 * rng.standard_normal(tuple(node.shape))).astype(np.float32))

    return walk(tree)


def as_numpy(sd, dtype=np.float32):
    return {k: np.ascontiguousarray(v.float().numpy(), dtype)
            for k, v in sd.items()}


def write_file(path, sd, fmt):
    """``sd`` (name -> fp32 numpy) as ``fmt``: "fp32"/"fp16" safetensors by
    the safetensors package's numpy writer, "bf16" by its torch writer, or
    "bin": a torch pickle under "state_dict"."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if fmt == "bin":
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in sd.items()}}, path)
    elif fmt == "bf16":
        safetensors.torch.save_file(
            {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}, path)
    else:
        safetensors.numpy.save_file(
            {k: v.astype(np.float16 if fmt == "fp16" else np.float32)
             for k, v in sd.items()}, path)


def write_checkpoint(root, params, fmt):
    """A diffusers directory of ``params`` (the port's tree) in ``fmt``."""
    ext = "bin" if fmt == "bin" else "safetensors"
    for sub, name, sd in (
            ("unet", f"diffusion_pytorch_model.{ext}",
             chip_smoke.diffusers_state_dict(params["unet"])),
            ("vae", f"diffusion_pytorch_model.{ext}",
             chip_smoke.diffusers_state_dict(params["vae"])),
            ("text_encoder",
             "model.safetensors" if ext == "safetensors"
             else "pytorch_model.bin",
             chip_smoke.clip_state_dict(params["clip"]))):
        write_file(os.path.join(root, sub, name), as_numpy(sd), fmt)
    return str(root)


def assert_same(got, jax_tree, dtype, path=""):
    """The port's tree equals ``params_from_jax`` of the JAX package's bit
    for bit, every tensor of ``dtype``, conv kernels channels_last."""
    want = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax_tree), device="cpu")

    def walk(a, b, p):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), p
            for k in b:
                walk(a[k], b[k], f"{p}/{k}")
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b), p
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{p}/{i}")
        elif b is None:
            assert a is None, p
        else:
            assert a.dtype == dtype and a.shape == b.shape, p
            assert torch.equal(a.float(), b), p
            if a.dim() == 4:
                assert a.is_contiguous(memory_format=torch.channels_last), p

    walk(got, want, path)


@pytest.fixture(scope="module")
def drawn():
    """The tiny pipeline's tree with random values everywhere."""
    return randomized(tfactory.init_pipeline_params(
        0, TTINY, torch.float32, device="cpu"), 1)


@pytest.fixture(scope="module")
def checkpoints(drawn, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {fmt: write_checkpoint(root / fmt, drawn, fmt)
            for fmt in ("fp32", "fp16", "bf16", "bin")}


# -- the safetensors format ---------------------------------------------------

def _sample(dtype, shape=(3, 5)):
    g = torch.Generator().manual_seed(0)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape,
                         generator=g, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", _ST_DTYPES, ids=str)
def test_safetensors_matches_the_package(dtype, tmp_path):
    """Each dtype both ways, at odd sizes (later tensors start unaligned),
    with a 0-d and an empty tensor, and the metadata."""
    tensors = {"a": _sample(dtype), "b": _sample(dtype, (7,)),
               "c": _sample(dtype, ()), "d": _sample(dtype, (0, 4)),
               "e": _sample(torch.float16, (3,))}
    meta = {"format": "pt", "note": "x"}
    ref, own = str(tmp_path / "ref.safetensors"), str(tmp_path / "own")
    safetensors.torch.save_file(tensors, ref, metadata=meta)
    tst.save_file(tensors, own, metadata=meta)
    for got in (tst.load_file(ref), safetensors.torch.load_file(own),
                tst.load_file(own)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert tst.load_metadata(ref) == tst.load_metadata(own) == meta
    with safetensors.safe_open(own, "pt") as f:
        assert f.metadata() == meta


def test_safetensors_layouts_and_refusals(tmp_path):
    """A channels_last tensor and a numpy array are written in logical
    order; a tensor read from the map is writable without touching the
    file; a bad dtype name, short offsets and a cut file are refused."""
    x = torch.randn(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    path = str(tmp_path / "a.safetensors")
    tst.save_file({"x": x, "n": np.arange(6, dtype=np.int32)}, path)
    want = safetensors.torch.load_file(path)
    assert torch.equal(want["x"], x)
    assert torch.equal(want["n"], torch.arange(6, dtype=torch.int32))
    got = tst.load_file(path)
    got["x"].add_(1)
    assert torch.equal(tst.load_file(path)["x"], x)
    raw = open(path, "rb").read()
    for bad in (raw.replace(b'"I32"', b'"I33"'),
                raw.replace(b'"shape":[6]', b'"shape":[7]'),
                raw[:-4], raw[:5]):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            tst.load_file(path)


# -- diffusers checkpoints ----------------------------------------------------

def test_flattened_names_are_the_jax_package_inverse(drawn):
    """chip_smoke's UNet names and values are those of the JAX package's
    own inverse of its converter; every written weight is read."""
    want = _unet_state_dict(to_jax(drawn["unet"]), JTINY.unet)
    got = as_numpy(chip_smoke.diffusers_state_dict(drawn["unet"]))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for part, sd, convert in (
            ("unet", got, lambda s: thf.convert_unet(s, TTINY.unet,
                                                     device="cpu")),
            ("vae", as_numpy(chip_smoke.diffusers_state_dict(drawn["vae"])),
             lambda s: thf.convert_vae(s, TTINY.vae, device="cpu")),
            ("clip", as_numpy(chip_smoke.clip_state_dict(drawn["clip"])),
             lambda s: thf.convert_clip(s, TTINY.clip, device="cpu"))):
        state = thf.StateDict(sd)
        convert(state)
        assert state.unused() == [], part


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", ["fp32", "fp16", "bf16", "bin"])
def test_load_pipeline_params_matches_jax(checkpoints, fmt, dtype):
    tdt, jdt = DTYPES[dtype]
    want = jhf.load_pipeline_params(checkpoints[fmt], JTINY, jdt,
                                    n_extra_tokens=64)
    got = thf.load_pipeline_params(checkpoints[fmt], TTINY, tdt,
                                   n_extra_tokens=64, device="cpu")
    assert_same(got, want, tdt)
    table = got["clip"]["token_embedding"]
    assert table.shape[0] == TTINY.clip.vocab_size + 64
    assert not table[TTINY.clip.vocab_size:].any()
    # fp16 -> fp32 -> the target: the written values, rounded once
    if fmt == "fp16" and dtype == "bf16":
        k = got["unet"]["conv_in"]["kernel"]
        src = torch.from_numpy(as_numpy(chip_smoke.diffusers_state_dict(
            {"conv_in": {"kernel": k}}))["conv_in.weight"])
        assert torch.equal(k, src.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sd21_linear_projections_match_jax(drawn, dtype, tmp_path):
    """``use_linear_projection``: proj_in/proj_out are 2-d (linears) where
    SD1.5's are 1x1 convs."""
    tdt, jdt = DTYPES[dtype]
    tc = dataclasses.replace(TTINY.unet, use_linear_projection=True)
    jc = dataclasses.replace(JTINY.unet, use_linear_projection=True)
    unet = randomized(tunet.unet_init(torch.Generator().manual_seed(0),
                                         tc, torch.float32, "cpu"), 2)
    path = str(tmp_path / "unet.safetensors")
    write_file(path, as_numpy(chip_smoke.diffusers_state_dict(unet)), "fp16")
    got = thf.convert_unet(thf.load_state_dict(path), tc, tdt, "cpu")
    assert_same(got, jhf.convert_unet(jhf.load_state_dict(path), jc, jdt),
                tdt)
    attn = got["down_blocks"][0]["attentions"][0]
    assert attn["proj_in"]["kernel"].dim() == 2
    assert drawn["unet"]["down_blocks"][0]["attentions"][0]["proj_in"][
        "kernel"].dim() == 4


def test_asymmetric_vae_matches_jax(tmp_path):
    tc, jc = _asym(TTINY.vae, 1.5), _asym(JTINY.vae, 1.5)
    vae = randomized(tvae.vae_init(torch.Generator().manual_seed(0), tc,
                                   torch.float32, "cpu"), 3)
    assert "condition_encoder" in vae["decoder"]
    path = str(tmp_path / "vae.safetensors")
    write_file(path, as_numpy(chip_smoke.diffusers_state_dict(vae)), "fp16")
    for tdt, jdt in DTYPES.values():
        got = thf.convert_vae(thf.load_state_dict(path), tc, tdt, "cpu")
        assert_same(got, jhf.convert_vae(jhf.load_state_dict(path), jc, jdt),
                    tdt)


def test_controlnet_file_matches_jax(tmp_path):
    cn = randomized(tcn.controlnet_init(torch.Generator().manual_seed(0),
                                        TTINY.unet, dtype=torch.float32,
                                        device="cpu"), 4)
    path = str(tmp_path / "controlnet" /
               "diffusion_pytorch_model.safetensors")
    write_file(path, as_numpy(chip_smoke.diffusers_state_dict(cn)), "fp16")
    for tdt, jdt in DTYPES.values():  # a directory, as the app passes it
        got = thf.convert_controlnet(
            thf.load_state_dict(os.path.dirname(path)), TTINY.unet, tdt,
            "cpu")
        assert_same(got, jhf.convert_controlnet(
            jhf.load_state_dict(os.path.dirname(path)), JTINY.unet, jdt),
            tdt)


def _t2i_state_dict(tree):
    """TencentARC full_adapter names: the first level's in_conv is the
    adapter's conv_in."""
    sd = {}
    for i, block in enumerate(tree["blocks"]):
        convs = [(f"adapter.body.{i}.resnets.{j}.{k}", r[k])
                 for j, r in enumerate(block["resnets"])
                 for k in ("block1", "block2")]
        if block["in_conv"] is not None:
            convs.append(("adapter.conv_in" if i == 0
                          else f"adapter.body.{i}.in_conv", block["in_conv"]))
        for name, conv in convs:
            sd[f"{name}.weight"] = conv["kernel"]
            sd[f"{name}.bias"] = conv["bias"]
    return sd


def test_t2i_adapter_file_matches_jax(tmp_path):
    cfg = tcfg.T2IAdapterConfig(channels=TTINY.unet.block_out_channels)
    ad = randomized(tt2i.t2i_adapter_init(torch.Generator().manual_seed(0),
                                          cfg, torch.float32, "cpu"), 5)
    path = str(tmp_path / "t2i.safetensors")
    write_file(path, as_numpy(_t2i_state_dict(ad)), "fp32")
    got = thf.convert_t2i_adapter(thf.load_state_dict(path), torch.float32,
                                  "cpu")
    assert_same(got, jhf.convert_t2i_adapter(jhf.load_state_dict(path),
                                             jnp.float32), torch.float32)
    assert got["blocks"][-1]["in_conv"] is None  # 128 -> 128


def _clip_vision_state_dict(tree):
    emb = "vision_model.embeddings"
    sd = {f"{emb}.class_embedding": tree["class_embedding"],
          f"{emb}.patch_embedding.weight": tree["patch_embedding"]["kernel"],
          f"{emb}.position_embedding.weight": tree["position_embedding"],
          "visual_projection.weight": tree["visual_projection"]["kernel"]}
    for name in ("pre_layrnorm", "post_layernorm"):
        sd[f"vision_model.{name}.weight"] = tree[name]["scale"]
        sd[f"vision_model.{name}.bias"] = tree[name]["bias"]
    sd.update(chip_smoke.clip_state_dict(
        {"token_embedding": None, "position_embedding": None,
         "final_layer_norm": {"scale": None, "bias": None},
         "layers": tree["layers"]}))
    return {k.replace("text_model.", "vision_model."): v
            for k, v in sd.items() if v is not None}


def test_clip_vision_file_matches_jax(tmp_path):
    kw = dict(image_size=28, patch_size=14, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=2,
              projection_dim=16)
    tc, jc = tcv.CLIPVisionConfig(**kw), jcv.CLIPVisionConfig(**kw)
    tower = randomized(tcv.clip_vision_init(torch.Generator().manual_seed(0),
                                            tc, torch.float32, "cpu"), 6)
    path = str(tmp_path / "image_encoder" / "model.safetensors")
    write_file(path, as_numpy(_clip_vision_state_dict(tower)), "fp16")
    for tdt, jdt in DTYPES.values():
        got = thf.convert_clip_vision(
            thf.load_state_dict(os.path.dirname(path)), tc, tdt, "cpu")
        assert_same(got, jhf.convert_clip_vision(
            jhf.load_state_dict(os.path.dirname(path)), jc, jdt), tdt)
    # through the manager: registered by path, built at first use
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_image_encoder(os.path.dirname(path), cfg=tc)
    cfg, params = m.get_image_encoder()
    assert cfg is tc and m.get_image_encoder()[1] is params
    assert_same(params, jhf.convert_clip_vision(
        jhf.load_state_dict(path), jc, jnp.float32), torch.float32)


def test_face_net_files_match_jax(tmp_path):
    """ArcFace and SCRFD from torch ``.pth`` files, by the converters and
    through the manager (the JAX package's own manager hands its SCRFD
    converter a StateDict, which it cannot index: ROADMAP.md §3)."""
    rng = np.random.default_rng(7)
    arc_cfg = dataclasses.replace(taf.ARCFACE_TINY, embed_dim=512)
    arc, det = _arcface_sd(arc_cfg, rng), _scrfd_sd(tfd.FACEDETECT_TINY, rng)
    paths = {}
    for name, sd in (("arc", arc), ("det", det)):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   paths[name])
    got = taf.convert_arcface(thf.load_state_dict(paths["arc"]).arrays(),
                              arc_cfg, torch.float32, "cpu")
    want = jaf.convert_arcface(jhf.load_state_dict(paths["arc"]),
                               dataclasses.replace(jaf.ARCFACE_TINY,
                                                   embed_dim=512),
                               jnp.float32)
    assert_same(got, want, torch.float32)
    got = tfd.convert_scrfd(thf.load_state_dict(paths["det"]).arrays(),
                            tfd.FACEDETECT_TINY, torch.float32, "cpu")
    want = jfd.convert_scrfd(jhf.load_state_dict(paths["det"]).tensors,
                             jfd.FACEDETECT_TINY, jnp.float32)
    assert_same(got, want, torch.float32)
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_face_embedder(paths["arc"], cfg=arc_cfg)
    m.register_face_detector(paths["det"], cfg=tfd.FACEDETECT_TINY,
                             top1_fallback=True)
    photo = np.random.default_rng(8).integers(0, 256, (96, 80, 3)).astype(
        np.uint8)
    crop = m.get_face_aligner()(photo)
    emb = m.get_face_embedder()(crop)
    want_crop = tfd.make_face_aligner(got, tfd.FACEDETECT_TINY,
                                      top1_fallback=True)(photo)
    assert np.array_equal(crop, want_crop) and emb.shape == (512,)
    arc_params = taf.convert_arcface(
        thf.load_state_dict(paths["arc"]).arrays(), arc_cfg, torch.float32,
        "cpu")
    assert np.array_equal(emb, taf.make_arcface_embedder(arc_params,
                                                         arc_cfg)(crop))
    j = japi.ModelManager(dtype=jnp.float32)
    j.register_face_detector(paths["det"], cfg=jfd.FACEDETECT_TINY)
    with pytest.raises(TypeError, match="subscriptable"):
        j.get_face_aligner()


def _ip_state_dict(variant, depth):
    """``random_state_dict`` (the JAX package's numpy draws), the Resampler
    grown to ``depth`` layers by repeating its layers with new draws."""
    sd = tipa.random_state_dict(TTINY.unet, variant, seed=9,
                                embed_dim=32 if variant == "resampler"
                                else 16)
    rng = np.random.default_rng(10)
    proj = sd["image_proj"]
    for i in range(2, depth):
        for k in [k for k in proj if k.startswith("layers.0.")]:
            proj[f"layers.{i}." + k[len("layers.0."):]] = (
                proj[k] + 0.01 * rng.standard_normal(proj[k].shape)
            ).astype(np.float32)
    return sd


@pytest.mark.parametrize("variant,depth,fmt", [
    ("linear", 0, "fp32"), ("mlp", 0, "fp16"), ("faceid", 0, "fp32"),
    ("resampler", 2, "fp16"), ("resampler", 4, "fp32"),
    ("resampler", 4, "bin")])
def test_ip_adapter_files_match_jax(variant, depth, fmt, tmp_path):
    """A flat safetensors file with the two prefixes, or a torch pickle of
    the two groups: the split groups bit for bit, then the projection
    trees; a Plus file of depth 4 gives a 4-layer Resampler."""
    sd = _ip_state_dict(variant, depth)
    if fmt == "bin":
        path = str(tmp_path / "ip.bin")
        torch.save({g: {k: torch.from_numpy(v) for k, v in sd[g].items()}
                    for g in sd}, path)
    else:
        path = str(tmp_path / "ip.safetensors")
        write_file(path, {f"{g}.{k}": v for g in sd for k, v in sd[g].items()},
                   fmt)
    got, want = tipa.load_ip_adapter_file(path), jipa.load_ip_adapter_file(
        path)
    assert list(got) == list(want) == ["image_proj", "ip_adapter"]
    for g in got:
        assert set(got[g]) == set(want[g]) == set(sd[g])
        for k in got[g]:
            assert got[g][k].dtype == np.float32
            assert np.array_equal(got[g][k], np.asarray(want[g][k],
                                                        np.float32)), k
    tv, tp, tn = tipa.convert_image_proj(got["image_proj"], torch.bfloat16,
                                         "cpu")
    jv, jp, jn = jipa.convert_image_proj(want["image_proj"], jnp.bfloat16)
    assert (tv, tn) == (jv, jn)
    assert tp.pop("heads", None) == jp.pop("heads", None)
    assert_same(tp, jp, torch.bfloat16)
    if variant == "resampler":
        assert len(tp["layers"]) == depth
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    state = m.get_ip_adapter_state(path, TTINY.unet)
    assert m.get_ip_adapter_state(path, TTINY.unet) is state
    assert all(np.array_equal(state[g][k], got[g][k])
               for g in got for k in got[g])


# -- the cache and the manager ------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_cached_convert_round_trip(checkpoints, dtype, tmp_path):
    """The second call restores the snapshot: leaf for leaf, dtype, shape,
    strides (channels_last) and None leaves as converted."""
    tdt = DTYPES[dtype][0]
    cache = str(tmp_path / "cache")
    first = tcache.cached_convert(checkpoints["fp16"], cache, TTINY, tdt,
                                  device="cpu")
    assert os.listdir(cache) == [f"fp16-{TTINY.name}"]
    again = tcache.cached_convert(checkpoints["fp16"], cache, TTINY, tdt,
                                  device="cpu")
    tree = dict(first, extra=[None, {"k": first["unet"]["conv_in"]["kernel"]}])
    tcache.save_params(str(tmp_path / "snap"), tree)
    back = tcache.load_params(str(tmp_path / "snap"), device="cpu")
    for a, b in ((first, again), (tree, back)):
        la, lb = (jax.tree_util.tree_leaves_with_path(
            t, is_leaf=lambda x: x is None) for t in (a, b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, x), (_, y) in zip(la, lb):
            if x is None:
                assert y is None, p
                continue
            assert x.dtype == y.dtype == tdt, p
            assert x.stride() == y.stride() and torch.equal(x, y), p
    with pytest.raises(ValueError, match="snapshot"):
        tcache.load_params(os.path.join(checkpoints["fp32"], "unet",
                                        "diffusion_pytorch_model.safetensors"),
                           device="cpu")


def test_manager_get_loads_a_checkpoint_directory(checkpoints, tmp_path):
    """``get`` converts at first use with 64 spare embedding rows, as the
    JAX package's does, and reads the directory's tokenizer (the hash
    tokenizer without vocab files, a CLIPTokenizer with them); a directory
    without weights raises as in the JAX package."""
    t = tapi.ModelManager(dtype=torch.float32, device="cpu")
    j = japi.ModelManager(dtype=jnp.float32)
    for m in (t, j):
        m.register("disk", checkpoints["fp16"], (TTINY if m is t else JTINY))
        m.register("empty", str(tmp_path))
    cfg, params, tok = t.get("disk")
    jcfg_, jparams, jtok_ = j.get("disk")
    assert cfg is t._dirs["disk"][1] and t.get("disk")[1] is params
    assert_same(params, jparams, torch.float32)
    assert isinstance(tok, ttok.HashTokenizer)
    assert type(tok).__name__ == type(jtok_).__name__
    for m in (t, j):
        with pytest.raises(FileNotFoundError, match="no weight file"):
            m.get("empty")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2}
    tokdir = tmp_path / "withtok"
    (tokdir / "tokenizer").mkdir(parents=True)
    (tokdir / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tokdir / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    for sub in ("unet", "vae", "text_encoder"):
        os.symlink(os.path.join(checkpoints["fp16"], sub), tokdir / sub)
    t.register("tok", str(tokdir), TTINY)
    j.register("tok", str(tokdir), JTINY)
    tt, jt = t.get("tok")[2], j.get("tok")[2]
    assert isinstance(tt, ttok.CLIPTokenizer)
    assert tt.encode("a a") == jt.encode("a a")
