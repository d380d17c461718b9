"""diffusers / transformers checkpoints -> the port's parameter trees (port of
``convert/hf.py``).

Any SD1.x/2.x checkpoint in the diffusers layout
(``unet/diffusion_pytorch_model.safetensors``, ``vae/...``,
``text_encoder/model.safetensors``, ``tokenizer/``) converts straight into
the trees the port's models take. Safetensors files are read by the port's
own reader (``convert/safetensors.py``); ``.bin`` pickles by
``torch.load(..., weights_only=True)``.

The tensors keep the checkpoint's layouts, which are the port's: a conv
weight (O, I, kh, kw) becomes a ``kernel`` stored ``channels_last``, a
linear weight (out, in) a ``kernel`` as it is, a norm's weight/bias its
scale/bias. As in the JAX package, a half-precision tensor is widened to
fp32 and then cast to the target dtype (both round to nearest even); the
stored tensor moves to the device first, so an fp16 file crosses to the
card at half the bytes of fp32.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import CLIPTextConfig, ModelConfig, UNetConfig, VAEConfig
from ..device import resolve_device
from ..models.unet import _up_skip_channels
from .safetensors import load_file


class StateDict:
    """Flat name -> tensor view over a weight file (torch tensors on the CPU,
    or numpy arrays)."""

    def __init__(self, tensors: Dict[str, Any]):
        self.tensors = tensors
        self.used: set = set()

    @classmethod
    def load(cls, path: str) -> "StateDict":
        if path.endswith(".safetensors"):
            return cls(load_file(path))
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return cls({k: v.float() for k, v in sd.items()})

    def get(self, key: str, aliases: tuple = (),
            device=None) -> torch.Tensor:
        """The tensor of ``key`` (or the first alias present) in fp32, moved
        to ``device`` (default: where it is) before it is widened."""
        for k in (key,) + aliases:
            if k in self.tensors:
                self.used.add(k)
                t = self.tensors[k]
                if not isinstance(t, torch.Tensor):
                    t = torch.tensor(np.asarray(t))
                if device is not None:
                    t = t.to(device)
                return t.float()
        raise KeyError(f"missing weight {key}")

    def arrays(self) -> Dict[str, np.ndarray]:
        """Every tensor widened to an fp32 numpy array (the face networks'
        converters take name -> array)."""
        return {k: self.get(k).numpy() for k in self.tensors}

    def unused(self):
        return sorted(set(self.tensors) - self.used)


class _Converter:
    """The StateDict, the target dtype and device of one conversion."""

    def __init__(self, sd: StateDict, dtype, device):
        self.sd, self.dtype = sd, dtype
        self.device = resolve_device(device)

    def tensor(self, key: str, channels_last: bool = False,
               pad_rows: int = 0) -> torch.Tensor:
        t = self.sd.get(key, device=self.device)
        if pad_rows:
            t = torch.cat([t, t.new_zeros((pad_rows,) + t.shape[1:])])
        out = torch.empty(t.shape, dtype=self.dtype, device=self.device,
                          memory_format=torch.channels_last if channels_last
                          else torch.contiguous_format)
        return out.copy_(t)

    def conv(self, name: str, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"kernel": self.tensor(f"{name}.weight", channels_last=True)}
        if bias:
            p["bias"] = self.tensor(f"{name}.bias")
        return p

    def linear(self, name: str, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"kernel": self.tensor(f"{name}.weight")}
        if bias:
            p["bias"] = self.tensor(f"{name}.bias")
        return p

    def norm(self, name: str) -> Dict[str, torch.Tensor]:
        return {"scale": self.tensor(f"{name}.weight"),
                "bias": self.tensor(f"{name}.bias")}

    def has(self, key: str) -> bool:
        return key in self.sd.tensors


def _resnet(c: _Converter, pre: str, has_shortcut: bool):
    p = {
        "norm1": c.norm(f"{pre}.norm1"),
        "conv1": c.conv(f"{pre}.conv1"),
        "time_emb_proj": c.linear(f"{pre}.time_emb_proj"),
        "norm2": c.norm(f"{pre}.norm2"),
        "conv2": c.conv(f"{pre}.conv2"),
    }
    if has_shortcut:
        p["conv_shortcut"] = c.conv(f"{pre}.conv_shortcut")
    return p


def _attention(c: _Converter, pre: str):
    return {
        "to_q": c.linear(f"{pre}.to_q", bias=False),
        "to_k": c.linear(f"{pre}.to_k", bias=False),
        "to_v": c.linear(f"{pre}.to_v", bias=False),
        "to_out": c.linear(f"{pre}.to_out.0"),
    }


def _transformer(c: _Converter, pre: str, cfg: UNetConfig):
    # 1x1 convs on SD1.x, linears on SD2.x (use_linear_projection)
    proj = c.linear if cfg.use_linear_projection else c.conv
    blocks = []
    for tb in range(cfg.transformer_layers_per_block):
        bp = f"{pre}.transformer_blocks.{tb}"
        blocks.append({
            "norm1": c.norm(f"{bp}.norm1"),
            "attn1": _attention(c, f"{bp}.attn1"),
            "norm2": c.norm(f"{bp}.norm2"),
            "attn2": _attention(c, f"{bp}.attn2"),
            "norm3": c.norm(f"{bp}.norm3"),
            "ff": {
                "proj_in": c.linear(f"{bp}.ff.net.0.proj"),
                "proj_out": c.linear(f"{bp}.ff.net.2"),
            },
        })
    return {
        "norm": c.norm(f"{pre}.norm"),
        "proj_in": proj(f"{pre}.proj_in"),
        "blocks": blocks,
        "proj_out": proj(f"{pre}.proj_out"),
    }


def _down_path(c: _Converter, cfg: UNetConfig) -> Dict[str, Any]:
    """conv_in, the time embedding, the down blocks and the mid block: the
    part of the UNet a ControlNet copies."""
    params: Dict[str, Any] = {
        "conv_in": c.conv("conv_in"),
        "time_embedding": {
            "linear_1": c.linear("time_embedding.linear_1"),
            "linear_2": c.linear("time_embedding.linear_2"),
        },
    }
    down = []
    in_c = cfg.block_out_channels[0]
    for level, out_c in enumerate(cfg.block_out_channels):
        pre = f"down_blocks.{level}"
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            cin = in_c if j == 0 else out_c
            block["resnets"].append(
                _resnet(c, f"{pre}.resnets.{j}", cin != out_c))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer(c, f"{pre}.attentions.{j}", cfg))
        if level < cfg.num_levels - 1:
            block["downsample"] = c.conv(f"{pre}.downsamplers.0.conv")
        down.append(block)
        in_c = out_c
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnet1": _resnet(c, "mid_block.resnets.0", False),
        "attention": _transformer(c, "mid_block.attentions.0", cfg),
        "resnet2": _resnet(c, "mid_block.resnets.1", False),
    }
    return params


def convert_unet(sd: StateDict, cfg: UNetConfig, dtype=torch.bfloat16,
                 device=None) -> Dict[str, Any]:
    c = _Converter(sd, dtype, device)
    params = _down_path(c, cfg)
    up = []
    rev = list(reversed(cfg.block_out_channels))
    for i, out_c in enumerate(rev):
        level = cfg.num_levels - 1 - i
        pre = f"up_blocks.{i}"
        prev_c = rev[max(i - 1, 0)]
        skip_cs = _up_skip_channels(cfg, level)
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            res_in = (prev_c if j == 0 else out_c) + skip_cs[j]
            block["resnets"].append(
                _resnet(c, f"{pre}.resnets.{j}", res_in != out_c))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer(c, f"{pre}.attentions.{j}", cfg))
        if i < cfg.num_levels - 1:
            block["upsample"] = c.conv(f"{pre}.upsamplers.0.conv")
        up.append(block)
    params["up_blocks"] = up
    params["conv_norm_out"] = c.norm("conv_norm_out")
    params["conv_out"] = c.conv("conv_out")
    return params


def _vae_resnet(c: _Converter, pre: str, has_shortcut: bool):
    p = {
        "norm1": c.norm(f"{pre}.norm1"),
        "conv1": c.conv(f"{pre}.conv1"),
        "norm2": c.norm(f"{pre}.norm2"),
        "conv2": c.conv(f"{pre}.conv2"),
    }
    if has_shortcut:
        p["conv_shortcut"] = c.conv(f"{pre}.conv_shortcut")
    return p


def _vae_attn(c: _Converter, pre: str):
    return {
        "group_norm": c.norm(f"{pre}.group_norm"),
        "to_q": c.linear(f"{pre}.to_q"),
        "to_k": c.linear(f"{pre}.to_k"),
        "to_v": c.linear(f"{pre}.to_v"),
        "to_out": c.linear(f"{pre}.to_out.0"),
    }


def _vae_mid(c: _Converter, pre: str):
    return {
        "resnet1": _vae_resnet(c, f"{pre}.resnets.0", False),
        "attention": _vae_attn(c, f"{pre}.attentions.0"),
        "resnet2": _vae_resnet(c, f"{pre}.resnets.1", False),
    }


def convert_vae(sd: StateDict, cfg: VAEConfig, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    c = _Converter(sd, dtype, device)
    chans = cfg.block_out_channels
    enc: Dict[str, Any] = {"conv_in": c.conv("encoder.conv_in")}
    down = []
    in_c = chans[0]
    for lv, out_c in enumerate(chans):
        pre = f"encoder.down_blocks.{lv}"
        block = {"resnets": [
            _vae_resnet(c, f"{pre}.resnets.{j}",
                        (in_c if j == 0 else out_c) != out_c)
            for j in range(cfg.layers_per_block)
        ]}
        if lv < len(chans) - 1:
            block["downsample"] = c.conv(f"{pre}.downsamplers.0.conv")
        down.append(block)
        in_c = out_c
    enc["down_blocks"] = down
    enc["mid"] = _vae_mid(c, "encoder.mid_block")
    enc["conv_norm_out"] = c.norm("encoder.conv_norm_out")
    enc["conv_out"] = c.conv("encoder.conv_out")
    enc["quant_conv"] = c.conv("quant_conv")

    dec: Dict[str, Any] = {
        "post_quant_conv": c.conv("post_quant_conv"),
        "conv_in": c.conv("decoder.conv_in"),
        "mid": _vae_mid(c, "decoder.mid_block"),
    }
    up = []
    dchans = cfg.decoder_block_out_channels or chans
    d_layers = cfg.decoder_layers_per_block or cfg.layers_per_block
    rev = list(reversed(dchans))
    in_c = rev[0]
    for lv, out_c in enumerate(rev):
        pre = f"decoder.up_blocks.{lv}"
        block = {"resnets": [
            _vae_resnet(c, f"{pre}.resnets.{j}",
                        (in_c if j == 0 else out_c) != out_c)
            for j in range(d_layers + 1)
        ]}
        if lv < len(rev) - 1:
            block["upsample"] = c.conv(f"{pre}.upsamplers.0.conv")
        up.append(block)
        in_c = out_c
    dec["up_blocks"] = up
    dec["conv_norm_out"] = c.norm("decoder.conv_norm_out")
    dec["conv_out"] = c.conv("decoder.conv_out")
    # AsymmetricAutoencoderKL: the mask-condition encoder (its strides follow
    # from the kernel sizes, models/vae.py)
    if c.has("decoder.condition_encoder.layers.0.weight"):
        layers = []
        i = 0
        while c.has(f"decoder.condition_encoder.layers.{i}.weight"):
            layers.append(c.conv(f"decoder.condition_encoder.layers.{i}"))
            i += 1
        dec["condition_encoder"] = {"layers": layers}
    return {"encoder": enc, "decoder": dec}


def _clip_layers(c: _Converter, pre: str, n: int):
    return [{
        "layer_norm1": c.norm(f"{pre}.{i}.layer_norm1"),
        "q_proj": c.linear(f"{pre}.{i}.self_attn.q_proj"),
        "k_proj": c.linear(f"{pre}.{i}.self_attn.k_proj"),
        "v_proj": c.linear(f"{pre}.{i}.self_attn.v_proj"),
        "out_proj": c.linear(f"{pre}.{i}.self_attn.out_proj"),
        "layer_norm2": c.norm(f"{pre}.{i}.layer_norm2"),
        "fc1": c.linear(f"{pre}.{i}.mlp.fc1"),
        "fc2": c.linear(f"{pre}.{i}.mlp.fc2"),
    } for i in range(n)]


def convert_clip(sd: StateDict, cfg: CLIPTextConfig, dtype=torch.bfloat16,
                 n_extra_tokens: int = 0, device=None) -> Dict[str, Any]:
    """``n_extra_tokens``: zero rows appended to the token-embedding table,
    the slots textual-inversion vectors go into."""
    c = _Converter(sd, dtype, device)
    pre = "text_model"
    return {
        "token_embedding": c.tensor(
            f"{pre}.embeddings.token_embedding.weight",
            pad_rows=n_extra_tokens),
        "position_embedding": c.tensor(
            f"{pre}.embeddings.position_embedding.weight"),
        "layers": _clip_layers(c, f"{pre}.encoder.layers", cfg.num_layers),
        "final_layer_norm": c.norm(f"{pre}.final_layer_norm"),
    }


def convert_clip_vision(sd: StateDict, cfg, dtype=torch.bfloat16,
                        device=None) -> Dict[str, Any]:
    """CLIPVisionModelWithProjection (transformers layout) -> the
    ``models/clip_vision.py`` tree."""
    c = _Converter(sd, dtype, device)
    pre = "vision_model"
    emb = f"{pre}.embeddings"
    return {
        "class_embedding": c.tensor(f"{emb}.class_embedding"),
        "patch_embedding": c.conv(f"{emb}.patch_embedding", bias=False),
        "position_embedding": c.tensor(f"{emb}.position_embedding.weight"),
        # transformers spells it "pre_layrnorm"
        "pre_layrnorm": c.norm(f"{pre}.pre_layrnorm"),
        "layers": _clip_layers(c, f"{pre}.encoder.layers", cfg.num_layers),
        "post_layernorm": c.norm(f"{pre}.post_layernorm"),
        "visual_projection": c.linear("visual_projection", bias=False),
    }


def _find_weights(dirpath: str, names=("diffusion_pytorch_model.safetensors",
                                       "model.safetensors",
                                       "diffusion_pytorch_model.bin",
                                       "pytorch_model.bin")):
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weight file in {dirpath}")


def load_state_dict(path: str) -> StateDict:
    """StateDict from a weight file or a model directory (the standard
    diffusers / transformers file names)."""
    if os.path.isdir(path):
        path = _find_weights(path)
    return StateDict.load(path)


def load_pipeline_params(model_dir: str, cfg: ModelConfig,
                         dtype=torch.bfloat16, n_extra_tokens: int = 0,
                         device=None) -> Dict[str, Any]:
    """Convert a diffusers-layout checkpoint directory; ``device`` defaults
    to CUDA and raises when there is none."""
    device = resolve_device(device)

    def sd(sub):
        return StateDict.load(_find_weights(os.path.join(model_dir, sub)))

    return {
        "unet": convert_unet(sd("unet"), cfg.unet, dtype, device),
        "vae": convert_vae(sd("vae"), cfg.vae, dtype, device),
        "clip": convert_clip(sd("text_encoder"), cfg.clip, dtype,
                             n_extra_tokens, device),
    }


def convert_controlnet(sd: StateDict, cfg: UNetConfig, dtype=torch.bfloat16,
                       device=None) -> Dict[str, Any]:
    """A ControlNet state dict (diffusers layout) -> the
    ``models/controlnet.py`` tree."""
    c = _Converter(sd, dtype, device)
    params: Dict[str, Any] = {
        "conv_in": c.conv("conv_in"),
        "time_embedding": {
            "linear_1": c.linear("time_embedding.linear_1"),
            "linear_2": c.linear("time_embedding.linear_2"),
        },
    }
    ce = {"conv_in": c.conv("controlnet_cond_embedding.conv_in"),
          "blocks": [],
          "conv_out": c.conv("controlnet_cond_embedding.conv_out")}
    i = 0
    while c.has(f"controlnet_cond_embedding.blocks.{i}.weight"):
        ce["blocks"].append(c.conv(f"controlnet_cond_embedding.blocks.{i}"))
        i += 1
    params["cond_embedding"] = ce
    trunk = _down_path(c, cfg)
    params["down_blocks"] = trunk["down_blocks"]
    params["mid_block"] = trunk["mid_block"]
    zero_convs = []
    i = 0
    while c.has(f"controlnet_down_blocks.{i}.weight"):
        zero_convs.append(c.conv(f"controlnet_down_blocks.{i}"))
        i += 1
    params["zero_convs"] = zero_convs
    params["mid_zero_conv"] = c.conv("controlnet_mid_block")
    return params


def convert_t2i_adapter(sd: StateDict, dtype=torch.bfloat16,
                        device=None) -> Dict[str, Any]:
    """TencentARC full_adapter state dict -> the ``models/t2i_adapter.py``
    tree (diffusers names: adapter.conv_in, adapter.body.{i}.in_conv,
    .resnets.{j}.block1/block2); ``in_conv`` is None where a level keeps its
    width."""
    c = _Converter(sd, dtype, device)
    blocks = []
    i = 0
    while any(k.startswith(f"adapter.body.{i}.") for k in sd.tensors):
        pre = f"adapter.body.{i}"
        block: Dict[str, Any] = {"in_conv": None, "resnets": []}
        if c.has(f"{pre}.in_conv.weight"):
            block["in_conv"] = c.conv(f"{pre}.in_conv")
        j = 0
        while c.has(f"{pre}.resnets.{j}.block1.weight"):
            block["resnets"].append({
                "block1": c.conv(f"{pre}.resnets.{j}.block1"),
                "block2": c.conv(f"{pre}.resnets.{j}.block2"),
            })
            j += 1
        blocks.append(block)
        i += 1
    params: Dict[str, Any] = {"blocks": blocks}
    if c.has("adapter.conv_in.weight"):
        # full_adapter's conv_in folds into the first block's in_conv slot
        params["blocks"][0]["in_conv"] = c.conv("adapter.conv_in")
    return params

