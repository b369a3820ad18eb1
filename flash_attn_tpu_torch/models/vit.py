"""Vision Transformer (port of the JAX package's models/vit.py ``ViTConfig``,
``VisionTransformer``, ``vit_config_from_hf``, ``remap_state_dict_hf_vit``):
a patch convolution, a cls token and learned positions, pre-norm blocks
whose attention is ``flash_attn_func(causal=False)``, a final LayerNorm and
a classifier over the cls token or the mean of the patch tokens. Images
come in as (b, H, W, C), as in JAX.

Parameters mirror flax's values and names: Dense and convolution weights
in the compute type, the head in fp32 (JAX computes it in fp32), norm
weights, the cls token and the position table in fp32. ``load_jax_params``
fills the model from a flax param tree; ``remap_state_dict_hf_vit`` gives
a HF ``ViTForImageClassification`` state dict in this model's names.
"""

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.interface import flash_attn_func
from flash_attn_tpu_torch.ops.norm import layer_norm
from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["ViTConfig", "VisionTransformer", "vit_config_from_hf",
           "remap_state_dict_hf_vit", "jax_param_arrays", "load_jax_params"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    use_cls_token: bool = True
    global_pool: str = "token"   # "token" (cls) | "avg"
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32


def _norm_pair(dim: int, device):
    return (nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device)),
            nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device)))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        e, dt = cfg.embed_dim, cfg.dtype
        self.cfg = cfg
        self.norm1_weight, self.norm1_bias = _norm_pair(e, device)
        self.Wqkv = nn.Linear(e, 3 * e, dtype=dt, device=device)
        self.out_proj = nn.Linear(e, e, dtype=dt, device=device)
        self.norm2_weight, self.norm2_bias = _norm_pair(e, device)
        hidden = int(e * cfg.mlp_ratio)
        self.fc1 = nn.Linear(e, hidden, dtype=dt, device=device)
        self.fc2 = nn.Linear(hidden, e, dtype=dt, device=device)

    def forward(self, x):
        cfg = self.cfg
        b, s, e = x.shape
        h = cfg.num_heads
        y = layer_norm(x, self.norm1_weight, self.norm1_bias,
                       cfg.layer_norm_eps)
        # q, k, v are strided views of the fused projection (b, s, 3, h, d)
        q, k, v = self.Wqkv(y).unflatten(-1, (3, h, e // h)).unbind(2)
        attn = flash_attn_func(q, k, v, causal=False)
        x = x + self.out_proj(attn.reshape(b, s, e))
        y = layer_norm(x, self.norm2_weight, self.norm2_bias,
                       cfg.layer_norm_eps)
        return x + self.fc2(F.gelu(self.fc1(y), approximate="none"))


class VisionTransformer(nn.Module):
    def __init__(self, config: ViTConfig, device=None):
        """``device`` defaults to the CUDA card and raises without one;
        ``device="cpu"`` runs the attention kernel's plain version."""
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        e, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.in_chans, e, p, stride=p,
                                     dtype=cfg.dtype, device=device)
        n = (cfg.img_size // p) ** 2 + int(cfg.use_cls_token)
        self.cls_token = (nn.Parameter(torch.zeros(
            1, 1, e, dtype=torch.float32, device=device))
            if cfg.use_cls_token else None)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, e, dtype=torch.float32,
                                                  device=device))
        self.blocks = nn.ModuleList(ViTBlock(cfg, device)
                                    for _ in range(cfg.depth))
        self.norm_weight, self.norm_bias = _norm_pair(e, device)
        self.head = nn.Linear(e, cfg.num_classes, dtype=torch.float32,
                              device=device)

    def forward(self, images):
        """images (b, H, W, C) -> logits (b, num_classes) fp32."""
        cfg = self.config
        b = images.shape[0]
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)          # (b, patches, e), row-major
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(b, 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(x, self.norm_weight, self.norm_bias, cfg.layer_norm_eps)
        if cfg.global_pool == "token" and cfg.use_cls_token:
            feat = x[:, 0]
        else:  # "avg": the mean over patch tokens (cls excluded, timm's)
            feat = x[:, int(cfg.use_cls_token):].mean(dim=1)
        return self.head(feat.float())

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` with flax's default scales:
        Dense and convolution kernels N(0, 1/fan_in), biases and the cls
        token 0, positions N(0, 0.02^2), norms 1 and 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                   generator=generator)
                mod.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for name, p in self.named_parameters():
            if "norm" in name or name == "cls_token":
                p.fill_(1.0 if name.endswith("weight") else 0.0)


def vit_config_from_hf(hf_config, num_classes: int,
                       dtype=torch.float32) -> ViTConfig:
    return ViTConfig(
        img_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        in_chans=hf_config.num_channels,
        embed_dim=hf_config.hidden_size,
        depth=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        mlp_ratio=hf_config.intermediate_size / hf_config.hidden_size,
        num_classes=num_classes,
        use_cls_token=True,
        layer_norm_eps=hf_config.layer_norm_eps,
        dtype=dtype,
    )


def remap_state_dict_hf_vit(state_dict: Dict[str, torch.Tensor],
                            cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """HF ViTForImageClassification state dict -> this model's. torch Conv
    and Linear weights keep their layouts; query, key and value are
    concatenated into Wqkv."""
    sd = state_dict
    emb = "vit.embeddings."
    out = {"cls_token": sd[emb + "cls_token"],
           "pos_embed": sd[emb + "position_embeddings"],
           "patch_embed.weight": sd[emb + "patch_embeddings.projection.weight"],
           "patch_embed.bias": sd[emb + "patch_embeddings.projection.bias"],
           "norm_weight": sd["vit.layernorm.weight"],
           "norm_bias": sd["vit.layernorm.bias"],
           "head.weight": sd["classifier.weight"],
           "head.bias": sd["classifier.bias"]}
    for i in range(cfg.depth):
        src, dst = f"vit.encoder.layer.{i}.", f"blocks.{i}."
        attn = src + "attention.attention."
        for part in ("weight", "bias"):
            out[dst + f"Wqkv.{part}"] = torch.cat(
                [sd[attn + f"{p}.{part}"] for p in ("query", "key", "value")])
            for ours, theirs in (("out_proj", "attention.output.dense"),
                                 ("fc1", "intermediate.dense"),
                                 ("fc2", "output.dense")):
                out[dst + f"{ours}.{part}"] = sd[src + f"{theirs}.{part}"]
            out[dst + f"norm1_{part}"] = sd[src + f"layernorm_before.{part}"]
            out[dst + f"norm2_{part}"] = sd[src + f"layernorm_after.{part}"]
    return out


def jax_param_arrays(model: VisionTransformer, params):
    """The arrays of a flax VisionTransformer param tree (nested dicts of
    numpy arrays) by the names of ``model.named_parameters()``, in torch
    layouts (Dense kernels (in, out) -> (out, in); the convolution's (kh,
    kw, in, out) -> (out, in, kh, kw)). Raises if the two do not name the
    same parameters."""
    out = {"pos_embed": params["pos_embed"],
           "patch_embed.weight":
           params["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
           "patch_embed.bias": params["patch_embed"]["bias"],
           "norm_weight": params["norm_weight"],
           "norm_bias": params["norm_bias"],
           "head.weight": params["head"]["kernel"].T,
           "head.bias": params["head"]["bias"]}
    if "cls_token" in params:
        out["cls_token"] = params["cls_token"]
    for i in range(model.config.depth):
        bp = params[f"blocks_{i}"]
        for name in ("Wqkv", "out_proj", "fc1", "fc2"):
            out[f"blocks.{i}.{name}.weight"] = bp[name]["kernel"].T
            out[f"blocks.{i}.{name}.bias"] = bp[name]["bias"]
        for name in ("norm1_weight", "norm1_bias", "norm2_weight",
                     "norm2_bias"):
            out[f"blocks.{i}.{name}"] = bp[name]
    names = {name for name, _ in model.named_parameters()}
    if names != set(out):
        raise ValueError(f"param tree and model differ: {names ^ set(out)}")
    return out


@torch.no_grad()
def load_jax_params(model: VisionTransformer, params) -> VisionTransformer:
    """Fill ``model`` from a flax VisionTransformer param tree of numpy
    arrays; values are cast to each parameter's type."""
    named = dict(model.named_parameters())
    for name, arr in jax_param_arrays(model, params).items():
        named[name].copy_(torch.from_numpy(arr.copy()).to(named[name].dtype))
    return model
