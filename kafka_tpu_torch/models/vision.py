"""Vision encoder: ViT + projector for image inputs (Llava-style).

Counterpart of kafka_tpu/models/vision.py.  Images enter the decoder as a
soft prompt: a ViT encodes each image into `num_patches` vectors, a
two-layer projector maps them into the decoder's hidden width, and they
replace the embeddings of `image_token_id` placeholder positions at
prefill (models/llama.py forward's `embed_override`).  After the
substitution they are ordinary token positions, so the paged KV pool,
chunked prefill and every attention kernel (K2 for the prompt, K1 / K4
for the decode after it) run on image tokens unchanged.

The tower is small (the reference's default: 32x32 images, 16 patches,
width 64) and runs once per image turn, so it is written as plain
matmuls in the reference's formulation: the scores are formed in f32
(JAX `preferred_element_type`), the softmax in f32 and cast back, and
the GELU is the tanh approximation (`jax.nn.gelu`'s default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.norms import rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """ViT hyperparameters.  Frozen and hashable: it rides inside the
    frozen ModelConfig."""

    image_size: int = 32
    patch_size: int = 8
    hidden_size: int = 64       # ViT width
    num_layers: int = 2
    num_heads: int = 4
    mlp_ratio: int = 4
    projector_hidden: int = 128  # Llava-style 2-layer MLP projector

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def vision_init_params(vcfg: VisionConfig, text_hidden: int,
                       generator: torch.Generator,
                       dtype: torch.dtype = torch.float32,
                       device: Optional[torch.device] = None) -> Params:
    """Random-init tower and projector (normal * fan_in^-0.5, the
    reference's recipe; the position table is scaled by 0.02).  Draws are
    made on `generator`'s device."""
    d, L = vcfg.hidden_size, vcfg.num_layers
    m = vcfg.mlp_ratio * d

    def norm01(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "ln1": ones((L, d)),
        "ln2": ones((L, d)),
        "wqkv": norm01((L, d, 3 * d), d),
        "wo": norm01((L, d, d), d),
        "w1": norm01((L, d, m), d),
        "w2": norm01((L, m, d), m),
    }
    return {
        "patch_embed": norm01((vcfg.patch_dim, d), vcfg.patch_dim),
        "pos_embed": norm01((vcfg.num_patches, d), d) * 0.02,
        "final_ln": ones((d,)),
        "layers": layers,
        "proj_w1": norm01((d, vcfg.projector_hidden), d),
        "proj_w2": norm01((vcfg.projector_hidden, text_hidden),
                          vcfg.projector_hidden),
    }


def vision_params_from_jax(np_params: Mapping[str, Any], dtype=None,
                           device=None) -> Params:
    """The port's tower from `kafka_tpu.models.vision.vision_init_params`'
    pytree converted to numpy arrays (the layouts are identical)."""
    from .llama import params_from_jax

    return params_from_jax(np_params, dtype=dtype, device=device)


def patchify(vcfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] float (0..1) -> [N, num_patches, patch_dim]."""
    n, s = pixels.shape[0], pixels.shape[1]
    p = vcfg.patch_size
    g = s // p
    x = pixels.reshape(n, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * g, p * p * 3)


def encode_images(params: Params, vcfg: VisionConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] float (0..1) -> [N, num_patches, text_hidden], in the
    tower's dtype.  Pre-LN ViT with full (non-causal) attention over the
    patches."""
    dt = params["patch_embed"].dtype
    x = patchify(vcfg, pixels.to(params["patch_embed"].device)).to(dt)
    x = x @ params["patch_embed"] + params["pos_embed"][None]
    nh = vcfg.num_heads
    hd = vcfg.hidden_size // nh
    layers = params["layers"]
    for l in range(vcfg.num_layers):
        h = rms_norm(x, layers["ln1"][l])
        q, k, v = (h @ layers["wqkv"][l]).chunk(3, dim=-1)
        n, p, _ = q.shape
        q = q.reshape(n, p, nh, hd).transpose(1, 2)  # [N, nh, P, hd]
        k = k.reshape(n, p, nh, hd).transpose(1, 2)
        v = v.reshape(n, p, nh, hd).transpose(1, 2)
        s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        a = torch.softmax(s, dim=-1).to(dt)
        o = (a @ v).transpose(1, 2).reshape(n, p, -1)
        x = x + o @ layers["wo"][l]
        h = rms_norm(x, layers["ln2"][l])
        h = F.gelu(h @ layers["w1"][l], approximate="tanh")
        x = x + h @ layers["w2"][l]
    x = rms_norm(x, params["final_ln"])
    h = F.gelu(x @ params["proj_w1"], approximate="tanh")
    return h @ params["proj_w2"]
