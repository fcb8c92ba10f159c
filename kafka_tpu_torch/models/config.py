"""Model configurations for the Llama family served by the CUDA engine.

Counterpart of kafka_tpu/models/config.py with torch dtypes.  A model name
resolves to an architecture config; widths follow the published Llama and
Mixtral checkpoints' config.json files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from .vision import VisionConfig

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (Llama-style decoder-only transformer)."""

    name: str = "tiny"
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 16
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_context: int = 8192
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"
    # Llama-3.x rope scaling (NTK-by-parts). None disables.
    rope_scaling_factor: Optional[float] = None
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # Paged attention: "plain" (page gather + ops.attention.causal_attention)
    # or "kernel" (ops.kernels: the hand-written CUDA kernels on CUDA
    # tensors, their plain versions on CPU tensors).  Engines resolve
    # EngineConfig.attention_backend="auto" to "kernel"; plain forward()
    # callers keep the gather path by default.
    attention_backend: str = "plain"
    # Mixture-of-experts MLP (Mixtral-style): 0 = dense.  When > 0 each
    # layer's MLP is num_experts stacked SwiGLU experts with top-k routing
    # (softmax over the top-k router logits, models/llama.py _moe_block);
    # expert weights shard over the "ep" axis of a rank group
    # (parallel/sharding.py).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Vision input (Llava-style soft prompt, models/vision.py): a ViT +
    # projector encodes images into num_patches embeddings that replace
    # `image_token_id` placeholder positions at prefill.  None = text-only
    # (image parts answer a typed 400 at the provider).
    vision: Optional[VisionConfig] = None
    image_token_id: Optional[int] = None

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# Registry of named configs. Sizes follow the published Llama architectures;
# "tiny"/"tiny-gqa" keep the CPU tests fast.
CONFIGS = {
    "tiny": ModelConfig(),
    "tiny-gqa": ModelConfig(name="tiny-gqa", num_heads=8, num_kv_heads=2,
                            hidden_size=128, head_dim=16),
    "debug-290m": ModelConfig(
        name="debug-290m",
        vocab_size=32000,
        hidden_size=1024,
        intermediate_size=2816,
        num_layers=12,
        num_heads=16,
        num_kv_heads=4,
        head_dim=64,
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        max_context=131072,
        tie_word_embeddings=True,
        rope_scaling_factor=32.0,
    ),
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=28,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        max_context=131072,
        tie_word_embeddings=True,
        rope_scaling_factor=32.0,
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_context=8192,
        tie_word_embeddings=False,
    ),
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_context=131072,
        tie_word_embeddings=False,
        rope_scaling_factor=8.0,
    ),
    "tiny-moe": ModelConfig(
        name="tiny-moe", num_heads=8, num_kv_heads=2, hidden_size=128,
        head_dim=16, num_experts=4, num_experts_per_tok=2,
    ),
    # Mixtral 8x7B (HF mistralai/Mixtral-8x7B-v0.1 config.json): experts
    # shard over "ep", attention and each expert's FFN over "tp"
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        max_context=32768,
        tie_word_embeddings=False,
        num_experts=8,
        num_experts_per_tok=2,
    ),
    # Llava-class tiny vision model for tests: byte tokenizer vocab (262)
    # + 1 reserved image-placeholder id (JAX models/config.py "tiny-vision")
    "tiny-vision": ModelConfig(
        name="tiny-vision", vocab_size=263, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, vision=VisionConfig(), image_token_id=262,
    ),
    "llama-3-70b": ModelConfig(
        name="llama-3-70b",
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_context=8192,
        tie_word_embeddings=False,
    ),
}


def get_config(name: str) -> ModelConfig:
    """Resolve a model name (case/sep-insensitive) to a config."""
    key = name.lower().replace("_", "-").replace("meta-llama/", "")
    aliases = {
        "llama-3.2-1b-instruct": "llama-3.2-1b",
        "llama-3.2-3b-instruct": "llama-3.2-3b",
        "llama-3-8b-instruct": "llama-3-8b",
        "llama-3.1-8b-instruct": "llama-3.1-8b",
        "llama-3-70b-instruct": "llama-3-70b",
        "meta-llama-3-8b": "llama-3-8b",
    }
    key = aliases.get(key, key)
    if key not in CONFIGS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[key]


def config_from_hf_json(path: str) -> ModelConfig:
    """Build a ModelConfig from a HuggingFace config.json."""
    with open(path) as f:
        hf = json.load(f)
    rs = hf.get("rope_scaling") or {}
    # the checkpoint's own precision ("dtype" since transformers 4.56+,
    # "torch_dtype" before); fp16 checkpoints run as bf16 (same width, and
    # bf16's exponent range is what the f32-accumulating kernels assume)
    dtype = {"float32": "float32", "bfloat16": "bfloat16",
             "float16": "bfloat16"}.get(
        hf.get("dtype", hf.get("torch_dtype")), "bfloat16"
    )
    return ModelConfig(
        dtype=dtype,
        # MoE (HF Mixtral config keys); absent -> 0 = dense
        num_experts=hf.get("num_local_experts", 0) or 0,
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        name=os.path.basename(os.path.dirname(os.path.abspath(path))),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim",
                        hf["hidden_size"] // hf["num_attention_heads"]),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_context=hf.get("max_position_embeddings", 8192),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        rope_scaling_factor=rs.get("factor"),
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_position=rs.get(
            "original_max_position_embeddings", 8192),
    )
