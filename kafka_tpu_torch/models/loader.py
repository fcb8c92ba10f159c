"""Checkpoint loading: HuggingFace Llama / Mixtral safetensors -> the
port's params.

Counterpart of kafka_tpu/models/loader.py for a local safetensors
directory.  HF stores projections as [out, in] per layer; they are
transposed to [in, out] and stacked on a leading layer axis — the same
layout as the JAX package (models/llama.py docstring).  A Mixtral
checkpoint (config.json's num_local_experts) keeps its MLP under
block_sparse_moe: the router `gate` [E, H] and experts.{e}.w1/w3/w2
(gate/up/down), stacked to [L, E, H, F] / [L, E, F, H].
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .config import ModelConfig, config_from_hf_json
from .llama import Params


def _to_tensor(t: Any) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(t)))


def convert_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig,
                          dtype=None, device=None) -> Params:
    """Convert an HF Llama or Mixtral state dict (torch tensors or numpy
    arrays) to the layer-stacked parameter dict."""
    dtype = dtype or cfg.activation_dtype
    h, d = cfg.hidden_size, cfg.head_dim
    hq, hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def get(name: str) -> torch.Tensor:
        key = name if name in state else f"model.{name}"
        if key not in state:
            raise KeyError(f"missing weight {name!r} (tried {key!r})")
        return _to_tensor(state[key])

    def stack(fmt: str,
              reshape: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        return torch.stack([
            reshape(get(fmt.format(i=i))).to(dtype) for i in range(L)
        ]).contiguous().to(device)

    layers = {
        "ln_attn": stack("layers.{i}.input_layernorm.weight", lambda w: w),
        "ln_mlp": stack("layers.{i}.post_attention_layernorm.weight",
                        lambda w: w),
        "wq": stack("layers.{i}.self_attn.q_proj.weight",
                    lambda w: w.t().reshape(h, hq, d)),
        "wk": stack("layers.{i}.self_attn.k_proj.weight",
                    lambda w: w.t().reshape(h, hkv, d)),
        "wv": stack("layers.{i}.self_attn.v_proj.weight",
                    lambda w: w.t().reshape(h, hkv, d)),
        "wo": stack("layers.{i}.self_attn.o_proj.weight",
                    lambda w: w.t().reshape(hq, d, h)),
    }
    if cfg.is_moe:
        # HF Mixtral: block_sparse_moe.gate [E, H] is the router;
        # experts.{e}.w1/w3/w2 = gate/up/down [F, H] / [F, H] / [H, F]
        E = cfg.num_experts

        def stack_experts(wname: str) -> torch.Tensor:
            return torch.stack([torch.stack([
                get(f"layers.{i}.block_sparse_moe.experts.{e}."
                    f"{wname}.weight").t().to(dtype) for e in range(E)
            ]) for i in range(L)]).contiguous().to(device)

        layers["router"] = stack("layers.{i}.block_sparse_moe.gate.weight",
                                 lambda w: w.t())
        layers["wg"] = stack_experts("w1")
        layers["wu"] = stack_experts("w3")
        layers["wd"] = stack_experts("w2")
    else:
        layers["wg"] = stack("layers.{i}.mlp.gate_proj.weight",
                             lambda w: w.t())
        layers["wu"] = stack("layers.{i}.mlp.up_proj.weight",
                             lambda w: w.t())
        layers["wd"] = stack("layers.{i}.mlp.down_proj.weight",
                             lambda w: w.t())
    params: Params = {
        "embed": get("embed_tokens.weight").to(dtype).contiguous().to(device),
        "final_norm": get("norm.weight").to(dtype).to(device),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        head = state.get("lm_head.weight")
        if head is None:
            raise KeyError(
                "config says untied embeddings but lm_head.weight missing")
        params["lm_head"] = _to_tensor(head).t().to(dtype).contiguous().to(
            device)
    return params


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Load all tensors from a directory of .safetensors shards."""
    from safetensors.torch import load_file

    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(load_file(f))
    return tensors


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None,
                    device=None) -> tuple:
    """Load (cfg, params) from a local HF checkpoint directory (a
    Mixtral config.json gives a MoE config, models/config.py)."""
    if cfg is None:
        cfg = config_from_hf_json(os.path.join(path, "config.json"))
    state = load_safetensors_dir(path)
    return cfg, convert_hf_state_dict(state, cfg, device=device)


def resolve_checkpoint_dir(model_name: str) -> Optional[str]:
    """A local checkpoint directory for a model name, if one exists
    (kafka_tpu/models/loader.py's lookup).  Searched in order:
    $KAFKA_TORCH_CKPT_DIR/<name>, ./checkpoints/<name>, then the HF cache
    ($HF_HOME, default ~/.cache/huggingface).  A directory counts only
    when it holds a *.safetensors file.  Nothing is downloaded: None
    means the model runs with random weights."""
    candidates = []
    env_dir = os.environ.get("KAFKA_TORCH_CKPT_DIR")
    if env_dir:
        candidates.append(os.path.join(env_dir, model_name))
    candidates.append(os.path.join("checkpoints", model_name))
    hf_cache = os.path.expanduser(
        os.environ.get("HF_HOME", "~/.cache/huggingface"))
    candidates.extend(glob.glob(os.path.join(
        hf_cache, "hub", f"models--*{model_name}*", "snapshots", "*")))
    for c in candidates:
        if os.path.isdir(c) and glob.glob(os.path.join(c, "*.safetensors")):
            return c
    return None
