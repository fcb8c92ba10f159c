"""Model family: configs, the PyTorch Llama, checkpoint loading, tokenizers."""

from .config import CONFIGS, ModelConfig, config_from_hf_json, get_config
from .llama import (
    KVCache,
    PagedView,
    forward,
    init_kv_cache,
    init_params,
    params_from_jax,
    params_to,
)
from .loader import (
    convert_hf_state_dict,
    load_checkpoint,
    resolve_checkpoint_dir,
)
from .quant import (
    QTensor,
    dequantize,
    param_bytes,
    quantize_array,
    quantize_params,
)
from .tokenizer import (
    BaseTokenizer,
    ByteTokenizer,
    HFTokenizer,
    load_tokenizer,
    parse_tool_call_text,
)

__all__ = [
    "CONFIGS",
    "ModelConfig",
    "config_from_hf_json",
    "get_config",
    "KVCache",
    "PagedView",
    "forward",
    "init_kv_cache",
    "init_params",
    "params_from_jax",
    "params_to",
    "convert_hf_state_dict",
    "load_checkpoint",
    "resolve_checkpoint_dir",
    "QTensor",
    "dequantize",
    "param_bytes",
    "quantize_array",
    "quantize_params",
    "BaseTokenizer",
    "ByteTokenizer",
    "HFTokenizer",
    "load_tokenizer",
    "parse_tool_call_text",
]
