"""Int8 weight-only quantization for the serving matmuls.

Counterpart of kafka_tpu/models/quant.py (dense and MoE models).
Symmetric per-output-channel int8: each quantized leaf becomes a
`QTensor(q=int8, s=f32 scale)` whose scale broadcasts over the
contraction axes, so `q.to(dt) * s` reconstructs the weight.  A MoE
model's expert stacks [L, E, H, F] / [L, E, F, H] contract axis 2: one
scale per (layer, expert, output channel); its router stays dense.  The same
recipe quantizes the int8 paged KV pool's rows (models/llama.py
_kv_write, one scale per slot).

The numerics are the JAX package's, so both packages hold byte-equal
codes for the same weights:

    s = max(amax, 1e-8) / 127            (f32)
    q = clip(round(w_f32 / s), -127, 127) (a division, round half to even)
    dequantize: (q * s).to(dt)            (the product in f32, rounded once)

The matmuls dequantize at each use site (models/llama.py `_w`) and run
`torch.matmul` on the dense weight; on the card that materialises the
layer's weight in the activation dtype for each matmul (PERF.md) — for a
MoE layer, a whole expert stack at a time (runtime/planner.py charges
that working set).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import torch

Params = Dict[str, Any]


class QTensor(NamedTuple):
    """Symmetric per-channel int8 tensor: `q.to(dt) * s` dequantizes."""

    q: torch.Tensor  # int8, the original shape
    s: torch.Tensor  # float32, broadcastable (contraction dims = 1)


def quantize_array(w: torch.Tensor, contract_axes: Sequence[int]) -> QTensor:
    """Per-output-channel symmetric int8 over the given contraction axes."""
    axes = tuple(a % w.dim() for a in contract_axes)
    w32 = w.float()
    amax = w32.abs().amax(dim=axes, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def dequantize(w: Any, dtype: torch.dtype) -> Any:
    """QTensor -> dense in `dtype` (the scale stays f32 in the product,
    which rounds once); anything else is returned as it is.

    JAX writes `(q.astype(dt) * s).astype(dt)`; int8 -> dt is exact for
    |q| <= 127, so promoting the int8 codes straight to f32 in the product
    gives the same values with one pass fewer over the weight (eager
    PyTorch does not fuse the cast into the multiply)."""
    if isinstance(w, QTensor):
        return (w.q * w.s).to(dtype)
    return w


# Contraction axes per layer-stacked weight (models/llama.py layouts).
# Axis 0 is the layer stack; scales are per (layer, output channel).
_CONTRACT = {
    "wq": (1,),        # [L, H, hq, d]   contract H
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),      # [L, hq, d, H]   contract hq, d
    "wg": (1,),        # [L, H, F]       contract H
    "wu": (1,),
    "wd": (1,),        # [L, F, H]       contract F
}
_CONTRACT_MOE = {
    "wg": (2,),        # [L, E, H, F]    contract H
    "wu": (2,),
    "wd": (2,),        # [L, E, F, H]    contract F
}


def quantize_params(params: Params, cfg=None) -> Params:
    """Quantize the serving matmul weights of a Llama/Mixtral parameter
    tree.

    embed is quantized per row ([V, H], contract H): the row gather
    dequantizes per looked-up token, and a tied LM head streams the same
    int8 table.  Norms and the MoE router stay dense.  A MoE tree is
    known by its router; `cfg` is accepted for the JAX signature's
    sake."""
    layers = dict(params["layers"])
    contract = ({**_CONTRACT, **_CONTRACT_MOE} if "router" in layers
                else _CONTRACT)
    for name, axes in contract.items():
        if name in layers:
            layers[name] = quantize_array(layers[name], axes)
    out: Params = {
        "embed": quantize_array(params["embed"], (1,)),
        "final_norm": params["final_norm"],
        "layers": layers,
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_array(params["lm_head"], (0,))  # [H, V]
    return out


def _leaves(params: Params):
    for k, v in params.items():
        if k == "layers":
            yield from _leaves(v)
        elif isinstance(v, QTensor):
            yield v.q
            yield v.s
        else:
            yield v


def param_bytes(params: Params) -> int:
    """Stored bytes (int8 codes + scales, or dense weights): the decode
    step's weight traffic."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))
