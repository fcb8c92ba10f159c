"""Expert parallelism: a MoE MLP's experts over the "ep" axis of a rank
group.

Counterpart of kafka_tpu/parallel/expert.py.  The design is the
reference's, the standard inference shape for few experts:

* experts are stacked [E, ...]; rank e of the ep axis holds experts
  [e*E/ep, (e+1)*E/ep);
* tokens stay replicated and the router too, so every rank routes alike;
  each rank computes its experts' contribution for every token (dense
  dispatch: the routing weights are zero for tokens routed elsewhere)
  from its slice of the [T, E] weights, and an all-reduce sums the ranks'
  partial outputs.

This is the capacity-unlimited formulation: exact, and no token
permutation.  Routing is models/llama.py's `_routing_weights`, and the
expert math its `_experts`, so the served model and this module cannot
drift.  The served model runs the same split inside `_moe_block`
(forward(..., tp=...) with parallel/tp.py's collectives).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from ..models.llama import _experts, _routing_weights

Params = Dict[str, torch.Tensor]


def init_moe_params(generator: torch.Generator, num_experts: int,
                    hidden: int, ffn: int, dtype=torch.float32,
                    device=None) -> Params:
    """[E, ...]-stacked SwiGLU experts and their router, normal *
    fan_in^-0.5."""

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    return {
        "router": norm((hidden, num_experts), hidden),
        "wg": norm((num_experts, hidden, ffn), hidden),
        "wu": norm((num_experts, hidden, ffn), hidden),
        "wd": norm((num_experts, ffn, hidden), ffn),
    }


def moe_mlp_reference(x: torch.Tensor, params: Params,
                      top_k: int = 2) -> torch.Tensor:
    """Dense single-device reference: x [T, H] -> [T, H]."""
    w = _routing_weights(x, params["router"], top_k)  # [T, E]
    return _experts(x, params.__getitem__, w)


def shard_moe_params(params: Params, ep: int, index: int) -> Params:
    """Rank `index` of the ep axis: the router whole, experts
    [index*E/ep, (index+1)*E/ep)."""
    n = params["wg"].shape[0]
    if n % ep:
        raise ValueError(f"num_experts={n} not divisible by ep={ep}")
    lo, hi = index * n // ep, (index + 1) * n // ep
    return {k: (v if k == "router" else v[lo:hi].contiguous())
            for k, v in params.items()}


def moe_mlp_sharded(x: torch.Tensor, params: Params, group: Any, ep: int,
                    index: int, top_k: int = 2) -> torch.Tensor:
    """One rank's expert-sharded MoE MLP over a process group of the ep
    ranks (`group`; this rank is `index`), given its shard
    (shard_moe_params); every rank returns the reference's [T, H]."""
    w = _routing_weights(x, params["router"], top_k)  # [T, E] global
    e_local = params["wg"].shape[0]
    w_local = w[:, index * e_local:(index + 1) * e_local]
    out = _experts(x, params.__getitem__, w_local)
    if ep > 1:
        dist.all_reduce(out, group=group)
    return out
