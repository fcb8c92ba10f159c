"""Logit-level quality evidence for int8 weight quantization.

Counterpart of kafka_tpu/models/quant_quality.py, over the port's
`forward`.  Random weights give near-tied logits, so greedy agreement
between a bf16 model and its int8 twin says little: one tiny perturbation
flips a near-tie.  What bounds served quality is the logit error:

* ``max_abs_dlogit`` — the largest perturbation int8 applies to any
  logit.  A greedy choice can only flip where the dense model's top-1
  margin is below 2x this number.
* ``kl_mean`` / ``kl_p99`` — KL(dense || int8) of the next-token
  distributions, position-averaged and tail.
* ``flip_rate`` + ``flip_margin_max`` — how often argmax flips, and the
  largest dense margin at which a flip was seen.  The analytic bound
  ``flip_margin_max <= 2 * max_abs_dlogit`` holds for any model: flips
  stay inside the near-tie band.
* ``margin_p50`` — the dense model's own top-1 margin, which says how much
  of its output sits inside that band.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .config import ModelConfig
from .llama import forward


@torch.no_grad()
def _all_position_logits(cfg: ModelConfig, params: Any,
                         token_ids: Sequence[int],
                         device: torch.device) -> torch.Tensor:
    """[S, V] f32 logits for every position of one prompt (no cache)."""
    ids = torch.tensor([list(token_ids)], dtype=torch.long, device=device)
    positions = torch.arange(ids.shape[1], device=device)[None]
    logits, _ = forward(params, cfg, ids, positions)
    return logits[0].float()


def logit_quality_metrics(
    cfg: ModelConfig,
    params_dense: Any,
    params_quant: Any,
    prompts: Sequence[Sequence[int]],
) -> Dict[str, float]:
    """Compare dense vs quantized next-token logits over every position
    of every prompt.  Returns JSON-ready floats."""
    device = params_dense["final_norm"].device
    dmax = flips = total = 0.0
    kl_list: List[np.ndarray] = []
    flip_margins: List[float] = []
    margins: List[np.ndarray] = []
    for p in prompts:
        ld = _all_position_logits(cfg, params_dense, p, device)  # [S, V]
        lq = _all_position_logits(cfg, params_quant, p, device)
        dmax = max(dmax, float((ld - lq).abs().max()))
        logp = torch.log_softmax(ld, dim=-1)
        logq = torch.log_softmax(lq, dim=-1)
        kl = (logp.exp() * (logp - logq)).sum(dim=-1)  # [S]
        kl_list.append(kl.cpu().numpy())
        top2 = torch.topk(ld, 2, dim=-1).values           # [S, 2]
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        margins.append(margin)
        flipped = (ld.argmax(-1) != lq.argmax(-1)).cpu().numpy()
        flips += float(flipped.sum())
        total += float(len(flipped))
        flip_margins.extend(margin[flipped].tolist())
    kl_arr = np.concatenate(kl_list)
    margin_arr = np.concatenate(margins)
    return {
        "max_abs_dlogit": round(dmax, 5),
        "kl_mean": round(float(kl_arr.mean()), 6),
        "kl_p99": round(float(np.percentile(kl_arr, 99)), 6),
        "flip_rate": round(flips / total, 4),
        "flip_margin_max": round(max(flip_margins), 5) if flip_margins else 0.0,
        "margin_p50": round(float(np.median(margin_arr)), 4),
        "positions": int(total),
    }
