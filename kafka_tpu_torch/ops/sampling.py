"""Batched token sampling for the decode step.

Counterpart of kafka_tpu/ops/sampling.py: per-row temperature / top-k /
top-p, greedy as the temperature <= 0 limit.  Greedy is exact (argmax of
the same logits).  A sampled row draws from a `torch.Generator` seeded
from (seed, position), so a request's draws depend only on its own seed
and position — reproducible under preemption and re-batching, the JAX
package's per-(seed, position) contract (kafka_tpu/runtime/engine.py,
fold_in(key(seed), position)).  The bits differ from JAX's threefry, so
sampled streams are held to determinism within the port, not to JAX's
tokens.  `grammar_allowed_mask` / `grammar_advance` are the on-device
grammar FSM's mask and step (kafka_tpu/ops/sampling.py:132-187): gathers
over the compiled tables (llm/constrained.py), plain PyTorch on device
tensors — the JAX package has no kernel for them either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .attention import NEG_INF


@dataclasses.dataclass
class SamplingParams:
    """Per-sequence sampling state, batched [B]."""

    temperature: torch.Tensor  # [B] float32; <=0 means greedy
    top_k: torch.Tensor        # [B] int64; 0 disables
    top_p: torch.Tensor        # [B] float32; 1.0 disables

    @classmethod
    def make(cls, batch: int, temperature=0.0, top_k=0, top_p=1.0,
             device=None) -> "SamplingParams":
        return cls(
            temperature=torch.full((batch,), float(temperature),
                                   dtype=torch.float32, device=device),
            top_k=torch.full((batch,), int(top_k), dtype=torch.int64,
                             device=device),
            top_p=torch.full((batch,), float(top_p), dtype=torch.float32,
                             device=device),
        )


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask logits below the per-row k-th largest. top_k==0 disables."""
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.long().clamp(1, vocab)
    thresh = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    keep = (logits >= thresh) | (top_k[:, None] == 0)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose mass before each kept token is < top_p (the top
    token always survives). top_p>=1 disables."""
    order = torch.argsort(logits, dim=-1, descending=True, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    keep = keep | (top_p[:, None] >= 1.0)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def _filtered(scaled: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Sequential top-k -> top-p over ONE shared descending sort (the JAX
    package's _filtered_logits): top-p renormalizes over the top-k
    survivors."""
    order = torch.argsort(scaled, dim=-1, descending=True, stable=True)
    sorted_desc = torch.gather(scaled, -1, order)
    vocab = scaled.shape[-1]
    rank = torch.arange(vocab, device=scaled.device)[None, :]
    k = params.top_k.long().clamp(1, vocab)[:, None]
    keep_sorted = (rank < k) | (params.top_k[:, None] == 0)
    probs = torch.softmax(
        torch.where(keep_sorted, sorted_desc,
                    torch.full_like(sorted_desc, NEG_INF)), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < params.top_p[:, None]
    keep_p[:, 0] = True
    keep_p = keep_p | (params.top_p[:, None] >= 1.0)
    keep_sorted = keep_sorted & keep_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))


def draw_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed from (request seed, position): splitmix64
    of the pair, so neighbouring positions give unrelated streams."""
    z = ((seed & 0xFFFFFFFF) << 32 | (position & 0xFFFFFFFF)) \
        + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def grammar_allowed_mask(
    fsm_state: torch.Tensor,
    fsm_g: torch.Tensor,
    budget_left: torch.Tensor,
    active: torch.Tensor,
    token_class: torch.Tensor,
    trans: torch.Tensor,
    dist: torch.Tensor,
    wrap_slack: torch.Tensor,
) -> torch.Tensor:
    """[B, V] bool allowed mask from per-lane device FSM states.

    fsm_state [B] (-1 = unconstrained lane), fsm_g [B] grammar index,
    budget_left [B] remaining token budget, active [B] bool, token_class
    [G, V], trans [S, C] (-1 illegal), dist [S] shortest tokens-to-done,
    wrap_slack [] (all int tensors on one device).  Constrained lanes
    within `wrap_slack` tokens of their shortest close restrict to
    distance-decreasing transitions (on-device wrap-up) so a bounded
    generation still parses; a wrap window with no such move degrades to
    the legal set.  Unconstrained and inactive lanes get all-True rows,
    which leave the sampler's logits bit-identical to an unmasked call.
    """
    S = trans.shape[0]
    on = (fsm_state >= 0) & active
    s = fsm_state.long().clamp(0, S - 1)
    row = trans.index_select(0, s)                       # [B, C]
    legal = row >= 0
    nd = dist[row.long().clamp(0, S - 1)]                # [B, C]
    d = dist.index_select(0, s)[:, None]                 # [B, 1]
    wrap = budget_left[:, None] <= d + wrap_slack
    keep = legal & (~wrap | (nd < d))
    keep = torch.where(keep.any(dim=-1, keepdim=True), keep, legal)
    tc = token_class.index_select(0, fsm_g.long())       # [B, V]
    mask = torch.take_along_dim(keep, tc.long(), dim=1)  # [B, V]
    return torch.where(on[:, None], mask, torch.ones_like(mask))


def grammar_advance(
    fsm_state: torch.Tensor,
    fsm_g: torch.Tensor,
    tokens: torch.Tensor,
    active: torch.Tensor,
    token_class: torch.Tensor,
    trans: torch.Tensor,
) -> torch.Tensor:
    """Advance each lane's FSM state by one sampled token ([B]).  Inactive
    and unconstrained lanes keep their state; an illegal token (reachable
    only through the over-tight degrade path) parks the lane at the -1
    unconstrained sentinel instead of indexing garbage."""
    S = trans.shape[0]
    on = (fsm_state >= 0) & active
    tc = token_class.index_select(0, fsm_g.long())       # [B, V]
    cls = torch.take_along_dim(tc, tokens.long()[:, None], dim=1)[:, 0]
    nxt = trans[fsm_state.long().clamp(0, S - 1), cls.long()]
    return torch.where(on, nxt, fsm_state)


def sample_tokens_per_slot(
    logits: torch.Tensor,
    params: SamplingParams,
    seeds: Sequence[int],
    positions: Sequence[int],
    allowed_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One token per row: [B, V] float32 logits -> [B] int64.

    seeds/positions: per-row host ints — row i draws from a generator
    seeded with draw_seed(seeds[i], positions[i]) (Gumbel-max over the
    filtered, temperature-scaled logits).  allowed_mask [B, V] bool
    excludes tokens first; an all-False row falls back to unconstrained.
    """
    if allowed_mask is not None:
        usable = allowed_mask.any(dim=-1, keepdim=True)
        mask = torch.where(usable, allowed_mask,
                           torch.ones_like(allowed_mask))
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    greedy = torch.argmax(logits, dim=-1)
    sampled_rows = [i for i, t in enumerate(params.temperature.tolist())
                    if t > 0.0]
    if not sampled_rows:
        return greedy
    temp = params.temperature.clamp_min(1e-6)[:, None]
    scaled = logits / temp
    needs_filter = bool((
        (params.temperature > 0.0)
        & ((params.top_k > 0) | (params.top_p < 1.0))
    ).any())
    if needs_filter:
        scaled = _filtered(scaled, params)
    out = greedy.clone()
    vocab = logits.shape[-1]
    for i in sampled_rows:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(draw_seed(int(seeds[i]), int(positions[i])))
        u = torch.rand(vocab, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        out[i] = torch.argmax(scaled[i] + gumbel)
    return out
