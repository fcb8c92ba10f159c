"""Batched token sampling for the decode step.

Counterpart of kafka_tpu/ops/sampling.py: per-row temperature / top-k /
top-p, greedy as the temperature <= 0 limit.  Greedy is exact (argmax of
the same logits).  A sampled row draws with the JAX engine's own key,
fold_in(key(seed), position) (kafka_tpu/runtime/engine.py), reproduced
bit for bit on the device: threefry-2x32 in int64 tensors masked to 32
bits, jax.random.bits' counter layout, uniform's bits-to-float step and
gumbel's -log(-log(u)).  So a request's draws depend only on its seed and
position (reproducible under preemption, re-batching and speculation),
and equal JAX's tokens except where two perturbed scores tie within the
two libraries' log rounding.  Nothing reads back from the device, so the
sampler runs inside a captured CUDA graph.  `grammar_allowed_mask` /
`grammar_advance` are the on-device grammar FSM's mask and step
(kafka_tpu/ops/sampling.py:132-187): gathers over the compiled tables
(llm/constrained.py), plain PyTorch on device tensors — the JAX package
has no kernel for them either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


# ---------------------------------------------------------------------------
# the per-(seed, position) draw: JAX's threefry-2x32, bit for bit
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# f32 finfo.tiny: jax.random.gumbel's uniform draw starts there
_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2), as jax._src.prng's unrolled lowering computes it.  All
    four are int64 tensors holding uint32 values (broadcastable); every
    sum is masked back to 32 bits, so nothing overflows.  Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ (((x[1] << r) & _M32) | (x[1] >> (32 - r)))
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def fold_in_keys(seeds: torch.Tensor, positions: torch.Tensor):
    """Per-row keys `jax.random.fold_in(jax.random.key(seed), position)`
    for [N] integer tensors (seeds taken as uint32, as the JAX engine
    holds them; positions as the uint32 of an int32).  key(seed) is the
    pair (0, seed); fold_in hashes the counter pair (0, position)."""
    s = seeds.long() & _M32
    zero = torch.zeros_like(s)
    return threefry2x32(zero, s, zero, positions.long() & _M32)


def random_bits(keys, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` for each row's key: [N, n]
    int64 holding the uint32 draws.  With jax_threefry_partitionable (the
    JAX default) element i hashes the counter pair (0, i) and the two
    output words are xor-ed."""
    k1, k2 = keys
    dev = k1.device
    lo = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None],
                          torch.zeros(1, 1, dtype=torch.int64, device=dev), lo)
    return b1 ^ b2


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.gumbel (mode "low") of float32 from uniform bits: the
    top 23 bits as a mantissa in [1, 2), minus 1, lifted to [tiny, 1),
    then -log(-log(u))."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_tokens_per_slot(
    logits: torch.Tensor,
    params: SamplingParams,
    seeds,
    positions,
    allowed_mask: Optional[torch.Tensor] = None,
    *,
    sampled: Optional[bool] = None,
    filtered: Optional[bool] = None,
) -> torch.Tensor:
    """One token per row: [B, V] float32 logits -> [B] int64.

    Row i draws with the key fold_in(key(seeds[i]), positions[i]) — the
    JAX engine's per-(seed, position) key — as jax.random.categorical
    does: argmax of the filtered, temperature-scaled logits plus the
    key's Gumbel field.  seeds/positions: [B] integer tensors on the
    logits' device (host sequences are converted).  allowed_mask [B, V]
    bool excludes tokens first; an all-False row falls back to
    unconstrained.

    sampled / filtered: whether any row samples (temperature > 0) and
    whether any sampled row filters (top_k > 0 or top_p < 1).  The
    engine passes them from the lanes' host parameters, so the call
    reads nothing back from the device and can be captured in a CUDA
    graph; None derives them from `params` (a device read).  Like the
    reference's lax.cond, they only skip work: a greedy row is the
    argmax and an unfiltered row's logits pass the filter unchanged."""
    dev = logits.device
    if sampled is None:
        sampled = bool((params.temperature > 0.0).any())
    if filtered is None:
        filtered = bool(((params.temperature > 0.0)
                         & ((params.top_k > 0) | (params.top_p < 1.0))).any())
    if allowed_mask is not None:
        usable = allowed_mask.any(dim=-1, keepdim=True)
        mask = torch.where(usable, allowed_mask,
                           torch.ones_like(allowed_mask))
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    scaled = logits / params.temperature.clamp_min(1e-6)[:, None]
    if filtered:
        scaled = _filtered(scaled, params)
    seeds = torch.as_tensor(seeds, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    noise = gumbel_from_bits(random_bits(fold_in_keys(seeds, positions),
                                         logits.shape[-1]))
    drawn = torch.argmax(noise + scaled, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, drawn)
