"""Draft-free speculative decoding: host-side n-gram prompt-lookup proposer.

Copied from kafka_tpu/runtime/speculative.py (pure Python); the port's
verify step is InferenceEngine._try_dispatch_verify, whose attention runs
the K+1-query paged verify kernel (K3, csrc/paged_verify.cu).

Decode is memory-bandwidth-bound — every step streams the full
weights to advance each lane ONE token.  Speculative decoding (Leviathan et
al., 2023) amortizes one weight-stream over several tokens: propose a run
of K candidate tokens, verify all of them (plus the bonus token after the
last accepted one) in ONE [B, K+1]-query device dispatch, keep the longest
prefix the model itself would have produced.

The proposer here is *draft-free* prompt lookup (Saxena, 2023): the agent
workload this framework serves echoes file contents, JSON tool results and
code spans back into the generation, so candidate runs come for free from a
suffix match over the lane's OWN token history — no draft model, no extra
HBM residency, and no change to the continuous-batching step
(non-proposing lanes ride the same verify dispatch masked down to
ordinary 1-token decode).

Acceptance rule (engine._verify): the verify step samples every
position with the SAME per-(seed, position) key the sequential decode path
uses, and accepts candidates exactly while `sample == candidate`.  The
emitted tokens are therefore *literally the sequential path's samples* —
greedy output is bit-identical and sampled output follows the target
distribution at any temperature by construction (this is the exact-match
special case of Leviathan rejection sampling for a point-mass draft).

This module is pure host-side bookkeeping: the rolling n-gram index and the
per-lane acceptance EWMA that throttles proposing for lanes where
speculation is losing (adaptive K).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# Largest/smallest suffix n-gram the proposer anchors on.  Longer anchors
# first: a 3-token match is far more predictive than a 2-token match in
# byte/token streams, and both lookups are O(1) dict probes.
NGRAM_MAX = 3
NGRAM_MIN = 2

# Adaptive-K throttle: once the acceptance EWMA (accepted/proposed per
# verify round) falls below the floor, the lane reverts to plain decode and
# re-probes after PROBE_TOKENS more drained tokens (repetition often comes
# in phases: a tool-echo span follows free prose).
ACCEPT_FLOOR = 0.2
ACCEPT_EWMA_ALPHA = 0.3
PROBE_TOKENS = 64

# Prompt indexing is AMORTIZED: construction/propose index at most this
# many tokens per call, so admitting a 100k-token prompt never stalls the
# single engine worker thread (eager indexing measured ~4us/token — ~0.4s
# of frozen token emission for every in-flight stream per long admission).
# A warming lane simply rides plain decode until its index catches up.
INDEX_BUDGET = 2048


class LaneSpeculator:
    """Per-lane n-gram index + acceptance controller.

    Single-writer (the engine thread).  `hist` mirrors the lane's token
    stream — prompt at construction, then one `push()` per DRAINED output
    token — so `propose()` always anchors on a fully-known tail (the
    engine only proposes for lanes with no in-flight dispatches).
    """

    __slots__ = ("hist", "_index", "_indexed", "accept_ewma", "_probe_at",
                 "proposed", "accepted")

    def __init__(self, prompt_ids: Sequence[int]):
        self.hist: List[int] = [int(t) for t in prompt_ids]
        # n-gram -> FIRST continuation position (the token index right
        # after the n-gram's earliest occurrence — the classic prompt-
        # lookup anchor).  Earliest beats most-recent for run length: on a
        # periodic tail the most recent occurrence is one step back and
        # offers a 1-token continuation, while the first offers the whole
        # repeated span.  A cheap rolling index: each position inserts
        # NGRAM_MAX-NGRAM_MIN+1 small-tuple keys at most once each, fed
        # INDEX_BUDGET tokens at a time (amortized over propose calls) so
        # a long prompt never stalls the engine thread at submit.  Memory
        # is ~2 dict entries per history token, bounded by the attention
        # window the lane itself is bounded by.
        self._index: Dict[Tuple[int, ...], int] = {}
        self._indexed = 0  # hist prefix the index covers
        self.accept_ewma = 1.0  # optimistic: every lane gets a first shot
        self._probe_at: Optional[int] = None  # hist len gating a re-probe
        self.proposed = 0
        self.accepted = 0

    def push(self, token: int) -> None:
        self.hist.append(token)
        self._catch_up()

    def _catch_up(self, budget: int = INDEX_BUDGET) -> bool:
        """Index up to `budget` more history tokens; True when the index
        covers the whole history (a drained lane is usually 1 behind)."""
        hist = self.hist
        end = self._indexed
        stop = min(len(hist), end + budget)
        index = self._index
        while end < stop:
            end += 1
            for n in range(NGRAM_MIN, NGRAM_MAX + 1):
                if end >= n:
                    index.setdefault(tuple(hist[end - n:end]), end)
        self._indexed = end
        return end == len(hist)

    def _continuation_at(self) -> Optional[int]:
        """Position right after the EARLIEST occurrence of the current
        suffix (None = no earlier occurrence).  Longest anchor wins."""
        hist = self.hist
        end = len(hist)
        for n in range(NGRAM_MAX, NGRAM_MIN - 1, -1):
            if end < n:
                continue
            pos = self._index.get(tuple(hist[end - n:end]))
            # pos == end means the only occurrence is the suffix itself
            if pos is not None and pos < end:
                return pos
        return None

    def propose(self, k_max: int) -> List[int]:
        """Candidate continuation of up to k_max tokens ([] = don't
        speculate this lane this round)."""
        if k_max <= 0:
            return []
        if not self._catch_up():
            # long prompt still being indexed (amortized): plain decode
            # until the index covers the whole history — an anchor over a
            # partial index could miss the earliest occurrence
            return []
        if self.accept_ewma < ACCEPT_FLOOR:
            # throttled: speculation has been losing on this lane — plain
            # decode until the periodic re-probe
            if self._probe_at is None or len(self.hist) < self._probe_at:
                return []
        pos = self._continuation_at()
        if pos is None:
            return []
        return self.hist[pos:pos + k_max]

    def observe(self, accepted: int, proposed: int) -> None:
        """Account one drained verify round (proposed >= 1)."""
        self.proposed += proposed
        self.accepted += accepted
        rate = accepted / proposed
        self.accept_ewma = (
            (1 - ACCEPT_EWMA_ALPHA) * self.accept_ewma
            + ACCEPT_EWMA_ALPHA * rate
        )
        if self.accept_ewma < ACCEPT_FLOOR:
            self._probe_at = len(self.hist) + PROBE_TOKENS
        else:
            self._probe_at = None
