"""The CUDA inference engine: continuous batching over a paged KV pool.

Counterpart of kafka_tpu/runtime/engine.py, main-path slice.  The
scheduler keeps the JAX engine's semantics:

* `submit` queues a request (bounded by `max_waiting` -> AdmissionError);
* each `step()` checks deadlines, drains matured token fetches, admits
  waiting requests into free batch slots when their prompt's pages fit,
  advances the oldest prefilling lanes one chunk each, then dispatches one
  decode for every active lane;
* a prompt longer than the largest bucket prefills in chunks, one chunk
  per step, interleaved with the decode batch;
* several unconstrained admissions that share a bucket prefill together
  in one batched dispatch (plain attention, as in the JAX package); a
  lone admission, a constrained one and any bucket over 128 on the kernel
  backend take the single-sequence prefill, which runs the flash prefill
  kernel (K2);
* decode runs the paged decode kernel (K1) for every layer — over an
  int8 KV pool (`kv_quantize="int8"`) the int8 paged decode kernel (K4),
  while every prefill chunk and verify step reads that pool through the
  dequantizing page gather, as the JAX package does;
* off-slot admission (`max_parked`): with every slot busy, waiting
  requests prefill and sample their first token without a slot, then
  wait PARKED for one; page pressure rolls parked lanes back before it
  preempts an active one;
* a request with a `prefix_key` (the serving layer passes the thread id)
  attaches the longest whole-page prefix the radix prefix cache holds
  (runtime/prefix_cache.py) before the admission page gate, and its
  prefill starts at the first uncached token (`cached_tokens`); a
  finished request stores its materialized tokens' pages into the cache
  before they go back to the pool, and page pressure evicts cache leaves
  before it preempts a live request;
* with `speculative_k > 0` each lane's n-gram proposer
  (runtime/speculative.py) may offer up to K candidate tokens once its
  history is drained; one [B, K+1]-query forward — the paged verify
  kernel (K3) — checks them all, every position is sampled with the
  sequential path's own (seed, position) draw, and acceptance runs on the
  device, so the stream is the one plain decode would give;
* a request with a `logits_mask_fn` (llm/constrained.ToolCallMaskFn, the
  provider's tool_choice mask) is constrained: with its compiled
  `grammar` (the same automaton lowered to a token DFA) the lane carries
  a device FSM state that masks and advances inside the decode and verify
  steps (`grammar_allowed_mask` / `grammar_advance`) and rides every
  dispatch, fused ones included; without one, or when the grammar cannot
  register or its replay stops validating, the lane takes the host mask
  path: a [V] row from `logits_mask_fn(output_ids)` per token, dispatched
  as its own micro-batch once its previous token has been fetched;
* when the pool runs out of pages mid-decode the pipeline is drained,
  parked lanes roll back, then the youngest request is rolled back to the
  waiting queue (re-prefilled later over prompt + generated-so-far; its
  resumed prefill's token is the deterministic duplicate and is dropped);
* with a KV tier (`kv_host_tier_mb`, `kv_disk_tier_dir`,
  `kv_object_dir`; runtime/kv_tier.py, object_tier.py) prefix-cache
  eviction demotes a run to pinned host memory (its gather enqueued
  before the pages return to the pool) instead of dropping it, and a
  lookup crossing it promotes it back into fresh pages, in place, ahead
  of the suffix prefill (`cache_source="host_tier"`); the host tier spills
  to disk and archives to a shared object store, from which
  `sleep_to_object` drains every thread and a fresh engine wakes it
  (`cache_source="object_tier"`); with `agent_demote` a thread that left
  for a tool call (`note_tool_gap`) is demoted once `agent_linger_s`
  passes without its return (`note_tool_return`);
* a `background` request (tool-result prefill) queues on `waiting_bg`,
  admits only into idle capacity outside the park reserve, yields its
  prefill chunks to interactive ones (shrunk to the smallest bucket
  while interactive lanes decode) and is the first preemption victim;
* for the DP router (runtime/dp_router.py): `take_waiting` / `adopt`
  move queued requests between replicas, a `handoff` request ends at its
  first token with its run stored in the radix cache and parked on
  `handoffs` for the router to ship, and `spec_k_cap` lets the
  autoscaler's ladder pause speculation;
* `recover_from_failure` rebuilds a servable engine after a step fault
  (the `engine.step` and `engine.prefill` failpoints inject one);
* with `mesh` (a parallel.MeshConfig of tp, tq or ep > 1, or a RankGroup)
  the engine is rank 0 of a rank group (kafka_tpu/runtime/
  engine.py:639-850): every rank holds its shard of the weights (at ep, a
  MoE model's experts of its ep slice) and of the pool, and every method
  that touches device state is `replicated`: rank 0 sends it, with its
  host inputs, to the other ranks, and each runs it in the same order
  (prefill chunks, control uploads, decode graph captures and replays,
  verify steps, FSM and grammar tables, recovery).  Sampling is replicated,
  so the next token is on every card with no broadcast; only rank 0
  fetches to the host, and its host waits run under the group's guard: a
  dead rank fails every request with "error:distributed" (the group cannot
  serve again);
* a request carrying a trace (`GenRequest.trace`, tracing.py) gets
  engine.queue, engine.prefill and emit spans, and an engine.decode span
  each time one of its fetches lands.

The decode pipeline is the JAX engine's, in PyTorch's idiom.  The decode
batch's control state lives on the device in fixed tensors (page table,
last tokens, lengths, sampling parameters, seeds, FSM states), updated in
place and re-uploaded from one pinned staging buffer only when scheduling
changes it; each step derives its write slots, validity mask and
positions there.  One step body — forward, mask, sample, FSM advance,
`seq_lens += run`, `last = toks` — runs unrolled `k` times: on CUDA it is
captured once per (k, fsm, sampling mode, host mask, kept logits) into a
`torch.cuda.CUDAGraph` (all graphs share one memory pool) and every decode
is a replay, `multi_step=1` included; on CPU tensors the same function
runs eagerly.  A busy, stable batch (>= 3 lanes, no host-masked lane, no
prefill in progress, every budget and window >= k) dispatches `multi_step`
steps at once (`_pick_multi_step`), as the reference's lax.scan does.
Sampled tokens reach the host through a FIFO of asynchronous copies
(`_Fetch`: pinned host memory, `non_blocking`, a `torch.cuda.Event`), at
most `fetch_lag` steps deep and popped by age (`fetch_wait_s`, ~RTT for a
lone stream) once landed; a stop token found in flight retires the lane
and the tokens dispatched after it are dropped.  Prefill and verify run
eagerly.  A host-masked lane (a mask fn without a compiled grammar)
dispatches the tokens its grammar forces without waiting for the
previous token to land (singleton-mask chaining, `predicted`); only its
genuine choice points wait for a round trip.

A vision model's requests carry `override_pos` / `override_rows`: the
image rows replace the embeddings of their placeholder positions in
whichever prefill chunk holds them (`_chunk_override`).

Telemetry is the reference's (runtime/metrics.py, flight_recorder.py,
planner.py, compile_log.py, kernel_profiler.py): `self.metrics` records
every request and dispatch at the reference's sites with the planner's
modeled flop/byte cost per dispatch; `self.flight` keeps the
per-iteration ring (KAFKA_TORCH_FLIGHT_RING, 0 = off) and dumps a
postmortem when a step fails; `self.memory_monitor` samples the caching
allocator at ~1 Hz; `self.kernel_sampler` (KAFKA_TORCH_PROFILE_SAMPLE)
profiles every Nth step; each graph capture is a compile-observatory
record.  A dispatch's measured device time, and its busy time in the
MFU and bandwidth figures, come on CUDA from timing events around it on
the stream, read when its fetch lands (the host runs up to fetch_lag
steps ahead, so the reference's enqueue-to-enqueue gaps undercount the
device: fault C8); on the CPU from the reference's rules (fetch
maturation; the gap to the next dispatch).  No telemetry call runs
inside the step body or a captured region: a host call there would run
only at capture.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..failpoints import failpoint
from ..models.config import ModelConfig
from ..models.llama import KVCache, PagedView, forward, params_to
from ..ops.kernels.common import chunk_plan
from ..ops.kernels.paged_decode import CHUNK_TOKENS as DECODE_CHUNK
from ..ops.kernels.paged_decode_int8 import CHUNK_TOKENS as DECODE_INT8_CHUNK
from ..ops.kernels.paged_verify import CHUNK_TOKENS as VERIFY_CHUNK
from ..ops.sampling import (
    SamplingParams,
    grammar_advance,
    grammar_allowed_mask,
    sample_tokens_per_slot,
)
from ..tracing import add_event, annotate, record_span
from . import compile_log, kernel_profiler
from .flight_recorder import (
    KIND_DECODE,
    KIND_MULTI,
    KIND_VERIFY,
    FlightRecorder,
    ring_default,
)
from .kv_cache import (
    OutOfPagesError,
    PagePool,
    SequencePages,
    TRASH_PAGE,
    make_kv_pool_arrays,
    page_table_array,
)
from .metrics import AGENT_METRIC_KEYS, EngineMetrics
from .planner import MemoryMonitor
from .prefix_cache import PrefixCache
from .speculative import LaneSpeculator

logger = logging.getLogger("kafka_tpu_torch.engine")

WAITING, PREFILLING, ACTIVE, PARKED, DRAINING, FINISHED = (
    "waiting", "prefilling", "active", "parked", "draining", "finished")

# Held while an engine captures a decode-step graph.  A process-wide
# capture forbids CUDA calls from other threads, so work that another
# thread launches on the card (the provider's vision tower) takes it too.
capture_lock = threading.Lock()

# Agent-gap scheduling knobs.
AGENT_DEMOTE_ENV = "KAFKA_TORCH_AGENT_DEMOTE"
AGENT_LINGER_ENV = "KAFKA_TORCH_AGENT_LINGER_MS"


def agent_demote_default() -> str:
    """KAFKA_TORCH_AGENT_DEMOTE -> "" (off) | "host" | "object".  "1"/"on"
    mean host — the tier ladder's first rung; "object" additionally
    archives the gap-demoted chain + sleep manifest.  Nonsense = off."""
    raw = (os.environ.get(AGENT_DEMOTE_ENV) or "").strip().lower()
    if raw in ("1", "on", "true", "host"):
        return "host"
    if raw == "object":
        return "object"
    return ""


def agent_linger_default() -> float:
    """KAFKA_TORCH_AGENT_LINGER_MS -> seconds (default 250 ms): how long a
    tool-call gap lingers before the thread's KV demotes.  Sub-linger
    tools never pay the round trip."""
    raw = os.environ.get(AGENT_LINGER_ENV)
    try:
        ms = float(raw) if raw not in (None, "") else 250.0
    except ValueError:
        ms = 250.0
    return max(0.0, ms) / 1e3


# a dispatch's sampling work, from its lanes' host parameters: argmax only,
# the Gumbel draw, or the draw over top-k / top-p filtered logits
GREEDY, SAMPLED, FILTERED = 0, 1, 2


class AdmissionError(RuntimeError):
    """submit() rejected a request because the waiting queue is at its
    configured bound (EngineConfig.max_waiting).  Carries a Retry-After
    estimate so the serving layer can answer HTTP 429."""

    def __init__(self, depth: int, limit: int, retry_after_s: float):
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"waiting queue full ({depth}/{limit}); retry in "
            f"~{retry_after_s:.0f}s")


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 256
    max_pages_per_seq: int = 16  # attention window = this * page_size
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    max_new_tokens_default: int = 512
    # In-flight decode STEPS tolerated in the fetch pipeline before the
    # host force-pops the oldest entry (a fused k-step dispatch counts k).
    # 0 pops every entry in the step that dispatched it.
    fetch_lag: int = 96
    # Also pop a fetch once it has been in flight this long (seconds) and
    # its copy has landed; with <= 2 active lanes the bound tightens to
    # ~1.25x the measured device->host round trip (_emit_wait).
    fetch_wait_s: float = 0.15
    # Decode steps fused into one dispatch (one k-step CUDA graph) when
    # the batch is busy and stable (_pick_multi_step): >= 3 active lanes,
    # no host-masked lane, no prefill in progress, every lane's budget and
    # window >= k.  1 disables fusion.
    multi_step: int = 16
    # Off-slot admission: with every decode slot busy, up to this many
    # waiting requests prefill and emit their first token without a slot
    # ("parked"), then join the decode batch as slots free.  Parked lanes
    # pin their pages, so parking is page-gated (park_reserve_pages stay
    # free) and rolled back under page pressure before any active lane is
    # preempted.  0 disables.
    max_parked: int = 64
    # Pool pages kept free of parked pinning (headroom for active lanes'
    # decode growth).  None -> 2 * max_batch.
    park_reserve_pages: Optional[int] = None
    # "kernel": the hand-written kernels (ops/kernels) — launched on CUDA
    # tensors, their plain versions on CPU tensors; refused on CUDA for a
    # model or window the kernels cannot take (kernel_backend_problems).
    # "plain": the page gather + plain attention everywhere.  "auto" (the
    # reference's rule): "kernel" where the kernels take the model,
    # otherwise "plain", logged with the reasons
    # (resolve_attention_backend).
    attention_backend: str = "auto"
    # Request lifecycle bounds (None = disabled): max_ttft_s times out a
    # request still waiting for its FIRST token; max_total_s bounds total
    # wall time from submit.  Both finish with finish_reason="timeout".
    max_ttft_s: Optional[float] = None
    max_total_s: Optional[float] = None
    # Admission backpressure: submit() raises AdmissionError once the
    # waiting queue holds this many requests (0 = unbounded).
    max_waiting: int = 0
    # Diagnostic: keep each request's sampled-row logits (float32, host)
    # on GenRequest.logits.  The chip smoke compares engines with it.
    keep_logits: bool = False
    # Radix prefix cache (runtime/prefix_cache.py): cross-thread KV reuse
    # over the refcounted pool, for requests that carry a prefix_key.
    # prefix_cache_entries is the on/off knob (0 disables; any positive
    # value enables); prefix_cache_pages bounds the pages the cache may
    # retain (None = bounded only by pool pressure via reclaim; 0
    # disables).
    prefix_cache_entries: int = 64
    prefix_cache_pages: Optional[int] = None
    # Draft-free speculative decoding (runtime/speculative.py): up to K
    # n-gram candidates per lane verified in one [B, K+1]-query forward.
    # 0 (the default) disables it: no proposer is built and decode is the
    # plain path.  Greedy output equals plain decode token for token, and
    # sampled output is plain decode's own draws at any temperature.
    speculative_k: int = 0
    # KV-cache quantization: "" (the kv dtype) or "int8" — int8 rows with
    # one f32 scale per slot (runtime/kv_cache.py), half the window bytes.
    # Decode runs the int8 paged decode kernel (K4); prefill chunks and
    # verify steps read through the dequantizing page gather, as in the
    # JAX package (which has no int8 prefill or verify kernel).
    kv_quantize: str = ""
    # Scheduler flight recorder (runtime/flight_recorder.py): ring of
    # this many per-iteration records; 0 disables it (every hook site is
    # one branch).  Default KAFKA_TORCH_FLIGHT_RING, else 256.
    flight_ring: int = dataclasses.field(default_factory=ring_default)
    # Tiered KV cache (runtime/kv_tier.py): a host-RAM page tier of this
    # many MiB under the pool.  When > 0, prefix-cache eviction DEMOTES
    # page runs into pinned host memory (async D2H) instead of dropping
    # them, and a lookup hit against a demoted run PROMOTES it back (H2D
    # + in-place scatter ahead of the suffix prefill).  0 disables the
    # tier: no manager is built.  KAFKA_TORCH_KV_HOST_TIER_MB via the
    # serving config.
    kv_host_tier_mb: int = 0
    # Spill directory below the host tier (KAFKA_TORCH_KV_DISK_TIER_DIR):
    # host-budget overflow spills page runs to disk (second-chance LRU)
    # instead of dropping them.  None/"" = drop on host-tier overflow.
    kv_disk_tier_dir: Optional[str] = None
    # Object-store KV tier (KAFKA_TORCH_KV_OBJECT_DIR; runtime/
    # object_tier.py): a SHARED store below host+disk that makes thread
    # state portable — runs the local ladder would drop archive there
    # content-addressed, per-thread sleep manifests let a dormant thread
    # wake on any engine sharing the store (cache_source="object_tier"),
    # and POST /admin/drain/0 flushes the engine's warm state.  A local
    # directory or an http(s):// S3-shaped endpoint.  None/"" disables.
    kv_object_dir: Optional[str] = None
    # Byte budget (MiB) on the object-store references this engine holds
    # (second-chance LRU).  0 = unbounded.  KAFKA_TORCH_KV_OBJECT_MB.
    kv_object_mb: int = 0
    # Agent tool-call gaps: a lane that finishes into a tool call (the
    # provider signals note_tool_gap on finish_reason=tool_calls) has its
    # thread's KV demoted down the tier ladder after agent_linger_s
    # without a return.  "" disables (note_tool_gap / note_tool_return
    # are no-ops); "host" demotes into the host/disk tier; "object" also
    # archives the chain + sleep manifest.  Needs the prefix cache and
    # the KV tier.
    agent_demote: str = dataclasses.field(
        default_factory=agent_demote_default)
    agent_linger_s: float = dataclasses.field(
        default_factory=agent_linger_default)

    @property
    def max_window(self) -> int:
        return self.max_pages_per_seq * self.page_size


@dataclasses.dataclass
class GenRequest:
    """One generation request moving through the scheduler."""

    request_id: str
    prompt_ids: List[int]
    # None -> EngineConfig.max_new_tokens_default is applied at submit()
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    # per-request deadline overrides (seconds from submit)
    deadline_ttft_s: Optional[float] = None
    deadline_s: Optional[float] = None
    # engine bookkeeping
    state: str = WAITING
    slot: int = -1
    seq: Optional[SequencePages] = None
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    # tokens sampled on the device / processed on the host (emission lags
    # dispatch by up to fetch_lag steps)
    dispatched: int = 0
    drained: int = 0
    # True while re-entering after preemption: the resumed prefill's token
    # is the deterministic duplicate of output_ids[-1] and is dropped
    resumed: bool = False
    # token ids the next prefill must materialize (prompt, or prompt +
    # generated-so-far after a preemption)
    prefill_ids: List[int] = dataclasses.field(default_factory=list)
    # EngineConfig.keep_logits: the logits row each token was sampled from
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # KV prefix reuse: requests sharing cached token runs share their
    # pages and prefill only the rest.  The serving layer keys by thread.
    prefix_key: Optional[str] = None
    # radix-cache hit of the latest attach: tokens served from cached
    # pages, and "own" (this thread's earlier turn), "cross" (another
    # thread's shared prefix), "host_tier" (any part promoted from the
    # host/disk tier) or "object_tier" (any part woken from the object
    # store)
    cached_tokens: int = 0
    cache_source: Optional[str] = None
    # tokens of the hit promoted from the host/disk tier, and woken from
    # the object store (engine.prefill span attributes)
    promoted_tokens: int = 0
    object_tokens: int = 0
    # the FIRST admission's share, frozen when its prefill starts (usage
    # reports this: a preemption's re-attach is not client-saved compute)
    usage_cached_tokens: Optional[int] = None
    # n-gram proposer (EngineConfig.speculative_k > 0), built at submit.
    # spec_ahead > 0 while a verify dispatch for this lane is in flight:
    # the lane's host seq.length / dispatched are then confirmed-only (the
    # advance, 1..K+1 tokens, reconciles at drain) and the lane sits out
    # every dispatch until then
    spec: Optional[LaneSpeculator] = None
    spec_ahead: int = 0
    # constrained decoding: fn(output_ids) -> allowed token id list or None
    logits_mask_fn: Optional[Callable[[List[int]], Optional[List[int]]]] = None
    # the on-device grammar FSM (llm/constrained.CompiledGrammar) of the
    # same mask: the lane's automaton state is masked and advanced inside
    # the decode and verify steps.  logits_mask_fn stays attached as the
    # fallback: a grammar that cannot register or whose replay stops
    # validating degrades the lane to the host mask path.  None = host
    # mask path.
    grammar: Optional[Any] = None
    # over-tight mask rows log once per request (the counter counts all)
    overtight_logged: bool = False
    # singleton-mask chaining on the host mask path: tokens already
    # dispatched whose value the grammar forces (the mask fn's forced_id,
    # or an allowed list of one id), not yet drained.  The next mask
    # builds on output_ids + predicted, so a forced run of tool-call JSON
    # dispatches at scheduler cadence instead of one token per
    # device->host round trip
    predicted: List[int] = dataclasses.field(default_factory=list)
    # (position, _next_constraint result) memo: a lane blocked behind the
    # awaited fetch does not re-walk its mask fn every iteration
    mask_cache: Optional[Tuple[int, Tuple[str, Any]]] = None
    # genuine constrained choice points that awaited a device->host round
    # trip (forced tokens chain without one)
    constrained_roundtrips: int = 0
    # vision soft prompt (models/vision.py): projected image-patch rows
    # that replace the prompt's image_token_id placeholders at prefill.
    # The positions are absolute prompt positions, so chunked prefill, a
    # prefix-hit resume, a preemption's re-prefill and a router's hand-off
    # all recompute the same per-chunk slices.  None = text only
    override_pos: Optional[np.ndarray] = None   # [K] int32
    override_rows: Optional[np.ndarray] = None  # [K, H] float32
    # off-slot (parked) admission: True while the prefill's sampled token
    # waits on the device (engine._parked_toks, on every rank of a
    # tensor-parallel group) for a decode slot, where it seeds the lane's
    # last token at seating (None for resumed lanes: output_ids[-1] is
    # known)
    pending_tok: Optional[bool] = None
    # request tracing (tracing.py): the trace context this request
    # carries — None = untraced, and every engine span site is then one
    # branch.  t_prefill_start / t_first_dispatch stamp the first prefill
    # chunk and the last chunk's dispatch (engine.queue, engine.prefill,
    # emit); trace_last_t is when the lane's previous decode span ended
    trace: Optional[Any] = None
    trace_last_t: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_first_dispatch: Optional[float] = None
    # SLO verdict set at finalize (_finalize_slo): True met, False
    # missed, None excluded (a client cancel) or not finalized yet
    slo_met: Optional[bool] = None
    # disaggregated prefill/decode: a prefill-and-hand-off request ends
    # at its first token with its pages kept — the engine parks
    # (request, token) on `engine.handoffs` instead of emitting a terminal
    # event, and the DP router ships the page run to a decode replica and
    # requeues the request there (a preemption-style resume: the
    # re-prefill's token is the duplicate of the emitted first token and
    # is dropped).  Only the router sets it, and only for prefix-keyed
    # requests: the radix cache names the shipped run at the destination.
    handoff: bool = False
    # the background class: tool-result prefill and compaction.  Queued
    # on engine.waiting_bg, admitted only with no interactive request
    # waiting (and never into the park reserve), yields its prefill
    # chunks to any interactive prefill, is the first preemption victim,
    # and is exempt from the max_waiting bound (engine-internal work must
    # not 429 the client that caused it).
    background: bool = False


class _GrammarTables:
    """Device residency for registered CompiledGrammar artifacts
    (kafka_tpu/runtime/engine.py:520-628).

    All live grammars share ONE padded table set so a mixed batch takes a
    single mask/advance: per-grammar transition blocks are concatenated
    along the state axis (entries offset at registration, so a lane's
    absolute int32 state addresses the combined [S, C] array) and
    token-class rows stack into [G, V].  Registration is append-only —
    offsets never move, so in-flight lanes' device states stay valid
    across registrations; shapes grow geometrically, as in the reference.
    A full registry (MAX_LIVE), a vocab mismatch or a table set over the
    KAFKA_TORCH_GRAMMAR_TABLE_MB budget returns None and the request
    degrades to the host mask path.  The padded tables are fixed device
    buffers, refilled in place (stream-ordered behind the steps already
    dispatched) when a grammar registers; they are reallocated only when
    a padded size grows.  `version` counts reallocations: a captured step
    graph reads the buffers of its version, so only a growth recaptures.
    """

    MAX_LIVE = 8
    MIN_STATE_PAD = 256

    def __init__(self, vocab_size: int, device: torch.device):
        self.vocab_size = vocab_size
        self.device = device
        self.grammars: List[Any] = []
        self.offsets: List[int] = []
        self._total_states = 0
        self.version = 0
        # device tensors (padded); None until the first registration
        self.token_class: Optional[torch.Tensor] = None  # [G_pad, V] int32
        self.trans: Optional[torch.Tensor] = None        # [S_pad, C_pad]
        self.dist: Optional[torch.Tensor] = None         # [S_pad] int32
        self.slack: Optional[torch.Tensor] = None        # [] int32
        # how a rebuilt table set reaches the device: `write` here; the
        # engine routes it through every rank of a tensor-parallel group
        self.upload: Callable[..., None] = self.write

    def register(self, grammar) -> Optional[int]:
        """Index of `grammar` in the table set (registering if new); None
        when it cannot register."""
        from ..llm.constrained import _grammar_table_cap_bytes

        for i, g in enumerate(self.grammars):
            if g is grammar:
                return i
        if len(self.grammars) >= self.MAX_LIVE:
            return None
        if grammar.vocab_size != self.vocab_size:
            return None
        if self._padded_bytes(
            self._total_states + grammar.num_states,
            max([grammar.num_classes] + [g.num_classes
                                         for g in self.grammars]),
            len(self.grammars) + 1,
        ) > _grammar_table_cap_bytes():
            return None
        self.grammars.append(grammar)
        self.offsets.append(self._total_states)
        self._total_states += grammar.num_states
        self._rebuild()
        return len(self.grammars) - 1

    def _padded_bytes(self, total_states: int, max_classes: int,
                      n_grammars: int) -> int:
        """Device bytes of the padded table set for a prospective shape."""
        S_pad = self._pad(total_states, self.MIN_STATE_PAD)
        C_pad = self._pad(max_classes, 32)
        G_pad = self._pad(n_grammars, 1)
        return 4 * (G_pad * self.vocab_size + S_pad * C_pad + S_pad)

    @staticmethod
    def _pad(n: int, lo: int) -> int:
        p = lo
        while p < n:
            p *= 2
        return p

    def _rebuild(self) -> None:
        S_pad = self._pad(self._total_states, self.MIN_STATE_PAD)
        C_pad = self._pad(max(g.num_classes for g in self.grammars), 32)
        G_pad = self._pad(len(self.grammars), 1)
        tc = np.zeros((G_pad, self.vocab_size), np.int32)
        trans = np.full((S_pad, C_pad), -1, np.int32)
        # padded/unreachable states read as "far from done" so wrap-up
        # never engages on them
        dist = np.full(S_pad, 1 << 20, np.int32)
        for gi, (g, off) in enumerate(zip(self.grammars, self.offsets)):
            tc[gi] = g.token_class
            block = g.trans.copy()
            block[block >= 0] += off
            trans[off:off + g.num_states, : g.num_classes] = block
            dist[off:off + g.num_states] = g.dist
        # conservative across grammars: extra slack engages wrap earlier
        # but never breaks closure
        self.upload(tc, trans, dist, max(g.wrap_slack for g in self.grammars))

    def write(self, tc: np.ndarray, trans: np.ndarray, dist: np.ndarray,
              slack: int) -> None:
        """Refill the device tables, reallocating (a new `version`) only
        when a padded shape grew."""
        if self.token_class is None or \
                self.trans.shape != trans.shape or \
                self.token_class.shape != tc.shape:
            dev = self.device
            self.token_class = torch.empty(tc.shape, dtype=torch.int32,
                                           device=dev)
            self.trans = torch.empty(trans.shape, dtype=torch.int32,
                                     device=dev)
            self.dist = torch.empty(dist.shape, dtype=torch.int32, device=dev)
            self.slack = torch.empty((), dtype=torch.int32, device=dev)
            self.version += 1
        for buf, arr in ((self.token_class, tc), (self.trans, trans),
                         (self.dist, dist)):
            src = torch.from_numpy(arr)
            if buf.is_cuda:
                src = src.pin_memory()
            buf.copy_(src, non_blocking=True)
        self.slack.fill_(slack)

    def args(self) -> Tuple[torch.Tensor, ...]:
        """(token_class, trans, dist, slack): grammar_allowed_mask's
        table arguments."""
        return (self.token_class, self.trans, self.dist, self.slack)


@dataclasses.dataclass
class TokenEvent:
    """One emitted token (or terminal event) for a request."""

    request_id: str
    token_id: Optional[int]
    finished: bool = False
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class _SpecMeta:
    """Per-lane candidate widths of one verify dispatch: cand_lens[i] == 0
    marks a rider (an ordinary one-token decode, at-dispatch accounting),
    > 0 a proposer whose advance reconciles at drain."""

    cand_lens: List[int]
    width: int  # K + 1 sample columns per lane in the fetched array


@dataclasses.dataclass(eq=False)  # identity semantics (list.remove / `is`)
class _Fetch:
    """One in-flight sampled-token transfer awaiting host processing
    (kafka_tpu/runtime/engine.py _Fetch).

    `toks` is host memory the copy lands in: [steps, lanes] for a decode
    dispatch, [1, lanes] for a prefill, [B, K+2] for a verify (K+1 samples
    and the accepted count per lane).  `items[i]` is the request lane i
    belonged to at dispatch (None for idle lanes); `final[j][i]` marks a
    lane's last dispatched token (a host-known limit) with its reason.
    `event` (CUDA) completes when the copy has landed; None on the CPU,
    where the tokens are there at once.  `logits` holds the sampled rows
    (EngineConfig.keep_logits) shaped like `toks` plus a vocab axis."""

    toks: torch.Tensor
    items: List[Optional[GenRequest]]
    final: List[List[Optional[str]]]
    t0: float = 0.0  # dispatch time (fetch_wait_s aging)
    steps: int = 1
    # first time the copy was observed landed (_stamp_ready)
    t_ready: Optional[float] = None
    spec: Optional[_SpecMeta] = None
    event: Optional[Any] = None
    logits: Optional[torch.Tensor] = None
    # False for a prefill's first-token fetch (no engine.decode span)
    decode: bool = True
    # the utilization kind this dispatch bills to and its modeled
    # roofline seconds (None: no cost model or roofline), read when the
    # fetch lands to pair it with the measured device time
    kind: str = "decode"
    modeled_s: Optional[float] = None
    # CUDA: (start, end) timing events bracketing the dispatch's device
    # work on the stream (a prefill's: each of its chunks).  None on the
    # CPU.
    spans: Optional[List[Tuple[Any, Any]]] = None
    # CUDA: modeled dispatch costs charged to the registry when this
    # fetch lands, each (kind, tokens, flops, bytes, spans) with the
    # device seconds of its spans as busy time (_note_ready)
    costs: List[Tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _StepGraph:
    """A captured decode step program and the launches one replay makes
    of each kernel wrapper (captured calls tick the wrappers' counters
    once; a replay launches them again without Python)."""

    graph: Any
    launches: List[Tuple[Callable, int]]


_NP_DTYPE = {torch.int32: np.int32, torch.int64: np.int64,
             torch.float32: np.float32, torch.bool: np.bool_}


class _ControlState:
    """Fixed device tensors that are views of ONE device buffer, refreshed
    from one pinned host staging buffer with one non-blocking copy: the
    decode batch's host-authored control arrays.  A captured step graph
    reads the views; an upload never rebinds them."""

    def __init__(self, fields: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 device: torch.device):
        self.layout: Dict[str, Tuple[int, int, Tuple[int, ...],
                                     torch.dtype]] = {}
        off = 0
        for name, (shape, dtype) in fields.items():
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype
                                                  ).element_size()
            self.layout[name] = (off, n, shape, dtype)
            off += -(-n // 16) * 16  # every view 16-byte aligned
        self.buf = torch.zeros(off, dtype=torch.uint8, device=device)
        self.views = {
            name: self.buf[o:o + n].view(dtype).view(shape)
            for name, (o, n, shape, dtype) in self.layout.items()
        }

    def pack(self, arrays: Dict[str, Any]) -> np.ndarray:
        """The staging bytes for a full set of host arrays."""
        host = np.zeros(self.buf.numel(), np.uint8)
        for name, (o, n, shape, dtype) in self.layout.items():
            arr = np.ascontiguousarray(arrays[name], dtype=_NP_DTYPE[dtype])
            host[o:o + n] = arr.reshape(-1).view(np.uint8)
        return host


def kernel_backend_problems(cfg: ModelConfig, ecfg: EngineConfig,
                            mesh: Any = None) -> List[str]:
    """Why the CUDA attention kernels (K1-K4) cannot serve this model and
    engine configuration; empty when they can.  On CUDA, "auto" then
    resolves to "plain" with these as its reasons, and an explicit
    "kernel" is refused at construction (resolve_attention_backend).

    All four take bf16 models with head_dim 64 or 128 and <= 8 q heads per
    kv head, and K1, K3 and K4 a window whose chunks their merge can hold
    (ops/kernels/common.py).  K3 (paged verify) sets no bound on
    speculative_k: it holds any G * (speculative_k + 1) query rows of a kv
    head, so every speculative_k the window fits (checked at construction)
    is served, as in the reference engine.  On a tensor-parallel group
    (`mesh`) the kernels run per rank on local heads (ops/kernels/
    sharded.py): the split must pass kernel_mesh_ok (tensor_mesh_problems)."""
    problems = []
    g, d = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    if cfg.activation_dtype != torch.bfloat16 or d not in (64, 128) \
            or g > 8 or cfg.num_heads % cfg.num_kv_heads:
        problems.append(
            f"the CUDA attention kernels take bf16 models with head_dim 64 "
            f"or 128 and <= 8 q heads per kv head; {cfg.name} is "
            f"{cfg.dtype} D={d} G={g}")
    try:  # the smallest chunk makes the most chunks
        chunk_plan(ecfg.max_pages_per_seq, ecfg.page_size,
                   min(DECODE_CHUNK, DECODE_INT8_CHUNK, VERIFY_CHUNK))
    except ValueError as e:
        problems.append(str(e))
    return problems + tensor_mesh_problems(cfg, mesh)


def tensor_mesh_problems(cfg: ModelConfig, mesh: Any) -> List[str]:
    """Why the per-rank kernels cannot take this head split (the
    reference's pallas_mesh_ok rule); empty off a mesh.  At ep > 1 they
    never run: the rule admits only the tensor axes (tp * tq equal to the
    mesh's size, JAX ops/pallas/paged_attention.py:510-513), so "auto"
    resolves to the plain gather there, as the reference's does."""
    ep = getattr(mesh, "ep", 1) if mesh is not None else 1
    if mesh is None or mesh.tp * mesh.tq * ep <= 1:
        return []
    from ..ops.kernels.sharded import kernel_mesh_ok

    if kernel_mesh_ok(mesh, cfg.num_heads, cfg.num_kv_heads):
        return []
    if ep > 1:
        return [f"ep={ep}: the per-rank kernels take the tensor axes only "
                f"(tp*tq={mesh.tp * mesh.tq} is not the group's "
                f"{mesh.tp * mesh.tq * ep} ranks), so attention is the "
                "plain gather at ep > 1, as in the reference"]
    return [f"the per-rank kernels need tp | Hkv, tp*tq | Hq and one kv "
            f"head per rank when tq > 1; tp={mesh.tp} tq={mesh.tq} over "
            f"Hq={cfg.num_heads} Hkv={cfg.num_kv_heads}"]


def resolve_attention_backend(cfg: ModelConfig, ecfg: EngineConfig,
                              device_type: str, mesh: Any = None
                              ) -> Tuple[str, List[str]]:
    """EngineConfig.attention_backend resolved for a device type:
    (backend, reasons).  "auto" is "kernel" on the CPU (the wrappers run
    their plain versions on CPU tensors) and on CUDA where
    kernel_backend_problems is empty; otherwise "plain", with those
    problems as the reasons.  On a tensor-parallel group the head split
    counts on the CPU too (the plain versions share the kernels' q->kv
    map).  An explicit "kernel" with problems raises ValueError; "plain"
    stays "plain"."""
    choice = ecfg.attention_backend
    if choice not in ("auto", "kernel", "plain"):
        raise ValueError(
            f"attention_backend must be 'auto', 'kernel' or 'plain', got "
            f"{choice!r}")
    if choice == "plain":
        return "plain", []
    problems = (kernel_backend_problems(cfg, ecfg, mesh)
                if device_type == "cuda"
                else tensor_mesh_problems(cfg, mesh))
    if not problems:
        return "kernel", []
    if choice == "kernel":
        raise ValueError(
            "; ".join(problems) + " — use attention_backend='auto' or "
            "'plain'")
    return "plain", problems


def validate_tensor_parallel(cfg: ModelConfig, ecfg: EngineConfig,
                             mesh: Any) -> None:
    """The engine's rank-group checks (kafka_tpu/runtime/engine.py
    mesh validation, :669-684 for MoE): ep only on a MoE model whose
    experts it divides, no MoE at pp > 1, whole heads and MLP columns per
    rank, and nothing this port does not move across ranks.  Raises
    ValueError (naming the ROADMAP item where one ports it)."""
    ep = getattr(mesh, "ep", 1)
    if ep > 1:
        if not cfg.is_moe:
            raise ValueError(
                f"mesh has ep={ep} but {cfg.name!r} is dense: the ep axis "
                "shards MoE expert weights")
        if cfg.num_experts % ep:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by ep={ep}")
    if getattr(mesh, "pp", 1) > 1 and cfg.is_moe:
        raise ValueError(
            "pp stage sharding does not support MoE models: use ep x tp "
            "rank groups for Mixtral-class serving")
    n = mesh.tp * mesh.tq
    if cfg.num_heads % n or cfg.intermediate_size % n:
        raise ValueError(
            f"tp={mesh.tp} tq={mesh.tq}: {cfg.name}'s {cfg.num_heads} q "
            f"heads and {cfg.intermediate_size} MLP columns must split {n} "
            "ways")
    if mesh.tq > 1 and cfg.num_kv_heads % mesh.tp:
        raise ValueError(
            f"tp={mesh.tp} must divide the {cfg.num_kv_heads} kv heads on a "
            "grouped split (tq > 1)")
    if ecfg.kv_host_tier_mb > 0 or ecfg.kv_disk_tier_dir or \
            ecfg.kv_object_dir:
        raise ValueError(
            "the KV tiers at tp > 1 are not ported: every rank's shard of "
            "a page run would have to move (ROADMAP A9, KV tiers and ships "
            "at tp > 1)")


def _spans_s(spans: Sequence[Tuple[Any, Any]]) -> float:
    """Device seconds of (start, end) CUDA timing-event pairs (their
    end events have completed)."""
    return sum(a.elapsed_time(b) for a, b in spans) / 1e3


# one capture side stream per device, shared by every engine of the
# process: replicas on one card and the engines a resize rebuilds would
# otherwise each add a BLAS workspace that outlives them
_CAPTURE_STREAMS: Dict[torch.device, Any] = {}


def _capture_stream_for(dev: torch.device):
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


def sampling_mode(reqs: Sequence[Optional[GenRequest]]) -> int:
    """GREEDY, SAMPLED or FILTERED for the lanes of one dispatch, from
    their host parameters (the reference's lax.cond predicates)."""
    hot = [r for r in reqs if r is not None and r.temperature > 0.0]
    if not hot:
        return GREEDY
    if any(r.top_k > 0 or r.top_p < 1.0 for r in hot):
        return FILTERED
    return SAMPLED


def replicated(fn: Callable) -> Callable:
    """Mark an engine method as device work that every rank of a
    tensor-parallel group runs (parallel/worker.py).  Its arguments are
    host values; on rank 0 the call is first sent to the other ranks, then
    run here, so every rank runs the same device operations in the same
    order.  A worker runs `method.replicated`, the undecorated function.
    A failure here while a peer is down is that peer's failure: it
    surfaces as the group's DistributedStepError."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kw):
        group = self._group
        if group is None:
            return fn(self, *args, **kw)
        group.op(self._eid, fn.__name__, args, kw)
        try:
            return fn(self, *args, **kw)
        except Exception as e:
            group.explain(e)
            raise

    wrapper.replicated = fn
    return wrapper


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        engine_cfg: Optional[EngineConfig] = None,
        kv_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
        mesh: Any = None,
    ):
        """device: None = CUDA (raises without it); "cpu" for the tests.
        params: the layer-stacked dict (models/llama.py), moved to device.

        mesh: None for one device.  A `parallel.MeshConfig` with tp, tq
        or ep > 1 makes this engine rank 0 of a rank group it spawns and
        owns (rank r on `cuda:r`, or every rank on the CPU with
        device="cpu"); a `parallel.RankGroup` builds it on a group the
        caller owns.  `params` is then the full tree each rank slices its
        shard from, or `parallel.RandomWeights`, from which each rank
        draws its own shard on its own card."""
        self.ecfg = engine_cfg or EngineConfig()
        ecfg = self.ecfg
        # tensor parallelism (parallel/): the group rank 0 sends its device
        # work to (None on one device and on the other ranks), this
        # engine's id there, and the rank's collectives
        self._group = None
        self._owns_group = False
        self._eid: Optional[int] = None
        self.tp = None
        self.mesh = None
        if mesh is not None:
            mesh, device, params = self._join_mesh(cfg, mesh, device, params,
                                                   kv_dtype)
        self.device = resolve_device(device)
        if ecfg.num_pages - 1 < ecfg.max_pages_per_seq:
            raise ValueError(
                "num_pages must exceed max_pages_per_seq: a lone sequence "
                "must always be able to reach the full attention window")
        if not ecfg.prefill_buckets or list(ecfg.prefill_buckets) != sorted(
                set(ecfg.prefill_buckets)) or ecfg.prefill_buckets[0] < 1:
            raise ValueError("prefill_buckets must be increasing and positive")
        if ecfg.prefix_cache_pages is not None and ecfg.prefix_cache_pages < 0:
            raise ValueError(
                "prefix_cache_pages must be >= 0 (0 disables; None = "
                "bounded only by pool pressure)")
        if ecfg.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0 (0 disables)")
        if ecfg.speculative_k > 0 and \
                ecfg.speculative_k + 2 > ecfg.max_window:
            raise ValueError(
                f"speculative_k={ecfg.speculative_k} does not fit the "
                f"attention window ({ecfg.max_window})")
        if ecfg.multi_step < 1 or ecfg.fetch_lag < 0 or ecfg.max_parked < 0:
            raise ValueError("multi_step must be >= 1, fetch_lag and "
                             "max_parked >= 0")
        if ecfg.flight_ring < 0:
            raise ValueError(
                "flight_ring must be >= 0 (0 disables the flight recorder)")
        if ecfg.kv_host_tier_mb < 0:
            raise ValueError(
                "kv_host_tier_mb must be >= 0 (0 disables the host tier)")
        if ecfg.kv_object_mb < 0:
            raise ValueError(
                "kv_object_mb must be >= 0 (0 = unbounded references)")
        if ecfg.agent_demote not in ("", "host", "object"):
            raise ValueError(
                "agent_demote must be '' (off), 'host', or 'object'")
        backend, self.attention_backend_reasons = resolve_attention_backend(
            cfg, ecfg, self.device.type, mesh=self.mesh)
        if self.attention_backend_reasons and (
                self.mesh is None or self.mesh.rank == 0):
            logger.warning(
                "attention_backend 'auto' resolved to 'plain' on %s: %s",
                self.device, "; ".join(self.attention_backend_reasons))
        self.cfg = cfg.replace(attention_backend=backend)
        self.params = params_to(params, device=self.device)
        self.kv_dtype = kv_dtype or cfg.activation_dtype
        ps = ecfg.page_size
        self.pool = PagePool(ecfg.num_pages, ps)
        # dense tensors, or QTensor pools (int8 rows + per-slot scales);
        # a rank's pool holds its kv heads only: column block r // tq of
        # the full pool, allocated contiguous
        self.k_pool, self.v_pool = make_kv_pool_arrays(
            cfg if self.tp is None
            else cfg.replace(num_kv_heads=self.tp.kv_heads),
            ecfg.num_pages, ps, self.kv_dtype, device=self.device,
            quantize=ecfg.kv_quantize)
        B, P = ecfg.max_batch, ecfg.max_pages_per_seq
        dev = self.device
        self.slots: List[Optional[GenRequest]] = [None] * B
        self.waiting: List[GenRequest] = []
        # the background class's own FIFO: interactive admission never
        # scans past deferred background work
        self.waiting_bg: List[GenRequest] = []
        self.bg_admitted = 0
        self.bg_chunks = 0
        self.bg_yields = 0
        # off-slot lanes (PREFILLING with slot -1, or PARKED), FIFO
        self.parked: List[GenRequest] = []
        # prefill-and-hand-off completions, (request, first token) pairs
        # whose pages were kept, awaiting the DP router's ship and requeue
        # (the router drains this every step; a lone engine never fills
        # it: GenRequest.handoff is router-set only)
        self.handoffs: List[Tuple[GenRequest, int]] = []
        # the autoscaler ladder's speculation rung: None = unthrottled; an
        # integer caps each lane's proposals (0 pauses speculation, verify
        # entries in flight drain normally).  Written from the controller
        # thread as one attribute store.
        self.spec_k_cap: Optional[int] = None
        # scheduler iterations left before off-slot admission may resume
        # after a page-pressure rollback (_ensure_pages)
        self._park_cooldown = 0
        self._requests: Dict[str, GenRequest] = {}
        self._counter = itertools.count()
        self._out_events: List[TokenEvent] = []
        # device-resident decode control state.  Host-authored arrays are
        # views of one buffer, re-uploaded only after a scheduling change
        # (_refresh_ctl); the last tokens and lengths are advanced by the
        # step programs and patched per lane at admission, never rebuilt
        # from host values that may still be in flight.
        self._ctl = _ControlState({
            "table": ((B, P), torch.int32),
            "lens": ((B,), torch.int32),
            "keep": ((B,), torch.bool),
            "temps": ((B,), torch.float32),
            "top_ks": ((B,), torch.int64),
            "top_ps": ((B,), torch.float32),
            "seeds": ((B,), torch.int64),
        }, dev)
        v = self._ctl.views
        self._d_table, self._d_seeds = v["table"], v["seeds"]
        self._d_sampling = SamplingParams(v["temps"], v["top_ks"],
                                          v["top_ps"])
        self._d_last = torch.zeros(B, dtype=torch.int64, device=dev)
        self._d_seq_lens = torch.zeros(B, dtype=torch.int32, device=dev)
        # the lanes one dispatch advances (uploaded per dispatch)
        self._d_run = torch.zeros(B, dtype=torch.bool, device=dev)
        # host mask rows of a host-masked micro-batch (allocated at first
        # use: [B, V])
        self._d_allowed: Optional[torch.Tensor] = None
        # the last prefill dispatch's sampled tokens, and parked lanes'
        # first tokens by request id (_dev_park_prefill), on the device
        self._prefill_toks: Optional[torch.Tensor] = None
        self._parked_toks: Dict[str, torch.Tensor] = {}
        self._ctl_dirty = True
        # step program outputs per fused depth k: tokens [k, B], and with
        # keep_logits the sampled rows [k, B, V] f32
        self._toks_buf: Dict[int, torch.Tensor] = {}
        self._logits_buf: Dict[int, torch.Tensor] = {}
        # captured step programs (CUDA), one shared memory pool
        self._graphs: Dict[Tuple, _StepGraph] = {}
        self._graph_pool = None
        # the side stream of every capture's warm-up run: one per device
        # for every engine of the process (_capture_stream_for), since the
        # BLAS libraries keep a workspace per stream and never free it
        self._capture_stream = None
        self.graph_replays = 0
        # graphs captured and the host seconds their warm-ups and captures
        # took (each capture synchronizes the device)
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        # fused k-step dispatches made (k > 1)
        self.multi_step_dispatches = 0
        # the fetch pipeline: in-flight token copies, FIFO, and the device
        # steps they represent (fused entries count k)
        self._pending: List[_Fetch] = []
        self._pending_steps = 0
        # the host-masked micro-batch's in-flight fetch (at most one):
        # those lanes redispatch only after it is processed
        self._constrained_fetch: Optional[_Fetch] = None
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool, max_pages=ecfg.prefix_cache_pages)
            if ecfg.prefix_cache_entries > 0 and ecfg.prefix_cache_pages != 0
            else None)
        self.kv_tier = None
        self._build_kv_tier()
        # agent tool-call gaps: prefix_key -> monotonic due time (insertion
        # order == due order: the linger is constant), and prefix_key ->
        # pages demoted mid-gap awaiting the tool's return
        self._agent_gaps: Dict[str, float] = {}
        self._awaiting_demoted: Dict[str, int] = {}
        self.agent_gaps = 0
        self.agent_gap_demotions = 0
        self.agent_gap_pages_demoted = 0
        self.agent_gap_bytes_demoted = 0
        self.agent_gap_cancelled = 0
        self.agent_hint_hits = 0
        self.agent_hint_misses = 0
        # the clock of the gap linger (tests inject one)
        self.clock: Callable[[], float] = time.monotonic
        # on-device grammar FSM lanes: per-slot automaton state (-1 =
        # unconstrained), grammar index into the shared table set, and
        # remaining token budget, all on the device and advanced there
        self._grammars = _GrammarTables(cfg.vocab_size, dev)
        self._grammars.upload = self._dev_grammar_tables
        self._fsm = torch.full((B,), -1, dtype=torch.int32, device=dev)
        self._fsm_g = torch.zeros(B, dtype=torch.int32, device=dev)
        self._budget = torch.zeros(B, dtype=torch.int32, device=dev)
        # constrained-decoding counters of this package (the reference's
        # constrained_* keys live in self.metrics): host mask rows built
        # from logits_mask_fn, and lanes degraded from the FSM to the
        # host mask
        self.constrained_host_mask_steps = 0
        self.constrained_degrades = 0
        # device-resident all-zero embed overrides of a vision engine's
        # text-only prefill chunks, per [B, S] (_zero_override)
        self._zero_ov_cache: Dict[Tuple[int, int],
                                  Tuple[torch.Tensor, torch.Tensor]] = {}
        self._init_telemetry()
        self._rtt_est = self._measure_rtt()
        if self._group is not None:
            # the other ranks built their engines meanwhile
            self._group.await_built(self._eid)

    def _join_mesh(self, cfg: ModelConfig, mesh: Any, device: DeviceLike,
                   params: Any, kv_dtype: Optional[torch.dtype]):
        """Place this engine on a tensor-parallel rank group: check the
        split, spawn the group (a MeshConfig) or join it (a RankGroup, or a
        worker's RankContext), send the other ranks their build order, and
        return (this rank's mesh, its device, its parameter shard)."""
        from ..parallel.mesh import MeshConfig
        from ..parallel.tp import TensorParallel
        from ..parallel.worker import EngineSpec, RankContext, RankGroup

        if isinstance(mesh, MeshConfig):
            if mesh.total_devices <= 1:
                return None, device, params
            validate_tensor_parallel(cfg, self.ecfg, mesh)
            mesh = RankGroup(mesh, device=device)
            self._owns_group = True
        if isinstance(mesh, RankGroup):
            validate_tensor_parallel(cfg, self.ecfg, mesh.mesh)
            try:
                spec = EngineSpec(cfg, self.ecfg, kv_dtype, params)
                self._eid = mesh.build(spec)
                self._group = mesh
                rank_mesh, group = mesh.mesh, mesh.group
                tensor_group = mesh.tensor_group
                params = spec.rank_params(rank_mesh)
            except BaseException:
                if self._owns_group:
                    mesh.close()
                raise
        elif isinstance(mesh, RankContext):
            rank_mesh, group = mesh.mesh, mesh.group
            tensor_group = mesh.tensor_group
        else:
            raise TypeError(f"mesh must be a MeshConfig, RankGroup or None, "
                            f"got {type(mesh).__name__}")
        self.mesh = rank_mesh
        self.tp = TensorParallel(cfg, rank_mesh, group, tensor_group)
        return rank_mesh, rank_mesh.device, params

    def _build_kv_tier(self) -> None:
        """The host-RAM (+ disk) page tier under the pool, and the object
        tier below it (kafka_tpu/runtime/engine.py:955-1020).  Built only
        when enabled AND the prefix cache exists (the radix tree names
        the demotable runs)."""
        ecfg = self.ecfg
        if self.prefix_cache is None or not (
                ecfg.kv_host_tier_mb > 0 or ecfg.kv_object_dir):
            return
        from .kv_tier import KVTierManager, LocalPageShipper

        ps = ecfg.page_size
        self.kv_tier = KVTierManager(
            LocalPageShipper(self, ps),
            host_budget_bytes=ecfg.kv_host_tier_mb * 1024 * 1024,
            disk_dir=ecfg.kv_disk_tier_dir or None,
            page_size=ps)
        self.prefix_cache.tier = self.kv_tier
        if not ecfg.kv_object_dir:
            return
        # the store behind a StoreGuard (deadline, retry, breaker) from
        # the KAFKA_TORCH_KV_OBJECT_* knobs; the fingerprint partitions
        # the store by model and pool geometry
        from .object_tier import ObjectTier, WakePrefetcher, build_object_store

        obj = ObjectTier(build_object_store(ecfg.kv_object_dir),
                         budget_bytes=ecfg.kv_object_mb * 1024 * 1024,
                         fingerprint=self._object_fingerprint(),
                         page_size=ps)

        def env_f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default) or default)
            except (TypeError, ValueError):
                return default

        # opt-in in-process janitor (default off)
        obj.start_janitor(
            env_f("KAFKA_TORCH_KV_OBJECT_SCRUB_S", 0.0),
            grace_s=env_f("KAFKA_TORCH_KV_OBJECT_SCRUB_GRACE_S", 3600.0))
        # wake prefetch (KAFKA_TORCH_WAKE_PREFETCH_MB; None when unset)
        obj.prefetcher = WakePrefetcher.from_env(obj)
        self.kv_tier.attach_object(obj)

    def _object_fingerprint(self) -> str:
        """The object tier's content-address fingerprint, the JAX
        package's string character for character: model name + page
        size + per-leaf pool layout with numpy dtype names (+ an operator
        namespace, KAFKA_TORCH_KV_OBJECT_NAMESPACE — bump it when weights
        change under an unchanged config).  Two engines agreeing on it
        exchange KV runs byte for byte through a shared store."""
        from .kv_tier import dtype_name, pool_leaves

        leaves = pool_leaves(self.k_pool) + pool_leaves(self.v_pool)
        geo = ",".join(
            f"{dtype_name(a.dtype)}:{a.shape[0]}x{tuple(a.shape[2:])}"
            for a in leaves)
        ns = os.environ.get("KAFKA_TORCH_KV_OBJECT_NAMESPACE", "")
        return f"{self.cfg.name}|ps{self.ecfg.page_size}|{geo}|{ns}"

    def close(self) -> None:
        """Stop the tier's background threads (spill writer, janitor, wake
        prefetcher) after resolving in-flight demotions; on a
        tensor-parallel group, drop this engine on every rank and stop
        the ranks when the engine owns them.  Idempotent."""
        # the grammar tables' upload hook is a bound method of this engine
        self._grammars.upload = self._grammars.write
        group, self._group = self._group, None
        if group is not None:
            try:
                group.drop(self._eid)
            except Exception:  # a broken group cannot take the order
                logger.warning("dropping the engine on the rank group "
                               "failed", exc_info=True)
            # NCCL holds a communicator that collectives were captured on
            # until their graphs are destroyed (an executable graph still
            # in flight is freed when it completes): release this
            # engine's graphs before its group's communicators go, or
            # tearing them down waits on the graphs
            self._graphs.clear()
            self._graph_pool = None
            if self._owns_group:
                group.close()
        tier = self.kv_tier
        if tier is None:
            return
        tier.close()
        obj = tier.object
        if obj is not None:
            obj.stop_janitor()
            if obj.prefetcher is not None:
                obj.prefetcher.close()

    def _init_telemetry(self) -> None:
        """The reference's telemetry (kafka_tpu/runtime/engine.py
        __init__): flight recorder, metrics registry with the planner's
        dispatch cost model and this device's roofline, the live memory
        monitor and the kernel sampler."""
        self.flight: Optional[FlightRecorder] = (
            FlightRecorder(self.ecfg.flight_ring)
            if self.ecfg.flight_ring > 0 else None)
        # completion time of the previously observed fetch (the CPU's
        # measured-dispatch rule: a dispatch starts at max(its enqueue,
        # the previous completion))
        self._last_ready_t: Optional[float] = None
        # modeled seconds of prefill chunks whose completion is not
        # observed (only a final chunk ships a fetch entry) and, on CUDA,
        # their timing spans and costs: the final chunk's entry carries
        # them
        self._prefill_modeled_acc: Optional[float] = None
        self._prefill_spans: List[Tuple[Any, Any]] = []
        self._prefill_costs: List[Tuple] = []
        self.metrics = EngineMetrics()
        self._cost_model = None
        self._roofline: Optional[Tuple] = None
        self._have_roofline = False
        try:
            from ..models.quant import param_bytes
            from .planner import device_peaks, dispatch_cost_model

            # per device: on a tensor-parallel group each rank does 1/n of
            # the flops over its own shard and kv heads, so the device's
            # share against one card's peaks is the group's against n
            # cards' (kafka_tpu/runtime/engine.py:1060-1100)
            n = self.mesh.size if self.mesh is not None else 1
            self._cost_model = dispatch_cost_model(
                self.cfg, n_devices=n,
                weight_bytes_total=param_bytes(self.params) * n,
                kv_dtype_bytes=(1 if self.ecfg.kv_quantize == "int8"
                                else self.kv_dtype.itemsize),
                kv_replication=(self.mesh.tq * self.mesh.ep
                                if self.mesh is not None else 1))
            self._roofline = device_peaks(self.device)
            self.metrics.set_roofline(*self._roofline)
            # a known roofline survives metrics resets (the server swaps
            # in a fresh EngineMetrics after warmup): the cost helpers
            # re-apply it on the first dispatch they record
            self._have_roofline = self._roofline[2] != "unknown"
        except Exception:
            logger.warning("dispatch cost model unavailable: MFU and "
                           "bandwidth utilization will read 0",
                           exc_info=True)
        # attached by the server after planning (memory_monitor.plan)
        self.memory_monitor: Optional[MemoryMonitor] = MemoryMonitor(
            [self.device])
        self.kernel_sampler = kernel_profiler.build_from_env(
            self.device.type)

    # the reference's counters, read from the registry (self.metrics)
    @property
    def preemptions(self) -> int:
        return self.metrics.requests_preempted

    @property
    def fetch_pipeline_wasted(self) -> int:
        return self.metrics.fetch_pipeline_wasted_tokens

    @property
    def speculation_proposed_tokens(self) -> int:
        return self.metrics.speculation_proposed_tokens

    @property
    def speculation_accepted_tokens(self) -> int:
        return self.metrics.speculation_accepted_tokens

    @property
    def verify_steps(self) -> int:
        return self.metrics.speculation_verify_steps

    @property
    def constrained_ondevice_tokens(self) -> int:
        return self.metrics.constrained_ondevice_tokens

    @property
    def constrained_mask_overtight(self) -> int:
        return self.metrics.constrained_mask_overtight

    def _measure_rtt(self) -> float:
        """Time a device-to-host copy of a fresh small tensor: the seed of
        the adaptive emit cadence (_emit_wait), kept honest by an EWMA
        over blocking pops in _process_entry."""
        samples = []
        for _ in range(2):
            probe = torch.zeros(self.ecfg.max_batch, dtype=torch.int32,
                                device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.monotonic()
            probe.cpu()
            samples.append(time.monotonic() - t0)
        self._rtt_probe = min(samples)
        return self._rtt_probe

    def _to_device(self, arr: np.ndarray,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A host array on the device: on CUDA through pinned host memory
        and a non-blocking copy (the caching host allocator keeps the
        staging block until the copy has landed), into `out` — a fixed
        tensor a step graph reads — when given."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            src = src.pin_memory()
            if out is None:
                out = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
            out.copy_(src, non_blocking=True)
            return out
        if out is None:
            return src
        out.copy_(src)
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        if len(req.prompt_ids) == 0:
            raise ValueError("empty prompt")
        if self.group_broken:
            from ..parallel.distributed import DistributedStepError

            raise DistributedStepError(
                f"the engine's rank group is broken: {self.group_broken}")
        if not req.background and self.ecfg.max_waiting > 0 and \
                len(self.waiting) >= self.ecfg.max_waiting:
            self.metrics.record_rejected()
            if self.flight is not None:
                self.flight.note_cause("reject")
            raise AdmissionError(len(self.waiting), self.ecfg.max_waiting,
                                 self.retry_after_estimate())
        limit = self.ecfg.max_window
        if len(req.prompt_ids) + 1 > limit:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens exceeds the "
                f"attention window ({limit}); compact the conversation first")
        if req.max_new_tokens is None:
            req.max_new_tokens = self.ecfg.max_new_tokens_default
        if len(req.prompt_ids) + req.max_new_tokens > limit:
            req.max_new_tokens = max(1, limit - len(req.prompt_ids))
        if req.grammar is not None and (
                getattr(req.grammar, "vocab_size", None)
                != self.cfg.vocab_size):
            # an artifact compiled for another model's vocab cannot index
            # this engine's tables: host mask path
            req.grammar = None
        if req.logits_mask_fn is not None and hasattr(
                req.logits_mask_fn, "set_budget"):
            # constrained decoding: tell the mask the post-clamp budget so
            # it can wrap the JSON up before tokens run out
            req.logits_mask_fn.set_budget(req.max_new_tokens)
        req.prefill_ids = list(req.prompt_ids)
        if req.handoff and (req.prefix_key is None
                            or self.prefix_cache is None):
            # a hand-off run is named by the radix cache at both ends:
            # without a key (or a cache) the request is served in place
            req.handoff = False
        if self.ecfg.speculative_k > 0 and req.spec is None and (
                req.logits_mask_fn is None or req.grammar is not None):
            # free lanes and device-FSM lanes speculate (the verify step
            # masks every position with the FSM state reached through the
            # candidate prefix); host-masked lanes do not, their masks
            # need a host turnaround per token
            req.spec = LaneSpeculator(req.prompt_ids)
        req.submit_time = time.monotonic()
        self.metrics.record_submit(len(req.prompt_ids))
        req.state = WAITING
        if req.prefix_key is not None and (
                self._agent_gaps or self._awaiting_demoted):
            # the thread is back (whether or not the return hint fired): a
            # pending gap demote must not race the new turn's admission
            self._agent_gaps.pop(req.prefix_key, None)
            self._awaiting_demoted.pop(req.prefix_key, None)
        (self.waiting_bg if req.background else self.waiting).append(req)
        self._requests[req.request_id] = req

    def take_waiting(self) -> List[GenRequest]:
        """Remove and return every WAITING request (they own no device
        state): the DP router migrates a quarantined replica's queue onto
        healthy ones, and a topology rebuild carries the queue across
        engine generations.  Runs on the thread that drives step()."""
        taken = list(self.waiting) + list(self.waiting_bg)
        self.waiting.clear()
        self.waiting_bg.clear()
        for req in taken:
            if req.seq is not None:  # defensive: waiting owns no pages
                self.pool.free_sequence(req.seq)
                req.seq = None
            self._requests.pop(req.request_id, None)
        return taken

    def adopt(self, req: GenRequest) -> None:
        """Requeue a WAITING request taken from another replica.  Unlike
        submit() no admission bound and no submission metrics: the
        request was admitted and counted once, and a replica failure must
        not turn into client-visible rejections."""
        req.state = WAITING
        q = self.waiting_bg if req.background else self.waiting
        q.append(req)
        q.sort(key=lambda r: r.submit_time)
        self._requests[req.request_id] = req

    def _unqueue(self, req: GenRequest) -> None:
        """Take a WAITING request out of its queue (cancel, timeout)."""
        q = self.waiting_bg if req.background else self.waiting
        if req in q:
            q.remove(req)

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Abort a request (client disconnect); frees its slot and pages
        at once.  Its tokens still in flight are dropped as they mature.
        Runs on the thread that drives step().  False for unknown or
        already finished ids."""
        req = self._requests.get(request_id)
        if req is None or req.state == FINISHED:
            return False
        if req.state == WAITING:
            self._unqueue(req)
        req.state = FINISHED
        req.finish_reason = reason
        self._finalize_slo(req, reason)
        self._release_slot(req)
        self._requests.pop(request_id, None)
        return True

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        # a pending tool-gap linger keeps step() running on an otherwise
        # idle engine, or the demote never fires
        return (self.num_active > 0 or bool(self.waiting)
                or bool(self.waiting_bg)
                or bool(self.parked) or bool(self._pending)
                or bool(self._agent_gaps))

    def step(self) -> List[TokenEvent]:
        """One scheduler iteration: deadlines, drain matured fetches,
        admit, advance one prefill chunk per prefilling lane, dispatch the
        decode batch.  With nothing left to dispatch the pipeline is
        flushed."""
        failpoint("engine.step")
        if self.kernel_sampler is not None:
            # close the previous sample's window (the device work queued
            # behind it has had the inter-step gap to land) and open a
            # new one when this step is due
            self.kernel_sampler.on_step_begin(self.metrics)
        if self.memory_monitor is not None:
            self.memory_monitor.poll()  # throttled to ~1 Hz internally
        if self.kv_tier is not None:
            # resolve completed D2H demotions (a list scan, usually empty)
            self.kv_tier.drain()
        if self._agent_gaps:
            self._process_agent_gaps()
        if self._park_cooldown > 0:
            self._park_cooldown -= 1
        self._check_deadlines()
        self.metrics.record_queue_depth(len(self.waiting))
        self._drain(block=False)
        self._admit()
        self._advance_prefills()
        if any(s is not None and s.state == ACTIVE for s in self.slots):
            self._dispatch_decode()
            self._drain(block=False)
        if not self.num_active and not self.waiting and self._pending:
            # nothing left to dispatch: flush the pipeline — except when
            # a prefill-and-hand-off is pending.  The DP router drives
            # every replica from one thread; a prefill replica waiting
            # here would stall the others for the whole chunk.  Hand-off
            # entries drain non-blocking on a later step (has_work spans
            # them).
            if not any(r.handoff and r.state == DRAINING
                       for r in self._requests.values()):
                self._drain(block=True)
        if not self.num_active:
            self.metrics.mark_idle()  # idle gaps are not TPOT
            self._last_ready_t = None  # the measured-time chain restarts
        if self.flight is not None:
            # commit this iteration's record, run the anomaly detectors
            self.flight.finish_step(self)
        out, self._out_events = self._out_events, []
        return out

    def run_to_completion(self) -> Dict[str, GenRequest]:
        """Drain all requests (testing/bench convenience)."""
        registry = dict(self._requests)
        done: Dict[str, GenRequest] = {}
        while self.has_work:
            for ev in self.step():
                if ev.finished:
                    done[ev.request_id] = registry[ev.request_id]
        return done

    def generate(self, prompt_ids: List[int], **kw) -> GenRequest:
        """Single-request synchronous generation."""
        req = GenRequest(request_id=f"gen-{next(self._counter)}",
                         prompt_ids=list(prompt_ids), **kw)
        self.submit(req)
        while req.state != FINISHED:
            self.step()
        return req

    def agent_section(self) -> Dict[str, int]:
        """The metrics snapshot's "agent" section (AGENT_METRIC_KEYS):
        the tool-gap counters and the background class's queue depth and
        admit / chunk / yield counters."""
        pages = sum(self._awaiting_demoted.values())
        tier = self.kv_tier
        out = {k: 0 for k in AGENT_METRIC_KEYS}
        out.update({
            "agent_gaps": self.agent_gaps,
            "agent_gap_demotions": self.agent_gap_demotions,
            "agent_gap_pages_demoted": self.agent_gap_pages_demoted,
            "agent_gap_bytes_demoted": self.agent_gap_bytes_demoted,
            "agent_gap_cancelled": self.agent_gap_cancelled,
            "agent_hint_hits": self.agent_hint_hits,
            "agent_hint_misses": self.agent_hint_misses,
            "agent_awaiting_threads": len(self._agent_gaps) + len(
                [k for k in self._awaiting_demoted
                 if k not in self._agent_gaps]),
            "agent_awaiting_bytes": (tier.bytes_for_pages(pages)
                                     if tier is not None else 0),
            "bg_queue_depth": len(self.waiting_bg),
            "bg_admitted": self.bg_admitted,
            "bg_chunks": self.bg_chunks,
            "bg_yields": self.bg_yields,
        })
        return out

    # -- agent tool-call gaps -------------------------------------------

    def note_tool_gap(self, prefix_key: Optional[str]) -> None:
        """The thread just finished a turn with finish_reason=tool_calls
        and is idle for the tool's runtime (the provider signals this
        through the worker inbox, so it runs on the engine thread).
        Start the linger clock: after agent_linger_s with no return, the
        thread's KV demotes down the tier ladder.  No-op with the knob
        off or without the cache and tier to demote into."""
        if (not prefix_key or not self.ecfg.agent_demote
                or self.prefix_cache is None or self.kv_tier is None):
            return
        self.agent_gaps += 1
        # re-noting a gap restarts its linger (re-insert keeps due order)
        self._agent_gaps.pop(prefix_key, None)
        self._agent_gaps[prefix_key] = self.clock() + self.ecfg.agent_linger_s

    def note_tool_return(self, prefix_key: Optional[str]) -> None:
        """The tool finished: the thread's follow-up turn is imminent.
        Cancel a still-lingering demote, or — when the gap already
        demoted — protect the thread's tier runs from second-chance
        eviction and kick the wake prefetcher."""
        if not prefix_key or not self.ecfg.agent_demote:
            return
        pending = self._agent_gaps.pop(prefix_key, None)
        demoted = self._awaiting_demoted.pop(prefix_key, None)
        if pending is not None:
            self.agent_gap_cancelled += 1
            self.agent_hint_hits += 1
            return
        if demoted is None:
            self.agent_hint_misses += 1
            return
        self.agent_hint_hits += 1
        pc = self.prefix_cache
        if pc is None:
            return
        resident = pc.touch_thread(prefix_key)
        obj = self.kv_tier.object if self.kv_tier is not None else None
        pre = obj.prefetcher if obj is not None else None
        if pre is not None:
            # object GETs for runs NOT locally resident start now,
            # overlapping the tool's tail
            pre.prefetch_thread(prefix_key, min_depth=resident)

    def _process_agent_gaps(self) -> None:
        """Demote threads whose tool-call linger expired (step() entry).
        Insertion order == due order, so the scan stops at the first
        not-yet-due key."""
        now = self.clock()
        while self._agent_gaps:
            key, due = next(iter(self._agent_gaps.items()))
            if due > now:
                break
            del self._agent_gaps[key]
            self._demote_gap_thread(key)

    def _demote_gap_thread(self, key: str) -> None:
        pc, tier = self.prefix_cache, self.kv_tier
        if pc is None or tier is None:
            return
        stats = pc.demote_thread(
            key, archive=(self.ecfg.agent_demote == "object"))
        pages = stats.get("pages", 0)
        if pages:
            self.agent_gap_demotions += 1
            self.agent_gap_pages_demoted += pages
            self.agent_gap_bytes_demoted += tier.bytes_for_pages(pages)
            if self.flight is not None:
                self.flight.note_cause("agent_demote")
        # 0-page sweeps still register the awaiting state: the thread IS
        # mid-gap (its KV may already be tier-resident from pressure)
        self._awaiting_demoted[key] = self._awaiting_demoted.get(key, 0) + pages

    def awaiting_tool_keys(self) -> List[str]:
        """Threads currently mid-tool-call-gap (linger pending or
        demoted-awaiting)."""
        return list(self._agent_gaps) + [
            k for k in self._awaiting_demoted if k not in self._agent_gaps]

    # -- warmup and the object tier's drain -----------------------------

    def _warm_step(self, k: int, fsm: bool, mode: int) -> None:
        """Run one step-program variant with every lane inactive: writes
        land in the trash page and no lane's length, token, FSM state or
        budget moves.  On CUDA this captures the variant's graph (the
        first use) and replays it."""
        if self.has_work:
            raise RuntimeError("warmup dispatch on a busy engine")
        if self._ctl_dirty:
            self._refresh_ctl()
        self._dev_decode(np.zeros(self.ecfg.max_batch, bool), None, k, fsm,
                         mode, self.ecfg.keep_logits)
        self._sync()

    def warmup_sampling(self) -> None:
        """Capture the plain decode program for every sampling mode, at
        one step and at the fused depth, outside serving: a first sampled
        or top-k/top-p request would otherwise capture a graph on the
        scheduler thread."""
        depths = sorted({1, self.ecfg.multi_step})
        for k in depths:
            for mode in (GREEDY, SAMPLED, FILTERED):
                self._warm_step(k, False, mode)

    def warmup_verify(self) -> None:
        """Run the speculative verify step once outside serving, with
        every lane inactive: writes land in the trash page and no
        scheduler state moves.  No-op when speculative_k is 0."""
        if self.ecfg.speculative_k <= 0:
            return
        if self._ctl_dirty:
            self._refresh_ctl()
        B, K = self.ecfg.max_batch, self.ecfg.speculative_k
        self._verify_step([None] * B, np.zeros((B, K), np.int32), [0] * B,
                          fsm=False)
        self._sync()

    def warmup_grammar(self, grammar) -> None:
        """Register `grammar` and run the FSM decode variant (every
        sampling mode, one step) with every lane inactive, so the first
        tool_choice-constrained request finds its tables registered and
        its step graph captured.  With speculative_k > 0 the FSM verify
        variant runs once too.  No-op when the grammar cannot register
        (those requests use the host mask path anyway)."""
        if self._grammars.register(grammar) is None:
            return
        for mode in (GREEDY, SAMPLED, FILTERED):
            self._warm_step(1, True, mode)
        if self.ecfg.speculative_k > 0:
            if self._ctl_dirty:
                self._refresh_ctl()
            B, K = self.ecfg.max_batch, self.ecfg.speculative_k
            self._verify_step([None] * B, np.zeros((B, K), np.int32),
                              [0] * B, fsm=True)
            self._sync()

    def warmup_kv_tier(self) -> None:
        """One ship per SHIP_BUCKETS entry against the trash page, outside
        serving: each bucket's pinned staging block is allocated now (the
        caching host allocator reuses it), so the first demotion or
        promotion under traffic pays copy time only.  Gathers read
        garbage and scatters write zeros INTO the trash page (its
        contract); no pool state changes.  No-op without a tier."""
        if self.kv_tier is None:
            return
        from .kv_tier import SHIP_BUCKETS

        ship = self.kv_tier.shipper
        for b in SHIP_BUCKETS:
            pending = ship.export_run([TRASH_PAGE] * b)
            k_leaves, v_leaves = ship.resolve(pending)
            ship.import_run(k_leaves, v_leaves, b, [TRASH_PAGE] * b)
        self._sync()

    def sleep_to_object(self) -> Dict[str, Any]:
        """Flush this engine's warm KV state (every cached radix run +
        per-thread sleep manifests) into the shared object store — the
        POST /admin/drain/{replica} seam.  Non-destructive; see
        PrefixCache.sleep_to_object.  Must run with the scheduler
        quiesced (the provider pauses the worker first)."""
        if (self.prefix_cache is None or self.kv_tier is None
                or self.kv_tier.object is None):
            return {"enabled": False}
        return self.prefix_cache.sleep_to_object()

    def retry_after_estimate(self) -> float:
        """Seconds until queue relief is plausible, for 429 Retry-After:
        the batch retires ~max_batch requests per (default token budget x
        per-token latency, the registry's recent TPOT).  Clamped to
        [1, 120] — a hint, not a promise."""
        tpot_s = self.metrics.recent_tpot_s() or 0.05
        per_request_s = self.ecfg.max_new_tokens_default * tpot_s
        drain_rate = self.ecfg.max_batch / max(per_request_s, 1e-3)
        excess = max(1, len(self.waiting) - self.ecfg.max_batch)
        return float(min(120.0, max(1.0, excess / max(drain_rate, 1e-3))))

    # ------------------------------------------------------------------
    # failure handling & self-check
    # ------------------------------------------------------------------

    def _expected_page_owners(self) -> Dict[int, int]:
        """Live references per page: every registered request's sequence
        plus the prefix cache's retains — what the pool's refcounts must
        equal."""
        owners: Dict[int, int] = {}
        for req in self._requests.values():
            if req.seq is not None:
                for p in req.seq.pages:
                    owners[p] = owners.get(p, 0) + 1
        if self.prefix_cache is not None:
            for p, n in self.prefix_cache.page_owners().items():
                owners[p] = owners.get(p, 0) + n
        return owners

    def self_check(self, repair: bool = False) -> List[str]:
        """Scheduler/pool invariants; returns problems (empty = ok).  With
        `repair`, page discrepancies are fixed in place."""
        problems: List[str] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.slot != i:
                problems.append(f"slot {i} holds {s.request_id} whose slot "
                                f"field is {s.slot}")
            if s.state not in (ACTIVE, PREFILLING):
                problems.append(f"slot {i} holds {s.request_id} in state "
                                f"{s.state}")
            if self._requests.get(s.request_id) is not s:
                problems.append(f"slot {i} holds unregistered request "
                                f"{s.request_id}")
        for req in self._requests.values():
            if req.slot >= 0 and self.slots[req.slot] is not req:
                problems.append(f"{req.request_id} claims slot {req.slot} "
                                "but the slot holds someone else")
        for req in self.parked:
            if req.state not in (PARKED, PREFILLING):
                problems.append(f"parked lane {req.request_id} in state "
                                f"{req.state}")
        problems += self.pool.check_consistency()
        problems += self.pool.reconcile(self._expected_page_owners(),
                                        repair=repair)
        return problems

    def lane_table(self) -> List[Dict[str, Any]]:
        """The active-lane table for postmortems: every registered
        request's scheduler-visible state, readable without the engine."""
        now = time.monotonic()
        return [{
            "request_id": req.request_id,
            "state": req.state,
            "slot": req.slot,
            "age_s": round(now - req.submit_time, 3)
            if req.submit_time else None,
            "prompt_tokens": len(req.prompt_ids),
            "output_tokens": len(req.output_ids),
            "dispatched": req.dispatched,
            "drained": req.drained,
            "spec_ahead": req.spec_ahead,
            "cached_tokens": req.cached_tokens,
            "cache_source": req.cache_source,
            "grammar": req.grammar is not None,
            "host_constrained": self._host_constrained(req),
            "predicted": len(req.predicted),
            "pages": len(req.seq.pages) if req.seq is not None else 0,
            "seq_len": req.seq.length if req.seq is not None else 0,
            "finish_reason": req.finish_reason,
            "background": req.background,
        } for req in self._requests.values()]

    def dump_postmortem(self, reason: str) -> Optional[str]:
        """Write a flight-recorder postmortem (ring + metrics snapshot +
        active-lane table).  Best-effort and exception-free: this runs on
        failure paths.  None when the recorder is off or no dump
        directory is configured."""
        if self.flight is None:
            return None
        try:
            # flush the failing iteration's partial staging into the ring
            # so the dump's LAST record describes the step that died
            self.flight.finish_step(self)
        except Exception:  # pragma: no cover - defensive
            pass
        try:
            lanes = self.lane_table()
        except Exception:  # pragma: no cover - defensive
            lanes = []
        try:
            snap = self.metrics.snapshot(self, reset_peak=False)
        except Exception:  # pragma: no cover - defensive
            snap = {}
        return self.flight.dump_postmortem(
            reason, lanes=lanes, metrics_snapshot=snap)

    def recover_from_failure(self) -> List[TokenEvent]:
        """Rebuild a servable engine after a step() exception: every
        request that had started compute gets exactly one terminal error
        event; WAITING requests stay queued; the fetch pipeline is
        dropped (its tokens' producing work may have died), the captured
        step graphs are discarded, the decode control state is rebuilt
        from zero, and page accounting is verified and repaired.

        On CUDA the host may be up to fetch_lag steps ahead: graph
        replays and their copies into pinned host buffers can still be in
        flight.  One device synchronize (cold path) lets them finish
        before their entries are dropped — no token of theirs is ever
        processed, so none reaches a stream after its terminal event —
        and before the graphs, their memory pool and the control tensors
        are released or re-seeded.  A device that cannot synchronize
        raises here, and the worker fails every request.  First the
        flight recorder's postmortem, before recovery mutates the state
        it explains."""
        self.dump_postmortem("engine_failure")
        if self.group_broken:
            return self._fail_group()
        self._dev_reset()
        events: List[TokenEvent] = list(self._out_events)
        self._out_events = []
        self._pending.clear()
        self._pending_steps = 0
        self._constrained_fetch = None
        self._last_ready_t = None
        # the unobserved prefill chunks died with the step
        self._prefill_modeled_acc = None
        self._prefill_spans = []
        self._prefill_costs = []
        for req in list(self._requests.values()):
            if req.state == WAITING:
                if req.seq is not None:
                    self.pool.free_sequence(req.seq)
                    req.seq = None
                req.spec_ahead = 0  # any in-flight verify was discarded
                q = self.waiting_bg if req.background else self.waiting
                if req not in q:
                    q.append(req)
                continue
            req.state = FINISHED
            req.finish_reason = "error:engine"
            self._finalize_slo(req, "error:engine")
            add_event(req.trace, "engine.recover", {"reason": "error:engine"})
            self._release_slot(req)
            self._requests.pop(req.request_id, None)
            events.append(TokenEvent(req.request_id, None, finished=True,
                                     finish_reason="error:engine"))
        self.waiting.sort(key=lambda r: r.submit_time)
        self.waiting_bg.sort(key=lambda r: r.submit_time)
        self._ctl_dirty = True
        self._park_cooldown = 0
        problems = self.self_check(repair=True)
        if problems:
            logger.error("post-failure self-check repaired %d problem(s): %s",
                         len(problems), "; ".join(problems))
        return events

    @replicated
    def _dev_reset(self) -> None:
        """Recovery's device side: let in-flight work finish, then drop
        the graphs (and with the last of them their memory pool: the next
        capture opens a new one — capturing into a freed pool's handle
        fails in the caching allocator) and zero the control state."""
        self._sync(whole_device=True)
        self._graphs.clear()
        self._graph_pool = None
        self._d_last.zero_()
        self._d_seq_lens.zero_()
        self._d_run.zero_()
        self._fsm.fill_(-1)
        self._fsm_g.zero_()
        self._budget.zero_()
        self._parked_toks.clear()
        self._prefill_toks = None

    # -- tensor-parallel groups ----------------------------------------

    @property
    def group_broken(self) -> Optional[str]:
        """Why this engine's rank group is broken (a rank died, failed or
        missed a deadline); None while it serves, and off a group."""
        return self._group.broken if self._group is not None else None

    def _sync(self, whole_device: bool = False) -> None:
        """Wait for the device work enqueued so far on the stream (every
        stream with `whole_device`); on rank 0 of a group under the guard
        (a dead rank raises DistributedStepError instead of hanging in a
        collective)."""
        if self.device.type != "cuda":
            return
        if self._group is None:
            if whole_device:
                torch.cuda.synchronize(self.device)
            else:
                torch.cuda.current_stream(self.device).synchronize()
            return
        ev = torch.cuda.Event()
        ev.record()
        self._wait_event(ev)

    def _wait_event(self, event: Any) -> None:
        if self._group is None:
            event.synchronize()
        else:
            self._group.wait(event.query)

    def rank_query(self, name: str, *args: Any) -> List[Any]:
        """Engine method `name` evaluated on every rank, in rank order (one
        entry off a group): per-rank telemetry and test probes.  On rank 0
        the others answer after every operation sent before the query.
        Call it on the thread that drives the engine: the query shares the
        pipes that carry the ranks' operations."""
        local = getattr(self, name)(*args)
        if self._group is None:
            return [local]
        return [local] + self._group.query(self._eid, name, *args)

    def rank_launches(self) -> Dict[str, int]:
        """This rank's kernel launch counts by wrapper name."""
        from ..ops import kernels

        return {fn.__name__: fn.launches for fn in kernels.KERNELS}

    def rank_reset_launches(self) -> None:
        from ..ops import kernels

        kernels.reset_launch_counts()

    def rank_pools(self) -> Tuple[Any, Any]:
        """This rank's K and V pools on the host (tests; QTensor pools as
        (q, s) pairs)."""
        def host(pool):
            if isinstance(pool, tuple):
                return tuple(t.cpu() for t in pool)
            return pool.cpu()

        self._sync()
        return host(self.k_pool), host(self.v_pool)

    def rank_memory(self) -> Dict[str, int]:
        """This rank's bytes: its weight shard, its KV pool and, on CUDA,
        the caching allocator's live and reserved bytes."""
        from ..models.quant import param_bytes
        from .kv_tier import pool_leaves

        out = {"weights": param_bytes(self.params),
               "kv_pool": sum(a.numel() * a.element_size() for a in
                              pool_leaves(self.k_pool)
                              + pool_leaves(self.v_pool))}
        if self.device.type == "cuda":
            out["allocated"] = torch.cuda.memory_allocated(self.device)
            out["reserved"] = torch.cuda.memory_reserved(self.device)
        return out

    def _fail_group(self) -> List[TokenEvent]:
        """The rank group is broken: the engine cannot serve again.  Every
        request, queued ones too, gets one terminal error event; the
        fetch pipeline is dropped unread."""
        events: List[TokenEvent] = list(self._out_events)
        self._out_events = []
        self._pending.clear()
        self._pending_steps = 0
        self._constrained_fetch = None
        self.waiting.clear()
        self.waiting_bg.clear()
        self.parked.clear()
        self.slots = [None] * self.ecfg.max_batch
        reason = "error:distributed"
        for req in list(self._requests.values()):
            req.state = FINISHED
            req.finish_reason = reason
            req.seq = None
            req.slot = -1
            req.pending_tok = None
            self._finalize_slo(req, reason)
            add_event(req.trace, "engine.recover", {"reason": reason})
            events.append(TokenEvent(req.request_id, None, finished=True,
                                     finish_reason=reason))
        self._requests.clear()
        return events

    # ------------------------------------------------------------------
    # deadlines
    # ------------------------------------------------------------------

    def _check_deadlines(self) -> None:
        """Time out requests past their TTFT / total deadline.  DRAINING
        requests are exempt: their dispatching stopped and a terminal
        event is imminent."""
        ecfg = self.ecfg
        now = time.monotonic()
        for req in list(self._requests.values()):
            if req.state in (FINISHED, DRAINING):
                continue
            total = req.deadline_s if req.deadline_s is not None \
                else ecfg.max_total_s
            ttft = req.deadline_ttft_s if req.deadline_ttft_s is not None \
                else ecfg.max_ttft_s
            age = now - req.submit_time
            if (total is not None and age > total) or (
                    ttft is not None and req.first_token_time is None
                    and age > ttft):
                self._timeout(req)

    def _timeout(self, req: GenRequest) -> None:
        logger.warning("request %s timed out after %.2fs (state %s)",
                       req.request_id, time.monotonic() - req.submit_time,
                       req.state)
        if req.state == WAITING:
            self._unqueue(req)
        req.state = FINISHED
        req.finish_reason = "timeout"
        self._finalize_slo(req, "timeout")
        if self.flight is not None:
            self.flight.note_cause("timeout")
        self._release_slot(req)
        self._requests.pop(req.request_id, None)
        self._out_events.append(TokenEvent(req.request_id, None, finished=True,
                                           finish_reason="timeout"))

    # ------------------------------------------------------------------
    # the fetch pipeline
    # ------------------------------------------------------------------

    def _timer(self) -> Optional[Any]:
        """A timing event recorded now on the stream (CUDA), the start of
        a dispatch's measured span; None on the CPU."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _fetch(self, toks: torch.Tensor, items: List[Optional[GenRequest]],
               final: List[List[Optional[str]]], steps: int = 1,
               logits: Optional[torch.Tensor] = None,
               spec: Optional[_SpecMeta] = None,
               decode: bool = True, kind: str = "decode",
               modeled_s: Optional[float] = None,
               t_start: Optional[Any] = None,
               spans: Optional[List[Tuple[Any, Any]]] = None) -> _Fetch:
        """Start the host copy of a dispatch's device tokens (and kept
        logits) and enqueue it.  On CUDA the copy goes into pinned host
        memory with non_blocking=True and a timing event marks its
        landing, which closes the span that `t_start` (the dispatch's
        start event) opens; `spans` are the dispatch's earlier spans.  The
        device buffers may be overwritten by the next dispatch, which the
        stream orders after the copy."""
        keep = logits if self.ecfg.keep_logits else None
        if self.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            if keep is not None:
                lh = torch.empty(keep.shape, dtype=torch.float32,
                                 pin_memory=True)
                lh.copy_(keep, non_blocking=True)
                keep = lh
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            spans = list(spans or [])
            if t_start is not None:
                spans.append((t_start, event))
        else:
            host = toks.clone()
            keep = keep.float().clone() if keep is not None else None
            event = None
        entry = _Fetch(toks=host, items=items, final=final,
                       t0=time.monotonic(), steps=steps, spec=spec,
                       event=event, logits=keep, decode=decode, kind=kind,
                       modeled_s=modeled_s, spans=spans)
        self._pending.append(entry)
        self._pending_steps += entry.steps
        return entry

    def _entry_ready(self, entry: _Fetch) -> bool:
        """Has the entry's copy landed?  (Non-blocking; the CPU's entries
        are ready at once.)"""
        return entry.event is None or entry.event.query()

    def _stamp_ready(self) -> None:
        now = time.monotonic()
        for e in self._pending[:8]:
            if e.t_ready is None and self._entry_ready(e):
                self._note_ready(e, now)

    def _note_ready(self, entry: _Fetch, now: float) -> None:
        """Stamp one fetch's landing and its MEASURED device time
        (kafka_tpu/runtime/engine.py _note_ready).  On CUDA: the sum of
        its dispatch's timing-event spans, exact once the copy event has
        completed.  On the CPU the reference's rule: with in-order
        execution a dispatch starts at max(its enqueue, the previous
        completion), so completion minus that start is its time —
        observed at scheduler cadence, so the per-kind sums, not single
        samples, are the calibrated quantity."""
        entry.t_ready = now
        if entry.spans is not None:
            measured = _spans_s(entry.spans)
            for kind, toks, flops, bytes_, spans in entry.costs:
                self.metrics.record_dispatch_cost(
                    kind, toks, flops, bytes_, busy_s=_spans_s(spans))
        else:
            start = entry.t0
            if self._last_ready_t is not None and \
                    self._last_ready_t > start:
                start = self._last_ready_t
            self._last_ready_t = now
            measured = now - start
            if measured < 0.0 or measured > 10.0:
                return  # clock weirdness / wedged device
        if entry.modeled_s is not None:
            self.metrics.record_measured_dispatch(
                entry.kind, entry.modeled_s, measured)
        if self.flight is not None:
            self.flight.note_measured(measured)

    def _rtt_age_bound(self) -> float:
        return max(1.25 * self._rtt_est, 0.002)

    def _emit_wait(self) -> float:
        """Age at which a landed fetch is popped without depth pressure:
        with <= 2 active lanes ~the device->host round trip (a lone
        interactive stream gets smooth per-token cadence), otherwise
        fetch_wait_s."""
        if self.num_active <= 2:
            return min(self.ecfg.fetch_wait_s, self._rtt_age_bound())
        return self.ecfg.fetch_wait_s

    def _drain(self, block: bool) -> None:
        """Process matured fetches into events (self._out_events).

        Non-blocking mode pops the head entry when the pipeline is deeper
        than fetch_lag steps (a forced pop: it waits on that entry's
        event, never on the device), or when it has landed and is older
        than _emit_wait — with speculation on, a landed entry pops at
        once (a lane proposes only from a drained history)."""
        wait = self._emit_wait()
        self._stamp_ready()
        emitted = 0
        while self._pending:
            if not block:
                entry = self._pending[0]
                within_lag = self._pending_steps <= self.ecfg.fetch_lag
                aged = time.monotonic() - entry.t0 >= wait
                landed = entry.t_ready is not None
                if within_lag and not aged:
                    if not (self.ecfg.speculative_k > 0 and landed):
                        break
                elif within_lag and not landed:
                    break
            popped = self._pending.pop(0)
            self._pending_steps -= popped.steps
            emitted += self._process_entry(popped)
        if not self._pending:
            # empty pipeline: the next completion's measured time starts
            # at its own enqueue, not a stale completion
            self._last_ready_t = None
        if emitted:
            self.metrics.record_emit_burst(emitted)
            if self.flight is not None:
                self.flight.note_pop(emitted)

    def _pop_entry_now(self, entry: _Fetch) -> None:
        """Take one entry out of the FIFO and process it now: safe out of
        order only for a request that has no older entry (a just-finished
        prefill)."""
        self._pending.remove(entry)
        self._pending_steps -= entry.steps
        n = self._process_entry(entry)
        if n:
            self.metrics.record_emit_burst(n)

    def _pop_through(self, entry: _Fetch) -> None:
        """Process pending entries in FIFO order up to and including
        `entry` (per-request token order must hold)."""
        n = 0
        while self._pending:
            e = self._pending.pop(0)
            self._pending_steps -= e.steps
            n += self._process_entry(e)
            if e is entry:
                break
        if n:
            self.metrics.record_emit_burst(n)

    def _process_entry(self, entry: _Fetch) -> int:
        """Materialize one fetch (waiting on its event if the copy has not
        landed) and process its tokens.  Returns the tokens processed."""
        if entry.event is not None and not entry.event.query():
            t0 = time.monotonic()
            self._wait_event(entry.event)
            # dispatch -> landed bounds the round trip from above but also
            # holds the device backlog: shrink freely, grow slowly and
            # never past 2x the compute-free probe
            sample = time.monotonic() - entry.t0
            if time.monotonic() - t0 > 0.001:
                if sample < self._rtt_est:
                    self._rtt_est = 0.75 * self._rtt_est + 0.25 * sample
                else:
                    self._rtt_est = min(0.9 * self._rtt_est + 0.1 * sample,
                                        max(2.0 * self._rtt_probe, 0.001))
        if entry.t_ready is None and entry.spans is not None:
            # landed (CUDA): every entry's event spans are read, stamped
            # or not before its pop
            self._note_ready(entry, time.monotonic())
        if entry.decode:
            # decode spans end when the tokens land on the host: a
            # dispatch is only an enqueue, up to fetch_lag steps ahead
            self._trace_decode(entry)
        if entry.spec is not None:
            return self._finish_verify_entry(entry)
        vals = entry.toks.view(entry.steps, -1).tolist()
        n = 0
        for j in range(entry.steps):
            row, finals = vals[j], entry.final[j]
            for i, req in enumerate(entry.items):
                if req is None:
                    continue
                if req.state == FINISHED:
                    # dispatched after the request finished (a stop token
                    # found in flight, a cancel)
                    self.metrics.record_wasted_token()
                    continue
                if entry.logits is not None:
                    req.logits.append(entry.logits[j, i])
                n += 1
                self._process_token(req, row[i], finals[i])
        return n

    def _trace_decode(self, entry: _Fetch) -> None:
        """One engine.decode span per traced lane of a landed decode or
        verify fetch: from the lane's previous span end (or its first
        dispatch) to the landing, with the fused-step count and batch
        occupancy — on a verify also the candidates proposed and kept.
        An untraced lane costs one branch."""
        now = None
        for i, req in enumerate(entry.items):
            if req is None or req.trace is None or req.state == FINISHED:
                continue
            if now is None:
                now = entry.t_ready or time.monotonic()
                busy = sum(m is not None for m in entry.items)
            attrs = {"steps": entry.steps, "busy": busy}
            if entry.spec is not None and entry.spec.cand_lens[i]:
                attrs["proposed"] = entry.spec.cand_lens[i]
                attrs["accepted"] = int(entry.toks[i, entry.spec.width])
            record_span(req.trace, "engine.decode",
                        now - (req.trace_last_t or req.t_first_dispatch
                               or now), attrs=attrs)
            req.trace_last_t = now

    def _finish_verify_entry(self, entry: _Fetch) -> int:
        """Drain one verify dispatch: each proposer's host accounting is
        reconciled to its accepted run (the device already clamped its
        length and last token at dispatch) and its 1..K+1 tokens are
        emitted with plain decode's host limits applied token by token;
        riders drain like a plain decode row."""
        meta = entry.spec
        vals = entry.toks.tolist()
        finals = entry.final[0]
        n = 0
        for i, req in enumerate(entry.items):
            if req is None:
                continue
            row, cl = vals[i], meta.cand_lens[i]
            if cl == 0:
                if req.state == FINISHED:
                    self.metrics.record_wasted_token()
                    continue
                if entry.logits is not None:
                    req.logits.append(entry.logits[i, 0])
                n += 1
                self._process_token(req, row[0], finals[i])
                continue
            m = row[meta.width]  # accepted candidates (0..cl)
            req.spec_ahead = 0
            if req.state == FINISHED:
                # the whole run is discarded: every candidate counts
                # rejected (proposed == accepted + rejected + in flight)
                # and the would-be emissions are fetch-pipeline waste
                self.metrics.record_verify_drain(0, cl)
                self.metrics.record_wasted_token(m + 1)
                continue
            self.metrics.record_verify_drain(m, cl - m)
            if req.spec is not None:
                req.spec.observe(m, cl)
            emit = m + 1  # the accepted run and the bonus token
            old_len, old_disp = req.seq.length, req.dispatched
            req.seq.length += emit
            req.dispatched += emit
            for j in range(emit):
                final = None
                if old_disp + j + 1 >= req.max_new_tokens or \
                        old_len + j + 2 >= self.ecfg.max_window:
                    final = "length"
                if entry.logits is not None:
                    req.logits.append(entry.logits[i, j])
                n += 1
                self._process_token(req, row[j], final)
                if req.state == FINISHED:
                    self.metrics.record_wasted_token(emit - (j + 1))
                    break
        return n

    def _process_token(self, req: GenRequest, token: int,
                       final_reason: Optional[str]) -> None:
        req.drained += 1
        if req.predicted:
            # a chained token ran with a one-id mask row: the sampled
            # value is exactly the prediction
            expected = req.predicted.pop(0)
            assert expected == token, (
                f"constrained prediction diverged: {expected} != {token}")
        req.output_ids.append(token)
        if req.grammar is not None:
            self.metrics.constrained_ondevice_tokens += 1
        if req.spec is not None:
            req.spec.push(token)  # keep the n-gram index tail-accurate
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
            self.metrics.record_first_token(
                req.first_token_time - req.submit_time)
            self.metrics.record_ttft_breakdown(
                req.submit_time, req.t_prefill_start, req.t_first_dispatch,
                req.first_token_time)
            if req.trace is not None and req.t_first_dispatch is not None:
                # first dispatch -> first token on the host
                record_span(
                    req.trace, "emit",
                    req.first_token_time - req.t_first_dispatch,
                    attrs={"ttft_ms": round(
                        (req.first_token_time - req.submit_time) * 1e3, 2)})
        self.metrics.record_token()
        if token in req.stop_token_ids:
            reason = "stop"
        elif final_reason is not None:
            reason = final_reason
        else:
            self._out_events.append(TokenEvent(req.request_id, token))
            return
        if reason == "handoff":
            # prefill-and-hand-off: the request leaves with its pages —
            # no terminal event and no SLO verdict here (the decode
            # replica finalizes the true finish).  The run is stored
            # into this replica's radix cache first: a shared prefix
            # stays warm on the prefill pool, and the cache's retains
            # keep the pages alive through the ship after the router
            # frees the sequence.
            req.state = FINISHED
            if req.seq is not None and self.prefix_cache is not None:
                self.prefix_cache.store(
                    req.prefix_key,
                    (req.prompt_ids + req.output_ids)[: req.seq.length],
                    req.seq.pages)
            self._requests.pop(req.request_id, None)
            self.handoffs.append((req, token))
            return
        req.finish_reason = reason
        req.state = FINISHED
        self._finalize_slo(req, reason)
        if req.seq is not None and req.prefix_key is not None \
                and self.prefix_cache is not None:
            # Cache the thread's KV before the pages go back to the pool
            # (the cache takes its own retains).  Store only tokens whose
            # KV is materialized: seq.length counts them — the final
            # sampled token's KV is never written (it is the pending
            # decode input), so a page-aligned next turn must not share a
            # page holding an unwritten slot.  Positions past the stored
            # range may hold discarded in-flight KV; only whole pages
            # inside it are ever shared.
            self.prefix_cache.store(
                req.prefix_key,
                (req.prompt_ids + req.output_ids)[: req.seq.length],
                req.seq.pages)
        self._release_slot(req)
        self._requests.pop(req.request_id, None)
        self._out_events.append(TokenEvent(req.request_id, token,
                                           finished=True,
                                           finish_reason=reason))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _pages_needed(self, req: GenRequest) -> int:
        """Fresh pages the next prefill must allocate."""
        total = len(req.prefill_ids) + 1  # +1 so decode always has a slot
        have = len(req.seq.pages) if req.seq is not None else 0
        return max(0, -(-total // self.ecfg.page_size) - have)

    def _admit(self) -> None:
        """Strict submit-order FIFO across the waiting queue and the
        parked lanes: each free slot goes to the older of the waiting head
        and the oldest parked lane.  A page-blocked waiting head yields
        the slot to parked lanes (seating them needs no pages, and their
        completions free pages for the head)."""
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            oldest = (min(self.parked, key=lambda r: r.submit_time)
                      if self.parked else None)
            head = self.waiting[0] if self.waiting else None
            if head is None and oldest is None:
                break
            head_first = head is not None and (
                oldest is None or head.submit_time < oldest.submit_time)
            if head_first and self._admit_waiting_head(slot):
                continue
            if oldest is None:
                break  # head page-blocked, nothing parked to seat
            self.parked.remove(oldest)
            self._seat(oldest, slot)
            if self.flight is not None:
                self.flight.note_cause("admit_parked")
        self._admit_offslot()
        if self.waiting_bg:
            self._admit_background()

    def _admit_waiting_head(self, slot: int) -> bool:
        """Start the waiting head's prefill in `slot`; False (queue
        untouched) when page-blocked.  A blocked head drops the prefix
        retains it took for the page estimate: waiting requests must not
        pin pool pages."""
        req = self.waiting[0]
        self._attach_prefix(req)
        needed = self._pages_needed(req)
        if needed > self.pool.free_pages and \
                not self._reclaim_cache(needed, req):
            self._detach_prefix(req)
            if self.flight is not None:
                self.flight.note_cause("page_blocked")
            return False
        self.waiting.pop(0)
        try:
            self._start_prefill(req, slot)
        except OutOfPagesError:
            self._detach_prefix(req)
            req.state = WAITING
            self.waiting.insert(0, req)
            if self.flight is not None:
                self.flight.note_cause("page_blocked")
            return False
        if self.flight is not None:
            self.flight.note_cause("admit")
        return True

    def _seat(self, req: GenRequest, slot: int) -> None:
        """Move an off-slot lane into a decode slot: a PARKED lane joins
        decode at once (its pages and first token exist), a PREFILLING
        one finishes its chunks as a slot lane."""
        req.slot = slot
        self.slots[slot] = req
        self._ctl_dirty = True
        if req.state == PARKED:
            req.state = ACTIVE
            if req.pending_tok:
                self._dev_set_last(slot, None, req.request_id)
            else:  # resumed: the pending token is host-known
                self._dev_set_last(slot, req.output_ids[-1], None)
            req.pending_tok = None
            self._set_fsm_lane(req, slot)

    def _admit_offslot(self) -> None:
        """Start off-slot prefills for waiting requests when every slot is
        busy (EngineConfig.max_parked): their first token comes from the
        prefill, which needs pages but no slot.  Gated on pool headroom:
        park_reserve_pages stay free for active lanes' decode growth."""
        ecfg = self.ecfg
        if ecfg.max_parked <= 0 or not self.waiting:
            return
        if self._park_cooldown > 0:
            return  # a recent page-pressure rollback: let active lanes grow
        if self._free_slot() is not None:
            return  # slot admission (or its page gate) owns the queue head
        reserve = (ecfg.park_reserve_pages
                   if ecfg.park_reserve_pages is not None
                   else 2 * ecfg.max_batch)
        while self.waiting and len(self.parked) < ecfg.max_parked:
            req = self.waiting[0]
            self._attach_prefix(req)
            if self._pages_needed(req) > self.pool.free_pages - reserve:
                self._detach_prefix(req)
                break
            self.waiting.pop(0)
            try:
                self._start_prefill(req, -1)
            except OutOfPagesError:
                self._detach_prefix(req)
                req.state = WAITING
                self.waiting.insert(0, req)
                break
            self.parked.append(req)
            if self.flight is not None:
                self.flight.note_cause("park")

    def _admit_background(self) -> None:
        """Admit at most one background request per iteration, and only
        into capacity nobody interactive wants: a free slot with the
        interactive queue empty, and pages outside the park reserve."""
        if self.waiting:
            return  # interactive demand owns admission
        slot = self._free_slot()
        if slot is None:
            return
        ecfg = self.ecfg
        reserve = (ecfg.park_reserve_pages
                   if ecfg.park_reserve_pages is not None
                   else 2 * ecfg.max_batch)
        req = self.waiting_bg[0]
        self._attach_prefix(req)
        needed = self._pages_needed(req)
        if needed > self.pool.free_pages - reserve:
            # a cold radix cache is idle capacity too: reclaim it, but
            # keep the park reserve, or a cache-saturated idle engine
            # would starve its background queue forever
            if not self._reclaim_cache(needed + reserve, req):
                self._detach_prefix(req)
                return
        self.waiting_bg.pop(0)
        try:
            self._start_prefill(req, slot)
        except OutOfPagesError:
            self._detach_prefix(req)
            req.state = WAITING
            self.waiting_bg.insert(0, req)
            return
        self.bg_admitted += 1
        if self.flight is not None:
            self.flight.note_cause("bg_admit")

    def _attach_prefix(self, req: GenRequest) -> None:
        """Share the longest cached prefix before the admission page gate:
        the gate then sizes the allocation net of the share, and a
        reclaim under pressure cannot evict the run this request is
        about to reuse (the lookup retained its pages)."""
        if req.prefix_key is None or self.prefix_cache is None \
                or req.seq is not None:
            return
        req.cached_tokens = 0
        req.cache_source = None
        req.promoted_tokens = 0
        req.object_tokens = 0
        if self.kv_tier is not None:
            # kv.promote / kv.object_get / thread.wake spans inside the
            # lookup attach to this request
            self.kv_tier.trace_ctx = req.trace
        try:
            hit = self.prefix_cache.lookup(req.prefix_key, req.prefill_ids)
        finally:
            if self.kv_tier is not None:
                self.kv_tier.trace_ctx = None
        if hit is not None:
            req.seq = SequencePages(seq_id=req.request_id)
            req.seq.pages, req.seq.length = hit.pages, hit.tokens
            req.cached_tokens = hit.tokens
            req.cache_source = hit.source
            req.promoted_tokens = hit.promoted_tokens
            req.object_tokens = hit.object_tokens

    def _detach_prefix(self, req: GenRequest) -> None:
        """Roll back a page-blocked _attach_prefix: free the retains and
        clear the hit record (hits count only when the prefill starts)."""
        if req.seq is not None:
            self.pool.free_sequence(req.seq)
            req.seq = None
        req.cached_tokens = 0
        req.cache_source = None
        req.promoted_tokens = 0
        req.object_tokens = 0

    def _reclaim_cache(self, pages_needed: int,
                       req: Optional[GenRequest] = None) -> bool:
        """Evict (or, with the tier, demote) prefix-cache leaves until
        `pages_needed` pages are free; False when the cache cannot free
        enough (or there is none).  kv.demote spans attach to `req`, the
        request whose page pressure drives the eviction."""
        if self.prefix_cache is None:
            return False
        if self.kv_tier is not None:
            self.kv_tier.trace_ctx = req.trace if req is not None else None
        try:
            return self.prefix_cache.reclaim(pages_needed)
        finally:
            if self.kv_tier is not None:
                self.kv_tier.trace_ctx = None

    def _start_prefill(self, req: GenRequest, slot: int) -> None:
        """Reserve the prompt's pages and the slot (-1: off-slot); chunks
        run via _advance_prefills."""
        if req.t_prefill_start is None:  # keep the FIRST start on resume
            req.t_prefill_start = time.monotonic()
            if req.trace is not None:
                record_span(req.trace, "engine.queue",
                            req.t_prefill_start - req.submit_time,
                            attrs={"depth": len(self.waiting)})
        elif req.trace is not None:
            # re-prefill after preemption: an instant event with the
            # radix-cache share
            add_event(req.trace, "resume", self._prefill_attrs(req))
        req.seq = req.seq or SequencePages(seq_id=req.request_id)
        self.pool.ensure_capacity(req.seq, len(req.prefill_ids) + 1)
        if req.cached_tokens and self.prefix_cache is not None:
            # the attach survived the page gate: now the hit counts
            self.prefix_cache.commit_hit(req.cached_tokens, req.cache_source)
        if req.usage_cached_tokens is None:
            req.usage_cached_tokens = req.cached_tokens
        req.state = PREFILLING
        req.slot = slot
        if slot >= 0:
            self.slots[slot] = req
            self._ctl_dirty = True

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _prefill_bucket_for(self, req: GenRequest) -> int:
        remaining = len(req.prefill_ids) - req.seq.length
        if req.background and any(
                s is not None and s.state == ACTIVE and not s.background
                for s in self.slots):
            # a background chunk shrinks to the smallest bucket while an
            # interactive lane decodes: the added inter-token gap is one
            # small chunk's compute
            return self.ecfg.prefill_buckets[0]
        return next((b for b in self.ecfg.prefill_buckets if b >= remaining),
                    self.ecfg.prefill_buckets[-1])

    def _advance_prefills(self) -> None:
        """Advance the OLDEST <= W prefilling lanes (slot and off-slot)
        one chunk (W = the batched-prefill width).  Same-bucket free lanes
        fuse into one batched dispatch; on the kernel backend only buckets
        <= 128 do, so long chunks keep the flash prefill kernel;
        constrained lanes take the single-sequence path."""
        prefilling = [s for s in self.slots
                      if s is not None and s.state == PREFILLING] + \
            [r for r in self.parked if r.state == PREFILLING]
        if not prefilling:
            return
        bg = [r for r in prefilling if r.background]
        if bg:
            # background lanes yield their chunk to any interactive
            # prefill; with none pending, one background lane advances
            # one chunk
            interactive = [r for r in prefilling if not r.background]
            if interactive:
                prefilling = interactive
                self.bg_yields += 1
                if self.flight is not None:
                    self.flight.note_cause("bg_yield")
            else:
                bg.sort(key=lambda r: r.submit_time)
                prefilling = bg[:1]
                self.bg_chunks += 1
                if self.flight is not None:
                    self.flight.note_cause("bg_prefill")
        W = min(4, self.ecfg.max_batch)
        if len(prefilling) > W:
            prefilling.sort(key=lambda r: r.submit_time)
            prefilling = prefilling[:W]
        groups: Dict[int, List[GenRequest]] = {}
        singles: List[GenRequest] = []
        for req in prefilling:
            bucket = self._prefill_bucket_for(req)
            if W >= 2 and req.logits_mask_fn is None \
                    and req.grammar is None and (
                        self.cfg.attention_backend != "kernel"
                        or bucket <= 128):
                groups.setdefault(bucket, []).append(req)
            else:
                singles.append(req)
        for bucket, reqs in groups.items():
            while len(reqs) >= 2:
                take, reqs = reqs[:W], reqs[W:]
                self._advance_prefill_batch(bucket, take, W)
            singles.extend(reqs)
        for req in singles:
            self._advance_prefill(req)

    def _page_row(self, req: GenRequest) -> np.ndarray:
        row = np.full(self.ecfg.max_pages_per_seq, TRASH_PAGE, np.int32)
        row[: len(req.seq.pages)] = req.seq.pages
        return row

    def _write_slots(self, row: np.ndarray, start: int, n: int,
                     width: int) -> np.ndarray:
        """Flat pool slots for positions start..start+width-1 of a page
        row; positions past the first n go to the trash page."""
        ps = self.ecfg.page_size
        local = np.arange(width)
        pos = start + local
        live = local < n
        page = row[np.where(live, pos // ps, 0)]
        return np.where(live, page.astype(np.int64) * ps + pos % ps,
                        local % ps)

    def _chunk_override(self, req: GenRequest, start: int, bucket: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The embed-override slices (ov [bucket, H], on [bucket]) of the
        prompt span [start, start + bucket); None when the span holds no
        override row (JAX runtime/engine.py _chunk_override)."""
        if req.override_pos is None:
            return None
        sel = (req.override_pos >= start) & \
            (req.override_pos < start + bucket)
        if not sel.any():
            return None
        ov = np.zeros((bucket, self.cfg.hidden_size), np.float32)
        on = np.zeros((bucket,), bool)
        idx = req.override_pos[sel] - start
        ov[idx] = req.override_rows[sel]
        on[idx] = True
        return ov, on

    def _override_args(self, ov: Optional[tuple],
                       shape: Tuple[int, int]) -> Dict[str, Any]:
        """forward()'s embed-override arguments for a prefill dispatch of
        `shape` [B, S]: none on a text-only model; on a vision model every
        prefill passes the pair, the cached all-zero one for a span with
        no image (one argument shape per bucket, as the reference's
        prefill programs take)."""
        if self.cfg.vision is None:
            return {}
        if ov is None:
            ov = self._zero_override(shape)
        else:
            ov = (self._to_device(ov[0]), self._to_device(ov[1]))
        return {"embed_override": ov[0], "override_on": ov[1]}

    def _zero_override(self, shape: Tuple[int, int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident all-zero (ov, on) pair, cached per shape: a
        text-only chunk of a vision engine uploads nothing."""
        if shape not in self._zero_ov_cache:
            self._zero_ov_cache[shape] = (
                torch.zeros(shape + (self.cfg.hidden_size,),
                            dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.bool, device=self.device))
        return self._zero_ov_cache[shape]

    def _advance_prefill(self, req: GenRequest) -> None:
        """Dispatch ONE single-sequence prefill chunk; the final chunk
        samples the first token and activates (or parks) the lane."""
        failpoint("engine.prefill")
        start = req.seq.length
        prompt = req.prefill_ids
        bucket = self._prefill_bucket_for(req)
        chunk_len = min(len(prompt) - start, bucket)
        chunk = np.zeros(bucket, np.int64)
        chunk[:chunk_len] = prompt[start:start + chunk_len]
        row = self._page_row(req)
        final = start + chunk_len >= len(prompt)
        sample = (self._sample_args([req], [start + chunk_len - 1],
                                    self._prefill_masks([req]))
                  if final else None)
        ov = self._chunk_override(req, start, bucket)
        t_start = self._timer()
        rows, toks = self._dev_prefill(
            chunk, self._write_slots(row, start, chunk_len, bucket), row,
            start, chunk_len, sample,
            None if ov is None else (ov[0][None], ov[1][None]))
        self._prefill_dispatched(t_start, [(chunk_len, start)])
        req.seq.length = start + chunk_len
        if not final:
            return  # more chunks to go; decode proceeds meanwhile
        self._finish_prefills([req], toks, rows)

    @replicated
    def _dev_prefill(self, chunk: np.ndarray, write: np.ndarray,
                     row: np.ndarray, start: int, chunk_len: int,
                     sample: Optional[tuple], ov: Optional[tuple] = None):
        """One single-sequence prefill chunk on the device; a final chunk
        (`sample`: _sample_args) samples its first token too; `ov` is the
        chunk's embed override (_chunk_override, batched).  Returns the
        sampled row's logits and tokens (None for other chunks)."""
        dev, C = self.device, self.ecfg.max_window
        kv_pos = torch.arange(C, device=dev)[None]
        paged = PagedView(
            write_idx=self._to_device(write[None]),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=kv_pos < start + chunk_len,
            page_table=self._to_device(row[None]),
            page_size=self.ecfg.page_size,
            start=start,
            chunk_len=chunk_len,
        )
        positions = (start + torch.arange(len(chunk), device=dev))[None]
        logits, _ = forward(
            self.params, self.cfg, self._to_device(chunk[None]),
            positions, kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
            logits_at=self._to_device(np.asarray([chunk_len - 1])),
            tp=self.tp, **self._override_args(ov, (1, len(chunk))),
        )
        if sample is None:
            return None, None
        rows = logits[:, 0]
        self._prefill_toks = self._sample_on_device(rows, sample)
        return rows, self._prefill_toks

    def _advance_prefill_batch(self, bucket: int, reqs: List[GenRequest],
                               W: int) -> None:
        """One fused chunk dispatch for 2..W same-bucket lanes (plain
        attention over each lane's page-gathered window)."""
        failpoint("engine.prefill")
        ps = self.ecfg.page_size
        rows = np.full((W, self.ecfg.max_pages_per_seq), TRASH_PAGE, np.int32)
        chunks = np.zeros((W, bucket), np.int64)
        starts = np.zeros(W, np.int64)
        lens = np.zeros(W, np.int64)
        write = np.zeros((W, bucket), np.int64)
        for i in range(W):
            write[i] = np.arange(bucket) % ps  # idle lanes: trash page
        chunk_ovs = []
        for i, req in enumerate(reqs):
            start = req.seq.length
            clen = min(len(req.prefill_ids) - start, bucket)
            chunks[i, :clen] = req.prefill_ids[start:start + clen]
            rows[i] = self._page_row(req)
            starts[i], lens[i] = start, clen
            write[i] = self._write_slots(rows[i], start, clen, bucket)
            chunk_ovs.append(self._chunk_override(req, start, bucket))
        ov = None
        if any(co is not None for co in chunk_ovs):
            ov = (np.zeros((W, bucket, self.cfg.hidden_size), np.float32),
                  np.zeros((W, bucket), bool))
            for i, co in enumerate(chunk_ovs):
                if co is not None:
                    ov[0][i], ov[1][i] = co
        active = np.zeros(W, bool)
        active[: len(reqs)] = True
        ends = np.where(active, starts + lens, 0)
        last = np.clip(lens - 1, 0, bucket - 1)
        done = [i for i, req in enumerate(reqs)
                if req.seq.length + int(lens[i]) >= len(req.prefill_ids)]
        finished = [reqs[i] for i in done]
        sample = (self._sample_args(
            finished, [int(starts[i] + lens[i] - 1) for i in done], None)
            if done else None)
        t_start = self._timer()
        rows_l, toks = self._dev_prefill_batch(chunks, write, rows, starts,
                                               ends, last, done, sample, ov)
        self._prefill_dispatched(
            t_start, [(int(lens[i]), int(starts[i])) for i in range(len(reqs))])
        for i, req in enumerate(reqs):
            req.seq.length += int(lens[i])
        if not done:
            return
        self._finish_prefills(finished, toks, rows_l)

    @replicated
    def _dev_prefill_batch(self, chunks: np.ndarray, write: np.ndarray,
                           rows: np.ndarray, starts: np.ndarray,
                           ends: np.ndarray, last: np.ndarray,
                           done: List[int], sample: Optional[tuple],
                           ov: Optional[tuple] = None):
        """One fused prefill chunk over W lanes (plain attention over each
        lane's page-gathered window); the lanes in `done` sample their
        first tokens; `ov` is the lanes' embed override.  Returns their
        logits rows and tokens."""
        W, bucket = chunks.shape
        dev, C = self.device, self.ecfg.max_window
        kv_pos = torch.arange(C, device=dev).expand(W, C)
        paged = PagedView(
            write_idx=self._to_device(write),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=kv_pos < self._to_device(ends)[:, None],
            page_table=self._to_device(rows),
            page_size=self.ecfg.page_size,
        )
        positions = self._to_device(starts)[:, None] + \
            torch.arange(bucket, device=dev)[None]
        logits, _ = forward(
            self.params, self.cfg, self._to_device(chunks),
            positions, kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
            logits_at=self._to_device(last), tp=self.tp,
            **self._override_args(ov, (W, bucket)),
        )
        if sample is None:
            return None, None
        rows_l = logits[done, 0]
        self._prefill_toks = self._sample_on_device(rows_l, sample)
        return rows_l, self._prefill_toks

    def _finish_prefills(self, reqs: List[GenRequest], toks: torch.Tensor,
                         logits: torch.Tensor) -> None:
        """Last chunks dispatched: each lane joins the decode batch (or
        parks awaiting a slot when it prefilled off-slot).  Its first
        token seeds the lane's device last token straight from the
        device; its value reaches the host through the fetch pipeline.  A
        resumed lane's token is the duplicate of output_ids[-1] and is
        dropped.  Host-masked lanes pop their token at once: their first
        decode mask needs it."""
        items: List[Optional[GenRequest]] = [None] * len(reqs)
        finals: List[Optional[str]] = [None] * len(reqs)
        fused = len(reqs) > 1
        for i, req in enumerate(reqs):
            slot = req.slot
            if req.t_first_dispatch is None:
                req.t_first_dispatch = time.monotonic()
                if req.trace is not None:
                    attrs = self._prefill_attrs(req)
                    if fused:
                        attrs["fused"] = True
                    record_span(req.trace, "engine.prefill",
                                req.t_first_dispatch - (
                                    req.t_prefill_start
                                    or req.t_first_dispatch),
                                attrs=attrs)
            if slot < 0:
                req.state = PARKED
                if req.resumed:
                    req.resumed = False
                    self._drop_parked(req)  # host-known: output_ids[-1]
                    continue
                self._dev_park_prefill(req.request_id, i)
                req.pending_tok = True
            else:
                req.state = ACTIVE
                self._ctl_dirty = True
                if req.resumed:
                    req.resumed = False
                    self._dev_set_last(slot, req.output_ids[-1], None)
                    self._set_fsm_lane(req, slot)
                    continue
                self._dev_seat_prefill(slot, i)
            req.dispatched += 1
            if slot >= 0:
                self._set_fsm_lane(req, slot)
            items[i], finals[i] = req, self._limit_reason_after_dispatch(req)
        if all(m is None for m in items):
            return
        entry = self._fetch(toks[None], items, [finals],
                            logits=logits[None], decode=False,
                            kind="prefill",
                            modeled_s=self._take_prefill_modeled(),
                            spans=self._prefill_spans)
        self._prefill_spans = []
        entry.costs, self._prefill_costs = self._prefill_costs, []
        for req, fin in zip(items, finals):
            if req is not None and fin is not None:
                self._to_draining(req)
        if any(r is not None and self._host_constrained(r) for r in items):
            self._pop_entry_now(entry)

    @staticmethod
    def _prefill_attrs(req: GenRequest) -> Dict[str, Any]:
        """engine.prefill span attrs: prompt size plus the radix-cache
        share when the prefill resumed past cached pages.  Traced
        requests only — cold path."""
        attrs: Dict[str, Any] = {"tokens": len(req.prefill_ids)}
        if req.cached_tokens:
            attrs["cached_tokens"] = req.cached_tokens
            attrs["cache_source"] = req.cache_source
            if req.promoted_tokens:
                attrs["promoted_tokens"] = req.promoted_tokens
            if req.object_tokens:
                attrs["object_tokens"] = req.object_tokens
        return attrs

    def _limit_reason_after_dispatch(self, req: GenRequest) -> Optional[str]:
        """After a dispatch, has the request hit a host-known limit?  Stop
        tokens are the only finish the host cannot predict; those are
        found when the fetch matures."""
        if req.dispatched >= req.max_new_tokens:
            return "length"
        if req.seq is not None and req.seq.length + 1 >= self.ecfg.max_window:
            return "length"
        if req.handoff:
            # prefill-and-hand-off ends at the first token (after the
            # genuine limits: a one-token request finishes for real)
            return "handoff"
        return None

    def _to_draining(self, req: GenRequest) -> None:
        """Stop dispatching for a request whose last tokens are in flight.
        Its slot frees at once; so do its pages, unless it carries a
        prefix_key (kept until the final fetch matures, so the exact
        materialized tokens are stored into the prefix cache with them)."""
        req.state = DRAINING
        if req.slot >= 0:
            self._vacate(req.slot)
            req.slot = -1
        elif req in self.parked:
            self.parked.remove(req)  # finished at prefill (1-token budget)
        self._drop_parked(req)
        if req.prefix_key is None or self.prefix_cache is None:
            if req.seq is not None:
                self.pool.free_sequence(req.seq)
                req.seq = None

    # ------------------------------------------------------------------
    # decode dispatch
    # ------------------------------------------------------------------

    def _dispatch_decode(self) -> None:
        """Grow pages, then dispatch: a speculative verify when a lane
        proposes, else a fused k-step burst when the batch allows it,
        else one step — the host-masked lanes as their own micro-batch at
        fetch cadence beside the pipelined ones."""
        for req in [s for s in self.slots if s is not None]:
            # lanes with a verify in flight are skipped: their host length
            # is confirmed-only and their pages cover the whole span
            if req.state != ACTIVE or req.seq is None or req.spec_ahead:
                continue
            self._ensure_pages(req)
        active = [s for s in self.slots if s is not None
                  and s.state == ACTIVE and s.spec_ahead == 0]
        spec_wait = any(s is not None and s.state == ACTIVE and s.spec_ahead
                        for s in self.slots)
        if not active:
            return
        if self.ecfg.speculative_k > 0 and self._try_dispatch_verify(active):
            return
        k = 1 if spec_wait else self._pick_multi_step(active)
        if k > 1:
            self._dispatch_multi(k)
            return
        if self._ctl_dirty:
            self._refresh_ctl()
        ids = {id(s) for s in active}
        members = [s if id(s) in ids else None for s in self.slots]
        if not any(self._host_constrained(s) for s in active):
            entry = self._dispatch_group(
                members, None, fsm=any(s.grammar is not None for s in active))
            self.metrics.record_decode_step(len(active))
            self._record_decode_cost(active, entry=entry)
            return
        self._dispatch_mixed(members)

    def _dispatch_mixed(self, members: List[Optional[GenRequest]]) -> None:
        """A batch with host-masked lanes.  Their masks depend on every
        token they emitted, so they cannot be pipelined like the others
        — but nobody else waits for them: the free and device-FSM lanes
        dispatch as in the common case, and the host-masked lanes run
        beside them (_dispatch_host_masked)."""
        uncon = [m if m is not None and not self._host_constrained(m)
                 else None for m in members]
        n_uncon = sum(m is not None for m in uncon)
        entries = []
        if n_uncon:
            entries.append(self._dispatch_group(
                uncon, None,
                fsm=any(m is not None and m.grammar is not None
                        for m in uncon)))
        n_chain, n_amb, masked = self._dispatch_host_masked(members, n_uncon)
        entries += masked
        if self.flight is not None and (n_chain or n_amb):
            # host-masked groups this iteration: chained (grammar-forced,
            # no round trip) and awaited (genuine choice points)
            self.flight.note_constrained(n_chain, n_amb)
        if entries:
            # one scheduler iteration = one TPOT sample / occupancy
            # record, however many groups it took; its cost covers
            # exactly the lanes it advanced, and no single fetch carries
            # its modeled time (entry None)
            self.metrics.record_decode_step(n_uncon + n_chain + n_amb)
            advanced = [m for e in entries for m in e.items if m is not None]
            self._record_decode_cost(advanced, entries=entries)

    def _dispatch_host_masked(self, members: List[Optional[GenRequest]],
                              n_uncon: int
                              ) -> Tuple[int, int, List[_Fetch]]:
        """The host-masked lanes of _dispatch_mixed, as the reference
        runs them (kafka_tpu/runtime/engine.py _dispatch_decode's mixed
        branch).  A lane whose next token the grammar forces (the mask
        fn's forced_id, or an allowed list of one id over output_ids +
        predicted) has a host-known value: it dispatches every iteration
        as a chained group with a one-id mask row, awaiting nothing.  A
        lane at a genuine choice point joins the awaited micro-batch: it
        dispatches with its mask row once the previous awaited fetch has
        landed, and its next mask waits for this one.  Returns (chained
        lanes, awaited lanes, their fetch entries)."""
        if self._constrained_inflight():
            # pop once landed; with no pipelined lane nobody is stalled by
            # waiting, so pop at once
            entry = self._constrained_fetch
            if self._entry_ready(entry) or not n_uncon:
                self._pop_through(entry)
                self._constrained_fetch = None
        awaiting = ({id(r) for r in self._constrained_fetch.items
                     if r is not None}
                    if self._constrained_inflight() else set())
        B, V = self.ecfg.max_batch, self.cfg.vocab_size
        chain: List[Optional[GenRequest]] = [None] * B
        amb: List[Optional[GenRequest]] = [None] * B
        forced: Dict[int, int] = {}
        rows: Dict[int, Optional[np.ndarray]] = {}
        for i, s in enumerate(members):
            # a lane sits out while it waits on the awaited fetch, while
            # tokens other than its predicted chain are undrained (one
            # that just degraded off the device FSM), and once the chain
            # holds a stop token (it retires when that drains: the mask
            # fn is never called past the grammar's end)
            if s is None or not self._host_constrained(s) \
                    or s.state != ACTIVE or id(s) in awaiting \
                    or s.dispatched - s.drained != len(s.predicted) \
                    or any(t in s.stop_token_ids for t in s.predicted):
                continue
            pos = len(s.output_ids) + len(s.predicted)
            if s.mask_cache is not None and s.mask_cache[0] == pos:
                kind, val = s.mask_cache[1]  # a blocked lane: no re-walk
            else:
                kind, val = self._next_constraint(s)
                s.mask_cache = (pos, (kind, val))
            if kind == "forced":
                chain[i] = s
                forced[i] = val
            else:
                amb[i] = s
                rows[i] = val  # None: a free step
        entries: List[_Fetch] = []
        if forced:
            allowed = np.ones((B, V), bool)
            for i, tok in forced.items():
                allowed[i] = False
                allowed[i, tok] = True
            entries.append(self._dispatch_group(chain, allowed, fsm=False))
            for i, tok in forced.items():
                if chain[i].state in (ACTIVE, DRAINING):
                    chain[i].predicted.append(tok)
        if not rows or self._constrained_inflight():
            return len(forced), 0, entries
        allowed = None
        if any(ids is not None for ids in rows.values()):
            allowed = np.ones((B, V), bool)
            for i, ids in rows.items():
                if ids is None:
                    continue
                if len(ids) == 0:
                    # a fully clipped allow-list: the sampler degrades the
                    # all-False row to unconstrained
                    self._record_overtight(amb[i])
                allowed[i] = False
                allowed[i, ids] = True
        self._constrained_fetch = self._dispatch_group(amb, allowed,
                                                       fsm=False)
        entries.append(self._constrained_fetch)
        for i in rows:
            # this lane now awaits a device->host round trip for its next
            # mask: a genuine choice point
            amb[i].constrained_roundtrips += 1
            self.metrics.constrained_roundtrips += 1
        return len(forced), len(rows), entries

    def _constrained_inflight(self) -> bool:
        """Is the host-masked micro-batch still waiting on its fetch?"""
        e = self._constrained_fetch
        if e is None:
            return False
        if any(p is e for p in self._pending):
            return True
        self._constrained_fetch = None  # processed (or force-drained)
        return False

    def _pick_multi_step(self, active: List[GenRequest]) -> int:
        """How many decode steps to fuse into the next dispatch: one
        configured depth (kafka_tpu/runtime/engine.py _pick_multi_step),
        only when scheduling granularity is cheap — >= 3 active lanes, no
        host-masked lane, no lane or parked request mid-prefill, no
        page-blocked admission (a free slot with a waiting queue) — and
        no lane can reach a budget or window limit inside the burst.
        Pages are grown for all k steps first; a pool that cannot falls
        back to single steps, whose growth path reclaims and preempts."""
        ecfg = self.ecfg
        if (ecfg.multi_step <= 1 or len(active) < 3
                or any(self._host_constrained(s) for s in active)
                or any(s is not None and s.state == PREFILLING
                       for s in self.slots)
                or any(r.state == PREFILLING for r in self.parked)
                or (self.waiting and self._free_slot() is not None)):
            return 1
        k = ecfg.multi_step
        for req in active:
            if req.max_new_tokens - req.dispatched < k \
                    or ecfg.max_window - 1 - req.seq.length < k:
                return 1
        for req in active:
            if not self._grow(req.seq, req.seq.length + k):
                return 1
        return k

    def _dispatch_multi(self, k: int) -> None:
        """One fused k-step decode dispatch over every active lane;
        grammar lanes take the FSM variant, so their masks apply inside
        the burst."""
        if self._ctl_dirty:
            self._refresh_ctl()
        members = [s if s is not None and s.state == ACTIVE else None
                   for s in self.slots]
        entry = self._dispatch_group(
            members, None, steps=k,
            fsm=any(m is not None and m.grammar is not None
                    for m in members))
        self.multi_step_dispatches += 1
        self.metrics.record_decode_step(
            sum(1 for m in entry.items if m is not None), steps=k)
        self._record_decode_cost(entry.items, steps=k, entry=entry)

    def _dispatch_group(self, members: List[Optional[GenRequest]],
                        allowed: Optional[np.ndarray], fsm: bool,
                        steps: int = 1) -> _Fetch:
        """Run the decode step program `steps` times for the lanes in
        `members` (slot-aligned; None = not in this dispatch: their KV
        writes go to the trash page, their lengths, last tokens and FSM
        states stay), with `allowed` [B, V] host mask rows, then book it."""
        t_start = self._timer()
        self._dev_decode(np.array([m is not None for m in members]),
                         allowed, steps, fsm, sampling_mode(members),
                         self.ecfg.keep_logits)
        return self._book_dispatch(members, steps, t_start)

    @replicated
    def _dev_decode(self, run: np.ndarray, allowed: Optional[np.ndarray],
                    steps: int, fsm: bool, mode: int, keep: bool) -> None:
        """Upload the dispatch's lanes (and host mask rows), then run the
        `steps`-step program: a CUDA graph replay on the card.  `keep`
        is rank 0's keep_logits, mirrored on every rank: it picks the
        graph, and every rank must capture and replay the same ones."""
        self.ecfg.keep_logits = keep
        self._to_device(run, out=self._d_run)
        if allowed is not None:
            if self._d_allowed is None:
                self._d_allowed = torch.ones(
                    (self.ecfg.max_batch, self.cfg.vocab_size),
                    dtype=torch.bool, device=self.device)
            self._to_device(allowed, out=self._d_allowed)
        self._run_step(steps, fsm, mode, allowed is not None)

    def _book_dispatch(self, members: List[Optional[GenRequest]],
                       steps: int, t_start: Optional[Any] = None) -> _Fetch:
        """Post-dispatch accounting: advance each member's length and
        dispatched count by `steps`, enqueue the fetch, and start draining
        lanes that hit a host-known limit.  `steps` is chosen so limits
        trigger only on the last row (_pick_multi_step); stop tokens may
        land on any row and are reconciled when the fetch matures."""
        items: List[Optional[GenRequest]] = []
        last: List[Optional[str]] = []
        for req in members:
            if req is None:
                items.append(None)
                last.append(None)
                continue
            req.seq.length += steps  # the dispatched tokens' kv slots
            req.dispatched += steps
            items.append(req)
            last.append(self._limit_reason_after_dispatch(req))
        finals = [[None] * len(items) for _ in range(steps - 1)] + [last]
        entry = self._fetch(self._toks_buf[steps], items, finals,
                            steps=steps,
                            logits=self._logits_buf.get(steps),
                            t_start=t_start)
        if self.flight is not None:
            lanes = sum(1 for m in items if m is not None)
            self.flight.note_dispatch(KIND_MULTI if steps > 1 else KIND_DECODE,
                                      lanes, lanes * steps, steps=steps)
        for req, fin in zip(items, last):
            if req is not None and fin is not None:
                self._to_draining(req)
        return entry

    def _refresh_ctl(self) -> None:
        """Re-upload the host-authored control arrays after a scheduling
        change, in one pinned staging buffer.  Lengths come from the host
        except for lanes with a verify in flight, whose device length is
        the truth until their entry drains."""
        slots = self.slots
        keep = np.array([s is not None and s.state == ACTIVE
                         and s.spec_ahead > 0 for s in slots])
        self._dev_upload_ctl(self._ctl.pack({
            "table": page_table_array(
                [s.seq if s is not None else None for s in slots],
                self.ecfg.max_pages_per_seq),
            "lens": [s.seq.length if s is not None and s.seq else 0
                     for s in slots],
            "keep": keep,
            "temps": [s.temperature if s else 0.0 for s in slots],
            "top_ks": [s.top_k if s else 0 for s in slots],
            "top_ps": [s.top_p if s else 1.0 for s in slots],
            "seeds": [(s.seed if s else 0) & 0xFFFFFFFF for s in slots],
        }), bool(keep.any()))
        self._ctl_dirty = False

    @replicated
    def _dev_upload_ctl(self, packed: np.ndarray, keep_any: bool) -> None:
        """Upload the packed control arrays; lengths follow the host's,
        except lanes marked `keep` (a verify in flight)."""
        self._to_device(packed, out=self._ctl.buf)
        v = self._ctl.views
        if keep_any:
            self._d_seq_lens.copy_(
                torch.where(v["keep"], self._d_seq_lens, v["lens"]))
        else:
            self._d_seq_lens.copy_(v["lens"])

    # ------------------------------------------------------------------
    # the step program
    # ------------------------------------------------------------------

    def _step_buffers(self, k: int, keep: bool) -> None:
        """The fixed outputs of a k-step program (allocated before any
        capture, outside the graph pool)."""
        B = self.ecfg.max_batch
        if k not in self._toks_buf:
            self._toks_buf[k] = torch.zeros((k, B), dtype=torch.int64,
                                            device=self.device)
        if keep and k not in self._logits_buf:
            self._logits_buf[k] = torch.zeros(
                (k, B, self.cfg.vocab_size), dtype=torch.float32,
                device=self.device)

    def _decode_body(self, k: int, fsm: bool, mode: int, masked: bool,
                     keep: bool) -> None:
        """k decode steps over the fixed device state (the counterpart of
        the reference's _decode_step_body, unrolled k times): for the
        lanes in _d_run, write the new token's KV at its position,
        attend, mask (host rows and/or the device FSM), sample at (seed,
        position), advance the FSM and budget, then lengths += 1 and
        last = the sampled token.  Step j's tokens (and, kept, its
        logits) go to row j of the k-step output buffers.  Reads nothing
        back to the host, so on CUDA it is captured as one graph."""
        ecfg = self.ecfg
        B, ps, C = ecfg.max_batch, ecfg.page_size, ecfg.max_window
        P = ecfg.max_pages_per_seq
        toks_out = self._toks_buf[k]
        logits_out = self._logits_buf[k] if keep else None
        run = self._d_run
        step = run.int()
        kv_pos = torch.arange(C, device=self.device).expand(B, C)
        tables = self._grammars.args() if fsm else None
        for j in range(k):
            lens = torch.where(run, self._d_seq_lens, 0)
            page = self._d_table.gather(
                1, (lens // ps).clamp_max(P - 1).long()[:, None])
            write = torch.where(run[:, None],
                                page.long() * ps + (lens % ps).long()[:, None],
                                0)  # idle lanes: the trash page
            paged = PagedView(
                write_idx=write,
                read_idx=None,
                kv_positions=kv_pos,
                kv_valid=(kv_pos <= lens.long()[:, None]) & run[:, None],
                page_table=self._d_table,
                seq_lens=lens,
                page_size=ps,
            )
            logits, _ = forward(
                self.params, self.cfg, self._d_last[:, None],
                lens.long()[:, None],
                kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
                tp=self.tp)
            logits = logits[:, 0]
            mask = self._d_allowed if masked else None
            if fsm:
                g = grammar_allowed_mask(self._fsm, self._fsm_g, self._budget,
                                         run, *tables)
                mask = g if mask is None else mask & g
            toks = sample_tokens_per_slot(
                logits, self._d_sampling, self._d_seeds, lens,
                allowed_mask=mask, sampled=mode != GREEDY,
                filtered=mode == FILTERED)
            toks_out[j].copy_(toks)
            if logits_out is not None:
                logits_out[j].copy_(logits)
            if fsm:
                self._fsm.copy_(grammar_advance(self._fsm, self._fsm_g, toks,
                                                run, tables[0], tables[1]))
                self._budget.sub_(step)
            self._d_seq_lens.add_(step)
            self._d_last.copy_(torch.where(run, toks, self._d_last))

    def _run_step(self, k: int, fsm: bool, mode: int, masked: bool) -> None:
        """Run the k-step program: eagerly on CPU tensors, as a replay of
        its captured CUDA graph on the card (captured at first use).  A
        capture or replay failure raises; nothing falls back to the eager
        body on the card."""
        keep = self.ecfg.keep_logits
        self._step_buffers(k, keep)
        if self.device.type != "cuda":
            self._decode_body(k, fsm, mode, masked, keep)
            return
        key = (k, fsm, mode, masked, keep,
               self._grammars.version if fsm else 0)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key)
        try:
            g.graph.replay()
        except Exception as e:
            raise RuntimeError(f"decode step graph {key} failed to "
                               f"replay: {e}") from e
        for fn, n in g.launches:
            fn.launches += n
        self.graph_replays += 1

    def _capture(self, key: Tuple) -> _StepGraph:
        """Capture the step program `key` into a CUDA graph.  A warm-up
        run on a side stream first, with every lane masked off (so no
        state moves: writes land in the trash page, lengths and tokens
        stay), builds and loads every kernel library and library handle
        the body needs; the capture itself then records without host
        work.  Graphs whose FSM tables were rebuilt are dropped."""
        from ..ops import kernels

        t0 = time.monotonic()
        k, fsm, mode, masked, keep, version = key
        if fsm:
            for old in [g for g in self._graphs if g[1] and g[5] != version]:
                del self._graphs[old]
            if not self._graphs:
                self._graph_pool = None  # freed with its last graph
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        saved = self._d_run.clone()
        self._d_run.zero_()
        if self._capture_stream is None:
            self._capture_stream = _capture_stream_for(dev)
        side = self._capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._decode_body(k, fsm, mode, masked, keep)
        cur.wait_stream(side)
        self._d_run.copy_(saved)
        if self._group is not None:
            # the capture begins with a device synchronize: wait for the
            # warm-up's collectives under the guard first, so a dead rank
            # raises here instead of hanging it
            self._sync()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = [fn.launches for fn in kernels.KERNELS]
        graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while capturing: a collection
        # could free another engine's graphs or pinned buffers, whose
        # teardown calls are not permitted during a capture and
        # invalidate it (torch.cuda.graph collects once before it begins)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            # a rank of a tensor-parallel group captures its NCCL calls;
            # the process group's watchdog thread queries its events
            # meanwhile, which a process-wide capture would forbid
            with capture_lock, torch.cuda.graph(
                    graph, pool=self._graph_pool,
                    capture_error_mode="global"
                    if self.tp is None else "thread_local"):
                self._decode_body(k, fsm, mode, masked, keep)
        except Exception as e:
            raise RuntimeError(f"capturing decode step graph {key} "
                               f"failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
            # the captured calls launched nothing: take their ticks back,
            # and let every replay add them instead
            ticks = [(fn, fn.launches - b)
                     for fn, b in zip(kernels.KERNELS, before)]
            for fn, b in zip(kernels.KERNELS, before):
                fn.launches = b
        g = _StepGraph(graph, [(fn, n) for fn, n in ticks if n])
        self._graphs[key] = g
        dt = time.monotonic() - t0
        self.graph_captures += 1
        self.graph_capture_s += dt
        compile_log.record(
            f"decode_graph[k={k},fsm={int(fsm)},mode={mode},"
            f"masked={int(masked)},keep={int(keep)}"
            + (f",tables=v{version}]" if fsm else "]"), dt)
        return g

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    def _assert_private_tail(self, req: GenRequest, cl: int) -> None:
        """Verify writes land only in the lane's PRIVATE tail pages, never
        in radix-shared prefix pages: every page of positions
        seq_len..seq_len+cl must be owned by this sequence alone and
        unknown to the prefix cache.  This holds by construction (lookups
        share only whole pages strictly before the prefill's start, and
        store() retains pages only at finish); the assert is a cheap
        tripwire over a handful of tail pages per verify step."""
        ps = self.ecfg.page_size
        pages = req.seq.pages[req.seq.length // ps:
                              (req.seq.length + cl) // ps + 1]
        shared = [p for p in pages if self.pool.refcount[p] != 1]
        assert not shared, (f"speculative write span of {req.request_id} "
                            f"covers shared pages {shared}")
        assert self.prefix_cache is None or \
            not self.prefix_cache.owns_any(pages), (
                f"speculative write span of {req.request_id} covers "
                "radix-cached pages")

    def _try_dispatch_verify(self, lanes: List[GenRequest]) -> bool:
        """Propose, then dispatch one [B, K+1] verify step.  A lane
        proposes only when its history is fully drained (the n-gram anchor
        must be the true tail).  False when no lane has a usable candidate
        run (plain decode then dispatches exactly as without
        speculation).  Runs are clamped so a fully accepted run stays
        inside the token budget and the window; free and device-FSM lanes
        without a proposal ride as an ordinary one-token decode (cand_len
        0); host-masked lanes sit the dispatch out."""
        ecfg = self.ecfg
        K = ecfg.speculative_k
        cap = self.spec_k_cap
        if cap is not None:
            # the autoscaler ladder's rung 2: proposals throttled, 0 =
            # paused (plain decode dispatches)
            K = min(K, cap)
            if K <= 0:
                return False
        proposals: Dict[int, List[int]] = {}
        for s in lanes:
            if s.spec is None or self._host_constrained(s) \
                    or s.dispatched != s.drained:
                continue
            room = min(K, s.max_new_tokens - s.dispatched - 1,
                       ecfg.max_window - 2 - s.seq.length)
            cands = s.spec.propose(room)
            if cands:
                proposals[s.slot] = [int(c) for c in cands]
        # grow pages over each proposer's whole write span (positions
        # seq_len..seq_len+cl); a page-blocked proposal shrinks to a
        # plain ride rather than preempt anyone for speculative work
        for slot, cands in list(proposals.items()):
            s = self.slots[slot]
            need = s.seq.length + len(cands) + 1
            if self._grow(s.seq, need):
                continue
            short = -(-need // ecfg.page_size) - len(s.seq.pages)
            if not (self._reclaim_cache(max(1, short), s)
                    and self._grow(s.seq, need)):
                del proposals[slot]
        if not proposals:
            return False
        if self._ctl_dirty:
            self._refresh_ctl()
        B = ecfg.max_batch
        members: List[Optional[GenRequest]] = [None] * B
        for s in lanes:
            if not self._host_constrained(s):
                members[s.slot] = s
        cand_arr = np.zeros((B, K), np.int64)
        cand_lens = [0] * B
        for slot, cands in proposals.items():
            s = self.slots[slot]
            cand_arr[slot, :len(cands)] = cands
            cand_lens[slot] = len(cands)
            self._assert_private_tail(s, len(cands))
            s.spec_ahead = len(cands) + 1
        t_start = self._timer()
        out, logits = self._verify_step(members, cand_arr, cand_lens)
        finals: List[Optional[str]] = [None] * B
        for i, req in enumerate(members):
            if req is None or cand_lens[i] > 0:
                continue  # proposers: accounting at drain
            req.seq.length += 1
            req.dispatched += 1
            finals[i] = self._limit_reason_after_dispatch(req)
        entry = self._fetch(out, list(members), [finals],
                            steps=max(cand_lens) + 1, logits=logits,
                            spec=_SpecMeta(cand_lens=cand_lens, width=K + 1),
                            t_start=t_start)
        busy = sum(1 for m in members if m is not None)
        n_proposed = sum(cand_lens)
        if self.flight is not None:
            self.flight.note_dispatch(KIND_VERIFY, busy, busy + n_proposed)
            self.flight.note_spec(n_proposed)
        for req, fin in zip(members, finals):
            if req is not None and fin is not None:
                self._to_draining(req)
        self.metrics.record_decode_step(busy)
        self.metrics.record_verify_dispatch(n_proposed)
        # verify cost: every lane advances >= 1 query plus its candidates
        self._record_decode_cost(members, kind="verify",
                                 queries=busy + n_proposed, entry=entry)
        return True

    def _verify_step(self, members: List[Optional[GenRequest]],
                     cand_arr: np.ndarray, cand_lens: List[int],
                     fsm: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The verify forward and its acceptance, on the device state
        (the reference's _get_verify_fn body, eager).

        Lane i feeds [last_token, c_1..c_K] at positions seq_len..seq_len+K
        and writes the KV of its first cand_len + 1 of them (the rest, and
        idle lanes, write the trash page).  Every position is sampled with
        the sequential path's own (seed, position) draw; candidates are
        kept while sample == candidate, so the emitted tokens are the ones
        plain decode would have produced.  The lanes' lengths advance by
        the accepted run + 1 and their last token becomes the bonus token
        (the rejected tail's stale KV lies past the length, masked until
        those positions are written again); FSM lanes keep the state
        reached through the accepted prefix, advanced by the bonus.
        Returns ([B, K+2] samples and accepted counts, [B, K+1, V]
        logits).  `fsm` forces the FSM variant (warmup, every lane
        inactive); None takes it when a member carries a grammar."""
        if fsm is None:
            fsm = any(m is not None and m.grammar is not None
                      for m in members)
        return self._dev_verify(np.array([m is not None for m in members]),
                                np.asarray(cand_arr), list(cand_lens), fsm,
                                sampling_mode(members))

    @replicated
    def _dev_verify(self, act_np: np.ndarray, cand_arr: np.ndarray,
                    cand_lens: List[int], fsm: bool, mode: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The verify step's device work (_verify_step)."""
        ecfg, dev = self.ecfg, self.device
        ps, B, C = ecfg.page_size, ecfg.max_batch, ecfg.max_window
        K = ecfg.speculative_k
        S = K + 1
        P = ecfg.max_pages_per_seq
        act = self._to_device(act_np)
        cands = self._to_device(cand_arr)
        cl = self._to_device(np.asarray(cand_lens, np.int32))
        lens = torch.where(act, self._d_seq_lens, 0)
        toks_in = torch.cat([self._d_last[:, None], cands], dim=1)
        local = torch.arange(S, device=dev)[None]
        pos = lens.long()[:, None] + local
        in_run = (local <= cl.long()[:, None]) & act[:, None]
        page = self._d_table.long().gather(1, (pos // ps).clamp_max(P - 1))
        write = torch.where(in_run, page * ps + pos % ps, local % ps)
        kv_pos = torch.arange(C, device=dev).expand(B, C)
        paged = PagedView(
            write_idx=write,
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=(kv_pos <= (lens + cl).long()[:, None]) & act[:, None],
            page_table=self._d_table,
            seq_lens=lens,
            page_size=ps,
            q_lens=cl + 1,
        )
        logits, _ = forward(
            self.params, self.cfg, toks_in, pos,
            kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
            tp=self.tp)
        V = logits.shape[-1]
        sp = self._d_sampling
        rep = lambda x: x.repeat_interleave(S)  # noqa: E731
        mask = states = None
        if fsm:
            # the FSM state BEFORE each position: states[:, j] is the
            # automaton after the first j candidates (what sequential
            # decode would thread); position j is masked with budget
            # budget - j.  Positions past cand_len walk candidates that
            # acceptance never reads.
            tc, trans, _, _ = self._grammars.args()
            sts = [self._fsm]
            for j in range(K):
                sts.append(grammar_advance(sts[-1], self._fsm_g,
                                           cands[:, j], act, tc, trans))
            states = torch.stack(sts, dim=1)                     # [B, S]
            mask = torch.stack([
                grammar_allowed_mask(sts[j], self._fsm_g, self._budget - j,
                                     act, *self._grammars.args())
                for j in range(S)], dim=1).reshape(B * S, V)
        samples = sample_tokens_per_slot(
            logits.reshape(B * S, V),
            SamplingParams(rep(sp.temperature), rep(sp.top_k),
                           rep(sp.top_p)),
            rep(self._d_seeds), pos.reshape(-1), allowed_mask=mask,
            sampled=mode != GREEDY, filtered=mode == FILTERED).view(B, S)
        good = (samples[:, :K] == cands) & (
            torch.arange(K, device=dev)[None] < cl.long()[:, None])
        m = good.long().cumprod(dim=1).sum(dim=1)
        adv = torch.where(act, m + 1, 0)
        bonus = samples.gather(1, m[:, None])[:, 0]
        self._d_seq_lens.add_(adv.int())
        self._d_last.copy_(torch.where(act, bonus, self._d_last))
        if fsm:
            s_m = states.gather(1, m[:, None])[:, 0]
            self._fsm.copy_(grammar_advance(
                s_m, self._fsm_g, bonus, act, self._grammars.token_class,
                self._grammars.trans))
            self._budget.sub_(adv.int())
        return torch.cat([samples, m[:, None]], dim=1), logits

    # ------------------------------------------------------------------
    # telemetry: SLO verdicts and modeled dispatch cost
    # ------------------------------------------------------------------

    def _finalize_slo(self, req: GenRequest, reason: Optional[str]) -> None:
        """Terminal metrics + SLO verdict for one request
        (kafka_tpu/runtime/engine.py _finalize_slo): TTFT and mean TPOT
        from the request's own stamps (first token -> finalize), the
        verdict from metrics.record_finish, and on a traced request the
        verdict stamped onto its root span."""
        now = time.monotonic()
        ttft_s = (req.first_token_time - req.submit_time
                  if req.first_token_time is not None else None)
        n_out = len(req.output_ids)
        tpot_s = None
        if req.first_token_time is not None and n_out > 1:
            tpot_s = (now - req.first_token_time) / (n_out - 1)
        met = self.metrics.record_finish(reason, ttft_s=ttft_s,
                                         tpot_s=tpot_s, tokens=n_out)
        req.slo_met = met
        if met is not None and req.trace is not None:
            annotate(req.trace, {
                "slo_met": met,
                "slo_ttft_ms": round(ttft_s * 1e3, 1)
                if ttft_s is not None else None,
                "slo_tpot_ms": round(tpot_s * 1e3, 2)
                if tpot_s is not None else None,
                "goodput_tokens": n_out if met else 0,
            })

    def _modeled_dispatch_s(self, flops: float,
                            bytes_: float) -> Optional[float]:
        """Roofline time of one dispatch (None = no roofline): the slower
        of the compute and bandwidth bounds."""
        m = self.metrics
        if not m.peak_flops or not m.peak_hbm_bps:
            return None
        return max(flops / m.peak_flops, bytes_ / m.peak_hbm_bps)

    def _prefill_dispatched(self, t_start: Optional[Any],
                            lanes: List[Tuple[int, int]]) -> None:
        """Telemetry of one prefill chunk dispatch over `lanes`
        [(chunk_tokens, start_pos), ...]: its timing span (CUDA), its
        modeled cost, banked until a fetch entry carries them, and the
        flight record."""
        span = None
        if t_start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            span = (t_start, end)
            self._prefill_spans.append(span)
        modeled = self._record_prefill_cost(lanes, span)
        if modeled is not None:
            self._prefill_modeled_acc = \
                (self._prefill_modeled_acc or 0.0) + modeled
        if self.flight is not None:
            self.flight.note_prefill(len(lanes), sum(c for c, _ in lanes))

    def _take_prefill_modeled(self) -> Optional[float]:
        """The banked prefill modeled seconds, for the entry being
        created: its measured span covers every unobserved chunk since
        the previous observed one, so it gets their modeled SUM."""
        modeled = self._prefill_modeled_acc
        self._prefill_modeled_acc = None
        return modeled

    def _cost_ready(self) -> bool:
        """Is the modeled-cost path on?  A fresh metrics object (the
        server's post-warmup reset) gets the roofline back first."""
        if self._cost_model is None or not self.metrics.enabled:
            return False
        if self._have_roofline and self.metrics.peak_source == "unknown":
            self.metrics.set_roofline(*self._roofline)
        return True

    def _record_prefill_cost(self, lanes: List[Tuple[int, int]],
                             span: Optional[Tuple[Any, Any]] = None
                             ) -> Optional[float]:
        """Report one prefill dispatch's modeled cost over `lanes`
        [(chunk_tokens, start_pos), ...]; weights stream once per
        dispatch, so the per-lane weight-byte term is de-duplicated.  On
        CUDA (`span`: the chunk's timing events) it is charged when the
        final chunk's fetch lands, with the span's device seconds.
        Returns its modeled roofline seconds (None = no model/roofline)."""
        if not self._cost_ready():
            return None
        cm = self._cost_model
        flops = bytes_ = 0.0
        toks = 0
        for chunk, start in lanes:
            lf, lb = cm.prefill_cost(chunk, start)
            flops += lf
            bytes_ += lb - cm.weight_bytes
            toks += chunk
        bytes_ += cm.weight_bytes
        if span is not None:
            self._prefill_costs.append(("prefill", toks, flops, bytes_,
                                        [span]))
        else:
            self.metrics.record_dispatch_cost("prefill", toks, flops, bytes_)
        modeled = self._modeled_dispatch_s(flops, bytes_)
        if self.flight is not None:
            self.flight.note_cost(flops, bytes_, modeled)
        return modeled

    def _record_decode_cost(self, members: Sequence[Optional[GenRequest]],
                            steps: int = 1, kind: str = "decode",
                            queries: Optional[int] = None,
                            entry: Optional[_Fetch] = None,
                            entries: Sequence[_Fetch] = ()) -> None:
        """Report one decode/verify dispatch's modeled cost: context is
        the host-known per-lane KV length sum; `queries` is a verify's
        query-token count (lanes + candidates).  `entry` tags the
        dispatch's fetch with the modeled time for the skew gauge (a
        mixed host-constrained iteration passes its group fetches as
        `entries` instead: they share one cost record).  On CUDA the cost
        is charged when the last of the fetches lands, with their spans'
        device seconds as busy time; on the CPU at once, by the
        reference's gap rule."""
        if not self._cost_ready():
            return
        lanes = [m for m in members if m is not None]
        if not lanes:
            return
        cm = self._cost_model
        ctx = sum(m.seq.length if m.seq is not None else 0 for m in lanes)
        if kind == "verify":
            toks = queries if queries is not None else len(lanes)
            # each lane's K+1-wide query block attends its whole context
            flops, bytes_ = cm.verify_cost(
                toks, ctx, attn_pairs=ctx * toks / len(lanes))
        else:
            toks = len(lanes) * steps
            flops, bytes_ = cm.decode_cost(toks, ctx, steps)
        carriers = list(entries) or ([entry] if entry is not None else [])
        if carriers and carriers[-1].spans is not None:
            carriers[-1].costs.append(
                (kind, toks, flops, bytes_,
                 [sp for e in carriers for sp in e.spans]))
        else:
            self.metrics.record_dispatch_cost(kind, toks, flops, bytes_)
        modeled = self._modeled_dispatch_s(flops, bytes_)
        if entry is not None:
            entry.kind = kind
            entry.modeled_s = modeled
        if self.flight is not None:
            self.flight.note_cost(flops, bytes_, modeled)

    @staticmethod
    def _sample_args(reqs: Sequence[GenRequest], positions: Sequence[int],
                     allowed: Optional[np.ndarray]) -> tuple:
        """The host inputs of a prefill's sampling: per row temperature,
        top-k, top-p, seed and position, the sampling mode, and the
        [rows, V] bool constrained mask (None = free)."""
        return (np.array([r.temperature for r in reqs], np.float32),
                np.array([r.top_k for r in reqs], np.int64),
                np.array([r.top_p for r in reqs], np.float32),
                np.array([r.seed & 0xFFFFFFFF for r in reqs], np.int64),
                np.asarray(positions, np.int64), sampling_mode(reqs),
                allowed)

    def _sample_on_device(self, logits: torch.Tensor,
                          args: tuple) -> torch.Tensor:
        """A prefill's tokens on the device: row i draws at (seed,
        positions[i]) under the _sample_args inputs."""
        temps, top_ks, top_ps, seeds, positions, mode, allowed = args
        params = SamplingParams(temperature=self._to_device(temps),
                                top_k=self._to_device(top_ks),
                                top_p=self._to_device(top_ps))
        return sample_tokens_per_slot(
            logits, params, self._to_device(seeds),
            self._to_device(positions),
            allowed_mask=(self._to_device(allowed) if allowed is not None
                          else None),
            sampled=mode != GREEDY, filtered=mode == FILTERED)

    # ------------------------------------------------------------------
    # constrained decoding
    # ------------------------------------------------------------------

    @staticmethod
    def _host_constrained(req: GenRequest) -> bool:
        """Does this lane take the host mask path?  Device-FSM lanes are
        masked and advanced on the device instead."""
        return req.logits_mask_fn is not None and req.grammar is None

    def _set_fsm_lane(self, req: GenRequest, slot: int) -> None:
        """Seed the lane's device FSM state and budget as it takes a
        decode slot (prefill finish, seating, resume): free lanes park
        the slot at -1; grammar lanes replay their host-known output
        through the compiled table and, when the prefill's token is still
        in flight, advance by it on the device (no round trip).  A grammar
        that cannot register or a replay that stops validating degrades
        the lane to the host mask path."""
        if req.grammar is None:
            self._dev_fsm(slot, -1)
            return
        g_idx = self._grammars.register(req.grammar)
        state = req.grammar.walk(req.output_ids) if g_idx is not None else -1
        if state < 0:
            self._degrade(req, "cannot register" if g_idx is None
                          else "replay stopped validating")
            self._dev_fsm(slot, -1)
            return
        # when exactly the prefill's token is in flight it sits in
        # _d_last[slot]: the replayed state advances by it on the device
        self._dev_fsm(slot, self._grammars.offsets[g_idx] + state, g_idx,
                      req.max_new_tokens - req.dispatched,
                      advance=req.drained != req.dispatched)

    def _degrade(self, req: GenRequest, why: str) -> None:
        logger.warning("grammar for %s: %s; degrading to the host mask path",
                       req.request_id, why)
        req.grammar = None
        self.constrained_degrades += 1
        if self.flight is not None:
            self.flight.note_cause("degrade")

    def _prefill_masks(self, reqs: Sequence[GenRequest]
                       ) -> Optional[np.ndarray]:
        """[len(reqs), V] mask for the tokens a prefill samples, None when
        no lane is constrained.  Grammar lanes take their compiled row at
        the state their output replays to, under the decode step's
        wrap-up rule; host-masked lanes call their mask fn (a prefill's
        output_ids are complete: preemption drains the pipeline first)."""
        rows: List[Optional[np.ndarray]] = []
        for req in reqs:
            row = None
            if req.grammar is not None:
                state = req.grammar.walk(req.output_ids)
                if state >= 0:
                    row = req.grammar.allowed_row(
                        state,
                        budget_left=req.max_new_tokens - req.dispatched)
                else:
                    self._degrade(req, "replay stopped validating at prefill")
            if row is None and self._host_constrained(req):
                row = self._host_mask_row(req)
            rows.append(row)
        if all(r is None for r in rows):
            return None
        V = self.cfg.vocab_size
        return np.stack([np.ones(V, bool) if r is None else r for r in rows])

    def _host_mask_row(self, req: GenRequest) -> Optional[np.ndarray]:
        """[V] bool row from the lane's mask fn over its complete output
        (None: this step is free): a prefill's first token."""
        kind, val = self._next_constraint(req, singleton=False)
        if kind == "free":
            return None
        if len(val) == 0:
            self._record_overtight(req)
        row = np.zeros(self.cfg.vocab_size, bool)
        row[val] = True
        return row

    def _next_constraint(self, req: GenRequest, singleton: bool = True
                         ) -> Tuple[str, Any]:
        """Classify the lane's next host-masked step over output_ids +
        predicted: ("forced", id) when the grammar forces the token (the
        mask fn's forced_id hook, or an allowed list of one id),
        ("ids", in-vocab ids) at a genuine choice point, ("free", None)
        for an unconstrained step (JAX runtime/engine.py
        _next_constraint).  `singleton=False` skips the forced_id hook
        and returns ids.  A raising mask fn degrades the lane to
        unconstrained for good (one log line), never the engine thread."""
        fn = req.logits_mask_fn
        ctx = req.output_ids + req.predicted
        try:
            if singleton and hasattr(fn, "forced_id"):
                fid = fn.forced_id(ctx)
                if fid is not None and 0 <= int(fid) < self.cfg.vocab_size:
                    self.constrained_host_mask_steps += 1
                    return ("forced", int(fid))
            allowed = fn(ctx)
        except Exception:
            logger.exception("logits_mask_fn failed for %s; degrading the "
                             "lane to unconstrained", req.request_id)
            req.logits_mask_fn = None
            return ("free", None)
        if allowed is None:
            return ("free", None)
        self.constrained_host_mask_steps += 1
        ids = np.asarray(allowed, np.int64)
        ids = ids[(ids >= 0) & (ids < self.cfg.vocab_size)]
        if singleton and len(ids) == 1:
            return ("forced", int(ids[0]))
        return ("ids", ids)

    def _record_overtight(self, req: GenRequest) -> None:
        """An over-tight mask row (no token allowed): the sampler degrades
        it to unconstrained.  Counted every time, logged once per
        request."""
        self.metrics.constrained_mask_overtight += 1
        if self.flight is not None:
            self.flight.note_cause("overtight")
        if req.overtight_logged:
            return
        req.overtight_logged = True
        fn = req.logits_mask_fn
        desc = fn.state_desc() if hasattr(fn, "state_desc") else "?"
        logger.warning("over-tight constrained mask for %s (state %s): the "
                       "sampler degrades this row to unconstrained",
                       req.request_id, desc)

    # ------------------------------------------------------------------
    # pages, release, preemption
    # ------------------------------------------------------------------

    def _ensure_pages(self, req: GenRequest) -> None:
        """Grow req's pages for one more token.  Remedies under pressure,
        cheapest first: evict prefix-cache leaves (rebuilding one costs a
        prefill, no victim), drain the pipeline (stop tokens in flight may
        retire lanes), roll parked lanes back to the waiting queue
        (youngest first), roll the youngest request back; if that is not
        enough, roll req itself back rather than let it write into the
        trash page."""
        need = req.seq.length + 1
        if self._grow(req.seq, need) or (
                self._reclaim_cache(1, req) and self._grow(req.seq, need)):
            return
        self._drain(block=True)
        if req.state != ACTIVE or req.seq is None:
            return
        while not self._grow(req.seq, need):
            if not self.parked:
                break
            self._preempt(max(self.parked, key=lambda r: r.submit_time))
            # hysteresis: the freed pages feed active growth, not an
            # immediate re-park of the same lane
            self._park_cooldown = 32
        else:
            return
        self._preempt_youngest()
        if req.state != ACTIVE or req.seq is None:
            return
        if not self._grow(req.seq, need):
            self._preempt(req)

    def _grow(self, seq: SequencePages, length: int) -> bool:
        """Grow seq's pages to cover `length` tokens; False when the pool
        cannot."""
        try:
            if self.pool.ensure_capacity(seq, length):
                self._ctl_dirty = True
            return True
        except OutOfPagesError:
            return False

    def _vacate(self, slot: int) -> None:
        self.slots[slot] = None
        self._dev_fsm(slot, -1)  # the next occupant starts free
        self._ctl_dirty = True

    # -- the device writes of seating, parking and FSM lanes --------------

    @replicated
    def _dev_set_last(self, slot: int, token: Optional[int],
                      parked: Optional[str]) -> None:
        """Seed a lane's last token: a host-known `token`, or the token a
        parked prefill left on the device under request id `parked`."""
        if parked is not None:
            self._d_last[slot:slot + 1].copy_(self._parked_toks.pop(parked))
        else:
            self._d_last[slot] = token

    @replicated
    def _dev_seat_prefill(self, slot: int, row: int) -> None:
        """The last prefill's sampled token `row` seeds lane `slot`."""
        self._d_last[slot:slot + 1].copy_(self._prefill_toks[row:row + 1])

    @replicated
    def _dev_park_prefill(self, key: str, row: int) -> None:
        """Keep the last prefill's token `row` on the device for a parked
        lane until it is seated (or released)."""
        self._parked_toks[key] = self._prefill_toks[row:row + 1]

    @replicated
    def _dev_drop_parked(self, key: str) -> None:
        self._parked_toks.pop(key, None)

    @replicated
    def _dev_grammar_tables(self, tc: np.ndarray, trans: np.ndarray,
                            dist: np.ndarray, slack: int) -> None:
        """A registration's rebuilt grammar tables, to the device."""
        self._grammars.write(tc, trans, dist, slack)

    def _drop_parked(self, req: GenRequest) -> None:
        """Release a parked lane's device token, if it holds one."""
        if req.pending_tok:
            self._dev_drop_parked(req.request_id)
        req.pending_tok = None

    @replicated
    def _dev_fsm(self, slot: int, state: int, g_idx: Optional[int] = None,
                 budget: int = 0, advance: bool = False) -> None:
        """Set lane `slot`'s FSM state (-1 = free).  With `advance`, the
        lane's token still in flight (in _d_last) steps `state` on the
        device first.  A grammar lane also gets its grammar index and
        budget."""
        if g_idx is None:
            self._fsm[slot] = state
            return
        if advance:
            tc = self._grammars.token_class[g_idx]
            cls = tc.index_select(0, self._d_last[slot:slot + 1])
            nxt = self._grammars.trans[state].index_select(0, cls.long())
            self._fsm[slot:slot + 1].copy_(nxt)
        else:
            self._fsm[slot] = state
        self._fsm_g[slot] = g_idx
        self._budget[slot] = budget

    def _release_slot(self, req: GenRequest) -> None:
        """Free a request's batch slot (or parked place) and pages.  Pages
        freed here may be reallocated while dispatched steps still write
        into them: safe by stream order — the new owner's writes come
        later, or stay masked by the lengths."""
        if req.slot >= 0:
            self._vacate(req.slot)
            req.slot = -1
        if req in self.parked:
            self.parked.remove(req)
        self._drop_parked(req)
        if req.seq is not None:
            self.pool.free_sequence(req.seq)
            req.seq = None

    def _preempt_youngest(self) -> None:
        cands = [s for s in self.slots if s is not None]
        if len(cands) <= 1:
            return
        # background lanes are the first victims: they soak idle
        # capacity and never hold pages an interactive lane needs
        bg = [r for r in cands if r.background]
        self._preempt(max(bg or cands, key=lambda r: r.submit_time))

    def _preempt(self, victim: GenRequest) -> None:
        """Roll a request back to the waiting queue: re-prefilled later
        over prompt + generated-so-far, minus the final output token (its
        KV was never written: it is the pending decode input).  Needs
        complete outputs — the caller drained the pipeline.  A victim
        caught mid-prefill restarts as a fresh prefill."""
        logger.warning("preempting %s (out of KV pages)", victim.request_id)
        assert not self._pending, "preempt with in-flight fetches"
        assert victim.dispatched == victim.drained, (
            "preempt victim has unprocessed dispatched tokens")
        self.metrics.record_preempt()
        if self.flight is not None:
            self.flight.note_cause(
                "park_rollback" if victim in self.parked else "preempt")
        add_event(victim.trace, "preempt",
                  {"generated": len(victim.output_ids)})
        victim.spec_ahead = 0
        self._release_slot(victim)
        victim.prefill_ids = victim.prompt_ids + victim.output_ids[:-1]
        victim.state = WAITING
        victim.resumed = bool(victim.output_ids)
        (self.waiting_bg if victim.background
         else self.waiting).insert(0, victim)
