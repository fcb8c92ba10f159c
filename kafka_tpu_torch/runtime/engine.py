"""The CUDA inference engine: continuous batching over a paged KV pool.

Counterpart of kafka_tpu/runtime/engine.py, main-path slice.  The
scheduler keeps the JAX engine's semantics:

* `submit` queues a request (bounded by `max_waiting` -> AdmissionError);
* each `step()` checks deadlines, admits waiting requests into free batch
  slots when their prompt's pages fit, advances the oldest prefilling
  lanes one chunk each, then decodes every active lane one token;
* a prompt longer than the largest bucket prefills in chunks, one chunk
  per step, interleaved with the decode batch;
* several admissions that share a bucket prefill together in one batched
  dispatch (plain attention, as in the JAX package); a lone admission —
  and any bucket over 128 on the kernel backend — takes the
  single-sequence prefill, which runs the flash prefill kernel (K2);
* decode runs the paged decode kernel (K1) for every layer — over an
  int8 KV pool (`kv_quantize="int8"`) the int8 paged decode kernel (K4),
  while every prefill chunk and verify step reads that pool through the
  dequantizing page gather, as the JAX package does;
* a request with a `prefix_key` (the serving layer passes the thread id)
  attaches the longest whole-page prefix the radix prefix cache holds
  (runtime/prefix_cache.py) before the admission page gate, and its
  prefill starts at the first uncached token (`cached_tokens`); a
  finished request stores its materialized tokens' pages into the cache
  before they go back to the pool, and page pressure evicts cache leaves
  before it preempts a live request;
* with `speculative_k > 0` each lane's n-gram proposer
  (runtime/speculative.py) may offer up to K candidate tokens; one
  [B, K+1]-query forward — the paged verify kernel (K3) — checks them
  all, every position is sampled with the sequential path's own
  (seed, position) draw, and the longest matching run plus the bonus
  token is emitted, so the stream is the one plain decode would give;
* a request with a `logits_mask_fn` (llm/constrained.ToolCallMaskFn, the
  provider's tool_choice mask) is constrained: with its compiled
  `grammar` (the same automaton lowered to a token DFA) the lane carries
  a device FSM state that masks and advances inside the decode and verify
  steps (`grammar_allowed_mask` / `grammar_advance`); without one, or
  when the grammar cannot register or its replay stops validating, the
  lane takes the host mask path: a [1, V] row from
  `logits_mask_fn(output_ids)` per token.  Device-FSM lanes speculate
  (the verify step masks each position with the state reached through
  the candidate prefix); host-masked lanes do not;
* when the pool runs out of pages mid-decode the youngest request is
  rolled back to the waiting queue (re-prefilled later over prompt +
  generated-so-far; its resumed prefill's token is the deterministic
  duplicate and is dropped);
* `recover_from_failure` rebuilds a servable engine after a step fault.

What the port does differently: PyTorch runs eagerly, so there are no
compiled step programs, and the sampled tokens are fetched synchronously
at each dispatch (the JAX engine's fetch_lag pipeline, multi-step fusion,
off-slot parking, KV tiers, flight recorder and metrics wait for later
slices; multi_step=1 in the JAX engine is token-identical,
engine.py:1450-1455).  For constrained lanes this means the host mask
needs no singleton-mask chaining (`predicted`): every mask row is built
from complete output_ids.  Requests therefore never sit in a draining state:
a token is processed in the step that produced it.  For speculation this
means a verify step is accepted and emitted in the step that ran it: the
JAX engine's in-flight verify bookkeeping (`spec_ahead`, device-side
seq_lens that run ahead of the host's) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
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
from .kv_cache import (
    OutOfPagesError,
    PagePool,
    SequencePages,
    TRASH_PAGE,
    make_kv_pool_arrays,
    page_table_array,
)
from .prefix_cache import PrefixCache
from .speculative import LaneSpeculator

logger = logging.getLogger("kafka_tpu_torch.engine")

WAITING, PREFILLING, ACTIVE, FINISHED = (
    "waiting", "prefilling", "active", "finished")


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
    dispatched: int = 0
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
    # pages, and "own" (this thread's earlier turn) or "cross" (another
    # thread's shared prefix)
    cached_tokens: int = 0
    cache_source: Optional[str] = None
    # the FIRST admission's share, frozen when its prefill starts (usage
    # reports this: a preemption's re-attach is not client-saved compute)
    usage_cached_tokens: Optional[int] = None
    # n-gram proposer (EngineConfig.speculative_k > 0), built at submit
    spec: Optional[LaneSpeculator] = None
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
    degrades to the host mask path.
    """

    MAX_LIVE = 8
    MIN_STATE_PAD = 256

    def __init__(self, vocab_size: int, device: torch.device):
        self.vocab_size = vocab_size
        self.device = device
        self.grammars: List[Any] = []
        self.offsets: List[int] = []
        self._total_states = 0
        # device tensors (padded); None until the first registration
        self.token_class: Optional[torch.Tensor] = None  # [G_pad, V] int32
        self.trans: Optional[torch.Tensor] = None        # [S_pad, C_pad]
        self.dist: Optional[torch.Tensor] = None         # [S_pad] int32
        self.slack: Optional[torch.Tensor] = None        # [] int32

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
        dev = self.device
        self.token_class = torch.from_numpy(tc).to(dev)
        self.trans = torch.from_numpy(trans).to(dev)
        self.dist = torch.from_numpy(dist).to(dev)
        # conservative across grammars: extra slack engages wrap earlier
        # but never breaks closure
        self.slack = torch.tensor(max(g.wrap_slack for g in self.grammars),
                                  dtype=torch.int32, device=dev)

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


def kernel_backend_problems(cfg: ModelConfig,
                            ecfg: EngineConfig) -> List[str]:
    """Why the CUDA attention kernels (K1-K4) cannot serve this model and
    engine configuration; empty when they can.  On CUDA, "auto" then
    resolves to "plain" with these as its reasons, and an explicit
    "kernel" is refused at construction (resolve_attention_backend).

    All four take bf16 models with head_dim 64 or 128 and <= 8 q heads per
    kv head, and K1, K3 and K4 a window whose chunks their merge can hold
    (ops/kernels/common.py).  K3 (paged verify) sets no bound on
    speculative_k: it holds any G * (speculative_k + 1) query rows of a kv
    head, so every speculative_k the window fits (checked at construction)
    is served, as in the reference engine."""
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
    return problems


def resolve_attention_backend(cfg: ModelConfig, ecfg: EngineConfig,
                              device_type: str) -> Tuple[str, List[str]]:
    """EngineConfig.attention_backend resolved for a device type:
    (backend, reasons).  "auto" is "kernel" on the CPU (the wrappers run
    their plain versions on CPU tensors) and on CUDA where
    kernel_backend_problems is empty; otherwise "plain", with those
    problems as the reasons.  An explicit "kernel" with problems on CUDA
    raises ValueError; "plain" stays "plain"."""
    choice = ecfg.attention_backend
    if choice not in ("auto", "kernel", "plain"):
        raise ValueError(
            f"attention_backend must be 'auto', 'kernel' or 'plain', got "
            f"{choice!r}")
    if choice == "plain":
        return "plain", []
    problems = (kernel_backend_problems(cfg, ecfg)
                if device_type == "cuda" else [])
    if not problems:
        return "kernel", []
    if choice == "kernel":
        raise ValueError(
            "; ".join(problems) + " — use attention_backend='auto' or "
            "'plain'")
    return "plain", problems


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        engine_cfg: Optional[EngineConfig] = None,
        kv_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        """device: None = CUDA (raises without it); "cpu" for the tests.
        params: the layer-stacked dict (models/llama.py), moved to device."""
        self.device = resolve_device(device)
        self.ecfg = engine_cfg or EngineConfig()
        ecfg = self.ecfg
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
        backend, self.attention_backend_reasons = resolve_attention_backend(
            cfg, ecfg, self.device.type)
        if self.attention_backend_reasons:
            logger.warning(
                "attention_backend 'auto' resolved to 'plain' on %s: %s",
                self.device, "; ".join(self.attention_backend_reasons))
        self.cfg = cfg.replace(attention_backend=backend)
        self.params = params_to(params, device=self.device)
        self.kv_dtype = kv_dtype or cfg.activation_dtype
        ps = ecfg.page_size
        self.pool = PagePool(ecfg.num_pages, ps)
        # dense tensors, or QTensor pools (int8 rows + per-slot scales)
        self.k_pool, self.v_pool = make_kv_pool_arrays(
            cfg, ecfg.num_pages, ps, self.kv_dtype, device=self.device,
            quantize=ecfg.kv_quantize)
        B = ecfg.max_batch
        self.slots: List[Optional[GenRequest]] = [None] * B
        self.waiting: List[GenRequest] = []
        self._requests: Dict[str, GenRequest] = {}
        self._counter = itertools.count()
        self._out_events: List[TokenEvent] = []
        # device page table of the decode batch, re-uploaded only when
        # scheduling changes it (admit / retire / page growth)
        self._d_table: Optional[torch.Tensor] = None
        self._ctl_dirty = True
        # EWMA of decode step wall time (Retry-After estimate)
        self._tpot_s: Optional[float] = None
        self.preemptions = 0
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool, max_pages=ecfg.prefix_cache_pages)
            if ecfg.prefix_cache_entries > 0 and ecfg.prefix_cache_pages != 0
            else None)
        # speculation counters: candidates proposed / accepted, and the
        # verify forwards that checked them
        self.speculation_proposed_tokens = 0
        self.speculation_accepted_tokens = 0
        self.verify_steps = 0
        # on-device grammar FSM lanes: per-slot automaton state (-1 =
        # unconstrained), grammar index into the shared table set, and
        # remaining token budget, all on the device and advanced there
        self._grammars = _GrammarTables(cfg.vocab_size, self.device)
        self._fsm = torch.full((B,), -1, dtype=torch.int32,
                               device=self.device)
        self._fsm_g = torch.zeros(B, dtype=torch.int32, device=self.device)
        self._budget = torch.zeros(B, dtype=torch.int32, device=self.device)
        # constrained-decoding counters: tokens emitted by device-FSM
        # lanes, host mask rows built from logits_mask_fn, over-tight
        # rows (no allowed token: the sampler degrades the row to
        # unconstrained), and lanes degraded from the FSM to the host mask
        self.constrained_ondevice_tokens = 0
        self.constrained_host_mask_steps = 0
        self.constrained_mask_overtight = 0
        self.constrained_degrades = 0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        if len(req.prompt_ids) == 0:
            raise ValueError("empty prompt")
        if self.ecfg.max_waiting > 0 and \
                len(self.waiting) >= self.ecfg.max_waiting:
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
        if self.ecfg.speculative_k > 0 and req.spec is None and (
                req.logits_mask_fn is None or req.grammar is not None):
            # free lanes and device-FSM lanes speculate (the verify step
            # masks every position with the FSM state reached through the
            # candidate prefix); host-masked lanes do not, their masks
            # need a host turnaround per token
            req.spec = LaneSpeculator(req.prompt_ids)
        req.submit_time = time.monotonic()
        req.state = WAITING
        self.waiting.append(req)
        self._requests[req.request_id] = req

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Abort a request (client disconnect); frees its slot and pages.
        Runs on the thread that drives step().  False for unknown or
        already finished ids."""
        req = self._requests.get(request_id)
        if req is None or req.state == FINISHED:
            return False
        if req.state == WAITING and req in self.waiting:
            self.waiting.remove(req)
        req.state = FINISHED
        req.finish_reason = reason
        self._release_slot(req)
        self._requests.pop(request_id, None)
        return True

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        return self.num_active > 0 or bool(self.waiting)

    def step(self) -> List[TokenEvent]:
        """One scheduler iteration: deadlines, admit, advance one prefill
        chunk per prefilling lane, decode every active lane."""
        self._check_deadlines()
        self._admit()
        self._advance_prefills()
        if any(s is not None and s.state == ACTIVE for s in self.slots):
            self._dispatch_decode()
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

    def retry_after_estimate(self) -> float:
        """Seconds until queue relief is plausible, for 429 Retry-After:
        the batch retires ~max_batch requests per (default token budget x
        per-token latency).  Clamped to [1, 120] — a hint, not a promise."""
        tpot_s = self._tpot_s or 0.05
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
        problems += self.pool.check_consistency()
        problems += self.pool.reconcile(self._expected_page_owners(),
                                        repair=repair)
        return problems

    def recover_from_failure(self) -> List[TokenEvent]:
        """Rebuild a servable engine after a step() exception: every
        request that had started compute gets exactly one terminal error
        event; WAITING requests stay queued; page accounting is verified
        and repaired."""
        events: List[TokenEvent] = list(self._out_events)
        self._out_events = []
        for req in list(self._requests.values()):
            if req.state == WAITING:
                if req.seq is not None:
                    self.pool.free_sequence(req.seq)
                    req.seq = None
                if req not in self.waiting:
                    self.waiting.append(req)
                continue
            req.state = FINISHED
            req.finish_reason = "error:engine"
            self._release_slot(req)
            self._requests.pop(req.request_id, None)
            events.append(TokenEvent(req.request_id, None, finished=True,
                                     finish_reason="error:engine"))
        self.waiting.sort(key=lambda r: r.submit_time)
        self._ctl_dirty = True
        self._fsm.fill_(-1)
        problems = self.self_check(repair=True)
        if problems:
            logger.error("post-failure self-check repaired %d problem(s): %s",
                         len(problems), "; ".join(problems))
        return events

    # ------------------------------------------------------------------
    # deadlines
    # ------------------------------------------------------------------

    def _check_deadlines(self) -> None:
        ecfg = self.ecfg
        now = time.monotonic()
        for req in list(self._requests.values()):
            if req.state == FINISHED:
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
        if req.state == WAITING and req in self.waiting:
            self.waiting.remove(req)
        req.state = FINISHED
        req.finish_reason = "timeout"
        self._release_slot(req)
        self._requests.pop(req.request_id, None)
        self._out_events.append(TokenEvent(req.request_id, None, finished=True,
                                           finish_reason="timeout"))

    # ------------------------------------------------------------------
    # scheduler internals
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
        """Strict submit-order FIFO: the waiting head takes each free slot
        once its prompt's pages fit."""
        while self.waiting:
            slot = self._free_slot()
            if slot is None or not self._admit_waiting_head(slot):
                break

    def _admit_waiting_head(self, slot: int) -> bool:
        """Start the waiting head's prefill in `slot`; False (queue
        untouched) when page-blocked.  A blocked head drops the prefix
        retains it took for the page estimate: waiting requests must not
        pin pool pages."""
        req = self.waiting[0]
        self._attach_prefix(req)
        needed = self._pages_needed(req)
        if needed > self.pool.free_pages and not self._reclaim_cache(needed):
            self._detach_prefix(req)
            return False
        self.waiting.pop(0)
        try:
            self._start_prefill(req, slot)
        except OutOfPagesError:
            self._detach_prefix(req)
            req.state = WAITING
            self.waiting.insert(0, req)
            return False
        return True

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
        hit = self.prefix_cache.lookup(req.prefix_key, req.prefill_ids)
        if hit is not None:
            req.seq = SequencePages(seq_id=req.request_id)
            req.seq.pages, req.seq.length = hit.pages, hit.tokens
            req.cached_tokens = hit.tokens
            req.cache_source = hit.source

    def _detach_prefix(self, req: GenRequest) -> None:
        """Roll back a page-blocked _attach_prefix: free the retains and
        clear the hit record (hits count only when the prefill starts)."""
        if req.seq is not None:
            self.pool.free_sequence(req.seq)
            req.seq = None
        req.cached_tokens = 0
        req.cache_source = None

    def _reclaim_cache(self, pages_needed: int) -> bool:
        """Evict prefix-cache leaves until `pages_needed` pages are free;
        False when the cache cannot free enough (or there is none)."""
        return self.prefix_cache is not None and \
            self.prefix_cache.reclaim(pages_needed)

    def _start_prefill(self, req: GenRequest, slot: int) -> None:
        req.seq = req.seq or SequencePages(seq_id=req.request_id)
        self.pool.ensure_capacity(req.seq, len(req.prefill_ids) + 1)
        if req.cached_tokens and self.prefix_cache is not None:
            # the attach survived the page gate: now the hit counts
            self.prefix_cache.commit_hit(req.cached_tokens, req.cache_source)
        if req.usage_cached_tokens is None:
            req.usage_cached_tokens = req.cached_tokens
        req.state = PREFILLING
        req.slot = slot
        self.slots[slot] = req
        self._ctl_dirty = True

    def _prefill_bucket_for(self, req: GenRequest) -> int:
        remaining = len(req.prefill_ids) - req.seq.length
        return next((b for b in self.ecfg.prefill_buckets if b >= remaining),
                    self.ecfg.prefill_buckets[-1])

    def _advance_prefills(self) -> None:
        """Advance the OLDEST <= W prefilling lanes one chunk (W = the
        batched-prefill width).  Same-bucket lanes fuse into one batched
        dispatch; on the kernel backend only buckets <= 128 do, so long
        chunks keep the flash prefill kernel."""
        prefilling = [s for s in self.slots
                      if s is not None and s.state == PREFILLING]
        if not prefilling:
            return
        W = min(4, self.ecfg.max_batch)
        if len(prefilling) > W:
            prefilling.sort(key=lambda r: r.submit_time)
            prefilling = prefilling[:W]
        groups: Dict[int, List[GenRequest]] = {}
        singles: List[GenRequest] = []
        for req in prefilling:
            bucket = self._prefill_bucket_for(req)
            if W >= 2 and (self.cfg.attention_backend != "kernel"
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

    def _advance_prefill(self, req: GenRequest) -> None:
        """Dispatch ONE single-sequence prefill chunk; the final chunk
        samples the first token and activates the lane."""
        ps, dev = self.ecfg.page_size, self.device
        start = req.seq.length
        prompt = req.prefill_ids
        bucket = self._prefill_bucket_for(req)
        chunk_len = min(len(prompt) - start, bucket)
        chunk = np.zeros(bucket, np.int64)
        chunk[:chunk_len] = prompt[start:start + chunk_len]
        row = self._page_row(req)
        C = self.ecfg.max_window
        kv_pos = torch.arange(C, device=dev)[None]
        paged = PagedView(
            write_idx=torch.from_numpy(
                self._write_slots(row, start, chunk_len, bucket)[None]
            ).to(dev),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=kv_pos < start + chunk_len,
            page_table=torch.from_numpy(row[None]).to(dev),
            page_size=ps,
            start=start,
            chunk_len=chunk_len,
        )
        positions = (start + torch.arange(bucket, device=dev))[None]
        logits, _ = forward(
            self.params, self.cfg, torch.from_numpy(chunk[None]).to(dev),
            positions, kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
            logits_at=torch.tensor([chunk_len - 1], device=dev),
        )
        req.seq.length = start + chunk_len
        if req.seq.length < len(prompt):
            return  # more chunks to go; decode proceeds meanwhile
        tok = self._sample(logits[:, 0], [req], [start + chunk_len - 1],
                           allowed=self._prefill_masks([req]))[0]
        self._finish_prefill(req, tok)

    def _advance_prefill_batch(self, bucket: int, reqs: List[GenRequest],
                               W: int) -> None:
        """One fused chunk dispatch for 2..W same-bucket lanes (plain
        attention over each lane's page-gathered window)."""
        ps, dev, C = self.ecfg.page_size, self.device, self.ecfg.max_window
        rows = np.full((W, self.ecfg.max_pages_per_seq), TRASH_PAGE, np.int32)
        chunks = np.zeros((W, bucket), np.int64)
        starts = np.zeros(W, np.int64)
        lens = np.zeros(W, np.int64)
        write = np.zeros((W, bucket), np.int64)
        for i in range(W):
            write[i] = np.arange(bucket) % ps  # idle lanes: trash page
        for i, req in enumerate(reqs):
            start = req.seq.length
            clen = min(len(req.prefill_ids) - start, bucket)
            chunks[i, :clen] = req.prefill_ids[start:start + clen]
            rows[i] = self._page_row(req)
            starts[i], lens[i] = start, clen
            write[i] = self._write_slots(rows[i], start, clen, bucket)
        active = np.zeros(W, bool)
        active[: len(reqs)] = True
        kv_pos = torch.arange(C, device=dev).expand(W, C)
        ends = torch.from_numpy(starts + lens).to(dev)
        paged = PagedView(
            write_idx=torch.from_numpy(write).to(dev),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=(kv_pos < ends[:, None])
            & torch.from_numpy(active).to(dev)[:, None],
            page_table=torch.from_numpy(rows).to(dev),
            page_size=ps,
        )
        positions = torch.from_numpy(starts).to(dev)[:, None] + \
            torch.arange(bucket, device=dev)[None]
        last = np.clip(lens - 1, 0, bucket - 1)
        logits, _ = forward(
            self.params, self.cfg, torch.from_numpy(chunks).to(dev),
            positions, kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged,
            logits_at=torch.from_numpy(last).to(dev),
        )
        done = []
        for i, req in enumerate(reqs):
            req.seq.length += int(lens[i])
            if req.seq.length >= len(req.prefill_ids):
                done.append(i)
        if not done:
            return
        finished = [reqs[i] for i in done]
        toks = self._sample(
            logits[done, 0], finished,
            [int(starts[i] + lens[i] - 1) for i in done],
            allowed=self._prefill_masks(finished))
        for i, tok in zip(done, toks):
            self._finish_prefill(reqs[i], tok)

    def _finish_prefill(self, req: GenRequest, tok: int) -> None:
        """Last chunk done: the lane joins the decode batch."""
        req.state = ACTIVE
        self._ctl_dirty = True
        if req.resumed:
            # re-entry after preemption: the pending last token is already
            # output_ids[-1]; the freshly sampled token is its duplicate
            req.resumed = False
            if req.logits:
                req.logits.pop()
        else:
            req.dispatched += 1
            self._process_token(req, tok,
                                self._limit_reason_after_dispatch(req))
        if req.state == ACTIVE:
            self._set_fsm_lane(req)

    def _limit_reason_after_dispatch(self, req: GenRequest) -> Optional[str]:
        if req.dispatched >= req.max_new_tokens:
            return "length"
        if req.seq is not None and req.seq.length + 1 >= self.ecfg.max_window:
            return "length"
        return None

    def _process_token(self, req: GenRequest, token: int,
                       final_reason: Optional[str]) -> None:
        req.output_ids.append(token)
        if req.grammar is not None:
            self.constrained_ondevice_tokens += 1
        if req.spec is not None:
            req.spec.push(token)  # keep the n-gram index tail-accurate
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
        if token in req.stop_token_ids:
            reason = "stop"
        elif final_reason is not None:
            reason = final_reason
        else:
            self._out_events.append(TokenEvent(req.request_id, token))
            return
        req.finish_reason = reason
        req.state = FINISHED
        if req.seq is not None and req.prefix_key is not None \
                and self.prefix_cache is not None:
            # Cache the thread's KV before the pages go back to the pool
            # (the cache takes its own retains).  Store only tokens whose
            # KV is materialized: seq.length counts them — the final
            # sampled token's KV is never written (it is the pending
            # decode input), so a page-aligned next turn must not share a
            # page holding an unwritten slot.
            self.prefix_cache.store(
                req.prefix_key,
                (req.prompt_ids + req.output_ids)[: req.seq.length],
                req.seq.pages)
        self._release_slot(req)
        self._requests.pop(req.request_id, None)
        self._out_events.append(TokenEvent(req.request_id, token,
                                           finished=True,
                                           finish_reason=reason))

    def _dispatch_decode(self) -> None:
        # grow pages for lanes about to write past their capacity
        for req in [s for s in self.slots if s is not None]:
            if req.state != ACTIVE or req.seq is None:
                continue  # preempted/retired by an earlier iteration
            self._ensure_pages(req)
        members = [s if s is not None and s.state == ACTIVE else None
                   for s in self.slots]
        live = [m for m in members if m is not None]
        if not live:
            return
        t0 = time.monotonic()
        verified = self.ecfg.speculative_k > 0 and \
            self._try_dispatch_verify(live)
        toks = [] if verified else self._decode(members)
        dt = time.monotonic() - t0
        self._tpot_s = dt if self._tpot_s is None else \
            0.9 * self._tpot_s + 0.1 * dt
        for req, tok in zip(live, toks):
            req.seq.length += 1  # the dispatched token's kv slot
            req.dispatched += 1
            self._process_token(req, tok,
                                self._limit_reason_after_dispatch(req))

    def _device_table(self) -> torch.Tensor:
        """The decode batch's page table on the device, re-uploaded only
        after a scheduling change."""
        if self._ctl_dirty:
            self._d_table = torch.from_numpy(page_table_array(
                [s.seq if s is not None else None for s in self.slots],
                self.ecfg.max_pages_per_seq)).to(self.device)
            self._ctl_dirty = False
        return self._d_table

    def _decode(self, members: List[Optional[GenRequest]]) -> List[int]:
        """One decode step for the active lanes of the batch; returns the
        sampled tokens of the non-None members, in slot order."""
        ps, dev, B = self.ecfg.page_size, self.device, self.ecfg.max_batch
        C = self.ecfg.max_window
        table = self._device_table()
        lens = np.zeros(B, np.int32)
        last = np.zeros(B, np.int64)
        write = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        for i, m in enumerate(members):
            if m is None:
                continue
            n = m.seq.length
            lens[i], last[i], active[i] = n, m.output_ids[-1], True
            write[i] = m.seq.pages[n // ps] * ps + n % ps
        d_lens = torch.from_numpy(lens).to(dev)
        d_active = torch.from_numpy(active).to(dev)
        kv_pos = torch.arange(C, device=dev).expand(B, C)
        paged = PagedView(
            write_idx=torch.from_numpy(write[:, None]).to(dev),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=(kv_pos <= d_lens.long()[:, None]) & d_active[:, None],
            page_table=table,
            seq_lens=d_lens,
            page_size=ps,
        )
        logits, _ = forward(
            self.params, self.cfg, torch.from_numpy(last[:, None]).to(dev),
            d_lens.long()[:, None], kv_cache=KVCache(self.k_pool, self.v_pool),
            paged=paged,
        )
        idx = [i for i, m in enumerate(members) if m is not None]
        fsm = any(members[i].grammar is not None for i in idx)
        mask = None
        if fsm:
            # device-FSM lanes: mask from each lane's state (all-True rows
            # for the others), then advance by the sampled token
            mask = grammar_allowed_mask(self._fsm, self._fsm_g, self._budget,
                                        d_active, *self._grammars.args())
        mask = self._host_rows(mask, [(i, members[i]) for i in idx])
        toks = self._sample(logits[idx, 0], [members[i] for i in idx],
                            [int(lens[i]) for i in idx],
                            allowed=None if mask is None else mask[idx])
        if fsm:
            full = np.zeros(B, np.int64)
            full[idx] = toks
            self._fsm = grammar_advance(
                self._fsm, self._fsm_g, torch.from_numpy(full).to(dev),
                d_active, self._grammars.token_class, self._grammars.trans)
            self._budget = self._budget - d_active.int()
        return toks

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

    def _try_dispatch_verify(self, live: List[GenRequest]) -> bool:
        """Propose, then run one [B, K+1] verify step for the active
        lanes.  False when no lane has a usable candidate run (plain
        decode then runs exactly as without speculation).  Candidate runs
        are clamped so a fully accepted run stays inside the token budget
        and the attention window; lanes without a proposal ride the same
        forward as an ordinary one-token decode (cand_len 0)."""
        ecfg = self.ecfg
        proposals: Dict[int, List[int]] = {}
        for s in live:
            if s.spec is None or self._host_constrained(s):
                continue
            room = min(ecfg.speculative_k,
                       s.max_new_tokens - s.dispatched - 1,
                       ecfg.max_window - 2 - s.seq.length)
            cands = s.spec.propose(room)
            if cands:
                proposals[s.slot] = [int(c) for c in cands]
        # grow pages over each proposer's whole write span (positions
        # seq_len..seq_len+cl); a page-blocked proposal shrinks to a
        # plain ride rather than preempt anyone for speculative work
        for s in live:
            cands = proposals.get(s.slot)
            if cands is None:
                continue
            need = s.seq.length + len(cands) + 1
            if self._grow(s.seq, need):
                continue
            short = -(-need // ecfg.page_size) - len(s.seq.pages)
            if not (self._reclaim_cache(short) and self._grow(s.seq, need)):
                del proposals[s.slot]
        if not proposals:
            return False
        for slot, cands in proposals.items():
            self._assert_private_tail(self.slots[slot], len(cands))
        self._verify(live, proposals)
        return True

    def _verify(self, live: List[GenRequest],
                proposals: Dict[int, List[int]]) -> None:
        """The verify forward and its acceptance.

        Lane i feeds [last_token, c_1..c_K] at positions seq_len..seq_len+K
        and writes the KV of its first cand_len + 1 of them (the rest, and
        idle lanes, write the trash page).  Every position is sampled with
        the sequential path's own (seed, position) draw; candidates are
        kept while sample == candidate, so the emitted tokens are the ones
        plain decode would have produced.  The rejected tail is rolled
        back by seq.length alone: its stale KV lies past the length,
        masked until those positions are written again."""
        ecfg, dev = self.ecfg, self.device
        ps, B, C = ecfg.page_size, ecfg.max_batch, ecfg.max_window
        S = ecfg.speculative_k + 1
        toks = np.zeros((B, S), np.int64)
        lens = np.zeros(B, np.int32)
        q_lens = np.ones(B, np.int32)
        write = np.tile(np.arange(S, dtype=np.int64) % ps, (B, 1))
        active = np.zeros(B, bool)
        for s in live:
            i, n = s.slot, s.seq.length
            cands = proposals.get(i, [])
            run = [s.output_ids[-1]] + cands
            toks[i, :len(run)] = run
            lens[i], q_lens[i], active[i] = n, len(run), True
            pos = n + np.arange(len(run))
            pages = np.asarray(s.seq.pages, np.int64)[pos // ps]
            write[i, :len(run)] = pages * ps + pos % ps
        table = self._device_table()
        d_lens = torch.from_numpy(lens).to(dev)
        ends = torch.from_numpy(lens.astype(np.int64) + q_lens).to(dev)
        kv_pos = torch.arange(C, device=dev).expand(B, C)
        positions = d_lens.long()[:, None] + torch.arange(S, device=dev)[None]
        paged = PagedView(
            write_idx=torch.from_numpy(write).to(dev),
            read_idx=None,
            kv_positions=kv_pos,
            kv_valid=(kv_pos < ends[:, None])
            & torch.from_numpy(active).to(dev)[:, None],
            page_table=table,
            seq_lens=d_lens,
            page_size=ps,
            q_lens=torch.from_numpy(q_lens).to(dev),
        )
        logits, _ = forward(
            self.params, self.cfg, torch.from_numpy(toks).to(dev), positions,
            kv_cache=KVCache(self.k_pool, self.v_pool), paged=paged)
        self.verify_steps += 1
        # sample only the rows acceptance can read: 0..cand_len per lane
        rows = [(s, j) for s in live for j in range(int(q_lens[s.slot]))]
        slots = [s.slot for s, _ in rows]
        flat = logits[slots, [j for _, j in rows]]
        d_active = torch.from_numpy(active).to(dev)
        fsm = any(s.grammar is not None for s in live)
        mask = states = None
        if fsm:
            # the FSM state BEFORE each position: states[:, j] is the
            # automaton after the first j candidates (what sequential
            # decode would thread); position j is masked with budget
            # budget - j.  Positions past cand_len walk candidates that
            # acceptance never reads.
            tc, trans, _, _ = self._grammars.args()
            cands = torch.from_numpy(toks[:, 1:]).to(dev)
            sts = [self._fsm]
            for j in range(S - 1):
                sts.append(grammar_advance(sts[-1], self._fsm_g, cands[:, j],
                                           d_active, tc, trans))
            states = torch.stack(sts, dim=1)                     # [B, S]
            per_pos = torch.stack([
                grammar_allowed_mask(sts[j], self._fsm_g, self._budget - j,
                                     d_active, *self._grammars.args())
                for j in range(S)], dim=1)                       # [B, S, V]
            mask = per_pos[slots, [j for _, j in rows]]
        # host-masked lanes ride with no candidates: one row each
        mask = self._host_rows(
            mask, [(r, s) for r, (s, j) in enumerate(rows)
                   if j == 0 and self._host_constrained(s)], n=len(rows))
        samples = self._sample(flat, [s for s, _ in rows],
                               [int(lens[s.slot]) + j for s, j in rows],
                               keep=False, allowed=mask)
        at = 0
        runs = []
        accepted = np.zeros(B, np.int64)
        bonus = np.zeros(B, np.int64)
        for s in live:
            cands = proposals.get(s.slot, [])
            row = samples[at:at + len(cands) + 1]
            kept = flat[at:at + len(cands) + 1]
            at += len(cands) + 1
            m = 0
            while m < len(cands) and row[m] == cands[m]:
                m += 1
            if cands:
                self.speculation_proposed_tokens += len(cands)
                self.speculation_accepted_tokens += m
                s.spec.observe(m, len(cands))
            accepted[s.slot], bonus[s.slot] = m, row[m]
            runs.append((s, row[:m + 1], kept[:m + 1]))
        if fsm:
            # rejected-tail FSM rollback: the lane keeps the state reached
            # through its accepted candidates, advanced by the bonus token
            # (the mirror of the seq.length rollback)
            d_m = torch.from_numpy(accepted).to(dev)
            s_m = states.gather(1, d_m[:, None])[:, 0]
            self._fsm = grammar_advance(
                s_m, self._fsm_g, torch.from_numpy(bonus).to(dev), d_active,
                self._grammars.token_class, self._grammars.trans)
            self._budget = self._budget - torch.where(
                d_active, d_m + 1, torch.zeros_like(d_m)).int()
        for s, run, kept in runs:
            self._emit_run(s, run, kept)

    def _emit_run(self, req: GenRequest, run: List[int],
                  logits: torch.Tensor) -> None:
        """Emit an accepted run (candidates + bonus token) with plain
        decode's host limits applied token by token: a stop token, the
        token budget or the window cuts the run exactly where sequential
        decode would have stopped."""
        old_len, old_disp = req.seq.length, req.dispatched
        req.seq.length += len(run)
        req.dispatched += len(run)
        if self.ecfg.keep_logits:
            req.logits.extend(logits.float().cpu())
        for j, tok in enumerate(run):
            final = None
            if old_disp + j + 1 >= req.max_new_tokens or \
                    old_len + j + 2 >= self.ecfg.max_window:
                final = "length"
            self._process_token(req, tok, final)
            if req.state == FINISHED:
                if self.ecfg.keep_logits:
                    del req.logits[len(req.output_ids):]
                return

    def _sample(self, logits: torch.Tensor, reqs: Sequence[GenRequest],
                positions: Sequence[int], keep: bool = True,
                allowed: Optional[torch.Tensor] = None) -> List[int]:
        """Sample one token per row; row i draws at (seed, positions[i]).
        keep=False leaves EngineConfig.keep_logits to the caller; allowed
        [rows, V] bool is the constrained-decoding mask (None: free)."""
        dev = logits.device
        params = SamplingParams(
            temperature=torch.tensor([r.temperature for r in reqs],
                                     dtype=torch.float32, device=dev),
            top_k=torch.tensor([r.top_k for r in reqs], dtype=torch.int64,
                               device=dev),
            top_p=torch.tensor([r.top_p for r in reqs], dtype=torch.float32,
                               device=dev),
        )
        toks = sample_tokens_per_slot(logits, params,
                                      [r.seed for r in reqs], positions,
                                      allowed_mask=allowed)
        if self.ecfg.keep_logits and keep:
            host = logits.float().cpu()
            for i, r in enumerate(reqs):
                r.logits.append(host[i])
        return [int(t) for t in toks.tolist()]

    # ------------------------------------------------------------------
    # constrained decoding
    # ------------------------------------------------------------------

    @staticmethod
    def _host_constrained(req: GenRequest) -> bool:
        """Does this lane take the host mask path?  Device-FSM lanes are
        masked and advanced on the device instead."""
        return req.logits_mask_fn is not None and req.grammar is None

    def _set_fsm_lane(self, req: GenRequest) -> None:
        """Seed the lane's device FSM state and budget as it joins the
        decode batch (prefill finish, resume after preemption): free lanes
        park the slot at -1; grammar lanes replay their output through
        the compiled table.  A grammar that cannot register or a replay
        that stops validating degrades the lane to the host mask path."""
        slot = req.slot
        if req.grammar is None:
            self._fsm[slot] = -1
            return
        g_idx = self._grammars.register(req.grammar)
        state = req.grammar.walk(req.output_ids) if g_idx is not None else -1
        if state < 0:
            self._degrade(req, "cannot register" if g_idx is None
                          else "replay stopped validating")
            self._fsm[slot] = -1
            return
        self._fsm[slot] = self._grammars.offsets[g_idx] + state
        self._fsm_g[slot] = g_idx
        self._budget[slot] = req.max_new_tokens - req.dispatched

    def _degrade(self, req: GenRequest, why: str) -> None:
        logger.warning("grammar for %s: %s; degrading to the host mask path",
                       req.request_id, why)
        req.grammar = None
        self.constrained_degrades += 1

    def _prefill_masks(self, reqs: Sequence[GenRequest]
                       ) -> Optional[torch.Tensor]:
        """[len(reqs), V] mask for the tokens a prefill samples, None when
        no lane is constrained.  Grammar lanes take their compiled row at
        the state their output replays to, under the decode step's
        wrap-up rule; host-masked lanes call their mask fn."""
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
        return torch.from_numpy(np.stack(
            [np.ones(V, bool) if r is None else r for r in rows])
        ).to(self.device)

    def _host_rows(self, mask: Optional[torch.Tensor],
                   lanes: Sequence[Tuple[int, GenRequest]],
                   n: Optional[int] = None) -> Optional[torch.Tensor]:
        """Write the host mask rows of the host-masked lanes among
        `lanes` ((row, request) pairs) into `mask` ([n or max_batch, V],
        created all-True when None).  Returns the mask, None when no row
        constrains."""
        for i, req in lanes:
            if not self._host_constrained(req):
                continue
            row = self._host_mask_row(req)
            if row is None:
                continue
            if mask is None:
                mask = torch.ones((n or self.ecfg.max_batch,
                                   self.cfg.vocab_size), dtype=torch.bool,
                                  device=self.device)
            mask[i] = torch.from_numpy(row).to(self.device)
        return mask

    def _host_mask_row(self, req: GenRequest) -> Optional[np.ndarray]:
        """[V] bool row from the lane's mask fn over its complete output
        (None: this step is free).  Ids outside the model vocab are
        dropped; a raising mask fn degrades the lane to unconstrained."""
        try:
            allowed = req.logits_mask_fn(req.output_ids)
        except Exception:
            logger.exception("logits_mask_fn failed for %s; degrading the "
                             "lane to unconstrained", req.request_id)
            req.logits_mask_fn = None
            return None
        if allowed is None:
            return None
        self.constrained_host_mask_steps += 1
        ids = np.asarray(allowed, np.int64)
        ids = ids[(ids >= 0) & (ids < self.cfg.vocab_size)]
        if len(ids) == 0:
            self._record_overtight(req)
        row = np.zeros(self.cfg.vocab_size, bool)
        row[ids] = True
        return row

    def _record_overtight(self, req: GenRequest) -> None:
        """An over-tight mask row (no token allowed): the sampler degrades
        it to unconstrained.  Counted every time, logged once per
        request."""
        self.constrained_mask_overtight += 1
        if req.overtight_logged:
            return
        req.overtight_logged = True
        fn = req.logits_mask_fn
        desc = fn.state_desc() if hasattr(fn, "state_desc") else "?"
        logger.warning("over-tight constrained mask for %s (state %s): the "
                       "sampler degrades this row to unconstrained",
                       req.request_id, desc)

    def _ensure_pages(self, req: GenRequest) -> None:
        """Grow req's pages for one more token.  Under pressure, evict
        prefix-cache leaves first (rebuilding one costs a prefill, no
        victim), then roll the youngest request back to the waiting
        queue; if that is not enough, roll req itself back rather than
        let it write into the trash page."""
        need = req.seq.length + 1
        if self._grow(req.seq, need) or (
                self._reclaim_cache(1) and self._grow(req.seq, need)):
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

    def _release_slot(self, req: GenRequest) -> None:
        """Free a request's batch slot and pages."""
        if req.slot >= 0:
            self.slots[req.slot] = None
            self._fsm[req.slot] = -1  # the next occupant starts free
            req.slot = -1
            self._ctl_dirty = True
        if req.seq is not None:
            self.pool.free_sequence(req.seq)
            req.seq = None

    def _preempt_youngest(self) -> None:
        cands = [s for s in self.slots if s is not None]
        if len(cands) <= 1:
            return
        self._preempt(max(cands, key=lambda r: r.submit_time))

    def _preempt(self, victim: GenRequest) -> None:
        logger.warning("preempting %s (out of KV pages)", victim.request_id)
        self.preemptions += 1
        self._release_slot(victim)
        # re-prefill later over prompt + generated-so-far, minus the final
        # output token: its KV was never written (it is the pending decode
        # input).  A victim caught mid-prefill restarts as a fresh prefill.
        victim.prefill_ids = victim.prompt_ids + victim.output_ids[:-1]
        victim.state = WAITING
        victim.resumed = bool(victim.output_ids)
        self.waiting.insert(0, victim)
