"""`TorchLLMProvider` — the LLMProvider served by the in-process CUDA engine.

Counterpart of kafka_tpu/llm/tpu_provider.py.  The engine is one
InferenceEngine or a DataParallelEngines router over replicas
(runtime/dp_router.py); requests go into it via the dispatch thread
(llm/worker.py) and stream back per token:

* context overflow raises a typed ContextLengthError before any compute;
* chunks are yielded as the decode loop emits tokens;
* usage is reported on every path, streaming included, with
  prompt_tokens_details.cached_tokens for the prompt span served from the
  engine's radix prefix cache (the thread route passes the thread id as
  `prefix_key`, so a thread's next turn prefills only its new tokens);
* generated text that opens a JSON object or array is buffered and parsed
  into OpenAI tool_calls; plain text streams through immediately;
* `tool_choice` "required" or a named function constrains the tokens:
  `build_tool_call_mask_fn` gives the agent loop a ToolCallMaskFn
  (llm/constrained.py), and `stream_completion` lowers it to a compiled
  token DFA that the engine advances on the device
  (KAFKA_TORCH_GRAMMAR_ONDEVICE, on by default); the mask fn stays on the
  request as the host-mask fallback.

* each request carries the ambient trace context (tracing.py) across the
  thread boundary, so the engine records its queue, prefill, decode and
  emit spans against the request's trace;
* `background=True` (the agent loop's tool-result turns, when it asks
  for them) puts the request in the engine's background class;
* `drain` lets in-flight requests finish on shutdown, then cancels;
  `drain_replicas` flushes replicas' warm KV into the object store;
* `resize_dp` rebuilds the replica set at a new dp count (and role
  pools) under live traffic, WAITING requests surviving (POST
  /admin/resize, the autoscaler's act mode);
* `signals` is the autoscaler's input snapshot (GET /admin/signals) and
  `record_rejection` counts a gate-level 429 in the metrics registry.

* image parts (OpenAI `image_url` and Anthropic-style `image`) are
  served through the vision tower when the model has one (a ViT soft
  prompt, models/vision.py, encoded on the engine's device off the event
  loop); a text-only model answers them with a typed 400
  (UnsupportedContentError), never as text alone.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

import numpy as np

from ..core.types import (
    ContextLengthError,
    LLMProviderError,
    ServerOverloadedError,
    StreamChunk,
    UnsupportedContentError,
    Usage,
    new_completion_id,
)
from .. import tracing
from ..models.config import ModelConfig
from ..models.tokenizer import BaseTokenizer, parse_tool_call_text
from ..runtime.engine import GenRequest, InferenceEngine, TokenEvent
from .base import LLMProvider, MessageLike, to_message_dicts
from .constrained import (
    build_tool_call_mask_fn,
    compile_grammar_for_mask_fn,
    grammar_ondevice_enabled,
)
from .images import expand_placeholders, extract_images, sentinelize_images
from .utils import count_images, prune_images
from .worker import EngineWorker

logger = logging.getLogger("kafka_tpu_torch.llm.torch_provider")

# resize_dp `roles` default: keep the current role-pool spec (re-derived
# for the new dp by the router).  Distinct from None, which dissolves the
# pools back to colocated serving.
_ROLES_KEEP = object()


def _torn_items(d) -> list:
    """Snapshot the items of a dict the engine thread mutates
    concurrently: list() can raise "dictionary changed size" mid-copy, so
    retry; a torn read is fine (a request finishing during the copy needs
    no attention)."""
    for _ in range(8):
        try:
            return list(d.items())
        except RuntimeError:
            continue
    return []


class IncrementalDetokenizer:
    """Streams token ids to text without re-decoding the whole output.

    Two-offset scheme: hold back the tail while it decodes to an
    incomplete UTF-8 sequence (replacement char), emit once it stabilizes.
    """

    def __init__(self, tokenizer: BaseTokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._prefix = 0
        self._read = 0

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        emitted = self._tok.decode(self._ids[self._prefix: self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        if len(full) > len(emitted) and not full.endswith("�"):
            delta = full[len(emitted):]
            self._prefix = self._read
            self._read = len(self._ids)
            return delta
        return ""

    def flush(self) -> str:
        """Emit whatever remains (end of stream), replacement chars and all."""
        emitted = self._tok.decode(self._ids[self._prefix: self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        self._read = self._prefix = len(self._ids)
        return full[len(emitted):] if len(full) > len(emitted) else ""

    @property
    def ids(self) -> List[int]:
        return self._ids


class TorchLLMProvider(LLMProvider):
    """Serves chat completions from the in-process CUDA engine."""

    provider_name = "torch"
    # callers that own an agent loop feature-detect this before passing
    # background=True
    supports_background = True

    def __init__(self, engine: InferenceEngine, tokenizer: BaseTokenizer,
                 model_name: str = "llama",
                 worker: Optional[EngineWorker] = None,
                 vision_params: Any = None):
        # vision tower params (models/vision.py), present iff the model
        # config has a VisionConfig; image requests answer 400 otherwise.
        # The sentinel scheme (llm/images.py) needs a tokenizer where NUL
        # is one token that round-trips (the byte tokenizer's id 0): a
        # subword tokenizer would silently mis-split it
        self.vision_params = None
        if vision_params is not None and engine.cfg.vision is not None:
            nul = tokenizer.encode("\x00")
            if len(nul) != 1 or tokenizer.decode(nul) != "\x00":
                raise ValueError(
                    "vision serving requires a tokenizer with a "
                    "single-token NUL sentinel (byte-level); this "
                    f"tokenizer encodes NUL as {nul!r}")
            self.vision_params = vision_params
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.worker = worker or EngineWorker(engine)
        self.worker.start()
        self._counter = itertools.count()
        # one resize at a time; while held (or waited on) the admission
        # gate turns new traffic away, so the resize drain works a finite
        # set and converges
        self._resize_lock = asyncio.Lock()
        # True while a cancelled rebuild thread still runs: its completion
        # callback owns the worker resume, and the orphaned future gates
        # the next resize (_resize_locked)
        self._rebuild_owns_resume = False
        self._orphan_rebuild: Optional[Any] = None
        # the autoscaler control loop (runtime/autoscaler.py) attaches
        # itself here; /admin/signals echoes its state when present
        self.autoscaler: Optional[Any] = None

    @property
    def model_cfg(self) -> ModelConfig:
        return self.engine.cfg

    def count_prompt_tokens(self, messages: Sequence[MessageLike],
                            tools: Optional[List[Dict[str, Any]]] = None
                            ) -> int:
        """Token count of the rendered prompt (compaction pre-flight).
        A vision prompt is priced with its expansion: each image left
        after the newest-N pruning costs num_patches placeholder tokens
        in place of its one-token sentinel."""
        dicts = to_message_dicts(messages)
        if self.vision_params is not None and count_images(dicts):
            dicts, parts = sentinelize_images(prune_images(dicts))
            n = len(self.tokenizer.encode_chat(dicts, tools=tools))
            return n + len(parts) * (self.model_cfg.vision.num_patches - 1)
        return len(self.tokenizer.encode_chat(dicts, tools=tools))

    @property
    def max_prompt_tokens(self) -> int:
        """Largest admissible prompt (engine window, minus 1 for decode)."""
        return min(self.engine.ecfg.max_window,
                   self.model_cfg.max_context) - 1

    def note_tool_return(self, prefix_key: Optional[str]) -> None:
        """The thread's tool finished: fire its expected-return hint, so a
        demote still in its linger cancels and a demoted thread's runs
        are protected (and prefetched) before the follow-up turn.  An
        engine-thread op via the worker inbox; no-op with
        KAFKA_TORCH_AGENT_DEMOTE unset."""
        self.worker.note_tool_return(prefix_key)

    def _replicas(self) -> List[InferenceEngine]:
        """The engine as a replica list: a DataParallelEngines router
        unwraps to its .engines; one engine is its own one-element set."""
        return getattr(self.engine, "engines", [self.engine])

    async def drain_replica(self, replica: int) -> Dict[str, Any]:
        """Flush one replica's warm KV state into the shared object store
        (POST /admin/drain/{replica}): every cached radix run archived
        content-addressed and every thread's sleep manifest written, so a
        scale-in removing the replica discards no warm conversation —
        dormant threads wake on the survivors (cache_source=
        "object_tier") instead of re-prefilling.  Non-destructive and
        idempotent.  An index out of range raises ValueError."""
        return (await self.drain_replicas([replica]))[0]

    async def drain_replicas(self, indices) -> List[Dict[str, Any]]:
        """drain_replica over several replicas under ONE worker pause (the
        autoscaler's pre-scale-in drain covers the whole fleet).  The
        flush gathers pool pages and walks the radix tree — single-writer
        engine state — so it runs with the worker parked, off the event
        loop, and serialized against resizes by the same lock."""
        indices = list(indices)
        async with self._resize_lock:
            # resolve the replicas under the lock: a resize replaces the
            # replica list wholesale
            replicas = self._replicas()
            sleeps = []
            for i in indices:
                if not 0 <= i < len(replicas):
                    raise ValueError(
                        f"replica {i} out of range (dp={len(replicas)})")
                sleeps.append(replicas[i].sleep_to_object)
            if not await asyncio.to_thread(self.worker.pause):
                self.worker.resume()
                raise RuntimeError("engine worker did not pause")
            try:
                all_stats = await asyncio.get_running_loop(
                ).run_in_executor(None, lambda: [s() for s in sleeps])
            finally:
                self.worker.resume()
        for i, stats in zip(indices, all_stats):
            stats["replica"] = i
        return all_stats

    def admission_check(self) -> Optional[float]:
        """None = admit; else a Retry-After estimate in seconds.  Reads the
        engine thread's queue lengths unsynchronized — a torn read makes
        the gate one step stale, and the engine's max_waiting bound is the
        authoritative backstop.  With replicas, admit while any ROUTABLE
        replica has room (a quarantined replica's empty queue is not
        capacity); during a resize, turn traffic away so the resize drain
        works a finite set."""
        if self._resize_lock.locked():
            return 5.0
        limit = self.engine.ecfg.max_waiting
        if limit <= 0:
            return None
        replicas = self._replicas()
        health = getattr(self.engine, "health", None)
        if health is not None:
            routable = [e for e, h in zip(replicas, health) if h.routable]
            replicas = routable or replicas
        if any(len(e.waiting) < limit for e in replicas):
            return None
        return min(e.retry_after_estimate() for e in replicas)

    def record_rejection(self) -> None:
        """Count a gate-level HTTP 429 in requests.rejected (the engine
        backstop counts its own).  A rejection is also an SLO miss, and a
        flight-recorder "reject" cause drained into the next ring record.
        Cross-thread int increments: GIL-atomic enough for counters."""
        replica = self._replicas()[0]
        replica.metrics.record_rejected()
        if replica.flight is not None:
            replica.flight.note_gate_reject()

    def signals(self) -> Dict[str, Any]:
        """One coherent autoscaler-input snapshot (GET /admin/signals),
        the reference's contract (kafka_tpu/llm/tpu_provider.py signals,
        version 9) with the same keys: dp-wide queue depth, peak and 60s
        trend; decode-slot occupancy over max_batch x dp; windowed SLO
        attainment and goodput; per-kind MFU / bandwidth utilization and
        model skew; per-replica health state (quarantined replicas are
        capacity the router cannot use), load, pages and anomalies; one
        entry per role pool ("colocated" without role pools) so prefill
        and decode pools size independently; the router's ship counters;
        the object store's occupancy and health (the breaker state is the
        dp maximum); the autoscaler's state when one runs; the compile
        observatory; the memory monitor's measured headroom; the agent
        section.  Awaiting-tool threads are not load: they forecast wake
        traffic.  Read torn-tolerantly from the engine thread's
        single-writer metrics."""
        engine = self.engine
        # reset_peak=False: the ~1 Hz signal poll must not consume the
        # /metrics scraper's peak-since-last-snapshot window
        snap = engine.metrics.snapshot(engine, reset_peak=False)
        replicas = self._replicas()
        health = getattr(engine, "health", None)
        occupancy = snap.get("decode", {}).get("batch_occupancy", 0.0)
        max_batch = engine.ecfg.max_batch
        per_replica: List[Dict[str, Any]] = []
        rep_snaps = snap.get("replicas")
        for i, e in enumerate(replicas):
            rs = (rep_snaps[i] if rep_snaps and i < len(rep_snaps)
                  else snap)
            util = rs.get("utilization") or {}
            per_replica.append({
                "replica": i,
                "state": health[i].state if health else "healthy",
                "active": e.num_active,
                "waiting": len(e.waiting),
                "parked": len(e.parked),
                "pages_free": e.pool.free_pages,
                "pages_total": e.pool.num_pages,
                "batch_occupancy": rs.get("decode", {}).get(
                    "batch_occupancy", 0.0
                ),
                "anomalies_active": (rs.get("anomalies") or {}).get(
                    "anomalies_active", 0
                ),
                "utilization": {
                    kind: {
                        "mfu": util.get(kind, {}).get("mfu", 0.0),
                        "mfu_1m": util.get(kind, {}).get("mfu_1m", 0.0),
                        "hbm_bw_util": util.get(kind, {}).get(
                            "hbm_bw_util", 0.0
                        ),
                        "hbm_bw_util_1m": util.get(kind, {}).get(
                            "hbm_bw_util_1m", 0.0
                        ),
                        # measured/modeled calibration: >1 =
                        # this replica runs slower than the cost model
                        # assumes, so its MFU figures read high
                        "model_skew": util.get(kind, {}).get(
                            "model_skew", 0.0
                        ),
                    }
                    for kind in ("prefill", "decode", "verify")
                },
            })
        # anomalies: the aggregate section already attributes active
        # entries to replicas (dp); a single engine's lacks the field —
        # stamp replica 0 so the contract shape is dp-independent
        anomalies = dict(snap.get("anomalies") or {})
        if anomalies.get("active"):
            anomalies["active"] = [
                {**a, "replica": a.get("replica", 0)}
                for a in anomalies["active"]
            ]
        # Per-pool section: the aggregate snapshot
        # carries it when role pools are configured; otherwise the whole
        # fleet is one "colocated" pool so the contract shape is
        # role-independent.
        disagg = snap.get("disagg") or {}
        if disagg.get("pools"):
            pools = disagg["pools"]
        else:
            pools = [{
                "role": "colocated",
                "replicas": list(range(len(replicas))),
                "queue_depth": sum(len(e.waiting) for e in replicas),
                "active": engine.num_active,
                "parked": sum(len(e.parked) for e in replicas),
                "batch_occupancy": occupancy,
                "utilization": {
                    kind: {
                        k: (snap.get("utilization") or {}).get(
                            kind, {}
                        ).get(k, 0.0)
                        for k in ("mfu", "mfu_1m", "hbm_bw_util",
                                  "hbm_bw_util_1m")
                    }
                    for kind in ("prefill", "decode", "verify")
                },
            }]
        # SLO section: the raw window dicts stay internal to /metrics,
        # but the controller needs to know whether the 1m attainment
        # gauge rests on enough verdicts to act on — version 4 exports
        # that one scalar (met + missed in the 60s window)
        slo_src = snap.get("slo") or {}
        slo_out = {
            k: v for k, v in slo_src.items()
            if not k.startswith("window_")
        }
        w1 = slo_src.get("window_1m") or {}
        slo_out["window_1m_requests"] = int(
            (w1.get("met") or 0) + (w1.get("missed") or 0)
        )
        scaler = self.autoscaler
        # Object-store tier: shared-store occupancy,
        # the cross-host dedupe ratio, and wake counts — the autoscaler's
        # "drain-then-shrink is cheap here" signal.  Version 6
        # adds store health: breaker state (the dp-aggregate max, so any
        # replica's open breaker surfaces), retry/timeout counters, and
        # store_available — False tells a controller the pre-scale-in
        # drain will be skipped (capacity beats warm state).  Null when
        # KAFKA_TORCH_KV_OBJECT_DIR is unset.
        obj = snap.get("object_tier") or None
        object_section = None
        if obj:
            tried = (obj.get("object_puts", 0)
                     + obj.get("dedupe_hits", 0))
            breaker_gauge = int(obj.get("store_breaker_state", 0))
            object_section = {
                "store_bytes": obj.get("store_bytes", 0),
                "store_objects": obj.get("store_objects", 0),
                "dedupe_ratio": round(
                    obj.get("dedupe_hits", 0) / tried, 4
                ) if tried else 0.0,
                "wake_threads": obj.get("wake_threads", 0),
                "wake_tokens": obj.get("wake_tokens", 0),
                "breaker_state": {0: "closed", 1: "half_open",
                                  2: "open"}.get(breaker_gauge, "open"),
                "breaker_opens": obj.get("store_breaker_opens", 0),
                "store_available": breaker_gauge != 2,
                "store_retries": obj.get("store_retries", 0),
                "store_timeouts": obj.get("store_timeouts", 0),
                "store_errors": (obj.get("object_put_failures", 0)
                                 + obj.get("object_get_failures", 0)),
                "probe_neg_cached": obj.get("store_probe_neg_cached", 0),
                # version 8: wake-prefetch effectiveness —
                # hits vs wasted tells a controller whether the staging
                # budget is sized right (all zeros = prefetch off)
                "prefetch": {
                    "hits": obj.get("prefetch_hits", 0),
                    "wasted": obj.get("prefetch_wasted", 0),
                    "bytes": obj.get("prefetch_bytes", 0),
                    "inflight": obj.get("prefetch_inflight", 0),
                },
            }
        # Device-truth sections.  compiles: the
        # process-wide observatory ring summary — storm_active is the
        # "compiling under live traffic" veto input (null when
        # KAFKA_TORCH_COMPILE_RING=0).  memory: measured HBM per replica
        # plus the worst-case aggregate — a controller sizes scale-up
        # against MEASURED headroom (min across replicas) and treats
        # plan_skew > 1 as "the plan under-charges, trust the device".
        from ..runtime import compile_log

        obs = compile_log.get()
        compiles_section = (
            obs.signals_section() if obs is not None else None
        )
        mem_reps: List[Dict[str, Any]] = []
        for i, e in enumerate(replicas):
            mm = getattr(e, "memory_monitor", None)
            sec = mm.section() if mm is not None else None
            if not sec or sec.get("source") == "none":
                continue
            mem_reps.append({
                "replica": i,
                "source": sec["source"],
                "hbm_bytes_in_use": sec["hbm_bytes_in_use"],
                "hbm_bytes_limit": sec["hbm_bytes_limit"],
                "hbm_headroom_bytes": sec["hbm_headroom_bytes"],
                "hbm_plan_skew": sec["hbm_plan_skew"],
                "hbm_pressure": sec["hbm_pressure"],
            })
        memory_section = None
        if mem_reps:
            memory_section = {
                "headroom_bytes": min(
                    r["hbm_headroom_bytes"] for r in mem_reps
                ),
                "plan_skew": max(r["hbm_plan_skew"] for r in mem_reps),
                "pressure": max(r["hbm_pressure"] for r in mem_reps),
                "replicas": mem_reps,
            }
        # Agent-native scheduling.  awaiting_*
        # describes threads parked mid-tool-gap: NOT load (no decode
        # slot, KV in lower tiers) — a controller must exclude them
        # from demand sizing and read them only as a wake-traffic
        # forecast.  All zeros knobs-off.
        ag = snap.get("agent") or {}
        agent_section = {
            "awaiting_threads": ag.get("agent_awaiting_threads", 0),
            "awaiting_bytes": ag.get("agent_awaiting_bytes", 0),
            "gaps": ag.get("agent_gaps", 0),
            "gap_demotions": ag.get("agent_gap_demotions", 0),
            "gap_pages_demoted": ag.get("agent_gap_pages_demoted", 0),
            "gap_bytes_demoted": ag.get("agent_gap_bytes_demoted", 0),
            "gap_cancelled": ag.get("agent_gap_cancelled", 0),
            "hint_hits": ag.get("agent_hint_hits", 0),
            "hint_misses": ag.get("agent_hint_misses", 0),
            "bg_queue_depth": ag.get("bg_queue_depth", 0),
            "bg_admitted": ag.get("bg_admitted", 0),
            "bg_chunks": ag.get("bg_chunks", 0),
            "bg_yields": ag.get("bg_yields", 0),
        }
        return {
            "version": 9,
            "dp": len(replicas),
            "queue": dict(snap.get("queue") or {}),
            "anomalies": anomalies,
            "agent": agent_section,
            "compiles": compiles_section,
            "memory": memory_section,
            "pools": pools,
            "object_tier": object_section,
            "disagg": {
                k: v for k, v in disagg.items()
                if k not in ("pools", "ship_ms")
            } or None,
            "autoscaler": (
                scaler.signals_section() if scaler is not None else None
            ),
            "batch": {
                "occupancy": occupancy,
                "occupancy_frac": round(occupancy / max_batch, 4)
                if max_batch else 0.0,
                "active": engine.num_active,
                "max_batch": max_batch,
                "slots_total": max_batch * len(replicas),
            },
            "slo": slo_out,
            "utilization": snap.get("utilization") or {},
            "replicas": per_replica,
            "supervisor": {
                k: v for k, v in snap["replica_supervisor"].items()
                if k != "health"
            } if snap.get("replica_supervisor") else None,
        }

    def get_model_info(self, model: Optional[str] = None) -> Dict[str, Any]:
        return {
            "id": model or self.model_name,
            "provider": self.provider_name,
            "max_context": self.model_cfg.max_context,
            "max_window": self.engine.ecfg.max_window,
            "vocab_size": self.model_cfg.vocab_size,
            "supports_tools": True,
            "supports_streaming": True,
            "device": str(self.engine.device),
            # what EngineConfig.attention_backend resolved to; "plain" on
            # CUDA comes with the engine's attention_backend_reasons
            "attention_backend": self.model_cfg.attention_backend,
            # draft-free speculative decoding depth (0 = off)
            "speculative_k": self.engine.ecfg.speculative_k,
            # on-device grammar FSM for constrained tool-call decoding
            # (KAFKA_TORCH_GRAMMAR_ONDEVICE; llm/constrained.py)
            "grammar_ondevice": grammar_ondevice_enabled(),
        }

    def build_tool_call_mask_fn(
        self,
        tools: Optional[List[Dict[str, Any]]],
        tool_choice: Any = "required",
    ):
        """Constrained decoding over the local sampler (llm/constrained.py):
        the returned fn plugs into GenRequest.logits_mask_fn and forces
        schema-valid tool-call JSON."""
        return build_tool_call_mask_fn(self.tokenizer, tools or [],
                                       tool_choice)

    def get_available_models(self) -> List[Dict[str, Any]]:
        return [{"id": self.model_name, "object": "model",
                 "owned_by": "kafka-tpu-torch", "created": 0}]

    def _encode_image_parts(self, dicts: List[Dict[str, Any]]):
        """Decode the image parts (PIL) and run the tower where its
        weights live: (messages with each image replaced by the NUL
        sentinel, [n_images * num_patches, H] f32 rows).  Blocking: the
        caller runs it off the event loop.  The tower's launches wait
        while an engine captures a decode graph (a process-wide capture
        forbids other threads' CUDA calls)."""
        import torch

        from ..models.vision import encode_images
        from ..runtime.engine import capture_lock

        vcfg = self.model_cfg.vision
        dicts, pixels = extract_images(dicts, vcfg.image_size)
        with capture_lock, torch.no_grad():
            emb = encode_images(self.vision_params, vcfg,
                                torch.from_numpy(np.stack(pixels)))
            rows = emb.float().cpu().numpy()
        return dicts, rows.reshape(-1, self.model_cfg.hidden_size)

    async def stream_completion(
        self,
        messages: Sequence[MessageLike],
        model: Optional[str] = None,
        temperature: float = 0.7,
        max_tokens: Optional[int] = None,
        tools: Optional[List[Dict[str, Any]]] = None,
        top_p: float = 1.0,
        top_k: int = 0,
        seed: Optional[int] = None,
        prefix_key: Optional[str] = None,
        logits_mask_fn=None,
        background: bool = False,
        **kwargs: Any,
    ) -> AsyncIterator[StreamChunk]:
        self.validate_messages(messages)
        dicts = to_message_dicts(messages)
        # image parts: a vision model serves them as a soft prompt (the
        # newest 19 kept); a text-only model refuses them with a typed 400
        # rather than answering as if it had seen no image
        n_images = count_images(dicts)
        override_pos = override_rows = None
        if n_images:
            if self.vision_params is None:
                raise UnsupportedContentError(n_images,
                                              provider=self.provider_name)
            dicts, override_rows = await asyncio.to_thread(
                self._encode_image_parts, prune_images(dicts))
            # each sentinel -> num_patches placeholder ids at the
            # absolute positions the override rows fill
            P = self.model_cfg.vision.num_patches
            prompt_ids, override_pos = expand_placeholders(
                self.tokenizer.encode_chat(dicts, tools=tools),
                self.tokenizer.encode("\x00")[0],
                self.model_cfg.image_token_id, P, len(override_rows) // P)
            # the same placeholder ids stand for different pixels: an
            # image turn never shares prefix-cached KV
            prefix_key = None
        else:
            prompt_ids = self.tokenizer.encode_chat(dicts, tools=tools)
        if len(prompt_ids) > self.max_prompt_tokens:
            raise ContextLengthError(len(prompt_ids), self.max_prompt_tokens,
                                     self.provider_name)
        # the on-device grammar FSM: the mask lowered to a token DFA the
        # engine advances inside its decode and verify steps.  Cached per
        # (tokenizer, schema, vocab); large-vocab schemas compile on a
        # background worker and serve through the host mask until the
        # table lands.  None (disabled, a custom mask fn, an uncompilable
        # grammar) keeps the host mask path.
        grammar = None
        if logits_mask_fn is not None:
            grammar = await asyncio.to_thread(
                compile_grammar_for_mask_fn, logits_mask_fn,
                self.model_cfg.vocab_size)
        completion_id = new_completion_id()
        model_id = model or self.model_name
        req = GenRequest(
            request_id=f"{completion_id}-{next(self._counter)}",
            prompt_ids=prompt_ids,
            max_new_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            seed=seed if seed is not None else 0,
            stop_token_ids=tuple(self.tokenizer.stop_ids),
            prefix_key=prefix_key,
            logits_mask_fn=logits_mask_fn,
            grammar=grammar,
            override_pos=override_pos,
            override_rows=override_rows,
            # the background class: tool-result prefill rides idle
            # capacity, yielding to interactive work every iteration
            background=background,
            # the engine thread records its spans against this context
            # (None = untraced, one branch per span site)
            trace=tracing.current(),
        )
        events = self.worker.submit(req, asyncio.get_running_loop())

        # role header first (OpenAI convention)
        yield StreamChunk(role="assistant", id=completion_id, model=model_id)

        detok = IncrementalDetokenizer(self.tokenizer)
        # tool-call detection: undecided until the first non-space char;
        # "{" / "[" switches to buffering mode, anything else streams
        mode = "undecided"
        buffered: List[str] = []
        n_tokens = 0
        try:
            while True:
                ev: TokenEvent = await events.get()
                reason = ev.finish_reason or ""
                if reason.startswith("rejected:"):
                    parts = reason.split(":", 2)
                    try:
                        retry = float(parts[1])
                    except (IndexError, ValueError):
                        retry = 5.0
                    raise ServerOverloadedError(retry,
                                                provider=self.provider_name)
                if reason.startswith("error:"):
                    raise LLMProviderError(reason[len("error:"):],
                                           provider=self.provider_name)
                if reason == "cancelled":
                    raise asyncio.CancelledError("generation cancelled")
                text = ""
                if ev.token_id is not None:
                    n_tokens += 1
                    text = detok.push(ev.token_id)
                if ev.finished:
                    text += detok.flush()
                if text:
                    if mode == "undecided":
                        probe = ("".join(buffered) + text).lstrip()
                        if not probe:
                            buffered.append(text)
                        elif probe[0] in "[{":
                            mode = "tool"
                            buffered.append(text)
                        else:
                            mode = "text"
                            pending = "".join(buffered) + text
                            buffered = []
                            yield StreamChunk(content=pending,
                                              id=completion_id,
                                              model=model_id)
                    elif mode == "tool":
                        buffered.append(text)
                    else:
                        yield StreamChunk(content=text, id=completion_id,
                                          model=model_id)
                if ev.finished:
                    final = self._finalize(
                        mode, buffered, ev, completion_id, model_id,
                        len(prompt_ids), n_tokens,
                        req.usage_cached_tokens or 0)
                    if any(c.finish_reason == "tool_calls" for c in final):
                        # the thread leaves for a tool call: start the
                        # demote linger (engine thread, via the inbox;
                        # no-op with KAFKA_TORCH_AGENT_DEMOTE unset)
                        self.worker.note_tool_gap(req.prefix_key)
                    for chunk in final:
                        yield chunk
                    return
        finally:
            if req.state != "finished":
                self.worker.cancel(req.request_id)

    def _finalize(self, mode: str, buffered: List[str], ev: TokenEvent,
                  completion_id: str, model_id: str, prompt_tokens: int,
                  completion_tokens: int, cached_tokens: int = 0
                  ) -> List[StreamChunk]:
        """Terminal chunks: flush buffers, resolve tool calls, report usage."""
        chunks: List[StreamChunk] = []
        finish = ev.finish_reason or "stop"
        text = "".join(buffered)
        tool_calls = parse_tool_call_text(text) if mode == "tool" else None
        if tool_calls:
            deltas = [{"index": i, "id": tc["id"], "type": "function",
                       "function": tc["function"]}
                      for i, tc in enumerate(tool_calls)]
            chunks.append(StreamChunk(tool_calls=deltas, id=completion_id,
                                      model=model_id))
            finish = "tool_calls"
        elif text:
            chunks.append(StreamChunk(content=text, id=completion_id,
                                      model=model_id))
        usage = Usage(
            prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens,
            total_tokens=prompt_tokens + completion_tokens,
            # OpenAI-compatible prompt_tokens_details.cached_tokens: the
            # prompt span served from radix-cached KV pages (own- or
            # cross-thread) instead of prefill compute
            cached_prompt_tokens=cached_tokens,
        )
        chunks.append(StreamChunk(finish_reason=finish, id=completion_id,
                                  model=model_id, usage=usage.to_dict()))
        return chunks

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: let in-flight requests finish, then cancel the
        rest.  True when everything finished within the timeout.  The
        server has stopped admitting; reads only the engines' own host
        state (has_work, the request tables), never the device."""
        deadline = time.monotonic() + timeout_s
        replicas = self._replicas()
        while time.monotonic() < deadline:
            if not any(e.has_work for e in replicas):
                return True
            await asyncio.sleep(0.05)
        leftover = [rid for e in replicas
                    for rid, _ in _torn_items(e._requests)]
        if leftover:
            logger.warning("drain timeout after %.1fs: cancelling %d "
                           "in-flight request(s)", timeout_s, len(leftover))
            for rid in leftover:
                self.worker.cancel(rid)
            # let the engine thread process the cancels so every stream
            # sees its terminal event before teardown
            settle = time.monotonic() + min(2.0, timeout_s)
            while time.monotonic() < settle and any(
                    e.has_work for e in replicas):
                await asyncio.sleep(0.02)
        return not leftover

    async def resize_dp(self, dp: int, drain_timeout_s: float = 30.0,
                        roles: Any = _ROLES_KEEP) -> bool:
        """Rebuild the DP replica set at a new dp count while WAITING
        requests survive (POST /admin/resize and the autoscaler's act
        mode share this path).  `roles` re-shapes the role pools in the
        same rebuild: a "prefill:P,decode:D" spec (P + D == dp), None/""
        dissolves them, the default keeps the current spec.

        Started lanes own device state that cannot move across engines,
        so they get `drain_timeout_s` to retire; leftovers are cancelled
        (each still receives its terminal event).  Queued requests ride
        through the rebuild.  Returns True when nothing had to be
        cancelled.  The rebuild runs on the engine thread while it is
        PARKED (single writer; a new replica's graph captures run while
        nothing else runs on the card), off the event loop; one resize at
        a time, and the admission gate turns new traffic away
        meanwhile."""
        rebuild = getattr(self.engine, "rebuild", None)
        if rebuild is None:
            raise ValueError(
                "resize_dp requires a DataParallelEngines engine "
                "(single-engine deployments have no replica topology)")
        # validate the device budget and the role spec BEFORE draining:
        # an impossible topology fails up front, not after in-flight
        # requests were cancelled
        self.engine.validate_dp(dp)
        if roles is not _ROLES_KEEP:
            from ..runtime.dp_router import validate_roles_spec

            validate_roles_spec(roles, dp)
        async with self._resize_lock:
            if self._orphan_rebuild is not None:
                # a previous resize was cancelled mid-rebuild and its
                # thread may still be mutating engines: wait it out (its
                # done-callback, added first, resumes the worker)
                try:
                    await asyncio.shield(self._orphan_rebuild)
                except Exception:
                    pass  # logged by the orphan's done-callback
                self._orphan_rebuild = None
            try:
                return await self._resize_locked(
                    rebuild, dp, drain_timeout_s, roles)
            finally:
                # a cancelled resize must never leave the worker parked —
                # except while a cancelled rebuild thread still runs: its
                # done-callback owns the resume then
                if not self._rebuild_owns_resume:
                    self.worker.resume()

    async def _resize_locked(self, rebuild, dp: int, drain_timeout_s: float,
                             roles: Any = _ROLES_KEEP) -> bool:
        def _started(e) -> bool:
            # pending hand-offs are started work too: their pages and
            # emitted first token complete at step cadence
            return bool(e.num_active or e.parked or e._pending
                        or e.handoffs)

        clean = True
        deadline = time.monotonic() + drain_timeout_s
        while True:
            # park first, then look: an unparked worker could seat a
            # waiting request between the check and the rebuild
            if not await asyncio.to_thread(self.worker.pause):
                self.worker.resume()
                raise RuntimeError("engine worker did not pause")
            busy = [e for e in self._replicas() if _started(e)]
            if not busy:
                break
            self.worker.resume()
            if time.monotonic() >= deadline:
                if time.monotonic() >= deadline + drain_timeout_s + 5.0:
                    raise RuntimeError(
                        "resize_dp: started work did not drain")
                # sweep every iteration past the deadline: requests seated
                # after an earlier sweep get cancelled too
                clean = False
                ids = [rid for e in busy
                       for rid, req in _torn_items(e._requests)
                       if req.state != "waiting"]
                if ids:
                    logger.warning("resize_dp: drain timeout; cancelling "
                                   "%d started request(s)", len(ids))
                    for rid in ids:
                        self.worker.cancel(rid)
            await asyncio.sleep(0.02)
        from ..runtime import compile_log

        # rebuild captures and builds are expected, not a storm
        compile_log.set_phase("rebuild")
        # on the parked engine thread: the new replicas' warmup captures
        # their graphs with the handles of the thread that replays them
        fut = asyncio.wrap_future(self.worker.run_parked(
            lambda: (rebuild(dp=dp) if roles is _ROLES_KEEP
                     else rebuild(dp=dp, roles=roles))))
        try:
            await asyncio.shield(fut)
        except asyncio.CancelledError:
            if not fut.done():
                # the rebuild thread still mutates engines: resuming the
                # worker now would race it — hand the resume to its
                # completion, and leave the future for the next resize
                self._rebuild_owns_resume = True
                self._orphan_rebuild = fut

                def _resume(f) -> None:
                    self._rebuild_owns_resume = False
                    self.worker.resume()
                    compile_log.set_phase("first_traffic")
                    exc = None if f.cancelled() else f.exception()
                    if exc is not None:
                        logger.error(
                            "orphaned topology rebuild (resize was "
                            "cancelled mid-flight) FAILED: %s — the "
                            "previous topology may still be serving; "
                            "retry /admin/resize", exc)

                fut.add_done_callback(_resume)
            raise
        finally:
            if not self._rebuild_owns_resume:
                self.worker.resume()
                compile_log.set_phase("first_traffic")
        return clean

    async def aclose(self) -> None:
        self.worker.stop()
