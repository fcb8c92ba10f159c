"""`TorchLLMProvider` — the LLMProvider served by the in-process CUDA engine.

Counterpart of kafka_tpu/llm/tpu_provider.py (single replica).  Requests
go straight into the continuous-batching engine via the dispatch thread
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
* `drain` lets in-flight requests finish on shutdown, then cancels;
* `signals` is the autoscaler's input snapshot (GET /admin/signals) and
  `record_rejection` counts a gate-level 429 in the metrics registry.

Images, data-parallel replicas, the autoscaler and resizing wait for
later slices of the port.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

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
from .worker import EngineWorker

logger = logging.getLogger("kafka_tpu_torch.llm.torch_provider")


def _torn_keys(d) -> list:
    """Snapshot the keys of a dict the engine thread mutates
    concurrently: list() can raise "dictionary changed size" mid-copy, so
    retry; a torn read is fine (a request finishing during the copy needs
    no attention)."""
    for _ in range(8):
        try:
            return list(d)
        except RuntimeError:
            continue
    return []


def _count_images(dicts: List[Dict[str, Any]]) -> int:
    n = 0
    for m in dicts:
        c = m.get("content")
        if isinstance(c, list):
            n += sum(1 for p in c
                     if isinstance(p, dict) and p.get("type") == "image_url")
    return n


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

    def __init__(self, engine: InferenceEngine, tokenizer: BaseTokenizer,
                 model_name: str = "llama",
                 worker: Optional[EngineWorker] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.worker = worker or EngineWorker(engine)
        self.worker.start()
        self._counter = itertools.count()

    @property
    def model_cfg(self) -> ModelConfig:
        return self.engine.cfg

    def count_prompt_tokens(self, messages: Sequence[MessageLike],
                            tools: Optional[List[Dict[str, Any]]] = None
                            ) -> int:
        """Token count of the rendered prompt (compaction pre-flight)."""
        return len(self.tokenizer.encode_chat(to_message_dicts(messages),
                                              tools=tools))

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
        """The engine as a replica list: one engine is its own one-element
        set (data-parallel replicas are not ported)."""
        return [self.engine]

    async def drain_replica(self, replica: int) -> Dict[str, Any]:
        """Flush the engine's warm KV state into the shared object store
        (POST /admin/drain/{replica}): every cached radix run archived
        content-addressed and every thread's sleep manifest written, so
        dormant threads wake on a fresh engine (cache_source=
        "object_tier") instead of re-prefilling.  Non-destructive and
        idempotent.  An index other than 0 raises ValueError."""
        return (await self.drain_replicas([replica]))[0]

    async def drain_replicas(self, indices) -> List[Dict[str, Any]]:
        """drain_replica over several replicas under ONE worker pause.
        The flush gathers pool pages and walks the radix tree — both
        single-writer engine state — so it runs with the worker parked,
        off the event loop."""
        indices = list(indices)
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
            all_stats = await asyncio.get_running_loop().run_in_executor(
                None, lambda: [s() for s in sleeps])
        finally:
            self.worker.resume()
        for i, stats in zip(indices, all_stats):
            stats["replica"] = i
        return all_stats

    def admission_check(self) -> Optional[float]:
        """None = admit; else a Retry-After estimate in seconds.  Reads the
        engine thread's queue length unsynchronized — a torn read makes
        the gate one step stale, and the engine's max_waiting bound is the
        authoritative backstop."""
        limit = self.engine.ecfg.max_waiting
        if limit <= 0 or len(self.engine.waiting) < limit:
            return None
        return self.engine.retry_after_estimate()

    def record_rejection(self) -> None:
        """Count a gate-level HTTP 429 in requests.rejected (the engine
        backstop counts its own).  A rejection is also an SLO miss, and a
        flight-recorder "reject" cause drained into the next ring record.
        Cross-thread int increments: GIL-atomic enough for counters."""
        self.engine.metrics.record_rejected()
        if self.engine.flight is not None:
            self.engine.flight.note_gate_reject()

    def signals(self) -> Dict[str, Any]:
        """One coherent autoscaler-input snapshot (GET /admin/signals),
        the reference's contract (kafka_tpu/llm/tpu_provider.py signals,
        version 9) with the same keys: queue depth, peak and 60s trend;
        decode-slot occupancy; windowed SLO attainment and goodput;
        per-kind MFU / bandwidth utilization and model skew; per-replica
        load, pages and anomalies (one replica: the engine); the flight
        recorder's active anomalies; the compile observatory's summary
        and storm flag; the memory monitor's measured headroom and plan
        skew; the agent section.  Sections of subsystems this package
        does not have yet (object tier, disaggregation, autoscaler,
        replica supervisor) read null, as in a reference deployment
        without them.  Read torn-tolerantly from the engine thread's
        single-writer metrics."""
        from ..runtime import compile_log

        engine = self.engine
        # reset_peak=False: the signal poll must not consume the
        # /metrics scraper's peak-since-last-snapshot window
        snap = engine.metrics.snapshot(engine, reset_peak=False)
        util = snap.get("utilization") or {}
        occupancy = snap.get("decode", {}).get("batch_occupancy", 0.0)
        max_batch = engine.ecfg.max_batch
        kinds = ("prefill", "decode", "verify")
        replica = {
            "replica": 0,
            "state": "healthy",
            "active": engine.num_active,
            "waiting": len(engine.waiting),
            "parked": len(engine.parked),
            "pages_free": engine.pool.free_pages,
            "pages_total": engine.pool.num_pages,
            "batch_occupancy": occupancy,
            "anomalies_active": (snap.get("anomalies") or {}).get(
                "anomalies_active", 0),
            "utilization": {
                kind: {k: util.get(kind, {}).get(k, 0.0)
                       for k in ("mfu", "mfu_1m", "hbm_bw_util",
                                 "hbm_bw_util_1m", "model_skew")}
                for kind in kinds
            },
        }
        anomalies = dict(snap.get("anomalies") or {})
        if anomalies.get("active"):
            anomalies["active"] = [{**a, "replica": a.get("replica", 0)}
                                   for a in anomalies["active"]]
        pools = [{
            "role": "colocated",
            "replicas": [0],
            "queue_depth": len(engine.waiting),
            "active": engine.num_active,
            "parked": len(engine.parked),
            "batch_occupancy": occupancy,
            "utilization": {
                kind: {k: util.get(kind, {}).get(k, 0.0)
                       for k in ("mfu", "mfu_1m", "hbm_bw_util",
                                 "hbm_bw_util_1m")}
                for kind in kinds
            },
        }]
        slo_src = snap.get("slo") or {}
        slo_out = {k: v for k, v in slo_src.items()
                   if not k.startswith("window_")}
        w1 = slo_src.get("window_1m") or {}
        slo_out["window_1m_requests"] = int(
            (w1.get("met") or 0) + (w1.get("missed") or 0))
        obs = compile_log.get()
        memory_section = None
        mm = engine.memory_monitor
        sec = mm.section() if mm is not None else None
        if sec and sec.get("source") != "none":
            memory_section = {
                "headroom_bytes": sec["hbm_headroom_bytes"],
                "plan_skew": sec["hbm_plan_skew"],
                "pressure": sec["hbm_pressure"],
                "replicas": [{"replica": 0, **{k: sec[k] for k in (
                    "source", "hbm_bytes_in_use", "hbm_bytes_limit",
                    "hbm_headroom_bytes", "hbm_plan_skew",
                    "hbm_pressure")}}],
            }
        ag = snap.get("agent") or {}
        agent_section = {
            out_key: ag.get(key, 0) for out_key, key in (
                ("awaiting_threads", "agent_awaiting_threads"),
                ("awaiting_bytes", "agent_awaiting_bytes"),
                ("gaps", "agent_gaps"),
                ("gap_demotions", "agent_gap_demotions"),
                ("gap_pages_demoted", "agent_gap_pages_demoted"),
                ("gap_bytes_demoted", "agent_gap_bytes_demoted"),
                ("gap_cancelled", "agent_gap_cancelled"),
                ("hint_hits", "agent_hint_hits"),
                ("hint_misses", "agent_hint_misses"),
                ("bg_queue_depth", "bg_queue_depth"),
                ("bg_admitted", "bg_admitted"),
                ("bg_chunks", "bg_chunks"),
                ("bg_yields", "bg_yields"))
        }
        return {
            "version": 9,
            "dp": 1,
            "queue": dict(snap.get("queue") or {}),
            "anomalies": anomalies,
            "agent": agent_section,
            "compiles": obs.signals_section() if obs is not None else None,
            "memory": memory_section,
            "pools": pools,
            "object_tier": None,
            "disagg": None,
            "autoscaler": None,
            "batch": {
                "occupancy": occupancy,
                "occupancy_frac": round(occupancy / max_batch, 4)
                if max_batch else 0.0,
                "active": engine.num_active,
                "max_batch": max_batch,
                "slots_total": max_batch,
            },
            "slo": slo_out,
            "utilization": snap.get("utilization") or {},
            "replicas": [replica],
            "supervisor": None,
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
        **kwargs: Any,
    ) -> AsyncIterator[StreamChunk]:
        self.validate_messages(messages)
        dicts = to_message_dicts(messages)
        n_images = _count_images(dicts)
        if n_images:
            raise UnsupportedContentError(n_images,
                                          provider=self.provider_name)
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
        server has stopped admitting; reads only the engine's own host
        state (has_work, the request table), never the device."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.engine.has_work:
                return True
            await asyncio.sleep(0.05)
        leftover = _torn_keys(self.engine._requests)
        if leftover:
            logger.warning("drain timeout after %.1fs: cancelling %d "
                           "in-flight request(s)", timeout_s, len(leftover))
            for rid in leftover:
                self.worker.cancel(rid)
            # let the engine thread process the cancels so every stream
            # sees its terminal event before teardown
            settle = time.monotonic() + min(2.0, timeout_s)
            while time.monotonic() < settle and self.engine.has_work:
                await asyncio.sleep(0.02)
        return not leftover

    async def aclose(self) -> None:
        self.worker.stop()
