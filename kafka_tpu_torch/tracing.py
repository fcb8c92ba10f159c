"""End-to-end request tracing: a span tree per request, across processes.

(A jax-free copy of kafka_tpu/tracing.py, whole, with the port's
KAFKA_TORCH_* environment names; the agent loop opens `agent.turn` and
`compaction` spans and the tool provider `tool.exec`.)

Counters and cross-process fault injection cannot answer one question;
this module does: *where did THIS request spend its time* once it fans
out across the engine thread, the agent tool loop, a sandbox subprocess,
and a DP replica.

Design, mirroring the two disciplines this repo already trusts:

* **EngineMetrics' single-writer/torn-tolerant store.**  Traces live in a
  bounded in-memory ring (`_traces`, an OrderedDict capped at
  ``KAFKA_TORCH_TRACE_RING`` entries).  Span recording is a plain
  ``list.append`` (GIL-atomic) onto the owning trace — no lock on any hot
  path; readers (`/debug/trace`, the slow-request log) take torn-tolerant
  snapshots (retry-on-RuntimeError, same policy as runtime/metrics.py).
* **failpoints' cross-process seam.**  The trace context serializes into
  the sandbox wire protocol (``POST /run`` carries ``{"trace": {...}}``)
  and the subprocess environment (:func:`subprocess_env`), so a
  ``tool.exec`` span's children are *recorded inside the sandbox process*
  (:class:`ChildSpans`), shipped back as a ``{"kind": "spans"}`` SSE frame,
  and stitched into the parent's trace by trace ID (:func:`stitch`).

**Hot-path contract** (acceptance-tested): an untraced request costs ONE
branch per would-be span (``ctx is None``); a traced request costs that
branch plus one ring append.  The sampling knob ``KAFKA_TORCH_TRACE_SAMPLE``
(default 1.0 — sampling-*down* is the thing that's disabled by default)
decides per request at ingress; everything downstream keys off the
request's carried context, never off a global.

**Span registry.**  Like failpoints' SITES, every span name emitted in
code must appear in :data:`SPANS` (and every trace-level event name in
:data:`EVENTS`) — enforced both directions by a static check in
tests/test_tracing.py, so the trace schema cannot silently drift.

Timestamps are wall-clock (``time.time()``), the only base comparable
across PID boundaries; durations measured monotonically by callers are
converted at record time (``record_span(dur_s=...)``).

Export is Chrome trace-event JSON (``GET /debug/trace/{request_id}``),
loadable in Perfetto / chrome://tracing; ``GET /debug/traces`` serves a
recent-traces index.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import logging
import os
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

logger = logging.getLogger("kafka_tpu_torch.tracing")

ENV_SAMPLE = "KAFKA_TORCH_TRACE_SAMPLE"
ENV_RING = "KAFKA_TORCH_TRACE_RING"
ENV_SPAN_CAP = "KAFKA_TORCH_TRACE_SPAN_CAP"
ENV_SLOW_TTFT = "KAFKA_TORCH_SLOW_TTFT_MS"
ENV_SLOW_TOTAL = "KAFKA_TORCH_SLOW_TOTAL_MS"
ENV_PROFILING = "KAFKA_TORCH_PROFILING"
# Span-ring persistence: finished
# traces are also written as JSON files under this directory, so the ring
# survives process restarts alongside the disk KV tier.  Unset, it
# defaults to <KAFKA_TORCH_KV_DISK_TIER_DIR>/traces when the disk tier is
# configured — the span ring persists "alongside the disk tier" with no
# extra knob.  Explicit "" disables persistence even with a disk tier.
ENV_PERSIST = "KAFKA_TORCH_TRACE_PERSIST_DIR"
# the disk/object tier envs are read by name (kv_tier.py/object_tier.py
# own them; importing the runtime tier here would defeat this module's
# import-light contract).  With an OBJECT store configured the ring
# persists under it by preference — thread state that outlives the host
# should carry its trace history along.
_ENV_DISK_TIER = "KAFKA_TORCH_KV_DISK_TIER_DIR"
_ENV_OBJECT_DIR = "KAFKA_TORCH_KV_OBJECT_DIR"

# The DOCUMENTED SPAN REGISTRY: every span name emitted anywhere in
# kafka_tpu/ (tracing.span("..."), record_span(ctx, "..."),
# ChildSpans.span("..."), start_trace(name="...")) must appear here and
# vice versa — static check in tests/test_tracing.py, same contract as
# failpoints.SITES.
SPANS = (
    "http.request",   # root: HTTP ingress to response complete (server/app)
    "agent.turn",     # one LLM completion of the agent loop (agents/base)
    "tool.exec",      # one tool call, client side (tools/provider)
    "compaction",     # context-compaction retry (agents/base)
    "engine.queue",   # submit -> first prefill chunk dispatch (engine)
    "engine.prefill", # prefill chunks -> first token sampled (engine)
    "engine.decode",  # one decode dispatch burst; attrs: steps, busy — and
                      # on speculative verify dispatches proposed/accepted
                      # (candidate tokens offered / kept that round) (engine)
    "emit",           # first dispatch -> first token on host (engine)
    "sandbox.exec",   # tool execution INSIDE the sandbox subprocess
    "kv.demote",      # page run copied device->host under pressure; attrs:
                      # pages, bytes, overlap (runtime/kv_tier.py)
    "kv.promote",     # page run re-materialized host->device ahead of the
                      # suffix prefill; attrs: pages, bytes, source, overlap
    "kv.object_put",  # run archived into the shared object store; attrs:
                      # pages, bytes (runtime/object_tier.py)
    "kv.object_get",  # run fetched from the shared object store during a
                      # thread wake; attrs: pages, bytes, source
    "kv.prefetch",    # one run prefetched ahead of admission (wake
                      # prefetch); attrs: bytes, thread, hit
                      # (runtime/object_tier.WakePrefetcher)
    "thread.wake",    # dormant thread re-materialized from its sleep
                      # manifest; attrs: tokens, runs, bytes, source
                      # (runtime/prefix_cache.py)
)

# Trace-level instant events (supervisor actions that punctuate a request's
# timeline rather than span it).  Same both-directions static check.
EVENTS = (
    "preempt",         # engine rolled the request back to the queue
    "migrate",         # dp_router moved the queued request off a sick replica
    "quarantine",      # the request's replica was circuit-broken mid-flight
    "engine.recover",  # engine failure terminated the request
    "anomaly",         # a flight-recorder detector fired on the request's
                       # engine (attrs: kind, detail — flight_recorder.py)
    "resume",          # re-prefill admission after preemption or a
                       # disaggregated hand-off; attrs: tokens plus the
                       # radix share (cached_tokens / cache_source —
                       # "shipped" proves zero-re-prefill) (engine)
    "handoff",         # dp_router shipped the thread's prefilled pages to
                       # a decode replica; attrs: from_replica, to_replica,
                       # shipped_pages, shipped_bytes, shipped (bool)
)


class TraceContext(NamedTuple):
    """What crosses a boundary: enough to parent new spans."""

    trace_id: str
    span_id: str


@dataclasses.dataclass
class Span:
    """One recorded span.  `t1 is None` = still open (export flags it)."""

    name: str
    span_id: str
    parent_id: Optional[str]
    t0: float                       # wall-clock seconds
    t1: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    thread: str = ""
    pid: int = 0

    def to_wire(self) -> Dict[str, Any]:
        return {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "t0": self.t0, "t1": self.t1,
            "attrs": self.attrs, "thread": self.thread, "pid": self.pid,
        }


@dataclasses.dataclass
class Trace:
    """One request's span tree + instant events."""

    trace_id: str
    request_id: str
    t0: float
    spans: List[Span] = dataclasses.field(default_factory=list)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    root_id: str = ""
    done: bool = False
    # spans refused by the per-trace cap (_span_cap): long generations
    # must not grow a trace without bound
    dropped_spans: int = 0
    _ids: Iterator[int] = dataclasses.field(
        default_factory=lambda: itertools.count(1)
    )

    def next_span_id(self) -> str:
        # per-trace counter: unique within the trace, no uuid on hot paths
        return f"{self.trace_id[:8]}.{next(self._ids)}"


# ---------------------------------------------------------------------------
# module state (the ring store + config)
# ---------------------------------------------------------------------------

_lock = threading.Lock()  # guards ring insertion/eviction only (cold path)
_traces: "OrderedDict[str, Trace]" = OrderedDict()
_by_request: Dict[str, str] = {}  # request_id -> trace_id alias

_sample = 1.0
_capacity = 256
# Per-trace span bound: a 16k-token generation records thousands of
# engine.decode bursts; past the cap further spans drop (counted in the
# trace's dropped_spans) so a long stream cannot grow memory unboundedly.
_span_cap = 2048
_slow_ttft_ms: Optional[float] = None
_slow_total_ms: Optional[float] = None
_profiling = False
_persist_dir: Optional[str] = None
_counters: Dict[str, int] = {
    "slow": 0, "traces": 0, "stitched_spans": 0, "persisted": 0,
}

_ctx: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("kafka_tpu_trace_ctx", default=None)
)


def configure(
    sample: Optional[float] = None,
    ring: Optional[int] = None,
    slow_ttft_ms: Optional[float] = None,
    slow_total_ms: Optional[float] = None,
    profiling: Optional[bool] = None,
    span_cap: Optional[int] = None,
    persist_dir: Optional[str] = None,
) -> None:
    """Programmatic config (server boot / tests).  None = leave as is;
    for the slow thresholds, 0 disables (matching the env contract); for
    persist_dir, "" disables persistence."""
    global _sample, _capacity, _slow_ttft_ms, _slow_total_ms, _profiling
    global _span_cap, _persist_dir
    if persist_dir is not None:
        _persist_dir = persist_dir or None
        if _persist_dir:
            try:
                os.makedirs(_persist_dir, exist_ok=True)
            except OSError as e:
                logger.warning(
                    "trace persistence disabled (cannot create %s: %s)",
                    _persist_dir, e,
                )
                _persist_dir = None
    if sample is not None:
        _sample = max(0.0, min(1.0, float(sample)))
    if ring is not None:
        _capacity = max(1, int(ring))
    if span_cap is not None:
        _span_cap = max(1, int(span_cap))
    if slow_ttft_ms is not None:
        _slow_ttft_ms = float(slow_ttft_ms) or None
    if slow_total_ms is not None:
        _slow_total_ms = float(slow_total_ms) or None
    if profiling is not None:
        _profiling = bool(profiling)


def load_env() -> None:
    """Read the env knobs (import time + server startup, like failpoints)."""
    env = os.environ
    if ENV_PERSIST in env:
        persist = env[ENV_PERSIST]  # explicit, "" = off
    elif env.get(_ENV_OBJECT_DIR):
        # persist the ring alongside the OBJECT KV tier by preference:
        # portable thread state carries its trace history across hosts
        persist = os.path.join(env[_ENV_OBJECT_DIR], "traces")
    elif env.get(_ENV_DISK_TIER):
        # persist the ring alongside the disk KV tier by default
        persist = os.path.join(env[_ENV_DISK_TIER], "traces")
    else:
        persist = ""
    configure(
        sample=float(env.get(ENV_SAMPLE, "1.0")),
        ring=int(env.get(ENV_RING, "256")),
        span_cap=int(env.get(ENV_SPAN_CAP, "2048")),
        slow_ttft_ms=float(env.get(ENV_SLOW_TTFT, "0") or 0),
        slow_total_ms=float(env.get(ENV_SLOW_TOTAL, "0") or 0),
        profiling=env.get(ENV_PROFILING, "0") in ("1", "true"),
        persist_dir=persist,
    )


def sample_rate() -> float:
    return _sample


def profiler_annotations_enabled() -> bool:
    """Should the engine wrap device dispatches in jax.profiler named
    scopes keyed by trace id?  Costs one module-global bool read."""
    return _profiling


def reset() -> None:
    """Test hygiene: clear the store and counters, reload env config."""
    with _lock:
        _traces.clear()
        _by_request.clear()
    for k in _counters:
        _counters[k] = 0
    load_env()


def counters() -> Dict[str, int]:
    return dict(_counters)


def persist_dir() -> Optional[str]:
    """The configured trace-persistence directory (None = persistence
    off).  The flight recorder's postmortem dumps land alongside the
    persisted trace rings by default (runtime/flight_recorder.py)."""
    return _persist_dir


def slow_count() -> int:
    return _counters["slow"]


def subprocess_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for a child process inheriting the tracing/log config
    (sandbox subprocesses — the same seam failpoints.subprocess_env uses).
    The live values are serialized, not just whatever the parent's env
    happens to hold: programmatic configure() must reach children too."""
    env = dict(os.environ if base is None else base)
    env[ENV_SAMPLE] = repr(_sample)
    if _profiling:
        env[ENV_PROFILING] = "1"
    # KAFKA_TORCH_LOG_FORMAT rides along untouched (env-only knob): children
    # of a json-logging parent log json (logs.setup_logging reads it)
    return env


# ---------------------------------------------------------------------------
# trace lifecycle
# ---------------------------------------------------------------------------


def _register(trace: Trace) -> None:
    with _lock:
        _traces[trace.trace_id] = trace
        _by_request[trace.request_id] = trace.trace_id
        while len(_traces) > _capacity:
            _, evicted = _traces.popitem(last=False)
            _by_request.pop(evicted.request_id, None)
    _counters["traces"] += 1


def new_trace_id() -> str:
    return uuid.uuid4().hex


def start_trace(
    request_id: Optional[str] = None,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    name: str = "http.request",
    attrs: Optional[Dict[str, Any]] = None,
) -> Optional[Span]:
    """Mint (or adopt) a trace and open its root span; sets the context.

    Returns None when the request is sampled out (``KAFKA_TORCH_TRACE_SAMPLE``
    < 1) — an adopted trace id (incoming ``X-Request-Id``/``traceparent``)
    bypasses probabilistic sampling (the caller asked for this request by
    name), but NOT the hard off switch: at sample 0 nothing is traced, so
    a proxy that stamps X-Request-Id on every request cannot re-enable
    tracing a deployment turned off.
    """
    if _sample <= 0.0:
        return None
    if trace_id is None:
        if _sample < 1.0 and random.random() >= _sample:
            return None
        trace_id = new_trace_id()
    trace = Trace(
        trace_id=trace_id,
        request_id=request_id or trace_id,
        t0=time.time(),
    )
    root = Span(
        name=name,
        span_id=trace.next_span_id(),
        parent_id=parent_id,
        t0=trace.t0,
        attrs=dict(attrs or {}),
        thread=threading.current_thread().name,
        pid=os.getpid(),
    )
    trace.root_id = root.span_id
    trace.spans.append(root)
    _register(trace)
    _ctx.set(TraceContext(trace_id, root.span_id))
    return root


def finish_trace(root: Optional[Span], status: Any = None) -> None:
    """Close the root span, mark the trace done, and run the slow-request
    check (one structured log line + the ``requests.slow`` counter when a
    configured TTFT/total threshold is exceeded)."""
    if root is None:
        return
    root.t1 = time.time()
    if status is not None:
        root.attrs["status"] = status
    ctx = _ctx.get()
    trace = _traces.get(ctx.trace_id) if ctx is not None else None
    if trace is None or trace.root_id != root.span_id:
        # context already gone (or belongs to a nested span): resolve by
        # scanning the small ring — cold path, once per request
        trace = next(
            (tr for tr in list(_traces.values())
             if tr.root_id == root.span_id and root in tr.spans),
            None,
        )
    if trace is None:
        return  # evicted under pressure, or finish after reset()
    if ctx is not None:
        _ctx.set(None)
    trace.done = True
    if _persist_dir is not None:
        _persist(trace)
    _check_slow(trace, root)


def _check_slow(trace: Trace, root: Span) -> None:
    total_ms = (root.t1 - root.t0) * 1e3
    ttft_ms: Optional[float] = None
    for s in list(trace.spans):
        # the engine's `emit` span ends when the first token reaches the
        # host — its end relative to ingress is the request's true TTFT
        if s.name == "emit" and s.t1 is not None:
            t = (s.t1 - root.t0) * 1e3
            ttft_ms = t if ttft_ms is None else min(ttft_ms, t)
    slow = (
        _slow_total_ms is not None and total_ms > _slow_total_ms
    ) or (
        _slow_ttft_ms is not None
        and ttft_ms is not None
        and ttft_ms > _slow_ttft_ms
    )
    if not slow:
        return
    _counters["slow"] += 1
    logger.warning(
        "slow request %s: total=%.1fms ttft=%s slo_met=%s (thresholds: "
        "ttft=%s total=%s)",
        trace.request_id, total_ms,
        f"{ttft_ms:.1f}ms" if ttft_ms is not None else "n/a",
        # the engine's SLO verdict (annotate() stamped it on the root at
        # finalize) — a slow-log line is actionable only if it
        # says whether the request also MISSED its SLO or merely tripped
        # the softer slow threshold
        root.attrs.get("slo_met"),
        _slow_ttft_ms, _slow_total_ms,
        extra={
            "trace_id": trace.trace_id,
            "span_id": root.span_id,
            "slow_request": True,
            "total_ms": round(total_ms, 1),
            "ttft_ms": round(ttft_ms, 1) if ttft_ms is not None else None,
            "slo_met": root.attrs.get("slo_met"),
            "spans": span_breakdown(trace),
        },
    )


def span_breakdown(trace: Trace) -> List[Dict[str, Any]]:
    """The full span timeline as plain dicts (slow-request log payload)."""
    out = []
    for s in list(trace.spans):
        out.append({
            "name": s.name,
            "start_ms": round((s.t0 - trace.t0) * 1e3, 2),
            "dur_ms": round(((s.t1 or time.time()) - s.t0) * 1e3, 2),
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            **({"attrs": s.attrs} if s.attrs else {}),
        })
    return out


# ---------------------------------------------------------------------------
# in-context spans (asyncio serving path)
# ---------------------------------------------------------------------------


def _has_room(trace: Trace) -> bool:
    """Per-trace span cap: refuse (and count) appends past _span_cap."""
    if len(trace.spans) >= _span_cap:
        trace.dropped_spans += 1
        return False
    return True


def current() -> Optional[TraceContext]:
    """The ambient trace context (None = this request is untraced)."""
    return _ctx.get()


@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Open a child span of the ambient context for the with-block.

    No-op (yields None) when untraced.  Nesting works through contextvars,
    so spans opened inside the block parent correctly.
    """
    ctx = _ctx.get()
    if ctx is None:
        yield None
        return
    trace = _traces.get(ctx.trace_id)
    if trace is None or not _has_room(trace):
        yield None
        return
    s = Span(
        name=name,
        span_id=trace.next_span_id(),
        parent_id=ctx.span_id,
        t0=time.time(),
        attrs=dict(attrs or {}),
        thread=threading.current_thread().name,
        pid=os.getpid(),
    )
    trace.spans.append(s)
    token = _ctx.set(TraceContext(ctx.trace_id, s.span_id))
    try:
        yield s
    finally:
        s.t1 = time.time()
        _ctx.reset(token)


# ---------------------------------------------------------------------------
# engine hot path (explicit-context, single branch + append)
# ---------------------------------------------------------------------------


def record_span(
    ctx: Optional[TraceContext],
    name: str,
    dur_s: float,
    attrs: Optional[Dict[str, Any]] = None,
    end: Optional[float] = None,
) -> None:
    """Append one CLOSED span to `ctx`'s trace.  The engine thread's API:
    callers measure duration monotonically and record at completion, so
    the only cost on the scheduler thread is this call — a None check for
    untraced requests, one list append for traced ones."""
    if ctx is None:
        return
    trace = _traces.get(ctx.trace_id)
    if trace is None or not _has_room(trace):
        return  # evicted mid-request, or span cap reached: drop (counted)
    t1 = end if end is not None else time.time()
    trace.spans.append(Span(
        name=name,
        span_id=trace.next_span_id(),
        parent_id=ctx.span_id,
        t0=t1 - max(0.0, dur_s),
        t1=t1,
        attrs=attrs or {},
        thread=threading.current_thread().name,
        pid=os.getpid(),
    ))


def annotate(
    ctx: Optional[TraceContext],
    attrs: Dict[str, Any],
) -> None:
    """Merge attrs onto the trace's ROOT span (http.request).

    The engine stamps each request's SLO verdict here at finalize:
    slo_met / ttft_ms / tpot_ms show on the request's root
    span in /debug/trace and ride the slow-request log's breakdown.
    Same cost contract as record_span — None check untraced, one dict
    update traced.  Races with finish_trace are benign (dict update)."""
    if ctx is None:
        return
    trace = _traces.get(ctx.trace_id)
    if trace is None or trace.root_id is None:
        return
    for s in list(trace.spans):
        if s.span_id == trace.root_id:
            s.attrs.update(attrs)
            return


def add_event(
    ctx: Optional[TraceContext],
    name: str,
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Append one instant event (supervisor actions: preempt/migrate/
    quarantine/...) to `ctx`'s trace.  Same cost contract as record_span."""
    if ctx is None:
        return
    trace = _traces.get(ctx.trace_id)
    if trace is None:
        return
    trace.events.append({
        "name": name,
        "t": time.time(),
        "attrs": attrs or {},
        "span_id": ctx.span_id,
    })


# ---------------------------------------------------------------------------
# cross-process: child-side collection + parent-side stitching
# ---------------------------------------------------------------------------


def wire_context() -> Optional[Dict[str, str]]:
    """The ambient context as a wire dict for the sandbox /run payload."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_span_id": ctx.span_id}


class ChildSpans:
    """Span collector for a process that does NOT own the trace store
    (the sandbox subprocess).  Spans are recorded locally and exported as
    wire dicts; the parent stitches them by trace ID (:func:`stitch`).
    Single-task usage per collector (one /run call each)."""

    def __init__(self, trace_id: str, parent_span_id: Optional[str]):
        self.trace_id = trace_id
        self.spans: List[Span] = []
        self._stack: List[Optional[str]] = [parent_span_id]
        self._ids = itertools.count(1)

    @contextlib.contextmanager
    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        s = Span(
            name=name,
            span_id=f"{self.trace_id[:8]}.c{os.getpid()}.{next(self._ids)}",
            parent_id=self._stack[-1],
            t0=time.time(),
            attrs=dict(attrs or {}),
            thread=threading.current_thread().name,
            pid=os.getpid(),
        )
        self.spans.append(s)
        self._stack.append(s.span_id)
        try:
            yield s
        finally:
            s.t1 = time.time()
            self._stack.pop()

    def export(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "spans": [s.to_wire() for s in self.spans],
        }


def child_collector(wire: Optional[Dict[str, Any]]) -> Optional[ChildSpans]:
    """Build a collector from a /run payload's ``trace`` field (or None
    when the request is untraced — the child then records nothing)."""
    if not wire or not wire.get("trace_id"):
        return None
    return ChildSpans(str(wire["trace_id"]), wire.get("parent_span_id"))


def stitch(payload: Dict[str, Any]) -> int:
    """Merge a child process's exported spans into the parent's trace
    (matched by trace ID).  Returns how many spans landed; spans for a
    trace the ring no longer holds are dropped (torn-tolerant, like every
    other read path)."""
    trace = _traces.get(str(payload.get("trace_id", "")))
    if trace is None:
        return 0
    n = 0
    for w in payload.get("spans", []):
        if not _has_room(trace):
            break
        try:
            trace.spans.append(Span(
                name=str(w["name"]),
                span_id=str(w["span_id"]),
                parent_id=w.get("parent_id"),
                t0=float(w["t0"]),
                t1=float(w["t1"]) if w.get("t1") is not None else None,
                attrs=dict(w.get("attrs") or {}),
                thread=str(w.get("thread", "")),
                pid=int(w.get("pid", 0)),
            ))
            n += 1
        except (KeyError, TypeError, ValueError):
            logger.warning("dropping malformed stitched span: %r", w)
    _counters["stitched_spans"] += n
    return n


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def get_trace(id_or_request_id: str) -> Optional[Trace]:
    trace = _traces.get(id_or_request_id)
    if trace is None:
        tid = _by_request.get(id_or_request_id)
        trace = _traces.get(tid) if tid else None
    if trace is None and _persist_dir is not None:
        trace = _load_persisted(id_or_request_id)
    return trace


# ---------------------------------------------------------------------------
# ring persistence (alongside the disk KV tier)
# ---------------------------------------------------------------------------

# files kept on disk: a few rings' worth, pruned oldest-first at write time
_PERSIST_KEEP_FACTOR = 4
# prune cadence: listdir + stat + sort over the whole directory is ~1k
# syscalls once full — amortize it instead of paying it per finished trace
_PRUNE_EVERY = 64


def sanitize_stem(raw: str) -> str:
    """Filesystem-safe file-name stem: a sanitized prefix for human
    ls-ability plus a digest of the full string for uniqueness.  THE
    path-traversal defense for every artifact named from untrusted
    content — persisted traces (ids adopted verbatim from X-Request-Id)
    and flight-recorder postmortems both derive names through this one
    helper, so a hardening change cannot drift between them."""
    import hashlib

    safe = "".join(
        c if c.isalnum() or c in "._-" else "_" for c in raw[:48]
    )
    digest = hashlib.sha1(raw.encode()).hexdigest()[:12]
    return f"{safe}.{digest}"


def _persist_name(trace_id: str) -> str:
    """Persisted-trace file name (see sanitize_stem: trace ids can be
    ADOPTED VERBATIM from a client's X-Request-Id header, so the id must
    never be used as a path — '../..' would write, and let /debug/trace
    read, outside the persist dir).  Computed identically on write and
    lookup."""
    return f"{sanitize_stem(trace_id)}.trace.json"


def _persist(trace: Trace) -> None:
    """Write one finished trace as JSON (best-effort, never raises into
    the serving path).  Files are named by a sanitized trace id; the
    request id lives in the payload for the fallback scan."""
    assert _persist_dir is not None
    payload = {
        "trace_id": trace.trace_id,
        "request_id": trace.request_id,
        "t0": trace.t0,
        "root_id": trace.root_id,
        "done": trace.done,
        "dropped_spans": trace.dropped_spans,
        "spans": [s.to_wire() for s in list(trace.spans)],
        "events": list(trace.events),
    }
    path = os.path.join(_persist_dir, _persist_name(trace.trace_id))
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        _counters["persisted"] += 1
        if _counters["persisted"] % _PRUNE_EVERY == 0:
            _prune_persisted()
    except OSError as e:
        logger.warning("trace persistence failed for %s: %s",
                       trace.trace_id, e)


def _prune_persisted() -> None:
    """Bound the persisted set to a few rings' worth (oldest dropped)."""
    assert _persist_dir is not None
    try:
        names = [n for n in os.listdir(_persist_dir)
                 if n.endswith(".trace.json")]
        keep = _capacity * _PERSIST_KEEP_FACTOR
        if len(names) <= keep:
            return
        paths = [os.path.join(_persist_dir, n) for n in names]
        paths.sort(key=lambda p: os.path.getmtime(p))
        for p in paths[: len(paths) - keep]:
            os.unlink(p)
    except OSError:
        pass


def _trace_from_payload(payload: Dict[str, Any]) -> Trace:
    trace = Trace(
        trace_id=str(payload["trace_id"]),
        request_id=str(payload.get("request_id", payload["trace_id"])),
        t0=float(payload.get("t0", 0.0)),
    )
    trace.root_id = str(payload.get("root_id", ""))
    trace.done = bool(payload.get("done", True))
    trace.dropped_spans = int(payload.get("dropped_spans", 0))
    for w in payload.get("spans", []):
        trace.spans.append(Span(
            name=str(w["name"]),
            span_id=str(w["span_id"]),
            parent_id=w.get("parent_id"),
            t0=float(w["t0"]),
            t1=float(w["t1"]) if w.get("t1") is not None else None,
            attrs=dict(w.get("attrs") or {}),
            thread=str(w.get("thread", "")),
            pid=int(w.get("pid", 0)),
        ))
    trace.events = list(payload.get("events", []))
    return trace


def _load_persisted(id_or_request_id: str) -> Optional[Trace]:
    """Disk fallback for a trace the ring evicted (or a prior process
    recorded).  Direct hit by the sanitized trace-id file name (the same
    derivation _persist used, so a hostile id cannot traverse out of the
    dir); otherwise a bounded newest-first scan matching request_id —
    cold path, debug endpoint."""
    assert _persist_dir is not None
    direct = os.path.join(_persist_dir, _persist_name(id_or_request_id))
    try:
        if os.path.exists(direct):
            with open(direct) as f:
                return _trace_from_payload(json.load(f))
        names = [n for n in os.listdir(_persist_dir)
                 if n.endswith(".trace.json")]
        paths = [os.path.join(_persist_dir, n) for n in names]
        paths.sort(key=lambda p: os.path.getmtime(p), reverse=True)
        for p in paths[:512]:
            try:
                with open(p) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue
            if payload.get("request_id") == id_or_request_id:
                return _trace_from_payload(payload)
    except OSError:
        return None
    return None


def recent_traces() -> List[Dict[str, Any]]:
    """Index of the ring, newest first (GET /debug/traces)."""
    with _lock:
        items = list(_traces.values())
    out = []
    for tr in reversed(items):
        spans = list(tr.spans)
        root = next((s for s in spans if s.span_id == tr.root_id), None)
        end = root.t1 if root is not None and root.t1 is not None else None
        out.append({
            "trace_id": tr.trace_id,
            "request_id": tr.request_id,
            "start": tr.t0,
            "duration_ms": round((end - tr.t0) * 1e3, 2) if end else None,
            "spans": len(spans),
            "dropped_spans": tr.dropped_spans,
            "events": len(tr.events),
            "done": tr.done,
            "names": sorted({s.name for s in spans}),
        })
    return out


def chrome_trace(id_or_request_id: str) -> Optional[Dict[str, Any]]:
    """Chrome trace-event JSON for one trace (Perfetto-loadable).

    Spans render as complete ("X") events; trace-level events as instants
    ("i").  Lanes: pid = recording process, tid = a stable small int per
    (pid, thread) pair, named via metadata ("M") records so Perfetto shows
    'engine'/'aiohttp'/'sandbox' rows instead of raw ids.
    """
    trace = get_trace(id_or_request_id)
    if trace is None:
        return None
    spans = list(trace.spans)  # torn-tolerant snapshot
    events: List[Dict[str, Any]] = []
    lanes: Dict[tuple, int] = {}
    own_pid = os.getpid()

    def lane(pid: int, thread: str) -> int:
        key = (pid, thread)
        if key not in lanes:
            lanes[key] = len(lanes) + 1
        return lanes[key]

    now = time.time()
    for s in spans:
        pid = s.pid or own_pid
        t1 = s.t1 if s.t1 is not None else now
        args = {"span_id": s.span_id, "parent_id": s.parent_id, **s.attrs}
        if s.t1 is None:
            args["unfinished"] = True
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": "kafka_tpu_torch",
            "ts": round(s.t0 * 1e6, 1),
            "dur": round(max(0.0, t1 - s.t0) * 1e6, 1),
            "pid": pid,
            "tid": lane(pid, s.thread),
            "args": args,
        })
    for ev in list(trace.events):
        events.append({
            "ph": "i",
            "name": ev["name"],
            "cat": "kafka_tpu_torch",
            "ts": round(ev["t"] * 1e6, 1),
            "pid": own_pid,
            "tid": 0,
            "s": "p",
            "args": ev.get("attrs", {}),
        })
    for (pid, thread), tid in lanes.items():
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": thread or f"pid-{pid}"},
        })
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "kafka_tpu_torch" if pid == own_pid
                     else f"sandbox-{pid}"},
        })
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace.trace_id,
            "request_id": trace.request_id,
            "done": trace.done,
        },
        "traceEvents": events,
    }


load_env()
