"""Scheduler flight recorder: the measured dispatch timeline.

Counterpart of kafka_tpu/runtime/flight_recorder.py: the same ring,
records, cause codes, detectors and postmortem format.

* **Ring** — a fixed-size, allocation-free ring of per-scheduler-
  iteration records (`KAFKA_TORCH_FLIGHT_RING` steps; 0 = off, with
  every engine dispatch path identical to a recorder-less build — each
  hook site is one ``if engine.flight is not None`` branch, the same
  discipline as tracing).  One record = one `engine.step()`: wall
  timestamps, which dispatch kinds ran (prefill / decode / fused /
  verify / host-constrained groups), batch composition (lanes, token
  counts, speculative candidates, awaited constrained lanes),
  admission/preempt/park/degrade cause-code counts, queue/page pressure
  gauges, and the iteration's modeled flop/byte cost next to the
  MEASURED dispatch time.  Records are plain ``__slots__`` objects
  overwritten in place; nothing on the hot path allocates beyond the
  one integer-field stores.

* **Measured dispatch time** — on CUDA each dispatch is bracketed by a
  pair of timing events on the stream, so its device seconds are read
  exactly once its fetch lands; on the CPU the engine keeps the
  reference's fetch-maturation rule (completion - max(enqueue, previous
  completion)).  Summed per dispatch kind against the planner's modeled
  roofline time it yields the modeled-vs-measured skew gauge
  (``kafka_tpu_dispatch_model_skew``) that calibrates the MFU/HBM-BW
  estimates.

* **Anomaly detectors** — step-cadence checks over the staged record
  (throttled, never allocating): queue stall (requests waiting, no
  dispatch completed for ``KAFKA_TORCH_ANOMALY_STALL_S``), fetch-pipeline
  starvation (the oldest in-flight fetch stuck past the stall bound),
  MFU collapse (1m decode MFU under ``KAFKA_TORCH_ANOMALY_MFU_FRAC`` of
  the since-boot figure while still decoding), prefill convoy (prefill
  dispatches monopolizing the engine past ``KAFKA_TORCH_ANOMALY_CONVOY_S``
  while decode work is backlogged), the compile observatory's storm and
  measured memory pressure.  Each firing is edge-triggered: one counter
  increment (``EngineMetrics.anomaly_*`` -> ``kafka_tpu_anomalies_total``),
  one log line, one tracing instant event on the active requests'
  traces, and an entry in the ``anomalies`` section of ``/admin/signals``
  while the condition holds.

* **Postmortem capture** — on engine failure (``recover_from_failure``)
  or a recovery that itself dies (the worker's ``_fail_all``), the ring
  plus a full metrics snapshot and the active-lane table is dumped as
  one JSON file next to the persisted trace rings
  (``KAFKA_TORCH_FLIGHT_DIR``, defaulting to the tracing persist
  directory), with file names sanitized exactly like the persisted
  traces.  ``GET /debug/flight/{replica}`` serves the live ring.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("kafka_tpu_torch.flight")

RING_ENV = "KAFKA_TORCH_FLIGHT_RING"
DIR_ENV = "KAFKA_TORCH_FLIGHT_DIR"
STALL_ENV = "KAFKA_TORCH_ANOMALY_STALL_S"
CONVOY_ENV = "KAFKA_TORCH_ANOMALY_CONVOY_S"
MFU_FRAC_ENV = "KAFKA_TORCH_ANOMALY_MFU_FRAC"

# postmortem files kept per directory (oldest pruned at write time)
POSTMORTEM_KEEP = 32
POSTMORTEM_VERSION = 1

# Dispatch-kind bits for one scheduler iteration's record.  An iteration
# can set several (e.g. a prefill chunk + the decode batch).
KIND_PREFILL = 1
KIND_DECODE = 2
KIND_MULTI = 4      # fused multi-step decode
KIND_VERIFY = 8     # speculative verify
KIND_MIXED = 16     # host-constrained chained/awaited groups
KIND_NAMES = (
    (KIND_PREFILL, "prefill"),
    (KIND_DECODE, "decode"),
    (KIND_MULTI, "multi"),
    (KIND_VERIFY, "verify"),
    (KIND_MIXED, "mixed"),
)

# Scheduler cause codes: WHY the scheduler touched a request this
# iteration.  The README "Flight recorder" section is the user-facing
# table; flightview.py renders these names.
CAUSES = (
    "admit",          # waiting head seated into a decode slot (prefill)
    "admit_parked",   # parked lane seated into a freed decode slot
    "park",           # off-slot prefill started (oversubscription)
    "page_blocked",   # waiting head blocked on KV pages this iteration
    "preempt",        # a lane rolled back to waiting (page pressure)
    "park_rollback",  # a parked lane rolled back to the waiting queue
    "degrade",        # grammar lane degraded to the host mask path
    "overtight",      # over-tight constrained mask row
    "timeout",        # request deadline expired (finish_reason=timeout)
    "reject",         # admission rejection (waiting queue full, 429)
    # agent-native scheduling
    "agent_demote",   # tool-gap linger expired: thread KV demoted
    "bg_admit",       # background-class request admitted (idle capacity)
    "bg_prefill",     # background lane advanced one prefill chunk
    "bg_yield",       # background prefill yielded to interactive work
)
CAUSE_INDEX = {name: i for i, name in enumerate(CAUSES)}

ANOMALY_KINDS = (
    "queue_stall",
    "fetch_starvation",
    "mfu_collapse",
    "prefill_convoy",
    # device-truth detectors: the compile observatory's
    # level-held storm condition (recompiling under live traffic —
    # the autoscaler refuses to resize while it holds) and measured
    # HBM headroom under the watermark (runtime/planner.MemoryMonitor)
    "compile_storm",
    "hbm_pressure",
)


def ring_default() -> int:
    """KAFKA_TORCH_FLIGHT_RING with nonsense clamped to the default (256
    records ~= a few seconds of busy scheduling, a few minutes idle)."""
    raw = os.environ.get(RING_ENV)
    if raw is None or raw == "":
        return 256
    try:
        return max(0, int(raw))
    except ValueError:
        return 256


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def postmortem_dir() -> Optional[str]:
    """Where postmortem dumps land: KAFKA_TORCH_FLIGHT_DIR when set
    (explicit "" disables), else alongside the persisted trace rings
    (tracing.persist_dir(), itself defaulting to
    KAFKA_TORCH_TRACE_PERSIST_DIR / <disk tier>/traces).  None = no dump
    (logged once per dump attempt at debug level)."""
    env = os.environ
    if DIR_ENV in env:
        return env[DIR_ENV] or None
    try:
        from .. import tracing as _tracing

        d = _tracing.persist_dir()
        if d:
            return d
    except Exception:  # pragma: no cover - tracing import cycles
        pass
    d = env.get("KAFKA_TORCH_TRACE_PERSIST_DIR")
    if d:
        return d
    disk = env.get("KAFKA_TORCH_KV_DISK_TIER_DIR")
    if disk:
        return os.path.join(disk, "traces")
    return None


def sanitize_name(raw: str) -> str:
    """Filesystem-safe file-name stem — the SAME derivation as the
    persisted traces (one shared helper, tracing.sanitize_stem), so
    hostile content (a reason string built from an exception message,
    say) can never traverse out of the dump directory and a hardening
    change to the rule cannot drift between the two artifact kinds."""
    from ..tracing import sanitize_stem

    return sanitize_stem(raw)


class _Rec:
    """One scheduler iteration, overwritten in place (ring slot)."""

    __slots__ = (
        "seq", "t", "gap_ms",
        "kinds", "lanes", "toks", "steps",
        "prefill_lanes", "prefill_toks",
        "spec_cands", "chained", "awaited",
        "queue_depth", "active", "parked", "pending", "pending_steps",
        "pages_free", "pages_total", "cache_pages", "tier_bytes",
        "flops", "hbm_bytes", "modeled_ms", "measured_ms",
        "emitted", "causes",
    )

    def __init__(self, n_causes: int):
        self.causes = [0] * n_causes
        self.reset()

    def reset(self) -> None:
        self.seq = -1
        self.t = 0.0
        self.gap_ms = 0.0
        self.kinds = 0
        self.lanes = 0
        self.toks = 0
        self.steps = 0
        self.prefill_lanes = 0
        self.prefill_toks = 0
        self.spec_cands = 0
        self.chained = 0
        self.awaited = 0
        self.queue_depth = 0
        self.active = 0
        self.parked = 0
        self.pending = 0
        self.pending_steps = 0
        self.pages_free = 0
        self.pages_total = 0
        self.cache_pages = 0
        self.tier_bytes = 0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.modeled_ms = 0.0
        self.measured_ms = 0.0
        self.emitted = 0
        for i in range(len(self.causes)):
            self.causes[i] = 0

    def to_dict(self, wall_off: float) -> Dict[str, Any]:
        kinds = [name for bit, name in KIND_NAMES if self.kinds & bit]
        causes = {
            CAUSES[i]: n for i, n in enumerate(self.causes) if n
        }
        return {
            "seq": self.seq,
            "t": round(self.t + wall_off, 4),
            "gap_ms": round(self.gap_ms, 3),
            "kinds": kinds,
            "lanes": self.lanes,
            "toks": self.toks,
            "steps": self.steps,
            "prefill_lanes": self.prefill_lanes,
            "prefill_toks": self.prefill_toks,
            "spec_cands": self.spec_cands,
            "chained": self.chained,
            "awaited": self.awaited,
            "queue_depth": self.queue_depth,
            "active": self.active,
            "parked": self.parked,
            "pending": self.pending,
            "pending_steps": self.pending_steps,
            "pages_free": self.pages_free,
            "pages_total": self.pages_total,
            "cache_pages": self.cache_pages,
            "tier_bytes": self.tier_bytes,
            "flops": round(self.flops, 0),
            "hbm_bytes": round(self.hbm_bytes, 0),
            "modeled_ms": round(self.modeled_ms, 4),
            "measured_ms": round(self.measured_ms, 4),
            "emitted": self.emitted,
            "causes": causes,
        }


class FlightRecorder:
    """Per-engine scheduler flight recorder (engine-thread single-writer).

    The engine stages one iteration's facts through the ``note_*`` calls
    and commits them with ``finish_step(engine)`` at the end of
    ``step()``.  Reads from other threads (``/debug/flight``,
    ``/admin/signals``) are torn-tolerant exactly like the metrics
    snapshot: a record being overwritten may read mixed, one iteration
    stale at worst.
    """

    def __init__(self, size: int, replica: Optional[int] = None):
        if size <= 0:
            raise ValueError("FlightRecorder size must be > 0 (0 = off "
                             "means: do not construct one)")
        self.size = size
        self.replica = replica
        self._ring: List[_Rec] = [_Rec(len(CAUSES)) for _ in range(size)]
        self.next_seq = 0  # total records appended (monotone)
        self.postmortems = 0
        # monotonic->wall offset so exported timestamps correlate with
        # trace spans and log lines (computed once; drift is irrelevant
        # at flight-recorder resolution)
        self._wall_off = time.time() - time.monotonic()
        # staging for the in-progress iteration
        self._stage = _Rec(len(CAUSES))
        self._last_finish_t: Optional[float] = None
        # detector state
        self.stall_s = max(0.05, _env_float(STALL_ENV, 5.0))
        self.convoy_s = max(0.05, _env_float(CONVOY_ENV, self.stall_s))
        self.mfu_collapse_frac = min(
            1.0, max(0.0, _env_float(MFU_FRAC_ENV, 0.25))
        )
        self._last_dispatch_t: Optional[float] = None
        self._last_pop_t: Optional[float] = None
        self._convoy_since: Optional[float] = None
        self._mfu_check_t = 0.0
        # Gate-level 429s arrive on the EVENT LOOP thread (the serving
        # gate catches nearly everything under sustained overload — the
        # engine backstop sees only the race leftovers), while the stage
        # is engine-thread single-writer.  They land here via
        # note_gate_reject (GIL-atomic-enough increment, the same
        # tolerance record_rejection uses) and drain into the next
        # committed record's "reject" cause — without this the ring of
        # an overload burst would read as if almost nothing was shed.
        self.gate_rejects = 0
        # kind -> {"active": bool, "since": wall_s, "detail": str}
        self.anomaly_state: Dict[str, Dict[str, Any]] = {
            k: {"active": False, "since": None, "detail": None}
            for k in ANOMALY_KINDS
        }

    # -- per-iteration staging (engine thread) ---------------------------

    def note_dispatch(self, kind: int, lanes: int, toks: int,
                      steps: int = 1) -> None:
        s = self._stage
        s.kinds |= kind
        s.lanes += lanes
        s.toks += toks
        s.steps += steps

    def note_prefill(self, lanes: int, toks: int) -> None:
        s = self._stage
        s.kinds |= KIND_PREFILL
        s.prefill_lanes += lanes
        s.prefill_toks += toks

    def note_spec(self, candidates: int) -> None:
        self._stage.spec_cands += candidates

    def note_constrained(self, chained: int, awaited: int) -> None:
        s = self._stage
        if chained or awaited:
            s.kinds |= KIND_MIXED
        s.chained += chained
        s.awaited += awaited

    def note_cause(self, name: str, n: int = 1) -> None:
        self._stage.causes[CAUSE_INDEX[name]] += n

    def note_gate_reject(self) -> None:
        """A gate-level HTTP 429 (event-loop thread; see gate_rejects).
        Safe cross-thread: one int increment, drained by finish_step."""
        self.gate_rejects += 1

    def note_cost(self, flops: float, hbm_bytes: float,
                  modeled_s: Optional[float]) -> None:
        s = self._stage
        s.flops += flops
        s.hbm_bytes += hbm_bytes
        if modeled_s is not None:
            s.modeled_ms += modeled_s * 1e3

    def note_measured(self, measured_s: float) -> None:
        self._stage.measured_ms += measured_s * 1e3

    def note_pop(self, emitted: int) -> None:
        """A fetch entry matured and was processed (host side)."""
        self._last_pop_t = time.monotonic()
        self._stage.emitted += emitted

    # -- commit + detectors ---------------------------------------------

    def finish_step(self, engine: Any,
                    now: Optional[float] = None) -> None:
        """Commit the staged iteration into the ring and run the anomaly
        detectors.  `engine` is read for the pressure gauges (duck-typed;
        every read is defensive so a failing engine can still commit its
        final partial record from the postmortem path)."""
        now = time.monotonic() if now is None else now
        s = self._stage
        # drain gate-level 429s banked by the event-loop thread into
        # this record's reject cause (subtract what we took — increments
        # landing mid-drain survive for the next record)
        taken = self.gate_rejects
        if taken:
            self.gate_rejects -= taken
            s.causes[CAUSE_INDEX["reject"]] += taken
        s.seq = self.next_seq
        s.t = now
        if self._last_finish_t is not None:
            s.gap_ms = (now - self._last_finish_t) * 1e3
        self._last_finish_t = now
        # pressure gauges straight off the engine (single thread)
        try:
            s.queue_depth = len(engine.waiting)
            s.parked = len(engine.parked)
            s.active = engine.num_active
            s.pending = len(engine._pending)
            s.pending_steps = engine._pending_steps
            pool = engine.pool
            s.pages_free = pool.free_pages
            s.pages_total = pool.num_pages
            pc = engine.prefix_cache
            s.cache_pages = pc.total_pages if pc is not None else 0
            tier = getattr(engine, "kv_tier", None)
            s.tier_bytes = tier.host_bytes if tier is not None else 0
        except Exception:  # pragma: no cover - partial postmortem commit
            pass
        self._detect(engine, s, now)
        # commit: overwrite the ring slot in place (no allocation)
        rec = self._ring[self.next_seq % self.size]
        rec.seq = s.seq
        rec.t = s.t
        rec.gap_ms = s.gap_ms
        rec.kinds = s.kinds
        rec.lanes = s.lanes
        rec.toks = s.toks
        rec.steps = s.steps
        rec.prefill_lanes = s.prefill_lanes
        rec.prefill_toks = s.prefill_toks
        rec.spec_cands = s.spec_cands
        rec.chained = s.chained
        rec.awaited = s.awaited
        rec.queue_depth = s.queue_depth
        rec.active = s.active
        rec.parked = s.parked
        rec.pending = s.pending
        rec.pending_steps = s.pending_steps
        rec.pages_free = s.pages_free
        rec.pages_total = s.pages_total
        rec.cache_pages = s.cache_pages
        rec.tier_bytes = s.tier_bytes
        rec.flops = s.flops
        rec.hbm_bytes = s.hbm_bytes
        rec.modeled_ms = s.modeled_ms
        rec.measured_ms = s.measured_ms
        rec.emitted = s.emitted
        for i, n in enumerate(s.causes):
            rec.causes[i] = n
        self.next_seq += 1
        s.reset()

    def _detect(self, engine: Any, s: _Rec, now: float) -> None:
        metrics = getattr(engine, "metrics", None)
        dispatched = s.kinds != 0
        # queue stall: requests are waiting and no dispatch has COMPLETED
        # for stall_s — the autoscaler must not scale on a wedged
        # replica's stale utilization math.  Armed only once a dispatch
        # has been seen (cold start / idle wake is admission latency, not
        # a stall).
        stalled = (
            s.queue_depth > 0
            and self._last_dispatch_t is not None
            and now - self._last_dispatch_t > self.stall_s
        )
        if stalled:
            # fire even when THIS iteration finally dispatched: the queue
            # sat undisipatched past the bound, which is the event (a
            # delayed step that then proceeds still stalled its clients).
            # The anomaly stays ACTIVE across consecutive stalled
            # iterations — a chronic slow-cadence stall (every step
            # slower than the bound) is ONE episode: one counter edge,
            # continuously visible in /admin/signals, rather than a
            # fire+clear per iteration that the autoscaler's poll would
            # never observe.
            self._fire(
                engine, metrics, "queue_stall", now,
                f"depth={s.queue_depth} no dispatch for "
                f"{now - self._last_dispatch_t:.2f}s",
            )
        else:
            self._clear("queue_stall")  # cadence recovered / queue empty
        if dispatched:
            self._last_dispatch_t = now
        elif not (s.active or s.queue_depth or s.parked or s.pending):
            self._last_dispatch_t = None  # idle: re-arm on next one
        # fetch-pipeline starvation: the OLDEST in-flight fetch has been
        # stuck past the stall bound.  The drain rules force-pop aged
        # entries within fetch_wait_s normally; an entry this old means
        # the device never finished its compute (is_ready stayed false).
        head_t0 = None
        try:
            pending = engine._pending
            if pending:
                head_t0 = pending[0].t0
        except Exception:
            pending = None
        if head_t0 is not None and now - head_t0 > self.stall_s:
            self._fire(
                engine, metrics, "fetch_starvation", now,
                f"oldest fetch in flight {now - head_t0:.2f}s",
            )
        else:
            self._clear("fetch_starvation")
        # prefill convoy: prefill dispatches monopolize the engine while
        # OTHER work is backlogged — the pattern that melts TPOT p99
        # under a long-prompt storm.  The backlog must be work beyond the
        # prefilling lanes themselves (waiting queue): s.active counts
        # seated PREFILLING lanes too, so gating on it would flag every
        # single long prompt's normal chunked warm-up as an anomaly and
        # hold the autoscaler exactly when scale-up might help.
        convoy = (
            s.kinds & KIND_PREFILL
            and not s.kinds & (KIND_DECODE | KIND_MULTI | KIND_VERIFY)
            and s.queue_depth > 0
        )
        if convoy:
            if self._convoy_since is None:
                self._convoy_since = now
            elif now - self._convoy_since > self.convoy_s:
                self._fire(
                    engine, metrics, "prefill_convoy", now,
                    f"prefill-only for {now - self._convoy_since:.2f}s "
                    f"(queue={s.queue_depth} active={s.active})",
                )
        else:
            self._convoy_since = None
            self._clear("prefill_convoy")
        # MFU collapse (throttled to ~1 Hz): the last minute's decode MFU
        # fell under mfu_collapse_frac of the since-boot figure while the
        # engine is still decoding — the modeled numbers went stale.
        if metrics is not None and now - self._mfu_check_t >= 1.0:
            self._mfu_check_t = now
            try:
                self._check_mfu(engine, metrics, now)
            except Exception:  # pragma: no cover - defensive
                pass
        # compile storm: the process compile observatory is
        # level-holding the condition; this detector edge-counts it per
        # replica and keeps it in the active set the autoscaler reads.
        try:
            from . import compile_log

            obs = compile_log.get()
            if obs is not None:
                if obs.storm_active():
                    self._fire(
                        engine, metrics, "compile_storm", now,
                        f"{obs.storm_n}+ compiles in {obs.storm_s:.0f}s "
                        "under live traffic",
                    )
                else:
                    self._clear("compile_storm")
        except Exception:  # pragma: no cover - defensive
            pass
        # HBM pressure: MEASURED device headroom dropped
        # under the watermark — the resident set outgrew the plan
        # (plan_skew tells by how much); the degradation ladder input.
        try:
            mm = getattr(engine, "memory_monitor", None)
            if mm is not None:
                if mm.pressure():
                    sec = mm.section() or {}
                    self._fire(
                        engine, metrics, "hbm_pressure", now,
                        f"headroom "
                        f"{sec.get('hbm_headroom_bytes', 0) / 2**20:.0f}"
                        f"MiB (skew {sec.get('hbm_plan_skew', 0.0)})",
                    )
                else:
                    self._clear("hbm_pressure")
        except Exception:  # pragma: no cover - defensive
            pass

    def _check_mfu(self, engine: Any, metrics: Any, now: float) -> None:
        peak = metrics.peak_flops
        u = metrics.util.get("decode") if metrics.util else None
        if not peak or u is None or u.busy_s < 5.0:
            return
        w = metrics._util_window["decode"].sums(60.0, now=now)
        if w[2] < 1.0:
            self._clear("mfu_collapse")
            return  # not decoding this minute: idle, not collapsed
        mfu_total = u.flops / (u.busy_s * peak)
        mfu_1m = w[0] / (w[2] * peak)
        if mfu_total > 0 and mfu_1m < self.mfu_collapse_frac * mfu_total:
            self._fire(
                engine, metrics, "mfu_collapse", now,
                f"decode mfu_1m={mfu_1m:.4f} vs total={mfu_total:.4f}",
            )
        else:
            self._clear("mfu_collapse")

    def _fire(self, engine: Any, metrics: Any, kind: str, now: float,
              detail: str) -> None:
        st = self.anomaly_state[kind]
        st["detail"] = detail
        if st["active"]:
            return  # level holds; edge already counted
        st["active"] = True
        st["since"] = now + self._wall_off
        if metrics is not None:
            setattr(metrics, f"anomaly_{kind}",
                    getattr(metrics, f"anomaly_{kind}") + 1)
        logger.warning(
            "flight anomaly %s%s: %s", kind,
            f" (replica {self.replica})" if self.replica is not None
            else "", detail,
        )
        # punctuate the active requests' timelines (traced only; bounded)
        try:
            from ..tracing import add_event

            n = 0
            for req in engine._requests.values():
                if getattr(req, "trace", None) is not None:
                    add_event(req.trace, "anomaly",
                              {"kind": kind, "detail": detail})
                    n += 1
                    if n >= 8:
                        break
        except Exception:  # pragma: no cover - defensive
            pass

    def _clear(self, kind: str) -> None:
        st = self.anomaly_state[kind]
        if st["active"]:
            st["active"] = False
            st["since"] = None
            st["detail"] = None

    # -- export ----------------------------------------------------------

    def active_anomalies(self) -> List[Dict[str, Any]]:
        out = []
        for kind in ANOMALY_KINDS:
            st = self.anomaly_state[kind]
            if st["active"]:
                out.append({
                    "kind": kind,
                    "since": st["since"],
                    "detail": st["detail"],
                })
        return out

    def records(self) -> List[Dict[str, Any]]:
        """Ring contents oldest -> newest (torn-tolerant copy)."""
        out = []
        hi = self.next_seq
        lo = max(0, hi - self.size)
        for seq in range(lo, hi):
            rec = self._ring[seq % self.size]
            if rec.seq == seq:  # skip slots mid-overwrite / never written
                out.append(rec.to_dict(self._wall_off))
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "ring_size": self.size,
            "next_seq": self.next_seq,
            "replica": self.replica,
            "causes": list(CAUSES),
            "anomalies": {
                "active": self.active_anomalies(),
            },
            "records": self.records(),
        }

    # -- postmortem ------------------------------------------------------

    def dump_postmortem(
        self,
        reason: str,
        lanes: Optional[List[Dict[str, Any]]] = None,
        metrics_snapshot: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Write the ring + context as one postmortem JSON file.

        Best-effort and exception-free: this runs on failure paths where
        a second exception would mask the first.  Returns the path (None
        when no dump directory is configured or the write failed)."""
        d = postmortem_dir()
        if d is None:
            logger.debug("no postmortem dir configured; skipping %s dump",
                         reason)
            return None
        payload = {
            "version": POSTMORTEM_VERSION,
            "kind": "flight_postmortem",
            "reason": reason,
            "replica": self.replica,
            "pid": os.getpid(),
            "t_wall": time.time(),
            "ring_size": self.size,
            "next_seq": self.next_seq,
            "causes": list(CAUSES),
            "anomalies": {
                kind: dict(self.anomaly_state[kind])
                for kind in ANOMALY_KINDS
            },
            "records": self.records(),
            "lanes": lanes or [],
            "metrics": metrics_snapshot or {},
        }
        if extra:
            payload.update(extra)
        stem = sanitize_name(
            f"{reason}-r{self.replica if self.replica is not None else 0}"
            f"-{self.next_seq}-{os.getpid()}"
        )
        path = os.path.join(d, f"postmortem.{stem}.flight.json")
        try:
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            logger.warning("postmortem dump failed (%s): %s", reason, e)
            return None
        self.postmortems += 1
        _prune_postmortems(d)
        logger.error("flight postmortem (%s) written to %s", reason, path)
        return path


def _prune_postmortems(d: str) -> None:
    """Bound the postmortem set (oldest dropped)."""
    try:
        names = [n for n in os.listdir(d) if n.endswith(".flight.json")]
        if len(names) <= POSTMORTEM_KEEP:
            return
        paths = [os.path.join(d, n) for n in names]
        paths.sort(key=lambda p: os.path.getmtime(p))
        for p in paths[: len(paths) - POSTMORTEM_KEEP]:
            os.unlink(p)
    except OSError:  # pragma: no cover - best effort
        pass


def list_postmortems(d: Optional[str] = None) -> List[str]:
    """Postmortem files in the dump dir, newest first (flightview)."""
    d = d if d is not None else postmortem_dir()
    if not d:
        return []
    try:
        paths = [os.path.join(d, n) for n in os.listdir(d)
                 if n.endswith(".flight.json")]
        paths.sort(key=lambda p: os.path.getmtime(p), reverse=True)
        return paths
    except OSError:
        return []
