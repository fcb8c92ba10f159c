"""Compile observatory: the record of every compilation the port makes.

Counterpart of kafka_tpu/runtime/compile_log.py: the same bounded ring,
phases, storm detector and sections.  On the card a "compile" is one of:

* a CUDA-graph capture of a decode step program
  (`InferenceEngine._capture`, label ``decode_graph[...]``), which
  includes the FSM variant's recapture when a grammar grows the tables;
* an ``nvcc`` build of a kernel library (`ops/kernels/build.py`, label
  ``nvcc[<source>]``; a library already in the build directory is a
  zero-second ``hit``).

There is no compiler event stream to listen to (the reference hooks
``jax.monitoring``): the call sites record each event explicitly
through :func:`record`.

* **Bounded ring** — ``KAFKA_TORCH_COMPILE_RING`` records (default 256;
  0 = off: nothing is constructed and :func:`record` is a no-op).  One
  record = one compilation: label, wall-clock seconds, cache disposition
  (``hit`` / ``miss`` / ``off``) and the serving phase that triggered it
  (``boot`` / ``warmup`` / ``first_traffic`` / ``rebuild``).
* **Storm detection** — ``N`` compiles inside ``W`` seconds *after the
  engine reached first traffic* (``KAFKA_TORCH_COMPILE_STORM_N`` /
  ``_S``, default 3 in 60s) means programs are being rebuilt while users
  wait.  The condition is level-held here and edge-counted by the flight
  recorder's ``compile_storm`` anomaly.  Boot / warmup / rebuild
  compiles are the expected cost of those phases and never count.

``GET /debug/compiles`` serves the ring; the ``compiles`` sections of
``/metrics`` and ``/admin/signals`` carry the totals.  The observatory
is process-wide, so the section is reported once, not per replica.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("kafka_tpu_torch.compile")

RING_ENV = "KAFKA_TORCH_COMPILE_RING"
STORM_N_ENV = "KAFKA_TORCH_COMPILE_STORM_N"
STORM_S_ENV = "KAFKA_TORCH_COMPILE_STORM_S"

PHASES = ("boot", "warmup", "first_traffic", "rebuild")

# one compile above this many seconds is always worth a log line
_SLOW_COMPILE_S = 30.0


def ring_default() -> int:
    """KAFKA_TORCH_COMPILE_RING with nonsense clamped to the default
    (256 records outlives any realistic warmup + rebuild history)."""
    raw = os.environ.get(RING_ENV)
    if raw is None or raw == "":
        return 256
    try:
        return max(0, int(raw))
    except ValueError:
        return 256


def _env_pos(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


class CompileObservatory:
    """Process-wide compile ring + storm detector.

    Writes arrive from whichever thread compiles (the engine thread
    capturing a graph, the boot path building kernels) under ``_lock``;
    reads (``/debug/compiles``, metrics, signals) take the same lock —
    the ring is tiny and compiles are rare.
    """

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("CompileObservatory size must be > 0 "
                             "(0 = off means: do not construct one)")
        self.size = size
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []
        self.next_seq = 0
        self.phase = "boot"
        # no persistent compile cache on the card: always None, kept for
        # the reference's sections
        self.cache_dir: Optional[str] = None
        # totals (monotone counters)
        self.compiles_total = 0
        self.compile_seconds_total = 0.0
        self.by_cache: Dict[str, int] = {"hit": 0, "miss": 0, "off": 0}
        self.by_phase: Dict[str, int] = {p: 0 for p in PHASES}
        # storm detector: wall times of first_traffic-phase compiles
        self.storm_n = max(1, int(_env_pos(STORM_N_ENV, 3)))
        self.storm_s = _env_pos(STORM_S_ENV, 60.0)
        self._storm_times: List[float] = []
        self.storms_total = 0
        self._storm_was_active = False

    # -- recording -------------------------------------------------------

    def record(self, label: str, seconds: float,
               cache: Optional[str] = None,
               now: Optional[float] = None) -> None:
        """One compilation happened.  ``cache`` defaults from the cache
        configuration: ``off`` when no cache dir is configured, ``miss``
        otherwise."""
        now = time.time() if now is None else now
        if cache is None:
            cache = "miss" if self.cache_dir else "off"
        with self._lock:
            rec = {
                "seq": self.next_seq,
                "t": round(now, 3),
                "label": label,
                "seconds": round(seconds, 4),
                "cache": cache,
                "phase": self.phase,
            }
            if len(self._ring) < self.size:
                self._ring.append(rec)
            else:
                self._ring[self.next_seq % self.size] = rec
            self.next_seq += 1
            self.compiles_total += 1
            self.compile_seconds_total += seconds
            self.by_cache[cache] = self.by_cache.get(cache, 0) + 1
            self.by_phase[self.phase] = self.by_phase.get(
                self.phase, 0) + 1
            if self.phase == "first_traffic":
                self._storm_times.append(now)
                # bound the storm window list (ring discipline)
                if len(self._storm_times) > 4 * self.storm_n:
                    del self._storm_times[: -2 * self.storm_n]
                if (self._storm_active_locked(now)
                        and not self._storm_was_active):
                    self._storm_was_active = True
                    self.storms_total += 1
                    logger.warning(
                        "compile storm: %d compiles in %.0fs while "
                        "serving (last: %s, %.2fs)", self.storm_n,
                        self.storm_s, label, seconds)
        if seconds >= _SLOW_COMPILE_S:
            logger.warning("slow compile: %s took %.1fs (phase=%s, "
                           "cache=%s)", label, seconds, self.phase,
                           cache)
        else:
            logger.info("compile: %s %.2fs (phase=%s, cache=%s)",
                        label, seconds, self.phase, cache)

    # -- storm -----------------------------------------------------------

    def _storm_active_locked(self, now: float) -> bool:
        cutoff = now - self.storm_s
        n = 0
        for t in reversed(self._storm_times):
            if t < cutoff:
                break
            n += 1
        return n >= self.storm_n

    def storm_active(self, now: Optional[float] = None) -> bool:
        """Level-held storm condition (the flight recorder edge-counts
        it)."""
        now = time.time() if now is None else now
        with self._lock:
            active = self._storm_active_locked(now)
            if not active:
                self._storm_was_active = False
            return active

    # -- export ----------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            if len(self._ring) < self.size:
                return [dict(r) for r in self._ring]
            start = self.next_seq % self.size
            return [dict(self._ring[(start + i) % self.size])
                    for i in range(self.size)]

    def metrics_section(self) -> Dict[str, Any]:
        """The ``compiles`` section of the metrics snapshot (keys
        registered as COMPILE_METRIC_KEYS in metrics.py)."""
        now = time.time()
        storm = self.storm_active(now)
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "compile_seconds_total": round(
                    self.compile_seconds_total, 4),
                "compile_storm_active": 1 if storm else 0,
                "compile_storms_total": self.storms_total,
                "by_cache": dict(self.by_cache),
                "by_phase": dict(self.by_phase),
            }

    def signals_section(self) -> Dict[str, Any]:
        """The ``compiles`` section of /admin/signals: ring summary +
        the storm flag."""
        sec = self.metrics_section()
        with self._lock:
            recent = [dict(r) for r in self._ring[-8:]] \
                if len(self._ring) < self.size else None
            if recent is None:
                start = self.next_seq % self.size
                recent = [dict(self._ring[(start + i) % self.size])
                          for i in range(self.size)][-8:]
            sec.update({
                "ring_size": self.size,
                "next_seq": self.next_seq,
                "phase": self.phase,
                "cache_dir": self.cache_dir,
                "storm_n": self.storm_n,
                "storm_window_s": self.storm_s,
                "recent": recent,
            })
        sec["storm_active"] = bool(sec.pop("compile_storm_active"))
        return sec

    def snapshot(self) -> Dict[str, Any]:
        """Full ring for GET /debug/compiles."""
        sec = self.metrics_section()
        return {
            "ring_size": self.size,
            "next_seq": self.next_seq,
            "phase": self.phase,
            "cache_dir": self.cache_dir,
            "storm": {
                "active": bool(sec["compile_storm_active"]),
                "storms_total": self.storms_total,
                "n": self.storm_n,
                "window_s": self.storm_s,
            },
            "totals": {
                "compiles": sec["compiles_total"],
                "seconds": sec["compile_seconds_total"],
                "by_cache": sec["by_cache"],
                "by_phase": sec["by_phase"],
            },
            "records": self.records(),
        }


# ---------------------------------------------------------------------------
# module-level singleton: compilation is process-global, so is this

_OBS: Optional[CompileObservatory] = None
_INIT_LOCK = threading.Lock()


def get() -> Optional[CompileObservatory]:
    return _OBS


def init(size: Optional[int] = None) -> Optional[CompileObservatory]:
    """Build (or return) the process observatory.  size 0 disables —
    nothing is constructed and every hook below is a no-op."""
    global _OBS
    size = ring_default() if size is None else size
    if size <= 0:
        return _OBS
    with _INIT_LOCK:
        if _OBS is None:
            _OBS = CompileObservatory(size)
        return _OBS


def set_phase(phase: str) -> None:
    """Serving lifecycle transition (boot -> warmup -> first_traffic,
    with rebuild excursions).  Unknown names are kept verbatim so a
    future phase shows up in the ring rather than vanishing."""
    obs = _OBS
    if obs is not None:
        obs.phase = phase


def record(label: str, seconds: float, cache: Optional[str] = None) -> None:
    """Record one compilation from its call site; a no-op while the
    observatory is off.  Never raises into the compiling path."""
    obs = _OBS
    if obs is None:
        return
    try:
        obs.record(label, seconds, cache=cache)
    except Exception:  # pragma: no cover - never break a compile
        logger.debug("compile record failed", exc_info=True)
