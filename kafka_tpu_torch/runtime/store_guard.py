"""StoreGuard: fault containment between the object tier and its backend.

Counterpart of kafka_tpu/runtime/store_guard.py (copied; env knobs are
KAFKA_TORCH_KV_OBJECT_*).  The object tier consumes the ``ObjectStore``
contract as if the store were local and infallible.  Real backends (S3/GCS
over a network) fail partially, slowly, and at the worst moment; a dead or degraded store must cost warm-resume
TTFT, never liveness.  StoreGuard wraps any ``ObjectStore`` with:

  * a per-op deadline (``KAFKA_TORCH_KV_OBJECT_TIMEOUT_S``; 0 disables the
    deadline executor and calls the backend inline),
  * bounded exponential backoff with jitter for failed ops — every op in the
    protocol is idempotent by construction (content-addressed puts, empty ref
    markers, gets/heads/deletes/lists), so blind retry is safe,
  * a consecutive-failure circuit breaker: CLOSED → (N consecutive failures)
    → OPEN for a window → one HALF_OPEN probe → CLOSED on success, back to
    OPEN on failure.  While OPEN every call fast-fails with
    ``StoreUnavailableError`` so no consumer ever stalls on a dead store,
  * per-op latency / error accounting surfaced through
    ``ObjectTier.snapshot()`` → /metrics and /admin/signals.

The guard is applied at engine construction (``build_object_store``), never
inside ``ObjectTier`` itself, so unit tests that poke a bare store keep
working and the failure-injection seams (``kv.object_*`` failpoints) stay at
the tier level where chaos tests arm them.  Tier-level injected failures are
forwarded to the breaker via ``ObjectTier._note_store_failure`` so a failpoint
storm opens the breaker exactly like a real outage.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("kafka_tpu_torch.store_guard")

# Env knobs (read once per guard in from_env; all optional).
ENV_TIMEOUT_S = "KAFKA_TORCH_KV_OBJECT_TIMEOUT_S"  # per-op deadline, 0 = off
ENV_RETRIES = "KAFKA_TORCH_KV_OBJECT_RETRIES"  # extra attempts after the first
ENV_BACKOFF_S = "KAFKA_TORCH_KV_OBJECT_BACKOFF_S"  # base backoff before attempt 2
ENV_BREAKER_FAILURES = "KAFKA_TORCH_KV_OBJECT_BREAKER_FAILURES"  # trip threshold
ENV_BREAKER_OPEN_S = "KAFKA_TORCH_KV_OBJECT_BREAKER_OPEN_S"  # open window

_DEF_TIMEOUT_S = 0.0
_DEF_RETRIES = 2
_DEF_BACKOFF_S = 0.05
_DEF_BREAKER_FAILURES = 5
_DEF_BREAKER_OPEN_S = 10.0
_BACKOFF_CAP_S = 1.0


class StoreGuardError(OSError):
    """Base class for guard-originated failures.

    Subclasses OSError so pre-guard ``except OSError`` sites in the tier keep
    catching store trouble; ``isinstance(e, StoreGuardError)`` is how the tier
    tells guard-accounted failures from tier-level (failpoint) ones.
    """


class StoreUnavailableError(StoreGuardError):
    """Fast-fail: the circuit breaker is open, the backend was not called."""


class StoreTimeoutError(StoreGuardError):
    """A single attempt exceeded the per-op deadline."""


class StoreOpError(StoreGuardError):
    """An op failed after exhausting its retry budget (cause chained)."""


# Breaker states, with the numeric gauge encoding used by /metrics.
BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
_STATE_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    ``allow()`` answers "may this op hit the backend right now?".  While OPEN
    it returns False until the open window elapses, then grants exactly one
    HALF_OPEN probe; further callers keep fast-failing until the probe's
    outcome is recorded.  ``record_success`` closes from any state;
    ``record_failure`` re-opens a failed probe immediately and trips CLOSED
    after ``failure_threshold`` consecutive failures.
    """

    def __init__(
        self,
        failure_threshold: int = _DEF_BREAKER_FAILURES,
        open_window_s: float = _DEF_BREAKER_OPEN_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_window_s = max(0.0, float(open_window_s))
        self._clock = clock
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opens = 0  # CLOSED/HALF_OPEN -> OPEN transitions (counter)
        self._opened_at = 0.0

    def allow(self) -> bool:
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                if self._clock() - self._opened_at >= self.open_window_s:
                    self.state = BREAKER_HALF_OPEN
                    return True  # this caller is the probe
                return False
            return False  # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state != BREAKER_CLOSED:
                logger.info("object store breaker closed (probe succeeded)")
            self.state = BREAKER_CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == BREAKER_HALF_OPEN or (
                self.state == BREAKER_CLOSED
                and self.consecutive_failures >= self.failure_threshold
            ):
                self.state = BREAKER_OPEN
                self.opens += 1
                self._opened_at = self._clock()
                logger.warning(
                    "object store breaker open (%d consecutive failures); "
                    "fast-failing store ops for %.1fs",
                    self.consecutive_failures,
                    self.open_window_s,
                )

    def state_gauge(self) -> int:
        return _STATE_GAUGE[self.state]


class StoreGuard:
    """Wraps an ``ObjectStore`` with deadline + retry + breaker + accounting.

    Duck-types the full ``ObjectStore`` surface (put/get/head/delete/list/
    usage/put_if_absent) so it drops in anywhere the bare store is accepted.
    ``inner`` stays reachable for tests and fsck.
    """

    def __init__(
        self,
        inner: Any,
        timeout_s: float = _DEF_TIMEOUT_S,
        retries: int = _DEF_RETRIES,
        backoff_s: float = _DEF_BACKOFF_S,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.inner = inner
        self.timeout_s = max(0.0, float(timeout_s))
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.retries_total = 0
        self.timeouts_total = 0
        self.pool_replacements = 0
        self._rng = random.Random(0xC0FFEE)
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._executor_lock = threading.Lock()
        self._pool_workers = 4
        # timed-out futures whose backend thread never returned: each one
        # pins a worker until (if ever) the backend call unblocks
        self._abandoned: List[concurrent.futures.Future] = []
        # op -> [calls, errors, total_latency_s]; single small dict, torn
        # reads under concurrency only skew the report, never correctness.
        self.op_stats: Dict[str, List[float]] = {}

    @classmethod
    def from_env(cls, inner: Any, env: Optional[Dict[str, str]] = None) -> "StoreGuard":
        e = os.environ if env is None else env

        def _f(name: str, default: float) -> float:
            try:
                return float(e.get(name, default))
            except (TypeError, ValueError):
                return default

        return cls(
            inner,
            timeout_s=_f(ENV_TIMEOUT_S, _DEF_TIMEOUT_S),
            retries=int(_f(ENV_RETRIES, _DEF_RETRIES)),
            backoff_s=_f(ENV_BACKOFF_S, _DEF_BACKOFF_S),
            breaker=CircuitBreaker(
                failure_threshold=int(_f(ENV_BREAKER_FAILURES, _DEF_BREAKER_FAILURES)),
                open_window_s=_f(ENV_BREAKER_OPEN_S, _DEF_BREAKER_OPEN_S),
            ),
        )

    # ---- deadline ----------------------------------------------------

    def _with_deadline(self, fn: Callable, args: tuple,
                       deadline_scale: int = 1) -> Any:
        if self.timeout_s <= 0.0:
            return fn(*args)
        timeout_s = self.timeout_s * max(1, int(deadline_scale))
        with self._executor_lock:
            # Abandoned calls pin workers until (if ever) the backend
            # unblocks — e.g. LocalFS on a hard NFS mount has no socket
            # timeout.  If every worker is pinned, new submissions would
            # queue behind them and time out without ever reaching the
            # backend — including the breaker's half-open probe, so the
            # breaker could never close after recovery.  Swap in a fresh
            # pool instead; the old one keeps its stuck threads and is
            # dropped without joining them.
            self._abandoned = [f for f in self._abandoned if not f.done()]
            if (self._executor is not None
                    and len(self._abandoned) >= self._pool_workers):
                self._executor.shutdown(wait=False)
                self._executor = None
                self._abandoned = []
                self.pool_replacements += 1
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._pool_workers,
                    thread_name_prefix="store-guard",
                )
            ex = self._executor
        fut = ex.submit(fn, *args)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            fut.cancel()  # best effort; a stuck backend thread is abandoned
            with self._executor_lock:
                if not fut.done() and ex is self._executor:
                    self._abandoned.append(fut)
            raise StoreTimeoutError(
                f"object store op exceeded {timeout_s:.3f}s deadline"
            )

    # ---- core call path ----------------------------------------------

    def _call(self, op: str, fn: Callable, *args: Any,
              deadline_scale: int = 1) -> Any:
        if not self.breaker.allow():
            raise StoreUnavailableError(f"object store breaker open ({op})")
        stats = self.op_stats.setdefault(op, [0, 0, 0.0])
        t0 = time.monotonic()
        err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                out = self._with_deadline(fn, args, deadline_scale)
            except StoreTimeoutError as e:
                self.timeouts_total += 1
                err = e
            except Exception as e:  # backend fault: retry, then account
                err = e
            else:
                self.breaker.record_success()
                stats[0] += 1
                stats[2] += time.monotonic() - t0
                return out
            if attempt < self.retries:
                self.retries_total += 1
                delay = min(
                    _BACKOFF_CAP_S,
                    self.backoff_s * (2**attempt) * (1.0 + self._rng.random()),
                )
                if delay > 0:
                    time.sleep(delay)
        self.breaker.record_failure()
        stats[0] += 1
        stats[1] += 1
        stats[2] += time.monotonic() - t0
        if isinstance(err, StoreTimeoutError):
            raise err
        raise StoreOpError(f"object store {op} failed after {self.retries + 1} attempts: {err!r}") from err

    # ---- ObjectStore surface -----------------------------------------

    def put(self, key: str, data: bytes) -> None:
        self._call("put", self.inner.put, key, data,
                   deadline_scale=self._put_deadline_scale(len(data)))

    @staticmethod
    def _put_deadline_scale(nbytes: int) -> int:
        """A multipart put is 1 + ceil(n/threshold) + 1 sequential requests
        where a simple put is one; the per-op deadline must grow with the
        request count or large archives time out by construction."""
        from .object_tier import object_multipart_bytes

        mp = object_multipart_bytes()
        if not mp or nbytes <= mp:
            return 1
        return 1 + nbytes // mp

    def get(self, key: str) -> Optional[bytes]:
        return self._call("get", self.inner.get, key)

    def head(self, key: str) -> Optional[Tuple[int, float]]:
        return self._call("head", self.inner.head, key)

    def delete(self, key: str) -> None:
        self._call("delete", self.inner.delete, key)

    def list(self, prefix: str) -> List[str]:
        return self._call("list", self.inner.list, prefix)

    def usage(self) -> Tuple[int, int]:
        return self._call("usage", self.inner.usage)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        return self._call("put_if_absent", self.inner.put_if_absent, key, data)

    # ---- introspection -----------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Guard counters for ObjectTier.snapshot() / debugging."""
        with self._executor_lock:
            self._abandoned = [f for f in self._abandoned if not f.done()]
            stuck = len(self._abandoned)
        return {
            "retries": self.retries_total,
            "timeouts": self.timeouts_total,
            "stuck_ops": stuck,
            "pool_replacements": self.pool_replacements,
            "breaker_state": self.breaker.state_gauge(),
            "breaker_opens": self.breaker.opens,
            "consecutive_failures": self.breaker.consecutive_failures,
            "ops": {
                op: {"calls": int(c), "errors": int(e), "total_s": round(t, 6)}
                for op, (c, e, t) in self.op_stats.items()
            },
        }
