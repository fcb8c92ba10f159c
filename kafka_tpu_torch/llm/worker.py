"""Engine dispatch thread: bridges the synchronous step loop to asyncio.

Counterpart of kafka_tpu/llm/worker.py.  One daemon thread owns the
engine — one InferenceEngine, or a DataParallelEngines router driving its
replicas in turn through the same surface — and runs its steps
continuously; requests and cancels reach it
through a thread-safe inbox, and each request's TokenEvents are delivered
to its own asyncio queue with `loop.call_soon_threadsafe`.  The thread is
the engine's only mutator, so engine state needs no locks.  A step that
raises is recovered with `engine.recover_from_failure()`; if recovery
itself fails, every request gets a terminal error event.  Event routing
fires the `worker.dispatch` failpoint, and a routing fault never kills
the loop: a lost token is dropped, a terminal event is retried once per
loop iteration and finally delivered with the failpoint bypassed.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..failpoints import failpoint
from ..runtime.engine import (
    AdmissionError,
    GenRequest,
    InferenceEngine,
    TokenEvent,
)
from ..tracing import add_event

logger = logging.getLogger("kafka_tpu_torch.llm.worker")


@dataclass
class _Route:
    loop: asyncio.AbstractEventLoop
    events: "asyncio.Queue[TokenEvent]"
    dropped: bool = False


class EngineWorker:
    """Owns the engine thread; routes token events to per-request queues."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self._inbox: "queue.Queue[Tuple[str, object]]" = queue.Queue()
        self._routes: Dict[str, _Route] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._lock = threading.Lock()  # guards _routes (submit vs dispatch)
        # terminal events whose dispatch failed, awaiting a paced retry
        # (worker thread only; _dispatch_guarded / _retry_redispatches)
        self._redispatches: list = []
        # pause seam (the object tier's drain): while paused the worker
        # thread parks between steps and the caller owns the engine
        self._pause_req = threading.Event()
        self._pause_ack = threading.Event()
        self._resume_evt = threading.Event()
        # a function the parked thread runs for its owner (run_parked)
        self._parked_task: Optional[Tuple[Callable[[], Any],
                                          concurrent.futures.Future]] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "EngineWorker":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="kafka-torch-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stopped.set()
        self._inbox.put(("__wake__", None))
        if getattr(self.engine, "mesh", None) is not None:
            # a tensor-parallel engine stops its ranks as the thread ends
            # (each frees its shard and leaves the process group): wait
            # for them, so no rank outlives the server
            timeout = max(timeout, 60.0)
        self._thread.join(timeout=timeout)
        self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def pause(self, timeout: float = 30.0) -> bool:
        """Park the engine thread between steps; returns once it is parked
        (True) or the wait timed out (False).  While paused, no step()
        runs and no inbox command is processed — the caller owns the
        engine (single writer).  Always pair with resume(), promptly:
        submits and cancels queue up behind the pause."""
        if not self.alive:
            return True  # no thread -> nothing can race the caller
        self._resume_evt.clear()
        self._pause_ack.clear()
        self._pause_req.set()
        self._inbox.put(("__wake__", None))
        return self._pause_ack.wait(timeout)

    def resume(self) -> None:
        self._pause_req.clear()
        self._resume_evt.set()

    def run_parked(self, fn: Callable[[], Any]) -> concurrent.futures.Future:
        """Run `fn` on the engine thread while it is parked (after a
        successful pause()); the thread stays parked afterwards.  A
        topology rebuild runs here, so the new replicas' graph captures
        and BLAS handles belong to the thread that replays them, and a
        resize does not add another thread's library workspaces."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if not self.alive:
            try:
                fut.set_result(fn())
            except BaseException as e:  # handed to the caller
                fut.set_exception(e)
            return fut
        self._parked_task = (fn, fut)
        self._resume_evt.set()  # wakes the park loop; the pause holds
        return fut

    def _run_parked_task(self) -> bool:
        task, self._parked_task = self._parked_task, None
        if task is None:
            return False
        fn, fut = task
        try:
            fut.set_result(fn())
        except BaseException as e:  # handed to the caller
            fut.set_exception(e)
        return True

    # -- request API (called from asyncio) -----------------------------

    def submit(self, req: GenRequest, loop: asyncio.AbstractEventLoop
               ) -> "asyncio.Queue[TokenEvent]":
        """Enqueue a request; returns the asyncio queue its events land on."""
        if self._stopped.is_set():
            raise RuntimeError("engine worker is stopped")
        events: "asyncio.Queue[TokenEvent]" = asyncio.Queue()
        with self._lock:
            self._routes[req.request_id] = _Route(loop=loop, events=events)
        self._inbox.put(("submit", req))
        return events

    def cancel(self, request_id: str) -> None:
        """Abort a request from the serving side (client disconnect)."""
        self._inbox.put(("cancel", request_id))

    def note_tool_gap(self, prefix_key: Optional[str]) -> None:
        """The provider saw a lane finish with finish_reason=tool_calls:
        route the gap signal onto the engine thread (all gap state lives
        there)."""
        self._inbox.put(("agent", ("gap", prefix_key)))

    def note_tool_return(self, prefix_key: Optional[str]) -> None:
        """The thread's tool completed: cancel a lingering demote or kick
        the return prefetch, on the engine thread."""
        self._inbox.put(("agent", ("return", prefix_key)))

    # -- engine thread -------------------------------------------------

    def _run(self) -> None:
        logger.info("engine worker started")
        while not self._stopped.is_set():
            # pause seam: park between steps until resumed (or stopped).
            # A profiler window belongs to this thread: close the kernel
            # samplers' windows first, so whoever owns the parked engine
            # (a resize's rebuild, a drain) may discard or replace it.
            if self._pause_req.is_set():
                self._close_samplers()
            while self._pause_req.is_set() and not self._stopped.is_set():
                self._pause_ack.set()
                if self._run_parked_task():
                    continue
                self._resume_evt.wait(timeout=0.1)
                if self._pause_req.is_set():
                    self._resume_evt.clear()  # a run_parked wake-up
            block = not self.engine.has_work  # block when idle
            try:
                kind, payload = self._inbox.get(
                    block=block, timeout=1.0 if block else None)
                self._handle(kind, payload)
                while True:
                    try:
                        kind, payload = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    self._handle(kind, payload)
            except queue.Empty:
                pass
            if self._stopped.is_set():
                break
            # one retry round of parked terminal events per iteration,
            # before the idle `continue` so an idle engine drains them too
            self._retry_redispatches()
            if not self.engine.has_work:
                continue
            try:
                events = self.engine.step()
            except Exception:
                logger.exception("engine step failed; recovering")
                try:
                    events = self.engine.recover_from_failure()
                except Exception:
                    logger.exception(
                        "engine recovery failed; failing all requests")
                    events = self._fail_all()
            for ev in events:
                self._dispatch_guarded(ev)
        # the profiler opens and closes on this thread: an open kernel
        # sampler window must not outlive the worker
        self._close_samplers()
        # in-flight demotions resolve and the tiers' threads stop here
        for e in self._replicas():
            close = getattr(e, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    logger.exception("engine close failed")
        logger.info("engine worker stopped")

    def _replicas(self) -> list:
        return list(getattr(self.engine, "engines", [self.engine]))

    def _close_samplers(self) -> None:
        for e in self._replicas():
            sampler = getattr(e, "kernel_sampler", None)
            if sampler is not None:
                sampler.close(e.metrics)

    def _dispatch_guarded(self, ev: TokenEvent, attempts: int = 0) -> None:
        """Dispatch one event without letting a bad route (or an armed
        worker.dispatch failpoint) take the loop down or lose a terminal
        event: a consumer awaits its terminal event forever, so a failed
        one is parked and retried once per loop iteration; when the
        budget is spent a last delivery runs with the failpoint bypassed.
        A lost token is dropped; the stream continues."""
        try:
            self._dispatch(ev)
        except Exception:
            logger.exception("event dispatch failed for %s", ev.request_id)
            if not ev.finished:
                return
            if attempts < 8:
                self._redispatches.append((ev, attempts + 1))
                return
            logger.error(
                "terminal event for %s still undeliverable after %d "
                "attempts; trying once more without fault injection",
                ev.request_id, attempts)
            try:
                self._deliver(ev)
            except Exception:
                logger.exception("final delivery failed for %s; dropping "
                                 "its route", ev.request_id)
                with self._lock:
                    self._routes.pop(ev.request_id, None)

    def _retry_redispatches(self) -> None:
        """One fresh attempt for each parked terminal event (re-parking
        itself on failure)."""
        if not self._redispatches:
            return
        pending, self._redispatches = self._redispatches, []
        for ev, attempts in pending:
            self._dispatch_guarded(ev, attempts=attempts)

    def _handle(self, kind: str, payload: object) -> None:
        if kind == "submit":
            req: GenRequest = payload  # type: ignore[assignment]
            try:
                self.engine.submit(req)
            except AdmissionError as e:
                # queue-full backstop behind the server's admission gate:
                # a distinct reason prefix the provider maps to HTTP 429
                logger.warning("submit rejected for %s: %s", req.request_id, e)
                self._dispatch_guarded(TokenEvent(
                    req.request_id, None, finished=True,
                    finish_reason=f"rejected:{e.retry_after_s:.0f}:{e}"))
            except Exception as e:  # surfaced to the consumer as an error
                logger.warning("submit rejected for %s: %s", req.request_id, e)
                self._dispatch_guarded(TokenEvent(
                    req.request_id, None, finished=True,
                    finish_reason=f"error:{e}"))
        elif kind == "agent":
            # ("gap" | "return", prefix_key); getattr keeps the worker
            # duck-typed against engine stubs in tests
            verb, key = payload  # type: ignore[misc]
            fn = getattr(self.engine, f"note_tool_{verb}", None)
            if fn is not None:
                try:
                    fn(key)
                except Exception:  # an optimization must never kill steps
                    logger.exception("agent %s signal failed for %r",
                                     verb, key)
        elif kind == "cancel":
            rid: str = payload  # type: ignore[assignment]
            if self.engine.cancel(rid):
                self._dispatch_guarded(TokenEvent(
                    rid, None, finished=True, finish_reason="cancelled"))
            else:
                with self._lock:
                    self._routes.pop(rid, None)

    def _fail_all(self) -> List[TokenEvent]:
        """Recovery itself died: every registered request gets a terminal
        engine-error event.  The flight recorder's ring is then the only
        artifact that explains the engine: it is dumped first."""
        try:
            self.engine.dump_postmortem("recovery_failed")
        except Exception:  # pragma: no cover - defensive
            logger.exception("recovery-failure postmortem dump failed")
        events = []
        for rid in list(self.engine._requests):
            req = self.engine._requests.get(rid)
            if req is not None:
                # recovery itself died: the trace still says why
                add_event(req.trace, "engine.recover",
                          {"reason": "error:engine", "fail_all": True})
            self.engine.cancel(rid, reason="error:engine")
            events.append(TokenEvent(rid, None, finished=True,
                                     finish_reason="error:engine"))
        return events

    def check_routes(self) -> List[str]:
        """Route-table consistency probe: ids with a live route but no
        engine-side request.  Call only at quiescence."""
        with self._lock:
            routed = list(self._routes)
        return [rid for rid in routed if rid not in self.engine._requests]

    def _dispatch(self, ev: TokenEvent) -> None:
        failpoint("worker.dispatch")
        self._deliver(ev)

    def _deliver(self, ev: TokenEvent) -> None:
        """Route one event to its consumer queue (no fault injection:
        _dispatch_guarded's last resort calls this directly)."""
        with self._lock:
            route = self._routes.get(ev.request_id)
        if route is None:
            return
        try:
            route.loop.call_soon_threadsafe(route.events.put_nowait, ev)
        except RuntimeError:
            # consumer loop is gone (shutdown): cancel the request so the
            # engine does not decode into the void
            if not ev.finished and not route.dropped:
                route.dropped = True
                self._inbox.put(("cancel", ev.request_id))
        if ev.finished:
            with self._lock:
                self._routes.pop(ev.request_id, None)
