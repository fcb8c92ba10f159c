"""Sampled per-kernel dispatch profiling.

Counterpart of kafka_tpu/runtime/kernel_profiler.py, on torch.profiler.

* ``KAFKA_TORCH_PROFILE_SAMPLE=N`` wraps every Nth ``engine.step`` in a
  ``torch.profiler`` window (CUDA activity on the card, CPU activity on
  the CPU, ``acc_events=True``) whose Chrome trace is exported to a
  bounded spill directory (``KAFKA_TORCH_PROFILE_SPILL_DIR``, default
  ``kafka_torch_kernels`` under the temp directory; the last
  ``KAFKA_TORCH_PROFILE_KEEP`` raw traces are kept for Perfetto, older
  ones pruned).  Unset or 0 = off: the engine holds no sampler and each
  hook site is one ``if self.kernel_sampler is not None`` branch.

* Each sample's ``*.trace.json`` is parsed with stdlib json into
  per-kernel durations: the events with ``cat == "kernel"`` (the card's
  kernels, CUDA-graph replays included, named by their CUDA function,
  e.g. ``paged_decode_chunk_kernel``); a trace with none falls back to
  the reference's filters.  Kernels aggregate by the dispatch-kind
  composition of the sampled step (``decode``, ``prefill+decode``, …)
  into a top-K table served at ``GET /debug/kernels``.

* The sample's total device kernel time, split across the step's
  dispatch kinds in proportion to their modeled roofline seconds, is fed
  back as ``EngineMetrics.record_kernel_sample`` — the ``kernel_skew``
  (true-device vs modeled) gauge.

Trace windows are *deliberately offset*: a sample's window opens at the
start of step k and closes at the start of step k+1, so the device work
queued behind the host has the inter-step gap to land inside it without
the sampler ever blocking the scheduler.  The profiler is
process-global (one session at a time); the sampler and
``POST /debug/profile`` share :func:`try_acquire_trace` so they can
never collide.  A window that cannot open or close is logged at
WARNING and counted in ``sample_failures``, never silent.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("kafka_tpu_torch.kernels")

SAMPLE_ENV = "KAFKA_TORCH_PROFILE_SAMPLE"
SPILL_ENV = "KAFKA_TORCH_PROFILE_SPILL_DIR"
KEEP_ENV = "KAFKA_TORCH_PROFILE_KEEP"

DEFAULT_KEEP = 4

# host-API events that are not kernels (CPU traces put runtime noise on
# the same host process)
_HOST_NOISE = ("ParseArguments", "ThreadpoolListener",
               "ThunkExecutor", "ExecuteHelper")


def sample_period() -> int:
    """KAFKA_TORCH_PROFILE_SAMPLE: trace every Nth step (0/unset/junk =
    off).  Negative values clamp to off like every other knob."""
    raw = os.environ.get(SAMPLE_ENV)
    if raw is None or raw == "":
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


def open_profiler(device_type: str):
    """A started torch.profiler session for `device_type` ("cuda": the
    card's kernels; anything else: CPU ops), accumulating events across
    its cycle (acc_events) where this torch has the flag."""
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CUDA] if device_type == "cuda"
                  else [ProfilerActivity.CPU])
    try:
        prof = profile(activities=activities, acc_events=True)
    except TypeError:  # a torch without acc_events
        prof = profile(activities=activities)
    prof.start()
    return prof


# -- process-global trace ownership (one profiler session at a time) ----

_TRACE_LOCK = threading.Lock()


def try_acquire_trace() -> bool:
    """Claim the process profiler (non-blocking).  Shared with the
    on-demand POST /debug/profile capture so the two can't collide."""
    return _TRACE_LOCK.acquire(blocking=False)


def release_trace() -> None:
    try:
        _TRACE_LOCK.release()
    except RuntimeError:  # pragma: no cover - double release guard
        pass


# -- trace parsing ------------------------------------------------------


def parse_trace_dir(d: str) -> List[Tuple[str, float]]:
    """All kernel events in a sample dir's Chrome traces as (name,
    dur_us).  Raises nothing: an unreadable trace is an empty list."""
    out: List[Tuple[str, float]] = []
    try:
        paths = sorted(
            glob.glob(os.path.join(d, "**", "*.trace.json"), recursive=True)
            + glob.glob(os.path.join(d, "**", "*.trace.json.gz"),
                        recursive=True))
        for p in paths:
            opener = gzip.open if p.endswith(".gz") else open
            with opener(p, "rt") as f:
                data = json.load(f)
            out.extend(_parse_events(data.get("traceEvents", [])))
    except (OSError, ValueError, EOFError):
        logger.warning("unparseable kernel trace under %s", d,
                       exc_info=True)
    return out


def _parse_events(events: List[Dict[str, Any]]
                  ) -> List[Tuple[str, float]]:
    """Complete events ("X") with a positive duration that are kernels:
    torch.profiler marks the card's kernels ``cat == "kernel"``; a trace
    with none keeps the reference's rules (events on ``/device:*``
    processes, else the host-noise filter)."""
    kernel_cat = any(e.get("cat") == "kernel" for e in events)
    device_pids = set()
    for e in events:
        if (e.get("ph") == "M" and e.get("name") == "process_name"
                and str((e.get("args") or {}).get("name", ""))
                .startswith("/device:")
                and "CPU" not in str((e.get("args") or {})["name"])):
            device_pids.add(e.get("pid"))
    out: List[Tuple[str, float]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name")
        dur = e.get("dur")
        if not name or not isinstance(dur, (int, float)) or dur <= 0:
            continue
        if kernel_cat:
            if e.get("cat") != "kernel":
                continue
        elif device_pids:
            if e.get("pid") not in device_pids:
                continue
        elif not _looks_like_kernel(name):
            continue
        out.append((name, float(dur)))
    return out


def _looks_like_kernel(name: str) -> bool:
    """Host-trace heuristic: kernel-like names vs host API noise
    (``$profiler.py …``, ``aten::mm``, ``Foo(...)``)."""
    if name.startswith("$") or "::" in name or "(" in name:
        return False
    return not any(name.startswith(p) for p in _HOST_NOISE)


# -- the sampler --------------------------------------------------------


class KernelSampler:
    """Every-Nth-step torch.profiler sampling for ONE engine.

    Engine-thread single-writer for the sampling state; the aggregated
    kernel table is read by ``/debug/kernels`` under ``_agg_lock``.  A
    torch.profiler session belongs to the thread that started it, so a
    window must close on the thread that opened it: a caller that moves
    the engine to another thread (the server's boot warms up on its own
    thread, then hands the engine to the worker) calls ``close()`` first,
    and a close from any other thread raises.
    """

    def __init__(self, period: int,
                 spill_dir: Optional[str] = None,
                 keep: Optional[int] = None,
                 device_type: str = "cuda"):
        if period <= 0:
            raise ValueError("KernelSampler period must be > 0 "
                             "(0 = off means: do not construct one)")
        self.period = period
        self.device_type = device_type
        self.spill_dir = spill_dir or os.environ.get(SPILL_ENV) or \
            os.path.join(tempfile.gettempdir(), "kafka_torch_kernels")
        try:
            keep = int(os.environ.get(KEEP_ENV, "")) if keep is None \
                else keep
        except ValueError:
            keep = DEFAULT_KEEP
        self.keep = max(1, keep)
        self._step_i = 0
        self._open_dir: Optional[str] = None
        self._prof = None
        self._open_thread: Optional[int] = None
        self._open_modeled: Dict[str, float] = {}
        self._sample_seq = 0
        self.samples_total = 0
        self.sample_failures = 0
        self.last_sample_t: Optional[float] = None
        self._agg_lock = threading.Lock()
        # (kind_label, kernel) -> [count, total_us]
        self._kernels: Dict[Tuple[str, str], List[float]] = {}
        # kind_label -> total device us across samples
        self._kind_us: Dict[str, float] = {}

    # -- engine hooks (engine thread) -----------------------------------

    def on_step_begin(self, metrics: Any) -> None:
        """Called at the top of engine.step: closes the previous
        sample's window (the device work queued behind it has had the
        inter-step gap to land), then opens a new one when the step is
        due."""
        if self._open_dir is not None:
            self._finish_sample(metrics)
        due = self._step_i % self.period == 0
        self._step_i += 1
        if due:
            self._start_sample(metrics)

    def close(self, metrics: Any = None) -> None:
        """Stop any open window (engine shutdown / test teardown)."""
        if self._open_dir is not None:
            self._finish_sample(metrics)

    # -- sampling internals ---------------------------------------------

    def _modeled_by_kind(self, metrics: Any) -> Dict[str, float]:
        try:
            return {k: u.modeled_s for k, u in metrics.util.items()}
        except Exception:
            return {}

    def _start_sample(self, metrics: Any) -> None:
        if not try_acquire_trace():
            return  # an on-demand capture owns the profiler
        d = os.path.join(self.spill_dir,
                         f"sample_{self._sample_seq:06d}")
        self._sample_seq += 1
        try:
            os.makedirs(d, exist_ok=True)
            self._prof = open_profiler(self.device_type)
        except Exception:
            self.sample_failures += 1
            self._prof = None
            release_trace()
            logger.warning("kernel sampler: profiler failed to start",
                           exc_info=True)
            return
        self._open_dir = d
        self._open_thread = threading.get_ident()
        self._open_modeled = self._modeled_by_kind(metrics)

    def _finish_sample(self, metrics: Any) -> None:
        if threading.get_ident() != self._open_thread:
            raise RuntimeError(
                "kernel sampler: a profiler window closes on the thread "
                "that opened it; close() the sampler before stepping the "
                "engine from another thread")
        d, prof = self._open_dir, self._prof
        self._open_dir, self._prof = None, None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(d, "sample.trace.json"))
        except Exception:
            self.sample_failures += 1
            logger.warning("kernel sampler: profiler failed to stop or "
                           "export", exc_info=True)
            release_trace()
            return
        release_trace()
        # the sampled step's dispatch-kind composition, read off the
        # same per-kind modeled-seconds deltas the calibration uses
        deltas: Dict[str, float] = {}
        if metrics is not None:
            after = self._modeled_by_kind(metrics)
            deltas = {
                k: after.get(k, 0.0) - self._open_modeled.get(k, 0.0)
                for k in after
            }
            deltas = {k: v for k, v in deltas.items() if v > 0}
        kinds = "+".join(sorted(deltas)) or "idle"
        kernels = parse_trace_dir(d)
        total_us = sum(dur for _, dur in kernels)
        with self._agg_lock:
            self.samples_total += 1
            self.last_sample_t = time.time()
            for name, dur in kernels:
                slot = self._kernels.setdefault((kinds, name), [0, 0.0])
                slot[0] += 1
                slot[1] += dur
            if total_us > 0:
                self._kind_us[kinds] = self._kind_us.get(
                    kinds, 0.0) + total_us
        # calibration feedback: split the sample's device time across
        # the step's kinds in proportion to their modeled seconds
        modeled_total = sum(deltas.values())
        if metrics is not None and total_us > 0 and modeled_total > 0:
            try:
                for k, v in deltas.items():
                    share = v / modeled_total
                    metrics.record_kernel_sample(
                        k, total_us * 1e-6 * share, v)
            except Exception:  # pragma: no cover - defensive
                logger.warning("kernel calibration failed", exc_info=True)
        self._prune_spill()

    def _prune_spill(self) -> None:
        """Keep the newest ``keep`` raw sample dirs; parsing is done,
        older raw traces are dead weight."""
        try:
            dirs = sorted(glob.glob(
                os.path.join(self.spill_dir, "sample_*")))
            for d in dirs[: max(0, len(dirs) - self.keep)]:
                shutil.rmtree(d, ignore_errors=True)
        except OSError:  # pragma: no cover - best effort
            pass

    # -- export ----------------------------------------------------------

    def table(self, top_k: int = 20) -> List[Dict[str, Any]]:
        """Top-K kernels by total device time, across all samples."""
        with self._agg_lock:
            rows = [
                {
                    "kind": kinds,
                    "kernel": name,
                    "count": int(c),
                    "total_us": round(us, 3),
                    "avg_us": round(us / c, 3) if c else 0.0,
                    "frac": round(
                        us / self._kind_us[kinds], 4)
                    if self._kind_us.get(kinds) else 0.0,
                }
                for (kinds, name), (c, us) in self._kernels.items()
            ]
        rows.sort(key=lambda r: -r["total_us"])
        return rows[: max(1, top_k)]

    def snapshot(self, top_k: int = 20) -> Dict[str, Any]:
        """GET /debug/kernels payload."""
        with self._agg_lock:
            kind_us = {k: round(v, 3)
                       for k, v in self._kind_us.items()}
        return {
            "period": self.period,
            "spill_dir": self.spill_dir,
            "keep": self.keep,
            "samples_total": self.samples_total,
            "sample_failures": self.sample_failures,
            "last_sample_t": self.last_sample_t,
            "device_us_by_kind": kind_us,
            "kernels": self.table(top_k),
        }


def build_from_env(device_type: str = "cuda") -> Optional[KernelSampler]:
    """One sampler per engine when KAFKA_TORCH_PROFILE_SAMPLE > 0, else
    None (the off state)."""
    period = sample_period()
    if period <= 0:
        return None
    return KernelSampler(period, device_type=device_type)
