"""Autoscaler control loop: self-healing dp / role topology.

Counterpart of kafka_tpu/runtime/autoscaler.py (no JAX in either; the
port keeps its own copy, with KAFKA_TORCH_AUTOSCALE* knobs).  A controller
thread polls the provider's ``signals()`` snapshot (``GET
/admin/signals``: window attainment, queue depth and trend, batch
occupancy, per-replica MFU / bandwidth, quarantine state, anomalies, the
per-pool section) and drives ``resize_dp`` /
``DataParallelEngines.rebuild`` to re-shape the dp topology under live
traffic.

Design, in the order the decision function applies it:

* **Decision table** (``decide``, a pure function over one signals
  snapshot + the controller state — unit-testable with synthetic
  snapshots, no engine needed):

  - *scale out* when 1m window attainment collapses under
    ``attain_out`` (with enough window verdicts to mean anything) or the
    queue-depth trend grows past ``trend_out`` req/s, sustained for
    ``sustain_out`` consecutive polls;
  - *scale in* when the fleet is demonstrably idle — attainment holding
    at/above ``attain_in``, empty queue, non-positive trend, occupancy
    and decode MFU/HBM-BW under the idle thresholds — sustained for the
    (much longer) ``sustain_in`` window;
  - *descend the degradation ladder* when scale-out is impossible
    (device budget exhausted, or every replica quarantined);
  - *climb the ladder back* one rung at a time once attainment holds at
    ``attain_in`` for ``sustain_recover`` polls.

* **Hysteresis + cooldowns** (rebuild-cost awareness): a rebuild parks
  the serving worker, so the controller must never flap.  Scale-out and
  scale-in carry separate bands (``attain_out`` < ``attain_in``),
  separate sustain windows, and separate cooldowns
  (``cooldown_out_s`` / ``cooldown_in_s``, measured from the LAST resize
  in either direction) — at most one resize per cooldown window, by
  construction.

* **Vetoes**: while a flight-recorder anomaly is active anywhere, the
  utilization/attainment numbers describe a sick replica, and EVERY
  action holds (the signals contract's "don't scale on stale math"
  rule).  Resizes additionally hold while any replica is on probation
  (it is mid-re-admission; a rebuild would reset the experiment), while
  the server drains, and during cooldown.  Vetoed decisions are recorded
  with the action they blocked.

* **Degradation ladder** — what overload does when scale-out cannot
  happen, descended one rung per decision and climbed back in reverse
  order as attainment recovers:

  1. ``admission_tightened`` — shrink ``EngineConfig.max_waiting`` to a
     quarter (or ``2 x max_batch x dp`` when it was unbounded): excess
     load sheds as honest HTTP 429 + Retry-After at the gate instead of
     queueing into certain SLO misses;
  2. ``speculation_paused`` — ``engine.spec_k_cap = 0``: speculative
     proposals stop (in-flight verify entries drain normally), freeing
     the verify dispatch's compute for guaranteed decode work;
  3. ``background_deferred`` — a process-wide flag the KV tier's demote
     path and the deferred grammar-compile worker consult: background
     D2H copies and table compiles wait until the overload clears.

* **Decision log**: every decision (cause, condensed inputs snapshot,
  action, vetoes, outcome) lands in a bounded ring exported at
  ``GET /admin/autoscaler`` and echoed — condensed — into
  ``/admin/signals`` version 4.  Consecutive identical holds collapse
  into one entry with a count, so the log's history depth is spent on
  transitions, not steady-state noise.

* **Modes** (``KAFKA_TORCH_AUTOSCALE``): ``0``/``off`` (default) builds no
  controller at all — every dispatch and admission path is byte-identical
  to a controller-less build (tested).  ``recommend`` runs the full
  decision loop and log but performs no action (the operator's dry-run:
  watch /admin/autoscaler against live traffic before handing it the
  keys).  ``1``/``act`` closes the loop.

``replay`` drives recorded signals snapshots through this exact
decision function (the reference's scripts/autoscale_sim.py reads the
same snapshots), so the decision table is testable without a card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("kafka_tpu_torch.autoscaler")

MODE_ENV = "KAFKA_TORCH_AUTOSCALE"

MODE_OFF, MODE_RECOMMEND, MODE_ACT = "off", "recommend", "act"

# decision actions
HOLD, SCALE_OUT, SCALE_IN, DEGRADE, RECOVER = (
    "hold", "scale_out", "scale_in", "degrade", "recover",
)
ACTIONS = (HOLD, SCALE_OUT, SCALE_IN, DEGRADE, RECOVER)

# Degradation-ladder rungs in DESCENT order (index == ladder level).
# Climb-back happens in exact reverse: background work resumes first,
# speculation next, the admission bound last — admission is the rung
# that protects clients, so it is the first defense in and the last out.
LADDER_RUNGS = (
    "normal",
    "admission_tightened",
    "speculation_paused",
    "background_deferred",
)
LADDER_MAX = len(LADDER_RUNGS) - 1

DECISION_LOG_CAP = 256

# Counter/gauge keys exported under /metrics "autoscaler" and rendered by
# server/prometheus.py — the registry the tests enforce
# in both directions (mirrors runtime/metrics.AUTOSCALER_METRIC_KEYS).
COUNTER_KEYS = (
    "autoscaler_polls",
    "autoscaler_scale_outs",
    "autoscaler_scale_ins",
    "autoscaler_resize_failures",
    "autoscaler_degrades",
    "autoscaler_recovers",
    "autoscaler_vetoes",
    "autoscaler_drains",
)


def parse_mode(raw: Optional[str]) -> str:
    """KAFKA_TORCH_AUTOSCALE -> mode.  Unknown values log once and stay
    OFF — a typo must never hand a controller the resize keys."""
    v = (raw or "").strip().lower()
    if v in ("", "0", "off", "false", "no", "none"):
        return MODE_OFF
    if v in ("1", "act", "on", "true", "yes"):
        return MODE_ACT
    if v in ("recommend", "dry", "dryrun", "dry-run", "shadow"):
        return MODE_RECOMMEND
    logger.warning("unknown %s=%r; autoscaler stays off", MODE_ENV, raw)
    return MODE_OFF


# ---------------------------------------------------------------------------
# background-work deferral (ladder rung 3)
# ---------------------------------------------------------------------------

# Process-wide flag, default False: with the autoscaler off (or the
# ladder above rung 3) every consulting site reads one module bool and
# proceeds exactly as before — the KAFKA_TORCH_AUTOSCALE=0 bit-identity
# contract.  Consumers: runtime/kv_tier.KVTierManager.demote (falls back
# to plain eviction) and llm/constrained._defer_worker (holds queued
# grammar compiles).
_BACKGROUND_DEFERRED = False


def background_deferred() -> bool:
    return _BACKGROUND_DEFERRED


def set_background_deferred(on: bool) -> None:
    global _BACKGROUND_DEFERRED
    if on != _BACKGROUND_DEFERRED:
        logger.warning(
            "background work %s (autoscaler degradation ladder)",
            "DEFERRED" if on else "resumed",
        )
    _BACKGROUND_DEFERRED = bool(on)


# ---------------------------------------------------------------------------
# configuration + controller state
# ---------------------------------------------------------------------------


def _env(name: str, default, cast):
    raw = os.environ.get(f"KAFKA_TORCH_AUTOSCALE_{name}")
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        logger.warning("bad KAFKA_TORCH_AUTOSCALE_%s=%r; using %r",
                       name, raw, default)
        return default


@dataclasses.dataclass
class AutoscalerConfig:
    """Control-loop knobs (env: KAFKA_TORCH_AUTOSCALE_* — see from_env)."""

    mode: str = MODE_OFF
    interval_s: float = 2.0        # signal poll cadence
    min_dp: int = 1
    max_dp: Optional[int] = None   # None = device budget (resolved at attach)
    # hysteresis bands: out-threshold strictly below in-threshold so a
    # recovering fleet cannot oscillate between the two verdicts
    attain_out: float = 0.90       # scale out when attainment_1m sags below
    attain_in: float = 0.98        # recovery / scale-in requires at least
    trend_out: float = 0.5         # queue growth (waiting/s) = overload
    idle_occupancy: float = 0.25   # occupancy_frac below = idle candidate
    idle_mfu: float = 0.05         # decode mfu_1m/hbm_1m below = idle
    sustain_out: int = 2           # consecutive overloaded polls to act
    sustain_in: int = 5            # consecutive idle polls to scale in
    sustain_recover: int = 3       # consecutive recovered polls to climb
    cooldown_out_s: float = 30.0   # min gap after ANY resize before out
    cooldown_in_s: float = 120.0   # min gap after ANY resize before in
    ladder_cooldown_s: float = 10.0
    min_window_requests: int = 3   # 1m verdicts needed to trust attainment
    resize_drain_s: float = 10.0   # drain budget handed to resize_dp

    @classmethod
    def from_env(cls, **overrides) -> "AutoscalerConfig":
        cfg = cls(
            mode=parse_mode(os.environ.get(MODE_ENV)),
            interval_s=max(0.1, _env("INTERVAL_S", cls.interval_s, float)),
            min_dp=max(1, _env("MIN_DP", cls.min_dp, int)),
            max_dp=_env("MAX_DP", None, int),
            attain_out=_env("ATTAIN_OUT", cls.attain_out, float),
            attain_in=_env("ATTAIN_IN", cls.attain_in, float),
            trend_out=_env("TREND_OUT", cls.trend_out, float),
            idle_occupancy=_env("IDLE_OCCUPANCY", cls.idle_occupancy,
                                float),
            idle_mfu=_env("IDLE_MFU", cls.idle_mfu, float),
            sustain_out=max(1, _env("SUSTAIN_OUT", cls.sustain_out, int)),
            sustain_in=max(1, _env("SUSTAIN_IN", cls.sustain_in, int)),
            sustain_recover=max(1, _env("SUSTAIN_RECOVER",
                                        cls.sustain_recover, int)),
            cooldown_out_s=_env("COOLDOWN_OUT_S", cls.cooldown_out_s,
                                float),
            cooldown_in_s=_env("COOLDOWN_IN_S", cls.cooldown_in_s, float),
            ladder_cooldown_s=_env("LADDER_COOLDOWN_S",
                                   cls.ladder_cooldown_s, float),
            min_window_requests=max(1, _env("MIN_WINDOW_REQUESTS",
                                            cls.min_window_requests, int)),
            resize_drain_s=_env("RESIZE_DRAIN_S", cls.resize_drain_s,
                                float),
        )
        return dataclasses.replace(cfg, **overrides)


@dataclasses.dataclass
class ControllerState:
    """Mutable control-loop state decide() reads AND updates (the sustain
    counters are part of the decision table: an overload verdict needs
    `sustain_out` consecutive polls, so the counters travel with the
    state, not hidden module globals)."""

    overload_polls: int = 0
    idle_polls: int = 0
    recover_polls: int = 0
    pressure_polls: int = 0       # consecutive polls with hbm_pressure
    ladder: int = 0               # current degradation rung (0 = normal)
    last_resize_t: Optional[float] = None   # monotonic, either direction
    last_ladder_t: Optional[float] = None


@dataclasses.dataclass
class Decision:
    """One control-loop verdict (the decision-log payload minus outcome)."""

    action: str
    cause: str
    dp: int
    dp_target: Optional[int] = None
    roles_target: Optional[str] = None   # role-pool spec, pools only
    ladder_target: Optional[int] = None
    vetoes: List[str] = dataclasses.field(default_factory=list)
    intended: Optional[str] = None       # the action a veto blocked
    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, [])}


# ---------------------------------------------------------------------------
# the decision table
# ---------------------------------------------------------------------------


def _role_pools(snap: Dict[str, Any]) -> Optional[Dict[str, Dict]]:
    """{"prefill": pool, "decode": pool} when role pools are configured,
    else None (a single "colocated" pool is not independently sizable)."""
    pools = {p.get("role"): p for p in snap.get("pools") or []}
    if "prefill" in pools and "decode" in pools:
        return pools
    return None


def _pool_pressure(pool: Dict[str, Any]) -> float:
    """Queue depth per replica — the comparable pressure figure the
    grow/shrink choice keys on (occupancy breaks ties implicitly: a
    saturated pool queues)."""
    n = max(1, len(pool.get("replicas") or []))
    return (pool.get("queue_depth", 0) or 0) / n


def _grow_roles(pools: Dict[str, Dict]) -> str:
    p = len(pools["prefill"].get("replicas") or []) or 1
    d = len(pools["decode"].get("replicas") or []) or 1
    if _pool_pressure(pools["prefill"]) > _pool_pressure(pools["decode"]):
        p += 1
    else:
        d += 1
    return f"prefill:{p},decode:{d}"


def _shrink_roles(pools: Dict[str, Dict]) -> Optional[str]:
    p = len(pools["prefill"].get("replicas") or []) or 1
    d = len(pools["decode"].get("replicas") or []) or 1
    if p + d <= 2:
        return None  # both pools at their floor: nothing to shrink
    # shrink the LESS pressured pool, never below one replica
    if p > 1 and (_pool_pressure(pools["prefill"])
                  <= _pool_pressure(pools["decode"]) or d <= 1):
        p -= 1
    else:
        d -= 1
    return f"prefill:{p},decode:{d}"


def condense(snap: Dict[str, Any]) -> Dict[str, Any]:
    """The inputs snapshot a decision-log entry carries: enough to replay
    WHY, small enough to keep 256 of."""
    slo = snap.get("slo") or {}
    queue = snap.get("queue") or {}
    batch = snap.get("batch") or {}
    util = (snap.get("utilization") or {}).get("decode") or {}
    states: Dict[str, int] = {}
    for r in snap.get("replicas") or []:
        s = r.get("state", "healthy")
        states[s] = states.get(s, 0) + 1
    out = {
        "attainment_1m": slo.get("slo_attainment_1m"),
        "window_1m_requests": slo.get("window_1m_requests"),
        "queue_depth": queue.get("depth"),
        "queue_trend_per_s": queue.get("trend_per_s"),
        "occupancy_frac": batch.get("occupancy_frac"),
        "decode_mfu_1m": util.get("mfu_1m"),
        "decode_hbm_bw_util_1m": util.get("hbm_bw_util_1m"),
        "anomalies_active": (snap.get("anomalies") or {}).get(
            "anomalies_active", 0
        ),
        # device-truth inputs (version-7 feeds); None/0 on
        # older feeds or when the observatory/monitor is off
        "compile_storm_active": bool(
            (snap.get("compiles") or {}).get("storm_active")
        ),
        "hbm_pressure": int(
            (snap.get("memory") or {}).get("pressure") or 0
        ),
        "replica_states": states,
    }
    pools = _role_pools(snap)
    if pools:
        out["pools"] = {
            role: {"replicas": len(p.get("replicas") or []),
                   "queue_depth": p.get("queue_depth", 0)}
            for role, p in pools.items()
        }
    return out


def decide(snap: Dict[str, Any], state: ControllerState,
           cfg: AutoscalerConfig, now: float) -> Decision:
    """One control-loop verdict from one signals snapshot.

    Pure over (snapshot, state, config, clock): the only side effect is
    updating the sustain counters inside `state` (they ARE decision-table
    state — see ControllerState).  The unit matrix in
    tests drive this directly with synthetic snapshots; the controller
    thread and `replay` both call exactly this function, so the table
    cannot drift between the live loop and a replay."""
    dp = int(snap.get("dp", 1))
    slo = snap.get("slo") or {}
    queue = snap.get("queue") or {}
    batch = snap.get("batch") or {}
    util = (snap.get("utilization") or {}).get("decode") or {}

    attain = slo.get("slo_attainment_1m")
    attain = 1.0 if attain is None else float(attain)
    wr = slo.get("window_1m_requests")  # version-4 field; None on v3 feeds
    samples_ok = wr is None or wr >= cfg.min_window_requests
    depth = int(queue.get("depth") or 0)
    trend = float(queue.get("trend_per_s") or 0.0)
    occ = float(batch.get("occupancy_frac") or 0.0)
    busy_1m = max(float(util.get("mfu_1m") or 0.0),
                  float(util.get("hbm_bw_util_1m") or 0.0))

    attain_collapse = samples_ok and attain < cfg.attain_out
    queue_growth = trend > cfg.trend_out and depth > 0
    overloaded = attain_collapse or queue_growth
    recovered = (not overloaded) and attain >= cfg.attain_in
    idle = (
        recovered
        and depth == 0
        and trend <= 0.0
        and occ <= cfg.idle_occupancy
        and busy_1m <= cfg.idle_mfu
    )

    states = [r.get("state", "healthy")
              for r in snap.get("replicas") or []]
    anomalies_active = int(
        (snap.get("anomalies") or {}).get("anomalies_active", 0) or 0
    )
    # device-truth inputs
    compile_storm = bool((snap.get("compiles") or {}).get("storm_active"))
    hbm_pressure = bool((snap.get("memory") or {}).get("pressure"))
    all_quarantined = bool(states) and all(
        s == "quarantined" for s in states
    )
    any_probation = any(s == "probation" for s in states)
    any_quarantined = any(s == "quarantined" for s in states)

    # sustain counters: consecutive-poll evidence, reset the moment the
    # classification flips (hysteresis leg one; the bands are leg two)
    state.overload_polls = state.overload_polls + 1 if overloaded else 0
    state.idle_polls = state.idle_polls + 1 if idle else 0
    state.recover_polls = (
        state.recover_polls + 1 if (recovered and state.ladder > 0) else 0
    )
    state.pressure_polls = (
        state.pressure_polls + 1 if hbm_pressure else 0
    )

    d = Decision(action=HOLD, cause="steady", dp=dp, inputs=condense(snap))
    pools = _role_pools(snap)
    max_dp = cfg.max_dp if cfg.max_dp is not None else 1 << 30
    min_dp = max(cfg.min_dp, 2 if pools else 1)

    if overloaded and state.overload_polls >= cfg.sustain_out:
        cause = "attainment_collapse" if attain_collapse else "queue_growth"
        if dp < max_dp and not all_quarantined:
            d.action = SCALE_OUT
            d.cause = cause
            d.dp_target = dp + 1
            if pools:
                d.roles_target = _grow_roles(pools)
        elif state.ladder < LADDER_MAX:
            d.action = DEGRADE
            d.cause = cause + (":all_quarantined" if all_quarantined
                               else ":max_dp")
            d.ladder_target = state.ladder + 1
        else:
            d.cause = "saturated"  # capped AND at the ladder floor
    elif (
        hbm_pressure
        and state.pressure_polls >= cfg.sustain_out
        and state.ladder < LADDER_MAX
    ):
        # measured HBM headroom under the watermark: the next
        # allocation may OOM the device, so shed load NOW regardless of
        # SLO attainment — more replicas would not shrink this replica's
        # working set, only the ladder can
        d.action = DEGRADE
        d.cause = "hbm_pressure"
        d.ladder_target = state.ladder + 1
    elif (state.ladder > 0 and state.recover_polls >= cfg.sustain_recover
          and not hbm_pressure):
        # a rung applied for hbm_pressure must not climb back while the
        # headroom is still under water, however healthy the SLO looks
        d.action = RECOVER
        d.cause = "attainment_recovered"
        d.ladder_target = state.ladder - 1
    elif (
        idle
        and state.idle_polls >= cfg.sustain_in
        and dp > min_dp
        and state.ladder == 0
    ):
        d.action = SCALE_IN
        d.cause = "idle"
        d.dp_target = dp - 1
        if pools:
            d.roles_target = _shrink_roles(pools)
            if d.roles_target is None:  # pools at floor: cannot shrink
                d.action = HOLD
                d.cause = "idle_pools_at_floor"
                d.dp_target = None
    elif overloaded:
        d.cause = "overload_pending"
    elif idle:
        d.cause = "idle_pending"
    elif state.ladder > 0:
        d.cause = "degraded_awaiting_recovery"

    # vetoes — evaluated only against a would-be action, recorded with it
    if d.action != HOLD:
        if anomalies_active > 0:
            # the signals contract's rule: active anomaly = the numbers
            # describe a sick replica; EVERY action holds
            d.vetoes.append("anomaly_active")
        if snap.get("draining"):
            d.vetoes.append("draining")
        if d.action in (SCALE_OUT, SCALE_IN):
            if compile_storm:
                # the server is compiling under live traffic: the
                # latency the controller would act on measures the
                # compiler, not capacity — and a rebuild would ADD a
                # cold engine's compiles on top.  Named separately from
                # anomaly_active so the decision log shows the cause
                # even when the flight recorder is off.
                d.vetoes.append("compile_storm")
            if any_probation:
                # a probation replica is mid-re-admission; a rebuild
                # would reset the experiment (and flap)
                d.vetoes.append("replica_probation")
            if d.action == SCALE_IN and any_quarantined:
                d.vetoes.append("replica_quarantined")
            cool = (cfg.cooldown_out_s if d.action == SCALE_OUT
                    else cfg.cooldown_in_s)
            if (state.last_resize_t is not None
                    and now - state.last_resize_t < cool):
                d.vetoes.append("cooldown")
        else:  # ladder moves pace themselves too (one rung per window)
            if (state.last_ladder_t is not None
                    and now - state.last_ladder_t < cfg.ladder_cooldown_s):
                d.vetoes.append("ladder_cooldown")
    if d.vetoes:
        d.intended = d.action
        d.action = HOLD
    return d


# ---------------------------------------------------------------------------
# degradation ladder actuation
# ---------------------------------------------------------------------------


class DegradationLadder:
    """Applies/reverts the overload rungs on a live provider.

    Every mutation is a GIL-atomic attribute store the engine thread
    reads at its own cadence (the repo's standard cross-thread counter
    tolerance); `reassert()` re-stamps per-engine effects after a
    topology rebuild replaced the engine objects."""

    def __init__(self, provider: Any):
        self.provider = provider
        self.level = 0
        self._saved_max_waiting: Optional[int] = None

    def _engines(self) -> List[Any]:
        replicas = getattr(self.provider, "_replicas", None)
        if replicas is not None:
            return list(replicas())
        engine = getattr(self.provider, "engine", self.provider)
        return list(getattr(engine, "engines", [engine]))

    def apply(self, level: int) -> None:
        level = max(0, min(LADDER_MAX, int(level)))
        while self.level < level:
            self._set(self.level + 1, True)
        while self.level > level:
            self._set(self.level, False)

    def reassert(self) -> None:
        """Re-stamp per-engine rung effects (idempotent): a resize built
        fresh engine objects whose spec caps start unthrottled."""
        if self.level >= 2:
            for e in self._engines():
                e.spec_k_cap = 0

    def _set(self, rung: int, on: bool) -> None:
        engines = self._engines()
        ecfg = engines[0].ecfg
        if rung == 1:
            if on:
                self._saved_max_waiting = ecfg.max_waiting
                base = ecfg.max_waiting
                # 0 = unbounded: bound it near the fleet's in-flight
                # capacity so the queue stops absorbing certain misses
                ecfg.max_waiting = (
                    max(1, base // 4) if base > 0
                    else max(2, 2 * ecfg.max_batch * len(engines))
                )
            else:
                if self._saved_max_waiting is not None:
                    ecfg.max_waiting = self._saved_max_waiting
                self._saved_max_waiting = None
        elif rung == 2:
            for e in engines:
                e.spec_k_cap = 0 if on else None
        elif rung == 3:
            set_background_deferred(on)
        self.level = rung if on else rung - 1
        logger.warning(
            "degradation ladder %s rung %d (%s)",
            "descended to" if on else "climbed off",
            rung, LADDER_RUNGS[rung],
        )


def _device_budget_dp(engine: Any) -> int:
    """The dp ceiling the device set allows (1 for a single,
    non-resizable engine)."""
    devices = getattr(engine, "_devices", None)
    if devices is None or not hasattr(engine, "rebuild"):
        return len(getattr(engine, "engines", [engine]))
    per = (getattr(engine, "_tp", 1) * getattr(engine, "_sp", 1)
           * getattr(engine, "_ep", 1))
    return max(1, len(devices) // max(1, per))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


class AutoscalerController:
    """The control loop: poll signals(), decide, act, record.

    `provider` is anything exposing ``signals()`` (TorchLLMProvider; tests
    and the bench use a thin shim over DataParallelEngines).  Actuation
    goes through `resize_fn(dp, roles)` when injected, else through
    ``provider.resize_dp`` scheduled onto the asyncio loop handed to
    ``start()``.  `clock` is injectable for deterministic tests; every
    cooldown uses it.  A provider-less controller (scripts/
    replay) runs the decision table only."""

    def __init__(
        self,
        provider: Optional[Any] = None,
        cfg: Optional[AutoscalerConfig] = None,
        *,
        resize_fn: Optional[Callable[[int, Optional[str]], Any]] = None,
        is_draining: Optional[Callable[[], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg or AutoscalerConfig.from_env()
        self.provider = provider
        self._resize_fn = resize_fn
        self._is_draining = is_draining
        self._clock = clock
        self._loop: Optional[Any] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # decisions + counters are written by the controller thread and
        # read by HTTP handlers; one lock at poll cadence is noise
        self._lock = threading.Lock()
        self.state = ControllerState()
        self.decisions: "deque[Dict[str, Any]]" = deque(
            maxlen=DECISION_LOG_CAP
        )
        self._seq = 0
        self.counters: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}
        self._last_dp = 0
        self.ladder = (
            DegradationLadder(provider) if provider is not None else None
        )
        if provider is not None:
            engine = getattr(provider, "engine", None)
            if self.cfg.max_dp is None and engine is not None:
                # resolve the device-budget ceiling once: a controller
                # must know "scale-out is impossible" to pick the ladder
                self.cfg.max_dp = _device_budget_dp(engine)
            # the provider echoes the controller into /admin/signals v4
            provider.autoscaler = self

    # -- lifecycle -------------------------------------------------------

    def start(self, loop: Optional[Any] = None) -> "AutoscalerController":
        if self._thread is not None:
            return self
        self._loop = loop
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="kafka-torch-autoscaler", daemon=True
        )
        self._thread.start()
        logger.info(
            "autoscaler started (mode=%s interval=%.1fs dp=[%d,%s])",
            self.cfg.mode, self.cfg.interval_s, self.cfg.min_dp,
            self.cfg.max_dp,
        )
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the controller thread and climb off any applied ladder
        rungs.  BLOCKS in join(): callers on the event loop the
        controller schedules resizes onto (server/app._cleanup) must run
        this in an executor, or an in-flight resize_dp coroutine can
        never progress and the join always times out."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                # an in-flight resize outlived the join budget: leave the
                # ladder alone — restoring it here would race the live
                # thread's own ladder writes
                logger.warning(
                    "autoscaler thread still busy after %.1fs (resize "
                    "in flight?); skipping ladder restore", timeout,
                )
                return
            self._thread = None
        # never leave the fleet degraded behind a dead controller: the
        # ladder rungs only make sense while something can climb back up
        if (self.ladder is not None and self.cfg.mode == MODE_ACT
                and self.ladder.level > 0):
            try:
                self.ladder.apply(0)
            except Exception:  # pragma: no cover - defensive teardown
                logger.exception("ladder restore on stop failed")

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.poll_once()
            except Exception:
                # one bad poll (snapshot race, resize refusal) must not
                # kill the loop — the next interval retries from scratch
                logger.exception("autoscaler poll failed")
            self._stop_evt.wait(self.cfg.interval_s)

    # -- one control-loop iteration --------------------------------------

    def poll_once(self, now: Optional[float] = None,
                  snap: Optional[Dict[str, Any]] = None) -> Decision:
        now = self._clock() if now is None else now
        if snap is None:
            snap = self.provider.signals()
        if "draining" not in snap and self._is_draining is not None:
            snap = dict(snap)
            snap["draining"] = bool(self._is_draining())
        self.counters["autoscaler_polls"] += 1
        self._last_dp = int(snap.get("dp", self._last_dp) or 0)
        decision = decide(snap, self.state, self.cfg, now)
        if (self.cfg.mode == MODE_ACT and self.ladder is not None
                and self.state.ladder > 0):
            self.ladder.reassert()
        outcome = self._execute(decision, now)
        self._record(decision, now, outcome)
        return decision

    def _execute(self, d: Decision, now: float) -> Optional[str]:
        if d.action == HOLD:
            if d.vetoes:
                self.counters["autoscaler_vetoes"] += 1
                return "held"
            return None
        if d.action in (SCALE_OUT, SCALE_IN):
            # the attempt itself re-arms the cooldown (both modes, and
            # failed attempts too): the one-resize-per-window invariant
            # is about rebuild COST, which a failed drain also pays
            self.state.last_resize_t = now
            self.state.overload_polls = 0
            self.state.idle_polls = 0
            if self.cfg.mode != MODE_ACT:
                return "recommend_only"
            try:
                clean = self._resize(d.dp_target, d.roles_target)
            except Exception as e:
                self.counters["autoscaler_resize_failures"] += 1
                logger.exception("autoscaler resize to dp=%s failed",
                                 d.dp_target)
                return f"error:{e}"
            key = ("autoscaler_scale_outs" if d.action == SCALE_OUT
                   else "autoscaler_scale_ins")
            self.counters[key] += 1
            logger.warning(
                "autoscaler %s: dp %d -> %d%s (%s)", d.action, d.dp,
                d.dp_target,
                f" roles={d.roles_target}" if d.roles_target else "",
                d.cause,
            )
            return "resized" if clean in (True, None) else "resized:unclean"
        # ladder moves: state.ladder IS the recommended level; actuation
        # only in act mode (recommend traces the full descent/climb)
        self.state.last_ladder_t = now
        self.state.overload_polls = 0
        self.state.recover_polls = 0
        self.state.ladder = int(d.ladder_target or 0)
        self.counters[
            "autoscaler_degrades" if d.action == DEGRADE
            else "autoscaler_recovers"
        ] += 1
        if self.cfg.mode != MODE_ACT or self.ladder is None:
            return "recommend_only"
        try:
            self.ladder.apply(self.state.ladder)
        except Exception as e:
            logger.exception("degradation ladder apply(%d) failed",
                             self.state.ladder)
            return f"error:{e}"
        return "applied"

    def _object_tier_enabled(self) -> bool:
        if self.ladder is None:
            return False
        try:
            for e in self.ladder._engines():
                tier = getattr(e, "kv_tier", None)
                if tier is not None and getattr(tier, "object",
                                                None) is not None:
                    return True
        except Exception:  # pragma: no cover - provider shim variance
            pass
        return False

    def _object_store_available(self) -> bool:
        """False when any replica's store guard reports an OPEN breaker:
        the pre-scale-in drain would only burn the drain window failing
        every put, so the resize proceeds immediately — capacity beats
        warm state, and the skipped state re-prefills on wake."""
        if self.ladder is None:
            return True
        try:
            for e in self.ladder._engines():
                obj = getattr(getattr(e, "kv_tier", None), "object", None)
                if obj is not None and not obj.available():
                    return False
        except Exception:  # pragma: no cover - provider shim variance
            pass
        return True

    def _drain_before_shrink(self) -> None:
        """Drain-then-shrink: before a scale-in, flush EVERY
        replica's warm KV state to the shared object store — the rebuild
        recreates the whole replica set, so survivors' radix trees are
        discarded too, not just the removed tail's; dormant threads then
        wake on the new topology instead of re-prefilling.  Scale-OUT
        deliberately skips the drain: it fires under overload, where
        adding capacity NOW beats preserving warm state behind a parked
        worker (organic archives still cover whatever the ladder had
        already pushed past disk).  Best-effort — a failed drain must
        never block the resize the attainment math asked for (the cost
        is warm state, not correctness)."""
        drain = getattr(self.provider, "drain_replicas", None)
        if (
            drain is None or self._loop is None
            or not self._object_tier_enabled()
        ):
            return
        if not self._object_store_available():
            logger.warning(
                "object store breaker open; skipping pre-scale-in drain "
                "(capacity beats warm state — dormant threads re-prefill)",
            )
            return
        import asyncio

        try:
            fut = asyncio.run_coroutine_threadsafe(
                drain(range(self._last_dp)), self._loop
            )
            all_stats = fut.result(
                timeout=self.cfg.resize_drain_s + 60.0
            )
            self.counters["autoscaler_drains"] += len(all_stats)
            logger.warning(
                "autoscaler drained %d replica(s) to the object store "
                "before scale-in (%s)", len(all_stats), all_stats,
            )
        except Exception:
            logger.exception(
                "pre-scale-in drain failed; shrinking anyway (warm "
                "state re-prefills)",
            )

    def _resize(self, dp: int, roles: Optional[str]) -> Any:
        if (
            self.provider is not None
            and self._last_dp
            and dp < self._last_dp
        ):
            self._drain_before_shrink()
        if self._resize_fn is not None:
            return self._resize_fn(dp, roles)
        if self.provider is None or self._loop is None:
            raise RuntimeError(
                "no resize path: inject resize_fn or start(loop=...)"
            )
        import asyncio

        kwargs: Dict[str, Any] = {
            "drain_timeout_s": self.cfg.resize_drain_s,
        }
        if roles is not None:
            kwargs["roles"] = roles
        fut = asyncio.run_coroutine_threadsafe(
            self.provider.resize_dp(dp, **kwargs), self._loop
        )
        return fut.result(timeout=self.cfg.resize_drain_s * 3 + 60.0)

    def _record(self, d: Decision, now: float,
                outcome: Optional[str]) -> None:
        entry = {
            "seq": self._seq,
            "t": round(time.time(), 3),
            **d.to_dict(),
            "ladder": self.state.ladder,
            "outcome": outcome,
            "count": 1,
        }
        with self._lock:
            self._seq += 1
            last = self.decisions[-1] if self.decisions else None
            if (
                last is not None
                and d.action == HOLD
                and last.get("action") == HOLD
                and last.get("cause") == entry.get("cause")
                and last.get("vetoes") == entry.get("vetoes")
                and last.get("intended") == entry.get("intended")
            ):
                # steady-state holds collapse: history depth is spent on
                # transitions, not one row per poll of "steady"
                last["count"] += 1
                last["t_last"] = entry["t"]
                last["inputs"] = entry["inputs"]
                return
            self.decisions.append(entry)

    # -- export ----------------------------------------------------------

    def replay(self, snaps: List[Dict[str, Any]],
               interval_s: Optional[float] = None) -> List[Decision]:
        """Drive recorded signals snapshots through the decision table at
        a synthetic clock.  Never actuates:
        the controller must be provider-less or in recommend mode."""
        if self.cfg.mode == MODE_ACT and self.provider is not None:
            raise ValueError("replay only runs provider-less or in "
                             "recommend mode")
        dt = self.cfg.interval_s if interval_s is None else interval_s
        now = 0.0
        out = []
        for snap in snaps:
            out.append(self.poll_once(now=now, snap=snap))
            now += dt
        return out

    def metrics_section(self) -> Dict[str, Any]:
        """The /metrics "autoscaler" section
        (runtime/metrics.AUTOSCALER_METRIC_KEYS)."""
        out = dict(self.counters)
        out["autoscaler_ladder_level"] = self.state.ladder
        out["autoscaler_dp"] = self._last_dp
        return out

    def _cooldowns(self, now: Optional[float] = None) -> Dict[str, float]:
        now = self._clock() if now is None else now
        last = self.state.last_resize_t

        def remain(cool: float) -> float:
            if last is None:
                return 0.0
            return round(max(0.0, cool - (now - last)), 1)

        return {
            "scale_out_remaining_s": remain(self.cfg.cooldown_out_s),
            "scale_in_remaining_s": remain(self.cfg.cooldown_in_s),
        }

    def signals_section(self) -> Dict[str, Any]:
        """The condensed echo in /admin/signals version 4."""
        with self._lock:
            last = dict(self.decisions[-1]) if self.decisions else None
        if last is not None:
            last.pop("inputs", None)
        return {
            "mode": self.cfg.mode,
            "ladder_level": self.state.ladder,
            "ladder_rung": LADDER_RUNGS[self.state.ladder],
            "cooldown": self._cooldowns(),
            "decisions_logged": self._seq,
            "last_decision": last,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The full GET /admin/autoscaler payload."""
        with self._lock:
            decisions = [dict(e) for e in self.decisions]
        return {
            "mode": self.cfg.mode,
            "config": dataclasses.asdict(self.cfg),
            "state": {
                "ladder_level": self.state.ladder,
                "ladder_rung": LADDER_RUNGS[self.state.ladder],
                "overload_polls": self.state.overload_polls,
                "idle_polls": self.state.idle_polls,
                "recover_polls": self.state.recover_polls,
                "cooldown": self._cooldowns(),
            },
            "counters": self.metrics_section(),
            "ladder_rungs": list(LADDER_RUNGS),
            "decisions": decisions,
        }
