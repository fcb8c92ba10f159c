"""Data-parallel serving: request routing across engine replicas, with
per-replica fault supervision and disaggregated prefill/decode.

Counterpart of kafka_tpu/runtime/dp_router.py.  `DataParallelEngines`
builds dp independent engines — each with its own KV pool, prefix cache
and decode graphs — over a list of replica slots, one `torch.device` per
slot.  A device may appear more than once: replicas that share a card
share the weight tensors (`Tensor.to` on the same device returns the
same storage) and run on the card's current stream, one after another,
driven by one thread.  The router:

* sends requests with a `prefix_key` (thread id) where the longest cached
  prefix lives, with the thread's affinity pin as the tiebreak, so a
  warm thread stays on its replica and a cold thread with a shared
  system prompt lands where it is already cached; a balance guard lets
  load win when prefix gravity would pile more than a batch onto one
  replica;
* sends unkeyed requests to the least-loaded replica (active + waiting +
  parked).

**Replica supervision** (crash-only serving): each replica has a health
record.  A step() failure counts against it; `quarantine_threshold`
consecutive failures trip a circuit breaker — the replica gets no traffic
and no steps, its WAITING requests migrate to healthy replicas, and
affinity pins re-steer on next use; healthy replicas keep their in-flight
work untouched.  After a backoff window (doubling per trip) the replica
re-enters on PROBATION: one failure re-trips it, `probation_steps` clean
steps make it healthy.  If every replica is quarantined the one closest
to re-admission is force-probated.  Past `rebuild_threshold` trips the
replica's engine is rebuilt from scratch instead of re-admitted.

**Disaggregated prefill/decode** (``KAFKA_TORCH_DP_ROLES``,
"prefill:P,decode:D"): the decode pool is every thread's home; a keyed
request whose uncached span is at least
``KAFKA_TORCH_DISAGG_MIN_PREFILL_TOKENS`` prefills on a prefill replica
as a hand-off.  Its first token ends the prefill there (the engine stores
the run in its radix cache and parks the request on `engine.handoffs`);
the router ships the whole-page run into the decode home's pool
(runtime/kv_tier.CrossReplicaPageShipper), registers it in that
replica's radix cache as a shipped run, and requeues the request there,
where its first lookup reads ``cache_source="shipped"`` and nothing is
re-prefilled.  Every failure of the ship degrades to a re-prefill.

`rebuild(dp=...)` re-creates the replica set at a different dp count
while WAITING requests survive (the /admin/resize story).  The object
mirrors the single-engine surface the serving worker uses (submit /
cancel / step / has_work / metrics / _requests), so llm/worker.EngineWorker
drives it unchanged.

Tensor, sequence and expert parallelism inside a replica (tp / sp / ep >
1: dp x tp, dp x ep) and replicas across hosts are not ported (ROADMAP
A9); tp and ep run at dp 1, in one engine's rank group.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig
from ..tracing import add_event
from .engine import (
    FINISHED,
    EngineConfig,
    GenRequest,
    InferenceEngine,
    TokenEvent,
)
from .kv_cache import OutOfPagesError
from .metrics import DisaggMetrics, ReplicaSupervisorMetrics

logger = logging.getLogger("kafka_tpu_torch.dp")

QUARANTINE_THRESHOLD_ENV = "KAFKA_TORCH_REPLICA_QUARANTINE_THRESHOLD"
# after this many quarantine trips the supervisor rebuilds the replica's
# engine at window expiry instead of re-admitting it (0 disables; 3)
REBUILD_THRESHOLD_ENV = "KAFKA_TORCH_REPLICA_REBUILD_THRESHOLD"
# "prefill:P,decode:D" splits the fleet into role pools (P + D == dp);
# unset = colocated
DP_ROLES_ENV = "KAFKA_TORCH_DP_ROLES"
# prompts whose uncached span is below this many tokens prefill in place
# on the decode pool: shipping must never cost more than it saves
MIN_PREFILL_ENV = "KAFKA_TORCH_DISAGG_MIN_PREFILL_TOKENS"

HEALTHY, PROBATION, QUARANTINED = "healthy", "probation", "quarantined"

# rebuild() `roles` default: keep the current spec (re-derived for the
# new dp).  Distinct from None, which dissolves the pools.
_ROLES_KEEP = object()


def parse_dp_roles(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse ``KAFKA_TORCH_DP_ROLES`` ("prefill:2,decode:6") into
    (n_prefill, n_decode).  None/"" = colocated (no pools).  Repeated
    role entries add; both pools must end up non-empty."""
    if not spec:
        return None
    counts = {"prefill": 0, "decode": 0}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, _, n = part.partition(":")
        role = role.strip().lower()
        if role not in counts:
            raise ValueError(
                f"unknown pool role {role!r} in {spec!r} (expected "
                "'prefill:P,decode:D')")
        try:
            counts[role] += int(n)
        except ValueError:
            raise ValueError(f"bad replica count in {spec!r}")
    if counts["prefill"] <= 0 or counts["decode"] <= 0:
        raise ValueError(
            f"{spec!r} needs at least one prefill and one decode replica")
    return counts["prefill"], counts["decode"]


def validate_roles_spec(roles: Optional[str],
                        dp: int) -> Optional[Tuple[int, int]]:
    """parse_dp_roles plus the P + D == dp rule: the one check both
    resize_dp's pre-drain validation and rebuild() apply, so the early
    check never passes a spec the rebuild rejects after work was
    cancelled."""
    spec = parse_dp_roles(roles or None)
    if spec is not None and sum(spec) != dp:
        raise ValueError(
            f"roles {roles!r} names {sum(spec)} replicas but dp={dp}")
    return spec


def default_replica_devices() -> List[torch.device]:
    """One replica slot per visible card; raises without CUDA (the
    port's entry points never fall back to the CPU unasked)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass devices=[torch.device('cpu'), "
            "...] explicitly to run replicas on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class ReplicaHealth:
    """One replica's supervision record (engine-thread single-writer)."""

    state: str = HEALTHY
    consecutive_failures: int = 0
    total_failures: int = 0
    quarantine_count: int = 0  # trips so far (drives backoff doubling)
    quarantined_until: float = 0.0  # monotonic deadline of the window
    probation_successes: int = 0

    @property
    def routable(self) -> bool:
        return self.state != QUARANTINED

    def gauge(self) -> float:
        """Numeric health for /metrics: 1 healthy, 0.5 probation, 0 out."""
        return {HEALTHY: 1.0, PROBATION: 0.5, QUARANTINED: 0.0}[self.state]


class DataParallelEngines:
    """dp engine replicas over replica slots + the request router."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        engine_cfg: EngineConfig,
        dp: int,
        tp: int = 1,
        sp: int = 1,
        ep: int = 1,
        kv_dtype: Optional[torch.dtype] = None,
        devices: Optional[Sequence[Any]] = None,
        quarantine_threshold: Optional[int] = None,
        quarantine_window_s: float = 5.0,
        probation_steps: int = 3,
        rebuild_threshold: Optional[int] = None,
        dp_roles: Optional[str] = None,
        disagg_min_prefill_tokens: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """devices: one entry per replica slot (a device may repeat);
        None = one slot per visible card, raising without CUDA.  clock:
        the supervision clock (quarantine windows); tests inject one."""
        if tp > 1 or sp > 1 or ep > 1:
            raise ValueError(
                f"tp={tp} sp={sp} ep={ep}: replicas of a rank group "
                "(ROADMAP A9, dp x tp and dp x ep) and sequence parallelism "
                "(A9) are not ported; replicas are whole single-card "
                "engines here, and tp and ep run at dp 1")
        devices = [torch.device(d) for d in (
            devices if devices is not None else default_replica_devices())]
        if len(devices) < dp:
            raise ValueError(
                f"dp={dp} x sp={sp} x tp={tp} x ep={ep} needs {dp} "
                f"devices, have {len(devices)}")
        # construction inputs kept for rebuild() (topology resize)
        self._cfg = cfg
        self._params = params
        self._engine_cfg = engine_cfg
        self._tp, self._sp, self._ep = tp, sp, ep
        self._kv_dtype = kv_dtype
        self._devices = devices
        self.clock = clock
        # the server's per-engine warmup (server/app.py), run on every
        # engine a rebuild creates before it serves; None = cold engines
        self.warm_engine: Optional[Callable[[InferenceEngine], None]] = None
        # the server's memory plan for one card (weights once, every
        # replica's pool and scratch), attached to each new engine's
        # memory monitor
        self.memory_plan: Any = None
        if quarantine_threshold is None:
            quarantine_threshold = int(
                os.environ.get(QUARANTINE_THRESHOLD_ENV, "3"))
        self.quarantine_threshold = max(1, quarantine_threshold)
        self.quarantine_window_s = quarantine_window_s
        self.probation_steps = max(1, probation_steps)
        if rebuild_threshold is None:
            try:
                rebuild_threshold = int(
                    os.environ.get(REBUILD_THRESHOLD_ENV, "3") or 3)
            except ValueError:
                rebuild_threshold = 3
        self.rebuild_threshold = max(0, rebuild_threshold)  # 0 disables
        if dp_roles is None:
            dp_roles = os.environ.get(DP_ROLES_ENV) or None
        self._role_spec = parse_dp_roles(dp_roles)
        if self._role_spec is not None and sum(self._role_spec) != dp:
            raise ValueError(
                f"KAFKA_TORCH_DP_ROLES={dp_roles!r} names "
                f"{sum(self._role_spec)} replicas but dp={dp}")
        if disagg_min_prefill_tokens is None:
            try:
                disagg_min_prefill_tokens = int(
                    os.environ.get(MIN_PREFILL_ENV, "512") or 512)
            except ValueError:
                disagg_min_prefill_tokens = 512
        self.min_prefill_tokens = max(1, disagg_min_prefill_tokens)
        self.disagg = DisaggMetrics()
        self.supervisor = ReplicaSupervisorMetrics()
        self.engines: List[InferenceEngine] = []
        self.health: List[ReplicaHealth] = []
        self._build_engines(dp)
        if self._prefill_pool and self.engines[0].prefix_cache is None:
            logger.warning(
                "KAFKA_TORCH_DP_ROLES set but the prefix cache is disabled "
                "— shipped runs have nowhere to register; serving "
                "colocated")
            self._role_spec = None
            self._assign_roles(dp)
        self._route: Dict[str, int] = {}  # request_id -> replica
        # prefix_key -> replica, LRU-capped: a thread whose cache entry is
        # long evicted must not stay pinned (or leak memory) forever
        self._affinity: "OrderedDict[str, int]" = OrderedDict()
        self._affinity_cap = 4096
        # probe memo for the shared system-prompt head, keyed by the
        # prompt's first page: each replica's match_tokens result with
        # the prefix-cache generation it was computed at (_probe_matches)
        self._probe_memo: "OrderedDict[Tuple[int, ...], Dict[str, Any]]" = (
            OrderedDict())
        self._probe_memo_cap = 32
        # expected-return hints: prefix_key -> replica holding the
        # thread's tool-gap state (LRU-capped like the affinity map)
        self._expected_returns: "OrderedDict[str, int]" = OrderedDict()
        self._expected_cap = 4096
        # which replica raised out of step(), so recovery targets it alone
        self._failed_replica: Optional[int] = None
        self._pre_failure_events: List[TokenEvent] = []

    def _make_engine(self, r: int) -> InferenceEngine:
        """Build replica r's engine on its slot's device (construction,
        rebuilds and the per-replica rebuild escalation share this)."""
        engine = InferenceEngine(self._cfg, self._params, self._engine_cfg,
                                 kv_dtype=self._kv_dtype,
                                 device=self._devices[r])
        # postmortems and /debug/flight/{replica} name the replica
        if engine.flight is not None:
            engine.flight.replica = r
        if self.memory_plan is not None and \
                engine.memory_monitor is not None:
            engine.memory_monitor.plan = self.memory_plan
        if self.warm_engine is not None:
            self.warm_engine(engine)
        return engine

    def _build_engines(self, dp: int) -> None:
        # built aside and swapped in: HTTP readers (signals, /metrics)
        # never see an empty fleet
        engines = [self._make_engine(r) for r in range(dp)]
        self.dp = dp
        self.engines = engines
        self.health = [ReplicaHealth() for _ in range(dp)]
        self._assign_roles(dp)

    def _retire_engine(self, e: InferenceEngine) -> None:
        """Release a discarded engine's process-wide holdings: its kernel
        sampler's profiler window (the trace lock), its KV tier's threads,
        and its captured graphs with their memory pool."""
        sampler = e.kernel_sampler
        if sampler is not None:
            sampler.close(e.metrics)
        e.close()
        e._graphs.clear()
        e._graph_pool = None

    def _assign_roles(self, dp: int) -> None:
        """Map the parsed role spec onto replica indices: the first P
        replicas form the prefill pool, the rest decode.  A rebuild to a
        dp the spec cannot cover keeps the prefill count and flexes the
        decode pool, or degrades to colocated when even that cannot fit
        (construction validates exactly; this lenient path is for
        /admin/resize)."""
        spec = self._role_spec
        if spec is not None:
            n_pre, n_dec = spec
            if n_pre + n_dec != dp:
                if dp > n_pre:
                    n_dec = dp - n_pre
                    logger.warning(
                        "dp=%d != prefill:%d+decode:%d; decode pool "
                        "resized to %d", dp, n_pre, spec[1], n_dec)
                else:
                    logger.warning(
                        "dp=%d cannot fit prefill:%d,decode:%d pools; "
                        "serving colocated", dp, n_pre, n_dec)
                    spec = None
        if spec is None:
            self._prefill_pool: List[int] = []
            self._decode_pool: List[int] = []
        else:
            self._prefill_pool = list(range(n_pre))
            self._decode_pool = list(range(n_pre, n_pre + n_dec))
        self._prefill_set = set(self._prefill_pool)
        self._decode_set = set(self._decode_pool)

    # -- engine-like surface (llm/worker.EngineWorker compatible) --------

    @property
    def cfg(self) -> ModelConfig:
        return self.engines[0].cfg

    @property
    def ecfg(self) -> EngineConfig:
        return self.engines[0].ecfg

    @property
    def device(self) -> torch.device:
        return self.engines[0].device

    @property
    def num_active(self) -> int:
        return sum(e.num_active for e in self.engines)

    @property
    def has_work(self) -> bool:
        # pending hand-offs count: their ship and requeue run at step
        # cadence even when no engine has dispatchable work left
        return any(e.has_work or e.handoffs for e in self.engines)

    @property
    def waiting(self) -> List[GenRequest]:
        return [r for e in self.engines for r in e.waiting]

    @property
    def parked(self) -> List[GenRequest]:
        return [r for e in self.engines for r in e.parked]

    # -- supervision -----------------------------------------------------

    def _refresh_health(self, now: Optional[float] = None) -> None:
        """Expire quarantine windows: quarantined -> probation, or, past
        the rebuild threshold, quarantined -> a rebuilt engine on
        probation (a replica that keeps tripping is not re-admitted
        forever)."""
        now = self.clock() if now is None else now
        for i, h in enumerate(self.health):
            if h.state == QUARANTINED and now >= h.quarantined_until:
                if (self.rebuild_threshold > 0
                        and h.quarantine_count >= self.rebuild_threshold
                        and self._rebuild_replica(i)):
                    continue
                h.state = PROBATION
                h.probation_successes = 0
                logger.warning(
                    "replica %d quarantine window expired; on probation", i)

    def _rebuild_replica(self, i: int) -> bool:
        """Re-create one replica's engine after repeated quarantines.
        Only when the replica holds no started work (started lanes own
        device state a new engine cannot adopt); WAITING stragglers carry
        over.  The replica's counters carry over too (they export summed
        across replicas: a one-replica reset would read as a counter
        decrease)."""
        old = self.engines[i]
        if old.num_active or old.parked or old._pending or old.handoffs:
            logger.warning(
                "replica %d rebuild skipped: still holds started work", i)
            return False
        trips = self.health[i].quarantine_count
        pending = old.take_waiting()
        try:
            engine = self._make_engine(i)
        except Exception:
            logger.exception(
                "replica %d engine rebuild FAILED; re-admitting the old "
                "engine on probation", i)
            for req in pending:
                old.adopt(req)
            return False
        engine.metrics = old.metrics
        self._retire_engine(old)
        self.engines[i] = engine
        for req in pending:
            engine.adopt(req)
        # fresh engine, fresh record, but it still proves itself
        self.health[i] = ReplicaHealth(state=PROBATION)
        # its prefix-cache generations restarted at 0
        self._probe_memo.clear()
        self.supervisor.replica_rebuilds += 1
        logger.error(
            "replica %d engine REBUILT after %d quarantine trip(s); on "
            "probation (%d waiting request(s) carried over)",
            i, trips, len(pending))
        return True

    def _routable_indices(self) -> List[int]:
        self._refresh_health()
        idxs = [i for i, h in enumerate(self.health) if h.routable]
        if idxs:
            return idxs
        # every replica quarantined: force-probate the one closest to
        # re-admission — degraded service beats refusing all traffic
        i = min(range(len(self.health)),
                key=lambda j: self.health[j].quarantined_until)
        h = self.health[i]
        h.state = PROBATION
        h.probation_successes = 0
        logger.error(
            "all %d replicas quarantined; force-readmitting replica %d on "
            "probation", len(self.health), i)
        return [i]

    def _note_failure(self, i: int) -> None:
        h = self.health[i]
        h.consecutive_failures += 1
        h.total_failures += 1
        threshold = 1 if h.state == PROBATION else self.quarantine_threshold
        if h.state != QUARANTINED and h.consecutive_failures >= threshold:
            h.quarantine_count += 1
            # doubling backoff per trip, capped at a minute
            window = min(60.0, self.quarantine_window_s
                         * (2 ** (h.quarantine_count - 1)))
            h.state = QUARANTINED
            h.quarantined_until = self.clock() + window
            h.consecutive_failures = 0
            self.supervisor.quarantines += 1
            for req in list(self.engines[i]._requests.values()):
                add_event(req.trace, "quarantine",
                          {"replica": i, "window_s": round(window, 2)})
            logger.error(
                "replica %d quarantined for %.1fs after %d failure(s) "
                "(trip #%d)", i, window, threshold, h.quarantine_count)
            # the quarantined replica's flight ring explains the steps
            # that tripped the breaker (best-effort)
            try:
                self.engines[i].dump_postmortem("quarantine")
            except Exception:  # pragma: no cover - defensive
                logger.exception("quarantine postmortem dump failed")

    def _note_success(self, i: int) -> None:
        h = self.health[i]
        h.consecutive_failures = 0
        if h.state == PROBATION:
            h.probation_successes += 1
            if h.probation_successes >= self.probation_steps:
                h.state = HEALTHY
                self.supervisor.readmits += 1
                logger.warning(
                    "replica %d re-admitted after %d clean probation "
                    "steps", i, h.probation_successes)

    def _migrate_waiting(self, i: int) -> None:
        """Move a quarantined replica's queue onto routable replicas:
        WAITING requests own no device state there, and a healthy replica
        can serve them now."""
        taken = self.engines[i].take_waiting()
        if not taken:
            return
        targets = [j for j in self._routable_indices() if j != i]
        if not targets:
            # sole survivor: put them back rather than drop them
            for req in taken:
                self.engines[i].adopt(req)
            return
        for req in sorted(taken, key=lambda r: r.submit_time):
            cands = targets
            if self._prefill_pool:
                # role pools: prefer same-role targets; a hand-off with
                # no prefill replica left degrades to colocated service
                pool = (self._prefill_set if req.handoff
                        else self._decode_set)
                same = [j for j in targets if j in pool]
                if same:
                    cands = same
                elif req.handoff:
                    req.handoff = False
            j = min(cands, key=self._load)
            self.engines[j].adopt(req)
            self._route[req.request_id] = j
            add_event(req.trace, "migrate",
                      {"from_replica": i, "to_replica": j})
            if req.prefix_key is not None:
                if self._affinity.get(req.prefix_key) == i:
                    self.supervisor.affinity_resteered += 1
                self._set_affinity(req.prefix_key, j)
            self.supervisor.waiting_migrated += 1
        logger.warning(
            "migrated %d waiting request(s) off quarantined replica %d",
            len(taken), i)

    # -- routing ---------------------------------------------------------

    def _set_affinity(self, prefix_key: str, idx: int) -> None:
        self._affinity[prefix_key] = idx
        self._affinity.move_to_end(prefix_key)
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)

    def _load(self, i: int) -> int:
        e = self.engines[i]
        return e.num_active + len(e.waiting) + len(e.parked)

    def _pick(self, req: GenRequest) -> int:
        """Prefix-aware routing: keyed requests go where the longest
        cached prefix lives (a cheap read-only radix probe per routable
        replica — the router runs on the engine thread, the tree's single
        writer).  The thread-affinity LRU is the tiebreak among
        equal-match replicas, so a warm thread stays put, while a COLD
        thread with a shared system prompt lands on the replica that has
        already prefilled it (cross-thread reuse) instead of the merely
        least-loaded one.  A balance guard caps how much queue skew
        prefix gravity may build: when the best-match replica is more
        than a full batch deeper than the least-loaded routable one, load
        wins — the colder replica prefills the prefix once and becomes a
        second warm home.

        With the KV tier enabled, match_tokens counts HOST-RESIDENT runs
        too — a replica holding a thread's demoted KV is routable
        affinity (promotion is cheaper than re-prefill), so an idle
        thread's return still steers to the replica that can re-
        materialize it.

        With role pools configured (KAFKA_TORCH_DP_ROLES) the
        DECODE pool is every thread's home — affinity and prefix probes
        run over it — and a keyed request whose uncached prefill span is
        at least KAFKA_TORCH_DISAGG_MIN_PREFILL_TOKENS routes to the
        least-loaded PREFILL replica as a prefill-and-hand-off instead
        (the router ships its pages to the decode home at first-token
        time).  Shorter prompts prefill in place on the decode pool:
        shipping must never cost more than it saves."""
        routable = self._routable_indices()
        if not self._prefill_pool:
            return self._pick_within(req, routable)
        decode_routable = [i for i in routable if i in self._decode_set]
        prefill_routable = [i for i in routable if i in self._prefill_set]
        if not decode_routable:
            # decode pool fully quarantined: degraded colocated service
            # on whatever is routable beats refusing traffic
            decode_routable = routable
        home = self._pick_within(req, decode_routable)
        if req.prefix_key is None or not prefill_routable:
            return home
        if self.engines[home].prefix_cache is None:
            return home
        # memoized probe (shared with _pick_within's routing probe): a
        # warm fan-out head costs O(1) here instead of a second full
        # radix walk per submit on the engine thread.  A sleep-manifest
        # match counts too: the decode home can WAKE those tokens from
        # the object store, so shipping a fresh prefill of them would
        # only duplicate KV the store already holds.
        cached = self._probe_matches([home], req.prompt_ids)[home]
        cached = max(cached, self._object_match(req))
        if len(req.prompt_ids) - cached < self.min_prefill_tokens:
            self.disagg.prefill_in_place += 1
            return home
        req.handoff = True
        return min(prefill_routable, key=self._load)

    def _pick_within(self, req: GenRequest, routable: List[int]) -> int:
        """The prefix/affinity/load selection of _pick, over an explicit
        candidate set (the whole routable fleet when colocated; the
        decode pool when role pools are configured)."""
        allowed = set(routable)
        pin: Optional[int] = None
        if req.prefix_key is not None:
            hit = self._affinity.get(req.prefix_key)
            if hit is not None and hit < len(self.engines):
                if hit in allowed:
                    pin = hit
                else:
                    # pinned replica is quarantined/dead: re-steer the
                    # thread to a healthy replica (it pays one prefix-cache
                    # miss — the price of surviving the replica, not a
                    # wedged stream)
                    self.supervisor.affinity_resteered += 1
        if req.prefix_key is not None and len(routable) > 1:
            # Warm steady state short-circuit: when the pinned replica
            # already holds the maximum matchable prefix (every whole page
            # but the last token), no other replica can beat it — skip the
            # dp-wide probe entirely (every probe is an O(prompt) walk on
            # the engine thread).
            if pin is not None:
                pc = self.engines[pin].prefix_cache
                if pc is not None:
                    ps = pc.pool.page_size
                    max_match = ((len(req.prompt_ids) - 1) // ps) * ps
                    if (
                        max_match > 0
                        and pc.match_tokens(req.prompt_ids) >= max_match
                    ):
                        return pin
            match = self._probe_matches(routable, req.prompt_ids)
            best = max(match.values())
            obj_match = self._object_match(req)
            if best > 0 and best >= obj_match:
                cands = [i for i in routable if match[i] == best]
                if pin in cands:
                    return pin
                choice = min(cands, key=self._load)
                floor_load = min(self._load(i) for i in routable)
                if self._load(choice) - floor_load <= self.ecfg.max_batch:
                    return choice
                # prefix gravity would overload one replica: spill to the
                # least-loaded routable (it warms its own copy on this
                # prefill) — NOT the pin, which may be deeper still
                return min(routable, key=self._load)
            if obj_match > 0:
                # The shared object store matches deeper than any local
                # cache: EVERY routable replica can wake the thread from
                # its sleep manifest, so affinity is a hint, not a
                # constraint — keep the pin while its load is
                # reasonable, otherwise let load decide outright.
                if pin is not None:
                    floor_load = min(self._load(i) for i in routable)
                    if self._load(pin) - floor_load <= self.ecfg.max_batch:
                        return pin
                return min(routable, key=self._load)
        if pin is not None:
            return pin
        return min(routable, key=self._load)

    def _object_match(self, req: GenRequest) -> int:
        """Longest sleep-manifest-covered prefix of the request's prompt
        in the SHARED object store (0 without an object tier).  Cheap:
        one cached manifest read keyed by the thread's prefix key."""
        if req.prefix_key is None:
            return 0
        tier = getattr(self.engines[0], "kv_tier", None)
        obj = getattr(tier, "object", None) if tier is not None else None
        if obj is None:
            return 0
        try:
            if not obj.available():
                # breaker open: the submit path pays ZERO store RTT —
                # counted with the negatively-cached manifest probes
                obj.probe_neg_cached += 1
                return 0
            return obj.manifest_match_tokens(req.prefix_key,
                                             req.prompt_ids)
        except Exception:  # pragma: no cover - store flake
            return 0

    def _probe_matches(
        self, routable: List[int], prompt_ids: List[int]
    ) -> Dict[int, int]:
        """Per-replica radix-probe results, memoized for the shared head.

        Soundness: a replica's memoized match may be reused only while its
        prefix-cache generation is unchanged (identical tree contents),
        the new prompt still starts with the memoized matched run (every
        per-replica match is a prefix of the deepest one, so one O(match)
        list compare per SUBMIT validates all replicas at once), and the
        memoized match ended strictly INSIDE the run — such a match hit a
        tree divergence inside tokens the new prompt shares, so it is
        exact for the new prompt too.  A match that reached the END of
        the run proves nothing about this prompt's different continuation
        (the old walk may have been stopped by the old prompt's content
        or page cap where the tree goes deeper), so the deepest-match
        replica re-probes every submit: per submit the memo costs one
        O(match) walk for the warmest replica and O(1) for every other,
        instead of O(match) x dp.  Anything else re-probes that replica
        and refreshes the memo.
        """
        pcs = {i: self.engines[i].prefix_cache for i in routable}
        if any(pc is None for pc in pcs.values()):
            return {
                i: (pc.match_tokens(prompt_ids) if pc is not None else 0)
                for i, pc in pcs.items()
            }
        ps = next(iter(pcs.values())).pool.page_size
        if len(prompt_ids) <= ps:
            # sub-page prompt: nothing matchable beyond the head anyway
            return {i: pc.match_tokens(prompt_ids) for i, pc in pcs.items()}
        head = tuple(prompt_ids[:ps])
        memo = self._probe_memo.get(head)
        out: Dict[int, int] = {}
        if memo is not None:
            run = memo["tokens"]
            L = len(run)
            if len(prompt_ids) > L and list(prompt_ids[:L]) == run:
                for i in routable:
                    if memo["gens"].get(i) != pcs[i].generation:
                        continue  # cache mutated: re-probe
                    cached = memo["matches"].get(i)
                    if cached is None:
                        continue
                    if L > 0 and cached >= L:
                        # the memoized walk consumed the WHOLE run: the
                        # tree may continue past it where the old prompt
                        # diverged or was cap-cut, and this prompt's
                        # continuation could match deeper — re-probe.
                        # (L == 0 stays reusable: that walk failed on the
                        # head page itself, which the memo key shares.)
                        continue
                    out[i] = cached
        for i in routable:
            if i not in out:
                out[i] = pcs[i].match_tokens(prompt_ids)
        best = max(out.values(), default=0)
        self._probe_memo[head] = {
            "tokens": list(prompt_ids[:best]),
            "gens": {i: pcs[i].generation for i in routable},
            "matches": dict(out),
        }
        self._probe_memo.move_to_end(head)
        while len(self._probe_memo) > self._probe_memo_cap:
            self._probe_memo.popitem(last=False)
        return out

    def submit(self, req: GenRequest) -> None:
        idx = self._pick(req)
        if req.prefix_key is not None and self._expected_returns:
            # the thread is back: its expected-return hint is consumed
            # (the engine's own gap state pops inside engine.submit)
            self._expected_returns.pop(req.prefix_key, None)
        if req.prefix_key is not None and not req.handoff:
            # kick BEFORE the engine sees the request: admission can run
            # the wake inline (off-slot prefix attach fires on submit),
            # so staging must already be registered for take() to find.
            # A submit that raises below leaves staged payloads behind —
            # bounded by the budget, reclaimed as prefetch_wasted.
            self._kick_prefetch(idx, req)
        self.engines[idx].submit(req)  # may raise: record routes only after
        self._route[req.request_id] = idx
        if req.prefix_key is not None and not req.handoff:
            # hand-off requests pin their affinity at requeue time, to
            # the DECODE home — never to the transient prefill replica
            self._set_affinity(req.prefix_key, idx)

    def _kick_prefetch(self, idx: int, req: GenRequest) -> None:
        """Wake prefetch: when the thread's sleep manifest
        could serve deeper than the CHOSEN replica's local radix cache,
        start the object GETs now — the store RTT overlaps the queue
        wait instead of running synchronously inside prefill admission.
        Everything past the sync manifest-probe cache happens on the
        prefetcher's executor; a dead store degrades at the breaker gate
        inside prefetch_thread (today's synchronous path, zero RTT
        here).  Per-REPLICA staging: the payloads land in the picked
        engine's tier, where its prefix_cache.lookup consumes them."""
        e = self.engines[idx]
        tier = getattr(e, "kv_tier", None)
        obj = getattr(tier, "object", None) if tier is not None else None
        pre = getattr(obj, "prefetcher", None) if obj is not None else None
        if pre is None:
            return
        pc = e.prefix_cache
        local = pc.match_tokens(req.prompt_ids) if pc is not None else 0
        pre.prefetch_thread(req.prefix_key, min_depth=local)

    # -- agent tool-call gaps --------------------------------

    def note_tool_gap(self, prefix_key: Optional[str]) -> None:
        """Register an expected-return hint for `prefix_key` and forward
        the gap signal to its affinity replica's engine (where the
        thread's KV lives — affinity was pinned at its last submit).
        Runs on the worker's engine thread like submit/cancel."""
        if not prefix_key:
            return
        idx = self._affinity.get(prefix_key)
        if idx is None or idx >= len(self.engines):
            return  # affinity evicted: nothing locatable to demote
        self._expected_returns.pop(prefix_key, None)
        self._expected_returns[prefix_key] = idx
        while len(self._expected_returns) > self._expected_cap:
            self._expected_returns.popitem(last=False)
        self.engines[idx].note_tool_gap(prefix_key)

    def note_tool_return(self, prefix_key: Optional[str]) -> None:
        """Fire the expected-return hint: forward to the replica that
        holds the thread's gap state so it can cancel a lingering demote
        or kick its wake prefetcher — the follow-up turn's promotion /
        object GETs overlap the tool's tail."""
        if not prefix_key:
            return
        idx = self._expected_returns.pop(prefix_key, None)
        if idx is None:
            idx = self._affinity.get(prefix_key)
        if idx is None or idx >= len(self.engines):
            return
        self.engines[idx].note_tool_return(prefix_key)

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        idx = self._route.pop(request_id, None)
        if idx is None:
            return False
        # Doom any wake prefetch staged for the request's thread: a
        # cancelled request's staged payloads would otherwise sit
        # in the budget until evicted as waste.  Another queued request
        # of the same thread simply degrades to the synchronous fetch.
        req = self.engines[idx]._requests.get(request_id)
        if req is not None and req.prefix_key is not None:
            tier = getattr(self.engines[idx], "kv_tier", None)
            obj = getattr(tier, "object", None) if tier is not None else None
            pre = getattr(obj, "prefetcher", None) if obj is not None else None
            if pre is not None:
                pre.cancel_thread(req.prefix_key)
        # A request parked in an engine's hand-off list (prefill done,
        # ship + requeue pending) is in NEITHER engine's _requests — an
        # engine-level cancel would return False and the next step's
        # drain would resurrect the cancelled stream as an orphan
        # decoding into the void.  Retire it here: its pages free and
        # the hand-off never completes.
        for e in self.engines:
            for pair in e.handoffs:
                if pair[0].request_id == request_id:
                    e.handoffs.remove(pair)
                    req = pair[0]
                    if req.seq is not None:
                        e.pool.free_sequence(req.seq)
                        req.seq = None
                    req.state = FINISHED
                    req.finish_reason = reason
                    return True
        return self.engines[idx].cancel(request_id, reason=reason)

    def step(self) -> List[TokenEvent]:
        self._refresh_health()
        events: List[TokenEvent] = []
        for i, e in enumerate(self.engines):
            if not self.health[i].routable:
                continue  # quarantined: no traffic, no stepping
            if e.has_work:
                try:
                    events.extend(e.step())
                    self._note_success(i)
                except Exception:
                    # remember the failing replica and the events already
                    # collected from healthy ones; recover_from_failure
                    # (called by EngineWorker) returns both
                    self._failed_replica = i
                    self._pre_failure_events = events
                    self._note_failure(i)
                    raise
        # Prefill-and-hand-off completions (disaggregated serving): ship
        # each finished prefill's page run to its decode home and requeue
        # the thread there.  The first token emits as an ordinary
        # (non-terminal) event — the client stream continues seamlessly
        # on the decode pool.  Drained for EVERY engine, routable or not
        # (a replica quarantined after producing a hand-off must not
        # strand the thread).
        for i, e in enumerate(self.engines):
            if e.handoffs:
                pending, e.handoffs = e.handoffs, []
                for req, tok in pending:
                    # the ENGINE OBJECT rides along: a quarantine-
                    # escalation rebuild inside _complete_handoff's own
                    # health refresh can swap engines[i] mid-drain, and
                    # the ship must gather from the pool that actually
                    # holds the request's pages
                    events.append(self._complete_handoff(i, e, req, tok))
        for ev in events:
            if ev.finished:
                self._route.pop(ev.request_id, None)
        return events

    # -- disaggregated prefill/decode -------------------------

    def _complete_handoff(self, src: int, src_e: InferenceEngine,
                          req: GenRequest, token: int) -> TokenEvent:
        """Steer a finished prefill-and-hand-off to its decode home:
        ship the page run, requeue the request there (preemption-style
        resume — the re-prefill's sampled token is the deterministic
        duplicate of `token` and is dropped), and emit the first token.
        Every failure path degrades to re-prefill on the destination,
        never to a lost stream or partial KV."""
        self.disagg.handoffs += 1
        routable = self._routable_indices()
        decode_routable = [i for i in routable if i in self._decode_set]
        cands = (
            decode_routable
            or [i for i in routable if i != src]
            or routable
        )
        dst = self._pick_within(req, cands)
        attrs: Dict[str, Any] = {"shipped": False}
        if self.engines[dst] is src_e:
            # sole-survivor fallback: the local store in the engine's
            # hand-off path already cached the run here — the resume
            # hits it as an ordinary own-thread prefix, zero re-prefill
            self.disagg.ship_skips += 1
        elif req.seq is not None:
            attrs = self._ship_run(src_e, dst, req)
        if req.seq is not None:
            # cache retains (local store + shipped registration) keep
            # every shared page alive; the sequence's own references go
            # back to the source pool
            src_e.pool.free_sequence(req.seq)
            req.seq = None
        add_event(req.trace, "handoff",
                  {"from_replica": src, "to_replica": dst, **attrs})
        req.handoff = False
        req.resumed = True
        req.prefill_ids = req.prompt_ids + req.output_ids[:-1]
        self.engines[dst].adopt(req)
        self._route[req.request_id] = dst
        if req.prefix_key is not None:
            self._set_affinity(req.prefix_key, dst)
        return TokenEvent(req.request_id, token)

    def _ship_run(self, src_e: InferenceEngine, dst: int, req: GenRequest,
                  ) -> Dict[str, Any]:
        """Move the hand-off's whole-page run from replica `src` into
        replica `dst`'s pool and register it in dst's radix prefix cache
        (cache_source="shipped").  Returns the handoff event attrs.

        Delta shipping: pages the destination already caches (the shared
        fan-out head) are skipped — store() descends the matched runs
        without touching the dummy page entries passed for them.  The
        probe is exact (same thread, no tree mutation in between), and
        the skip is keyed on run CONTENT (match_tokens matches by token
        runs; store()'s host-run adoption requires real page ids, so a
        tier-resident matched run keeps its tier copy instead of
        capturing a dummy entry) — tiered destinations delta-ship like
        untiered ones.

        Torn-copy semantics: ship() raising leaves the destination pages
        partially written — they are freed in full (freshly allocated,
        shared with nobody: complete cleanup), the failure is counted in
        disagg_ship_failures, and the thread re-prefills on the decode
        replica.  Never partial KV."""
        from .kv_tier import CrossReplicaPageShipper

        dst_e = self.engines[dst]
        cache = dst_e.prefix_cache
        ps = src_e.ecfg.page_size
        tokens = (req.prompt_ids + req.output_ids)[: req.seq.length]
        n_full = min(len(req.seq.pages), len(tokens) // ps)
        if cache is None or n_full == 0 or req.prefix_key is None:
            self.disagg.ship_skips += 1
            return {"shipped": False}

        def probe_skip() -> int:
            return min(cache.match_tokens(tokens) // ps, n_full)

        skip = probe_skip()
        if skip >= n_full:
            # destination already warm (shared prefix): nothing to copy
            self.disagg.ship_skips += 1
            return {"shipped": False, "already_cached_pages": n_full}
        n_ship = n_full - skip
        if dst_e.pool.free_pages < n_ship:
            cache.reclaim(n_ship)
            # reclaim may have evicted the very runs the skip was
            # measured against — the dummy page entries below stand in
            # for runs store() DESCENDS, so the skip must only shrink to
            # match what is still present (a grown n_ship that no longer
            # fits simply fails the alloc and degrades to re-prefill)
            skip = min(skip, probe_skip())
            n_ship = n_full - skip
        try:
            dest = dst_e.pool.alloc(n_ship)
        except OutOfPagesError:
            self.disagg.ship_skips += 1
            return {"shipped": False, "dest_pages_short": n_ship}
        shipper = CrossReplicaPageShipper(src_e, dst_e, ps)
        t0 = time.monotonic()
        try:
            nbytes = shipper.ship(req.seq.pages[skip:n_full], dest)
        except Exception as e:
            dst_e.pool.release(dest)
            self.disagg.ship_failures += 1
            logger.warning(
                "cross-replica ship of %d pages (%s -> replica %d) "
                "failed: %s — degrading to re-prefill", n_ship,
                req.request_id, dst, e,
            )
            return {"shipped": False, "ship_error": str(e)}
        dur = time.monotonic() - t0
        # register, then drop the alloc reference: the cache's retains
        # keep the registered suffix alive; duplicate pages (runs the
        # store walk matched after all) free here
        cache.store(req.prefix_key, tokens[:n_full * ps],
                    [-1] * skip + list(dest), shipped=True)
        dst_e.pool.release(dest)
        self.disagg.record_ship(n_ship, nbytes, dur,
                                transport=shipper.transport)
        return {
            "shipped": True,
            "shipped_pages": n_ship,
            "shipped_bytes": nbytes,
            "already_cached_pages": skip,
            "transport": shipper.transport,
        }

    def warmup_disagg(self) -> None:
        """Run every ship bucket once outside serving, so the first
        hand-off does not pay the copy kernels' first launches on the
        scheduler thread.
        Shipped from and into the trash page on both ends (gathers read
        garbage, scatters write it into the destination trash page — its
        contract; no pool state changes); one pass over each pool edge
        covers every (prefill, decode) pair.  No-op without role
        pools."""
        if not self._prefill_pool:
            return
        from .kv_tier import SHIP_BUCKETS, CrossReplicaPageShipper

        d0, p0 = self._decode_pool[0], self._prefill_pool[0]
        pairs = [(p, d0) for p in self._prefill_pool] + [
            (p0, d) for d in self._decode_pool
        ]
        ps = self.engines[0].ecfg.page_size
        for s, d in pairs:
            shipper = CrossReplicaPageShipper(
                self.engines[s], self.engines[d], ps
            )
            for b in SHIP_BUCKETS:
                shipper.ship([0] * b, [0] * b)  # TRASH_PAGE both ends

    def run_to_completion(self) -> Dict[str, GenRequest]:
        """Drain all requests (testing/bench convenience) — driven
        through the ROUTER's step loop, not per-engine draining:
        supervision and hand-off completion only run here, and a
        prefill-and-hand-off drained engine-by-engine would strand its
        continuation."""
        registry: Dict[str, GenRequest] = {}
        for e in self.engines:
            registry.update(e._requests)
        done: Dict[str, GenRequest] = {}
        while self.has_work:
            for ev in self.step():
                if ev.finished and ev.request_id in registry:
                    done[ev.request_id] = registry[ev.request_id]
        return done

    def recover_from_failure(self) -> List[TokenEvent]:
        """Post-step-failure recovery (EngineWorker): only the replica
        that raised is recovered — healthy replicas keep their in-flight
        requests untouched.  Falls back to recovering every replica when
        the failure origin is unknown (e.g. submit-path errors).  If the
        failure tripped the circuit breaker, the quarantined replica's
        queued requests migrate to healthy replicas before returning."""
        events: List[TokenEvent] = list(self._pre_failure_events)
        self._pre_failure_events = []
        idx = self._failed_replica
        self._failed_replica = None
        targets = self.engines if idx is None else [self.engines[idx]]
        for e in targets:
            events.extend(e.recover_from_failure())
        for i, h in enumerate(self.health):
            if h.state == QUARANTINED:
                self._migrate_waiting(i)
        for ev in events:
            if ev.finished:
                self._route.pop(ev.request_id, None)
        return events

    # -- topology rebuild (drain/restart story) --------------------------

    def validate_dp(self, dp: int) -> None:
        """Raise ValueError when `dp` cannot fit the device budget.

        Exposed separately from rebuild() so callers (resize_dp) can
        reject an impossible topology UP FRONT, before draining cancels
        any in-flight work."""
        per = self._tp * self._sp * self._ep
        if dp * per > len(self._devices):
            raise ValueError(
                f"dp={dp} x {per} devices/replica needs {dp * per}, "
                f"have {len(self._devices)}"
            )

    def rebuild(self, dp: int, roles: Any = _ROLES_KEEP) -> None:
        """Re-create the replica set at a new dp count; WAITING requests
        survive the rebuild (re-queued onto the new replicas in submit
        order, with routes and affinity rewritten).

        `roles` re-shapes the role pools in the
        same rebuild: a "prefill:P,decode:D" spec (parse_dp_roles rules,
        P + D must equal `dp` — validated BEFORE any work is touched),
        None/"" dissolves the pools back to colocated, and the default
        keeps the current spec re-derived for the new dp.

        Precondition: no replica holds STARTED work (active lanes, parked
        lanes, in-flight fetches) — the caller drains or cancels those
        first (llm/torch_provider.resize_dp does, with the worker parked).
        Started lanes own device state that cannot move across engines.
        The old fleet's graphs (with their memory pools), tier threads and
        any kernel-sampler window are released before the new fleet is
        built; its pools go once the new fleet is swapped in."""
        self.validate_dp(dp)
        new_spec: Any = _ROLES_KEEP
        if roles is not _ROLES_KEEP:
            new_spec = validate_roles_spec(roles, dp)  # raises on bad spec
            if new_spec is not None and self.engines[0].prefix_cache is None:
                # same degrade rule as construction: shipped runs have
                # nowhere to register without a radix cache
                logger.warning(
                    "resize roles %r ignored: the prefix cache is "
                    "disabled; serving colocated", roles,
                )
                new_spec = None
        for i, e in enumerate(self.engines):
            if e.num_active or e.parked or e._pending or e.handoffs:
                raise RuntimeError(
                    f"cannot rebuild: replica {i} still holds started "
                    "work (drain or cancel it first)"
                )
        if new_spec is not _ROLES_KEEP:
            # committed only after the started-work check: a refused
            # rebuild must not leave a half-applied role spec behind
            self._role_spec = new_spec
        pending: List[GenRequest] = []
        for e in self.engines:
            pending.extend(e.take_waiting())
            # a discarded engine must not keep the process-wide profiler
            # trace lock, its tier threads or its graph pool
            self._retire_engine(e)
        old_dp = len(self.engines)
        self._build_engines(dp)
        gc.collect()  # engine <-> tier shipper cycles hold the old pools
        # replica indices changed meaning: stale pins/routes must not leak
        self._affinity.clear()
        self._route.clear()
        self._probe_memo.clear()
        for req in sorted(pending, key=lambda r: r.submit_time):
            cands: List[int] = list(range(dp))
            if self._prefill_pool:
                # role pools survive the resize (re-derived for the new
                # dp by _assign_roles): hand-offs requeue on the prefill
                # pool, everything else on its decode home pool
                cands = (self._prefill_pool if req.handoff
                         else self._decode_pool)
            elif req.handoff:
                req.handoff = False  # pools dissolved in the resize
            j = min(cands, key=lambda t: len(self.engines[t].waiting))
            self.engines[j].adopt(req)
            self._route[req.request_id] = j
            if req.prefix_key is not None:
                self._set_affinity(req.prefix_key, j)
        self.supervisor.rebuilds += 1
        logger.warning(
            "rebuilt topology dp=%d -> dp=%d (%d waiting request(s) "
            "carried over)", old_dp, dp, len(pending),
        )

    def self_check(self, repair: bool = False) -> List[str]:
        problems: List[str] = []
        for i, e in enumerate(self.engines):
            problems.extend(
                f"replica {i}: {p}" for p in e.self_check(repair=repair)
            )
        return problems

    def retry_after_estimate(self) -> float:
        return min(e.retry_after_estimate() for e in self.engines)

    def dump_postmortem(self, reason: str) -> List[Optional[str]]:
        """Every replica's flight-recorder postmortem (best-effort)."""
        return [e.dump_postmortem(reason) for e in self.engines]

    def close(self) -> None:
        """Stop every replica's KV-tier threads (idempotent)."""
        for e in self.engines:
            e.close()

    @property
    def metrics(self):
        # expose replica 0's metrics object shape with aggregate snapshot
        return _AggregateMetrics(self)

    @property
    def prefix_cache(self):
        return self.engines[0].prefix_cache

    @property
    def pool(self):
        return self.engines[0].pool

    @property
    def _pending(self):  # worker/metrics introspection
        return [p for e in self.engines for p in e._pending]

    @property
    def _requests(self) -> Dict[str, GenRequest]:
        # EngineWorker._fail_all iterates this on device-step failure;
        # merged view so dp serving fails requests instead of crashing
        # the worker thread
        merged: Dict[str, GenRequest] = {}
        for e in self.engines:
            merged.update(e._requests)
        return merged


class _AggregateMetrics:
    """Aggregated snapshot over replicas (read-only)."""

    def __init__(self, router: DataParallelEngines):
        self._router = router
        self._engines = router.engines

    def snapshot(self, engine=None,
                 reset_peak: bool = True) -> Dict[str, Any]:
        from .metrics import HISTOGRAM_NAMES, StreamingHistogram

        snaps = [e.metrics.snapshot(e, reset_peak=reset_peak)
                 for e in self._engines]
        agg: Dict[str, Any] = {
            "dp": len(snaps),
            "replicas": snaps,  # per-replica detail
            "uptime_s": snaps[0]["uptime_s"],
        }
        # summable counters aggregate
        agg["requests"] = {
            k: sum(s["requests"][k] for s in snaps)
            for k in snaps[0]["requests"]
        }
        agg["queue"] = {
            "depth": sum(s["queue"]["depth"] for s in snaps),
            "peak": max(s["queue"]["peak"] for s in snaps),
            # depth slopes add: the dp-wide queue's growth rate
            "trend_per_s": round(
                sum(s["queue"]["trend_per_s"] for s in snaps), 4
            ),
        }
        gen = sum(s["tokens"]["generated"] for s in snaps)
        wasted = sum(s["tokens"]["fetch_pipeline_wasted"] for s in snaps)
        agg["tokens"] = {
            "prompt": sum(s["tokens"]["prompt"] for s in snaps),
            "generated": gen,
            # rates sum across replicas (each is tokens over the same wall
            # clock), ratios do not — recompute anything derived
            "generated_per_s": round(
                sum(s["tokens"]["generated_per_s"] for s in snaps), 2
            ),
            "fetch_pipeline_wasted": wasted,
            "fetch_pipeline_waste_frac": round(
                wasted / (gen + wasted), 4
            ) if (gen + wasted) else 0.0,
        }
        # constrained decoding: every key is a summable counter EXCEPT
        # compile_pending, a process-wide gauge every replica reports
        # identically (the deferred-compile queue is shared) — summing it
        # would multiply by dp
        agg["constrained"] = {
            k: (s0_v if k == "constrained_compile_pending"
                else sum(s["constrained"][k] for s in snaps))
            for k, s0_v in snaps[0]["constrained"].items()
        }
        agg["constrained_roundtrips"] = \
            agg["constrained"]["constrained_roundtrips"]
        # speculative decoding: counters sum, rates recompute.  Summed
        # from the SAME snaps as the exported per-replica detail so the
        # aggregate always equals the sum of agg["replicas"] within one
        # scrape (live re-reads could disagree)
        prop = sum(s["speculation"]["speculation_proposed_tokens"]
                   for s in snaps)
        acc = sum(s["speculation"]["speculation_accepted_tokens"]
                  for s in snaps)
        rej = sum(s["speculation"]["speculation_rejected_tokens"]
                  for s in snaps)
        steps_v = sum(s["speculation"]["speculation_verify_steps"]
                      for s in snaps)
        agg["speculation"] = {
            "speculation_proposed_tokens": prop,
            "speculation_accepted_tokens": acc,
            "speculation_rejected_tokens": rej,
            "speculation_verify_steps": steps_v,
            "speculation_acceptance_rate": round(
                acc / (acc + rej), 4
            ) if (acc + rej) else 0.0,
            "speculation_accepted_per_step": round(
                acc / steps_v, 3
            ) if steps_v else 0.0,
        }
        # latency distributions MERGE exactly (the whole point of the
        # fixed-bucket streaming histograms, ): same bounds, bucket
        # counts add — no raw-sample pooling, no percentile-of-percentiles.
        # Merged from the SAME per-replica snapshots exported below so the
        # aggregate equals the sum of agg["replicas"] within one scrape.
        merged = {
            name: StreamingHistogram.merged([
                StreamingHistogram.from_snapshot(s["histograms"][name])
                for s in snaps
            ])
            for name in HISTOGRAM_NAMES
        }
        agg["histograms"] = {
            name: h.snapshot() for name, h in merged.items()
        }
        agg["ttft_ms"] = merged["ttft_ms"].quantiles()
        agg["tpot_ms"] = merged["tpot_ms"].quantiles()
        agg["ttft_breakdown_ms"] = {
            "queue_wait": merged["ttft_queue_ms"].quantiles(),
            "prefill": merged["ttft_prefill_ms"].quantiles(),
            "first_fetch": merged["ttft_fetch_ms"].quantiles(),
        }
        agg["emission"] = {
            "burst_tokens": merged["burst_tokens"].quantiles(),
            "burst_gap_ms": merged["burst_gap_ms"].quantiles(),
        }
        # SLO/goodput (SLO_METRIC_KEYS): counters and raw window sums add,
        # then the SHARED builder recomputes every ratio (one home for the
        # attainment/goodput math — metrics.build_slo_section — so the
        # aggregate cannot drift from the per-engine exposition); targets
        # are deployment-wide (same env), reported once
        from .metrics import build_slo_section

        slos = [s["slo"] for s in snaps]

        def _wsum(key):
            return {
                f: sum(s[key][f] for s in slos)
                for f in ("met", "missed", "goodput_tokens")
            }

        agg["slo"] = build_slo_section(
            ttft_target_ms=slos[0]["slo_ttft_target_ms"],
            tpot_target_ms=slos[0]["slo_tpot_target_ms"],
            met=sum(s["slo_met_requests"] for s in slos),
            missed=sum(s["slo_missed_requests"] for s in slos),
            ttft_violations=sum(s["slo_ttft_violations"] for s in slos),
            tpot_violations=sum(s["slo_tpot_violations"] for s in slos),
            goodput_tokens=sum(s["goodput_tokens"] for s in slos),
            generated_tokens=gen,
            uptime_s=snaps[0]["uptime_s"],
            window_1m=_wsum("window_1m"),
            window_5m=_wsum("window_5m"),
        )
        # device utilization (UTILIZATION_METRIC_KEYS): per-kind counters
        # sum; the MFU / HBM-BW ratios are recomputed from the summed
        # flop/byte/busy totals against the (homogeneous) replica roofline
        from .metrics import UTILIZATION_KINDS

        utils = [s["utilization"] for s in snaps]
        agg_util: Dict[str, Any] = {
            "peak_tflops": utils[0]["peak_tflops"],
            "peak_hbm_gbps": utils[0]["peak_hbm_gbps"],
            "peak_source": utils[0]["peak_source"],
        }
        peak_f = (utils[0]["peak_tflops"] or 0) * 1e12
        peak_b = (utils[0]["peak_hbm_gbps"] or 0) * 1e9
        for kind in UTILIZATION_KINDS:
            rows = [u[kind] for u in utils]
            measured_s = sum(r.get("measured_busy_s", 0.0) for r in rows)
            modeled_s = sum(r.get("modeled_busy_s", 0.0) for r in rows)
            sec: Dict[str, Any] = {
                "dispatches": sum(r["dispatches"] for r in rows),
                "tokens": sum(r["tokens"] for r in rows),
                "flops": sum(r["flops"] for r in rows),
                "hbm_bytes": sum(r["hbm_bytes"] for r in rows),
                "busy_s": round(sum(r["busy_s"] for r in rows), 3),
                "mfu": 0.0, "hbm_bw_util": 0.0,
                "mfu_1m": 0.0, "hbm_bw_util_1m": 0.0,
                # measured dispatch timing: sums add across
                # replicas; the skew RATIO recomputes from the sums
                "measured_dispatches": sum(
                    r.get("measured_dispatches", 0) for r in rows
                ),
                "measured_busy_s": round(measured_s, 4),
                "modeled_busy_s": round(modeled_s, 4),
                "model_skew": round(measured_s / modeled_s, 3)
                if modeled_s > 0 else 0.0,
            }
            # sampled kernel profiling: sample counts and
            # device-kernel seconds sum; the skew ratio recomputes from
            # modeled seconds reconstructed per row (busy_s / skew)
            kern_s = sum(r.get("kernel_busy_s", 0.0) for r in rows)
            kern_modeled = sum(
                r.get("kernel_busy_s", 0.0) / r["kernel_skew"]
                for r in rows if r.get("kernel_skew")
            )
            sec["kernel_samples"] = sum(
                r.get("kernel_samples", 0) for r in rows
            )
            sec["kernel_busy_s"] = round(kern_s, 4)
            sec["kernel_skew"] = (round(kern_s / kern_modeled, 3)
                                  if kern_modeled > 0 else 0.0)
            # aggregate busy time is SUMMED replica-seconds, so the ratio
            # divides by replica-seconds of roofline — per-chip MFU, not
            # fleet-total
            if sec["busy_s"] > 0:
                if peak_f:
                    sec["mfu"] = round(
                        sec["flops"] / (sec["busy_s"] * peak_f), 4
                    )
                if peak_b:
                    sec["hbm_bw_util"] = round(
                        sec["hbm_bytes"] / (sec["busy_s"] * peak_b), 4
                    )
            wf = sum(r["window_1m"]["flops"] for r in rows)
            wb = sum(r["window_1m"]["hbm_bytes"] for r in rows)
            ws = sum(r["window_1m"]["busy_s"] for r in rows)
            if ws > 0:
                if peak_f:
                    sec["mfu_1m"] = round(wf / (ws * peak_f), 4)
                if peak_b:
                    sec["hbm_bw_util_1m"] = round(wb / (ws * peak_b), 4)
            sec["window_1m"] = {"flops": wf, "hbm_bytes": wb,
                                "busy_s": round(ws, 4)}
            agg_util[kind] = sec
        agg["utilization"] = agg_util
        steps = sum(s["decode"]["steps"] for s in snaps)
        busy = sum(e.metrics.decode_busy_slots for e in self._engines)
        agg["decode"] = {
            "steps": steps,
            "batch_occupancy": round(busy / steps, 3) if steps else 0.0,
        }
        agg["engine"] = {
            "active": sum(s["engine"]["active"] for s in snaps),
            "waiting": sum(s["engine"]["waiting"] for s in snaps),
            "pages_total": sum(s["engine"]["pages_total"] for s in snaps),
            "pages_free": sum(s["engine"]["pages_free"] for s in snaps),
            "pages_in_use": sum(s["engine"]["pages_in_use"] for s in snaps),
        }
        if all("prefix_cache" in s for s in snaps):
            agg["prefix_cache"] = {
                k: sum(s["prefix_cache"][k] for s in snaps)
                for k in snaps[0]["prefix_cache"]
            }
        # KV tier: every key is a summable counter or a gauge
        # whose per-replica values add up (bytes/runs per replica tier)
        tier_snaps = [s["kv_tier"] for s in snaps if "kv_tier" in s]
        if tier_snaps:
            agg["kv_tier"] = {
                k: sum(t[k] for t in tier_snaps)
                for k in tier_snaps[0]
            }
        # Object-store KV tier:
        # per-owner counters sum; the store gauges describe the ONE
        # SHARED store every replica mounts, so they report once,
        # unsummed (summing would multiply by dp); the breaker-state
        # gauge maxes — one replica's open breaker must stay visible in
        # the fleet view, and 2=open dominates 1=half-open dominates 0
        obj_snaps = [s["object_tier"] for s in snaps
                     if "object_tier" in s]
        if obj_snaps:
            shared = ("store_bytes", "store_objects")

            def _agg_obj(k: str) -> Any:
                if k in shared:
                    return obj_snaps[0][k]
                if k == "store_breaker_state":
                    return max(t.get(k, 0) for t in obj_snaps)
                return sum(t[k] for t in obj_snaps)

            agg["object_tier"] = {k: _agg_obj(k) for k in obj_snaps[0]}
        # Flight recorder + anomaly detectors: counters sum;
        # each active anomaly carries the replica it fires on so the
        # autoscaler's "don't scale while an anomaly is active" guard can
        # tell a sick replica from a sick fleet.
        anoms = [s.get("anomalies") or {} for s in snaps]
        active: List[Dict[str, Any]] = []
        for i, a in enumerate(anoms):
            for entry in a.get("active", []):
                active.append({**entry, "replica": i})
        from .flight_recorder import ANOMALY_KINDS

        agg["anomalies"] = {
            f"anomaly_{kind}": sum(
                a.get(f"anomaly_{kind}", 0) for a in anoms
            )
            for kind in ANOMALY_KINDS
        }
        agg["anomalies"]["anomalies_active"] = len(active)
        agg["anomalies"]["active"] = active
        flights = [s["flight"] for s in snaps if "flight" in s]
        if flights:
            agg["flight"] = {
                k: sum(f[k] for f in flights) for k in flights[0]
            }
        # Agent-native scheduling: every
        # key is per-replica (counters and queue/awaiting gauges alike),
        # so the fleet view is a straight sum across replicas.
        agents = [s["agent"] for s in snaps if "agent" in s]
        if agents:
            agg["agent"] = {
                k: sum(a[k] for a in agents) for k in agents[0]
            }
        # Live HBM accounting: the fleet
        # view is worst-case — the plan is per-replica, so the tightest
        # replica bounds the fleet (max in_use/peak/skew/pressure, min
        # limit/headroom); component attribution is identical across
        # replicas (same plan), reported once
        mems = [s["memory"] for s in snaps if "memory" in s]
        if mems:
            agg["memory"] = {
                "source": mems[0]["source"],
                "hbm_bytes_in_use": max(
                    m["hbm_bytes_in_use"] for m in mems
                ),
                "hbm_bytes_peak": max(m["hbm_bytes_peak"] for m in mems),
                "hbm_bytes_limit": min(
                    m["hbm_bytes_limit"] for m in mems
                ),
                "hbm_headroom_bytes": min(
                    m["hbm_headroom_bytes"] for m in mems
                ),
                "hbm_plan_skew": max(m["hbm_plan_skew"] for m in mems),
                "hbm_pressure": max(m["hbm_pressure"] for m in mems),
                "hbm_component_bytes": dict(
                    mems[0].get("hbm_component_bytes") or {}
                ),
                "devices": [
                    d for m in mems for d in m.get("devices", [])
                ],
            }
        # Disaggregated prefill/decode:
        # router-owned ship counters + the ship-latency histogram,
        # reported once (one router per process), plus a per-pool section
        # (role, replica ids, queue/occupancy, per-kind MFU/HBM-BW) so
        # the autoscaler can size the pools independently.  Absent when
        # role pools are not configured — the colocated exposition is
        # byte-identical to before.
        router = self._router
        if router._prefill_pool:
            pools: List[Dict[str, Any]] = []
            for role, idxs in (("prefill", router._prefill_pool),
                               ("decode", router._decode_pool)):
                rows = [snaps[i] for i in idxs if i < len(snaps)]
                util: Dict[str, Any] = {}
                for kind in UTILIZATION_KINDS:
                    krs = [r["utilization"][kind] for r in rows
                           if "utilization" in r]
                    fl = sum(x["flops"] for x in krs)
                    hb = sum(x["hbm_bytes"] for x in krs)
                    bs = sum(x["busy_s"] for x in krs)
                    w1f = sum(x["window_1m"]["flops"] for x in krs)
                    w1b = sum(x["window_1m"]["hbm_bytes"] for x in krs)
                    w1s = sum(x["window_1m"]["busy_s"] for x in krs)
                    util[kind] = {
                        # per-chip ratios over the pool's replica-seconds
                        "mfu": round(fl / (bs * peak_f), 4)
                        if bs > 0 and peak_f else 0.0,
                        "hbm_bw_util": round(hb / (bs * peak_b), 4)
                        if bs > 0 and peak_b else 0.0,
                        "mfu_1m": round(w1f / (w1s * peak_f), 4)
                        if w1s > 0 and peak_f else 0.0,
                        "hbm_bw_util_1m": round(w1b / (w1s * peak_b), 4)
                        if w1s > 0 and peak_b else 0.0,
                    }
                occ = [r["decode"]["batch_occupancy"] for r in rows
                       if "decode" in r]
                pools.append({
                    "role": role,
                    "replicas": list(idxs),
                    "queue_depth": sum(
                        len(router.engines[i].waiting) for i in idxs
                    ),
                    "active": sum(
                        router.engines[i].num_active for i in idxs
                    ),
                    "parked": sum(
                        len(router.engines[i].parked) for i in idxs
                    ),
                    "batch_occupancy": round(
                        sum(occ) / len(occ), 3
                    ) if occ else 0.0,
                    "utilization": util,
                })
            agg["disagg"] = {**router.disagg.snapshot(), "pools": pools}
        # replica-lifecycle observability: per-replica health gauges +
        # the supervisor counter family (quarantine/re-admit/migration)
        agg["replica_supervisor"] = {
            "health": [h.gauge() for h in router.health],
            "states": [h.state for h in router.health],
            "consecutive_failures": [
                h.consecutive_failures for h in router.health
            ],
            "total_failures": [h.total_failures for h in router.health],
            **router.supervisor.snapshot(),
        }
        return agg
