"""kafka_tpu_torch.runtime.autoscaler against kafka_tpu.runtime.autoscaler.

* One scripted list of /admin/signals snapshots (overload, recovery,
  idle, anomalies, probation, role pools, HBM pressure, a compile storm,
  draining) drives both packages' `decide` and `AutoscalerController.
  replay`: the decisions, the decision logs (their wall-clock fields
  masked), the counters and the controller states are equal.
* The degradation ladder's three rungs — max_waiting, spec_k_cap = 0, the
  process-wide background flag — go down and back up on the port's
  engines (two replicas behind a router), as on the reference's.
* `recommend` mode decides but acts on nothing: no resize, no rung.
* `start` then `stop` leaves no controller thread.

An autouse fixture puts back both packages' background_deferred flag and
fails the test if a controller thread is still alive.
"""

import dataclasses
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.runtime import EngineConfig as JEngineConfig
from kafka_tpu.runtime import autoscaler as ref
from kafka_tpu.runtime import dp_router as jdp
from kafka_tpu_torch.models import params_from_jax
from kafka_tpu_torch.models.config import ModelConfig
from kafka_tpu_torch.runtime import EngineConfig
from kafka_tpu_torch.runtime import autoscaler as port
from kafka_tpu_torch.runtime import dp_router as pdp

DIMS = dict(name="dp-test", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, dtype="float32")
ECFG = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8,
            prefill_buckets=(8, 16, 32), max_waiting=40, speculative_k=2)


@pytest.fixture(autouse=True)
def _process_state():
    before = {t for t in threading.enumerate()}
    yield
    ref.set_background_deferred(False)
    port.set_background_deferred(False)
    alive = [t for t in threading.enumerate() if t not in before
             and t.name.startswith(("kafka-tpu-autoscaler",
                                    "kafka-torch-autoscaler"))]
    assert not alive, f"controller threads left running: {alive}"


def sig(dp=1, attain=1.0, wr=10, depth=0, trend=0.0, occ=0.5, mfu=0.3,
        anomalies=0, states=None, pools=None, draining=False, storm=False,
        pressure=0):
    """A synthetic signals snapshot (the /admin/signals shape)."""
    states = states if states is not None else ["healthy"] * dp
    snap = {
        "version": 9, "dp": dp,
        "slo": {"slo_attainment_1m": attain, "window_1m_requests": wr},
        "queue": {"depth": depth, "trend_per_s": trend, "peak": depth},
        "batch": {"occupancy_frac": occ, "active": 0, "max_batch": 8},
        "utilization": {"decode": {"mfu_1m": mfu, "hbm_bw_util_1m": mfu}},
        "anomalies": {"anomalies_active": anomalies},
        "replicas": [{"replica": i, "state": s}
                     for i, s in enumerate(states)],
        "pools": pools or [],
        "compiles": {"storm_active": storm},
        "memory": {"pressure": pressure},
    }
    if draining:
        snap["draining"] = True
    return snap


def pools(p, d, qp=0, qd=0):
    return [{"role": "prefill", "replicas": list(range(p)),
             "queue_depth": qp},
            {"role": "decode", "replicas": list(range(p, p + d)),
             "queue_depth": qd}]


# overload -> scale-out (then cooldown), more overload at the cap ->
# ladder descent, recovery -> climb, idle -> scale-in, vetoes of every kind
SCRIPT = (
    [sig(attain=0.5, depth=4)] * 3
    + [sig(dp=2, attain=0.5, depth=6, trend=1.0)] * 4
    + [sig(dp=4, attain=0.4, depth=9)] * 6
    + [sig(dp=4, attain=0.4, depth=9, anomalies=1)] * 2
    + [sig(dp=4, attain=1.0)] * 8
    + [sig(dp=4, attain=1.0, occ=0.0, mfu=0.0)] * 7
    + [sig(dp=4, attain=1.0, occ=0.0, mfu=0.0,
           states=["healthy", "probation", "healthy", "healthy"])] * 2
    + [sig(dp=3, attain=0.3, depth=5, storm=True)] * 3
    + [sig(dp=3, pressure=1)] * 3
    + [sig(dp=3, attain=1.0, occ=0.0, mfu=0.0, draining=True)] * 3
    + [sig(dp=4, attain=0.5, depth=8, pools=pools(1, 3, 6, 1))] * 3
    + [sig(dp=4, attain=1.0, occ=0.0, mfu=0.0, pools=pools(1, 3))] * 8
    + [sig(dp=2, attain=1.0, occ=0.0, mfu=0.0, pools=pools(1, 1))] * 8
    + [sig(dp=2, attain=0.2, wr=1, depth=3)] * 2
    + [sig(dp=2, attain=0.0,
           states=["quarantined", "quarantined"], depth=2)] * 3
)


def _cfg(mod, **over):
    base = mod.AutoscalerConfig(
        mode="recommend", interval_s=1.0, min_dp=1, max_dp=4,
        attain_out=0.9, attain_in=0.98, trend_out=0.5,
        idle_occupancy=0.25, idle_mfu=0.05, sustain_out=2, sustain_in=3,
        sustain_recover=2, cooldown_out_s=10.0, cooldown_in_s=20.0,
        ladder_cooldown_s=5.0, min_window_requests=3)
    return dataclasses.replace(base, **over)


def _masked(log):
    return [{k: v for k, v in e.items() if k not in ("t", "t_last")}
            for e in log]


def test_decide_and_replay_match_the_reference():
    out = []
    for mod in (ref, port):
        st = mod.ControllerState()
        c = _cfg(mod)
        direct = [mod.decide(s, st, c, float(t)).to_dict()
                  for t, s in enumerate(SCRIPT)]
        ctl = mod.AutoscalerController(cfg=_cfg(mod))
        replayed = [d.to_dict() for d in ctl.replay(SCRIPT)]
        out.append((direct, replayed, _masked(ctl.decisions), ctl.counters,
                    dataclasses.asdict(ctl.state), ctl.metrics_section(),
                    {k: v for k, v in ctl.snapshot().items()
                     if k != "decisions"},
                    {k: v for k, v in ctl.signals_section().items()
                     if k != "last_decision"}))
    assert out[1] == out[0]
    # the controller moves the ladder level that decide() reads
    actions = {d["action"] for d in out[1][1]}
    assert actions == {"hold", "scale_out", "scale_in", "degrade",
                       "recover"}
    vetoes = {v for d in out[1][1] for v in d.get("vetoes", [])}
    assert {"cooldown", "anomaly_active", "replica_probation",
            "compile_storm", "draining"} <= vetoes


def test_parse_mode_and_env_config(monkeypatch):
    for raw in (None, "", "0", "off", "1", "act", "on", "recommend", "dry",
                "shadow", "bogus"):
        assert port.parse_mode(raw) == ref.parse_mode(raw)
    for name, val in (("INTERVAL_S", "0.05"), ("MAX_DP", "3"),
                      ("SUSTAIN_OUT", "0"), ("ATTAIN_OUT", "x")):
        monkeypatch.setenv(f"KAFKA_TPU_AUTOSCALE_{name}", val)
        monkeypatch.setenv(f"KAFKA_TORCH_AUTOSCALE_{name}", val)
    monkeypatch.setenv("KAFKA_TPU_AUTOSCALE", "recommend")
    monkeypatch.setenv("KAFKA_TORCH_AUTOSCALE", "recommend")
    assert dataclasses.asdict(port.AutoscalerConfig.from_env()) == \
        dataclasses.asdict(ref.AutoscalerConfig.from_env())


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ModelConfig(**DIMS), params


class _Shim:
    """A provider stand-in: the router and a scripted signals feed."""

    def __init__(self, engine, snaps):
        self.engine = engine
        self.autoscaler = None
        self._snaps = list(snaps)

    def _replicas(self):
        return self.engine.engines

    def signals(self):
        return self._snaps.pop(0)


def test_ladder_rungs_down_and_up(model):
    jcfg, jparams, cfg, params = model
    routers = (
        (ref, jdp.DataParallelEngines(jcfg, jparams, JEngineConfig(**ECFG),
                                      dp=2, kv_dtype=jnp.float32)),
        (port, pdp.DataParallelEngines(cfg, params, EngineConfig(**ECFG),
                                       dp=2, kv_dtype=torch.float32,
                                       devices=["cpu"] * 2)))
    seen = []
    for mod, dp in routers:
        ladder = mod.DegradationLadder(_Shim(dp, []))
        states = []

        def state():
            return (ladder.level, dp.engines[0].ecfg.max_waiting,
                    [e.spec_k_cap for e in dp.engines],
                    mod.background_deferred())

        for level in (1, 2, 3, 2, 1, 0):
            ladder.apply(level)
            states.append(state())
        ladder.apply(3)
        ladder.apply(0)
        states.append(state())
        seen.append(states)
    assert seen[1] == seen[0]
    assert seen[1][:4] == [(1, 10, [None, None], False),
                           (2, 10, [0, 0], False),
                           (3, 10, [0, 0], True),
                           (2, 10, [0, 0], False)]
    assert seen[1][-1] == (0, 40, [None, None], False)
    # the rung the flag sets is the one the port's consumers read: the KV
    # tier refuses a demotion (the caller falls back to plain eviction)
    # without touching its shipper
    from kafka_tpu_torch.runtime.kv_tier import KVTierManager

    class _NoShipper:
        def __getattr__(self, name):
            raise AssertionError(f"demote touched the shipper ({name})")

    tier = KVTierManager(_NoShipper(), host_budget_bytes=1 << 20)
    port.set_background_deferred(True)
    assert tier.demote([1, 2]) is None
    port.set_background_deferred(False)


def test_recommend_mode_acts_on_nothing(model):
    _, _, cfg, params = model
    dp = pdp.DataParallelEngines(cfg, params, EngineConfig(**ECFG), dp=2,
                                 kv_dtype=torch.float32,
                                 devices=["cpu"] * 4)
    resizes = []
    snaps = [sig(dp=2, attain=0.3, depth=9)] * 4 + [
        sig(dp=4, attain=0.3, depth=9)] * 6
    shim = _Shim(dp, snaps)
    ctl = port.AutoscalerController(
        shim, _cfg(port, max_dp=None, ladder_cooldown_s=0.0),
        resize_fn=lambda n, roles: resizes.append((n, roles)))
    assert shim.autoscaler is ctl and ctl.cfg.max_dp == 4
    decisions = [ctl.poll_once(now=float(t)) for t in range(len(snaps))]
    assert resizes == [] and len(dp.engines) == 2
    assert [e.spec_k_cap for e in dp.engines] == [None, None]
    assert dp.engines[0].ecfg.max_waiting == 40
    assert not port.background_deferred()
    outcomes = [e["outcome"] for e in ctl.decisions]
    assert "recommend_only" in outcomes
    assert any(d.action == "scale_out" for d in decisions)
    assert ctl.state.ladder > 0  # the recommended rung, never applied


@pytest.mark.parametrize("mod", [ref, port], ids=["ref", "port"])
def test_start_then_stop_leaves_no_thread(mod):
    polled = threading.Event()

    class Feed:
        engine = None
        autoscaler = None

        def signals(self):
            polled.set()
            return sig()

    ctl = mod.AutoscalerController(Feed(), _cfg(mod, interval_s=3600.0))
    ctl.start()
    assert polled.wait(10.0)
    ctl.stop()
    assert ctl._thread is None
    assert ctl.counters["autoscaler_polls"] == 1
