"""kafka_tpu_torch telemetry modules against the JAX package's, on the CPU.

The port's metrics registry, Prometheus renderer, memory planner, flight
recorder and compile observatory are copies adapted to PyTorch; the same
calls must give the same results in both packages:

* the registry: one scripted event sequence (durations from a numpy
  seed, `time` replaced by one fake clock in both modules) gives equal
  snapshots, key for key and value for value (exact);
* Prometheus: the same snapshot renders to the same text — every TYPE
  and sample line exact, HELP lines exact but for the environment
  prefix (KAFKA_TPU_ -> KAFKA_TORCH_) and the two compile families,
  whose help names this package's compile sources; the text passes the
  reference's format checker (tests/test_prometheus.py);
* the planner: plan_memory and dispatch_cost_model give equal numbers
  for the same config and memory size (exact); device_peaks reads
  "unknown" off an H100 and the env override as the reference does;
* the recorders: the flight recorder's records, snapshot and postmortem
  and the compile observatory's records and sections are equal for the
  same calls (exact, wall offsets pinned).

No test leaves a thread, an environment variable (monkeypatch only), a
file outside tmp_path or an open profiler behind.
"""

import json
import os
import threading
import time as _time

import numpy as np
import pytest
import torch

from kafka_tpu.runtime import compile_log as rcomp
from kafka_tpu.runtime import flight_recorder as rflight
from kafka_tpu.runtime import metrics as rmetrics
from kafka_tpu.runtime import planner as rplanner
from kafka_tpu.server import prometheus as rprom
from kafka_tpu_torch.runtime import compile_log as pcomp
from kafka_tpu_torch.runtime import flight_recorder as pflight
from kafka_tpu_torch.runtime import metrics as pmetrics
from kafka_tpu_torch.runtime import planner as pplanner
from kafka_tpu_torch.server import prometheus as pprom
from test_prometheus import parse_exposition, validate_histogram_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    """No thread outlives the test and no profiler stays open."""
    before = set(threading.enumerate())
    yield
    deadline = _time.monotonic() + 5.0
    while True:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra or _time.monotonic() > deadline:
            break
        _time.sleep(0.02)
    assert not extra, f"threads left running: {extra}"
    assert not torch.autograd._profiler_enabled()


class FakeClock:
    """A module's `time`: monotonic and wall time from one counter."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, installed in its metrics, flight
    recorder and compile observatory modules."""
    out = []
    for mods in ((rmetrics, rflight, rcomp), (pmetrics, pflight, pcomp)):
        c = FakeClock()
        for m in mods:
            monkeypatch.setattr(m, "time", c)
        out.append(c)
    return out


def _env_clean(monkeypatch):
    for name in ("TELEMETRY", "SLO_TTFT_MS", "SLO_TPOT_MS", "PEAK_TFLOPS",
                 "PEAK_HBM_GBPS", "FLIGHT_RING", "FLIGHT_DIR",
                 "TRACE_PERSIST_DIR", "ANOMALY_STALL_S",
                 "ANOMALY_CONVOY_S", "ANOMALY_MFU_FRAC", "COMPILE_RING",
                 "COMPILE_STORM_N", "COMPILE_STORM_S", "HBM_WATERMARK"):
        for prefix in ("KAFKA_TPU_", "KAFKA_TORCH_"):
            monkeypatch.delenv(prefix + name, raising=False)


def script(m, clock, seed: int) -> None:
    """A scripted serving history: submissions, queue depths, prefill and
    decode dispatches with modeled costs, bursts, tokens, verify rounds,
    finishes of every kind, rejections, preemptions, idle gaps."""
    rng = np.random.RandomState(seed)
    m.set_roofline(989e12, 3.35e12, "datasheet")
    for i in range(12):
        clock.advance(float(rng.uniform(0.001, 0.02)))
        m.record_submit(int(rng.randint(5, 400)))
        m.record_queue_depth(int(rng.randint(0, 9)))
        kind = ("prefill", "decode", "verify")[i % 3]
        m.record_dispatch_cost(kind, int(rng.randint(1, 64)),
                               float(rng.uniform(1e9, 5e11)),
                               float(rng.uniform(1e8, 5e9)))
        m.record_decode_step(int(rng.randint(1, 9)),
                             steps=int(rng.choice([1, 16])))
        m.record_measured_dispatch(kind, float(rng.uniform(1e-4, 3e-3)),
                                   float(rng.uniform(1e-4, 5e-3)))
        if i % 4 == 0:
            m.record_kernel_sample(kind, float(rng.uniform(1e-4, 2e-3)),
                                   float(rng.uniform(1e-4, 2e-3)))
        m.record_emit_burst(int(rng.randint(1, 40)))
        for _ in range(int(rng.randint(1, 6))):
            m.record_token()
        m.record_wasted_token(int(rng.randint(0, 3)))
        m.record_verify_dispatch(int(rng.randint(0, 5)))
        m.record_verify_drain(int(rng.randint(0, 3)), int(rng.randint(0, 3)))
        m.constrained_ondevice_tokens += int(rng.randint(0, 4))
        m.constrained_roundtrips += int(rng.randint(0, 2))
        ttft = float(rng.uniform(0.01, 0.4))
        m.record_first_token(ttft)
        t = clock.t
        m.record_ttft_breakdown(t - ttft, t - ttft * 0.6, t - ttft * 0.2, t)
        reason = ("stop", "length", "timeout", "error:engine",
                  "cancelled", None)[i % 6]
        m.record_finish(reason, ttft_s=ttft,
                        tpot_s=float(rng.uniform(0.002, 0.06)),
                        tokens=int(rng.randint(1, 90)))
        if i % 5 == 0:
            m.record_rejected()
            m.record_preempt()
        if i == 7:
            m.mark_idle()
            clock.advance(3.0)
    m.anomaly_queue_stall += 1
    m.anomaly_hbm_pressure += 2
    clock.advance(0.5)


def both_registries(clocks, seed: int = 0):
    out = []
    for mod, clock in zip((rmetrics, pmetrics), clocks):
        m = mod.EngineMetrics()
        script(m, clock, seed)
        out.append(m)
    return out


class FakePool:
    num_pages, free_pages = 200, 150


class FakeEcfg:
    max_batch = 8


class FakeCfg:
    attention_backend = "kernel"


class FakePrefixCache:
    hits, misses, tokens_reused, cross_thread_hits = 5, 2, 96, 4
    host_tier_hits = shipped_hits = object_tier_hits = 0
    host_nodes = host_pages = 0
    evictions, pages_evicted, total_pages = 1, 2, 11

    def __len__(self):
        return 3


class FakeEngine:
    """The engine attributes the snapshot's engine sections read."""

    num_active = 3
    waiting = [object()] * 2
    _pending = [object()] * 4
    pool, ecfg, cfg = FakePool(), FakeEcfg(), FakeCfg()
    _rtt_est = 0.00123
    prefix_cache = FakePrefixCache()
    kv_tier = flight = memory_monitor = None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_equals_the_reference(clocks, monkeypatch, seed):
    _env_clean(monkeypatch)
    ref, port = both_registries(clocks, seed)
    assert port.snapshot(FakeEngine()) == ref.snapshot(FakeEngine())
    # a second scrape: peak-since-last re-armed identically
    assert port.snapshot() == ref.snapshot()
    assert port.recent_tpot_s() == ref.recent_tpot_s()
    assert port.queue_trend_per_s() == ref.queue_trend_per_s()


def test_registry_slo_targets_and_kill_switch(clocks, monkeypatch):
    """configure_slo, the SLO env targets and KAFKA_*_TELEMETRY=0 act
    alike: the same verdicts, and no per-dispatch recording when off."""
    _env_clean(monkeypatch)
    monkeypatch.setenv("KAFKA_TPU_SLO_TTFT_MS", "120")
    monkeypatch.setenv("KAFKA_TORCH_SLO_TTFT_MS", "120")
    monkeypatch.setenv("KAFKA_TPU_TELEMETRY", "0")
    monkeypatch.setenv("KAFKA_TORCH_TELEMETRY", "0")
    try:
        for mod in (rmetrics, pmetrics):
            mod.configure_slo(tpot_ms=25.0)
        ref, port = both_registries(clocks, 3)
        assert port.slo_tpot_ms == ref.slo_tpot_ms == 25.0
        assert port.slo_ttft_ms == ref.slo_ttft_ms == 120.0
        assert port.snapshot() == ref.snapshot()
        assert port.util["decode"].dispatches == 0
    finally:
        for mod in (rmetrics, pmetrics):
            mod.configure_slo()


def test_registry_keys_and_export_lint_equal():
    """Every key tuple and the export lint are the reference's, and every
    dataclass field is exported or excluded (both directions)."""
    import dataclasses

    for name in ("SPECULATION_METRIC_KEYS", "CONSTRAINED_METRIC_KEYS",
                 "KV_TIER_METRIC_KEYS", "OBJECT_TIER_METRIC_KEYS",
                 "DISAGG_METRIC_KEYS", "SLO_METRIC_KEYS",
                 "UTILIZATION_METRIC_KEYS", "UTILIZATION_KINDS",
                 "FLIGHT_METRIC_KEYS", "ANOMALY_METRIC_KEYS",
                 "AUTOSCALER_METRIC_KEYS", "COMPILE_METRIC_KEYS",
                 "MEMORY_METRIC_KEYS", "AGENT_METRIC_KEYS",
                 "ENGINE_METRIC_EXPORTS", "ENGINE_METRIC_EXCLUDED",
                 "HISTOGRAM_NAMES", "LATENCY_MS_BOUNDS",
                 "BURST_TOKEN_BOUNDS"):
        assert getattr(pmetrics, name) == getattr(rmetrics, name), name
    fields = {f.name for f in dataclasses.fields(pmetrics.EngineMetrics)}
    assert fields == set(pmetrics.ENGINE_METRIC_EXPORTS) | set(
        pmetrics.ENGINE_METRIC_EXCLUDED)


def test_histograms_merge_and_supervisor_sections_equal(clocks):
    rng = np.random.RandomState(4)
    vals = rng.lognormal(2.0, 1.5, 500).tolist()
    outs = []
    for mod in (rmetrics, pmetrics):
        hs = [mod.StreamingHistogram() for _ in range(3)]
        for i, v in enumerate(vals):
            hs[i % 3].record(v)
        merged = mod.StreamingHistogram.merged(hs)
        back = mod.StreamingHistogram.from_snapshot(merged.snapshot())
        ring = mod._WindowRing(2, span_s=60.0)
        for i, v in enumerate(vals[:50]):
            ring.add((v, 1.0), now=1000.0 + i)
        sup = mod.ReplicaSupervisorMetrics(quarantines=2, rebuilds=1)
        dis = mod.DisaggMetrics()
        dis.record_ship(4, 4096, 0.003, transport="device")
        outs.append((merged.snapshot(), back.quantiles((50, 90, 99, 100)),
                     ring.sums(30.0, now=1049.0), sup.snapshot(),
                     dis.snapshot()))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------

# families whose help text names this package's compile sources
_PORT_HELP = ("kafka_tpu_compiles_total", "kafka_tpu_compile_seconds_total")


def full_snapshot(clocks):
    ref, _ = both_registries(clocks, 5)
    snap = ref.snapshot(FakeEngine())
    snap["requests"]["slow"] = 1
    snap["sandbox"] = {"crashes": 2, "restarts": 1, "crash_loops": 0,
                       "reaped": 2}
    snap["tracing"] = {"traces": 7, "stitched_spans": 3, "slow": 1}
    snap["flight"] = {"flight_ring_size": 256, "flight_records": 77,
                      "flight_postmortems": 1}
    snap["kv_tier"] = {k: i for i, k in
                       enumerate(rmetrics.KV_TIER_METRIC_KEYS)}
    snap["object_tier"] = {k: i + 1 for i, k in
                           enumerate(rmetrics.OBJECT_TIER_METRIC_KEYS)}
    dis = rmetrics.DisaggMetrics()
    dis.record_ship(3, 1 << 20, 0.002)
    snap["disagg"] = dict(dis.snapshot(), pools=[
        {"role": "prefill", "replicas": [0], "queue_depth": 2,
         "batch_occupancy": 0.5},
        {"role": "decode", "replicas": [1, 2], "queue_depth": 0,
         "batch_occupancy": 3.2}])
    snap["autoscaler"] = {k: i for i, k in
                          enumerate(rmetrics.AUTOSCALER_METRIC_KEYS)}
    snap["compiles"] = {"compiles_total": 9, "compile_seconds_total": 3.5,
                        "compile_storm_active": 0, "compile_storms_total": 1,
                        "by_cache": {"hit": 5, "miss": 4, "off": 0},
                        "by_phase": {"boot": 5, "warmup": 3,
                                     "first_traffic": 1, "rebuild": 0}}
    snap["memory"] = {"source": "device", "hbm_bytes_in_use": 7 << 30,
                      "hbm_bytes_peak": 8 << 30, "hbm_bytes_limit": 80 << 30,
                      "hbm_headroom_bytes": 73 << 30, "hbm_plan_skew": 1.03,
                      "hbm_pressure": 0, "hbm_component_bytes": {
                          "weights": 5 << 30, "kv_pool": 1 << 30,
                          "graph_pool": 1 << 28, "unattributed": -4096}}
    snap["agent"] = {k: i for i, k in enumerate(rmetrics.AGENT_METRIC_KEYS)}
    snap["replica_supervisor"] = {"health": [1.0, 0.5], "quarantines": 1,
                                  "readmits": 1, "rebuilds": 0}
    snap["dp"] = 2
    snap["replicas"] = [ref.snapshot(), ref.snapshot()]
    return snap


def _help_normalized(text: str):
    out = []
    for line in text.splitlines():
        if line.startswith("# HELP ") and line.split(" ")[2] in _PORT_HELP:
            out.append(" ".join(line.split(" ")[:3]))
        else:
            out.append(line.replace("KAFKA_TPU_", "KAFKA_TORCH_"))
    return out


@pytest.mark.parametrize("shape", ["engine", "full", "legacy"])
def test_prometheus_text_equals_the_reference(clocks, shape):
    if shape == "engine":
        ref, _ = both_registries(clocks, 6)
        snap = ref.snapshot(FakeEngine())
    elif shape == "full":
        snap = full_snapshot(clocks)
    else:  # a snapshot without histograms: the summary fallback
        ref, _ = both_registries(clocks, 7)
        snap = ref.snapshot()
        del snap["histograms"]
    want = rprom.render_prometheus(json.loads(json.dumps(snap)))
    got = pprom.render_prometheus(json.loads(json.dumps(snap)))
    assert _help_normalized(got) == _help_normalized(want)
    assert [ln for ln in got.splitlines() if not ln.startswith("# HELP")] \
        == [ln for ln in want.splitlines() if not ln.startswith("# HELP")]
    families, samples = parse_exposition(got)
    if shape != "legacy":
        for fam in ("kafka_tpu_ttft_milliseconds",
                    "kafka_tpu_tpot_milliseconds"):
            validate_histogram_family(families, samples, fam)
    assert "KAFKA_TPU_" not in got


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _model_pair(name):
    from kafka_tpu.models.config import get_config as rget
    from kafka_tpu_torch.models import get_config as pget

    return rget(name), pget(name)


@pytest.mark.parametrize("name,quantize,kv", [
    ("llama-3.2-1b", "", "bfloat16"),
    ("llama-3.2-1b", "int8", "int8"),
    ("llama-3-8b", "", "bfloat16"),
    ("tiny-gqa", "", "bfloat16"),
])
def test_plan_memory_equals_the_reference(monkeypatch, name, quantize, kv):
    _env_clean(monkeypatch)
    rcfg, pcfg = _model_pair(name)
    hbm = 80 * 1024**3
    for tp in (1, 2, 8):
        kw = dict(tp=tp, num_pages=2112, page_size=16, max_pages_per_seq=256,
                  max_batch=8, prefill_bucket=2048, quantize=quantize,
                  kv_dtype=kv, hbm_bytes=hbm, grammar_table_bytes=1 << 22)
        want = rplanner.plan_memory(rcfg, **kw)
        got = pplanner.plan_memory(pcfg, **kw)
        assert got.summary() == want.summary()
        assert (got.total_bytes, got.usable_bytes, got.fits,
                got.max_concurrent_windows) == (
            want.total_bytes, want.usable_bytes, want.fits,
            want.max_concurrent_windows)


def test_plan_for_serving_and_grammar_charge_equal(monkeypatch):
    """The serving configuration's plan, with the grammar-table charge
    read from each package's own env knob (same value)."""
    from kafka_tpu.server.config import ServingConfig as RServing
    from kafka_tpu_torch.server import ServingConfig as PServing

    _env_clean(monkeypatch)
    monkeypatch.setenv("KAFKA_TPU_GRAMMAR_TABLE_MB", "12")
    monkeypatch.setenv("KAFKA_TORCH_GRAMMAR_TABLE_MB", "12")
    kw = dict(model_name="llama-3.2-1b", max_batch=8, page_size=16,
              num_pages=2112, max_pages_per_seq=256,
              prefill_buckets=(64, 256, 2048))
    rcfg, pcfg = _model_pair("llama-3.2-1b")
    want = rplanner.plan_for_serving(RServing(**kw), hbm_bytes=80 << 30,
                                     model_cfg=rcfg)
    got = pplanner.plan_for_serving(PServing(**kw), 80 << 30,
                                    model_cfg=pcfg)
    assert got.summary() == want.summary()
    assert got.grammar_table_bytes == 12 << 20


@pytest.mark.parametrize("name", ["llama-3.2-1b", "llama-3-8b", "tiny"])
def test_dispatch_cost_model_equals_the_reference(name):
    rcfg, pcfg = _model_pair(name)
    for kw in (dict(), dict(weight_bytes_total=1_234_567_890,
                            kv_dtype_bytes=1, kv_replication=2,
                            n_devices=4)):
        want = rplanner.dispatch_cost_model(rcfg, **kw)
        got = pplanner.dispatch_cost_model(pcfg, **kw)
        assert got == pplanner.DispatchCostModel(**vars(want))
        for args in ((8, 2048, 1), (3, 700, 16)):
            assert got.decode_cost(*args) == want.decode_cost(*args)
        assert got.prefill_cost(512, 1024) == want.prefill_cost(512, 1024)
        assert got.verify_cost(40, 3000, 15000.0) == \
            want.verify_cost(40, 3000, 15000.0)


def test_device_peaks_unknown_off_the_card_and_env_override(monkeypatch):
    """A device the planner does not know reads "unknown" (never a
    guess); the env override reads as the reference's; the H100 figures
    are the datasheet's."""
    _env_clean(monkeypatch)
    assert pplanner.device_peaks("cpu") == (None, None, "unknown")
    monkeypatch.setenv("KAFKA_TORCH_PEAK_TFLOPS", "0.05")
    monkeypatch.setenv("KAFKA_TORCH_PEAK_HBM_GBPS", "5")
    monkeypatch.setenv("KAFKA_TPU_PEAK_TFLOPS", "0.05")
    monkeypatch.setenv("KAFKA_TPU_PEAK_HBM_GBPS", "5")
    assert pplanner.device_peaks("cpu") == rplanner.device_peaks(object())
    assert pplanner.H100_SXM_PEAKS == (989e12, 3.35e12)
    assert pplanner.hbm_for_device("cpu") is None


def test_memory_monitor_from_the_plan_on_the_cpu(monkeypatch):
    """Without allocator stats the sample is synthesized from the plan,
    as the reference does off a TPU (source "plan", skew 1.0, the same
    section)."""
    _env_clean(monkeypatch)
    rcfg, pcfg = _model_pair("llama-3.2-1b")
    kw = dict(num_pages=512, page_size=16, max_pages_per_seq=64,
              max_batch=4, hbm_bytes=40 << 30, grammar_table_bytes=0)

    class NoStats:
        def memory_stats(self):
            return None

    want = rplanner.MemoryMonitor([NoStats()], plan=rplanner.plan_memory(
        rcfg, **kw), poll_s=0.0).poll()
    mm = pplanner.MemoryMonitor(["cpu"], plan=pplanner.plan_memory(
        pcfg, **kw), poll_s=0.0)
    assert mm.poll() == want
    assert want["source"] == "plan" and want["hbm_plan_skew"] == 1.0
    assert not mm.pressure()


# ---------------------------------------------------------------------------
# the flight recorder and the compile observatory
# ---------------------------------------------------------------------------


class FlightEngine:
    """What FlightRecorder.finish_step reads off an engine."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.waiting, self.parked, self._pending = [], [], []
        self.num_active, self._pending_steps = 0, 0
        self.pool, self.prefix_cache = FakePool(), None
        self.memory_monitor = None
        self._requests = {}


def drive_flight(mod, metrics_mod, clock, seed):
    rng = np.random.RandomState(seed)
    fr = mod.FlightRecorder(16)
    fr._wall_off = 0.0
    eng = FlightEngine(metrics_mod.EngineMetrics())
    eng.metrics.set_roofline(989e12, 3.35e12, "datasheet")
    for i in range(40):
        clock.advance(float(rng.uniform(0.001, 0.05)))
        if i % 3 == 0:
            fr.note_prefill(int(rng.randint(1, 4)), int(rng.randint(16, 900)))
        if i % 2:
            k = int(rng.choice([1, 16]))
            fr.note_dispatch(mod.KIND_MULTI if k > 1 else mod.KIND_DECODE,
                             8, 8 * k, steps=k)
        if i % 7 == 0:
            fr.note_dispatch(mod.KIND_VERIFY, 4, 12)
            fr.note_spec(8)
        fr.note_cost(float(rng.uniform(1e9, 1e12)),
                     float(rng.uniform(1e8, 1e10)),
                     float(rng.uniform(1e-4, 3e-3)))
        fr.note_measured(float(rng.uniform(1e-4, 4e-3)))
        fr.note_pop(int(rng.randint(0, 30)))
        for cause in mod.CAUSES[:10]:
            if rng.rand() < 0.2:
                fr.note_cause(cause)
        if i % 9 == 0:
            fr.note_gate_reject()
        fr.note_constrained(0, int(rng.randint(0, 2)))
        eng.waiting = [object()] * int(rng.randint(0, 3))
        eng.num_active = int(rng.randint(0, 8))
        fr.finish_step(eng)
    # a stall: the queue waits past the bound with no dispatch
    eng.waiting = [object()]
    clock.advance(6.0)
    fr.finish_step(eng)
    return fr, eng


def test_flight_recorder_records_equal_the_reference(clocks, monkeypatch,
                                                     tmp_path):
    _env_clean(monkeypatch)
    # no process observatory: the compile-storm detector stays quiet in both
    monkeypatch.setattr(rcomp, "_OBS", None)
    monkeypatch.setattr(pcomp, "_OBS", None)
    out = []
    for i, (mod, mmod) in enumerate(((rflight, rmetrics),
                                     (pflight, pmetrics))):
        monkeypatch.setenv(("KAFKA_TPU_" if i == 0 else "KAFKA_TORCH_")
                           + "FLIGHT_DIR", str(tmp_path / f"pm{i}"))
        fr, eng = drive_flight(mod, mmod, clocks[i], 8)
        path = fr.dump_postmortem("engine_failure", lanes=[{"a": 1}],
                                  metrics_snapshot={"m": 2})
        with open(path) as f:
            dump = json.load(f)
        for key in ("pid", "t_wall"):
            dump.pop(key)
        out.append((fr.snapshot(), eng.metrics.anomalies_snapshot(fr),
                    os.path.basename(path).replace(str(os.getpid()), "P"),
                    dump))
    assert out[1] == out[0]
    snap = out[1][0]
    assert snap["records"] and snap["anomalies"]["active"][0]["kind"] == \
        "queue_stall"
    assert list(pflight.CAUSES) == list(rflight.CAUSES)
    assert pflight.ring_default() == rflight.ring_default() == 256


def test_postmortems_pruned_and_named_like_the_reference(tmp_path,
                                                         monkeypatch):
    _env_clean(monkeypatch)
    d = tmp_path / "pm"
    monkeypatch.setenv("KAFKA_TORCH_FLIGHT_DIR", str(d))
    fr = pflight.FlightRecorder(4)
    for i in range(pflight.POSTMORTEM_KEEP + 3):
        assert fr.dump_postmortem(f"../evil/{i}") is not None
    names = pflight.list_postmortems(str(d))
    assert len(names) == pflight.POSTMORTEM_KEEP == rflight.POSTMORTEM_KEEP
    assert all(os.path.dirname(n) == str(d) for n in names)
    assert pflight.sanitize_name("../x y") == rflight.sanitize_name("../x y")


def drive_compiles(mod, clock):
    obs = mod.CompileObservatory(6)
    for i, phase in enumerate(("boot", "boot", "warmup", "first_traffic",
                               "first_traffic", "first_traffic",
                               "first_traffic", "rebuild")):
        obs.phase = phase
        clock.advance(1.5)
        obs.record(f"prog[{i}]", 0.25 * i,
                   cache=("hit" if i == 1 else None))
    sections = (obs.metrics_section(), obs.signals_section(),
                obs.snapshot(), obs.storm_active())
    clock.advance(120.0)
    return sections + (obs.storm_active(), obs.metrics_section())


def test_compile_observatory_equals_the_reference(clocks, monkeypatch):
    _env_clean(monkeypatch)
    want = drive_compiles(rcomp, clocks[0])
    got = drive_compiles(pcomp, clocks[1])
    assert got == want
    assert want[3] is True and want[4] is False  # a storm, then quiet
    assert pcomp.PHASES == rcomp.PHASES
    assert pcomp.ring_default() == 256


def test_compile_record_is_a_noop_while_off(monkeypatch):
    monkeypatch.setattr(pcomp, "_OBS", None)
    pcomp.record("nvcc[x]", 1.0)
    assert pcomp.get() is None
    monkeypatch.setenv("KAFKA_TORCH_COMPILE_RING", "0")
    assert pcomp.init() is None
    monkeypatch.setenv("KAFKA_TORCH_COMPILE_RING", "8")
    obs = pcomp.init()
    pcomp.set_phase("warmup")
    pcomp.record("decode_graph[k=1]", 0.5)
    assert obs.records()[0]["phase"] == "warmup" and obs.size == 8


def test_dispatch_busy_from_device_seconds(clocks, monkeypatch):
    """record_dispatch_cost(..., busy_s=) — the card's rule — charges a
    dispatch its own device seconds, whatever the host's gaps; without
    busy_s the reference's gap rule stands, equal to the reference."""
    _env_clean(monkeypatch)
    ref, port = rmetrics.EngineMetrics(), pmetrics.EngineMetrics()
    for m in (ref, port):
        m.set_roofline(989e12, 3.35e12, "datasheet")
    for i in range(4):
        for m, clock in zip((ref, port), clocks):
            clock.advance(0.0005)  # the host runs ahead of the device
            m.record_dispatch_cost("decode", 8, 2e10, 2.5e9)
    assert port.utilization_snapshot() == ref.utilization_snapshot()
    card = pmetrics.EngineMetrics()
    card.set_roofline(989e12, 3.35e12, "datasheet")
    for i in range(4):
        clocks[1].advance(0.0005)
        card.record_dispatch_cost("decode", 8, 2e10, 2.5e9, busy_s=0.0031)
    dec = card.utilization_snapshot()["decode"]
    assert dec["dispatches"] == 4 and dec["busy_s"] == round(4 * 0.0031, 3)
    assert dec["hbm_bw_util"] == round(2.5e9 / (0.0031 * 3.35e12), 4)
    assert dec["hbm_bw_util_1m"] == dec["hbm_bw_util"]
    assert ref.utilization_snapshot()["decode"]["hbm_bw_util"] > 1.0
