"""The port's telemetry wired through its engine, worker and server.

* Engine counters: both engines on the same weights and requests at
  fetch_lag 0 (every fetch is processed in the step that dispatched it,
  so scheduling is the same): the counters that do not depend on timing
  are equal (exact) — requests, prompt and generated tokens, decode
  steps and busy slots, fetch-pipeline waste, prefix-cache reuse,
  speculation proposed / accepted / rejected / verify steps, and the
  constrained keys on the device-FSM path.
* The routes: /metrics (JSON and Prometheus), /admin/signals,
  /debug/flight/{replica}, /debug/compiles, /debug/kernels and
  /debug/profile on a tiny CPU server return the reference's keys (the
  same key tree; for the two routes that would run the reference's
  profiler, the keys of its sampler's and capture's payloads).
* Wiring on the port alone: the flight ring's causes and measured
  dispatch time, MFU against an env roofline, a failed step's
  postmortem, the kernel sampler on the CPU, the profile capture's
  gates, and no KAFKA_TPU_ name anywhere in the package.

Hygiene: the environment is set through monkeypatch only, every dump and
spill directory is under tmp_path, an autouse fixture fails a test that
leaves a thread running or a profiler open, and another puts back the
process-wide tracing config, trace ring and SLO targets that create_app
and a traced turn change.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.llm import constrained as jcon
from kafka_tpu.models import llama as jllama
from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu.runtime import compile_log as rcomp
from kafka_tpu.runtime import kernel_profiler as rkp
from kafka_tpu_torch import failpoints as pfp
from kafka_tpu_torch.llm import constrained as pcon
from kafka_tpu_torch.models import ByteTokenizer, get_config, params_from_jax
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime import compile_log as pcomp
from kafka_tpu_torch.runtime import kernel_profiler as pkp
from kafka_tpu_torch.runtime.flight_recorder import list_postmortems

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 262


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    """No thread outlives the test and no profiler stays open."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while True:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not extra, f"threads left running: {extra}"
    assert not torch.autograd._profiler_enabled()


@pytest.fixture(autouse=True)
def _process_state_restored(monkeypatch):
    """create_app sets each package's process-wide tracing config and
    SLO targets, and a traced turn adds to its trace ring: all of it is
    put back after the test, so a later test file in this process reads
    what it would have read without this one."""
    from collections import OrderedDict

    from kafka_tpu import tracing as rtracing
    from kafka_tpu.runtime import metrics as rmetrics
    from kafka_tpu_torch import tracing as ptracing
    from kafka_tpu_torch.runtime import metrics as pmetrics

    for mod in (rtracing, ptracing):
        for name in ("_sample", "_capacity", "_span_cap", "_slow_ttft_ms",
                     "_slow_total_ms", "_profiling", "_persist_dir"):
            monkeypatch.setattr(mod, name, getattr(mod, name))
        monkeypatch.setattr(mod, "_traces", OrderedDict(mod._traces))
        monkeypatch.setattr(mod, "_by_request", dict(mod._by_request))
        monkeypatch.setattr(mod, "_counters", dict(mod._counters))
    for mod in (rmetrics, pmetrics):
        monkeypatch.setattr(mod, "_slo_override", dict(mod._slo_override))


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    """Each package's telemetry knobs unset, and no process compile
    observatory, for the length of the test."""
    for name in ("TELEMETRY", "SLO_TTFT_MS", "SLO_TPOT_MS", "PEAK_TFLOPS",
                 "PEAK_HBM_GBPS", "FLIGHT_RING", "FLIGHT_DIR",
                 "TRACE_PERSIST_DIR", "PROFILE_SAMPLE", "PROFILE_SPILL_DIR",
                 "PROFILING", "HBM_WATERMARK", "FAILPOINTS"):
        for prefix in ("KAFKA_TPU_", "KAFKA_TORCH_"):
            monkeypatch.delenv(prefix + name, raising=False)
    monkeypatch.setattr(rcomp, "_OBS", None)
    monkeypatch.setattr(pcomp, "_OBS", None)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-gqa").replace(vocab_size=V, dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    cfg = get_config("tiny-gqa").replace(vocab_size=V, dtype="float32")
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


SHAPE = dict(max_batch=3, page_size=8, num_pages=48, max_pages_per_seq=12,
             prefill_buckets=(8, 16, 32), fetch_lag=0, multi_step=1,
             max_parked=0)


def engines(model, **kw):
    jcfg, jparams, cfg, params = model
    ref = JInferenceEngine(
        jcfg, jparams, JEngineConfig(**{**SHAPE, **kw},
                                     attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)
    port = InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")
    return {"ref": (ref, JGenRequest), "port": (port, GenRequest)}


COUNTERS = ("requests_submitted", "requests_finished", "requests_preempted",
            "prompt_tokens", "generated_tokens", "decode_steps",
            "decode_busy_slots", "fetch_pipeline_wasted_tokens",
            "speculation_proposed_tokens", "speculation_accepted_tokens",
            "speculation_rejected_tokens", "speculation_verify_steps",
            "constrained_roundtrips", "constrained_mask_overtight",
            "constrained_ondevice_tokens")


def counters(eng):
    m = eng.metrics
    out = {k: getattr(m, k) for k in COUNTERS}
    snap = m.snapshot(eng)
    out["constrained"] = snap["constrained"]
    out["speculation"] = snap["speculation"]
    out["requests"] = snap["requests"]
    out["tokens"] = {k: snap["tokens"][k] for k in
                     ("prompt", "generated", "fetch_pipeline_wasted")}
    pc = snap.get("prefix_cache")
    out["prefix_cache"] = pc and {k: pc[k] for k in (
        "hits", "misses", "tokens_reused", "cross_thread_hits",
        "cached_pages", "nodes")}
    return out


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_counters_equal_the_reference(model, spec_k):
    """Five requests through three slots on two threads (prefix keys), a
    repetitive one the n-gram proposer engages on, then a second turn on
    thread t0 that reuses its cached pages."""
    out = {}
    for side, (eng, Req) in engines(model, speculative_k=spec_k).items():
        for i, p in enumerate(prompts(0, [5, 12, 40, 9, 30])):
            eng.submit(Req(request_id=f"r{i}", prompt_ids=p,
                           max_new_tokens=10, prefix_key=f"t{i % 2}"))
        eng.submit(Req(request_id="rep", prompt_ids=[7, 8, 9, 10] * 6,
                       max_new_tokens=20))
        done = eng.run_to_completion()
        turn2 = prompts(0, [5])[0] + done["r0"].output_ids + [1, 2, 3]
        eng.submit(Req(request_id="turn2", prompt_ids=turn2,
                       max_new_tokens=6, prefix_key="t0"))
        done.update(eng.run_to_completion())
        out[side] = (counters(eng), {k: list(r.output_ids)
                                     for k, r in done.items()})
    assert out["port"] == out["ref"]
    got = out["port"][0]
    assert got["decode_steps"] > 0 and got["prefix_cache"]["hits"] > 0
    if spec_k:
        assert got["speculation_accepted_tokens"] > 0


def test_constrained_counters_equal_the_reference(model):
    """A device-FSM tool-call lane beside a free one: the constrained
    keys (FSM tokens, no round trips, no over-tight rows) are equal."""
    toks = {"ref": (jcon, jax_get_config), "port": (pcon, get_config)}
    out = {}
    for side, (eng, Req) in engines(model, max_pages_per_seq=24,
                                    num_pages=64).items():
        con = toks[side][0]
        tok = ByteTokenizer() if side == "port" else \
            __import__("kafka_tpu.models.tokenizer",
                       fromlist=["ByteTokenizer"]).ByteTokenizer()
        tools = [{"type": "function", "function": {
            "name": "get_time",
            "parameters": {"type": "object", "properties": {}}}}]
        g = con.compile_tool_call_grammar(tok, tools, vocab_size=V)
        eng.submit(Req(request_id="con", prompt_ids=tok.encode("call it"),
                       max_new_tokens=60, stop_token_ids=tuple(tok.stop_ids),
                       logits_mask_fn=con.ToolCallMaskFn(tok, tools),
                       grammar=g))
        eng.submit(Req(request_id="free", prompt_ids=prompts(1, [9])[0],
                       max_new_tokens=12))
        done = eng.run_to_completion()
        out[side] = (counters(eng), {k: list(r.output_ids)
                                     for k, r in done.items()})
    assert out["port"] == out["ref"]
    c = out["port"][0]["constrained"]
    assert c["constrained_ondevice_tokens"] > 0
    assert c["constrained_roundtrips"] == 0


# ---------------------------------------------------------------------------
# the engine's telemetry on the port
# ---------------------------------------------------------------------------


def port_engine(model, **kw):
    return InferenceEngine(model[2], model[3], EngineConfig(**{**SHAPE,
                                                               **kw}),
                           kv_dtype=torch.float32, device="cpu")


def test_flight_ring_causes_and_measured_dispatch(model, monkeypatch):
    """The ring records every iteration with its dispatch kinds and
    causes; with a roofline (the env override off the card) the
    utilization section reads MFU in (0, 1] and the measured/modeled
    pairs land (the CPU keeps the reference's fetch-maturation rule)."""
    monkeypatch.setenv("KAFKA_TORCH_PEAK_TFLOPS", "0.05")
    monkeypatch.setenv("KAFKA_TORCH_PEAK_HBM_GBPS", "5")
    eng = port_engine(model, num_pages=10, max_pages_per_seq=8,
                      flight_ring=64)
    for i, p in enumerate(prompts(2, [8, 6, 10, 7])):
        eng.submit(GenRequest(request_id=f"p{i}", prompt_ids=p,
                              max_new_tokens=22))
    eng.run_to_completion()
    recs = eng.flight.records()
    assert recs and recs[-1]["seq"] == eng.flight.next_seq - 1
    causes = {c for r in recs for c in r["causes"]}
    assert {"admit", "preempt"} <= causes
    kinds = {k for r in recs for k in r["kinds"]}
    assert {"prefill", "decode"} <= kinds
    util = eng.metrics.utilization_snapshot()
    assert util["peak_source"] == "env"
    dec = util["decode"]
    assert dec["dispatches"] > 0 and 0 < dec["hbm_bw_util"]
    assert dec["measured_dispatches"] > 0 and dec["model_skew"] > 0
    assert any(r["measured_ms"] > 0 for r in recs)
    snap = eng.metrics.snapshot(eng)
    assert snap["flight"]["flight_records"] == eng.flight.next_seq
    assert snap["requests"]["preempted"] == eng.preemptions > 0
    assert snap["memory"]["source"] == "none"  # no plan, no allocator


def test_failed_step_writes_a_postmortem(model, monkeypatch, tmp_path):
    """engine.step failing under the worker: recovery dumps the ring, the
    lane table and a metrics snapshot into KAFKA_TORCH_FLIGHT_DIR."""
    from kafka_tpu_torch.llm.worker import EngineWorker

    d = tmp_path / "pm"
    monkeypatch.setenv("KAFKA_TORCH_FLIGHT_DIR", str(d))
    eng = port_engine(model)
    worker = EngineWorker(eng).start()

    async def run():
        loop = asyncio.get_running_loop()
        q = worker.submit(GenRequest(request_id="x", prompt_ids=[1, 2, 3],
                                     max_new_tokens=30), loop)
        evs = []
        while not evs or not evs[-1].finished:
            evs.append(await asyncio.wait_for(q.get(), 30))
        return evs

    pfp.configure("engine.step", "error", "chaos", nth=3)
    try:
        evs = asyncio.run(run())
    finally:
        pfp.clear()
        worker.stop()
    assert evs[-1].finish_reason == "error:engine"
    (path,) = list_postmortems(str(d))
    with open(path) as f:
        dump = json.load(f)
    assert dump["reason"] == "engine_failure" and dump["records"]
    assert dump["lanes"][0]["request_id"] == "x"
    assert dump["metrics"]["requests"]["submitted"] == 1
    assert eng.metrics.snapshot(eng)["flight"]["flight_postmortems"] == 1
    assert eng.metrics.requests_failed == 1


def test_kernel_sampler_on_the_cpu(model, monkeypatch, tmp_path):
    """KAFKA_TORCH_PROFILE_SAMPLE=2 profiles every 2nd step (CPU activity
    here), keeps the newest traces under the spill dir and closes its
    window when asked; the parser keys on cat == "kernel" and otherwise
    filters as the reference does."""
    monkeypatch.setenv("KAFKA_TORCH_PROFILE_SAMPLE", "2")
    monkeypatch.setenv("KAFKA_TORCH_PROFILE_SPILL_DIR", str(tmp_path / "k"))
    monkeypatch.setenv("KAFKA_TORCH_PROFILE_KEEP", "2")
    eng = port_engine(model)
    assert eng.kernel_sampler.period == 2
    eng.generate([1, 2, 3, 4], max_new_tokens=7)
    eng.kernel_sampler.close(eng.metrics)
    snap = eng.kernel_sampler.snapshot()
    assert snap["samples_total"] >= 3 and snap["sample_failures"] == 0
    assert len(os.listdir(tmp_path / "k")) == 2
    assert not pkp.try_acquire_trace() or pkp.release_trace() is None
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "name": "paged_decode_chunk_kernel", "dur": 12.5,
         "pid": 1, "cat": "kernel"},
        {"ph": "X", "name": "aten::mm", "dur": 40, "pid": 2,
         "cat": "cpu_op"},
        {"ph": "X", "name": "Memcpy DtoH", "dur": 3, "pid": 1,
         "cat": "gpu_memcpy"},
    ]
    assert pkp._parse_events(events) == [("paged_decode_chunk_kernel",
                                          12.5)]
    no_cat = [dict(e, cat=None) for e in events]
    assert pkp._parse_events(no_cat) == rkp._parse_events(no_cat)
    assert pkp._parse_events(events[2:3]) == rkp._parse_events(events[2:3])


def test_no_kafka_tpu_environment_names_in_the_port():
    """The port reads KAFKA_TORCH_* only: a KAFKA_TPU_ name in its source
    would read (or leak into) the reference's configuration."""
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "kafka_tpu_torch")):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh", ".html")):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    if "KAFKA_TPU_" in line:
                        hits.append(f"{path}:{i}")
    assert not hits, hits


# ---------------------------------------------------------------------------
# the six routes against the reference's
# ---------------------------------------------------------------------------


def key_tree(obj):
    """The nested key structure of a JSON payload: dicts by key, lists by
    the union of their items' trees, scalars as one leaf."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        merged = {}
        for item in obj:
            t = key_tree(item)
            if isinstance(t, dict):
                merged.update(t)
        return [merged] if merged else []
    return "."


# utilization.<kind> carries these only once that kind has busy time,
# which on the CPU's gap rule depends on how the host's dispatches fell
ACHIEVED = ("achieved_tflops", "achieved_gb_s")


def contract_tree(payload):
    """key_tree without the data-dependent ACHIEVED keys, after checking
    each utilization section holds them exactly when its busy_s > 0."""
    util = payload.get("utilization") if isinstance(payload, dict) else None
    if not isinstance(util, dict):
        return key_tree(payload)
    trimmed = dict(util)
    for kind, sec in util.items():
        if isinstance(sec, dict) and "busy_s" in sec:
            for k in ACHIEVED:
                assert (k in sec) == (sec["busy_s"] > 0), (kind, sec)
            trimmed[kind] = {k: v for k, v in sec.items()
                             if k not in ACHIEVED}
    return key_tree({**payload, "utilization": trimmed})


WINDOW = dict(max_batch=2, page_size=16, num_pages=2 * 64 + 8,
              max_pages_per_seq=64, prefill_buckets=(256, 1024),
              prefix_cache_pages=0, flight_ring=32)


@pytest.fixture(scope="module")
def providers(model):
    """Both packages' providers over the same tiny weights (no tools but
    the agent's idle tool, a 1024 window, flight rings on).  Their
    workers run for the module and stop at teardown."""
    from kafka_tpu.llm import TPULLMProvider
    from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
    from kafka_tpu_torch.llm import TorchLLMProvider

    jcfg, jparams, cfg, params = model
    jeng = JInferenceEngine(jcfg, jparams,
                            JEngineConfig(**WINDOW, attention_backend="xla"),
                            kv_dtype=jnp.float32)
    eng = InferenceEngine(cfg, params, EngineConfig(**WINDOW),
                          kv_dtype=torch.float32, device="cpu")
    provs = {"ref": TPULLMProvider(jeng, JByteTokenizer(), model_name="m"),
             "port": TorchLLMProvider(eng, ByteTokenizer(), model_name="m")}
    closers = {}
    for side, prov in provs.items():
        closers[side] = prov.aclose

        async def _noop():
            return None

        prov.aclose = _noop
    yield provs
    for close in closers.values():
        asyncio.run(close())


async def serve(side, prov, tmp_path, paths, api_token=None):
    """One streamed thread turn on a fresh app over `prov`, then GET each
    path; {path: (status, json or text)}."""
    from aiohttp.test_utils import TestClient, TestServer

    if side == "ref":
        from kafka_tpu.db import LocalDBClient as DB
        from kafka_tpu.server import ServingConfig
        from kafka_tpu.server.app import create_app
    else:
        from kafka_tpu_torch.db import LocalDBClient as DB
        from kafka_tpu_torch.server import ServingConfig
        from kafka_tpu_torch.server.app import create_app
    db_path = str(tmp_path / f"{side}.db")
    app = await create_app(cfg=ServingConfig(db_path=db_path,
                                             system_prompt="terse",
                                             api_token=api_token),
                           llm_provider=prov, db=DB(db_path), tools=[],
                           mcp_servers=[])
    hdr = {"Authorization": f"Bearer {api_token}"} if api_token else {}
    out = {}
    async with TestClient(TestServer(app)) as c:
        r = await c.post("/v1/threads/tel/chat/completions", headers=hdr,
                         json={"model": "m", "stream": True,
                               "temperature": 0, "max_tokens": 6,
                               "messages": [{"role": "user",
                                             "content": "say hi"}]})
        assert (await r.text()).rstrip().endswith("data: [DONE]")
        deadline = time.monotonic() + 10
        while prov.engine.has_work and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        for method, path, body in paths:
            r = await (c.post(path, json=body, headers=hdr)
                       if method == "post" else c.get(path, headers=hdr))
            text = await r.text()
            try:
                payload = json.loads(text)
            except ValueError:
                payload = text
            out[path] = (r.status, payload)
    return out


def test_metrics_signals_and_flight_return_the_reference_keys(providers,
                                                              tmp_path):
    paths = [("get", "/metrics", None), ("get", "/admin/signals", None),
             ("get", "/debug/flight/0", None),
             ("get", "/debug/flight/7", None),
             ("get", "/metrics?format=prometheus", None)]
    got = {side: asyncio.run(asyncio.wait_for(
        serve(side, prov, tmp_path, paths), 120))
        for side, prov in providers.items()}
    ref, port = got["ref"], got["port"]
    for path in ("/metrics", "/admin/signals", "/debug/flight/0"):
        assert port[path][0] == ref[path][0] == 200, path
        assert contract_tree(port[path][1]) == \
            contract_tree(ref[path][1]), path
    assert port["/debug/flight/7"][0] == ref["/debug/flight/7"][0] == 404
    m = port["/metrics"][1]
    assert m["requests"]["submitted"] == ref["/metrics"][1]["requests"][
        "submitted"] >= 1
    assert m["flight"]["flight_records"] > 0
    assert port["/debug/flight/0"][1]["records"]
    assert port["/admin/signals"][1]["version"] == 9
    prom = port["/metrics?format=prometheus"][1]
    want_families = {ln.split(" ")[2] for ln in
                     ref["/metrics?format=prometheus"][1].splitlines()
                     if ln.startswith("# TYPE")}
    assert {ln.split(" ")[2] for ln in prom.splitlines()
            if ln.startswith("# TYPE")} == want_families


def test_compiles_kernels_and_profile_return_the_reference_keys(
        providers, model, tmp_path, monkeypatch):
    """With an observatory in each package, /debug/compiles is the
    reference's payload; /debug/kernels and /debug/profile are 404 / 403
    while off, as in the reference, and when on carry the keys of the
    reference's sampler snapshot and capture response."""
    for mod in (rcomp, pcomp):
        obs = mod.CompileObservatory(8)
        monkeypatch.setattr(mod, "_OBS", obs)
        obs.record("prog[0]", 0.5)
    off = [("get", "/debug/compiles", None), ("get", "/debug/kernels", None),
           ("post", "/debug/profile", {"seconds": 0.1})]
    got = {side: asyncio.run(asyncio.wait_for(
        serve(side, prov, tmp_path / side, off), 120))
        for side, prov in providers.items()}
    for path in ("/debug/compiles", "/debug/kernels", "/debug/profile"):
        assert got["port"][path][0] == got["ref"][path][0], path
    assert got["port"]["/debug/compiles"][0] == 200
    assert key_tree(got["port"]["/debug/compiles"][1]) == \
        key_tree(got["ref"]["/debug/compiles"][1])
    assert (got["port"]["/debug/kernels"][0],
            got["port"]["/debug/profile"][0]) == (404, 403)

    # on, the port alone: a provider whose engine samples every 3rd
    # step (torch.profiler, CPU activity here); the app's cleanup stops
    # its worker, which closes the sampler's window on the engine thread
    from kafka_tpu_torch.llm import TorchLLMProvider

    monkeypatch.setenv("KAFKA_TORCH_PROFILE_SAMPLE", "3")
    monkeypatch.setenv("KAFKA_TORCH_PROFILE_SPILL_DIR", str(tmp_path / "k"))
    eng = InferenceEngine(model[2], model[3], EngineConfig(**WINDOW),
                          kv_dtype=torch.float32, device="cpu")
    prov = TorchLLMProvider(eng, ByteTokenizer(), model_name="m")
    on = asyncio.run(asyncio.wait_for(serve(
        "port", prov, tmp_path / "on",
        [("get", "/debug/kernels?top_k=5", None),
         ("get", "/debug/kernels?top_k=x", None)]), 120))
    assert eng.kernel_sampler._open_dir is None  # closed with the worker
    status, payload = on["/debug/kernels?top_k=5"]
    ref_keys = rkp.KernelSampler(1, spill_dir=str(tmp_path / "r")).snapshot()
    assert status == 200 and set(payload) == set(ref_keys)
    assert payload["samples_total"] >= 1 and payload["period"] == 3
    assert on["/debug/kernels?top_k=x"][0] == 400


def test_profile_capture_payload_and_bearer(providers, tmp_path,
                                            monkeypatch):
    """A capture returns the reference's keys with the flight window it
    covered; with an API token it wants that token; a capture while the
    sampler holds the profiler is a 409."""
    from kafka_tpu_torch.server import app as papp

    monkeypatch.setenv("KAFKA_TORCH_PROFILING", "1")
    monkeypatch.setattr(papp, "_PROFILE_DIR", str(tmp_path / "prof"))
    out = asyncio.run(asyncio.wait_for(serve(
        "port", providers["port"], tmp_path, [
            ("post", "/debug/profile", {"seconds": 0.1})],
        api_token="tok"), 120))
    status, payload = out["/debug/profile"]
    assert status == 200
    assert set(payload) == {"trace_dir", "seconds", "flight_window"}
    win = payload["flight_window"]["replicas"][0]
    assert win["replica"] == 0 and win["end_seq"] >= win["start_seq"]
    assert any(n.endswith(".trace.json")
               for n in os.listdir(tmp_path / "prof"))
    assert pkp.try_acquire_trace()
    try:
        busy = asyncio.run(asyncio.wait_for(serve(
            "port", providers["port"], tmp_path / "b", [
                ("post", "/debug/profile", {"seconds": 0.1})]), 120))
    finally:
        pkp.release_trace()
    assert busy["/debug/profile"][0] == 409
