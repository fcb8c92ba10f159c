"""Agent tool-call gaps, the single-engine /admin/drain/0, and the server
warmup, against the JAX package.

* Gap demotion on the port's engine with an injected monotonic clock: a
  gap demotes the thread's private KV to the host tier only once the
  linger has passed, a return inside the linger cancels the demote, and
  the follow-up turn promotes the run (cache_source="host_tier").
* One scripted agent flow (gap -> demote -> return -> follow-up; gap ->
  return inside the linger; a return with no gap) leaves the engine's
  agent_gap_* counters equal to the JAX engine's, and both streams equal.
* The provider fires note_tool_gap when a turn ends in a tool call, and
  the worker routes the hints and pauses / resumes around a drain.
* /admin/drain/0 on real tiny servers of both packages: the same status
  codes for the same requests (403 without an API token, 400 for another
  replica, 200 with the archive statistics, 409 with no object tier),
  and a thread drained by the port wakes on a fresh port server.
* Warmup: after create_app with warmup on the CPU, the built-in tools'
  grammar is registered, and a first forced tool call registers no new
  grammar table and hits the compile cache.

Environment through monkeypatch, files under tmp_path; the process-wide
tracing and SLO state create_app sets is put back after each test.
"""

import asyncio

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from aiohttp.test_utils import TestClient, TestServer

from kafka_tpu.models import llama as jllama
from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine

SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))
GAP_KEYS = ("agent_gaps", "agent_gap_demotions", "agent_gap_pages_demoted",
            "agent_gap_bytes_demoted", "agent_gap_cancelled",
            "agent_hint_hits", "agent_hint_misses", "agent_awaiting_threads",
            "agent_awaiting_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _process_state_restored(monkeypatch):
    from collections import OrderedDict

    from kafka_tpu import tracing as rtracing
    from kafka_tpu.runtime import compile_log as rcomp
    from kafka_tpu.runtime import metrics as rmetrics
    from kafka_tpu_torch import tracing as ptracing
    from kafka_tpu_torch.runtime import compile_log as pcomp
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
    monkeypatch.setattr(rcomp, "_OBS", None)
    monkeypatch.setattr(pcomp, "_OBS", None)
    for name in ("AGENT_DEMOTE", "AGENT_LINGER_MS", "KV_HOST_TIER_MB",
                 "KV_OBJECT_DIR", "KV_DISK_TIER_DIR", "WAKE_PREFETCH_MB",
                 "FAILPOINTS", "TRACE_PERSIST_DIR"):
        for prefix in ("KAFKA_TPU_", "KAFKA_TORCH_"):
            monkeypatch.delenv(prefix + name, raising=False)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-gqa").replace(dtype="float32")
    cfg = get_config("tiny-gqa").replace(dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


@pytest.fixture
def closed():
    engines = []
    yield engines.append
    for e in engines:
        if isinstance(e, InferenceEngine):
            e.close()


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(eng, Req, rid, key, prompt, n=6):
    r = Req(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
            prefix_key=key)
    eng.submit(r)
    eng.run_to_completion()
    return r


def port_engine(model, closed, **kw):
    e = InferenceEngine(model[2], model[3],
                        EngineConfig(**{**SHAPE, **kw}),
                        kv_dtype=torch.float32, device="cpu")
    closed(e)
    return e


def test_gap_demotes_after_the_linger_and_a_return_cancels(model, closed):
    eng = port_engine(model, closed, kv_host_tier_mb=64,
                      agent_demote="host", agent_linger_s=0.25)
    eng.clock = clock = Clock()
    rng = np.random.RandomState(4)
    a, b = rng.randint(0, 256, 30).tolist(), rng.randint(0, 256, 30).tolist()
    r1 = run(eng, GenRequest, "a1", "A", a)
    held = eng.prefix_cache.total_pages
    eng.note_tool_gap("A")
    clock.t += 0.2
    eng.step()  # inside the linger: nothing moves
    assert eng.agent_gap_demotions == 0
    assert eng.prefix_cache.total_pages == held
    clock.t += 0.1
    eng.step()
    assert eng.agent_gap_demotions == 1
    assert eng.prefix_cache.host_pages > 0
    assert eng.prefix_cache.total_pages < held
    eng.note_tool_return("A")
    r2 = run(eng, GenRequest, "a2", "A", a + r1.output_ids + [7, 8])
    assert r2.cache_source == "host_tier" and r2.promoted_tokens > 0
    # thread B: the tool returns inside the linger, the demote never runs
    run(eng, GenRequest, "b1", "B", b)
    eng.note_tool_gap("B")
    clock.t += 0.1
    eng.note_tool_return("B")
    clock.t += 1.0
    eng.step()
    sec = eng.agent_section()
    assert sec["agent_gap_cancelled"] == 1
    assert sec["agent_gap_demotions"] == 1
    assert sec["agent_awaiting_threads"] == 0
    assert eng.self_check() == []


def test_gap_counters_equal_the_reference(model, closed):
    """The same scripted flow on both engines (linger 0: a gap is due at
    the next step)."""
    jcfg, jparams = model[0], model[1]
    j = JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**SHAPE, kv_host_tier_mb=64, agent_demote="host",
                      agent_linger_s=0.0, multi_step=1, max_parked=0,
                      attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)
    p = port_engine(model, closed, kv_host_tier_mb=64, agent_demote="host",
                    agent_linger_s=0.0)
    rng = np.random.RandomState(9)
    a, b = rng.randint(0, 256, 30).tolist(), rng.randint(0, 256, 30).tolist()
    got = []
    for eng, Req in ((j, JGenRequest), (p, GenRequest)):
        r1 = run(eng, Req, "a1", "A", a)
        eng.note_tool_gap("A")
        eng.step()
        mid = {k: eng.agent_section()[k] for k in GAP_KEYS}
        eng.note_tool_return("A")
        r2 = run(eng, Req, "a2", "A", a + r1.output_ids + [3, 4])
        run(eng, Req, "b1", "B", b)
        eng.note_tool_gap("B")
        eng.note_tool_return("B")
        eng.note_tool_return("C")
        eng.step()
        end = {k: eng.agent_section()[k] for k in GAP_KEYS}
        got.append((r1.output_ids, r2.output_ids, r2.cache_source, mid, end,
                    eng.kv_tier.snapshot()))
        if Req is JGenRequest:
            t = eng.kv_tier._spill_thread
            assert t is None
    assert got[1] == got[0]
    assert got[1][3]["agent_gap_demotions"] == 1
    assert got[1][3]["agent_awaiting_threads"] == 1
    assert got[1][2] == "host_tier"


def test_knobs_off_make_the_hints_no_ops(model, closed):
    eng = port_engine(model, closed, kv_host_tier_mb=64)
    assert eng.ecfg.agent_demote == ""
    eng.note_tool_gap("A")
    eng.note_tool_return("A")
    assert all(v == 0 for v in eng.agent_section().values())


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("KAFKA_TORCH_AGENT_DEMOTE", "on")
    monkeypatch.setenv("KAFKA_TORCH_AGENT_LINGER_MS", "40")
    ecfg = EngineConfig()
    assert ecfg.agent_demote == "host" and ecfg.agent_linger_s == 0.04
    monkeypatch.setenv("KAFKA_TORCH_AGENT_DEMOTE", "nonsense")
    assert EngineConfig().agent_demote == ""


# ---------------------------------------------------------------------------
# the provider and the worker
# ---------------------------------------------------------------------------


class EngineStub:
    """What the worker needs of an engine, recording the agent hints."""

    def __init__(self):
        import threading

        self.hints = []
        self.arrived = threading.Event()  # a hint reached the engine
        self.has_work = False
        self.kernel_sampler = None
        self.closed = 0

    def note_tool_gap(self, key):
        self.hints.append(("gap", key))
        self.arrived.set()

    def note_tool_return(self, key):
        self.hints.append(("return", key))

    def step(self):
        return []

    def close(self):
        self.closed += 1


def test_worker_routes_hints_and_pauses():
    from kafka_tpu_torch.llm.worker import EngineWorker

    eng = EngineStub()
    w = EngineWorker(eng).start()
    try:
        w.note_tool_gap("t1")
        w.note_tool_return("t1")
        assert w.pause(timeout=5.0)
        assert eng.hints == [("gap", "t1"), ("return", "t1")]
        eng.arrived.clear()
        w.note_tool_gap("t2")  # queued behind the pause
        assert eng.hints == [("gap", "t1"), ("return", "t1")]
        w.resume()
        assert eng.arrived.wait(5.0)
        assert eng.hints[-1] == ("gap", "t2")
    finally:
        w.stop()
    assert eng.closed == 1  # the engine closes on the worker thread


async def _serve(app, fn):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()


def test_provider_fires_the_gap_on_a_tool_call_turn(model, closed):
    from kafka_tpu_torch.llm.torch_provider import TorchLLMProvider
    from kafka_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = get_config("tiny-gqa").replace(dtype="float32", vocab_size=262)
    gen = torch.Generator().manual_seed(0)
    from kafka_tpu_torch.models import init_params

    eng = InferenceEngine(cfg, init_params(cfg, gen, device="cpu"),
                          EngineConfig(max_batch=2, page_size=16,
                                       num_pages=64, max_pages_per_seq=32,
                                       kv_host_tier_mb=16,
                                       agent_demote="host",
                                       agent_linger_s=0.0),
                          device="cpu")
    prov = TorchLLMProvider(eng, ByteTokenizer())
    tools = [{"type": "function", "function": {
        "name": "add", "description": "",
        "parameters": {"type": "object",
                       "properties": {"a": {"type": "integer"}}}}}]

    async def go():
        mask = prov.build_tool_call_mask_fn(tools, "required")
        chunks = [c async for c in prov.stream_completion(
            [{"role": "user", "content": "add"}], tools=tools,
            temperature=0.0, max_tokens=40, prefix_key="thread-1",
            logits_mask_fn=mask)]
        return chunks

    try:
        chunks = asyncio.run(go())
        assert any(c.finish_reason == "tool_calls" for c in chunks)
        assert prov.worker.pause(timeout=10.0)
        try:
            assert eng.agent_gaps == 1
        finally:
            prov.worker.resume()
    finally:
        asyncio.run(prov.aclose())


# ---------------------------------------------------------------------------
# /admin/drain/0 on real servers
# ---------------------------------------------------------------------------


def _app(side, tmp_path, **cfg_kw):
    if side == "ref":
        from kafka_tpu.server import ServingConfig
        from kafka_tpu.server.app import create_app
        kw = {}
    else:
        from kafka_tpu_torch.server import ServingConfig
        from kafka_tpu_torch.server.app import create_app
        kw = {"device": "cpu"}
    cfg = ServingConfig(tiny_model=True, warmup=False, system_prompt="t",
                        db_path=str(tmp_path / f"{side}.db"), **cfg_kw)
    return create_app(cfg=cfg, tools=[], mcp_servers=[], **kw)


AUTH = {"Authorization": "Bearer tok"}


async def _drain_flow(c):
    out = []
    r = await c.post("/v1/threads/t-d/chat/completions", headers=AUTH,
                     json={"model": "m", "max_tokens": 4, "messages": [
                         {"role": "user", "content": "hi"}]})
    out.append(("turn", r.status))
    await r.read()
    for label, path, headers in (
            ("no_auth", "/admin/drain/0", {}),
            ("not_int", "/admin/drain/x", AUTH),
            ("other", "/admin/drain/1", AUTH),
            ("ok", "/admin/drain/0", AUTH)):
        r = await c.post(path, headers=headers)
        body = await r.json()
        out.append((label, r.status, sorted(body)))
    return out


def test_drain_route_matches_the_reference(tmp_path):
    got = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()

        async def go():
            app = await _app(side, d, api_token="tok", kv_host_tier_mb=8,
                             kv_object_dir=str(d / "store"))
            return await _serve(app, _drain_flow)

        got[side] = asyncio.run(asyncio.wait_for(go(), 300))
    assert got["port"] == got["ref"]
    statuses = {x[0]: x[1] for x in got["port"]}
    assert statuses == {"turn": 200, "no_auth": 401, "not_int": 400,
                        "other": 400, "ok": 200}


@pytest.mark.parametrize("cfg_kw,status", [
    (dict(), 403),  # no API token
    (dict(api_token="tok"), 409),  # no object tier
])
def test_drain_refusals_match_the_reference(tmp_path, cfg_kw, status):
    seen = []
    for side in ("ref", "port"):
        async def go():
            app = await _app(side, tmp_path, **cfg_kw)

            async def f(c):
                r = await c.post("/admin/drain/0", headers=AUTH)
                body = await r.json()
                return r.status, sorted(body)
            return await _serve(app, f)
        seen.append(asyncio.run(asyncio.wait_for(go(), 300)))
    assert seen[0] == seen[1] and seen[1][0] == status


def test_drained_thread_wakes_on_a_fresh_server(tmp_path):
    store = str(tmp_path / "store")
    body = {"model": "m", "max_tokens": 4, "temperature": 0.0,
            "messages": [{"role": "user", "content": "hello there"}]}

    async def first(c):
        r = await c.post("/v1/threads/t-w/chat/completions", json=body,
                         headers=AUTH)
        await r.read()
        r = await c.post("/admin/drain/0", headers=AUTH)
        return await r.json()

    async def second(c):
        r = await c.post("/v1/threads/t-w/chat/completions", json=body,
                         headers=AUTH)
        await r.read()
        r = await c.get("/metrics", headers=AUTH)
        return await r.json()

    async def go():
        kw = dict(api_token="tok", kv_host_tier_mb=8, kv_object_dir=store)
        stats = await _serve(await _app("port", tmp_path, **kw), first)
        snap = await _serve(await _app("port", tmp_path / "..", **kw),
                            second)
        return stats, snap

    stats, snap = asyncio.run(asyncio.wait_for(go(), 300))
    assert stats["enabled"] and stats["manifests"] >= 1
    assert stats["replica"] == 0 and stats["runs_archived"] >= 1
    assert snap["object_tier"]["wake_threads"] >= 1
    assert snap["prefix_cache"]["object_tier_hits"] >= 1


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


def test_warmup_registers_the_builtin_tools_grammar(tmp_path):
    from kafka_tpu_torch.agents.base import IDLE_TOOL
    from kafka_tpu_torch.llm import constrained
    from kafka_tpu_torch.server import ServingConfig
    from kafka_tpu_torch.server.app import STATE_KEY, create_app
    from kafka_tpu_torch.server_tools import builtin_tools

    async def go():
        cfg = ServingConfig(tiny_model=True, warmup=True, page_size=16,
                            num_pages=320, max_pages_per_seq=256,
                            max_batch=4, kv_host_tier_mb=8,
                            db_path=str(tmp_path / "w.db"))
        app = await create_app(cfg=cfg, mcp_servers=[], device="cpu")
        prov = app[STATE_KEY]["llm"]
        eng = prov.engine
        tables = eng._grammars
        n, version = len(tables.grammars), tables.version
        assert n == 1  # registered at boot
        tools = [t.to_openai() for t in builtin_tools()] + [IDLE_TOOL]
        mask = prov.build_tool_call_mask_fn(tools, "required")
        calls = []
        real = constrained._compile_into_cache

        def spy(*a, **kw):
            calls.append(a)
            return real(*a, **kw)

        constrained._compile_into_cache = spy
        try:
            async def f(c):
                return [x async for x in prov.stream_completion(
                    [{"role": "user", "content": "go"}], tools=tools,
                    temperature=0.0, max_tokens=8, logits_mask_fn=mask)]
            await _serve(app, f)
        finally:
            constrained._compile_into_cache = real
        assert calls == []  # the compile cache answered
        assert len(tables.grammars) == n and tables.version == version
        assert eng.constrained_ondevice_tokens > 0

    asyncio.run(asyncio.wait_for(go(), 300))
