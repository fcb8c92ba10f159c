"""Request tracing through the port, against the JAX package's (C7).

Both packages' servers over real providers with the same tiny weights:
a thread turn that names the `add` tool in `tool_choice` (the grammar
forces the call, the agent executes it and loops) is read back from
`GET /debug/trace/{id}`.  Held equal: the span-name tree — `http.request`
-> `agent.turn` -> `engine.queue` / `engine.prefill` / `engine.decode` /
`emit`, and `tool.exec` — and the per-turn counts of the spans each model
call opens once.  Also: X-Request-Id and traceparent are adopted and
echoed, `/debug/traces` indexes the trace, and a run with tracing off
streams the same tokens as a traced one.
"""

import asyncio
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu_torch.models import params_from_jax

WINDOW = dict(max_batch=2, page_size=16, num_pages=2 * 128 + 8,
              max_pages_per_seq=128, prefill_buckets=(256, 1024),
              prefix_cache_pages=0)
ADD_SCHEMA = {"type": "object", "properties": {
    "a": {"type": "integer"}, "b": {"type": "integer"}}}
NAMED = {"type": "function", "function": {"name": "add"}}


def add(a: int = 0, b: int = 0):
    return a + b


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    from kafka_tpu.models import llama as jllama
    from kafka_tpu.models.config import get_config as jax_get_config

    jcfg = jax_get_config("tiny-gqa").replace(vocab_size=262,
                                               dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def provider(side, weights):
    jcfg, jparams, params = weights
    if side == "ref":
        from kafka_tpu.llm import TPULLMProvider
        from kafka_tpu.models.tokenizer import ByteTokenizer
        from kafka_tpu.runtime import EngineConfig, InferenceEngine

        eng = InferenceEngine(
            jcfg, jparams,
            EngineConfig(**WINDOW, multi_step=1, max_parked=0,
                         attention_backend="xla", flight_ring=0),
            kv_dtype=jnp.float32)
        return TPULLMProvider(eng, ByteTokenizer(), model_name="m")
    from kafka_tpu_torch.llm import TorchLLMProvider
    from kafka_tpu_torch.models import ByteTokenizer, get_config
    from kafka_tpu_torch.runtime import EngineConfig, InferenceEngine

    cfg = get_config("tiny-gqa").replace(vocab_size=262, dtype="float32")
    eng = InferenceEngine(cfg, params, EngineConfig(**WINDOW),
                          kv_dtype=torch.float32, device="cpu")
    return TorchLLMProvider(eng, ByteTokenizer(), model_name="m")


async def make_app(side, prov, tmp_path, **cfg_kw):
    if side == "ref":
        from kafka_tpu.db import LocalDBClient as DB
        from kafka_tpu.server import ServingConfig
        from kafka_tpu.server.app import create_app
        from kafka_tpu.tools import Tool
    else:
        from kafka_tpu_torch.db import LocalDBClient as DB
        from kafka_tpu_torch.server import ServingConfig
        from kafka_tpu_torch.server.app import create_app
        from kafka_tpu_torch.tools import Tool
    db_path = str(tmp_path / f"{side}-{len(cfg_kw)}.db")
    return await create_app(
        cfg=ServingConfig(db_path=db_path, system_prompt="terse", **cfg_kw),
        llm_provider=prov, db=DB(db_path),
        tools=[Tool(name="add", description="add two integers",
                    handler=add, parameters=ADD_SCHEMA)],
        mcp_servers=[])


async def traced_turn(side, weights, tmp_path, rid, **cfg_kw):
    """One streamed thread turn forcing `add`; returns the SSE events,
    the chrome trace, the trace index and the completion tokens."""
    from aiohttp.test_utils import TestClient, TestServer

    prov = provider(side, weights)
    seen = []
    real = prov.engine.submit
    prov.engine.submit = lambda req: (seen.append(req), real(req))[1]
    app = await make_app(side, prov, tmp_path, **cfg_kw)
    async with TestClient(TestServer(app)) as c:
        r = await c.post(
            "/v1/threads/tr/chat/completions",
            headers={"X-Request-Id": rid},
            json={"model": "m", "stream": True, "temperature": 0,
                  "max_tokens": 64, "tool_choice": NAMED,
                  "messages": [{"role": "user", "content": "add 2 and 3"}]})
        assert r.status == 200, await r.text()
        raw = await r.text()
        t = await c.get(f"/debug/trace/{rid}")
        trace = await t.json() if t.status == 200 else None
        index = await (await c.get("/debug/traces")).json()
    events = [json.loads(line[6:]) for line in raw.splitlines()
              if line.startswith("data: {")]
    return events, trace, index, [list(q.output_ids) for q in seen]


def span_tree(trace):
    """Sorted unique root-to-span name paths, and per-name counts."""
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in spans}

    def path(e):
        names = [e["name"]]
        while e["args"].get("parent_id") in by_id:
            e = by_id[e["args"]["parent_id"]]
            names.append(e["name"])
        return tuple(reversed(names))

    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return sorted({path(e) for e in spans}), counts


def test_traced_tool_turn_has_the_reference_span_tree(weights, tmp_path):
    async def go():
        return {side: await traced_turn(side, weights, tmp_path, "rid-tree")
                for side in ("ref", "port")}

    out = asyncio.run(asyncio.wait_for(go(), 300))
    trees = {side: span_tree(out[side][1]) for side in out}
    assert trees["port"][0] == trees["ref"][0]
    paths = trees["port"][0]
    for leaf in ("engine.queue", "engine.prefill", "engine.decode", "emit"):
        assert ("http.request", "agent.turn", leaf) in paths, paths
    assert any(p[-1] == "tool.exec" for p in paths), paths
    # spans each model call opens once: one per agent iteration
    want, got = trees["ref"][1], trees["port"][1]
    for name in ("http.request", "agent.turn", "engine.queue",
                 "engine.prefill", "emit", "tool.exec"):
        assert got[name] == want[name], (name, got, want)
    assert got["engine.decode"] >= 1
    # the tool ran: both streams carry its result
    for side in out:
        assert any(e.get("type") == "tool_result" for e in out[side][0])
    # the trace is indexed by the adopted id
    idx = out["port"][2]
    assert idx["traces"][0]["trace_id"] == "rid-tree"
    assert "engine.decode" in idx["traces"][0]["names"]
    assert out["port"][1]["otherData"]["trace_id"] == "rid-tree"


def test_untraced_run_streams_the_traced_tokens(weights, tmp_path):
    """trace_sample=0 leaves every request untraced (no trace to read)
    and changes no token."""
    async def go():
        traced = await traced_turn("port", weights, tmp_path, "rid-on")
        untraced = await traced_turn("port", weights, tmp_path, "rid-off",
                                     trace_sample=0.0)
        return traced, untraced

    traced, untraced = asyncio.run(asyncio.wait_for(go(), 300))
    assert untraced[1] is None and traced[1] is not None
    assert untraced[3] == traced[3] and len(traced[3]) >= 2


@pytest.mark.parametrize("headers,want_id", [
    ({"X-Request-Id": "client-rid-7"}, "client-rid-7"),
    ({"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}, "ab" * 16),
    ({}, None),
], ids=["x_request_id", "traceparent", "minted"])
def test_trace_id_is_adopted_and_echoed(tmp_path, headers, want_id):
    """Buffered responses echo the trace id in X-Request-Id (adopted from
    the request, or minted), and /debug/trace answers for it, as in the
    reference."""
    from aiohttp.test_utils import TestClient, TestServer

    from kafka_tpu.db import LocalDBClient as RefDB
    from kafka_tpu.server import ServingConfig as RefCfg
    from kafka_tpu.server.app import create_app as ref_create_app
    from kafka_tpu_torch.db import LocalDBClient as PortDB
    from kafka_tpu_torch.server import ServingConfig as PortCfg
    from kafka_tpu_torch.server.app import create_app as port_create_app
    from tests.test_torch_agent import SIDES

    async def side(name, create_app, Cfg, DB):
        db_path = str(tmp_path / f"{name}.db")
        app = await create_app(cfg=Cfg(db_path=db_path),
                               llm_provider=SIDES[name][0]([]),
                               db=DB(db_path), tools=[], mcp_servers=[])
        async with TestClient(TestServer(app)) as c:
            r = await c.post("/v1/threads", headers=headers,
                             json={"thread_id": "t-echo"})
            rid = r.headers.get("X-Request-Id")
            t = await c.get(f"/debug/trace/{rid}")
            names = sorted({e["name"] for e in
                            (await t.json())["traceEvents"]
                            if e["ph"] == "X"})
            missing = await c.get("/debug/trace/no-such-trace")
        return r.status, rid, t.status, names, missing.status

    ref = asyncio.run(side("ref", ref_create_app, RefCfg, RefDB))
    port = asyncio.run(side("port", port_create_app, PortCfg, PortDB))
    assert port[0] == ref[0] == 201
    if want_id is not None:
        assert port[1] == ref[1] == want_id
    else:
        assert port[1] and len(port[1]) == len(ref[1])
    assert port[2:] == ref[2:] == (200, ["http.request"], 404)
