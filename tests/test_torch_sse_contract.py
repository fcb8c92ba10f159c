"""The client contract on the port's thread route, against the JAX
package's.

The five flows of tests/test_sse_contract.py (plain text, a tool call
whose arguments arrive across two deltas, per-completion-id segmentation,
the trailing-stub drop, two tool cycles) run on
`POST /v1/threads/{id}/chat/completions` of both servers with identical
scripted turns and an `add` tool; both raw SSE streams go through the
reference's `SSEMessageReconstructor` (the playground's consumer), and
the transcripts must be equal.

Then one thread turn end to end on the CPU through the real providers:
the port's `TorchLLMProvider` and the JAX package's `TPULLMProvider` over
a tiny model with the same weights (`params_from_jax`), the built-in
tools, a 4096-token window and greedy sampling.  Both must submit the
same prompt token ids and generate the same greedy tokens.
"""

import asyncio
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.core.sse_client import SSEMessageReconstructor
from kafka_tpu.db import LocalDBClient as RefDB
from kafka_tpu.server import ServingConfig as RefServingConfig
from kafka_tpu.server.app import create_app as ref_create_app
from kafka_tpu.tools import Tool as RefTool
from kafka_tpu_torch.db import LocalDBClient as PortDB
from kafka_tpu_torch.server import ServingConfig as PortServingConfig
from kafka_tpu_torch.server.app import create_app as port_create_app
from kafka_tpu_torch.tools import Tool as PortTool
from tests.test_torch_agent import SIDES, call_turn, text_turn


def split_args_turn(cid="chatcmpl-t1"):
    """A tool-call turn whose JSON arguments arrive across two deltas."""
    return [
        dict(role="assistant", id=cid),
        dict(tool_calls=[{"index": 0, "id": "call_1", "type": "function",
                          "function": {"name": "add",
                                       "arguments": '{"a": 2,'}}], id=cid),
        dict(tool_calls=[{"index": 0,
                          "function": {"arguments": ' "b": 3}'}}], id=cid),
        dict(finish_reason="tool_calls", id=cid),
    ]


FLOWS = {
    "plain_text_turn": [text_turn("Hello ", "world")],
    "tool_call_turn": [split_args_turn(),
                       text_turn("2+3 is 5", cid="chatcmpl-t2")],
    "per_completion_id_segmentation": [
        split_args_turn(cid="chatcmpl-seg1"),
        text_turn("done", cid="chatcmpl-seg2")],
    "agent_done_drops_trailing_stub": [text_turn("answer")],
    "two_tool_cycles": [
        split_args_turn(cid="chatcmpl-c1"),
        call_turn("add", {"a": 5, "b": 5}, call_id="call_2",
                  cid="chatcmpl-c2"),
        text_turn("both sums computed", cid="chatcmpl-c3")],
}


def add(a: int, b: int):
    return a + b


async def thread_turn(app, content, **body):
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as c:
        r = await c.post("/v1/threads/contract/chat/completions",
                         json={"model": "m", "stream": True, **body,
                               "messages": [{"role": "user",
                                             "content": content}]})
        assert r.status == 200, await r.text()
        raw = await r.text()
        r = await c.get("/v1/threads/contract/messages")
        history = (await r.json())["messages"]
    return raw, history


async def scripted_stream(side, tmp_path, script):
    Stub = SIDES[side][0]
    db_path = str(tmp_path / f"{side}.db")
    if side == "ref":
        app = await ref_create_app(
            cfg=RefServingConfig(db_path=db_path, system_prompt="terse"),
            llm_provider=Stub(script), db=RefDB(db_path),
            tools=[RefTool(name="add", description="", handler=add)],
            mcp_servers=[])
    else:
        app = await port_create_app(
            cfg=PortServingConfig(db_path=db_path, system_prompt="terse"),
            llm_provider=Stub(script), db=PortDB(db_path),
            tools=[PortTool(name="add", description="", handler=add)],
            mcp_servers=[])
    return await thread_turn(app, "add 2 and 3")


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flow_reconstructs_like_the_reference(tmp_path, flow):
    async def go():
        return [await scripted_stream(side, tmp_path, FLOWS[flow])
                for side in ("ref", "port")]

    (rraw, rhist), (praw, phist) = asyncio.run(go())
    recs = []
    for raw in (rraw, praw):
        rec = SSEMessageReconstructor()
        rec.feed_text(raw)
        assert rec.done and rec.errors == []
        recs.append(rec)
    assert recs[1].messages == recs[0].messages
    assert phist == rhist
    # what each flow shows, on the port's transcript
    msgs = recs[1].messages
    assert msgs[-1]["role"] == "assistant" and msgs[-1].get("content")
    tools = [m for m in msgs if m["role"] == "tool"]
    calls = [m for m in msgs if m.get("tool_calls")]
    n_calls = {"two_tool_cycles": 2, "tool_call_turn": 1,
               "per_completion_id_segmentation": 1}.get(flow, 0)
    assert len(tools) == len(calls) == n_calls
    if n_calls:
        first = calls[0]["tool_calls"][0]["function"]
        assert json.loads(first["arguments"]) == {"a": 2, "b": 3}
        assert tools[0]["content"] == "5"


# ---------------------------------------------------------------------------
# one thread turn through the real providers, same weights
# ---------------------------------------------------------------------------

WINDOW = dict(max_batch=2, page_size=16, num_pages=2 * 256 + 8,
              max_pages_per_seq=256, prefill_buckets=(256, 1024))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def real_providers():
    from kafka_tpu.llm import TPULLMProvider
    from kafka_tpu.models import llama as jllama
    from kafka_tpu.models.config import get_config as jax_get_config
    from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
    from kafka_tpu.runtime import (
        EngineConfig as JEngineConfig,
        InferenceEngine as JInferenceEngine,
    )
    from kafka_tpu_torch.llm import TorchLLMProvider
    from kafka_tpu_torch.models import ByteTokenizer, get_config
    from kafka_tpu_torch.models import params_from_jax
    from kafka_tpu_torch.runtime import EngineConfig, InferenceEngine

    jcfg = jax_get_config("tiny-gqa").replace(vocab_size=262, dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    jeng = JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**WINDOW, multi_step=1, max_parked=0,
                      attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)
    cfg = get_config("tiny-gqa").replace(vocab_size=262, dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    eng = InferenceEngine(cfg, params, EngineConfig(**WINDOW),
                          kv_dtype=torch.float32, device="cpu")
    return (TPULLMProvider(jeng, JByteTokenizer(), model_name="m"),
            TorchLLMProvider(eng, ByteTokenizer(), model_name="m"))


def spy_submits(engine):
    """Record every request the provider hands the engine."""
    seen = []
    real = engine.submit

    def submit(req, *a, **kw):
        seen.append(req)
        return real(req, *a, **kw)

    engine.submit = submit
    return seen


def test_thread_turn_through_real_providers(tmp_path):
    jprov, pprov = real_providers()
    seen = {"ref": spy_submits(jprov.engine), "port": spy_submits(pprov.engine)}

    async def go():
        out = {}
        for side, prov in (("ref", jprov), ("port", pprov)):
            db_path = str(tmp_path / f"{side}-real.db")
            if side == "ref":
                from kafka_tpu.server_tools import builtin_tools

                app = await ref_create_app(
                    cfg=RefServingConfig(db_path=db_path,
                                         system_prompt="terse"),
                    llm_provider=prov, db=RefDB(db_path),
                    tools=builtin_tools(), mcp_servers=[])
            else:
                app = await port_create_app(
                    cfg=PortServingConfig(db_path=db_path,
                                          system_prompt="terse"),
                    llm_provider=prov, db=PortDB(db_path), mcp_servers=[])
            out[side] = await thread_turn(app, "What can you do?",
                                          temperature=0, max_tokens=8)
        return out

    out = asyncio.run(go())
    ref, port = seen["ref"][0], seen["port"][0]
    # the built-in tools' schemas are in the prompt: well past 3k tokens
    assert len(port.prompt_ids) > 3000
    assert list(port.prompt_ids) == list(ref.prompt_ids)
    assert len(port.output_ids) == 8
    assert list(port.output_ids) == list(ref.output_ids)
    assert port.prefix_key == ref.prefix_key == "contract"
    recs = []
    for raw, _ in (out["ref"], out["port"]):
        rec = SSEMessageReconstructor()
        rec.feed_text(raw)
        assert rec.done and rec.errors == []
        recs.append(rec)
    assert recs[1].messages == recs[0].messages
    assert out["port"][1] == out["ref"][1]
