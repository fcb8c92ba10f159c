"""The port's agent turn against the JAX package's (faults C1 and C2).

The reference `KafkaV1Provider` (kafka_tpu/kafka/v1.py) and the port's run
the same scripted turns.  Each package gets its own stub LLM provider that
replays one neutral script as that package's `StreamChunk`s and records
the messages, tools and keyword arguments of every completion; each runs
over its own `LocalDBClient` thread store, with the built-in tools and
the prompt variables pinned (date and sandbox environment).  Held equal:
the rendered system prompt and tool schemas, the LLM kwargs, the event
stream with completion ids and timestamps stripped, and the persisted
thread.  Then both servers' thread and chat routes: a body carrying
`seed`, `top_p` and `top_k` reaches neither LLM with them (C2), and a
tool-call turn on the port's thread route executes the tool and loops
instead of ending as a text answer (C1).
"""

import asyncio
import copy
import json

import pytest

from kafka_tpu.core.types import StreamChunk as RefChunk
from kafka_tpu.db import LocalDBClient as RefDB
from kafka_tpu.kafka import KafkaV1Provider as RefKafka
from kafka_tpu.llm.base import LLMProvider as RefLLM
from kafka_tpu.server import ServingConfig as RefServingConfig
from kafka_tpu.server.app import create_app as ref_create_app
from kafka_tpu.server_tools import builtin_tools as ref_builtin_tools
from kafka_tpu_torch.core.types import StreamChunk as PortChunk
from kafka_tpu_torch.db import LocalDBClient as PortDB
from kafka_tpu_torch.kafka import KafkaV1Provider as PortKafka
from kafka_tpu_torch.llm.base import LLMProvider as PortLLM
from kafka_tpu_torch.server import ServingConfig as PortServingConfig
from kafka_tpu_torch.server.app import create_app as port_create_app
from kafka_tpu_torch.server_tools import builtin_tools as port_builtin_tools

PROMPT_VARIABLES = {"current_date": "2026-01-01",
                    "sandbox_env": "A pinned test sandbox."}
REASONS = ("text_response", "idle", "max_iterations")


# ---------------------------------------------------------------------------
# neutral scripts: lists of turns, each a list of StreamChunk kwargs
# ---------------------------------------------------------------------------


def text_turn(*parts, cid="chatcmpl-s1"):
    return ([dict(role="assistant", id=cid)]
            + [dict(content=p, id=cid) for p in parts]
            + [dict(finish_reason="stop", id=cid,
                    usage={"prompt_tokens": 7, "completion_tokens": len(parts),
                           "total_tokens": 7 + len(parts)})])


def call_turn(name, args, call_id="call_1", cid="chatcmpl-s2"):
    return [
        dict(role="assistant", id=cid),
        dict(tool_calls=[{"index": 0, "id": call_id, "type": "function",
                          "function": {"name": name,
                                       "arguments": json.dumps(args)}}],
             id=cid),
        dict(finish_reason="tool_calls", id=cid,
             usage={"prompt_tokens": 11, "completion_tokens": 5,
                    "total_tokens": 16}),
    ]


COUNT = ("count_slowly", {"limit": 3, "delay": 0})
THINK = ("sequentialthinking", {"thought": "plan the sums", "thoughtNumber": 1,
                                "totalThoughts": 1,
                                "nextThoughtNeeded": False})


def make_stub(base, chunk_cls):
    class Stub(base):
        """Replays a script; records what each completion was given."""

        provider_name = "stub"

        def __init__(self, script):
            self.script = [list(t) for t in script]
            self.calls = []

        async def stream_completion(self, messages, **kw):
            self.calls.append({"messages": copy.deepcopy(list(messages)),
                               **copy.deepcopy(kw)})
            turn = self.script.pop(0) if self.script else \
                text_turn("fallback", cid="chatcmpl-fallback")
            for c in turn:
                yield chunk_cls(**c)

        def get_available_models(self):
            return [{"id": "stub", "object": "model", "owned_by": "test",
                     "created": 0}]

    return Stub


SIDES = {
    "ref": (make_stub(RefLLM, RefChunk), RefDB, RefKafka, ref_builtin_tools),
    "port": (make_stub(PortLLM, PortChunk), PortDB, PortKafka,
             port_builtin_tools),
}


def strip(event):
    """An event without its completion id and timestamp."""
    return {k: v for k, v in event.items() if k not in ("id", "created")}


async def run_side(side, script, db_path, *, thread, max_iterations=50,
                   system_prompt=None, **kwargs):
    Stub, DB, Kafka, builtin = SIDES[side]
    llm = Stub(script)
    db = DB(str(db_path))
    await db.initialize()
    kafka = Kafka(llm, thread_db=db, tools=builtin(), mcp_servers=[],
                  thread_id="t1" if thread else None, default_model="stub",
                  system_prompt=system_prompt, max_iterations=max_iterations,
                  prompt_variables=PROMPT_VARIABLES)
    await kafka.initialize()
    user = [{"role": "user", "content": "count to three, then plan"}]
    events = []
    try:
        stream = kafka.run_with_thread("t1", user, **kwargs) if thread \
            else kafka.run(user, **kwargs)
        async for ev in stream:
            events.append(ev)
    finally:
        await kafka.cleanup()
    persisted = await db.get_thread_messages("t1") if thread else None
    await db.close()
    return llm.calls, events, persisted


def run_both(tmp_path, script, **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)

    async def go():
        return [await run_side(side, script, tmp_path / f"{side}.db", **kw)
                for side in ("ref", "port")]

    return asyncio.run(go())


CASES = {
    "text": dict(script=[text_turn("Hello ", "world")]),
    "counter": dict(script=[call_turn(*COUNT),
                            text_turn("counted", cid="chatcmpl-s3")]),
    "two_tool_cycles": dict(script=[
        call_turn(*COUNT),
        call_turn(*THINK, call_id="call_2", cid="chatcmpl-s3"),
        text_turn("counted and planned", cid="chatcmpl-s4")]),
    "max_iterations": dict(script=[
        call_turn(*COUNT),
        call_turn(*COUNT, call_id="call_2", cid="chatcmpl-s3"),
        call_turn(*COUNT, call_id="call_3", cid="chatcmpl-s4")],
        max_iterations=2),
    "tool_choice_none": dict(script=[text_turn("no tools here")],
                             tool_choice="none"),
    "stateless_counter": dict(script=[call_turn(*COUNT),
                                      text_turn("counted", cid="chatcmpl-s3")],
                              thread=False),
    "configured_system_prompt": dict(script=[text_turn("terse")],
                                     system_prompt="You are terse."),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_agent_turn_matches_reference(tmp_path, case):
    kw = dict(CASES[case])
    kw.setdefault("thread", True)
    (rcalls, revents, rthread), (pcalls, pevents, pthread) = run_both(
        tmp_path, **kw)
    # the rendered system prompt and the tool schemas the LLM saw
    assert pcalls[0]["messages"][0] == rcalls[0]["messages"][0]
    assert pcalls[0]["messages"][0]["role"] == "system"
    assert pcalls[0].get("tools") == rcalls[0].get("tools")
    # every completion's messages and kwargs
    assert pcalls == rcalls
    # the event stream, ids and timestamps stripped
    assert [strip(e) for e in pevents] == [strip(e) for e in revents]
    # the persisted thread
    assert pthread == rthread
    done = pevents[-1]
    assert done["type"] == "agent_done" and done["reason"] in REASONS


def test_case_expectations(tmp_path):
    """What each case exercises, on the port: tools reach the LLM with the
    prompt (the idle tool among them), tool_choice "none" sends none, two
    tool cycles run two tools, max_iterations stops the loop, and usage is
    summed over the run."""
    out = {c: run_both(tmp_path / c, **{"thread": True, **CASES[c]})[1]
           for c in ("counter", "two_tool_cycles", "max_iterations",
                     "tool_choice_none")}
    calls, events, thread = out["counter"]
    names = [t["function"]["name"] for t in calls[0]["tools"]]
    assert {"count_slowly", "sequentialthinking", "idle"} <= set(names)
    assert calls[0]["prefix_key"] == "t1"  # the thread keys the KV cache
    results = [e for e in events if e.get("type") == "tool_result"]
    assert results[-1]["done"] and results[-1]["name"] == "count_slowly"
    assert [m["role"] for m in thread] == ["user", "assistant", "tool",
                                           "assistant"]
    assert thread[2]["content"] == "1\n2\n3\n"
    assert events[-1]["usage"]["prompt_tokens"] == 11 + 7
    calls, events, thread = out["two_tool_cycles"]
    assert len(calls) == 3
    assert [m["role"] for m in thread].count("tool") == 2
    calls, events, _ = out["max_iterations"]
    assert len(calls) == 2 and events[-1]["reason"] == "max_iterations"
    calls, events, _ = out["tool_choice_none"]
    assert calls[0]["tools"] is None
    assert events[-1]["reason"] == "text_response"


# ---------------------------------------------------------------------------
# the servers' routes
# ---------------------------------------------------------------------------


def sse_events(text):
    return [json.loads(line[len("data: "):]) for line in text.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


async def serve_and_post(side, tmp_path, script, path, body):
    """One POST to `side`'s app, wired around a stub LLM and the built-in
    tools; returns (LLM calls, SSE events, raw text, thread history)."""
    from aiohttp.test_utils import TestClient, TestServer

    Stub, DB, _, builtin = SIDES[side]
    llm = Stub(script)
    db_path = str(tmp_path / f"{side}-server.db")
    if side == "ref":
        app = await ref_create_app(
            cfg=RefServingConfig(db_path=db_path, system_prompt="terse"),
            llm_provider=llm, db=DB(db_path), tools=builtin(),
            mcp_servers=[])
    else:
        app = await port_create_app(
            cfg=PortServingConfig(db_path=db_path, system_prompt="terse"),
            llm_provider=llm, db=DB(db_path), tools=builtin(),
            mcp_servers=[])
    async with TestClient(TestServer(app)) as c:
        r = await c.post(path, json=body)
        assert r.status == 200, await r.text()
        text = await r.text()
        history = None
        if "/threads/" in path:
            r = await c.get(path.replace("/chat/completions", "/messages"))
            history = (await r.json())["messages"]
    return llm.calls, sse_events(text), text, history


@pytest.mark.parametrize("path", ["/v1/threads/t9/chat/completions",
                                  "/v1/chat/completions"])
def test_body_sampling_knobs_are_not_forwarded(tmp_path, path):
    """C2: temperature, max_tokens and tool_choice reach the LLM; seed,
    top_p and top_k do not, on either package."""
    body = {"model": "stub", "stream": True, "temperature": 0.3,
            "max_tokens": 9, "seed": 123, "top_p": 0.5, "top_k": 7,
            "messages": [{"role": "user", "content": "hi"}]}

    async def go():
        return [await serve_and_post(side, tmp_path, [text_turn("hey")],
                                     path, body) for side in ("ref", "port")]

    (rcalls, revents, _, rhist), (pcalls, pevents, _, phist) = \
        asyncio.run(go())
    assert pcalls == rcalls
    for k in ("seed", "top_p", "top_k"):
        assert k not in pcalls[0]
    assert pcalls[0]["temperature"] == 0.3 and pcalls[0]["max_tokens"] == 9
    assert [strip(e) for e in pevents] == [strip(e) for e in revents]
    assert phist == rhist


def test_tool_call_turn_does_not_end_as_text_response(tmp_path):
    """C1 on the port's thread route: the model's tool call is executed,
    its result streams as tool_result and tool_messages, and the loop asks
    the model again; the thread persists the call with its answer."""
    script = [call_turn(*COUNT), text_turn("counted", cid="chatcmpl-s3")]
    body = {"model": "stub", "stream": True,
            "messages": [{"role": "user", "content": "count"}]}
    calls, events, raw, history = asyncio.run(serve_and_post(
        "port", tmp_path, script, "/v1/threads/c1/chat/completions", body))
    kinds = [e.get("type") or e.get("object") for e in events]
    first_done = kinds.index("agent_done")
    assert "tool_result" in kinds[:first_done]
    assert "tool_messages" in kinds[:first_done]
    assert len(calls) == 2
    assert calls[1]["messages"][-1] == {
        "role": "tool", "tool_call_id": "call_1", "content": "1\n2\n3\n"}
    assert events[-1]["type"] == "agent_done"
    assert events[-1]["reason"] in REASONS
    assert raw.rstrip().endswith("data: [DONE]")
    assert [m["role"] for m in history] == ["user", "assistant", "tool",
                                            "assistant"]
    assert history[1]["tool_calls"][0]["id"] == history[2]["tool_call_id"]


def test_mcp_servers_refused_at_boot(tmp_path, caplog):
    """A configured MCP server that cannot be reached no longer refuses
    the boot (tools/mcp.py is ported): as in the reference, it is skipped
    with a warning and the server serves without its tools."""
    from aiohttp.test_utils import TestClient, TestServer

    from kafka_tpu_torch.tools import MCPServerConfig

    Stub = SIDES["port"][0]

    async def go():
        app = await port_create_app(
            cfg=PortServingConfig(db_path=str(tmp_path / "m.db")),
            llm_provider=Stub([]), db=PortDB(str(tmp_path / "m.db")),
            tools=[], mcp_servers=[MCPServerConfig(
                name="fetch", url="http://127.0.0.1:9/mcp")])
        from kafka_tpu_torch.server.app import STATE_KEY

        async with TestClient(TestServer(app)) as c:
            health = await c.get("/health")
            assert health.status == 200
        return [t["function"]["name"]
                for t in app[STATE_KEY]["kafka"].get_tools()]

    names = asyncio.run(asyncio.wait_for(go(), 60))
    assert names == []
    assert "MCP server fetch failed to connect" in caplog.text


def test_prompt_sections_ship_with_the_package(tmp_path, monkeypatch):
    """The markdown sections are found from the package, whatever the
    current directory, and render the reference's prompt."""
    from kafka_tpu.prompts import PromptProviderV1 as RefPrompt
    from kafka_tpu_torch.prompts import PromptProviderV1, SECTION_FILES
    from kafka_tpu_torch.prompts.v1 import SECTIONS_DIR

    monkeypatch.chdir(tmp_path)
    assert SECTIONS_DIR.startswith(
        str(__import__("kafka_tpu_torch").__path__[0]))
    port = PromptProviderV1(variables=PROMPT_VARIABLES).get_system_prompt()
    ref = RefPrompt(variables=PROMPT_VARIABLES).get_system_prompt()
    assert port == ref and len(SECTION_FILES) == 13
