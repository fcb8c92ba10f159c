"""The port's MCP client against the JAX package's.

Both packages' `MCPConnection`s and `AgentToolProvider`s drive the stdio
stub server (tests/mcp_stub_server.py: `echo`, `progress_echo`, `fail`)
and an in-process streamable-HTTP stub: the discovered tools and the
ToolEvent sequences of every call must be equal.  An unreachable server
is skipped with a warning, on both.  With KAFKA_TORCH_MCP_SERVERS unset
the port's default is the reference's remote `fetch` server (read from
config only; nothing here dials it), and a thread turn through the port's
server calls the stub's `echo` tool.
"""

import asyncio
import json
import sys
from pathlib import Path

import pytest

from tests.test_mcp import _HTTPStub  # noqa: F401  (the HTTP stub handler)

STUB = str(Path(__file__).parent / "mcp_stub_server.py")
CALLS = [("echo", {"text": "hi"}), ("progress_echo", {"text": "x"}),
         ("fail", {}), ("nope", {})]


def package(side):
    if side == "ref":
        from kafka_tpu.tools import mcp, provider, types
    else:
        from kafka_tpu_torch.tools import mcp, provider, types
    return mcp, provider, types


def event_dicts(events):
    return [{"kind": e.kind, "data": e.data,
             "tool_call_id": e.tool_call_id} for e in events]


async def drive_connection(side, cfg_kw):
    mcp, _, types = package(side)
    conn = mcp.MCPConnection(types.MCPServerConfig(**cfg_kw), timeout=20.0)
    await conn.connect()
    try:
        tools = sorted((t.name, t.source, json.dumps(t.to_openai(),
                                                     sort_keys=True))
                       for t in conn.discovered_tools())
        calls = {}
        for name, args in CALLS:
            calls[name] = event_dicts(
                [ev async for ev in conn.call_tool_stream(name, args)])
        return conn.server_info, tools, calls
    finally:
        await conn.disconnect()


def test_stdio_discovery_and_events_match_the_reference():
    cfg = dict(name="stub", command=sys.executable, args=[STUB])
    want = asyncio.run(asyncio.wait_for(drive_connection("ref", cfg), 60))
    got = asyncio.run(asyncio.wait_for(drive_connection("port", cfg), 60))
    assert got == want
    info, tools, calls = got
    assert info["name"] == "stub"
    assert [t[0] for t in tools] == ["echo", "fail", "progress_echo"]
    assert calls["echo"][-1] == {"kind": "result", "data": "echo: hi",
                                 "tool_call_id": None}
    assert {"step 1", "step 2"} <= {e["data"] for e in
                                    calls["progress_echo"]
                                    if e["kind"] == "log"}
    assert calls["fail"][-1]["kind"] == "error"
    assert "unknown tool" in calls["nope"][-1]["data"]


@pytest.fixture
def http_stub():
    import threading
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), _HTTPStub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/mcp"
    server.shutdown()
    thread.join(timeout=5)


def test_streamable_http_matches_the_reference(http_stub):
    async def side(name):
        mcp, _, types = package(name)
        conn = mcp.MCPConnection(types.MCPServerConfig(
            name="h", url=http_stub, transport="streamable-http"),
            timeout=10.0)
        await conn.connect()
        try:
            return (conn.server_info, conn._transport._session_id,
                    [t.name for t in conn.discovered_tools()],
                    await conn.call_tool("ping", {}))
        finally:
            await conn.disconnect()

    want = asyncio.run(asyncio.wait_for(side("ref"), 60))
    got = asyncio.run(asyncio.wait_for(side("port"), 60))
    assert got == want == ({"name": "httpstub", "version": "1"}, "sess-1",
                           ["ping"], "pong")


async def drive_provider(side, servers):
    _, provider, types = package(side)
    prov = provider.AgentToolProvider(
        mcp_servers=[types.MCPServerConfig(**s) for s in servers])
    await prov.connect()
    try:
        names = sorted(t["function"]["name"] for t in prov.get_tools())
        events = event_dicts([ev async for ev in prov.run_tool_stream(
            "echo", {"text": "yo"}, tool_call_id="call_1")]) \
            if "echo" in names else []
        return names, events
    finally:
        await prov.disconnect()


@pytest.mark.parametrize("servers", [
    [dict(name="stub", command=sys.executable, args=[STUB])],
    [dict(name="dead", url="http://127.0.0.1:1",
          transport="streamable-http"),
     dict(name="stub", command=sys.executable, args=[STUB])],
    [dict(name="bad", command="/nonexistent-binary-xyz")],
], ids=["stdio", "unreachable_then_stdio", "spawn_failure"])
def test_provider_registers_or_skips_like_the_reference(servers, caplog):
    want = asyncio.run(asyncio.wait_for(drive_provider("ref", servers), 60))
    caplog.clear()
    got = asyncio.run(asyncio.wait_for(drive_provider("port", servers), 60))
    assert got == want
    if any(s["name"] == "stub" for s in servers):
        assert got[1][-1] == {"kind": "result", "data": "echo: yo",
                              "tool_call_id": "call_1"}
    else:
        assert got == ([], [])
    failed = [s["name"] for s in servers if s["name"] != "stub"]
    for name in failed:
        assert f"MCP server {name} failed to connect" in caplog.text


def test_default_mcp_servers_follow_the_reference(monkeypatch):
    """KAFKA_TORCH_MCP_SERVERS parses as the reference's variable does;
    unset, the default is the reference's remote fetch server."""
    from kafka_tpu.server_tools.mcp_servers import default_mcp_servers as ref
    from kafka_tpu_torch.server_tools.mcp_servers import default_mcp_servers

    def both(raw):
        for var in ("KAFKA_TPU_MCP_SERVERS", "KAFKA_TORCH_MCP_SERVERS"):
            if raw is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, raw)
        return ([vars(c) for c in default_mcp_servers()],
                [vars(c) for c in ref()])

    for raw in (json.dumps([{"name": "x", "url": "http://localhost:9"},
                            {"bogus_field": 1}]), "[]", "not json", "{}",
                None):
        port, want = both(raw)
        assert port == want, raw
    assert [c["name"] for c in port] == ["fetch"]
    assert port[0]["url"].startswith("https://")


def test_thread_turn_calls_the_stub_echo_tool(tmp_path):
    """A scripted turn through the port's server calls the stdio stub's
    `echo`: the stream carries its tool_result, as the reference's."""
    from aiohttp.test_utils import TestClient, TestServer

    from tests.test_torch_agent import SIDES, call_turn, text_turn

    script = [call_turn("echo", {"text": "via mcp"}),
              text_turn("done", cid="chatcmpl-s3")]

    async def side(name):
        if name == "ref":
            from kafka_tpu.server import ServingConfig
            from kafka_tpu.server.app import create_app
            from kafka_tpu.tools import MCPServerConfig
        else:
            from kafka_tpu_torch.server import ServingConfig
            from kafka_tpu_torch.server.app import create_app
            from kafka_tpu_torch.tools import MCPServerConfig
        Stub, DB = SIDES[name][0], SIDES[name][1]
        db_path = str(tmp_path / f"{name}.db")
        app = await create_app(
            cfg=ServingConfig(db_path=db_path, system_prompt="terse"),
            llm_provider=Stub(script), db=DB(db_path), tools=[],
            mcp_servers=[MCPServerConfig(name="stub", command=sys.executable,
                                         args=[STUB])])
        async with TestClient(TestServer(app)) as c:
            r = await c.post("/v1/threads/t-m/agent/run", json={
                "messages": [{"role": "user", "content": "echo it"}]})
            raw = await r.text()
            h = await c.get("/v1/threads/t-m/messages")
            msgs = (await h.json())["messages"]
        results = [json.loads(line[6:]) for line in raw.splitlines()
                   if line.startswith("data: {")
                   and '"tool_result"' in line]
        return [{k: v for k, v in e.items() if k != "id"}
                for e in results], [m["role"] for m in msgs]

    want = asyncio.run(asyncio.wait_for(side("ref"), 60))
    got = asyncio.run(asyncio.wait_for(side("port"), 60))
    assert got == want
    assert got[0] and "echo: via mcp" in json.dumps(got[0])
    assert got[1] == ["user", "assistant", "tool", "assistant"]
