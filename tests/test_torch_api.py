"""The port's thread API against the JAX package's, route by route.

The flows of tests/test_server.py and tests/test_auth_sessions.py (all
but the metrics, admin and resize ones) run on both packages' apps, each
over its own `LocalDBClient` and a stub LLM that replays the same neutral
script (tests/test_torch_agent.py).  Every response is recorded as
(request, status, Retry-After, body) with generated ids, tokens and
timestamps masked consistently within the flow, SSE streams parsed into
events; the two records must be equal.  Covered: health and models, the
full thread lifecycle, a missing thread's 404, an invalid body's 400,
buffered and streamed chat with a tool cycle, thread history, summed
usage, both agent/run routes, profiles and their inheritance, the bearer
token, signup / login / per-user threads, admission (429) and draining
(503, /health, shutdown drain), and the playground.
"""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from tests.test_torch_agent import SIDES, call_turn, text_turn


def add(a: int, b: int):
    return a + b


def package(side):
    if side == "ref":
        from kafka_tpu.server import ServingConfig
        from kafka_tpu.server.app import STATE_KEY, create_app
        from kafka_tpu.tools import Tool
    else:
        from kafka_tpu_torch.server import ServingConfig
        from kafka_tpu_torch.server.app import STATE_KEY, create_app
        from kafka_tpu_torch.tools import Tool
    return ServingConfig, STATE_KEY, create_app, Tool


# values that differ run to run: masked to first-seen placeholders, so a
# flow that reuses an id still shows it as the same id
VOLATILE = ("id", "created", "created_at", "updated_at", "expires_at",
            "token", "user_id", "profile_id", "final_content_id")


class Recorder:
    def __init__(self):
        self.items = []
        self.notes = []
        self._seen = {}

    def _ph(self, key, value):
        k = (key, json.dumps(value, sort_keys=True))
        if k not in self._seen:
            self._seen[k] = f"<{key}:{sum(1 for s in self._seen if s[0] == key)}>"
        return self._seen[k]

    def mask(self, obj, key=None):
        if isinstance(obj, dict):
            return {k: self.mask(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.mask(v, key) for v in obj]
        if key in VOLATILE or (key in ("thread_id", "deleted", "cleared")
                               and isinstance(obj, str)
                               and not obj.startswith("t-")):
            return self._ph(key, obj)
        if isinstance(obj, str):
            return re.sub(r"sess_[\w-]+", lambda m: self._ph("token",
                                                           m.group(0)), obj)
        return obj

    async def __call__(self, label, r):
        ctype = r.headers.get("Content-Type", "")
        text = await r.text()
        if ctype.startswith("text/event-stream"):
            body = [e if e == "[DONE]" else self.mask(json.loads(e))
                    for e in (line[len("data: "):]
                              for line in text.splitlines()
                              if line.startswith("data: "))]
        elif ctype.startswith("application/json"):
            body = self.mask(json.loads(text))
        else:
            body = (ctype.split(";")[0], len(text) > 0)
        self.items.append((label, r.status, r.headers.get("Retry-After"),
                           body))
        return json.loads(text) if ctype.startswith("application/json") \
            else None


async def run_flow(side, flow, tmp_path, script=(), llm_extra=None,
                   **cfg_kw):
    Stub, DB = SIDES[side][0], SIDES[side][1]
    if llm_extra:
        Stub = type("Stub", (Stub,), dict(llm_extra))
    llm = Stub(list(script))
    ServingConfig, STATE_KEY, create_app, Tool = package(side)
    db_path = str(tmp_path / f"{side}-{flow.__name__}.db")
    db = DB(db_path)
    app = await create_app(
        cfg=ServingConfig(db_path=db_path,
                          **{"system_prompt": "terse", **cfg_kw}),
        llm_provider=llm, db=db,
        tools=[Tool(name="add", description="", handler=add)],
        mcp_servers=[])
    rec = Recorder()
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        await flow(client, rec, dict(app=app, key=STATE_KEY, llm=llm, db=db))
    finally:
        await client.close()  # idempotent: a flow may have closed it
    return rec


def both(flow, tmp_path, **kw):
    """The flow's record on the reference's app and on the port's."""
    want = asyncio.run(asyncio.wait_for(
        run_flow("ref", flow, tmp_path, **kw), 120))
    got = asyncio.run(asyncio.wait_for(
        run_flow("port", flow, tmp_path, **kw), 120))
    assert got.items == want.items
    assert got.notes == want.notes
    return got


def user(content="hi", **kw):
    return {"model": "stub", "messages": [{"role": "user",
                                           "content": content}], **kw}


# ---------------------------------------------------------------------------
# flows
# ---------------------------------------------------------------------------


async def health_and_models(c, rec, ctx):
    await rec("health", await c.get("/health"))
    await rec("models", await c.get("/v1/models"))


async def thread_lifecycle(c, rec, ctx):
    await rec("create", await c.post("/v1/threads", json={"thread_id": "t-x"}))
    await rec("list", await c.get("/v1/threads"))
    await rec("get", await c.get("/v1/threads/t-x"))
    await rec("config", await c.put("/v1/threads/t-x/config",
                                    json={"model": "m2"}))
    await rec("get2", await c.get("/v1/threads/t-x"))
    await rec("msgs", await c.get("/v1/threads/t-x/messages"))
    await rec("clear", await c.delete("/v1/threads/t-x/messages"))
    await rec("delete", await c.delete("/v1/threads/t-x"))
    await rec("gone", await c.get("/v1/threads/t-x"))
    await rec("minted", await c.post("/v1/threads", json={}))


async def missing_and_invalid(c, rec, ctx):
    await rec("missing", await c.get("/v1/threads/ghost/messages"))
    await rec("missing_get", await c.get("/v1/threads/ghost"))
    await rec("missing_delete", await c.delete("/v1/threads/ghost"))
    await rec("bad_body", await c.post("/v1/chat/completions",
                                       json={"bad": 1}))
    await rec("not_json", await c.post("/v1/agent/run", data="not json"))


async def buffered_chat(c, rec, ctx):
    await rec("chat", await c.post("/v1/chat/completions", json=user()))


async def streamed_tool_cycle(c, rec, ctx):
    await rec("stream", await c.post("/v1/chat/completions",
                                     json=user("1+2?", stream=True)))


async def thread_chat_history(c, rec, ctx):
    for q in ("q1", "q2"):
        await rec(q, await c.post("/v1/threads/t-chat/chat/completions",
                                  json=user(q, thought_signature=None)))
    await rec("msgs", await c.get("/v1/threads/t-chat/messages"))


async def usage_over_tool_loop(c, rec, ctx):
    await rec("buffered", await c.post("/v1/threads/t-u/chat/completions",
                                       json=user("1+2?")))
    await rec("sse", await c.post("/v1/threads/t-u2/chat/completions",
                                  json=user("1+2?", stream=True)))


async def agent_runs(c, rec, ctx):
    await rec("run", await c.post("/v1/agent/run", json=user("go")))
    await rec("thread_run", await c.post("/v1/threads/t-agent/agent/run",
                                         json=user("go")))
    await rec("msgs", await c.get("/v1/threads/t-agent/messages"))


async def profiles(c, rec, ctx):
    p = await rec("create", await c.post("/v1/profiles", json={
        "name": "research", "config": {"global_prompt": "Always cite.",
                                       "model": "tiny"}}))
    await rec("list", await c.get("/v1/profiles"))
    t = await rec("thread", await c.post(
        "/v1/threads", json={"profile_id": p["profile_id"]}))
    rec.notes.append(rec.mask(await ctx["db"].get_thread_config(
        t["thread_id"])))
    await rec("run", await c.post(f"/v1/threads/{t['thread_id']}/agent/run",
                                  json=user("go")))
    system = [m for m in ctx["llm"].calls[-1]["messages"]
              if m.get("role") == "system"]
    rec.notes.append("Always cite." in json.dumps(system))
    await rec("unknown", await c.post("/v1/threads",
                                      json={"profile_id": "profile_nope"}))
    await rec("no_name", await c.post("/v1/profiles", json={"config": {}}))
    await rec("after", await c.get("/v1/threads"))


async def bearer_token(c, rec, ctx):
    await rec("none", await c.get("/v1/threads"))
    await rec("wrong", await c.get(
        "/v1/threads", headers={"Authorization": "Bearer wrong"}))
    await rec("non_ascii", await c.get(
        "/v1/threads", headers={"Authorization": "Bearer sékrit"}))
    await rec("right", await c.get(
        "/v1/threads", headers={"Authorization": "Bearer sekrit"}))
    await rec("health", await c.get("/health"))
    await rec("playground", await c.get("/playground"))
    await rec("signup_closed", await c.post("/v1/auth/signup", json={
        "email": "a@b.c", "password": "longenough"}))
    s = await rec("signup_token", await c.post(
        "/v1/auth/signup", json={"email": "a@b.c", "password": "longenough"},
        headers={"Authorization": "Bearer sekrit"}))
    await rec("session_passes", await c.get(
        "/v1/threads", headers={"Authorization": f"Bearer {s['token']}"}))
    await rec("login_open", await c.post("/v1/auth/login", json={
        "email": "a@b.c", "password": "longenough"}))


async def open_server(c, rec, ctx):
    await rec("threads", await c.get("/v1/threads"))
    await rec("run", await c.post("/v1/agent/run", json=user("go")))


async def sessions(c, rec, ctx):
    a = await rec("signup", await c.post("/v1/auth/signup", json={
        "email": "Ada@Example.com ", "password": "lovelace"}))
    ha = {"Authorization": f"Bearer {a['token']}"}
    await rec("dup", await c.post("/v1/auth/signup", json={
        "email": "ada@example.com", "password": "xxxxxx"}))
    await rec("short", await c.post("/v1/auth/signup", json={
        "email": "x@y.z", "password": "123"}))
    await rec("bad_json", await c.post("/v1/auth/login", data="[1]"))
    await rec("wrong_pw", await c.post("/v1/auth/login", json={
        "email": "ada@example.com", "password": "wrong!"}))
    await rec("login", await c.post("/v1/auth/login", json={
        "email": "ada@example.com", "password": "lovelace"}))
    b = await rec("signup_b", await c.post("/v1/auth/signup", json={
        "email": "bob@example.com", "password": "bobs-pass"}))
    hb = {"Authorization": f"Bearer {b['token']}"}
    await rec("create_a", await c.post("/v1/threads",
                                       json={"thread_id": "t-ada"},
                                       headers=ha))
    await rec("list_a", await c.get("/v1/threads", headers=ha))
    await rec("list_b", await c.get("/v1/threads", headers=hb))
    await rec("b_get", await c.get("/v1/threads/t-ada", headers=hb))
    await rec("b_delete", await c.delete("/v1/threads/t-ada", headers=hb))
    await rec("b_run", await c.post("/v1/threads/t-ada/agent/run",
                                    json=user("go"), headers=hb))
    await rec("a_get", await c.get("/v1/threads/t-ada", headers=ha))
    await rec("bogus", await c.get(
        "/v1/threads", headers={"Authorization": "Bearer sess_bogus"}))
    await rec("anon_list", await c.get("/v1/threads"))
    # a read by a session user does not claim an anonymous thread
    await rec("anon_create", await c.post("/v1/threads",
                                          json={"thread_id": "t-anon"}))
    await rec("a_reads_anon", await c.get("/v1/threads/t-anon", headers=ha))
    await rec("anon_still", await c.get("/v1/threads"))
    # a chat by a session user binds the thread to them
    await rec("a_chat", await c.post("/v1/threads/t-chat/chat/completions",
                                     json=user("hi"), headers=ha))
    await rec("a_list", await c.get("/v1/threads", headers=ha))
    await rec("anon_list2", await c.get("/v1/threads"))


async def overloaded(c, rec, ctx):
    await rec("chat", await c.post("/v1/chat/completions", json=user()))
    await rec("thread_chat", await c.post(
        "/v1/threads/t-o/chat/completions", json=user()))
    await rec("run", await c.post("/v1/agent/run", json=user()))
    await rec("thread_run", await c.post("/v1/threads/t-o/agent/run",
                                         json=user()))
    await rec("crud_open", await c.post("/v1/threads", json={}))


async def draining(c, rec, ctx):
    ctx["app"][ctx["key"]]["draining"] = True
    await rec("health", await c.get("/health"))
    for path in ("/v1/chat/completions", "/v1/agent/run",
                 "/v1/threads/t-d/chat/completions",
                 "/v1/threads/t-d/agent/run"):
        await rec(path, await c.post(path, json=user()))
    await rec("reads_open", await c.get("/v1/threads"))


async def shutdown_drains(c, rec, ctx):
    await rec("health", await c.get("/health"))
    await c.close()  # on_shutdown runs the drain
    state = ctx["app"][ctx["key"]]
    rec.notes.append((ctx["llm"].drained_with, state["draining"],
                      state["cfg"].drain_timeout_s))


async def playground(c, rec, ctx):
    r = await c.get("/playground")
    await rec("page", r)
    rec.notes.append(r.headers["Content-Type"].split(";")[0])


async def _drain(self, timeout_s):
    self.drained_with = timeout_s
    return True


TOOL_CYCLE = [call_turn("add", {"a": 1, "b": 2}),
              text_turn("3", cid="chatcmpl-s3")]
FLOWS = {
    "health_and_models": (health_and_models, {}),
    "thread_lifecycle": (thread_lifecycle, {}),
    "missing_thread_404_invalid_body_400": (missing_and_invalid, {}),
    "buffered_chat": (buffered_chat,
                      dict(script=[text_turn("hello ", "world")])),
    "streamed_tool_cycle": (streamed_tool_cycle, dict(script=TOOL_CYCLE)),
    "thread_chat_history": (thread_chat_history, dict(
        script=[text_turn("first"), text_turn("second", cid="chatcmpl-s4")])),
    "usage_over_tool_loop": (usage_over_tool_loop,
                             dict(script=TOOL_CYCLE + TOOL_CYCLE)),
    "agent_runs": (agent_runs, dict(script=[text_turn("done deal"),
                                            text_turn("ok")])),
    # the rendered prompt (no static system_prompt) carries the thread's
    # global_prompt section
    "profiles_and_inheritance": (profiles, dict(script=[text_turn("ok")],
                                                system_prompt=None)),
    "bearer_token_required": (bearer_token, dict(api_token="sekrit")),
    "no_token_stays_open": (open_server, dict(script=[text_turn("ok")])),
    "signup_login_and_ownership": (sessions, dict(script=[text_turn("ok")])),
    "queue_full_429": (overloaded, dict(
        llm_extra={"admission_check": lambda self: 7.0})),
    "draining_503": (draining, dict(drain_timeout_s=12.0)),
    "shutdown_calls_drain": (shutdown_drains, dict(
        llm_extra={"drain": _drain, "drained_with": None},
        drain_timeout_s=9.0)),
    "playground": (playground, {}),
}


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_matches_the_reference(tmp_path, name):
    flow, kw = FLOWS[name]
    rec = both(flow, tmp_path, **kw)
    assert rec.items, name
    statuses = {label: status for label, status, _, _ in rec.items}
    # the port's own answers, beyond equality with the reference
    expect = {
        "thread_lifecycle": {"create": 201, "gone": 404, "minted": 201},
        "missing_thread_404_invalid_body_400": {
            "missing": 404, "bad_body": 400, "not_json": 400},
        "bearer_token_required": {"none": 401, "wrong": 401,
                                  "non_ascii": 401, "right": 200,
                                  "health": 200, "playground": 200,
                                  "signup_closed": 401,
                                  "session_passes": 200},
        "signup_login_and_ownership": {"dup": 409, "wrong_pw": 401,
                                       "b_get": 404, "b_delete": 404,
                                       "b_run": 404, "bogus": 401},
        "queue_full_429": {"chat": 429, "thread_run": 429,
                           "crud_open": 201},
        "draining_503": {"health": 503, "/v1/agent/run": 503,
                         "reads_open": 200},
        "profiles_and_inheritance": {"create": 201, "unknown": 400},
    }.get(name, {})
    for label, status in expect.items():
        assert statuses[label] == status, (label, statuses)
    if name == "queue_full_429":
        assert all(ra == "7" for label, st, ra, _ in rec.items if st == 429)
    if name == "draining_503":
        assert all(ra == "12" for label, st, ra, _ in rec.items
                   if st == 503 and label != "health")
    if name == "shutdown_calls_drain":
        assert rec.notes == [(9.0, True, 9.0)]
    if name == "profiles_and_inheritance":
        assert rec.notes[1] is True


def test_port_registers_the_reference_routes_but_nine():
    """Twenty-six routes: the reference's 29 less the three admin routes
    that come with the DP router (/admin/autoscaler, /admin/resize,
    /admin/drain/{replica}).  Nine were missing before the telemetry
    routes landed."""
    from kafka_tpu.server import app as ref_app
    from kafka_tpu_torch.server import app as port_app

    def routes(mod):
        src = open(mod.__file__).read()
        return set(re.findall(r'r\.add_(get|post|put|delete)\("([^"]+)"',
                              src))

    ref, port = routes(ref_app), routes(port_app)
    assert port <= ref
    missing = sorted(p for _, p in ref - port)
    assert len(port) == 26 and missing == [
        "/admin/autoscaler", "/admin/drain/{replica}", "/admin/resize"]


def test_port_sse_client_is_the_reference(tmp_path):
    """core/sse_client.py, the reconstruction rules the playground
    follows, is a copy: both reconstruct the same streamed tool cycle to
    the same transcript."""
    from kafka_tpu.core.sse_client import SSEMessageReconstructor as Ref
    from kafka_tpu_torch.core.sse_client import SSEMessageReconstructor

    async def raw(side):
        out = []

        async def flow(c, rec, ctx):
            r = await c.post("/v1/threads/t-s/chat/completions",
                             json=user("1+2?", stream=True))
            out.append(await r.text())

        flow.__name__ = f"sse_{side}"
        await run_flow(side, flow, tmp_path, script=TOOL_CYCLE)
        return out[0]

    recs = []
    for side, cls in (("ref", Ref), ("port", SSEMessageReconstructor)):
        rec = cls()
        rec.feed_text(asyncio.run(raw(side)))
        assert rec.done and rec.errors == []
        recs.append(rec.messages)
    assert recs[1] == recs[0]
    assert [m["role"] for m in recs[1]] == ["assistant", "tool", "assistant"]
