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
(503, /health, shutdown drain), the playground, and the admin routes of
the DP router over stub providers: /admin/drain/{replica} on one engine
and on two replicas, /admin/resize (resized, re-pooled, a bad dp, bad
roles, a drain that does not finish, no token, one engine),
/admin/autoscaler off and in recommend mode, /admin/signals at dp 2.
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
            "token", "user_id", "profile_id", "final_content_id",
            "t", "t_last")


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
            # the packages' env knobs differ only in their prefix
            obj = obj.replace("KAFKA_TORCH_", "KAFKA_TPU_")
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


async def drain_then_wake(c, rec, ctx):
    auth = {"Authorization": "Bearer sekrit"}
    await rec("turn", await c.post("/v1/threads/t-w/chat/completions",
                                   json=user("q1"), headers=auth))
    await rec("no_auth", await c.post("/admin/drain/0"))
    await rec("not_int", await c.post("/admin/drain/x", headers=auth))
    await rec("other", await c.post("/admin/drain/1", headers=auth))
    await rec("no_tier", await c.post("/admin/drain/0", headers=auth))
    await rec("busy", await c.post("/admin/drain/0", headers=auth))
    await rec("drained", await c.post("/admin/drain/0", headers=auth))
    await rec("wake", await c.post("/v1/threads/t-w/chat/completions",
                                   json=user("q2"), headers=auth))
    rec.notes.append(ctx["llm"].drains)


async def drain_needs_a_token(c, rec, ctx):
    await rec("no_token", await c.post("/admin/drain/0"))


DRAINED = {"enabled": True, "runs_archived": 2, "runs_failed": 0,
           "runs_skipped_store_down": 0, "manifests": 1,
           "manifests_failed": 0, "threads": 1, "bytes_put": 4096,
           "dedupe_hits": 0, "breaker_state": "closed"}


async def _drain_replica(self, replica):
    """A stub engine's drain: another index is out of range, the first
    call finds no object tier, the second a worker that will not pause,
    the third archives."""
    if replica != 0:
        raise ValueError(f"replica {replica} out of range (dp=1)")
    self.drains += 1
    if self.drains == 1:
        return {"enabled": False, "replica": 0}
    if self.drains == 2:
        raise RuntimeError("engine worker did not pause")
    return {**DRAINED, "replica": 0}


async def _drain(self, timeout_s):
    self.drained_with = timeout_s
    return True


async def resize(c, rec, ctx):
    auth = {"Authorization": "Bearer sekrit"}
    await rec("no_auth", await c.post("/admin/resize", json={"dp": 1}))
    await rec("ok", await c.post("/admin/resize", json={"dp": 1},
                                 headers=auth))
    await rec("roles", await c.post("/admin/resize", json={
        "dp": 2, "roles": "prefill:1,decode:1", "drain_timeout_s": 5},
        headers=auth))
    await rec("dissolve", await c.post("/admin/resize", json={
        "dp": 2, "roles": None}, headers=auth))
    await rec("bad_dp", await c.post("/admin/resize", json={"dp": 9},
                                     headers=auth))
    await rec("zero", await c.post("/admin/resize", json={"dp": 0},
                                   headers=auth))
    await rec("bad_roles", await c.post("/admin/resize", json={
        "dp": 2, "roles": "prefill:2,decode:1"}, headers=auth))
    await rec("roles_type", await c.post("/admin/resize", json={
        "dp": 2, "roles": 3}, headers=auth))
    await rec("not_json", await c.post("/admin/resize", data="x",
                                       headers=auth))
    await rec("busy", await c.post("/admin/resize", json={"dp": 3},
                                   headers=auth))
    rec.notes.append(ctx["llm"].resizes)


async def resize_needs_a_token(c, rec, ctx):
    await rec("no_token", await c.post("/admin/resize", json={"dp": 1}))


async def not_resizable(c, rec, ctx):
    await rec("one_engine", await c.post(
        "/admin/resize", json={"dp": 2},
        headers={"Authorization": "Bearer sekrit"}))


class _Router:
    """The stub provider's engine: a resizable replica set of 8 slots."""

    def rebuild(self, dp, roles=None):
        pass


async def _resize_dp(self, dp, drain_timeout_s=30.0, roles="keep"):
    """A stub provider's resize: the router's device budget (8 slots) and
    role rule, a started request that will not drain at dp 3, else a
    clean rebuild."""
    from kafka_tpu_torch.runtime.dp_router import validate_roles_spec

    if dp > 8:
        raise ValueError(f"dp={dp} x 1 devices/replica needs {dp}, have 8")
    if roles != "keep":
        validate_roles_spec(roles, dp)
    if dp == 3:
        raise RuntimeError("resize_dp: started work did not drain")
    self.__dict__.setdefault("resizes", []).append(
        (dp, drain_timeout_s, roles))
    return True


def _signals(self):
    """A stub provider's dp-2 autoscaler feed."""
    return {"version": 9, "dp": 2,
            "queue": {"depth": 0, "peak": 0, "trend_per_s": 0.0},
            "slo": {"slo_attainment_1m": 1.0, "window_1m_requests": 0},
            "batch": {"occupancy": 0.0, "occupancy_frac": 0.0,
                      "active": 0, "max_batch": 8, "slots_total": 16},
            "utilization": {"decode": {"mfu_1m": 0.0,
                                       "hbm_bw_util_1m": 0.0}},
            "anomalies": {"anomalies_active": 0},
            "replicas": [{"replica": 0, "state": "healthy"},
                         {"replica": 1, "state": "probation"}],
            "pools": [{"role": "colocated", "replicas": [0, 1],
                       "queue_depth": 0}],
            "supervisor": {"states": ["healthy", "probation"],
                           "quarantines": 1, "readmits": 0},
            "autoscaler": None}


async def autoscaler_off(c, rec, ctx):
    await rec("log", await c.get("/admin/autoscaler"))


async def autoscaler_recommend(c, rec, ctx):
    scaler = ctx["app"][ctx["key"]]["autoscaler"]
    for _ in range(500):
        if scaler.counters["autoscaler_polls"]:
            break
        await asyncio.sleep(0.01)
    await rec("log", await c.get("/admin/autoscaler"))
    await rec("signals", await c.get("/admin/signals"))


async def signals_dp2(c, rec, ctx):
    await rec("signals", await c.get("/admin/signals"))


async def _drain_replica_dp2(self, replica):
    """A stub router's drain over two replicas."""
    if not 0 <= replica < 2:
        raise ValueError(f"replica {replica} out of range (dp=2)")
    self.drains += 1
    return {**DRAINED, "replica": replica}


async def drain_replica_1(c, rec, ctx):
    auth = {"Authorization": "Bearer sekrit"}
    await rec("one", await c.post("/admin/drain/1", headers=auth))
    await rec("two", await c.post("/admin/drain/2", headers=auth))
    await rec("zero", await c.post("/admin/drain/0", headers=auth))
    rec.notes.append(ctx["llm"].drains)


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
    "drain_then_wake": (drain_then_wake, dict(
        script=[text_turn("one"), text_turn("two", cid="chatcmpl-s4")],
        api_token="sekrit",
        llm_extra={"drain_replica": _drain_replica, "drains": 0,
                   "engine": True})),
    "drain_needs_a_token": (drain_needs_a_token, dict(
        llm_extra={"drain_replica": _drain_replica, "drains": 0,
                   "engine": True})),
    "resize": (resize, dict(api_token="sekrit", llm_extra={
        "resize_dp": _resize_dp, "engine": _Router()})),
    "resize_needs_a_token": (resize_needs_a_token, dict(llm_extra={
        "resize_dp": _resize_dp, "engine": _Router()})),
    "resize_one_engine_501": (not_resizable, dict(
        api_token="sekrit", llm_extra={"resize_dp": _resize_dp,
                                       "engine": True})),
    "autoscaler_off_404": (autoscaler_off, {}),
    "autoscaler_recommend": (autoscaler_recommend, dict(
        autoscale="recommend", llm_extra={"signals": _signals,
                                          "engine": True})),
    "drain_replica_1_of_2": (drain_replica_1, dict(
        api_token="sekrit", llm_extra={"drain_replica": _drain_replica_dp2,
                                       "drains": 0, "engine": True})),
    "signals_dp2": (signals_dp2, dict(llm_extra={"signals": _signals,
                                                 "engine": True})),
}


# Flows whose SSE chunks stamp "created" from core/types.py's clock.  The
# recorder masks "created" by value, so a stream that crosses a second
# boundary in one package and not in the other records <created:1>
# against <created:0> although both behave alike: the clock is frozen in
# both packages for these flows.
STREAMED = ("streamed_tool_cycle", "usage_over_tool_loop", "agent_runs")
FROZEN_CLOCK = 1_700_000_000


def freeze_chunk_clock(monkeypatch):
    import types

    import kafka_tpu.core.types as ref_types
    import kafka_tpu_torch.core.types as port_types

    clock = types.SimpleNamespace(time=lambda: FROZEN_CLOCK)
    for mod in (ref_types, port_types):
        monkeypatch.setattr(mod, "time", clock)


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_matches_the_reference(tmp_path, monkeypatch, name):
    flow, kw = FLOWS[name]
    if name in STREAMED:
        freeze_chunk_clock(monkeypatch)
    if name.startswith("autoscaler"):
        # one poll at start, then none within the flow
        for pkg in ("TPU", "TORCH"):
            monkeypatch.setenv(f"KAFKA_{pkg}_AUTOSCALE_INTERVAL_S", "3600")
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
        "drain_then_wake": {"turn": 200, "no_auth": 401, "not_int": 400,
                            "other": 400, "no_tier": 409, "busy": 409,
                            "drained": 200, "wake": 200},
        "drain_needs_a_token": {"no_token": 403},
        "resize": {"no_auth": 401, "ok": 200, "roles": 200, "dissolve": 200,
                   "bad_dp": 400, "zero": 400, "bad_roles": 400,
                   "roles_type": 400, "not_json": 400, "busy": 409},
        "resize_needs_a_token": {"no_token": 403},
        "resize_one_engine_501": {"one_engine": 501},
        "autoscaler_off_404": {"log": 404},
        "autoscaler_recommend": {"log": 200, "signals": 200},
        "drain_replica_1_of_2": {"one": 200, "two": 400, "zero": 200},
        "signals_dp2": {"signals": 200},
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
    if name == "resize":
        assert rec.notes == [[(1, 30.0, "keep"),
                              (2, 5.0, "prefill:1,decode:1"),
                              (2, 30.0, None)]]
    if name == "autoscaler_recommend":
        log = rec.items[0][3]
        assert log["mode"] == "recommend" and len(log["decisions"]) == 1
        assert rec.items[1][3]["dp"] == 2
    if name == "drain_replica_1_of_2":
        assert rec.items[0][3]["replica"] == 1 and rec.notes == [2]


def test_port_registers_every_reference_route():
    """All of the reference's 29 routes, the DP router's two admin routes
    (/admin/autoscaler, /admin/resize) the last to come."""
    from kafka_tpu.server import app as ref_app
    from kafka_tpu_torch.server import app as port_app

    def routes(mod):
        src = open(mod.__file__).read()
        return set(re.findall(r'r\.add_(get|post|put|delete)\("([^"]+)"',
                              src))

    ref, port = routes(ref_app), routes(port_app)
    assert len(ref) == 29 and port == ref


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
