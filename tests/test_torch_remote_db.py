"""kafka_tpu_torch's remote thread store and checkpoint lookup against the
JAX package, on the CPU.

* `db/remote.py`: the port's RemoteDBClient and the reference's each run
  the same scripted session against their own fresh copy of one aiohttp
  PostgREST stub (tests/test_remote_db.py's): every return value and
  every row the stub ends with are equal — thread CRUD, ordered
  messages, multi-part content flattening, the sandbox binding, the
  thread-config join, the config replace contract, and VM-key reuse,
  minting through the RPC and the local fallback when the RPC fails;
* `make_db_client` picks the remote store when KAFKA_TORCH_REMOTE_DB_URL
  is set, and the port's server then serves its threads from it;
* `models/loader.py` resolve_checkpoint_dir finds the same local
  directories as the reference's (its env dir, ./checkpoints, the HF
  cache), and only ones holding safetensors.
"""

import asyncio
import json
import os

import pytest
from aiohttp.test_utils import TestClient, TestServer

from kafka_tpu.db.remote import RemoteDBClient as JRemoteDBClient
from kafka_tpu.db.remote import _flatten_content as j_flatten
from kafka_tpu.models.loader import (
    resolve_checkpoint_dir as jresolve_checkpoint_dir,
)
from kafka_tpu_torch.db import LocalDBClient, make_db_client
from kafka_tpu_torch.db.remote import RemoteDBClient, _flatten_content
from kafka_tpu_torch.models import resolve_checkpoint_dir
from test_remote_db import StubPostgrest


def _profile_rows(stub):
    stub.tables["profiles"].append({"id": "user-1", "name": "Ada"})
    stub.tables["kafka_profiles"].append({
        "id": "kp-1", "user_id": "user-1", "global_prompt": "Be terse.",
        "memory_dsn": "dsn://x", "model": "llama-3.2-1b"})
    stub.tables["vm_api_keys"].append({
        "id": "vk-1", "thread_id": "t", "api_key": "vm_abc",
        "status": "active", "created_at": 1.0})
    stub.tables["playbooks"].append({
        "id": "pb-1", "kafka_profile_id": "kp-1", "name": "deploy",
        "created_at": 1.0})


async def s_threads(db, stub):
    out = [await db.create_thread("t1", {"k": "v"}),
           await db.thread_exists("t1"), await db.thread_exists("nope"),
           await db.create_thread("t1"),
           (await db.get_thread_metadata("t1"))["metadata"],
           [t["thread_id"] for t in await db.list_threads()]]
    await db.delete_thread("t1")
    return out + [await db.thread_exists("t1")]


async def s_messages(db, stub):
    await db.create_thread("t")
    await db.add_messages("t", [{"role": "user", "content": "one"},
                                {"role": "assistant", "content": "two"}])
    await db.add_message("t", {"role": "user", "content": [
        {"type": "text", "text": "hello "},
        {"type": "image_url", "image_url": {"url": "x"}},
        {"type": "text", "text": "world"}]})
    msgs = await db.get_thread_messages("t")
    await db.delete_thread_messages("t")
    return [msgs, await db.get_thread_messages("t")]


async def s_sandbox(db, stub):
    await db.create_thread("t")
    before = await db.get_thread_sandbox_id("t")
    await db.update_thread_sandbox_id("t", "sb-9")
    return [before, await db.get_thread_sandbox_id("t")]


async def s_config_join(db, stub):
    _profile_rows(stub)
    await db.create_thread("t")
    await db.set_thread_config("t", {
        "kafka_profile_id": "kp-1", "vm_api_key_id": "vk-1",
        "user_id": "user-1", "ignored_field": "x"})
    await db.create_thread("bare")
    return [await db.get_thread_config("t"),
            await db.get_thread_config("bare"),
            await db.get_thread_config("ghost")]


async def s_config_replace(db, stub):
    await db.create_thread("t")
    out = []
    for cfg in ({"model": "m1", "user_id": "u1"}, {"global_prompt": "p"},
                {"user_id": None}, None):
        await db.set_thread_config("t", cfg)
        out.append(await db.get_thread_config("t"))
    return out


async def s_vm_keys(db, stub):
    stub.tables["vm_api_keys"].append({
        "id": "vk", "thread_id": "t", "api_key": "vm_keep",
        "status": "active"})
    return [await db.get_or_create_vm_api_key("t"),
            await db.get_or_create_vm_api_key("t9"),
            await db.get_or_create_vm_api_key("t9"), list(stub.rpc_calls)]


async def s_vm_key_fallback(db, stub):
    stub.fail_rpc = True
    key = await db.get_or_create_vm_api_key("t")
    return [key.startswith("vm_"), len(key), list(stub.rpc_calls)]


SESSIONS = [s_threads, s_messages, s_sandbox, s_config_join,
            s_config_replace, s_vm_keys, s_vm_key_fallback]


def _minted(k, v):
    """A per-run value: a uuid4 row id, or a locally minted vm_ key."""
    if not isinstance(v, str):
        return False
    return (k == "id" and len(v) == 36 and v.count("-") == 4) or \
        (k == "api_key" and v.startswith("vm_") and len(v) > 30)


def _normal(x):
    """Rows and results without the per-run values: timestamps and
    locally minted ids or keys."""
    if isinstance(x, dict):
        return {k: _normal(v) for k, v in x.items()
                if k not in ("created_at", "updated_at")
                and not _minted(k, v)}
    if isinstance(x, list):
        return [_normal(v) for v in x]
    return x


def _run(client_cls, session):
    stub = StubPostgrest()

    async def go():
        server = TestServer(stub.app())
        await server.start_server()
        db = client_cls(str(server.make_url("")), api_key="svc-key")
        try:
            out = await session(db, stub)
        finally:
            await db.close()
            await server.close()
        return out, stub.tables

    return _normal(json.loads(json.dumps(asyncio.run(go()), default=str)))


@pytest.mark.parametrize("session", SESSIONS, ids=lambda f: f.__name__[2:])
def test_remote_client_equals_reference(session):
    want = _run(JRemoteDBClient, session)
    got = _run(RemoteDBClient, session)
    assert got == want


def test_flatten_content_equals_reference():
    for c in ("plain", None, [{"type": "text", "text": "a"}, "b",
                              {"type": "tool", "x": 1}]):
        assert _flatten_content(c) == j_flatten(c)


def test_make_db_client_picks_by_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("KAFKA_TORCH_REMOTE_DB_URL", raising=False)
    assert isinstance(make_db_client(str(tmp_path / "t.db")), LocalDBClient)
    monkeypatch.setenv("KAFKA_TORCH_REMOTE_DB_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("KAFKA_TORCH_REMOTE_DB_KEY", "k")
    db = make_db_client(str(tmp_path / "t.db"))
    assert isinstance(db, RemoteDBClient)
    asyncio.run(db.close())


def test_server_serves_threads_from_the_remote_store(tmp_path, monkeypatch):
    """With KAFKA_TORCH_REMOTE_DB_URL set, the port's server writes a
    thread turn to the PostgREST store and reads its history back."""
    from kafka_tpu_torch.runtime import compile_log as pcomp
    from kafka_tpu_torch.server import ServingConfig, create_app

    # the server's compile observatory is process-wide: leave it as found
    monkeypatch.setattr(pcomp, "_OBS", pcomp._OBS)
    stub = StubPostgrest()

    async def go():
        server = TestServer(stub.app())
        await server.start_server()
        monkeypatch.setenv("KAFKA_TORCH_REMOTE_DB_URL",
                           str(server.make_url("")))
        monkeypatch.setenv("KAFKA_TORCH_REMOTE_DB_KEY", "svc-key")
        app = await create_app(ServingConfig(
            tiny_model=True, max_batch=2, page_size=16, num_pages=160,
            max_pages_per_seq=64, prefill_buckets=(16, 32, 64, 128),
            db_path=str(tmp_path / "unused.db"), system_prompt="terse",
            warmup=False), tools=[], mcp_servers=[], device="cpu")
        try:
            async with TestClient(TestServer(app)) as c:
                r = await c.post("/v1/threads/t1/chat/completions", json={
                    "model": "tiny", "stream": False, "temperature": 0,
                    "max_tokens": 4,
                    "messages": [{"role": "user", "content": "hello"}]})
                assert r.status == 200, await r.text()
                r = await c.get("/v1/threads/t1/messages")
                msgs = (await r.json())["messages"]
        finally:
            await server.close()
        return msgs

    msgs = asyncio.run(go())
    assert (msgs[0]["role"], msgs[0]["content"]) == ("user", "hello")
    assert [r["id"] for r in stub.tables["threads"]] == ["t1"]
    assert [r["message"]["role"] for r in stub.tables["oai_messages"]][0] \
        == "user"
    assert not os.path.exists(tmp_path / "unused.db")


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    """A scratch working directory and HF cache, and both packages' env
    dir knobs pointed at one place."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    env = tmp_path / "env"
    monkeypatch.setenv("KAFKA_TORCH_CKPT_DIR", str(env))
    monkeypatch.setenv("KAFKA_TPU_CKPT_DIR", str(env))
    return tmp_path


def _ckpt(path, weights=True):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write("{}")
    if weights:
        with open(os.path.join(path, "model.safetensors"), "wb") as f:
            f.write(b"\0")


@pytest.mark.parametrize("where", ["env", "local", "hf_cache", "no_weights",
                                   "absent", "env_first"])
def test_resolve_checkpoint_dir_equals_reference(ckpt_env, where):
    name = "llama-3.2-1b"
    env = str(ckpt_env / "env" / name)
    local = os.path.join("checkpoints", name)
    snap = str(ckpt_env / "hf" / "hub" / f"models--meta-llama--{name}"
               / "snapshots" / "abc123")
    want_path = {"env": env, "local": local, "hf_cache": snap,
                 "no_weights": None, "absent": None, "env_first": env}[where]
    if where in ("env", "local", "hf_cache"):
        _ckpt({"env": env, "local": local, "hf_cache": snap}[where])
    elif where == "no_weights":
        _ckpt(local, weights=False)
    elif where == "env_first":
        _ckpt(local)
        _ckpt(env)
    got = resolve_checkpoint_dir(name)
    assert got == jresolve_checkpoint_dir(name) == want_path
