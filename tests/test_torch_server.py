"""kafka_tpu_torch serving path on the CPU: provider, worker, HTTP server.

A tiny float32 model behind the port's create_app: a streamed two-turn
thread ends every stream with `data: [DONE]` and persists its history,
the stateless route streams too, and the provider's stream equals the
engine's greedy tokens.  These apps serve no tools besides the agent's
`idle` tool (`tools=[]`): the built-in tools' schemas alone are ~3k
byte-tokenizer tokens, past these small windows (tests/test_torch_agent.py
and tests/test_torch_sse_contract.py keep them, at a 4096 window).  Also: importing the port leaves jax and kafka_tpu
out of sys.modules, and its entry points refuse to start without CUDA
unless asked for the CPU.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from kafka_tpu_torch.core.types import ContextLengthError
from kafka_tpu_torch.llm import IncrementalDetokenizer, TorchLLMProvider
from kafka_tpu_torch.models import ByteTokenizer, get_config, init_params
from kafka_tpu_torch.runtime import EngineConfig, InferenceEngine
from kafka_tpu_torch.server import ServingConfig, build_provider, create_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def serving_cfg(tmp_path, **kw):
    return ServingConfig(**{**dict(
        tiny_model=True, max_batch=2, page_size=16, num_pages=160,
        max_pages_per_seq=64, prefill_buckets=(16, 32, 64, 128),
        max_new_tokens_default=8, db_path=str(tmp_path / "threads.db"),
        system_prompt="terse", warmup=False), **kw})


def sse_events(text):
    return [line[len("data: "):] for line in text.splitlines()
            if line.startswith("data: ")]


def test_streamed_thread_turns_persist_history(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        app = await create_app(serving_cfg(tmp_path, warmup=True),
                               tools=[], mcp_servers=[], device="cpu")
        usages = []
        async with TestClient(TestServer(app)) as c:
            for content in ("hello there", "and again"):
                r = await c.post(
                    "/v1/threads/t1/chat/completions",
                    json={"model": "tiny", "stream": True, "temperature": 0,
                          "max_tokens": 6,
                          "messages": [{"role": "user", "content": content}]})
                assert r.status == 200
                events = sse_events(await r.text())
                assert events[-1] == "[DONE]"
                parsed = [json.loads(e) for e in events[:-1]]
                assert not [e for e in parsed if e.get("type") == "error"]
                assert parsed[-1]["type"] == "agent_done"
                usages.append(next(e["usage"] for e in parsed
                                   if e.get("usage") and "object" in e))
            r = await c.get("/v1/threads/t1/messages")
            msgs = (await r.json())["messages"]
            r404 = await c.get("/v1/threads/nope/messages")
            health = await (await c.get("/health")).json()
            models = await (await c.get("/v1/models")).json()
        return usages, msgs, r404.status, health, models

    usages, msgs, status, health, models = asyncio.run(run())
    assert [m["role"] for m in msgs] == ["user", "assistant", "user",
                                         "assistant"]
    assert msgs[0]["content"] == "hello there"
    # the second turn's prompt holds the first turn
    assert usages[1]["prompt_tokens"] > usages[0]["prompt_tokens"] + \
        usages[0]["completion_tokens"]
    assert status == 404
    assert health["engine"]["device"] == "cpu"
    assert models["data"][0]["id"] == "llama-3.2-1b"


def test_server_cleanup_releases_the_model(tmp_path):
    """aiohttp keeps every Application that served a request in a
    process-wide cache, so after shutdown the app must not pin its
    engine: the engine and its weights are freed once the server is
    gone (a card that runs several servers in turn would otherwise keep
    every model's weights)."""
    import gc
    import weakref

    from aiohttp.test_utils import TestClient, TestServer
    from kafka_tpu_torch.server.app import STATE_KEY

    async def run():
        app = await create_app(serving_cfg(tmp_path), tools=[],
                               mcp_servers=[], device="cpu")
        engine = app[STATE_KEY]["llm"].engine
        refs = (weakref.ref(engine),
                weakref.ref(engine.params["layers"]["wq"]))
        del engine
        async with TestClient(TestServer(app)) as c:
            r = await c.post("/v1/chat/completions", json={
                "model": "tiny", "stream": True, "temperature": 0,
                "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}]})
            assert sse_events(await r.text())[-1] == "[DONE]"
        return refs

    refs = asyncio.run(run())
    gc.collect()
    assert [r() for r in refs] == [None, None]


def test_stateless_completion_streamed_and_not(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        app = await create_app(serving_cfg(tmp_path), tools=[],
                               mcp_servers=[], device="cpu")
        async with TestClient(TestServer(app)) as c:
            body = {"model": "tiny", "temperature": 0, "max_tokens": 4,
                    "messages": [{"role": "user", "content": "hi"}]}
            r1 = await c.post("/v1/chat/completions",
                              json={**body, "stream": True})
            t1 = await r1.text()
            r2 = await c.post("/v1/chat/completions", json=body)
            j2 = await r2.json()
            r3 = await c.post("/v1/chat/completions", data="not json")
        return t1, j2, r3.status

    text, completion, bad = asyncio.run(run())
    assert sse_events(text)[-1] == "[DONE]"
    assert completion["object"] == "chat.completion"
    assert completion["usage"]["completion_tokens"] == 4
    assert bad == 400


def test_provider_stream_matches_engine_tokens():
    cfg = get_config("tiny").replace(vocab_size=262, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    tok = ByteTokenizer()
    ecfg = EngineConfig(max_batch=2, page_size=16, num_pages=32,
                        max_pages_per_seq=16, prefill_buckets=(32, 64, 128))
    messages = [{"role": "user", "content": "count to three"}]
    ref = InferenceEngine(cfg, params, ecfg, device="cpu").generate(
        tok.encode_chat(messages), max_new_tokens=6,
        stop_token_ids=tuple(tok.stop_ids))
    provider = TorchLLMProvider(
        InferenceEngine(cfg, params, ecfg, device="cpu"), tok)

    async def run():
        try:
            return await provider.completion(messages, temperature=0.0,
                                             max_tokens=6)
        finally:
            await provider.aclose()

    resp = asyncio.run(run())
    detok = IncrementalDetokenizer(tok)
    text = "".join(detok.push(t) for t in ref.output_ids) + detok.flush()
    assert resp.usage["completion_tokens"] == len(ref.output_ids)
    if resp.tool_calls is None:
        assert (resp.content or "") == text


def test_context_overflow_is_typed():
    cfg = get_config("tiny").replace(vocab_size=262, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    ecfg = EngineConfig(max_batch=1, page_size=8, num_pages=8,
                        max_pages_per_seq=4, prefill_buckets=(8, 16, 32))
    provider = TorchLLMProvider(
        InferenceEngine(cfg, params, ecfg, device="cpu"), ByteTokenizer())

    async def run():
        try:
            with pytest.raises(ContextLengthError):
                await provider.completion(
                    [{"role": "user", "content": "x" * 100}], max_tokens=2)
        finally:
            await provider.aclose()

    asyncio.run(run())


def test_import_leaves_jax_and_kafka_tpu_out():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "pre = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.'))\n"
        "import kafka_tpu_torch, kafka_tpu_torch.server, "
        "kafka_tpu_torch.server.__main__, kafka_tpu_torch.runtime, "
        "kafka_tpu_torch.models, kafka_tpu_torch.models.quant_quality, "
        "kafka_tpu_torch.ops.kernels, "
        "kafka_tpu_torch.llm, kafka_tpu_torch.kafka, kafka_tpu_torch.db, "
        "kafka_tpu_torch.agents, kafka_tpu_torch.tools, "
        "kafka_tpu_torch.server_tools, kafka_tpu_torch.prompts, "
        "kafka_tpu_torch.llm.compaction, kafka_tpu_torch.llm.constrained, "
        "kafka_tpu_torch.tracing, "
        "kafka_tpu_torch.failpoints, kafka_tpu_torch.logs, "
        "kafka_tpu_torch.server.auth, kafka_tpu_torch.core.sse_client, "
        "kafka_tpu_torch.tools.mcp, kafka_tpu_torch.server_tools.mcp_servers, "
        "kafka_tpu_torch.sandbox, kafka_tpu_torch.sandbox.server, "
        "kafka_tpu_torch.runtime.metrics, kafka_tpu_torch.runtime.planner, "
        "kafka_tpu_torch.runtime.flight_recorder, "
        "kafka_tpu_torch.runtime.compile_log, "
        "kafka_tpu_torch.runtime.kernel_profiler, "
        "kafka_tpu_torch.server.prometheus, "
        "kafka_tpu_torch.runtime.kv_tier, "
        "kafka_tpu_torch.runtime.object_tier, "
        "kafka_tpu_torch.runtime.store_guard, "
        "kafka_tpu_torch.runtime.dp_router, "
        "kafka_tpu_torch.runtime.autoscaler\n"
        "bad = [m for m in sys.modules if m in ('jax', 'kafka_tpu', "
        "'ml_dtypes') or m.startswith(('jax.', 'kafka_tpu.', "
        "'ml_dtypes.'))]\n"
        "assert not pre and not bad, (pre, bad)\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_refuse_cpu_without_being_asked(tmp_path):
    """Without CUDA and without device="cpu", the engine, the provider
    builder and create_app raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    cfg = get_config("tiny").replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, params, EngineConfig(num_pages=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_provider(serving_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(create_app(serving_cfg(tmp_path)))
    with pytest.raises(RuntimeError):
        InferenceEngine(cfg, params, EngineConfig(num_pages=32),
                        device="cuda")


def test_concurrent_streams_through_the_worker():
    """More concurrent streams than batch slots and cores, with a short
    thread switch interval: every stream gets exactly its tokens and the
    worker's route table drains (a lost update would strand a stream or
    leak a route)."""
    cfg = get_config("tiny").replace(vocab_size=262, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(2))
    ecfg = EngineConfig(max_batch=2, page_size=8, num_pages=64,
                        max_pages_per_seq=16, prefill_buckets=(16, 32, 64))
    tok = ByteTokenizer()
    provider = TorchLLMProvider(
        InferenceEngine(cfg, params, ecfg, device="cpu"), tok)
    n = max(12, 2 * (os.cpu_count() or 1))

    async def one(i):
        resp = await provider.completion(
            [{"role": "user", "content": f"stream {i}"}], temperature=0.8,
            seed=i, max_tokens=5)
        return resp.usage["completion_tokens"]

    async def run():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(one(i) for i in range(n))), timeout=120)
        finally:
            await provider.aclose()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        counts = asyncio.run(run())
    finally:
        sys.setswitchinterval(prev)
    assert all(1 <= c <= 5 for c in counts) and len(counts) == n
    assert not provider.worker.alive
    assert provider.worker._routes == {}
    assert provider.engine._requests == {}


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernel library cannot be built: a clear error,
    never a silent fallback."""
    from kafka_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    real_exists = os.path.exists
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_decode")
    # library names follow the source and flags
    assert build._lib_path("paged_decode") != build._lib_path(
        "flash_prefill")
    assert build._lib_path("paged_decode").parent == tmp_path / "build"
    # ... and every shared header: an edited or added csrc/*.cuh renames
    # each library, so a stale one is never loaded
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(build, "CSRC", csrc)
    names = list(build.SIGNATURES)
    before = {n: build._lib_path(n) for n in names}
    header = csrc / "paged_chunks.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build._lib_path(n) for n in names}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {n: build._lib_path(n) for n in names}
    for n in names:
        assert len({before[n], edited[n], added[n]}) == 3, n


@pytest.mark.cuda
def test_kernels_build_from_sources():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from kafka_tpu_torch.ops.kernels import build

    seconds, _ = build.build_all()
    for name in build.SIGNATURES:
        assert build.load(name) is not None
    assert seconds >= 0


def test_port_sources_import_no_jax_and_no_kafka_tpu():
    """Static check over every source of the port and the chip smoke: no
    import of jax or of the JAX package, even on a path the subprocess
    check above does not execute."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|kafka_tpu)(\.|\s|$)",
                     re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "kafka_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert len(files) > 20 and offenders == []
