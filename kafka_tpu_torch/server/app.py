"""The HTTP API server, main-path slice: OpenAI-compatible endpoints and
the SSE protocol, served by aiohttp.

Counterpart of kafka_tpu/server/app.py:
  POST /v1/chat/completions                  stateless chat
  POST /v1/threads/{id}/chat/completions     thread chat w/ server-side history
  GET  /v1/threads/{id}/messages             thread history
  GET  /v1/models                            served models
  GET  /health                               liveness + engine stats

Both chat routes run the reference's agent turn (`_agent_events`,
kafka_tpu/server/app.py:803-900): `KafkaV1Provider` renders the system
prompt (`PromptProviderV1`, or the configured `system_prompt`), passes the
server's tools (the built-in weather, counter and planner tools by
default) to the LLM, executes the tools the model calls and loops, and
streams OpenAI chunks, `tool_result` and cumulative `tool_messages`
events, ending with `agent_done` and `data: [DONE]` (`"stream": true`) or
one JSON completion.  The thread route keeps history server-side through
`KafkaAgent.run_with_thread`, one provider per request; the stateless
route shares `state["kafka"]`.  MCP servers, sandbox tools, auth,
admin/debug routes and Prometheus wait for later slices of the port.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, AsyncIterator, Dict, List, Optional

import torch
from aiohttp import web
from pydantic import ValidationError

from ..core.types import (
    ContextLengthError,
    LLMProviderError,
    ServerOverloadedError,
    Usage,
    new_completion_id,
)
from ..core.wire import ChatCompletionRequest
from ..db import DBClient, LocalDBClient
from ..device import DeviceLike, resolve_device
from ..kafka import KafkaV1Provider, MessageAccumulator
from ..llm.base import LLMProvider
from ..tools import MCPServerConfig, Tool
from .config import ServingConfig
from .sse import sse_response


STATE_KEY = web.AppKey("kafka_torch_state", dict)


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------


def build_provider(cfg: ServingConfig, device: DeviceLike = None
                   ) -> LLMProvider:
    """Construct tokenizer + engine + provider per the serving config —
    the counterpart of kafka_tpu's build_tpu_provider (single replica).

    Without a checkpoint the model is random-init from cfg.seed with the
    byte tokenizer, so the vocab is the tokenizer's (262) and every other
    width is the named config's.  device: None = CUDA (raises without
    it); "cpu" for the tests."""
    from ..llm.torch_provider import TorchLLMProvider
    from ..models import get_config, init_params, load_checkpoint
    from ..models.quant import quantize_params
    from ..models.tokenizer import ByteTokenizer, load_tokenizer
    from ..runtime import EngineConfig, GenRequest, InferenceEngine

    for knob, mode in (("quantize", cfg.quantize),
                       ("kv_quantize", cfg.kv_quantize)):
        if mode not in ("", "int8"):
            raise ValueError(f"unknown {knob} mode {mode!r}")
    dev = resolve_device(device)
    if cfg.checkpoint_dir:
        tokenizer = load_tokenizer(cfg.checkpoint_dir)
        model_cfg, params = load_checkpoint(cfg.checkpoint_dir, device=dev)
    else:
        tokenizer = ByteTokenizer()
        if cfg.tiny_model:
            model_cfg = get_config("tiny").replace(
                vocab_size=tokenizer.vocab_size, dtype="float32")
        else:
            model_cfg = get_config(cfg.model_name).replace(
                vocab_size=max(tokenizer.vocab_size, 262), dtype=cfg.dtype)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = init_params(model_cfg, gen, device=dev)
    if cfg.quantize == "int8":
        params = quantize_params(params, model_cfg)
    engine_cfg = EngineConfig(
        max_batch=cfg.max_batch,
        page_size=cfg.page_size,
        num_pages=cfg.num_pages,
        max_pages_per_seq=cfg.max_pages_per_seq,
        prefill_buckets=cfg.prefill_buckets,
        max_new_tokens_default=cfg.max_new_tokens_default,
        multi_step=cfg.multi_step,
        max_ttft_s=cfg.max_ttft_s,
        max_total_s=cfg.request_timeout_s,
        max_waiting=cfg.max_queue_depth,
        prefix_cache_pages=cfg.prefix_cache_pages,
        speculative_k=cfg.speculative_k,
        kv_quantize=cfg.kv_quantize,
    )
    engine = InferenceEngine(model_cfg, params, engine_cfg, device=dev)
    if cfg.warmup:
        # on CUDA every kernel is built now (one nvcc per source, in
        # parallel), before the worker thread drives the engine; one lone
        # prompt over 128 tokens then takes the single-sequence prefill
        # (flash prefill kernel, or the page gather over an int8 pool) and
        # one decode step (the paged decode kernel, int8 or not, captured
        # as the 1-step graph).  With fused decode on, three concurrent
        # short requests then capture the multi_step graph, as the
        # reference's warmup compiles its fused program.  No prefix_key:
        # warmup must not seed the prefix cache.
        if dev.type == "cuda":
            from ..ops.kernels import build

            build.build_all()
        n = max(1, min(200, engine_cfg.max_window - 2))
        engine.submit(GenRequest(request_id="__warmup", prompt_ids=[3] * n,
                                 max_new_tokens=2))
        engine.run_to_completion()
        k = engine_cfg.multi_step
        if k > 1 and engine_cfg.max_batch >= 3 and \
                engine_cfg.max_window > k + 12:
            for i in range(3):
                engine.submit(GenRequest(request_id=f"__warmup_{i}",
                                         prompt_ids=[3] * 8,
                                         max_new_tokens=k + 2))
            engine.run_to_completion()
    return TorchLLMProvider(engine, tokenizer, model_name=cfg.model_name)


async def create_app(
    cfg: Optional[ServingConfig] = None,
    llm_provider: Optional[LLMProvider] = None,
    db: Optional[DBClient] = None,
    tools: Optional[List[Tool]] = None,
    mcp_servers: Optional[List[MCPServerConfig]] = None,
    device: DeviceLike = None,
) -> web.Application:
    """Build the application; the keyword seams override config-driven
    wiring (tests inject a provider, a DB or a tool set).  tools=None
    serves the built-in tools; mcp_servers defaults to none, and any
    configured server raises NotImplementedError until tools/mcp.py is
    ported."""
    cfg = cfg or ServingConfig.from_env()
    if llm_provider is None:
        llm_provider = build_provider(cfg, device=device)
    if db is None:
        db = LocalDBClient(cfg.db_path)
    await db.initialize()
    if tools is None:
        from ..server_tools import builtin_tools

        tools = builtin_tools()
    kafka = KafkaV1Provider(
        llm_provider,
        thread_db=db,
        tools=tools,
        mcp_servers=mcp_servers,
        default_model=cfg.model_name,
        system_prompt=cfg.system_prompt,
    )
    await kafka.initialize()
    app = web.Application(middlewares=[cors_middleware(cfg.cors_origins)])
    app[STATE_KEY] = {"cfg": cfg, "db": db, "llm": llm_provider,
                      "tools": tools, "mcp_servers": list(mcp_servers or []),
                      "kafka": kafka}
    r = app.router
    r.add_post("/v1/chat/completions", chat_completions)
    r.add_post("/v1/threads/{thread_id}/chat/completions",
               thread_chat_completions)
    r.add_get("/v1/threads/{thread_id}/messages", get_thread_messages)
    r.add_get("/v1/models", list_models)
    r.add_get("/health", health)
    app.on_cleanup.append(_cleanup)
    return app


async def _cleanup(app: web.Application) -> None:
    state = app[STATE_KEY]
    await state["kafka"].cleanup()
    await state["db"].close()
    await state["llm"].aclose()


def cors_middleware(origins: str):
    @web.middleware
    async def mw(request: web.Request, handler):
        if request.method == "OPTIONS":
            resp: web.StreamResponse = web.Response(status=204)
        else:
            try:
                resp = await handler(request)
            except web.HTTPException as e:
                resp = e
        resp.headers["Access-Control-Allow-Origin"] = origins
        resp.headers["Access-Control-Allow-Methods"] = "GET,POST,OPTIONS"
        resp.headers["Access-Control-Allow-Headers"] = \
            "Content-Type,Authorization"
        if isinstance(resp, web.HTTPException):
            raise resp
        return resp

    return mw


def _state(request: web.Request) -> dict:
    return request.app[STATE_KEY]


async def _parse(request: web.Request) -> ChatCompletionRequest:
    try:
        return ChatCompletionRequest.model_validate(await request.json())
    except ValidationError as e:
        raise web.HTTPBadRequest(text=e.json(),
                                 content_type="application/json")
    except ValueError:
        raise web.HTTPBadRequest(text='{"error": "invalid JSON body"}',
                                 content_type="application/json")


def _admission_gate(request: web.Request) -> None:
    """HTTP 429 + Retry-After when the engine's waiting queue is full."""
    check = getattr(_state(request)["llm"], "admission_check", None)
    retry_after = check() if check is not None else None
    if retry_after is None:
        return
    raise web.HTTPTooManyRequests(
        text=json.dumps({"error": {
            "message": "request queue is full; retry later "
                       "(server_overloaded)",
            "type": "server_overloaded",
        }}),
        content_type="application/json",
        headers={"Retry-After": str(max(1, int(retry_after)))},
    )


# ---------------------------------------------------------------------------
# serving endpoints
# ---------------------------------------------------------------------------


async def _agent_events(
    request: web.Request,
    body: ChatCompletionRequest,
    thread_id: Optional[str],
) -> AsyncIterator[Dict[str, Any]]:
    """Run the agent turn; yield protocol events + tool_messages.  As the
    reference does, sampling carries only temperature (default 0.7),
    max_tokens and tool_choice from the body."""
    state = _state(request)
    sampling: Dict[str, Any] = dict(
        temperature=body.temperature if body.temperature is not None
        else 0.7,
        max_tokens=body.max_tokens,
    )
    if body.tool_choice is not None:
        sampling["tool_choice"] = body.tool_choice
    messages = [m.model_dump(exclude_none=True) for m in body.messages]
    model = body.model or state["cfg"].model_name
    acc = MessageAccumulator()

    if thread_id is None:
        kafka = state["kafka"]
        stream = kafka.run(messages, model=model, **sampling)
    else:
        # per-thread provider: the thread's config (global_prompt,
        # playbooks, model) is read at initialize
        kafka = KafkaV1Provider(
            state["llm"],
            thread_db=state["db"],
            tools=state["tools"],
            mcp_servers=state["mcp_servers"],
            thread_id=thread_id,
            default_model=model,
            system_prompt=state["cfg"].system_prompt,
        )
        await kafka.initialize()
        stream = kafka.run_with_thread(thread_id, messages, **sampling)

    # the CUMULATIVE tool-cycle history is re-batched before each new
    # completion's chunks (and before agent_done) whenever its content
    # changed: a client replaces all its tool/tool-call messages with each
    # batch.  Plain assistant text streams live and is never batched.
    last_batched = None

    def _maybe_batch() -> Optional[Dict[str, Any]]:
        nonlocal last_batched
        batch = [m.to_dict() for m in acc.messages
                 if m.role == "tool" or m.tool_calls]
        fingerprint = hashlib.sha256(
            json.dumps(batch, sort_keys=True, default=str).encode()
        ).hexdigest()
        if batch and fingerprint != last_batched:
            last_batched = fingerprint
            return {"type": "tool_messages", "messages": batch}
        return None

    last_cid = None
    try:
        async for event in stream:
            if event.get("object") == "chat.completion.chunk":
                cid = event.get("id")
                if cid != last_cid:
                    last_cid = cid
                    batch_ev = _maybe_batch()
                    if batch_ev:
                        yield batch_ev
            acc.add_event(event)
            if event.get("type") == "agent_done":
                batch_ev = _maybe_batch()
                if batch_ev:
                    yield batch_ev
            yield event
    finally:
        if thread_id is not None:
            await kafka.cleanup()


async def _completion_response(events, model: str) -> web.Response:
    """Drain an event stream into one chat completion, with OpenAI-style
    structured errors."""
    acc = MessageAccumulator()
    usage = Usage()
    try:
        async for event in events:
            acc.add_event(event)
            if event.get("object") == "chat.completion.chunk" and \
                    event.get("usage"):
                u = event["usage"]
                usage.prompt_tokens += u.get("prompt_tokens", 0)
                usage.completion_tokens += u.get("completion_tokens", 0)
                usage.total_tokens += u.get("total_tokens", 0)
                usage.cached_prompt_tokens += (
                    u.get("prompt_tokens_details") or {}
                ).get("cached_tokens", 0)
    except ServerOverloadedError as e:
        return web.json_response(
            {"error": {"message": str(e), "type": "server_overloaded"}},
            status=429,
            headers={"Retry-After": str(max(1, int(e.retry_after_s)))},
        )
    except LLMProviderError as e:
        status = e.status_code or 500
        return web.json_response({"error": {
            "message": str(e),
            "type": "invalid_request_error" if status < 500
            else "server_error",
            "code": "context_length_exceeded"
            if isinstance(e, ContextLengthError) else None,
        }}, status=status)
    return web.json_response({
        "id": new_completion_id(),
        "object": "chat.completion",
        "created": 0,
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": acc.final_content},
            "finish_reason": "stop",
        }],
        "usage": usage.to_dict(),
    })


async def chat_completions(request: web.Request) -> web.StreamResponse:
    _admission_gate(request)
    body = await _parse(request)
    events = _agent_events(request, body, thread_id=None)
    if body.stream:
        return await sse_response(request, events)
    return await _completion_response(events, body.model)


async def thread_chat_completions(request: web.Request
                                  ) -> web.StreamResponse:
    _admission_gate(request)
    thread_id = request.match_info["thread_id"]
    body = await _parse(request)
    events = _agent_events(request, body, thread_id=thread_id)
    if body.stream:
        return await sse_response(request, events)
    return await _completion_response(events, body.model)


async def get_thread_messages(request: web.Request) -> web.Response:
    db = _state(request)["db"]
    tid = request.match_info["thread_id"]
    if not await db.thread_exists(tid):
        raise web.HTTPNotFound(text=json.dumps(
            {"error": f"thread {tid} not found"}),
            content_type="application/json")
    return web.json_response({"thread_id": tid,
                              "messages": await db.get_thread_messages(tid)})


async def list_models(request: web.Request) -> web.Response:
    llm = _state(request)["llm"]
    return web.json_response({"object": "list",
                              "data": llm.get_available_models()})


async def health(request: web.Request) -> web.Response:
    llm = _state(request)["llm"]
    payload: Dict[str, Any] = {"status": "ok"}
    engine = getattr(llm, "engine", None)
    if engine is not None:
        payload["engine"] = {
            "device": str(engine.device),
            "active": engine.num_active,
            "waiting": len(engine.waiting),
            "free_pages": engine.pool.free_pages,
            "total_pages": engine.pool.num_pages,
        }
    return web.json_response(payload)


def run_server(cfg: Optional[ServingConfig] = None,
               device: DeviceLike = None) -> None:
    cfg = cfg or ServingConfig.from_env()
    web.run_app(create_app(cfg, device=device), host=cfg.host, port=cfg.port)
