"""The HTTP API server: OpenAI-compatible endpoints and the SSE protocol,
served by aiohttp.

Counterpart of kafka_tpu/server/app.py:
  POST /v1/chat/completions                  stateless chat (agent loop)
  POST /v1/threads/{id}/chat/completions     thread chat w/ server-side history
  POST /v1/agent/run                         stateless agent run (SSE)
  POST /v1/threads/{id}/agent/run            thread agent run (SSE)
  POST /v1/threads                           create thread (optional profile)
  GET  /v1/threads                           list threads (per user)
  GET  /v1/threads/{id}                      thread metadata
  GET  /v1/threads/{id}/messages             thread history
  DELETE /v1/threads/{id}                    delete thread
  DELETE /v1/threads/{id}/messages           clear history
  PUT  /v1/threads/{id}/config               set per-thread config
  GET/POST /v1/profiles                      list / create config profiles
  POST /v1/auth/signup, /v1/auth/login       user sessions
  GET  /v1/models                            served models
  GET  /health                               liveness + engine stats (503
                                             while draining)
  GET  /metrics                              the metrics registry (JSON, or
                                             ?format=prometheus)
  GET  /admin/signals                        the autoscaler input snapshot
  GET  /admin/autoscaler                     the autoscaler's decision log
  POST /admin/resize                         rebuild the DP replica set
  POST /admin/drain/{replica}                flush a replica to the store
  POST /debug/profile                        a torch.profiler window
                                             (KAFKA_TORCH_PROFILING=1)
  GET  /debug/traces, /debug/trace/{id}      recent traces / one span tree
  GET  /debug/flight/{replica}               the flight recorder's ring
  GET  /debug/compiles                       the compile observatory
  GET  /debug/kernels                        sampled per-kernel device time
                                             (KAFKA_TORCH_PROFILE_SAMPLE)
  GET  /playground                           the in-tree chat client

Every serving route runs the reference's agent turn (`_agent_events`):
`KafkaV1Provider` renders the system prompt (`PromptProviderV1`, or the
configured `system_prompt`), passes the server's tools (the built-in
weather, counter and planner tools, the sandbox's shell and notebook tools
when `local_sandbox_url` is set, and every configured MCP server's tools)
to the LLM, executes the tools the model calls and loops, and streams
OpenAI chunks, `tool_result` and cumulative `tool_messages` events, ending
with `agent_done` and `data: [DONE]` (`"stream": true`) or one JSON
completion.  Thread routes keep history server-side through
`KafkaAgent.run_with_thread`, one provider per request.

Middlewares, outermost first: CORS; tracing (every serving request gets or
adopts a trace id from X-Request-Id / traceparent, echoed back, and runs
inside its `http.request` span); auth (the static bearer token
`api_token` and per-user `sess_` tokens; thread ownership per user).  On
shutdown the server drains: /health answers 503, serving routes answer
503 + Retry-After, and in-flight streams get `drain_timeout_s` to finish.
With `dp_size > 1` the engine is a DataParallelEngines router over
replica slots (KAFKA_TORCH_REPLICA_DEVICES), optionally split into
prefill and decode pools (KAFKA_TORCH_DP_ROLES); with KAFKA_TORCH_AUTOSCALE
an autoscaler controller polls /admin/signals' snapshot and resizes it.
With `tp_size > 1` (KAFKA_TORCH_TP_SIZE) and/or `ep_size > 1`
(KAFKA_TORCH_EP_SIZE, a MoE model's experts) the engine is rank 0 of a
rank group over tp_size * ep_size cards (parallel/); a group that breaks
(a rank dies) fails its in-flight requests with an error event and turns
/health to 503 "unhealthy", and shutdown stops every rank.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import logging
import os
import tempfile
from typing import Any, AsyncIterator, Dict, List, Optional

import torch
from aiohttp import web, web_app
from pydantic import ValidationError

from ..core.types import (
    ContextLengthError,
    LLMProviderError,
    ServerOverloadedError,
    Usage,
    new_completion_id,
)
from .. import failpoints, tracing
from ..core.wire import AgentRunRequest, ChatCompletionRequest
from ..db import DBClient, make_db_client
from ..device import DeviceLike, resolve_device
from ..kafka import KafkaV1Provider, MessageAccumulator
from ..llm.base import LLMProvider
from ..tools import MCPServerConfig, Tool
from .config import ServingConfig
from .sse import sse_response


logger = logging.getLogger("kafka_tpu_torch.server")

STATE_KEY = web.AppKey("kafka_torch_state", dict)


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------


def build_provider(cfg: ServingConfig, device: DeviceLike = None
                   ) -> LLMProvider:
    """Construct tokenizer + engine + provider per the serving config —
    the counterpart of kafka_tpu's build_tpu_provider: one engine, or
    with dp_size > 1 a DataParallelEngines router over the replica slots.

    Without a checkpoint the model is random-init from cfg.seed with the
    byte tokenizer, so the vocab is the tokenizer's (262) and every other
    width is the named config's.  device: None = CUDA (raises without
    it); "cpu" for the tests."""
    from ..llm.torch_provider import TorchLLMProvider
    from ..models import get_config, init_params, load_checkpoint
    from ..models.quant import quantize_params
    from ..models.tokenizer import ByteTokenizer, load_tokenizer
    from ..runtime import EngineConfig, GenRequest, InferenceEngine
    from ..runtime import compile_log
    from ..runtime.metrics import EngineMetrics
    from ..runtime.planner import hbm_for_device, plan_for_serving

    # the compile observatory exists before the first kernel build or
    # graph capture, so the boot-phase compiles are in its ring
    # (KAFKA_TORCH_COMPILE_RING=0 leaves it off)
    compile_log.init()
    compile_log.set_phase("boot")
    for knob, mode in (("quantize", cfg.quantize),
                       ("kv_quantize", cfg.kv_quantize)):
        if mode not in ("", "int8"):
            raise ValueError(f"unknown {knob} mode {mode!r}")
    dev = resolve_device(device)
    mesh = _tensor_mesh(cfg)
    # drawn already quantized (a MoE model's random weights)
    drawn_int8 = False
    if cfg.checkpoint_dir:
        tokenizer = load_tokenizer(cfg.checkpoint_dir)
        model_cfg, params = load_checkpoint(cfg.checkpoint_dir, device=dev)
    else:
        tokenizer = ByteTokenizer()
        if cfg.tiny_model:
            model_cfg = get_config("tiny").replace(
                vocab_size=tokenizer.vocab_size, dtype="float32")
        else:
            base = get_config(cfg.model_name)
            vocab = max(tokenizer.vocab_size, 262)
            if base.image_token_id is not None:
                # the reserved image-placeholder id stays in the vocab
                vocab = max(vocab, base.image_token_id + 1)
            model_cfg = base.replace(vocab_size=vocab, dtype=cfg.dtype)
        if mesh is not None:
            # every rank draws its own shard on its own card
            from ..parallel import RandomWeights

            params = RandomWeights(seed=cfg.seed, quantize=cfg.quantize)
        elif model_cfg.is_moe:
            # one expert at a time, quantized as drawn: an int8
            # mixtral-8x7b never exists in bf16 (~93 GB) here, and its
            # weights are the ones an ep group draws from the same seed
            from ..parallel import init_params_shard

            params = init_params_shard(model_cfg, cfg.seed, device=dev,
                                       quantize=cfg.quantize)
            drawn_int8 = cfg.quantize == "int8"
        else:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = init_params(model_cfg, gen, device=dev)
    if cfg.quantize == "int8" and mesh is None and not drawn_int8:
        params = quantize_params(params, model_cfg)
    if cfg.dp_roles and cfg.dp_size <= 1:
        raise ValueError(
            "KAFKA_TORCH_DP_ROLES needs dp_size > 1: role pools split the "
            "DP fleet into prefill and decode replicas")
    slots = _replica_slots(cfg, dev) if cfg.dp_size > 1 else [dev]
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
        kv_host_tier_mb=cfg.kv_host_tier_mb,
        kv_disk_tier_dir=cfg.kv_disk_tier_dir,
        kv_object_dir=cfg.kv_object_dir,
        kv_object_mb=cfg.kv_object_mb,
    )
    if cfg.flight_ring is not None:
        # None defers to the EngineConfig default (KAFKA_TORCH_FLIGHT_RING)
        engine_cfg.flight_ring = cfg.flight_ring
    # memory-fit validation (runtime/planner.py) against the device's
    # memory: weights alone over the budget fail here; the plan is
    # attached to the engine's memory monitor, which reconciles it with
    # the caching allocator's bytes at step cadence
    memory_plan = None
    hbm = hbm_for_device(dev)
    if hbm:
        memory_plan = _card_plan(
            plan_for_serving(cfg, hbm, model_cfg=model_cfg),
            max(slots.count(d) for d in slots))
        if memory_plan.weight_bytes > memory_plan.usable_bytes:
            raise MemoryError(
                f"{model_cfg.name} weights alone need "
                f"{memory_plan.weight_bytes / 2**30:.1f} GiB, budget "
                f"{memory_plan.usable_bytes / 2**30:.1f} GiB: "
                f"{memory_plan.summary()} — quantize or pick a bigger card")
        log = logger.warning if not memory_plan.fits else logger.info
        log("memory plan: %s", memory_plan.summary())
    if cfg.warmup and dev.type == "cuda":
        # on CUDA every kernel is built now (one nvcc per source, in
        # parallel), before any engine or worker thread runs
        compile_log.set_phase("warmup")
        from ..ops.kernels import build

        build.build_all()
    if cfg.dp_size > 1:
        from ..runtime.dp_router import DataParallelEngines

        engine = DataParallelEngines(
            model_cfg, params, engine_cfg, dp=cfg.dp_size, devices=slots,
            quarantine_threshold=cfg.replica_quarantine_threshold,
            rebuild_threshold=cfg.replica_rebuild_threshold,
            dp_roles=cfg.dp_roles,
            disagg_min_prefill_tokens=cfg.disagg_min_prefill_tokens)
        # replicas a resize or a quarantine escalation builds later get
        # the same plan and warmup before they serve
        engine.memory_plan = memory_plan
    elif mesh is not None:
        # rank 0 here, ranks 1..n-1 spawned on cuda:1..n-1 (or the CPU
        # when the caller asked for it)
        engine = InferenceEngine(
            model_cfg, params, engine_cfg,
            device="cpu" if dev.type == "cpu" else None, mesh=mesh)
    else:
        engine = InferenceEngine(model_cfg, params, engine_cfg, device=dev)
    replicas = getattr(engine, "engines", [engine])
    for e in replicas:
        if memory_plan is not None and e.memory_monitor is not None:
            e.memory_monitor.plan = memory_plan

    def warm(e) -> None:
        _warmup(cfg, e, engine_cfg, tokenizer)
        # /metrics reflects serving only (the flight ring keeps warmup)
        e.metrics = EngineMetrics()
        if e.kernel_sampler is not None:
            # its profiler window belongs to this thread; the worker
            # thread opens its own
            e.kernel_sampler.close(e.metrics)

    if cfg.warmup:
        compile_log.set_phase("warmup")
        # every replica runs every serving program once, then the
        # cross-replica ships of the role pools (no-op colocated)
        for e in replicas:
            warm(e)
        if cfg.dp_size > 1:
            engine.warmup_disagg()
            engine.warm_engine = warm
    for e in replicas:
        if e.kernel_sampler is not None:
            e.kernel_sampler.close(e.metrics)
    # everything compiled past this point is work under live traffic:
    # the observatory's storm detector counts only this phase
    compile_log.set_phase("first_traffic")
    vision_params = None
    if model_cfg.vision is not None:
        # the vision tower (models/vision.py), random-init like the text
        # weights (no checkpoint in the repo carries one), on the first
        # replica's device
        from ..models.vision import vision_init_params

        vdev = replicas[0].device
        vision_params = vision_init_params(
            model_cfg.vision, model_cfg.hidden_size,
            torch.Generator(device=vdev).manual_seed(7),
            dtype=model_cfg.activation_dtype, device=vdev)
    return TorchLLMProvider(engine, tokenizer, model_name=cfg.model_name,
                            vision_params=vision_params)


def _tensor_mesh(cfg: ServingConfig):
    """The MeshConfig of the server's rank group (tp x ep), None at
    tp_size = ep_size = 1.  The tensor degree splits by
    resolve_tensor_axes, as the planner charges it."""
    if cfg.tp_size <= 1 and cfg.ep_size <= 1:
        return None
    if cfg.dp_size > 1:
        raise ValueError(
            f"dp_size={cfg.dp_size} x tp_size={cfg.tp_size} x "
            f"ep_size={cfg.ep_size}: replicas of a rank group are not "
            "ported (ROADMAP A9, dp x tp and dp x ep)")
    if cfg.checkpoint_dir:
        raise ValueError(
            "a checkpoint on a rank group (tp_size or ep_size > 1) is not "
            "ported: each rank would load its own shard of the "
            "safetensors files (ROADMAP A9)")
    from ..models import get_config
    from ..parallel import MeshConfig, resolve_tensor_axes

    model_cfg = get_config("tiny" if cfg.tiny_model else cfg.model_name)
    tp, tq = resolve_tensor_axes(max(cfg.tp_size, 1),
                                 model_cfg.num_kv_heads)
    return MeshConfig(tp=tp, tq=tq, ep=max(cfg.ep_size, 1))


def _replica_slots(cfg: ServingConfig, dev) -> List[torch.device]:
    """The DP router's replica slots: KAFKA_TORCH_REPLICA_DEVICES when
    set, else one slot per visible card on CUDA, or dp_size CPU slots
    when the caller asked for the CPU."""
    if cfg.replica_devices:
        return [resolve_device(d.strip())
                for d in cfg.replica_devices.split(",") if d.strip()]
    if dev.type == "cuda":
        from ..runtime.dp_router import default_replica_devices

        return default_replica_devices()
    return [dev] * cfg.dp_size


def _card_plan(plan, replicas_on_card: int):
    """One card's plan when `replicas_on_card` replicas share it: the
    weights once (the replicas share the tensors), every replica's KV
    pool, activations and grammar tables.  Each replica's memory monitor
    then compares the card's live bytes with this sum, not with one
    replica's share."""
    import dataclasses

    n = replicas_on_card
    if n <= 1:
        return plan
    return dataclasses.replace(
        plan,
        kv_pool_bytes=plan.kv_pool_bytes * n,
        activation_bytes=plan.activation_bytes * n,
        grammar_table_bytes=plan.grammar_table_bytes * n,
        notes=(plan.notes + "; " if plan.notes else "")
        + f"{n} replicas share the card (weights once)")


def _warmup(cfg: ServingConfig, engine, engine_cfg, tokenizer) -> None:
    """The reference's server warmup (kafka_tpu/server/app.py:300-376):
    every serving program runs once before the worker thread drives the
    engine, so the first request pays serving latency, not a kernel
    build, a graph capture or a grammar table registration.  Warmup is
    operator traffic: the admission bound is lifted for it, and no
    request carries a prefix_key (warmup must not seed the prefix
    cache)."""
    from ..agents.base import IDLE_TOOL
    from ..llm.constrained import (
        build_tool_call_mask_fn,
        compile_grammar_for_mask_fn,
        grammar_ondevice_enabled,
    )
    from ..runtime import GenRequest
    from ..server_tools import builtin_tools

    bound, engine_cfg.max_waiting = engine_cfg.max_waiting, 0
    try:
        window = engine_cfg.max_window
        # one prompt per prefill bucket, sized to land in it: a
        # conversation grows through the bucket ladder
        bucket_lens = sorted({
            min(b, window - engine_cfg.multi_step - 4)
            for b in engine_cfg.prefill_buckets})
        for j, blen in enumerate(bucket_lens):
            engine.submit(GenRequest(request_id=f"__warmup_b{j}",
                                     prompt_ids=[3] * max(1, blen),
                                     max_new_tokens=1))
            engine.run_to_completion()  # one at a time: bounded pool use
        # three concurrent lanes engage the fused multi-step decode
        per_engine = 3 if engine_cfg.multi_step > 1 and \
            cfg.max_batch >= 3 else 1
        for i in range(per_engine):
            engine.submit(GenRequest(
                request_id=f"__warmup_{i}",
                prompt_ids=[3] * min(8, window // 4),
                max_new_tokens=engine_cfg.multi_step + 2))
        # a host-masked request: the masked prefill, a forced step (one
        # allowed id) and an ambiguous step (two)
        engine.submit(GenRequest(
            request_id="__warmup_con",
            prompt_ids=[3] * 4, max_new_tokens=3,
            logits_mask_fn=lambda out: (
                [3] if len(out) == 0 else
                [3, 4] if len(out) == 1 else None)))
        engine.run_to_completion()
        # every sampling mode of the plain decode program (the warm
        # prompts above decode greedily)
        engine.warmup_sampling()
        # the speculative verify step (no-op at speculative_k 0)
        engine.warmup_verify()
        # the device-FSM tables and step variants for the grammar the
        # agent path constrains to: the built-in tools plus the idle tool
        if grammar_ondevice_enabled():
            tools = [t.to_openai() for t in builtin_tools(
                sandbox_url=cfg.local_sandbox_url)] + [IDLE_TOOL]
            mask = build_tool_call_mask_fn(tokenizer, tools, "required")
            grammar = (compile_grammar_for_mask_fn(
                mask, engine.cfg.vocab_size) if mask is not None else None)
            if grammar is not None:
                engine.warmup_grammar(grammar)
        # the KV tier's per-bucket ships (no-op without a tier)
        engine.warmup_kv_tier()
    finally:
        engine_cfg.max_waiting = bound


async def create_app(
    cfg: Optional[ServingConfig] = None,
    llm_provider: Optional[LLMProvider] = None,
    db: Optional[DBClient] = None,
    tools: Optional[List[Tool]] = None,
    mcp_servers: Optional[List[MCPServerConfig]] = None,
    device: DeviceLike = None,
) -> web.Application:
    """Build the application; the keyword seams override config-driven
    wiring (tests inject a provider, a DB, a tool set or MCP servers).
    tools=None serves the built-in tools (plus the sandbox's when
    `local_sandbox_url` is set); mcp_servers=None reads
    KAFKA_TORCH_MCP_SERVERS, and with it unset the reference's remote
    `fetch` server — an unreachable server is skipped with a warning."""
    cfg = cfg or ServingConfig.from_env()
    # late env injection (KAFKA_TORCH_FAILPOINTS set after import): arm
    # any configured failpoints before the engine builds
    failpoints.load_env()
    # tracing / slow-log config is per deployment, applied before the
    # engine builds so every request is eligible from boot
    tracing.configure(
        sample=cfg.trace_sample,
        ring=cfg.trace_ring,
        slow_ttft_ms=cfg.slow_ttft_ms or 0,
        slow_total_ms=cfg.slow_total_ms or 0,
    )
    # SLO targets likewise, before the engine builds, so every
    # EngineMetrics (the post-warmup reset too) classifies against this
    # deployment's targets.  Always called: None clears an earlier app
    # build's override back to the env / default.
    from ..runtime.metrics import configure_slo

    configure_slo(ttft_ms=cfg.slo_ttft_ms, tpot_ms=cfg.slo_tpot_ms)
    if llm_provider is None:
        llm_provider = build_provider(cfg, device=device)
    if db is None:
        # the remote PostgREST store when KAFKA_TORCH_REMOTE_DB_URL is
        # set, else SQLite at db_path
        db = make_db_client(cfg.db_path)
    await db.initialize()
    if tools is None:
        from ..server_tools import builtin_tools

        tools = builtin_tools(sandbox_url=cfg.local_sandbox_url)
    if mcp_servers is None:
        from ..server_tools.mcp_servers import default_mcp_servers

        mcp_servers = default_mcp_servers()
    kafka = KafkaV1Provider(
        llm_provider,
        thread_db=db,
        tools=tools,
        mcp_servers=mcp_servers,
        default_model=cfg.model_name,
        system_prompt=cfg.system_prompt,
    )
    await kafka.initialize()
    app = web.Application(middlewares=[
        cors_middleware(cfg.cors_origins),
        tracing_middleware(),
        auth_middleware(cfg.api_token),
    ])
    state = {"cfg": cfg, "db": db, "llm": llm_provider, "tools": tools,
             "mcp_servers": list(mcp_servers or []), "kafka": kafka,
             "draining": False, "autoscaler": None}
    app[STATE_KEY] = state
    # the autoscaler (runtime/autoscaler.py) is built only when
    # KAFKA_TORCH_AUTOSCALE asks for it and the provider emits signals —
    # "off" constructs nothing.  Its thread starts on the running loop:
    # act-mode resizes schedule provider.resize_dp onto it.
    from ..runtime.autoscaler import MODE_OFF, parse_mode

    if (parse_mode(cfg.autoscale) != MODE_OFF
            and getattr(llm_provider, "signals", None) is not None):
        from ..runtime.autoscaler import (
            AutoscalerConfig,
            AutoscalerController,
        )

        scaler = AutoscalerController(
            llm_provider,
            AutoscalerConfig.from_env(mode=parse_mode(cfg.autoscale)),
            is_draining=lambda: bool(state.get("draining")))
        state["autoscaler"] = scaler

        async def _start_autoscaler(app: web.Application) -> None:
            scaler.start(loop=asyncio.get_running_loop())

        app.on_startup.append(_start_autoscaler)
    r = app.router
    r.add_post("/v1/chat/completions", chat_completions)
    r.add_post("/v1/threads/{thread_id}/chat/completions",
               thread_chat_completions)
    r.add_post("/v1/agent/run", agent_run)
    r.add_post("/v1/threads/{thread_id}/agent/run", thread_agent_run)
    r.add_post("/v1/threads", create_thread)
    r.add_get("/v1/threads", list_threads)
    r.add_get("/v1/threads/{thread_id}", get_thread)
    r.add_get("/v1/threads/{thread_id}/messages", get_thread_messages)
    r.add_delete("/v1/threads/{thread_id}", delete_thread)
    r.add_delete("/v1/threads/{thread_id}/messages", delete_thread_messages)
    r.add_put("/v1/threads/{thread_id}/config", set_thread_config)
    r.add_get("/v1/profiles", list_profiles)
    r.add_post("/v1/profiles", create_profile)
    r.add_get("/v1/models", list_models)
    r.add_post("/v1/auth/signup", auth_signup)
    r.add_post("/v1/auth/login", auth_login)
    r.add_get("/health", health)
    r.add_get("/metrics", metrics)
    r.add_get("/admin/signals", admin_signals)
    r.add_get("/admin/autoscaler", admin_autoscaler)
    r.add_post("/admin/resize", resize_topology)
    r.add_post("/admin/drain/{replica}", admin_drain_replica)
    r.add_post("/debug/profile", capture_profile)
    r.add_get("/debug/traces", debug_traces)
    r.add_get("/debug/trace/{request_id}", debug_trace)
    r.add_get("/debug/flight/{replica}", debug_flight)
    r.add_get("/debug/compiles", debug_compiles)
    r.add_get("/debug/kernels", debug_kernels)
    r.add_get("/playground", playground)
    app.on_shutdown.append(_drain_on_shutdown)
    app.on_cleanup.append(_cleanup)
    return app


async def _drain_on_shutdown(app: web.Application) -> None:
    """Graceful drain: stop admitting, let in-flight streams finish.

    Runs while connections are still open (aiohttp on_shutdown): /health
    flips to 503 "draining" so load balancers pull the instance, the
    admission gate rejects serving requests with 503, and the engine gets
    drain_timeout_s to finish what it holds before the leftovers are
    cancelled (each still receives its terminal event)."""
    state = app[STATE_KEY]
    if state["draining"]:
        return
    state["draining"] = True
    drain = getattr(state["llm"], "drain", None)
    if drain is None:
        return
    timeout = state["cfg"].drain_timeout_s
    logger.info("draining: waiting up to %.1fs for in-flight requests",
                timeout)
    clean = await drain(timeout)
    logger.info("drain %s", "complete" if clean
                else "timed out (cancelled remaining requests)")


async def _cleanup(app: web.Application) -> None:
    state = app[STATE_KEY]
    scaler = state.get("autoscaler")
    if scaler is not None:
        # before the provider closes (a poll racing teardown would read a
        # dying engine; stop() also climbs off applied ladder rungs).  In
        # an executor: stop() joins a thread that may wait on a resize
        # coroutine scheduled onto this very loop.
        await asyncio.get_running_loop().run_in_executor(None, scaler.stop)
    await state["kafka"].cleanup()
    await state["db"].close()
    await state["llm"].aclose()
    # aiohttp keeps every Application that served a request in a
    # process-wide cache of middleware chains (keyed by handler and apps,
    # 1024 entries): clear it, or this app and the model its provider
    # holds outlive the server, and a process that runs servers in turn
    # keeps every model's weights and pool on the card
    cache = getattr(web_app, "_cached_build_middleware", None)
    if cache is not None:
        cache.cache_clear()


def cors_middleware(origins: str):
    @web.middleware
    async def mw(request: web.Request, handler):
        if request.method == "OPTIONS":
            resp: web.StreamResponse = web.Response(status=204)
        else:
            try:
                resp = await handler(request)
            except web.HTTPException as e:
                # error responses need CORS headers too, or browsers hide
                # the 400/404 body behind a CORS failure
                resp = e
        resp.headers["Access-Control-Allow-Origin"] = origins
        resp.headers["Access-Control-Allow-Methods"] = \
            "GET,POST,PUT,DELETE,OPTIONS"
        resp.headers["Access-Control-Allow-Headers"] = \
            "Content-Type,Authorization"
        if isinstance(resp, web.HTTPException):
            raise resp
        return resp

    return mw


# paths that never start a trace: health probes, the playground and the
# observability surface itself (an autoscaler's ~1 Hz signal scrape
# included) would churn the ring with noise
_TRACE_SKIP = ("/health", "/metrics", "/playground", "/debug",
               "/admin/signals", "/admin/autoscaler")


def _incoming_trace(request: web.Request):
    """Adopt an incoming trace identity: X-Request-Id (the id verbatim) or
    a W3C traceparent (00-<32hex trace>-<16hex span>-<flags>: the trace id
    is adopted and the caller's span becomes the root's parent)."""
    rid = request.headers.get("X-Request-Id", "").strip()
    if rid:
        return rid[:128], None
    tp = request.headers.get("traceparent", "").strip()
    parts = tp.split("-")
    if len(parts) == 4 and len(parts[1]) == 32 and len(parts[2]) == 16:
        return parts[1], parts[2]
    return None, None


def tracing_middleware():
    """Root-span middleware: every serving request gets (or adopts) a
    trace id, and the whole handler — auth, agent loop, SSE stream — runs
    inside its http.request span.  Sampled-out requests pass through
    untouched (tracing.start_trace returns None)."""

    @web.middleware
    async def mw(request: web.Request, handler):
        if request.method == "OPTIONS" or request.path.startswith(
                _TRACE_SKIP):
            return await handler(request)
        trace_id, parent_id = _incoming_trace(request)
        root = tracing.start_trace(
            request_id=trace_id,
            trace_id=trace_id,
            parent_id=parent_id,
            name="http.request",
            attrs={"method": request.method, "path": request.path},
        )
        if root is None:
            return await handler(request)
        ctx = tracing.current()
        status = None
        try:
            resp = await handler(request)
            status = resp.status
            if not resp.prepared and ctx is not None:
                # streamed responses are already on the wire; buffered
                # ones tell the client which id to ask /debug/trace for
                resp.headers["X-Request-Id"] = ctx.trace_id
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            tracing.finish_trace(root, status=status)

    return mw


def auth_middleware(api_token: Optional[str]):
    """Two bearer tiers: the static machine token (ServingConfig.api_token)
    and per-user session tokens from /v1/auth/login (`sess_...`, stored in
    the DB).  A valid session resolves request["user_id"] (thread
    ownership) and also satisfies the api_token gate.  An invalid or
    expired session answers 401 even on an open server: a client that
    presents credentials is never silently downgraded to anonymous.
    /health, /playground and /v1/auth/login stay open; signup runs under
    the api_token gate when one is set (an open signup would mint sessions
    that bypass the static token).  No api_token = anonymous access."""
    open_paths = ("/health", "/playground", "/v1/auth/login")

    @web.middleware
    async def mw(request: web.Request, handler):
        if request.path in open_paths:
            return await handler(request)
        supplied = request.headers.get("Authorization", "")
        if supplied.startswith("Bearer sess_"):
            token = supplied[len("Bearer "):]
            try:
                user_id = await _state(request)["db"].get_session_user(token)
            except NotImplementedError:
                user_id = None
            if user_id is None:
                return web.json_response(
                    {"error": {"message": "invalid or expired session",
                               "type": "authentication_error"}},
                    status=401)
            request["user_id"] = user_id
            return await handler(request)
        if api_token:
            # compare as bytes: compare_digest raises TypeError on
            # non-ASCII str inputs, which would turn a malformed
            # credential into a 500
            if not hmac.compare_digest(
                    supplied.encode("utf-8", "surrogateescape"),
                    f"Bearer {api_token}".encode()):
                return web.json_response(
                    {"error": {"message": "invalid or missing bearer token",
                               "type": "authentication_error"}},
                    status=401)
        return await handler(request)

    return mw


def _state(request: web.Request) -> dict:
    return request.app[STATE_KEY]


async def _parse(request: web.Request, model_cls):
    try:
        return model_cls.model_validate(await request.json())
    except ValidationError as e:
        raise web.HTTPBadRequest(text=e.json(),
                                 content_type="application/json")
    except Exception:
        raise web.HTTPBadRequest(text='{"error": "invalid JSON body"}',
                                 content_type="application/json")


def _admission_gate(request: web.Request) -> None:
    """Reject serving requests while draining (HTTP 503) or when the
    engine's waiting queue is full (429), each with Retry-After.  Thread
    CRUD and health stay open: only routes that submit engine work are
    gated."""
    state = _state(request)
    if state["draining"]:
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"error": {
                "message": "server is draining for shutdown",
                "type": "server_draining",
            }}),
            content_type="application/json",
            headers={"Retry-After": str(int(state["cfg"].drain_timeout_s))},
        )
    check = getattr(state["llm"], "admission_check", None)
    retry_after = check() if check is not None else None
    if retry_after is None:
        return
    # a gate-level 429 is a rejection and an SLO miss in the registry
    record = getattr(state["llm"], "record_rejection", None)
    if record is not None:
        record()
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
    body = await _parse(request, ChatCompletionRequest)
    events = _agent_events(request, body, thread_id=None)
    if body.stream:
        return await sse_response(request, events)
    return await _completion_response(events, body.model)


async def thread_chat_completions(request: web.Request
                                  ) -> web.StreamResponse:
    _admission_gate(request)
    thread_id = request.match_info["thread_id"]
    await _check_thread_owner(request, thread_id, create=True)
    body = await _parse(request, ChatCompletionRequest)
    events = _agent_events(request, body, thread_id=thread_id)
    if body.stream:
        return await sse_response(request, events)
    return await _completion_response(events, body.model)


async def agent_run(request: web.Request) -> web.StreamResponse:
    _admission_gate(request)
    body = await _parse(request, AgentRunRequest)
    return await sse_response(request,
                              _agent_events(request, body, thread_id=None))


async def thread_agent_run(request: web.Request) -> web.StreamResponse:
    _admission_gate(request)
    thread_id = request.match_info["thread_id"]
    await _check_thread_owner(request, thread_id, create=True)
    body = await _parse(request, AgentRunRequest)
    return await sse_response(
        request, _agent_events(request, body, thread_id=thread_id))


# ---------------------------------------------------------------------------
# threads and profiles
# ---------------------------------------------------------------------------


def _not_found(tid: str) -> web.HTTPNotFound:
    return web.HTTPNotFound(text=json.dumps(
        {"error": f"thread {tid} not found"}),
        content_type="application/json")


async def create_thread(request: web.Request) -> web.Response:
    db = _state(request)["db"]
    body = {}
    if request.can_read_body:
        try:
            body = await request.json()
        except Exception:
            body = {}
    # profile inheritance: a thread created with profile_id copies that
    # profile's config as its own.  Validated BEFORE the thread is created,
    # so a 400 leaves no orphan row.
    pid = body.get("profile_id")
    profile = None
    if pid:
        get_profile = getattr(db, "get_profile", None)
        profile = await get_profile(pid) if get_profile else None
        if profile is None:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": f"unknown profile {pid!r}"}),
                content_type="application/json")
    tid = await db.create_thread(thread_id=body.get("thread_id"),
                                 metadata=body.get("metadata"))
    if request.get("user_id") is not None:
        try:
            await db.set_thread_owner(tid, request["user_id"])
        except NotImplementedError:
            pass
    if profile is not None:
        await db.set_thread_config(tid, {**profile["config"],
                                         "profile_id": pid})
    return web.json_response(await db.get_thread_metadata(tid), status=201)


def _profiles_fn(request: web.Request, name: str):
    fn = getattr(_state(request)["db"], name, None)
    if fn is None:
        raise web.HTTPNotImplemented(
            text='{"error": "profiles unsupported by this DB backend"}',
            content_type="application/json")
    return fn


async def list_profiles(request: web.Request) -> web.Response:
    return web.json_response(
        {"profiles": await _profiles_fn(request, "list_profiles")()})


async def create_profile(request: web.Request) -> web.Response:
    fn = _profiles_fn(request, "create_profile")
    try:
        body = await request.json()
    except Exception:
        raise web.HTTPBadRequest(text='{"error": "invalid JSON body"}',
                                 content_type="application/json")
    name = body.get("name")
    if not name:
        raise web.HTTPBadRequest(text='{"error": "profile name required"}',
                                 content_type="application/json")
    profile = await fn(name, config=body.get("config") or {})
    return web.json_response(profile, status=201)


async def list_threads(request: web.Request) -> web.Response:
    """A session user sees their own threads; anonymous requests see only
    unowned ones (all, on a DB backend without a user store)."""
    db = _state(request)["db"]
    user = request.get("user_id")
    if user is not None:
        return web.json_response(
            {"threads": await db.list_threads_for_user(user)})
    try:
        threads = await db.list_threads_unowned()
    except NotImplementedError:
        threads = await db.list_threads()
    return web.json_response({"threads": threads})


async def _check_thread_owner(request: web.Request, tid: str,
                              create: bool = False) -> None:
    """Enforce, or on a write path establish, thread ownership.  Another
    user's thread answers 404 (existence is not leaked).  A session user
    writing to an unowned or new thread claims it (create=True: the run
    routes); a read never transfers ownership away from the anonymous
    client that created the thread.  A DB backend without a user store
    skips enforcement."""
    db = _state(request)["db"]
    user = request.get("user_id")
    try:
        owner = await db.get_thread_owner(tid)
    except NotImplementedError:
        return
    if owner is not None and owner != user:
        raise _not_found(tid)
    if create and user is not None and owner is None:
        if not await db.thread_exists(tid):
            await db.create_thread(tid)
        await db.set_thread_owner(tid, user)


async def _require_thread(request: web.Request) -> str:
    tid = request.match_info["thread_id"]
    if not await _state(request)["db"].thread_exists(tid):
        raise _not_found(tid)
    await _check_thread_owner(request, tid)
    return tid


async def get_thread(request: web.Request) -> web.Response:
    tid = await _require_thread(request)
    return web.json_response(
        await _state(request)["db"].get_thread_metadata(tid))


async def get_thread_messages(request: web.Request) -> web.Response:
    tid = await _require_thread(request)
    msgs = await _state(request)["db"].get_thread_messages(tid)
    return web.json_response({"thread_id": tid, "messages": msgs})


async def delete_thread(request: web.Request) -> web.Response:
    tid = await _require_thread(request)
    await _state(request)["db"].delete_thread(tid)
    return web.json_response({"deleted": tid})


async def delete_thread_messages(request: web.Request) -> web.Response:
    tid = await _require_thread(request)
    await _state(request)["db"].delete_thread_messages(tid)
    return web.json_response({"cleared": tid})


async def set_thread_config(request: web.Request) -> web.Response:
    tid = await _require_thread(request)
    cfg = await request.json()
    await _state(request)["db"].set_thread_config(tid, cfg)
    return web.json_response({"thread_id": tid, "config": cfg})


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


def _no_user_store() -> web.HTTPNotImplemented:
    return web.HTTPNotImplemented(
        text='{"error": "this DB backend has no user store"}',
        content_type="application/json")


async def _session_response(db, user_id: str, email: str) -> web.Response:
    from .auth import new_session_token, session_expiry

    token = new_session_token()
    await db.create_session(user_id, token, session_expiry())
    return web.json_response({"token": token, "user_id": user_id,
                              "email": email})


async def _auth_body(request: web.Request) -> tuple:
    try:
        body = await request.json()
        assert isinstance(body, dict)
    except Exception:
        raise web.HTTPBadRequest(text='{"error": "invalid JSON body"}',
                                 content_type="application/json")
    return ((body.get("email") or "").strip().lower(),
            body.get("password") or "")


async def auth_signup(request: web.Request) -> web.Response:
    """Create a user and open a session."""
    from .auth import hash_password, new_salt

    db = _state(request)["db"]
    email, password = await _auth_body(request)
    if "@" not in email or len(password) < 6:
        raise web.HTTPBadRequest(
            text='{"error": "need a valid email and a password of 6+ chars"}',
            content_type="application/json")
    salt = new_salt()
    # scrypt is ~50 ms of CPU: off the event loop, or every in-flight SSE
    # stream hiccups for its duration
    pw_hash = await asyncio.to_thread(hash_password, password, salt)
    try:
        user_id = await db.create_user(email, pw_hash, salt)
    except ValueError:
        return web.json_response(
            {"error": {"message": "email already registered",
                       "type": "invalid_request_error"}}, status=409)
    except NotImplementedError:
        raise _no_user_store()
    return await _session_response(db, user_id, email)


async def auth_login(request: web.Request) -> web.Response:
    from .auth import verify_password

    db = _state(request)["db"]
    email, password = await _auth_body(request)
    try:
        user = await db.get_user_by_email(email)
    except NotImplementedError:
        raise _no_user_store()
    if user is None or not await asyncio.to_thread(
            verify_password, password, user["salt"], user["password_hash"]):
        return web.json_response(
            {"error": {"message": "invalid email or password",
                       "type": "authentication_error"}}, status=401)
    return await _session_response(db, user["user_id"], user["email"])


# ---------------------------------------------------------------------------
# models, health, debug, playground
# ---------------------------------------------------------------------------


async def list_models(request: web.Request) -> web.Response:
    llm = _state(request)["llm"]
    return web.json_response({"object": "list",
                              "data": llm.get_available_models()})


async def health(request: web.Request) -> web.Response:
    """Liveness and engine stats; "draining" with 503 pulls the instance
    from load-balancer rotation while in-flight streams finish."""
    state = _state(request)
    draining = state["draining"]
    engine = getattr(state["llm"], "engine", None)
    # a tensor-parallel engine whose rank group broke cannot serve again
    broken = getattr(engine, "group_broken", None)
    payload: Dict[str, Any] = {
        "status": ("draining" if draining
                   else "unhealthy" if broken else "ok"),
        "kafka_initialized": state["kafka"]._initialized,
    }
    if engine is not None:
        # a router exposes .engines; one engine is its own replica set
        replicas = getattr(engine, "engines", [engine])
        payload["engine"] = {
            "device": str(engine.device),
            "active": engine.num_active,
            "waiting": len(engine.waiting),
            "free_pages": sum(e.pool.free_pages for e in replicas),
            "total_pages": sum(e.pool.num_pages for e in replicas),
        }
        if len(replicas) > 1:
            payload["engine"]["dp"] = len(replicas)
        health_records = getattr(engine, "health", None)
        if health_records:
            # which replicas are quarantined, at a glance
            payload["engine"]["replicas"] = [h.state for h in health_records]
        rank_mesh = getattr(engine, "mesh", None)
        if rank_mesh is not None:
            payload["engine"]["tp"] = rank_mesh.tp
            payload["engine"]["tq"] = rank_mesh.tq
            if rank_mesh.ep > 1:
                payload["engine"]["ep"] = rank_mesh.ep
        if broken:
            payload["engine"]["error"] = broken
    return web.json_response(payload,
                             status=503 if draining or broken else 200)


async def debug_traces(request: web.Request) -> web.Response:
    """Recent-traces index (newest first): ids, durations, span names —
    enough to find the id to pull from /debug/trace/{request_id}."""
    return web.json_response({
        "traces": tracing.recent_traces(),
        "counters": tracing.counters(),
        "sample": tracing.sample_rate(),
    })


async def debug_trace(request: web.Request) -> web.Response:
    """One request's span tree as Chrome trace-event JSON (load it in
    Perfetto or chrome://tracing), keyed by the trace id: the
    X-Request-Id the request carried or was assigned."""
    data = tracing.chrome_trace(request.match_info["request_id"])
    if data is None:
        raise web.HTTPNotFound(
            text=json.dumps({"error": "unknown trace (evicted from the "
                             "ring, or the request was sampled out)"}),
            content_type="application/json")
    return web.json_response(data)


async def metrics(request: web.Request) -> web.Response:
    """Serving counters: the engine's metrics registry snapshot (TTFT /
    TPOT histograms, throughput, SLO attainment and goodput, MFU and
    bandwidth utilization per dispatch kind, the flight recorder's ring
    state, memory), with the process-wide sections merged in: sandbox
    supervision, tracing (and the slow-request count) and the compile
    observatory.  `?format=prometheus` renders the same snapshot as
    Prometheus text."""
    llm = _state(request)["llm"]
    engine = getattr(llm, "engine", None)
    if engine is None:
        return web.json_response({"error": "no local engine"}, status=404)
    snap = engine.metrics.snapshot(engine)
    from ..runtime import compile_log
    from ..sandbox.process import supervisor_snapshot

    snap["sandbox"] = supervisor_snapshot()
    snap["tracing"] = tracing.counters()
    if isinstance(snap.get("requests"), dict):
        snap["requests"]["slow"] = tracing.slow_count()
    # the autoscaler's counters (one controller per process; absent when
    # KAFKA_TORCH_AUTOSCALE is off)
    scaler = _state(request).get("autoscaler")
    if scaler is not None:
        snap["autoscaler"] = scaler.metrics_section()
    obs = compile_log.get()
    if obs is not None:
        snap["compiles"] = obs.metrics_section()
    if request.query.get("format") == "prometheus":
        from .prometheus import render_prometheus

        return web.Response(
            text=render_prometheus(snap),
            headers={"Content-Type":
                     "text/plain; version=0.0.4; charset=utf-8"})
    return web.json_response(snap)


async def admin_autoscaler(request: web.Request) -> web.Response:
    """The autoscaler's bounded decision log and live state: mode,
    config, degradation-ladder rung, cooldowns, and every recorded
    decision (cause, condensed inputs, action, vetoes, outcome;
    consecutive identical holds collapse into one counted entry).
    Read-only, the token policy of /admin/signals.  404 when
    KAFKA_TORCH_AUTOSCALE is off."""
    scaler = _state(request).get("autoscaler")
    if scaler is None:
        return web.json_response(
            {"error": "autoscaler not running (KAFKA_TORCH_AUTOSCALE is "
                      "off, or this deployment emits no signals)"},
            status=404)
    return web.json_response(scaler.snapshot())


async def resize_topology(request: web.Request) -> web.Response:
    """Rebuild the DP replica set at a new dp count while queued
    requests survive: body {"dp": N, optional "drain_timeout_s": S,
    optional "roles": "prefill:P,decode:D"}.  Started requests get the
    drain budget; leftovers are cancelled with terminal events
    ("clean": false).  "roles" re-shapes the pools in the same rebuild
    ("" or null dissolves them); absent keeps the current spec.
    Operator-destructive, so it refuses outright without a configured
    KAFKA_TORCH_API_TOKEN."""
    if not _state(request)["cfg"].api_token:
        return web.json_response(
            {"error": "admin endpoints require KAFKA_TORCH_API_TOKEN to "
                      "be configured"},
            status=403)
    llm = _state(request)["llm"]
    resize = getattr(llm, "resize_dp", None)
    if resize is None or not hasattr(getattr(llm, "engine", None),
                                     "rebuild"):
        return web.json_response(
            {"error": "this deployment has no resizable DP topology"},
            status=501)
    try:
        body = await request.json()
        dp = int(body["dp"])
        drain_timeout_s = float(body.get(
            "drain_timeout_s", _state(request)["cfg"].drain_timeout_s))
        roles_given = "roles" in body
        roles = body.get("roles")
        if roles_given and roles is not None and not isinstance(roles, str):
            raise TypeError("roles must be a string or null")
    except Exception:
        return web.json_response(
            {"error": 'body must be {"dp": N[, "drain_timeout_s": S]'
                      '[, "roles": "prefill:P,decode:D"|null]}'},
            status=400)
    if dp < 1:
        return web.json_response({"error": "dp must be >= 1"}, status=400)
    kwargs: Dict[str, Any] = {"drain_timeout_s": drain_timeout_s}
    if roles_given:
        kwargs["roles"] = roles
    try:
        clean = await resize(dp, **kwargs)
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=400)
    except RuntimeError as e:
        return web.json_response({"error": str(e)}, status=409)
    out: Dict[str, Any] = {"dp": dp, "clean": clean}
    if roles_given:
        out["roles"] = roles or None
    return web.json_response(out)


async def admin_drain_replica(request: web.Request) -> web.Response:
    """Flush one replica's warm KV state into the shared object store:
    every cached radix run is archived content-addressed and every
    thread's sleep manifest written, so the replica can be removed (a
    resize to a smaller dp) without discarding any warm conversation —
    dormant threads wake on the survivors with cache_source=
    "object_tier" instead of re-prefilling.  Non-destructive.  Requires
    the object tier (KAFKA_TORCH_KV_OBJECT_DIR) and a configured
    KAFKA_TORCH_API_TOKEN (it parks the scheduler for the flush)."""
    if not _state(request)["cfg"].api_token:
        return web.json_response(
            {"error": "admin endpoints require KAFKA_TORCH_API_TOKEN to "
                      "be configured"},
            status=403)
    llm = _state(request)["llm"]
    drain = getattr(llm, "drain_replica", None)
    if drain is None or getattr(llm, "engine", None) is None:
        return web.json_response(
            {"error": "this deployment has no drainable engine"},
            status=501)
    try:
        idx = int(request.match_info["replica"])
    except ValueError:
        return web.json_response(
            {"error": "replica must be an integer index"}, status=400)
    try:
        stats = await drain(idx)
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=400)
    except RuntimeError as e:
        return web.json_response({"error": str(e)}, status=409)
    if not stats.get("enabled", True):
        return web.json_response(
            {"error": "object tier not configured "
                      "(set KAFKA_TORCH_KV_OBJECT_DIR)", **stats},
            status=409)
    return web.json_response(stats)


async def admin_signals(request: web.Request) -> web.Response:
    """The autoscaler signal feed: one coherent JSON snapshot of queue
    depth and trend, batch occupancy, SLO window attainment, goodput,
    per-kind utilization, anomalies, compiles and memory (the provider's
    `signals`).  Read-only; honors the bearer gate when one is set."""
    state = _state(request)
    llm = state["llm"]
    signals = getattr(llm, "signals", None)
    if signals is None or getattr(llm, "engine", None) is None:
        return web.json_response(
            {"error": "no local engine (this deployment emits no "
                      "autoscaler signals)"}, status=404)
    payload = signals()
    payload["draining"] = bool(state.get("draining"))
    payload["admission"] = {"max_queue_depth": state["cfg"].max_queue_depth}
    return web.json_response(payload)


async def debug_flight(request: web.Request) -> web.Response:
    """One replica's live flight-recorder ring: the per-scheduler-
    iteration decision log, measured dispatch timing and the anomaly
    detector state.  Postmortem dumps of the same shape land next to the
    persisted traces when a step fails."""
    llm = _state(request)["llm"]
    engine = getattr(llm, "engine", None)
    if engine is None:
        return web.json_response({"error": "no local engine"}, status=404)
    replicas = getattr(engine, "engines", [engine])
    try:
        idx = int(request.match_info["replica"])
    except ValueError:
        return web.json_response(
            {"error": "replica must be an integer index"}, status=400)
    if not 0 <= idx < len(replicas):
        return web.json_response(
            {"error": f"replica {idx} out of range (dp={len(replicas)})"},
            status=404)
    flight = replicas[idx].flight
    if flight is None:
        return web.json_response(
            {"error": "flight recorder disabled "
                      "(KAFKA_TORCH_FLIGHT_RING=0)"}, status=404)
    payload = flight.snapshot()
    payload["replica"] = idx
    payload["dp"] = len(replicas)
    return web.json_response(payload)


async def debug_compiles(request: web.Request) -> web.Response:
    """The compile observatory's bounded ring: every CUDA-graph capture
    and nvcc build this process made — label, wall seconds, cache
    disposition and the serving phase it happened in (boot / warmup /
    first_traffic / rebuild) — plus the storm detector and totals."""
    from ..runtime import compile_log

    obs = compile_log.get()
    if obs is None:
        return web.json_response(
            {"error": "compile observatory disabled "
                      "(KAFKA_TORCH_COMPILE_RING=0)"}, status=404)
    return web.json_response(obs.snapshot())


async def debug_kernels(request: web.Request) -> web.Response:
    """Sampled per-kernel device timing: the top-K kernels by device
    time, grouped by the dispatch kinds active in each sampled window,
    from KAFKA_TORCH_PROFILE_SAMPLE=N every-Nth-step profiles.  404 when
    sampling is off."""
    llm = _state(request)["llm"]
    engine = getattr(llm, "engine", None)
    if engine is None:
        return web.json_response({"error": "no local engine"}, status=404)
    try:
        top_k = int(request.query.get("top_k", "20"))
    except ValueError:
        return web.json_response(
            {"error": "top_k must be an integer"}, status=400)
    # each replica owns its sampler: replica 0's table, and every
    # replica's when there are several
    samplers = [(i, e.kernel_sampler) for i, e in enumerate(
        getattr(engine, "engines", [engine])) if e.kernel_sampler is not None]
    if not samplers:
        return web.json_response(
            {"error": "kernel sampling disabled "
                      "(set KAFKA_TORCH_PROFILE_SAMPLE=N)"}, status=404)
    payload = samplers[0][1].snapshot(top_k=top_k)
    if len(samplers) > 1:
        payload["replicas"] = [dict(sm.snapshot(top_k=top_k), replica=i)
                               for i, sm in samplers]
    return web.json_response(payload)


_PROFILE_BUSY = False
# server-chosen, never client-chosen
_PROFILE_DIR = os.path.join(tempfile.gettempdir(), "kafka_torch_trace")


def _flight_seqs(llm) -> Optional[List[Dict[str, Any]]]:
    """Per-replica flight-recorder sequence cursors (None = no engine or
    recorder off everywhere)."""
    engine = getattr(llm, "engine", None)
    if engine is None:
        return None
    out = [{"replica": i, "seq": e.flight.next_seq}
           for i, e in enumerate(getattr(engine, "engines", [engine]))
           if e.flight is not None]
    return out or None


async def capture_profile(request: web.Request) -> web.Response:
    """Capture a torch.profiler window for offline analysis (Chrome
    trace JSON, for Perfetto).  Body: {"seconds": 2}.  The trace covers
    whatever the engine executes during the window (the card's kernels
    on CUDA) and lands under a server-chosen directory.  Gated behind
    KAFKA_TORCH_PROFILING=1 (traces can carry workload detail); with an
    API token configured it wants that machine token, not a user
    session; one capture at a time, and never while the kernel sampler
    holds the profiler (409).  The response carries the flight-recorder
    window the capture covers (per replica [start_seq, end_seq) and wall
    timestamps), so the trace correlates with /debug/flight."""
    import time as _time

    from ..runtime import kernel_profiler

    if os.environ.get("KAFKA_TORCH_PROFILING", "0") not in ("1", "true"):
        return web.json_response(
            {"error": "profiling disabled (set KAFKA_TORCH_PROFILING=1)"},
            status=403)
    cfg = _state(request)["cfg"]
    if cfg.api_token:
        supplied = request.headers.get("Authorization", "")
        if not hmac.compare_digest(
                supplied.encode("utf-8", "surrogateescape"),
                f"Bearer {cfg.api_token}".encode()):
            return web.json_response(
                {"error": {"message": "profile capture requires the "
                           "configured API token",
                           "type": "authentication_error"}},
                status=401)
    global _PROFILE_BUSY
    # check-and-set with no await in between (the event loop is one
    # thread): concurrent requests cannot race past the guard
    if _PROFILE_BUSY:
        return web.json_response(
            {"error": "a profile capture is already running"}, status=409)
    _PROFILE_BUSY = True
    try:
        try:
            body = await request.json()
        except Exception:
            body = {}
        try:
            seconds = float(body.get("seconds", 2.0))
        except (TypeError, ValueError):
            return web.json_response(
                {"error": "'seconds' must be a number"}, status=400)
        if not (0.1 <= seconds <= 30.0):
            return web.json_response(
                {"error": "'seconds' must be in [0.1, 30]"}, status=400)
        llm = _state(request)["llm"]
        engine = getattr(llm, "engine", None)
        device_type = engine.device.type if engine is not None else "cpu"
        start_seqs = _flight_seqs(llm)
        if not kernel_profiler.try_acquire_trace():
            return web.json_response(
                {"error": "device tracing busy (kernel sampler window "
                          "open, or another capture running)"},
                status=409)
        t_start = _time.time()
        path = os.path.join(_PROFILE_DIR,
                            f"profile_{int(t_start * 1e3)}.trace.json")
        try:
            os.makedirs(_PROFILE_DIR, exist_ok=True)
            prof = kernel_profiler.open_profiler(device_type)
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.stop()
            prof.export_chrome_trace(path)
        finally:
            kernel_profiler.release_trace()
        t_end = _time.time()
        end_seqs = _flight_seqs(llm)
    finally:
        _PROFILE_BUSY = False
    flight_window = None
    if start_seqs is not None and end_seqs is not None:
        ends = {e["replica"]: e["seq"] for e in end_seqs}
        flight_window = {
            "t_start": round(t_start, 4),
            "t_end": round(t_end, 4),
            "replicas": [
                {"replica": s["replica"], "start_seq": s["seq"],
                 "end_seq": ends.get(s["replica"], s["seq"])}
                for s in start_seqs
            ],
        }
    return web.json_response({
        "trace_dir": _PROFILE_DIR,
        "seconds": seconds,
        # correlate the trace with scheduler decisions: /debug/flight
        # records with start_seq <= seq < end_seq (or t in [t_start,
        # t_end])
        "flight_window": flight_window,
    })


async def playground(request: web.Request) -> web.Response:
    """The in-tree chat client: one static file consuming the SSE
    protocol with the reconstruction rules of core/sse_client.py."""
    return web.FileResponse(
        os.path.join(os.path.dirname(__file__), "playground.html"))


def run_server(cfg: Optional[ServingConfig] = None,
               device: DeviceLike = None) -> None:
    cfg = cfg or ServingConfig.from_env()
    from ..logs import setup_logging

    # KAFKA_TORCH_LOG_FORMAT=json (or cfg.log_format): every record
    # carries trace_id / span_id / thread_id
    setup_logging(cfg.log_format)
    web.run_app(create_app(cfg, device=device), host=cfg.host, port=cfg.port)
