"""Typed serving configuration (main-path fields of
kafka_tpu/server/config.py): one dataclass with KAFKA_TORCH_* environment
overrides, covering the engine shape, model selection, telemetry and
server knobs."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class ServingConfig:
    # model
    model_name: str = "llama-3.2-1b"
    checkpoint_dir: Optional[str] = None  # HF safetensors dir; None=random
    dtype: str = "bfloat16"
    seed: int = 0  # random-init weights when no checkpoint is given
    # weight-only quantization (KAFKA_TORCH_QUANTIZE): "" (the model
    # dtype) or "int8" (models/quant.py, per-output-channel scales) —
    # half the weight bytes in memory
    quantize: str = ""
    # KV-cache quantization (KAFKA_TORCH_KV_QUANTIZE): "" or "int8"
    # (per-slot scales, runtime/kv_cache.py) — half the KV window's bytes;
    # decode runs the int8 paged decode kernel
    kv_quantize: str = ""
    # engine shape
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 512
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    max_new_tokens_default: int = 1024
    # fused decode depth (EngineConfig.multi_step, KAFKA_TORCH_MULTI_STEP):
    # steps per dispatch — one captured CUDA graph replay — when the batch
    # is busy; 1 disables fusion
    multi_step: int = 16
    # request lifecycle: first-token and total deadlines (None = off), the
    # bounded waiting queue (429 + Retry-After past it; 0 = unbounded),
    # and the graceful-shutdown budget: /health flips to "draining" (503),
    # admission stops, and in-flight streams get drain_timeout_s to finish
    # before they are cancelled
    max_ttft_s: Optional[float] = None
    request_timeout_s: Optional[float] = None
    max_queue_depth: int = 256
    drain_timeout_s: float = 30.0
    # observability (tracing.py, logs.py):
    #   trace_sample — fraction of requests traced end to end (span tree at
    #       GET /debug/trace/{id}); 1.0 traces everything, 0 disables
    #   trace_ring — how many finished traces the in-memory ring retains
    #   slow_ttft_ms / slow_total_ms — a request past either threshold
    #       logs ONE structured line with its span breakdown (None = off)
    #   log_format — "json" stamps every log record with trace_id /
    #       span_id / thread_id; "text" keeps stdlib formatting
    trace_sample: float = 1.0
    trace_ring: int = 256
    slow_ttft_ms: Optional[float] = None
    slow_total_ms: Optional[float] = None
    log_format: str = "text"
    # Scheduler flight recorder (runtime/flight_recorder.py): per-engine
    # ring of this many per-scheduler-iteration records (decision log,
    # measured dispatch timing, anomaly detectors, postmortem capture,
    # GET /debug/flight/{replica}).  0 disables it; None defers to
    # KAFKA_TORCH_FLIGHT_RING (default 256).
    flight_ring: Optional[int] = None
    # SLO targets (runtime/metrics.py): every request is classified
    # MET/MISSED at finalize against these; /metrics exports attainment
    # (total/1m/5m windows) and goodput, /admin/signals feeds them to an
    # autoscaler.
    #   slo_ttft_ms — time-to-first-token target (default 200; 0 disables)
    #   slo_tpot_ms — per-output-token target (default 0 = disabled)
    # None defers to KAFKA_TORCH_SLO_TTFT_MS / KAFKA_TORCH_SLO_TPOT_MS.
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    # server
    host: str = "0.0.0.0"
    port: int = 8000
    # optional bearer-token auth for /v1/* (None = open, the dev default);
    # per-user session tokens from /v1/auth/login satisfy it too
    api_token: Optional[str] = None
    db_path: str = "data/threads.db"
    # a sandbox server (python -m kafka_tpu_torch.sandbox.server) whose
    # shell and notebook tools join the built-in tools (None = none)
    local_sandbox_url: Optional[str] = None
    cors_origins: str = "*"
    # test/dev: tiny random model instead of a real checkpoint
    tiny_model: bool = False
    # static system prompt prepended to every turn (None = none)
    system_prompt: Optional[str] = None
    # run one short generation at boot so the CUDA kernels are built and
    # the first request pays serving latency, not nvcc
    warmup: bool = True
    # Radix prefix-cache page budget (KAFKA_TORCH_PREFIX_CACHE_PAGES): how
    # many KV pool pages the cross-thread prefix cache may retain.  None =
    # bounded only by pool pressure (the engine reclaims cache pages
    # before it ever preempts a live request); 0 disables the cache.
    prefix_cache_pages: Optional[int] = None
    # Draft-free speculative decoding (KAFKA_TORCH_SPECULATIVE_K): up to K
    # n-gram prompt-lookup candidates per lane verified in one [B, K+1]
    # forward (the paged verify kernel).  0 (default) disables it.  Best
    # on repetition-heavy agent traffic (tool echoes, JSON, code spans).
    speculative_k: int = 0
    # Tiered KV cache (KAFKA_TORCH_KV_HOST_TIER_MB): host-RAM page tier
    # under the pool, in MiB.  Prefix-cache eviction demotes page runs
    # host-side; a returning thread's lookup promotes them back instead
    # of re-prefilling.  0 (default) disables the tier.  The memory
    # planner charges it as host RAM.
    kv_host_tier_mb: int = 0
    # Disk spill dir below the host tier (KAFKA_TORCH_KV_DISK_TIER_DIR):
    # host-budget overflow spills runs here (second-chance LRU).  None =
    # drop on overflow.
    kv_disk_tier_dir: Optional[str] = None
    # Object-store KV tier (KAFKA_TORCH_KV_OBJECT_DIR): a SHARED directory
    # (or an http(s):// S3-shaped endpoint) below host+disk that makes
    # thread state portable — runs are archived content-addressed and
    # per-thread sleep manifests let a dormant thread wake on a fresh
    # engine with cache_source="object_tier".  POST /admin/drain/0
    # flushes the engine's warm state there.  None (default) disables.
    # The store sits behind the StoreGuard, tuned by
    #   KAFKA_TORCH_KV_OBJECT_TIMEOUT_S          per-op deadline (0 = off)
    #   KAFKA_TORCH_KV_OBJECT_RETRIES            retry budget (default 2)
    #   KAFKA_TORCH_KV_OBJECT_BACKOFF_S          base backoff (default .05)
    #   KAFKA_TORCH_KV_OBJECT_BREAKER_FAILURES   breaker trip (default 5)
    #   KAFKA_TORCH_KV_OBJECT_BREAKER_OPEN_S     open window (default 10)
    #   KAFKA_TORCH_KV_OBJECT_SCRUB_S            in-process janitor (0 = off)
    # and KAFKA_TORCH_WAKE_PREFETCH_MB (default 0 = off) stages a waking
    # thread's object GETs in parallel.
    kv_object_dir: Optional[str] = None
    # Byte budget (MiB) on the object-store references the engine holds;
    # 0 = unbounded.  KAFKA_TORCH_KV_OBJECT_MB.
    kv_object_mb: int = 0
    # Tensor parallelism (parallel/, KAFKA_TORCH_TP_SIZE or
    # KAFKA_TORCH_TP): one engine over tp_size cards, rank r on cuda:r,
    # spawned as worker processes; the degree splits into (tp, tq) by
    # resolve_tensor_axes.  Random weights are drawn per rank
    # (RandomWeights): no full copy of the model exists anywhere.  One
    # card per rank; dp x tp is not ported (ROADMAP A9).
    tp_size: int = 1
    # Expert parallelism (KAFKA_TORCH_EP_SIZE or KAFKA_TORCH_EP): a MoE
    # model's experts shard over ep_size ranks, attention and the KV pool
    # replicated over them; composes with tp_size (tp_size * ep_size
    # cards, one per rank).  A dense model at ep_size > 1 is refused.
    ep_size: int = 1
    # Data-parallel replicas (runtime/dp_router.py): dp independent
    # engines with thread-affinity routing (KAFKA_TORCH_DP_SIZE, or
    # KAFKA_TORCH_DP).  1 = one engine, no router.
    dp_size: int = 1
    # The replica slots (KAFKA_TORCH_REPLICA_DEVICES, comma-separated,
    # e.g. "cuda:0,cuda:0" or "cpu,cpu,cpu,cpu"): one device per slot, a
    # device may repeat (replicas sharing a card share its weights).  None
    # = one slot per visible card.  The counterpart of the virtual device
    # budget the reference's tests set through XLA flags; it only says
    # where replicas live and adds no behaviour of its own.
    replica_devices: Optional[str] = None
    # Disaggregated prefill/decode (KAFKA_TORCH_DP_ROLES):
    # "prefill:P,decode:D" splits the dp fleet into role pools — long
    # prefills run on the prefill pool and their KV pages ship to a
    # decode-pool replica at first-token time.  P + D must equal dp_size.
    # None (default) = colocated.
    dp_roles: Optional[str] = None
    # prompts whose uncached prefill span is below this many tokens
    # prefill in place on the decode pool
    # (KAFKA_TORCH_DISAGG_MIN_PREFILL_TOKENS)
    disagg_min_prefill_tokens: int = 512
    # replica supervision: consecutive step failures before a replica is
    # circuit-broken out of the router, and quarantine trips before its
    # engine is rebuilt instead of re-admitted (0 disables the rebuild)
    replica_quarantine_threshold: int = 3
    replica_rebuild_threshold: int = 3
    # Autoscaler control loop (KAFKA_TORCH_AUTOSCALE, runtime/
    # autoscaler.py): "off" (default — no controller built), "recommend"
    # (the full decision loop and GET /admin/autoscaler log, no action),
    # or "act" (scale out / in through /admin/resize's seam, the
    # degradation ladder under overload).  Cadence, bands, cooldowns and
    # dp bounds: KAFKA_TORCH_AUTOSCALE_*.
    autoscale: str = "off"
    # Agent tool-call gaps are configured by the environment, read by
    # EngineConfig: KAFKA_TORCH_AGENT_DEMOTE = "" (off, default) | "host" |
    # "object" demotes a thread's KV down the tier ladder once it leaves
    # for a tool call and KAFKA_TORCH_AGENT_LINGER_MS (default 250) pass
    # without the tool returning.

    @classmethod
    def from_env(cls, **overrides) -> "ServingConfig":
        env = os.environ

        def get(name: str, default, cast=str):
            raw = env.get(f"KAFKA_TORCH_{name}")
            return cast(raw) if raw is not None else default

        def get_axis(name: str, default: int) -> int:
            # both spellings: KAFKA_TORCH_DP_SIZE=2 and KAFKA_TORCH_DP=2
            raw = env.get(f"KAFKA_TORCH_{name}_SIZE",
                          env.get(f"KAFKA_TORCH_{name}"))
            return int(raw) if raw is not None else default

        cfg = cls(
            model_name=get("MODEL", cls.model_name),
            checkpoint_dir=get("CHECKPOINT_DIR", None),
            dtype=get("DTYPE", cls.dtype),
            seed=get("SEED", cls.seed, int),
            quantize=get("QUANTIZE", cls.quantize),
            kv_quantize=get("KV_QUANTIZE", cls.kv_quantize),
            max_batch=get("MAX_BATCH", cls.max_batch, int),
            num_pages=get("NUM_PAGES", cls.num_pages, int),
            max_pages_per_seq=get("MAX_PAGES_PER_SEQ", cls.max_pages_per_seq,
                                  int),
            multi_step=get("MULTI_STEP", cls.multi_step, int),
            max_ttft_s=get("MAX_TTFT_S", None, float),
            request_timeout_s=get("REQUEST_TIMEOUT_S", None, float),
            max_queue_depth=get("MAX_QUEUE_DEPTH", cls.max_queue_depth, int),
            drain_timeout_s=get("DRAIN_TIMEOUT_S", cls.drain_timeout_s,
                                float),
            trace_sample=get("TRACE_SAMPLE", cls.trace_sample, float),
            trace_ring=get("TRACE_RING", cls.trace_ring, int),
            slow_ttft_ms=get("SLOW_TTFT_MS", None, float),
            slow_total_ms=get("SLOW_TOTAL_MS", None, float),
            log_format=get("LOG_FORMAT", cls.log_format),
            # clamp negatives to 0 = disabled
            flight_ring=get("FLIGHT_RING", None, lambda v: max(0, int(v))),
            slo_ttft_ms=get("SLO_TTFT_MS", None, float),
            slo_tpot_ms=get("SLO_TPOT_MS", None, float),
            host=get("HOST", cls.host),
            port=get("PORT", cls.port, int),
            api_token=get("API_TOKEN", None),
            db_path=get("DB_PATH", cls.db_path),
            local_sandbox_url=get("SANDBOX_URL", None),
            tiny_model=get("TINY_MODEL", "0") in ("1", "true", "True"),
            system_prompt=get("SYSTEM_PROMPT", None),
            warmup=get("WARMUP", "1") not in ("0", "false", "False"),
            prefix_cache_pages=get("PREFIX_CACHE_PAGES", None, int),
            speculative_k=get("SPECULATIVE_K", cls.speculative_k, int),
            # clamp negatives to 0 = disabled / unbounded
            kv_host_tier_mb=get("KV_HOST_TIER_MB", cls.kv_host_tier_mb,
                                lambda v: max(0, int(v))),
            kv_disk_tier_dir=get("KV_DISK_TIER_DIR", None),
            kv_object_dir=get("KV_OBJECT_DIR", None),
            kv_object_mb=get("KV_OBJECT_MB", cls.kv_object_mb,
                             lambda v: max(0, int(v))),
            tp_size=get_axis("TP", cls.tp_size),
            ep_size=get_axis("EP", cls.ep_size),
            dp_size=get_axis("DP", cls.dp_size),
            replica_devices=get("REPLICA_DEVICES", None),
            dp_roles=get("DP_ROLES", None),
            disagg_min_prefill_tokens=get(
                "DISAGG_MIN_PREFILL_TOKENS", cls.disagg_min_prefill_tokens,
                lambda v: max(1, int(v))),
            replica_quarantine_threshold=get(
                "REPLICA_QUARANTINE_THRESHOLD",
                cls.replica_quarantine_threshold, int),
            # clamp negatives to 0 = disabled
            replica_rebuild_threshold=get(
                "REPLICA_REBUILD_THRESHOLD", cls.replica_rebuild_threshold,
                lambda v: max(0, int(v))),
            autoscale=get("AUTOSCALE", cls.autoscale),
        )
        return dataclasses.replace(cfg, **overrides)
