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

    @classmethod
    def from_env(cls, **overrides) -> "ServingConfig":
        env = os.environ

        def get(name: str, default, cast=str):
            raw = env.get(f"KAFKA_TORCH_{name}")
            return cast(raw) if raw is not None else default

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
        )
        return dataclasses.replace(cfg, **overrides)
