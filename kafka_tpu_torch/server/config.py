"""Typed serving configuration (main-path fields of
kafka_tpu/server/config.py): one dataclass with KAFKA_TORCH_* environment
overrides, covering the engine shape, model selection and server knobs."""

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
    # bounded waiting queue (429 + Retry-After past it; 0 = unbounded)
    max_ttft_s: Optional[float] = None
    request_timeout_s: Optional[float] = None
    max_queue_depth: int = 256
    # server
    host: str = "0.0.0.0"
    port: int = 8000
    db_path: str = "data/threads.db"
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
            host=get("HOST", cls.host),
            port=get("PORT", cls.port, int),
            db_path=get("DB_PATH", cls.db_path),
            tiny_model=get("TINY_MODEL", "0") in ("1", "true", "True"),
            system_prompt=get("SYSTEM_PROMPT", None),
            warmup=get("WARMUP", "1") not in ("0", "false", "False"),
            prefix_cache_pages=get("PREFIX_CACHE_PAGES", None, int),
            speculative_k=get("SPECULATIVE_K", cls.speculative_k, int),
        )
        return dataclasses.replace(cfg, **overrides)
