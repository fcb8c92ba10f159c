"""Memory-fit planner: pure arithmetic over model + engine shapes.

Counterpart of kafka_tpu/runtime/planner.py: the same byte arithmetic
(`plan_memory`, `plan_for_serving`), the same per-dispatch cost model
(`DispatchCostModel`, `dispatch_cost_model`) and the same live memory
gauges (`MemoryMonitor`), with the card's memory and roofline read from
PyTorch instead of a chip table:

* a CUDA device's budget is its `total_memory`
  (`torch.cuda.get_device_properties`); a CPU device has none;
* `device_peaks` knows one card, the H100 SXM5 (NVIDIA H100 Tensor Core
  GPU datasheet: 989 TFLOP/s dense BF16 tensor, 3.35 TB/s HBM3);
  anything else reads "unknown" unless KAFKA_TORCH_PEAK_TFLOPS /
  KAFKA_TORCH_PEAK_HBM_GBPS say otherwise;
* `MemoryMonitor` samples the caching allocator
  (`torch.cuda.memory_reserved` / `max_memory_reserved`, the device's
  total from `torch.cuda.mem_get_info`) and attributes the CUDA-graph
  pools' segments (`torch.cuda.memory_snapshot`) as their own line.

The placement rules keep the reference's tensor-parallel arithmetic
(grouped-GQA kv sharding over gcd(tp, Hkv)), so a plan for tp > 1 reads
as the reference's does; this package serves one device, tp = 1.
Activation peaks are *estimates* sized from the dominant live tensors:
the [S, V/tp] f32 prefill logits block, the window gather, and the
decode-time [B, V] f32 logits + sampling workspace.  A
fragmentation/scratch reserve (default 8%) absorbs what the formulas do
not model.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig

GiB = 1024**3
MiB = 1024**2

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 column: BF16 tensor
# core 1,979 TFLOP/s with sparsity, so 989 dense; GPU memory bandwidth
# 3.35 TB/s (HBM3).  The PCIe and NVL parts have other figures and are
# not listed: their roofline reads "unknown".
H100_SXM_PEAKS = (989e12, 3.35e12)

PEAK_TFLOPS_ENV = "KAFKA_TORCH_PEAK_TFLOPS"
PEAK_HBM_GBPS_ENV = "KAFKA_TORCH_PEAK_HBM_GBPS"

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}


def _bytes(dtype: str) -> int:
    return _DTYPE_BYTES[dtype]


def factor_tp_for_kv(tensor_degree: int, num_kv_heads: int
                     ) -> Tuple[int, int]:
    """(tp, tq) for a tensor-parallel degree: the kv sub-axis tp is the
    largest divisor of the degree that divides num_kv_heads, tq carries
    the rest as kv replication groups (kafka_tpu/parallel/mesh.py)."""
    if tensor_degree <= 1:
        return max(tensor_degree, 1), 1
    kv = math.gcd(tensor_degree, num_kv_heads)
    return kv, tensor_degree // kv


def _kv_shard(cfg: ModelConfig, tp: int, kv_shard: Optional[int] = None
              ) -> int:
    """kv-head shard factor: gcd(tp, Hkv) unless `kv_shard` overrides."""
    if kv_shard is not None:
        return kv_shard
    return factor_tp_for_kv(tp, cfg.num_kv_heads)[0]


def hbm_for_device(dev) -> Optional[int]:
    """Device memory of a torch device: a CUDA device's total_memory;
    None for the CPU (no budget to validate against)."""
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Per-device byte budget for one serving configuration."""

    model: str
    mesh: Dict[str, int]              # {"tp":..,"sp":..,"pp":..,"ep":..}
    hbm_bytes: int                    # budget per device
    reserve_frac: float               # scratch/fragmentation allowance
    weight_bytes: int                 # per device
    kv_pool_bytes: int                # per device (both k and v)
    activation_bytes: int             # estimated peak live activations
    kv_replicated: bool               # kv not sharded the full tensor
                                      # degree (gcd(tp, Hkv) < tp)
    kv_bytes_per_token: int           # per device, k+v, all layers
    window_tokens: int                # configured attention window
    kv_shard: int = 1
    tq: int = 1
    # the on-device grammar tables' reservation
    # (KAFKA_TORCH_GRAMMAR_TABLE_MB); 0 when on-device grammar is off
    grammar_table_bytes: int = 0
    # host-RAM KV tier budget (not device memory, not in total_bytes);
    # 0 until this package has the KV tiers
    kv_host_tier_bytes: int = 0
    notes: str = ""

    @property
    def total_bytes(self) -> int:
        return (self.weight_bytes + self.kv_pool_bytes
                + self.activation_bytes + self.grammar_table_bytes)

    @property
    def usable_bytes(self) -> int:
        return int(self.hbm_bytes * (1.0 - self.reserve_frac))

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.usable_bytes

    @property
    def headroom_bytes(self) -> int:
        return self.usable_bytes - self.total_bytes

    @property
    def max_concurrent_windows(self) -> int:
        """How many FULL attention windows of KV the leftover memory holds
        (weights and activations charged first; the configured pool is
        not)."""
        free = self.usable_bytes - self.weight_bytes - self.activation_bytes
        per_window = self.kv_bytes_per_token * self.window_tokens
        return max(0, free // per_window) if per_window else 0

    def summary(self) -> Dict[str, object]:
        return {
            "model": self.model,
            "mesh": self.mesh,
            "hbm_gib": round(self.hbm_bytes / GiB, 2),
            "weight_gib": round(self.weight_bytes / GiB, 3),
            "kv_pool_gib": round(self.kv_pool_bytes / GiB, 3),
            "activation_gib": round(self.activation_bytes / GiB, 3),
            "total_gib": round(self.total_bytes / GiB, 3),
            "usable_gib": round(self.usable_bytes / GiB, 3),
            "fits": self.fits,
            "headroom_gib": round(self.headroom_bytes / GiB, 3),
            "kv_replicated": self.kv_replicated,
            "kv_shard": self.kv_shard,
            "tq": self.tq,
            "grammar_table_mib": round(self.grammar_table_bytes / MiB, 2),
            "kv_host_tier_mib": round(self.kv_host_tier_bytes / MiB, 2),
            "window_tokens": self.window_tokens,
            "max_concurrent_windows": self.max_concurrent_windows,
            "notes": self.notes,
        }


def weight_bytes_per_device(
    cfg: ModelConfig,
    *,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    quantize: str = "",
    kv_shard: Optional[int] = None,
) -> int:
    """Per-device weight bytes: int8 = 1 byte + an f32 scale per output
    channel (models/quant.py)."""
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    L = cfg.num_layers
    wb = _bytes(cfg.dtype)
    int8 = quantize == "int8"

    def mat(rows: int, cols: int, shard: int) -> int:
        n = rows * cols // shard
        return n + (cols // shard) * 4 if int8 else n * wb

    kv_shard = _kv_shard(cfg, tp, kv_shard)

    per_layer = (
        mat(h, hq * d, tp)            # wq
        + 2 * mat(h, hkv * d, kv_shard)  # wk, wv
        + mat(hq * d, h, tp)          # wo
        + 2 * h * wb                  # norms
    )
    if getattr(cfg, "is_moe", False):
        n_exp = cfg.num_experts
        e_shard = ep if (ep > 1 and n_exp % ep == 0) else 1
        per_layer += h * n_exp * wb  # router, replicated
        per_layer += n_exp // e_shard * (2 * mat(h, f, tp) + mat(f, h, tp))
    else:
        per_layer += 2 * mat(h, f, tp) + mat(f, h, tp)

    total = per_layer * L // pp
    total += mat(cfg.vocab_size, h, 1) if int8 else cfg.vocab_size * h * wb
    total += h * wb  # final norm
    if not cfg.tie_word_embeddings:
        total += mat(h, cfg.vocab_size, tp)
    return total


def kv_pool_bytes_per_device(
    cfg: ModelConfig,
    *,
    num_pages: int,
    page_size: int,
    tp: int = 1,
    pp: int = 1,
    kv_dtype: str = "bfloat16",
    kv_shard: Optional[int] = None,
) -> int:
    """Both pool arrays (k + v), [L/pp, num_pages*page_size, Hkv*D]."""
    hkv_d = cfg.num_kv_heads * cfg.head_dim
    kv_shard = _kv_shard(cfg, tp, kv_shard)
    slots = num_pages * page_size
    per = cfg.num_layers // pp * slots * hkv_d // kv_shard
    b = per * _bytes(kv_dtype) * 2
    if kv_dtype == "int8":
        # per-slot f32 scales, k and v
        b += cfg.num_layers // pp * slots * 2 * 4
    return b


def kv_bytes_per_token(
    cfg: ModelConfig, *, tp: int = 1, pp: int = 1,
    kv_dtype: str = "bfloat16", kv_shard: Optional[int] = None,
) -> int:
    kv_shard = _kv_shard(cfg, tp, kv_shard)
    return (
        cfg.num_layers // pp
        * cfg.num_kv_heads * cfg.head_dim // kv_shard
        * _bytes(kv_dtype) * 2
    )


def activation_bytes_estimate(
    cfg: ModelConfig,
    *,
    max_batch: int,
    prefill_bucket: int,
    window: int,
    tp: int = 1,
    sp: int = 1,
) -> int:
    """Peak live activations, from the dominant tensors.

    Prefill (chunk S over sp ranks, heads/F over tp):
      logits block  S/sp * V/tp * 4   (f32, the [S, V] output)
      hidden trio   S/sp * (H + 2*F/tp) * 2
      window gather S * Hkv*D * 2 * 2 (plain attention gathers k+v
                    windows; the kernels stream pages instead, but plan
                    for the plain path)
    Decode: B * V * 4 * 3 (logits + top-k sort workspace ~2 copies).
    """
    V, H, F = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size
    hkv_d = cfg.num_kv_heads * cfg.head_dim
    s_local = max(1, prefill_bucket // max(sp, 1))
    prefill = (
        s_local * (V // tp) * 4
        + s_local * (H + 2 * F // tp) * 2
        + window * hkv_d * 2 * 2
    )
    decode = max_batch * V * 4 * 3 + max_batch * window * hkv_d * 2 * 2
    return max(prefill, decode)


def plan_memory(
    cfg: ModelConfig,
    *,
    hbm_bytes: int,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    num_pages: int,
    page_size: int,
    max_pages_per_seq: int,
    max_batch: int,
    prefill_bucket: int = 512,
    quantize: str = "",
    kv_dtype: str = "bfloat16",
    reserve_frac: float = 0.08,
    kv_shard: Optional[int] = None,
    grammar_table_bytes: Optional[int] = None,
) -> MemoryPlan:
    """The plan for one device of `hbm_bytes` (hbm_for_device of the
    serving device)."""
    if grammar_table_bytes is None:
        # charge the on-device constrained-decoding table reservation
        # unless the feature is disabled
        from ..llm.constrained import (
            _grammar_table_cap_bytes,
            grammar_ondevice_enabled,
        )

        grammar_table_bytes = (
            _grammar_table_cap_bytes() if grammar_ondevice_enabled() else 0
        )
    kv_shard = _kv_shard(cfg, tp, kv_shard)
    kv_replicated = tp > 1 and kv_shard < tp
    window = max_pages_per_seq * page_size
    return MemoryPlan(
        model=cfg.name,
        mesh={"tp": tp, "sp": sp, "pp": pp, "ep": ep},
        hbm_bytes=hbm_bytes,
        reserve_frac=reserve_frac,
        weight_bytes=weight_bytes_per_device(
            cfg, tp=tp, pp=pp, ep=ep, quantize=quantize, kv_shard=kv_shard
        ),
        kv_pool_bytes=kv_pool_bytes_per_device(
            cfg, num_pages=num_pages, page_size=page_size, tp=tp, pp=pp,
            kv_dtype=kv_dtype, kv_shard=kv_shard,
        ),
        activation_bytes=activation_bytes_estimate(
            cfg, max_batch=max_batch, prefill_bucket=prefill_bucket,
            window=window, tp=tp, sp=sp,
        ),
        kv_replicated=kv_replicated,
        kv_bytes_per_token=kv_bytes_per_token(
            cfg, tp=tp, pp=pp, kv_dtype=kv_dtype, kv_shard=kv_shard
        ),
        window_tokens=window,
        kv_shard=kv_shard,
        tq=tp // kv_shard,
        grammar_table_bytes=grammar_table_bytes,
        notes=(
            (
                f"grouped GQA layout: tensor degree {tp} factorizes "
                f"tp={kv_shard} x tq={tp // kv_shard}; kv params+pool "
                f"shard {kv_shard}-ways, each kv head replicated on "
                f"{tp // kv_shard} chips (parallel/mesh.py "
                "factor_tp_for_kv)"
                if kv_shard > 1 else
                "kv params+pool fully replicated per chip: the mesh "
                f"keeps the plain tensor axis (degree {tp}) and it does "
                f"not divide num_kv_heads ({cfg.num_kv_heads})"
            )
            if kv_replicated else ""
        ),
    )


def device_peaks(dev) -> tuple:
    """(peak FLOP/s, peak memory bytes/s, source) roofline of a torch
    device — the denominator of the MFU / HBM-bandwidth-utilization
    estimator.

    KAFKA_TORCH_PEAK_TFLOPS / KAFKA_TORCH_PEAK_HBM_GBPS override
    everything ("env"); an H100 SXM5 gets its datasheet figures
    (H100_SXM_PEAKS, "datasheet"); every other device returns (None,
    None, "unknown") — the estimator then reports achieved FLOP/s and
    GB/s without ratios rather than inventing a roofline."""
    import torch

    env_tf = os.environ.get(PEAK_TFLOPS_ENV)
    env_bw = os.environ.get(PEAK_HBM_GBPS_ENV)
    if env_tf or env_bw:
        try:
            return (
                float(env_tf) * 1e12 if env_tf else None,
                float(env_bw) * 1e9 if env_bw else None,
                "env",
            )
        except ValueError:
            pass
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None, None, "unknown"
    name = torch.cuda.get_device_name(dev)
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        return (*H100_SXM_PEAKS, "datasheet")
    return None, None, "unknown"


@dataclasses.dataclass(frozen=True)
class DispatchCostModel:
    """Per-device flop/byte cost of one engine dispatch, from the same
    shape arithmetic the memory plan uses.

    The engine calls the cost methods at every dispatch site with its
    host-known shapes (new tokens sampled, total KV context attended);
    the products divide by busy time in runtime/metrics.py to yield MFU
    and HBM-bandwidth utilization.  Deliberately an ESTIMATE: matmul
    flops use the 2·params convention (embedding lookups and norms are
    noise), attention uses 4·H·D per (query, kv) pair.
    """

    flops_per_token: float       # per device: matmul flops for 1 token
    attn_flops_per_kv: float     # per device: per (query, kv-token) pair
    weight_bytes: int            # per device: read once per dispatch step
    kv_bytes_per_token: int      # per device: one token's k+v row

    def decode_cost(self, new_tokens: int, kv_tokens: int,
                    steps: int = 1) -> tuple:
        """One decode dispatch advancing `new_tokens` lanes by `steps`
        fused steps, attending ~`kv_tokens` total context per step.
        Decode is bandwidth-bound: every weight byte streams once per
        step and the batch's whole KV window is read per step."""
        flops = steps * kv_tokens * self.attn_flops_per_kv \
            + new_tokens * self.flops_per_token
        bytes_ = steps * (self.weight_bytes
                          + kv_tokens * self.kv_bytes_per_token) \
            + new_tokens * self.kv_bytes_per_token
        return flops, bytes_

    def prefill_cost(self, chunk_tokens: int, start_tokens: int) -> tuple:
        """One prefill chunk of `chunk_tokens` starting at position
        `start_tokens`: causal attention pairs = chunk·start + chunk²/2;
        KV reads cover the materialized window once, writes the chunk."""
        pairs = chunk_tokens * start_tokens + chunk_tokens * chunk_tokens / 2
        flops = (chunk_tokens * self.flops_per_token
                 + pairs * self.attn_flops_per_kv)
        bytes_ = (self.weight_bytes
                  + (start_tokens + chunk_tokens) * self.kv_bytes_per_token
                  + chunk_tokens * self.kv_bytes_per_token)
        return flops, bytes_

    def verify_cost(self, query_tokens: int, kv_tokens: int,
                    attn_pairs: Optional[float] = None) -> tuple:
        """One speculative verify dispatch scoring `query_tokens` total
        candidate positions against `kv_tokens` of context; `attn_pairs`
        is the (query, kv-token) pair count (each of a lane's K+1 queries
        attends that lane's whole context).  Bytes stay kv_tokens-based:
        the kernel streams each KV page once per lane."""
        if attn_pairs is None:
            attn_pairs = float(kv_tokens)
        flops = (query_tokens * self.flops_per_token
                 + attn_pairs * self.attn_flops_per_kv)
        bytes_ = (self.weight_bytes + kv_tokens * self.kv_bytes_per_token
                  + query_tokens * self.kv_bytes_per_token)
        return flops, bytes_


def dispatch_cost_model(
    cfg: ModelConfig,
    *,
    n_devices: int = 1,
    weight_bytes_total: Optional[int] = None,
    kv_dtype_bytes: int = 2,
    kv_replication: int = 1,
) -> DispatchCostModel:
    """The per-device dispatch cost model for an engine.

    `weight_bytes_total` is the engine's ACTUAL parameter bytes when known
    (models/quant.param_bytes — exact for int8 trees); falls back to the
    planner's arithmetic.  `kv_replication` is the tq factor."""
    if weight_bytes_total is None:
        weight_bytes_total = weight_bytes_per_device(cfg, tp=1)
    wb = _bytes(cfg.dtype)
    # params from the unsharded arithmetic (stable vs quantization)
    params_total = weight_bytes_per_device(cfg, tp=1) / wb
    n = max(1, n_devices)
    kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim \
        * kv_dtype_bytes
    return DispatchCostModel(
        flops_per_token=2.0 * params_total / n,
        attn_flops_per_kv=4.0 * cfg.num_layers * cfg.num_heads
        * cfg.head_dim / n,
        weight_bytes=int(weight_bytes_total // n),
        kv_bytes_per_token=int(kv_row * max(1, kv_replication) // n),
    )


def plan_for_serving(scfg, hbm_bytes: int,
                     model_cfg: Optional[ModelConfig] = None) -> MemoryPlan:
    """Plan from a ServingConfig (server/config.py); `model_cfg` is the
    model the server actually built (tiny / checkpoint configs differ
    from model_name).  One device: tp = sp = pp = ep = 1."""
    if model_cfg is None:
        from ..models.config import get_config

        model_cfg = get_config(scfg.model_name)
    return plan_memory(
        model_cfg,
        hbm_bytes=hbm_bytes,
        num_pages=scfg.num_pages, page_size=scfg.page_size,
        max_pages_per_seq=scfg.max_pages_per_seq, max_batch=scfg.max_batch,
        prefill_bucket=max(scfg.prefill_buckets),
        quantize=scfg.quantize,
        kv_dtype=getattr(scfg, "kv_quantize", "") or "bfloat16",
    )


# ---------------------------------------------------------------------------
# Live memory accounting: reconcile the boot-time plan against what the
# device actually holds, at step cadence.

HBM_WATERMARK_ENV = "KAFKA_TORCH_HBM_WATERMARK"
HBM_POLL_ENV = "KAFKA_TORCH_HBM_POLL_S"


def _watermark_frac() -> Optional[float]:
    """Headroom watermark as a fraction of the device byte limit.
    Explicitly set -> that fraction (clamped to [0, 1)).  Unset -> 0.03
    for device-sourced samples and DISABLED for plan-synthesized ones (a
    barely-fitting plan on the CPU would otherwise hold an hbm_pressure
    anomaly forever on numbers that are a prediction, not a
    measurement)."""
    raw = os.environ.get(HBM_WATERMARK_ENV)
    if raw is None or raw == "":
        return None
    try:
        return min(0.99, max(0.0, float(raw)))
    except ValueError:
        return None


def _device_stats(dev) -> Optional[Dict[str, int]]:
    """The caching allocator's view of one CUDA device: bytes reserved
    (every segment, the CUDA-graph pools' included), their peak, the
    device's total memory, and the bytes held by private (CUDA-graph)
    pools.  None for a non-CUDA device."""
    import torch

    if dev.type != "cuda":
        return None
    graph_pool = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev.index) == dev.index and \
                tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
            graph_pool += int(seg.get("total_size", 0))
    return {
        "bytes_in_use": int(torch.cuda.memory_reserved(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_reserved(dev)),
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
        "graph_pool_bytes": graph_pool,
    }


class MemoryMonitor:
    """Per-engine live memory gauge set (engine-thread single-writer).

    ``poll()`` samples each CUDA device's caching allocator (throttled to
    ``KAFKA_TORCH_HBM_POLL_S``, default 1s) and publishes one immutable
    section dict; readers (``/metrics``, ``/admin/signals``, the flight
    recorder's ``hbm_pressure`` detector) grab the latest reference
    torn-free.

    A device without allocator stats (the CPU) synthesizes the sample
    from the :class:`MemoryPlan` itself (``source: "plan"``,
    ``plan_skew`` pinned at 1.0), as the reference does, so every
    consumer downstream exercises the same code path.
    """

    def __init__(self, devices, plan: Optional[MemoryPlan] = None,
                 poll_s: Optional[float] = None):
        import torch

        self.devices = [torch.device(d) for d in devices]
        self.plan = plan
        if poll_s is None:
            try:
                poll_s = float(os.environ.get(HBM_POLL_ENV, "1.0"))
            except ValueError:
                poll_s = 1.0
        self.poll_s = max(0.0, poll_s)
        explicit = _watermark_frac()
        self.watermark_frac = explicit
        self._watermark_explicit = explicit is not None
        self._last_poll_t: Optional[float] = None
        self._last: Optional[Dict[str, object]] = None
        self.polls = 0

    # -- sampling --------------------------------------------------------

    def poll(self, now: Optional[float] = None,
             force: bool = False) -> Optional[Dict[str, object]]:
        """Refresh the sample when the throttle allows; returns the
        current section either way (None before the first poll)."""
        now = time.monotonic() if now is None else now
        if (not force and self._last_poll_t is not None
                and now - self._last_poll_t < self.poll_s):
            return self._last
        self._last_poll_t = now
        self._last = self._sample()
        self.polls += 1
        return self._last

    def _sample(self) -> Dict[str, object]:
        per_dev = []
        graph_pool = 0
        for d in self.devices:
            stats = _device_stats(d)
            if not stats or not stats.get("bytes_limit"):
                continue
            graph_pool = max(graph_pool, stats["graph_pool_bytes"])
            per_dev.append({
                "device": str(d.index if d.index is not None else
                              len(per_dev)),
                "bytes_in_use": stats["bytes_in_use"],
                "bytes_peak": stats["peak_bytes_in_use"],
                "bytes_limit": stats["bytes_limit"],
            })
        plan = self.plan
        if per_dev:
            # worst device bounds the fleet: the plan is per-device
            in_use = max(d["bytes_in_use"] for d in per_dev)
            peak = max(d["bytes_peak"] for d in per_dev)
            limit = min(d["bytes_limit"] for d in per_dev)
            source = "device"
        elif plan is not None:
            in_use = plan.total_bytes
            peak = plan.total_bytes
            limit = plan.usable_bytes
            source = "plan"
        else:
            return {
                "source": "none", "hbm_bytes_in_use": 0,
                "hbm_bytes_peak": 0, "hbm_bytes_limit": 0,
                "hbm_headroom_bytes": 0, "hbm_plan_skew": 0.0,
                "hbm_pressure": 0, "hbm_component_bytes": {},
                "devices": [],
            }
        headroom = limit - in_use
        skew = (in_use / plan.total_bytes
                if plan is not None and plan.total_bytes else 0.0)
        wm = self.watermark_frac
        if wm is None:
            wm = 0.03 if source == "device" else None
        pressure = (wm is not None and limit > 0
                    and headroom < wm * limit)
        return {
            "source": source,
            "hbm_bytes_in_use": int(in_use),
            "hbm_bytes_peak": int(peak),
            "hbm_bytes_limit": int(limit),
            "hbm_headroom_bytes": int(headroom),
            "hbm_plan_skew": round(skew, 4),
            "hbm_pressure": 1 if pressure else 0,
            "hbm_component_bytes": self._attribution(
                in_use, graph_pool if source == "device" else None),
            "devices": per_dev,
        }

    def _attribution(self, in_use: int,
                     graph_pool: Optional[int] = None) -> Dict[str, int]:
        """Measured bytes reconciled against the plan's line items: each
        planned component at its planned charge, the CUDA-graph pools'
        segments as measured (the decode step programs' private memory,
        which the plan does not model), and the residual (allocator
        slack, scratch, fragmentation) as ``unattributed``.  A strongly
        negative residual means the plan OVER-charges (plan_skew < 1)."""
        plan = self.plan
        if plan is None:
            return {}
        comp = {
            "weights": plan.weight_bytes,
            "kv_pool": plan.kv_pool_bytes,
            "activations": plan.activation_bytes,
            "grammar_tables": plan.grammar_table_bytes,
        }
        charged = plan.total_bytes
        if graph_pool is not None:
            comp["graph_pool"] = int(graph_pool)
            charged += int(graph_pool)
        comp["unattributed"] = int(in_use) - charged
        return comp

    # -- export ----------------------------------------------------------

    def section(self) -> Optional[Dict[str, object]]:
        """Latest sample (the ``memory`` metrics/signals section; keys
        registered as MEMORY_METRIC_KEYS in metrics.py)."""
        return self._last

    def pressure(self) -> bool:
        s = self._last
        return bool(s and s.get("hbm_pressure"))
