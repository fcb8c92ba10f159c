"""Prometheus text exposition for the /metrics snapshot.

Counterpart of kafka_tpu/server/prometheus.py with the same family
names, so one snapshot renders to the same text in both packages (help
texts name this package's knobs and compile sources).

``GET /metrics?format=prometheus`` renders the same snapshot the JSON
endpoint serves (one source of truth — the engine's EngineMetrics, plus
sandbox-supervision, tracing and compile-observatory counters merged by
server/app.py) in the classic text format (version 0.0.4): ``# TYPE``
lines, stable metric names, label escaping per the spec.  Percentile
families render as summaries with ``quantile`` labels (p50 → 0.5 etc.).

The renderer tolerates both snapshot shapes — a single engine's and a
DP aggregate's (which lacks the TTFT breakdown and adds the
replica_supervisor section) — by keying every family off ``.get``.  The
output passes a minimal format checker (no duplicate series, every
family typed, values float-parseable), so the endpoint stays scrapeable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_QUANTILE = {"p50": "0.5", "p90": "0.9", "p99": "0.99"}


def _escape(value: str) -> str:
    """Label-value escaping per the exposition format spec."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value: Any) -> str:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Writer:
    def __init__(self) -> None:
        self.lines: List[str] = []
        self._typed: set = set()

    def family(self, name: str, kind: str, help_text: str) -> None:
        if name in self._typed:
            return
        self._typed.add(name)
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(
        self, name: str, value: Any,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        if labels:
            rendered = ",".join(
                f'{k}="{_escape(v)}"' for k, v in labels.items()
            )
            self.lines.append(f"{name}{{{rendered}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def summary(
        self, name: str, quantiles: Dict[str, Any], help_text: str,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.family(name, "summary", help_text)
        for p, q in _QUANTILE.items():
            if p in quantiles:
                self.sample(name, quantiles[p],
                            {**(labels or {}), "quantile": q})

    def histogram_family(
        self, name: str, help_text: str,
        rows: List[tuple],
    ) -> None:
        """One histogram family from StreamingHistogram snapshots: true
        ``_bucket`` series with CUMULATIVE counts per
        ``le`` bound (monotone by construction — the wire snapshot holds
        non-negative per-bucket counts), a ``+Inf`` bucket equal to
        ``_count``, and ``_sum``.  `rows` is [(labels, hist_snapshot)] —
        all bucket series render before the sums/counts so each sample
        NAME stays one contiguous group (exposition single-group rule,
        enforced by the in-tree parser)."""
        self.family(name, "histogram", help_text)
        for labels, h in rows:
            cum = 0
            for le, c in zip(h["le"], h["counts"]):
                cum += c
                self.sample(f"{name}_bucket", cum,
                            {**labels, "le": _fmt(le)})
            self.sample(f"{name}_bucket", sum(h["counts"]),
                        {**labels, "le": "+Inf"})
        for labels, h in rows:
            self.sample(f"{name}_sum", h["sum"], labels or None)
        for labels, h in rows:
            self.sample(f"{name}_count", sum(h["counts"]), labels or None)

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


# histogram snapshot name -> (family, extra labels).  The three TTFT
# phases share ONE family distinguished by the phase label, mirroring the
# JSON breakdown section.
_HISTOGRAM_FAMILIES = (
    ("ttft_ms", "kafka_tpu_ttft_milliseconds",
     "Time to first token.", {}),
    ("tpot_ms", "kafka_tpu_tpot_milliseconds",
     "Time per output token.", {}),
    ("ttft_queue_ms", "kafka_tpu_ttft_phase_milliseconds",
     "TTFT decomposition by phase.", {"phase": "queue_wait"}),
    ("ttft_prefill_ms", "kafka_tpu_ttft_phase_milliseconds",
     "TTFT decomposition by phase.", {"phase": "prefill"}),
    ("ttft_fetch_ms", "kafka_tpu_ttft_phase_milliseconds",
     "TTFT decomposition by phase.", {"phase": "first_fetch"}),
    ("burst_tokens", "kafka_tpu_emission_burst_tokens",
     "Tokens arriving together per emission burst.", {}),
    ("burst_gap_ms", "kafka_tpu_emission_burst_gap_milliseconds",
     "Gap between emission bursts.", {}),
)


def _render_histograms(w: "_Writer", snap: Dict[str, Any]) -> None:
    """The latency/size histogram families: aggregate series plus one
    replica-labeled series per DP replica (contiguous per family)."""
    hists = snap.get("histograms") or {}
    if not hists:
        return
    replica_hists = [
        (idx, rs.get("histograms") or {})
        for idx, rs in enumerate(snap.get("replicas") or [])
        if rs.get("histograms")
    ]
    by_family: Dict[str, List[tuple]] = {}
    help_by_family: Dict[str, str] = {}
    for key, family, help_text, labels in _HISTOGRAM_FAMILIES:
        if key not in hists:
            continue
        help_by_family[family] = help_text
        rows = by_family.setdefault(family, [])
        rows.append((dict(labels), hists[key]))
        for idx, rh in replica_hists:
            if key in rh:
                rows.append(({**labels, "replica": idx}, rh[key]))
    for family, rows in by_family.items():
        w.histogram_family(family, help_by_family[family], rows)


def render_prometheus(snap: Dict[str, Any]) -> str:
    w = _Writer()

    w.family("kafka_tpu_uptime_seconds", "gauge", "Engine uptime.")
    w.sample("kafka_tpu_uptime_seconds", snap.get("uptime_s", 0))

    requests = snap.get("requests") or {}
    if requests:
        w.family("kafka_tpu_requests_total", "counter",
                 "Requests by terminal state (submitted counts ingress).")
        for state, v in requests.items():
            w.sample("kafka_tpu_requests_total", v, {"state": state})

    queue = snap.get("queue") or {}
    if queue:
        w.family("kafka_tpu_queue_depth", "gauge",
                 "Engine waiting-queue depth (last scheduler iteration).")
        w.sample("kafka_tpu_queue_depth", queue.get("depth", 0))
        w.family("kafka_tpu_queue_depth_peak", "gauge",
                 "Peak waiting-queue depth since the previous snapshot "
                 "(each scrape re-arms the high-water mark).")
        w.sample("kafka_tpu_queue_depth_peak", queue.get("peak", 0))
        if "trend_per_s" in queue:
            w.family("kafka_tpu_queue_depth_trend_per_second", "gauge",
                     "Queue-depth slope over the last minute (>0 = "
                     "growing; an autoscaler scale-up signal).")
            w.sample("kafka_tpu_queue_depth_trend_per_second",
                     queue["trend_per_s"])

    tokens = snap.get("tokens") or {}
    if tokens:
        w.family("kafka_tpu_tokens_total", "counter",
                 "Token counters by kind.")
        # fetch_pipeline_wasted was exported as kind="speculative_wasted"
        # before real speculative decoding existed (the JSON endpoint's
        # deprecated aliases are gone)
        for kind in ("prompt", "generated", "fetch_pipeline_wasted"):
            if kind in tokens:
                w.sample("kafka_tpu_tokens_total", tokens[kind],
                         {"kind": kind})
        w.family("kafka_tpu_tokens_generated_per_second", "gauge",
                 "Decode throughput over uptime.")
        w.sample("kafka_tpu_tokens_generated_per_second",
                 tokens.get("generated_per_s", 0))

    # Latency/size distributions: TRUE histogram families (_bucket with
    # le labels, _sum, _count) from the streaming-histogram snapshots —
    # cumulative since boot, mergeable in PromQL, per replica and
    # aggregated (replaces the old summary-quantile rendering).
    # When the snapshot predates histograms (stale client), fall back to
    # the summary form so the endpoint never goes dark.
    if snap.get("histograms"):
        _render_histograms(w, snap)
    else:
        if "ttft_ms" in snap:
            w.summary("kafka_tpu_ttft_milliseconds", snap["ttft_ms"],
                      "Time to first token (percentiles).")
        for phase, q in (snap.get("ttft_breakdown_ms") or {}).items():
            w.summary("kafka_tpu_ttft_phase_milliseconds", q,
                      "TTFT decomposition by phase.",
                      labels={"phase": phase})
        if "tpot_ms" in snap:
            w.summary("kafka_tpu_tpot_milliseconds", snap["tpot_ms"],
                      "Time per output token (percentiles).")

    decode = snap.get("decode") or {}
    if decode:
        w.family("kafka_tpu_decode_steps_total", "counter",
                 "Decode steps dispatched (fused steps count k).")
        w.sample("kafka_tpu_decode_steps_total", decode.get("steps", 0))
        w.family("kafka_tpu_batch_occupancy", "gauge",
                 "Mean busy decode slots per step.")
        w.sample("kafka_tpu_batch_occupancy",
                 decode.get("batch_occupancy", 0))

    if not snap.get("histograms"):
        emission = snap.get("emission") or {}
        if "burst_tokens" in emission:
            w.summary("kafka_tpu_emission_burst_tokens",
                      emission["burst_tokens"],
                      "Tokens arriving together per emission burst.")
        if "burst_gap_ms" in emission:
            w.summary("kafka_tpu_emission_burst_gap_milliseconds",
                      emission["burst_gap_ms"],
                      "Gap between emission bursts.")

    # SLO / goodput (runtime/metrics.SLO_METRIC_KEYS — the registry a
    # static test enforces in both files).  The autoscaler's primary
    # inputs: attainment per window, goodput vs raw throughput.
    slo = snap.get("slo") or {}
    if slo:
        w.family("kafka_tpu_slo_requests_total", "counter",
                 "Requests by SLO verdict at finalize (timeouts, engine "
                 "failures and 429 rejections count as missed; client "
                 "cancels are excluded).")
        for key, result in (("slo_met_requests", "met"),
                            ("slo_missed_requests", "missed")):
            if key in slo:
                w.sample("kafka_tpu_slo_requests_total", slo[key],
                         {"result": result})
        w.family("kafka_tpu_slo_violations_total", "counter",
                 "Missed-SLO attributions by violated target.")
        for key, kind in (("slo_ttft_violations", "ttft"),
                          ("slo_tpot_violations", "tpot")):
            if key in slo:
                w.sample("kafka_tpu_slo_violations_total", slo[key],
                         {"kind": kind})
        w.family("kafka_tpu_slo_target_milliseconds", "gauge",
                 "Configured SLO targets (0 = target disabled).")
        for key, kind in (("slo_ttft_target_ms", "ttft"),
                          ("slo_tpot_target_ms", "tpot")):
            if key in slo:
                w.sample("kafka_tpu_slo_target_milliseconds", slo[key],
                         {"kind": kind})
        w.family("kafka_tpu_slo_attainment", "gauge",
                 "Fraction of finalized requests meeting every SLO "
                 "target, by window (1.0 when the window saw none).")
        for key, window in (("slo_attainment", "total"),
                            ("slo_attainment_1m", "1m"),
                            ("slo_attainment_5m", "5m")):
            if key in slo:
                w.sample("kafka_tpu_slo_attainment", slo[key],
                         {"window": window})
        if "goodput_tokens" in slo:
            w.family("kafka_tpu_goodput_tokens_total", "counter",
                     "Tokens generated by SLO-met requests.")
            w.sample("kafka_tpu_goodput_tokens_total",
                     slo["goodput_tokens"])
        w.family("kafka_tpu_goodput_tokens_per_second", "gauge",
                 "Goodput rate by window (SLO-met tokens only).")
        for key, window in (("goodput_tok_s", "total"),
                            ("goodput_tok_s_1m", "1m")):
            if key in slo:
                w.sample("kafka_tpu_goodput_tokens_per_second", slo[key],
                         {"window": window})
        if "goodput_frac" in slo:
            w.family("kafka_tpu_goodput_fraction", "gauge",
                     "Goodput tokens / raw generated tokens.")
            w.sample("kafka_tpu_goodput_fraction", slo["goodput_frac"])

    # Device-utilization estimator (runtime/metrics.UTILIZATION_METRIC_
    # KEYS), per dispatch kind; counters enable PromQL rate()-based MFU,
    # the gauges are the ready-made since-boot and 1m ratios.  Per-replica
    # ratio gauges ride as labeled series next to the aggregate.
    util = snap.get("utilization") or {}
    kinds = [k for k in ("prefill", "decode", "verify") if k in util]
    if kinds:
        replica_utils = [
            (idx, rs.get("utilization") or {})
            for idx, rs in enumerate(snap.get("replicas") or [])
            if rs.get("utilization")
        ]
        w.family("kafka_tpu_dispatches_total", "counter",
                 "Device dispatches by kind.")
        for k in kinds:
            w.sample("kafka_tpu_dispatches_total",
                     util[k].get("dispatches", 0), {"kind": k})
        w.family("kafka_tpu_dispatch_tokens_total", "counter",
                 "Tokens processed by dispatch kind.")
        for k in kinds:
            w.sample("kafka_tpu_dispatch_tokens_total",
                     util[k].get("tokens", 0), {"kind": k})
        w.family("kafka_tpu_device_flops_total", "counter",
                 "Modeled device FLOPs by dispatch kind (planner cost "
                 "model).")
        for k in kinds:
            w.sample("kafka_tpu_device_flops_total",
                     util[k].get("flops", 0), {"kind": k})
        w.family("kafka_tpu_device_hbm_bytes_total", "counter",
                 "Modeled HBM bytes moved by dispatch kind.")
        for k in kinds:
            w.sample("kafka_tpu_device_hbm_bytes_total",
                     util[k].get("hbm_bytes", 0), {"kind": k})
        w.family("kafka_tpu_dispatch_busy_seconds_total", "counter",
                 "Wall time attributed to dispatch execution by kind.")
        for k in kinds:
            w.sample("kafka_tpu_dispatch_busy_seconds_total",
                     util[k].get("busy_s", 0), {"kind": k})
        w.family("kafka_tpu_mfu", "gauge",
                 "Model FLOPs utilization vs the chip roofline, by "
                 "dispatch kind and window (0 when no roofline known).")
        for k in kinds:
            for key, window in (("mfu", "total"), ("mfu_1m", "1m")):
                w.sample("kafka_tpu_mfu", util[k].get(key, 0),
                         {"kind": k, "window": window})
        for idx, ru in replica_utils:
            for k in kinds:
                if k in ru:
                    for key, window in (("mfu", "total"),
                                        ("mfu_1m", "1m")):
                        w.sample("kafka_tpu_mfu", ru[k].get(key, 0),
                                 {"replica": idx, "kind": k,
                                  "window": window})
        w.family("kafka_tpu_hbm_bandwidth_utilization", "gauge",
                 "HBM bandwidth utilization vs the chip roofline, by "
                 "dispatch kind and window.")
        for k in kinds:
            for key, window in (("hbm_bw_util", "total"),
                                ("hbm_bw_util_1m", "1m")):
                w.sample("kafka_tpu_hbm_bandwidth_utilization",
                         util[k].get(key, 0),
                         {"kind": k, "window": window})
        for idx, ru in replica_utils:
            for k in kinds:
                if k in ru:
                    for key, window in (("hbm_bw_util", "total"),
                                        ("hbm_bw_util_1m", "1m")):
                        w.sample("kafka_tpu_hbm_bandwidth_utilization",
                                 ru[k].get(key, 0),
                                 {"replica": idx, "kind": k,
                                  "window": window})
        # Measured dispatch timing + model skew: counters for PromQL
        # rate()-based skew, plus the ready-made since-boot ratio gauge.
        w.family("kafka_tpu_measured_dispatches_total", "counter",
                 "Dispatches with a measured device-time sample by kind.")
        for k in kinds:
            w.sample("kafka_tpu_measured_dispatches_total",
                     util[k].get("measured_dispatches", 0), {"kind": k})
        w.family("kafka_tpu_dispatch_measured_seconds_total", "counter",
                 "Measured device execution time by dispatch kind "
                 "(fetch-maturation timing).")
        for k in kinds:
            w.sample("kafka_tpu_dispatch_measured_seconds_total",
                     util[k].get("measured_busy_s", 0), {"kind": k})
        w.family("kafka_tpu_dispatch_modeled_seconds_total", "counter",
                 "Modeled roofline execution time for the SAME measured "
                 "dispatches, by kind.")
        for k in kinds:
            w.sample("kafka_tpu_dispatch_modeled_seconds_total",
                     util[k].get("modeled_busy_s", 0), {"kind": k})
        w.family("kafka_tpu_dispatch_model_skew", "gauge",
                 "Measured / modeled dispatch time by kind (>1 = the "
                 "device runs slower than the cost model assumes, so the "
                 "modeled MFU/HBM-BW figures read high by this factor; "
                 "0 = no samples yet).")
        for k in kinds:
            w.sample("kafka_tpu_dispatch_model_skew",
                     util[k].get("model_skew", 0), {"kind": k})
        # Profiler-sampled kernel truth: TRUE device kernel seconds from
        # sampled torch.profiler traces vs the modeled seconds of those same
        # sampled steps — the chip-truth calibration model_skew is read
        # against (keys kernel_samples / kernel_busy_s / kernel_skew).
        w.family("kafka_tpu_kernel_samples_total", "counter",
                 "Profiler trace samples attributed to this dispatch "
                 "kind (KAFKA_TORCH_PROFILE_SAMPLE).")
        for k in kinds:
            w.sample("kafka_tpu_kernel_samples_total",
                     util[k].get("kernel_samples", 0), {"kind": k})
        w.family("kafka_tpu_kernel_seconds_total", "counter",
                 "True device kernel time by dispatch kind, from "
                 "sampled profiler traces.")
        for k in kinds:
            w.sample("kafka_tpu_kernel_seconds_total",
                     util[k].get("kernel_busy_s", 0), {"kind": k})
        w.family("kafka_tpu_kernel_skew", "gauge",
                 "Sampled device kernel time / modeled roofline time "
                 "for the same steps, by kind (0 = no samples yet).")
        for k in kinds:
            w.sample("kafka_tpu_kernel_skew",
                     util[k].get("kernel_skew", 0), {"kind": k})
        if util.get("peak_tflops"):
            w.family("kafka_tpu_device_peak_teraflops", "gauge",
                     "Roofline peak FLOP/s per chip (datasheet or env "
                     "override), in TFLOP/s.")
            w.sample("kafka_tpu_device_peak_teraflops",
                     util["peak_tflops"])
        if util.get("peak_hbm_gbps"):
            w.family("kafka_tpu_device_peak_hbm_gigabytes_per_second",
                     "gauge",
                     "Roofline peak HBM bandwidth per chip, in GB/s.")
            w.sample("kafka_tpu_device_peak_hbm_gigabytes_per_second",
                     util["peak_hbm_gbps"])

    # constrained decoding (runtime/metrics.CONSTRAINED_METRIC_KEYS — the
    # registry a static test enforces in both files)
    con = dict(snap.get("constrained") or {})
    if "constrained_roundtrips" not in con and "constrained_roundtrips" in snap:
        con["constrained_roundtrips"] = snap["constrained_roundtrips"]
    if "constrained_roundtrips" in con:
        w.family("kafka_tpu_constrained_roundtrips_total", "counter",
                 "Constrained choice points that awaited a device fetch.")
        w.sample("kafka_tpu_constrained_roundtrips_total",
                 con["constrained_roundtrips"])
    if "constrained_mask_overtight" in con:
        w.family("kafka_tpu_constrained_overtight_total", "counter",
                 "Over-tight constrained mask rows degraded to "
                 "unconstrained sampling.")
        w.sample("kafka_tpu_constrained_overtight_total",
                 con["constrained_mask_overtight"])
    if "constrained_ondevice_tokens" in con:
        w.family("kafka_tpu_constrained_ondevice_tokens_total", "counter",
                 "Tokens emitted through the device-resident grammar FSM "
                 "(zero-roundtrip constrained decoding).")
        w.sample("kafka_tpu_constrained_ondevice_tokens_total",
                 con["constrained_ondevice_tokens"])
    if "constrained_compile_pending" in con:
        w.family("kafka_tpu_constrained_compile_pending", "gauge",
                 "Grammar compiles queued/running on the background "
                 "deferred-compile worker (requests use the host-mask "
                 "path until their table lands).")
        w.sample("kafka_tpu_constrained_compile_pending",
                 con["constrained_compile_pending"])

    spec = snap.get("speculation") or {}
    if spec:
        # speculative decoding (draft-free n-gram + batched verify).
        # Family names mirror runtime/metrics.SPECULATION_METRIC_KEYS —
        # the registry a static test enforces in both files.
        w.family("kafka_tpu_speculation_tokens_total", "counter",
                 "Speculative candidate tokens by outcome.")
        for key, kind in (
            ("speculation_proposed_tokens", "proposed"),
            ("speculation_accepted_tokens", "accepted"),
            ("speculation_rejected_tokens", "rejected"),
        ):
            if key in spec:
                w.sample("kafka_tpu_speculation_tokens_total", spec[key],
                         {"kind": kind})
        if "speculation_verify_steps" in spec:
            w.family("kafka_tpu_speculation_verify_steps_total", "counter",
                     "Speculative verify dispatches.")
            w.sample("kafka_tpu_speculation_verify_steps_total",
                     spec["speculation_verify_steps"])
        if "speculation_acceptance_rate" in spec:
            w.family("kafka_tpu_speculation_acceptance_rate", "gauge",
                     "Accepted / (accepted + rejected) candidate tokens.")
            w.sample("kafka_tpu_speculation_acceptance_rate",
                     spec["speculation_acceptance_rate"])
        if "speculation_accepted_per_step" in spec:
            w.family("kafka_tpu_speculation_accepted_per_step", "gauge",
                     "Mean accepted candidates per verify dispatch.")
            w.sample("kafka_tpu_speculation_accepted_per_step",
                     spec["speculation_accepted_per_step"])

    engine = snap.get("engine") or {}
    if engine:
        w.family("kafka_tpu_engine_active", "gauge",
                 "Requests holding a decode slot.")
        w.sample("kafka_tpu_engine_active", engine.get("active", 0))
        w.family("kafka_tpu_engine_waiting", "gauge",
                 "Requests in the waiting queue.")
        w.sample("kafka_tpu_engine_waiting", engine.get("waiting", 0))
        w.family("kafka_tpu_kv_pages", "gauge",
                 "KV pool pages by state.")
        for key, label in (("pages_total", "total"),
                           ("pages_free", "free"),
                           ("pages_in_use", "in_use")):
            if key in engine:
                w.sample("kafka_tpu_kv_pages", engine[key],
                         {"state": label})
        if "rtt_est_ms" in engine:
            w.family("kafka_tpu_device_rtt_milliseconds", "gauge",
                     "Estimated device-to-host fetch round trip.")
            w.sample("kafka_tpu_device_rtt_milliseconds",
                     engine["rtt_est_ms"])

    if "dp" in snap:
        w.family("kafka_tpu_dp_replicas", "gauge",
                 "Configured DP replica count.")
        w.sample("kafka_tpu_dp_replicas", snap["dp"])

    pc = snap.get("prefix_cache") or {}
    # DP aggregates sum per-replica prefix caches; export each replica's
    # cache as its own labeled series too (replica="<i>") so a dashboard
    # can see WHERE the radix trees are hot, while the unlabeled aggregate
    # series keeps existing dashboards working.  The exposition format
    # requires every sample of a family in ONE contiguous group, so the
    # aggregate and replica-labeled samples are emitted per family, not
    # per section.
    replica_pcs = [
        (idx, rs.get("prefix_cache") or {})
        for idx, rs in enumerate(snap.get("replicas") or [])
        if rs.get("prefix_cache")
    ]
    if pc:
        w.family("kafka_tpu_prefix_cache_entries", "gauge",
                 "Live prefix-cache entries (radix nodes; legacy name).")
        w.sample("kafka_tpu_prefix_cache_entries", pc.get("entries", 0))
    if "nodes" in pc or any("nodes" in r for _, r in replica_pcs):
        w.family("kafka_tpu_prefix_cache_nodes", "gauge",
                 "Radix-tree nodes (page-aligned token runs).")
        if "nodes" in pc:
            w.sample("kafka_tpu_prefix_cache_nodes", pc["nodes"])
        for idx, rpc in replica_pcs:
            if "nodes" in rpc:
                w.sample("kafka_tpu_prefix_cache_nodes", rpc["nodes"],
                         {"replica": idx})
    if "cached_pages" in pc or any("cached_pages" in r
                                   for _, r in replica_pcs):
        w.family("kafka_tpu_prefix_cache_pages", "gauge",
                 "KV pages the prefix cache currently retains.")
        if "cached_pages" in pc:
            w.sample("kafka_tpu_prefix_cache_pages", pc["cached_pages"])
        for idx, rpc in replica_pcs:
            if "cached_pages" in rpc:
                w.sample("kafka_tpu_prefix_cache_pages",
                         rpc["cached_pages"], {"replica": idx})
    if pc or replica_pcs:
        w.family("kafka_tpu_prefix_cache_total", "counter",
                 "Prefix-cache events by kind.")
        for kind in ("hits", "misses", "tokens_reused",
                     "cross_thread_hits", "host_tier_hits",
                     "shipped_hits", "object_tier_hits",
                     "evictions", "pages_evicted"):
            if kind in pc:
                w.sample("kafka_tpu_prefix_cache_total", pc[kind],
                         {"kind": kind})
        for idx, rpc in replica_pcs:
            for kind in ("hits", "misses", "tokens_reused",
                         "cross_thread_hits", "host_tier_hits",
                         "shipped_hits", "object_tier_hits",
                         "evictions", "pages_evicted"):
                if kind in rpc:
                    w.sample("kafka_tpu_prefix_cache_total", rpc[kind],
                             {"replica": idx, "kind": kind})
    if "host_nodes" in pc or "host_pages" in pc:
        w.family("kafka_tpu_prefix_cache_host_resident", "gauge",
                 "Radix runs currently demoted to the KV tier "
                 "(still matchable; promoted back on lookup).")
        for kind in ("host_nodes", "host_pages"):
            if kind in pc:
                w.sample("kafka_tpu_prefix_cache_host_resident",
                         pc[kind], {"kind": kind})

    # tiered KV cache (runtime/metrics.KV_TIER_METRIC_KEYS — the registry
    # a static test enforces in both files; tests/test_kv_tier.py)
    tier = snap.get("kv_tier") or {}
    if tier:
        w.family("kafka_tpu_kv_tier_bytes", "gauge",
                 "Tiered-KV occupancy and budget by tier.")
        for key, labels in (
            ("host_bytes", {"tier": "host", "kind": "used"}),
            ("host_budget_bytes", {"tier": "host", "kind": "budget"}),
            ("disk_bytes", {"tier": "disk", "kind": "used"}),
        ):
            if key in tier:
                w.sample("kafka_tpu_kv_tier_bytes", tier[key], labels)
        w.family("kafka_tpu_kv_tier_runs", "gauge",
                 "Demoted page runs resident per tier.")
        for key, label in (("host_runs", "host"), ("disk_runs", "disk")):
            if key in tier:
                w.sample("kafka_tpu_kv_tier_runs", tier[key],
                         {"tier": label})
        w.family("kafka_tpu_kv_tier_total", "counter",
                 "Tiered-KV events by kind.")
        for key in ("demotions", "demote_failures", "promotions",
                    "promote_failures", "host_evictions", "disk_spills",
                    "disk_loads"):
            if key in tier:
                w.sample("kafka_tpu_kv_tier_total", tier[key],
                         {"event": key})
        w.family("kafka_tpu_kv_tier_pages_total", "counter",
                 "Pages shipped between tiers by direction.")
        for key, label in (("pages_demoted", "demoted"),
                           ("pages_promoted", "promoted")):
            if key in tier:
                w.sample("kafka_tpu_kv_tier_pages_total", tier[key],
                         {"dir": label})
        w.family("kafka_tpu_kv_tier_bytes_total", "counter",
                 "Bytes shipped between tiers by direction.")
        for key, label in (("bytes_demoted", "demoted"),
                           ("bytes_promoted", "promoted")):
            if key in tier:
                w.sample("kafka_tpu_kv_tier_bytes_total", tier[key],
                         {"dir": label})

    # Object-store KV tier (runtime/metrics.OBJECT_TIER_METRIC_KEYS — the
    # registry tests/test_object_tier.py enforces in both files; present
    # only when KAFKA_TORCH_KV_OBJECT_DIR mounts the shared store).
    obj = snap.get("object_tier") or {}
    if obj:
        w.family("kafka_tpu_object_tier_bytes", "gauge",
                 "Object-store occupancy: scope=store is the SHARED "
                 "store (report once per store when aggregating "
                 "scrapes); scope=owned is this replica's references.")
        for key, scope in (("store_bytes", "store"),
                           ("owned_bytes", "owned")):
            if key in obj:
                w.sample("kafka_tpu_object_tier_bytes", obj[key],
                         {"scope": scope})
        if "store_objects" in obj:
            w.family("kafka_tpu_object_tier_objects", "gauge",
                     "Run objects resident in the shared store.")
            w.sample("kafka_tpu_object_tier_objects",
                     obj["store_objects"])
        if "object_puts" in obj:
            w.family("kafka_tpu_object_tier_puts_total", "counter",
                     "Run payloads archived into the store.")
            w.sample("kafka_tpu_object_tier_puts_total",
                     obj["object_puts"])
        if "object_gets" in obj:
            w.family("kafka_tpu_object_tier_gets_total", "counter",
                     "Run payloads fetched from the store (wakes).")
            w.sample("kafka_tpu_object_tier_gets_total",
                     obj["object_gets"])
        w.family("kafka_tpu_object_tier_bytes_total", "counter",
                 "Object-store payload bytes moved by direction.")
        for key, label in (("object_bytes_put", "put"),
                           ("object_bytes_got", "get")):
            if key in obj:
                w.sample("kafka_tpu_object_tier_bytes_total", obj[key],
                         {"dir": label})
        w.family("kafka_tpu_object_tier_failures_total", "counter",
                 "Torn/failed store operations (put = archive degraded "
                 "to plain eviction; get = wake aborted, pages freed).")
        for key, op in (("object_put_failures", "put"),
                        ("object_get_failures", "get")):
            if key in obj:
                w.sample("kafka_tpu_object_tier_failures_total",
                         obj[key], {"op": op})
        if "dedupe_hits" in obj:
            w.family("kafka_tpu_object_tier_dedupe_hits_total", "counter",
                     "Puts whose content was already present (cross-host "
                     "prefix dedupe — only a reference was added).")
            w.sample("kafka_tpu_object_tier_dedupe_hits_total",
                     obj["dedupe_hits"])
        if "wake_threads" in obj:
            w.family("kafka_tpu_object_tier_wake_threads_total",
                     "counter",
                     "Dormant threads re-materialized from their sleep "
                     "manifests (cache_source=\"object_tier\").")
            w.sample("kafka_tpu_object_tier_wake_threads_total",
                     obj["wake_threads"])
        if "wake_tokens" in obj:
            w.family("kafka_tpu_object_tier_wake_tokens_total", "counter",
                     "Tokens re-materialized by sleep-manifest wakes "
                     "(prompt tokens NOT re-prefilled).")
            w.sample("kafka_tpu_object_tier_wake_tokens_total",
                     obj["wake_tokens"])
        if "manifests_written" in obj:
            w.family("kafka_tpu_object_tier_manifests_total", "counter",
                     "Per-thread sleep manifests written.")
            w.sample("kafka_tpu_object_tier_manifests_total",
                     obj["manifests_written"])
        if "objects_released" in obj:
            w.family("kafka_tpu_object_tier_released_total", "counter",
                     "Owner references dropped (budget eviction / thread "
                     "invalidation; the last reference deletes the "
                     "object).")
            w.sample("kafka_tpu_object_tier_released_total",
                     obj["objects_released"])
        # Store-guard families: retry/deadline/breaker/scrub
        # visibility for the resilience layer around the shared store.
        if "store_retries" in obj:
            w.family("kafka_tpu_object_store_retries_total", "counter",
                     "Store ops retried by the guard (idempotent "
                     "protocol ops, bounded exponential backoff).")
            w.sample("kafka_tpu_object_store_retries_total",
                     obj["store_retries"])
        if "store_timeouts" in obj:
            w.family("kafka_tpu_object_store_timeouts_total", "counter",
                     "Store op attempts that exceeded the per-op "
                     "deadline (KAFKA_TORCH_KV_OBJECT_TIMEOUT_S).")
            w.sample("kafka_tpu_object_store_timeouts_total",
                     obj["store_timeouts"])
        if "store_breaker_opens" in obj:
            w.family("kafka_tpu_object_store_breaker_open_total",
                     "counter",
                     "Circuit-breaker open transitions (consecutive "
                     "store failures crossed the trip threshold).")
            w.sample("kafka_tpu_object_store_breaker_open_total",
                     obj["store_breaker_opens"])
        if "store_breaker_state" in obj:
            w.family("kafka_tpu_object_store_breaker_state", "gauge",
                     "Store circuit-breaker state: 0=closed, "
                     "1=half-open, 2=open (ops fast-fail).")
            w.sample("kafka_tpu_object_store_breaker_state",
                     obj["store_breaker_state"])
        if "store_probe_neg_cached" in obj:
            w.family("kafka_tpu_object_store_probe_neg_cached_total",
                     "counter",
                     "Manifest probes answered from the negative cache "
                     "while the store is unhealthy (zero store RTT on "
                     "the submit path).")
            w.sample("kafka_tpu_object_store_probe_neg_cached_total",
                     obj["store_probe_neg_cached"])
        if "store_scrub_repairs" in obj:
            w.family("kafka_tpu_object_store_scrub_repairs_total",
                     "counter",
                     "Crash-window orphans repaired by the scrubber "
                     "(ref-less objects, dangling refs, dead "
                     "manifests).")
            w.sample("kafka_tpu_object_store_scrub_repairs_total",
                     obj["store_scrub_repairs"])
        # Wake-prefetch families: object GETs started at
        # submit time so the store RTT overlaps queue wait.
        if "prefetch_hits" in obj:
            w.family("kafka_tpu_object_tier_prefetch_total", "counter",
                     "Wake-prefetch outcomes: hit = staged payload "
                     "consumed by admission (zero fetch RTT); wasted = "
                     "staged/fetched but dropped (cancel, budget "
                     "eviction, superseded).")
            w.sample("kafka_tpu_object_tier_prefetch_total",
                     obj["prefetch_hits"], {"outcome": "hit"})
            if "prefetch_wasted" in obj:
                w.sample("kafka_tpu_object_tier_prefetch_total",
                         obj["prefetch_wasted"], {"outcome": "wasted"})
        if "prefetch_bytes" in obj:
            w.family("kafka_tpu_object_tier_prefetch_bytes_total",
                     "counter",
                     "Run payload bytes staged by wake prefetch.")
            w.sample("kafka_tpu_object_tier_prefetch_bytes_total",
                     obj["prefetch_bytes"])
        if "prefetch_inflight" in obj:
            w.family("kafka_tpu_object_tier_prefetch_inflight", "gauge",
                     "Prefetch GETs scheduled but not yet resolved.")
            w.sample("kafka_tpu_object_tier_prefetch_inflight",
                     obj["prefetch_inflight"])

    # Disaggregated prefill/decode (runtime/metrics.DISAGG_METRIC_KEYS —
    # the registry a static test enforces in both files; present only
    # when KAFKA_TORCH_DP_ROLES configures role pools).  Ship counters by
    # direction-less kind, the torn-copy failure counter the chaos
    # acceptance keys on, fallback counters, the ship-latency histogram,
    # and per-pool occupancy gauges the pool-sizing autoscaler reads.
    disagg = snap.get("disagg") or {}
    if disagg:
        for name, key, help_text in (
            ("kafka_tpu_disagg_shipped_runs_total", "disagg_shipped_runs",
             "Page runs shipped from prefill-pool to decode-pool "
             "replicas."),
            ("kafka_tpu_disagg_shipped_pages_total",
             "disagg_shipped_pages", "KV pages shipped across replicas."),
            ("kafka_tpu_disagg_shipped_bytes_total",
             "disagg_shipped_bytes",
             "Bytes shipped across replicas (real, unpadded)."),
            ("kafka_tpu_disagg_ship_failures_total",
             "disagg_ship_failures",
             "Torn/failed cross-replica ships (thread degraded to "
             "re-prefill; never partial KV)."),
        ):
            if key in disagg:
                w.family(name, "counter", help_text)
                w.sample(name, disagg[key])
        w.family("kafka_tpu_disagg_fallback_total", "counter",
                 "Hand-off fallbacks by kind: prefill_in_place = short "
                 "prompts served colocated on the decode pool; "
                 "ship_skip = hand-offs completed without a copy "
                 "(destination warm / no pages / sole survivor).")
        for key, kind in (("disagg_prefill_in_place", "prefill_in_place"),
                          ("disagg_ship_skips", "ship_skip")):
            if key in disagg:
                w.sample("kafka_tpu_disagg_fallback_total", disagg[key],
                         {"kind": kind})
        if "disagg_handoffs" in disagg:
            w.family("kafka_tpu_disagg_handoffs_total", "counter",
                     "Prefill-and-hand-off completions (shipped or "
                     "degraded).")
            w.sample("kafka_tpu_disagg_handoffs_total",
                     disagg["disagg_handoffs"])
        # Ship-transport dimension: which transport moved each
        # run — host + device sum to shipped_runs — plus the host-staging
        # high-water gauge (0 under the device transport).
        w.family("kafka_tpu_disagg_ship_runs_by_transport_total",
                 "counter",
                 "Shipped runs by transport: host = staged through a "
                 "numpy copy; device = device-to-device (zero host "
                 "materialization).")
        for key, transport in (("disagg_ship_host_runs", "host"),
                               ("disagg_ship_device_runs", "device")):
            if key in disagg:
                w.sample("kafka_tpu_disagg_ship_runs_by_transport_total",
                         disagg[key], {"transport": transport})
        if "disagg_ship_staging_bytes" in disagg:
            w.family("kafka_tpu_disagg_ship_staging_bytes", "gauge",
                     "Peak host bytes pinned by host-staged ship chunks "
                     "since the last scrape (peak-since-last, re-armed "
                     "on read).")
            w.sample("kafka_tpu_disagg_ship_staging_bytes",
                     disagg["disagg_ship_staging_bytes"])
        if "ship_ms" in disagg:
            w.histogram_family(
                "kafka_tpu_disagg_ship_milliseconds",
                "Cross-replica page-run ship latency (host-staged "
                "gather+scatter, per run).",
                [({}, disagg["ship_ms"])],
            )
        pools = disagg.get("pools") or []
        if pools:
            # one pass per family so each sample name stays a single
            # contiguous group (exposition rule, enforced by the parser)
            w.family("kafka_tpu_disagg_pool_replicas", "gauge",
                     "Replicas per role pool.")
            for pool in pools:
                w.sample("kafka_tpu_disagg_pool_replicas",
                         len(pool.get("replicas") or []),
                         {"role": pool.get("role", "")})
            w.family("kafka_tpu_disagg_pool_queue_depth", "gauge",
                     "Waiting-queue depth per role pool.")
            for pool in pools:
                w.sample("kafka_tpu_disagg_pool_queue_depth",
                         pool.get("queue_depth", 0),
                         {"role": pool.get("role", "")})
            w.family("kafka_tpu_disagg_pool_occupancy", "gauge",
                     "Mean busy decode slots per step, per role pool.")
            for pool in pools:
                w.sample("kafka_tpu_disagg_pool_occupancy",
                         pool.get("batch_occupancy", 0),
                         {"role": pool.get("role", "")})

    # Flight-recorder anomaly detectors (runtime/metrics.ANOMALY_METRIC_
    # KEYS — the registry a static test enforces in both files).  The
    # counters are edge-triggered firings; the gauge is how many
    # detectors are CURRENTLY firing (the autoscaler's "don't scale on
    # stale math" input, also in /admin/signals).
    anom = snap.get("anomalies") or {}
    if anom:
        w.family("kafka_tpu_anomalies_total", "counter",
                 "Scheduler anomaly detector firings by kind "
                 "(edge-triggered).")
        for key, kind in (
            ("anomaly_queue_stall", "queue_stall"),
            ("anomaly_fetch_starvation", "fetch_starvation"),
            ("anomaly_mfu_collapse", "mfu_collapse"),
            ("anomaly_prefill_convoy", "prefill_convoy"),
            ("anomaly_compile_storm", "compile_storm"),
            ("anomaly_hbm_pressure", "hbm_pressure"),
        ):
            if key in anom:
                w.sample("kafka_tpu_anomalies_total", anom[key],
                         {"kind": kind})
        if "anomalies_active" in anom:
            w.family("kafka_tpu_anomalies_active", "gauge",
                     "Anomaly detectors currently firing.")
            w.sample("kafka_tpu_anomalies_active",
                     anom["anomalies_active"])

    # Flight recorder ring state (runtime/metrics.FLIGHT_METRIC_KEYS);
    # the record contents live at GET /debug/flight/{replica}
    fl = snap.get("flight") or {}
    if fl:
        w.family("kafka_tpu_flight_ring_size", "gauge",
                 "Configured flight-recorder ring length (records; "
                 "summed across DP replicas).")
        w.sample("kafka_tpu_flight_ring_size",
                 fl.get("flight_ring_size", 0))
        w.family("kafka_tpu_flight_records_total", "counter",
                 "Scheduler iterations recorded by the flight recorder.")
        w.sample("kafka_tpu_flight_records_total",
                 fl.get("flight_records", 0))
        w.family("kafka_tpu_flight_postmortems_total", "counter",
                 "Flight-recorder postmortem dumps written.")
        w.sample("kafka_tpu_flight_postmortems_total",
                 fl.get("flight_postmortems", 0))

    # Autoscaler control loop (runtime/metrics.AUTOSCALER_METRIC_KEYS —
    # the registry tests/test_autoscaler.py enforces in both files;
    # present only when KAFKA_TORCH_AUTOSCALE runs a controller).  Event
    # counters under one family; the ladder rung and last-observed dp
    # are gauges a dashboard alerts on directly.
    scaler = snap.get("autoscaler") or {}
    if scaler:
        w.family("kafka_tpu_autoscaler_events_total", "counter",
                 "Autoscaler control-loop events by kind.")
        for key, event in (
            ("autoscaler_polls", "poll"),
            ("autoscaler_scale_outs", "scale_out"),
            ("autoscaler_scale_ins", "scale_in"),
            ("autoscaler_resize_failures", "resize_failure"),
            ("autoscaler_degrades", "degrade"),
            ("autoscaler_recovers", "recover"),
            ("autoscaler_vetoes", "veto"),
            ("autoscaler_drains", "drain"),
        ):
            if key in scaler:
                w.sample("kafka_tpu_autoscaler_events_total",
                         scaler[key], {"event": event})
        if "autoscaler_ladder_level" in scaler:
            w.family("kafka_tpu_autoscaler_ladder_level", "gauge",
                     "Current degradation-ladder rung (0 = normal).")
            w.sample("kafka_tpu_autoscaler_ladder_level",
                     scaler["autoscaler_ladder_level"])
        if "autoscaler_dp" in scaler:
            w.family("kafka_tpu_autoscaler_dp", "gauge",
                     "dp at the controller's last signal poll.")
            w.sample("kafka_tpu_autoscaler_dp", scaler["autoscaler_dp"])

    # Compile observatory (runtime/metrics.COMPILE_METRIC_KEYS — the
    # registry tests/test_device_truth.py enforces in both files;
    # process-wide, merged into the snapshot by server/app.py).  The
    # total counter carries the {cache, phase} label matrices; the
    # storm gauge is the autoscaler's "don't resize mid-storm" input.
    comp = snap.get("compiles") or {}
    if comp:
        w.family("kafka_tpu_compiles_total", "counter",
                 "Compilations observed (CUDA-graph captures, nvcc "
                 "builds), by cache disposition and engine phase.")
        for cache, n in (comp.get("by_cache") or {}).items():
            w.sample("kafka_tpu_compiles_total", n, {"cache": cache})
        for phase, n in (comp.get("by_phase") or {}).items():
            w.sample("kafka_tpu_compiles_total", n, {"phase": phase})
        if "compile_seconds_total" in comp:
            w.family("kafka_tpu_compile_seconds_total", "counter",
                     "Wall-clock seconds spent compiling.")
            w.sample("kafka_tpu_compile_seconds_total",
                     comp["compile_seconds_total"])
        if "compile_storm_active" in comp:
            w.family("kafka_tpu_compile_storm_active", "gauge",
                     "Compile storm condition currently held "
                     "(recompiles under live traffic).")
            w.sample("kafka_tpu_compile_storm_active",
                     comp["compile_storm_active"])
        if "compile_storms_total" in comp:
            w.family("kafka_tpu_compile_storms_total", "counter",
                     "Compile storm episodes entered.")
            w.sample("kafka_tpu_compile_storms_total",
                     comp["compile_storms_total"])

    # Live HBM accounting (runtime/metrics.MEMORY_METRIC_KEYS, fed by
    # runtime/planner.MemoryMonitor at step cadence).  Gauges are the
    # worst device's numbers; the component family reconciles measured
    # bytes against the MemoryPlan's line items.
    mem = snap.get("memory") or {}
    if mem:
        for key, help_text in (
            ("hbm_bytes_in_use", "Live HBM bytes in use (worst "
             "device; source=plan on chips without memory_stats)."),
            ("hbm_bytes_peak", "Peak HBM bytes in use (worst device)."),
            ("hbm_bytes_limit", "HBM byte limit (smallest device)."),
            ("hbm_headroom_bytes", "Measured HBM headroom: limit - "
             "in_use (size against this, not the plan)."),
            ("hbm_plan_skew", "Measured bytes / MemoryPlan predicted "
             "bytes (1.0 = the plan was right)."),
            ("hbm_pressure", "Headroom under the watermark "
             "(KAFKA_TORCH_HBM_WATERMARK)."),
        ):
            if key in mem:
                w.family(f"kafka_tpu_{key}", "gauge", help_text)
                w.sample(f"kafka_tpu_{key}", mem[key])
        components = mem.get("hbm_component_bytes") or {}
        if components:
            w.family("kafka_tpu_hbm_component_bytes", "gauge",
                     "HBM attribution by MemoryPlan line item "
                     "(unattributed = measured residual: gather "
                     "staging, scratch, fragmentation).")
            for comp_name, b in components.items():
                w.sample("kafka_tpu_hbm_component_bytes", b,
                         {"component": comp_name})

    # Agent-native scheduling (runtime/metrics.AGENT_METRIC_KEYS — the
    # registry tests/test_agent_sched.py enforces in both files; all
    # zeros unless KAFKA_TORCH_AGENT_DEMOTE is set or background-class
    # requests ran).  Event counters under one family; the awaiting /
    # queue-depth gauges stand alone so the autoscaler contract
    # ("awaiting-tool threads are not load") reads directly.
    ag = snap.get("agent") or {}
    if ag:
        w.family("kafka_tpu_agent_events_total", "counter",
                 "Agent tool-gap scheduling events by kind.")
        for key, event in (
            ("agent_gaps", "gap"),
            ("agent_gap_demotions", "demote"),
            ("agent_gap_cancelled", "cancel"),
            ("agent_hint_hits", "hint_hit"),
            ("agent_hint_misses", "hint_miss"),
        ):
            if key in ag:
                w.sample("kafka_tpu_agent_events_total", ag[key],
                         {"event": event})
        if "agent_gap_pages_demoted" in ag:
            w.family("kafka_tpu_agent_gap_pages_demoted_total", "counter",
                     "KV pages freed from HBM by tool-gap demotions.")
            w.sample("kafka_tpu_agent_gap_pages_demoted_total",
                     ag["agent_gap_pages_demoted"])
        if "agent_gap_bytes_demoted" in ag:
            w.family("kafka_tpu_agent_gap_bytes_demoted_total", "counter",
                     "KV bytes moved down-tier by tool-gap demotions.")
            w.sample("kafka_tpu_agent_gap_bytes_demoted_total",
                     ag["agent_gap_bytes_demoted"])
        if "agent_awaiting_threads" in ag:
            w.family("kafka_tpu_agent_awaiting_threads", "gauge",
                     "Threads mid-tool-gap (lingering or demoted); not "
                     "load — the autoscaler must not count them.")
            w.sample("kafka_tpu_agent_awaiting_threads",
                     ag["agent_awaiting_threads"])
        if "agent_awaiting_bytes" in ag:
            w.family("kafka_tpu_agent_awaiting_bytes", "gauge",
                     "Demoted KV bytes parked in lower tiers awaiting "
                     "a tool return.")
            w.sample("kafka_tpu_agent_awaiting_bytes",
                     ag["agent_awaiting_bytes"])
        if "bg_queue_depth" in ag:
            w.family("kafka_tpu_bg_queue_depth", "gauge",
                     "Background-class requests queued (admit only "
                     "into idle capacity).")
            w.sample("kafka_tpu_bg_queue_depth", ag["bg_queue_depth"])
        w.family("kafka_tpu_bg_events_total", "counter",
                 "Background-class scheduling events by kind.")
        for key, event in (
            ("bg_admitted", "admit"),
            ("bg_chunks", "chunk"),
            ("bg_yields", "yield"),
        ):
            if key in ag:
                w.sample("kafka_tpu_bg_events_total", ag[key],
                         {"event": event})

    sandbox = snap.get("sandbox") or {}
    if sandbox:
        w.family("kafka_tpu_sandbox_total", "counter",
                 "Sandbox subprocess supervision events.")
        for kind, v in sandbox.items():
            w.sample("kafka_tpu_sandbox_total", v, {"event": kind})

    sup = snap.get("replica_supervisor") or {}
    if sup:
        w.family("kafka_tpu_replica_health", "gauge",
                 "Per-replica health (1 healthy, 0.5 probation, 0 out).")
        for i, g in enumerate(sup.get("health", [])):
            w.sample("kafka_tpu_replica_health", g, {"replica": i})
        w.family("kafka_tpu_replica_supervisor_total", "counter",
                 "Replica supervision events.")
        for kind in ("quarantines", "readmits", "waiting_migrated",
                     "affinity_resteered", "rebuilds",
                     "replica_rebuilds"):
            if kind in sup:
                w.sample("kafka_tpu_replica_supervisor_total", sup[kind],
                         {"event": kind})

    tr = snap.get("tracing") or {}
    if tr:
        w.family("kafka_tpu_traces_total", "counter",
                 "Traces started since boot.")
        w.sample("kafka_tpu_traces_total", tr.get("traces", 0))
        w.family("kafka_tpu_stitched_spans_total", "counter",
                 "Cross-process spans stitched into parent traces.")
        w.sample("kafka_tpu_stitched_spans_total",
                 tr.get("stitched_spans", 0))

    return w.render()
