#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (kafka_tpu_torch) on one H100.

    python3 chip_smoke.py            # every phase, one card

Phases, each of which raises (non-zero exit) on any failure:
  0. build   — compiles every CUDA kernel of the main path from
               kafka_tpu_torch/csrc with nvcc for sm_90a, one nvcc per
               source, all started together; logs each kernel function's
               ptxas registers and spill bytes, and K2's and K5's HMMA
               counts from cuobjdump -sass.  K2 and K5 must not spill and
               must use the tensor cores.
  1. kernels — each kernel (K1 paged decode, K2 flash prefill, K3 paged
               verify, K4 int8 paged decode, K5 fused decode MLP in bf16
               and int8) against its plain PyTorch version on the card at
               Llama-3.2-1B geometry (Hq 32, Hkv 8, D 64, page 16; K3 at
               the K = 4 verify shape; K4 at K1's shape over an int8 pool;
               K5 at H 2048, F 8192), then timed beside its plain
               version, its bound and a PyTorch library call
               (scaled_dot_product_attention on the gathered window — a
               yardstick only; the port never calls it; K5 has none and
               is timed beside the port's torch formulation instead).
               K1 runs at the ragged head case and every case of K1_CASES
               (all lanes at 2,047 tokens, all <= 32 tokens, windows on
               chunk and page boundaries, trash lanes, G 8, G 1, D 128),
               each held elementwise and per row and timed (CUDA events
               and profiler device time, SDPA's too); a planted
               dropped-chunk fault must fail the row check.
               K3 runs at the ragged head case (S 5) and every case of
               K3_CASES (all lanes at ~2,040 tokens, all <= 32 slots,
               windows on chunk and page boundaries, trash lanes, G 8 at
               S 5, G 4 at S 9 and S 17 — the speculative_k 8 and 16 of
               fault C4 —, G 8 at S 17, D 128), K4 at K1's eight cases
               over int8 pools (K4_CASES); each held elementwise and per
               row (K3's rows j >= q_len must be zeros), each with a
               planted dropped-chunk fault that must fail the row check,
               each timed with CUDA events and with the profiler's device
               time, the L2 warm and flushed, beside SDPA's device time
               and the bound (K4 also at 256-token chunks).
               K2 runs at every shape of K2_CASES (the engine's and the
               agent turn's chunks, short and long, and D 128), with the
               launcher's block shape and each shape pinned, held
               elementwise and per row, rows past chunk_len checked to be
               zeros; a planted dropped-tile fault must fail the row check.
               K5 is held to its plain version at B 1, 8, 9 and 64 in bf16
               and int8 (K5_ATOL) and timed at each with the L2 warm and
               flushed; it is not on the serving path (as in the JAX
               package): its path is a 16-layer decode MLP sweep through
               the function at B 8, held to the port's torch formulation
               (LOGITS_RTOL) and timed per layer with the weights read
               from device memory.
  2. engine  — the engine at full llama-3.2-1b width (bf16, vocab 128256,
               random weights from --seed): eight greedy requests, one
               submitted alone and longer than the largest prefill bucket
               (so it chunks through the flash prefill kernel), then seven
               together.  Both kernel launch counters must move (K1's
               counts graph replays: every decode is a replay of a
               captured step program, and a replay of a k-step graph adds
               k x 16 layers to K1's counter).  The same
               requests run through a plain-attention engine on the same
               weights; logits must agree within the stated bf16 tolerance
               and the token agreement is printed.  Then (a) the same
               requests on an engine with speculative_k = 4 and fetch_lag
               0 (every dispatch drains in its own step, so a lane with a
               proposal proposes at once) whose proposers offer the first
               engine's own continuation: verify steps must run, K3 must
               launch, tokens must be accepted, and the emitted
               positions' logits must agree with the spec-off engine's;
               then on that engine a device-FSM grammar lane (the idle
               tool, tool_choice "required") whose proposer offers the
               spec-off engine's stream for it: the verify step's grammar
               branch must run and accept, the stream equal the spec-off
               one (or part at a bf16 near-tie) and the text be a valid
               tool call;
               (a') the same at speculative_k = 8 (fault C4: 36 query rows
               per kv head): K3 must launch, and the greedy streams must
               equal the spec-off streams wherever the spec-off logits
               are not a bf16 near-tie (they may part only where the two
               tokens' margin is within twice the logits' difference);
               (b) a two-turn thread on the first engine: turn 2 must hit
               the prefix cache and prefill from past the cached pages
               (K2 at start > 0).  (c) int8 serving: the same weights
               quantized per output channel and an int8 KV pool; decode
               must launch K4 (and no K1 or K2), logits must agree with
               the same int8 engine on plain attention, and the int8
               model's logit quality against the bf16 model must hold the
               analytic flip bound (flip_margin_max <= 2 max|dlogit|).
  2b. graphs — the decode pipeline at full llama-3.2-1b width (bf16,
               random weights from --seed, page 16, 2048 window, kernel
               attention): eight greedy requests through engines at
               multi_step 1 and 16, through the same engine class running
               its step body eagerly instead of replaying graphs, and
               through plain attention.  The three streams must be equal,
               the logits within LOGITS_RTOL of plain attention's (max|d|
               against the eager body printed); K1's counter must equal
               (replayed steps + each capture's warm-up steps) x 16 layers
               (bookkeeping: the proof that the replays ran K1 is their
               logits equal to the eager body's bit for bit, which is
               asserted, and the K1 and K4 chunk-kernel events the
               profiler catches inside replays, which must be > 0);
               the 16-step engine must fuse.  A sampled lane (temperature
               0.8, top_p 0.95) riding fused bursts must give the eager
               body's stream; 12 requests on 8 slots must bring the four
               parked requests' first tokens to the host while every slot
               lane still holds its slot.  Then the profile at 8 lanes x
               ~256 tokens for bf16 and for int8 weights + int8 KV at
               multi_step 1 and 16: host-clock ms per step and per
               generated token over a steady window ending in a
               synchronize, device ms per step from CUDA events around
               each replay, the device busy share and tokens/s; the int8
               engines' K4 counter is checked like K1's.  And the host's
               own cost per step() and per replay call at 8 and 32 lanes,
               multi_step 1 and 16, with no fetch popped in the window.
  3. server  — served at the reference's fused depth
               (ServingConfig.multi_step 16).  First fault C5: the tiny_model=True (float32, D 16) server on
               the card, which the kernels cannot take: "auto" must
               resolve to plain attention with logged reasons, the
               provider must report attention_backend "plain", and one
               streamed thread turn must end with `data: [DONE]` without a
               kernel launch.  Then the HTTP server built by create_app for llama-3.2-1b as the
               provider builder does with no checkpoint: byte tokenizer, so
               the vocab is 262 (full width otherwise), serving the agent
               turn with the built-in tools at a 4096-token window with
               prefill buckets up to 2048.  In-process on a free port: two
               streamed turns on one thread (turn 1's prompt must hold the
               tool schemas and its host-clock TTFT is logged; each turn
               must end in agent_done with a reason of the reference's
               set; the second turn's prompt holds the first and must
               report prompt_tokens_details.cached_tokens; the history
               must read user, assistant, user, assistant) and one
               streamed /v1/chat/completions.  Every stream must end with
               `data: [DONE]`, and both kernel counters must move.  Then
               one streamed request to a second server configured with
               KAFKA_TORCH_SPECULATIVE_K=4, and two streamed turns on one
               thread to a third configured with KAFKA_TORCH_QUANTIZE=int8
               and KAFKA_TORCH_KV_QUANTIZE=int8 (both with no tools but the
               agent's idle tool, at 2048-token windows): turn 2 must
               report cached tokens and K4 must launch.  Constrained
               decoding (fault C3): a server with no tools but the idle
               tool and no prefix cache serves greedy thread turns with
               tool_choice "required" and a named function; each must be
               one model turn ending finish_reason "tool_calls" whose
               text validate_tool_call_json accepts, run on the device
               FSM (FSM tokens > 0, host-mask steps 0, model vocab ==
               tokenizer vocab); the "required" turn again with
               KAFKA_TORCH_GRAMMAR_ONDEVICE=0 must take the host mask and
               give the same tokens; and the speculative server's
               "required" turn (a grammar lane whose proposer offers those
               tokens, the engine at fetch_lag 0) must give them too, with
               verify steps run and tokens accepted; the speculative
               request must run verify steps as well.
               Turn 1 of the built-in-tools server carries X-Request-Id:
               its span tree from /debug/trace breaks its TTFT down
               (serving layer, engine.queue, engine.prefill, emit).
               Then the thread API on a server of the same configuration
               with an API token, `python -m kafka_tpu_torch.sandbox.server`
               as a subprocess and the stub MCP server over stdio (their
               tools only: beside the built-in ones they would not fit the
               4096 window): a request without the token gets 401; signup,
               login, a profile, a thread created from it and its config
               set; a streamed agent/run forcing `create_shell` (its
               arguments carry no command) and one forcing the MCP `echo`,
               each ending with the tool's result, agent_done and [DONE],
               both tool messages in the history; the cold run's span
               tree; then `engine.step=error(chip):nth=2` armed once four
               streams have each had 16 tokens and decode in fused graphs
               with the fetch FIFO at least half full: every stream must
               end with an error event and
               [DONE], no event may follow a terminal one, /health's
               free_pages must return to idle, and the next turn's tokens
               must equal the same turn before the failure (recovery and
               recapture times logged); last a thread DELETE (404 after)
               and a shutdown with a stream in flight, which must still
               end with agent_done and [DONE].  The graphs phase also runs
               its bf16 profile and the 8-lane host cost with every
               request traced; traced decode must stay device-bound
               (busy share >= TRACED_BUSY_MIN).
  4. telemetry — run first, after the builds, in the same process as
               the phases after it: its memory gate reads a fresh
               caching allocator, and the later phases' gates (the
               graphs phase's busy shares) read the main path after
               the kernel sampler's and /debug/profile's profiler
               windows.  When it ends no Python thread it started
               and no profiler session may be left.  The profiler's
               catch on a bare loop of 200 K1 launches (CUDA events;
               torch.profiler with acc_events on and off; kernel sampler
               windows).  Then the llama-3.2-1b
               bf16 server (tools=[], 2048 window, multi_step 16) with
               the flight ring, the compile ring and the kernel sampler
               (every 8th step) on: eight concurrent streamed thread
               turns, then sequential ones until the sampler has named
               K1 and K2; /metrics (MFU and bandwidth utilization in
               (0, UTIL_MAX] over every window of every kind that
               dispatched, the roofline the H100's datasheet figures),
               the Prometheus text under the reference checker's rules,
               /admin/signals, /debug/kernels (K1 and K2 named, decode
               kernel_skew finite), /debug/compiles (this run's nvcc
               builds and graph captures by phase), /debug/flight/0
               (records with causes), /debug/profile, an engine.step
               failure that must write a postmortem, and the memory plan:
               its weights and KV pool against the engine's own tensors
               (PLAN_EXACT), its total against the server's growth of
               memory_reserved less the graph pools and the allocator's
               cache of freed blocks (PLAN_MARGIN).  Then one
               turn each on an int8 (weights + KV) and a speculative
               (speculative_k 4, fetch_lag 0) server, under the same
               utilization gates, and the decode step at 8 lanes with
               the flight ring on and off at multi_step 16 and 1: busy
               >= FLIGHT_BUSY_MIN with the ring on, and the registry's
               decode bandwidth utilization over the window within
               HBM_AGREE of the window's modeled bytes over its CUDA-event
               time.  The kernels' launches on these servers are recorded
               as `telemetry_launches`.

Output: progress lines, then a `{"kernels": [...]}` JSON line, the card's
`nvidia-smi --query-gpu=name,power.limit` line, and last
`{"ok": true, "device": {...}}`.  The full record also goes to
chiprun_out/chip_smoke.json.  Without CUDA, or without the package beside
it, the script exits non-zero and prints no result.

Comparing two trees on one card: unpack the other commit (`git archive`)
into a git-ignored directory and run, in one call,
    python3 chip_smoke.py --phases attention,mlp --root DIR --out base.json
    python3 chip_smoke.py --phases attention,mlp --out new.json
(and the two again, in reverse order): both time the K3, K4 and K5 cases
on the same inputs (made from --seed); the first with DIR's kernels.
`--phases kernels --root DIR` does the same for all five.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor rate and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs plain version on the same bf16 inputs: both accumulate in f32
# and round the [.., D] output to bf16, whose ulp is 2^-7 of |x| at worst;
# the plain version also rounds the probabilities to bf16 before PV (the
# JAX recipe).  Held to |kernel - plain| <= ATOL + RTOL * |plain|: two
# ulps relative, plus an absolute floor for outputs near zero.
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2.0 ** -7
# K2 per (row, head): ||kernel - plain|| / ||plain|| along D.  Both round
# the output to bf16 (2^-9 relative on average) and the probabilities
# at different points, so a sound row reads a few 2^-9; a row of ~2000
# random keys that lost one 64-token tile reads ~0.5 (planted_tile_fault).
K2_ROW_RTOL = 0.02
# Engine logits, kernel engine vs plain engine (bf16 weights, 16 layers):
# attention outputs differ at bf16 rounding and the difference propagates
# through the residual stream; held to 5% of the largest |logit|.
LOGITS_RTOL = 0.05
# K5 against its plain version: both round at the JAX kernel's points and
# differ by f32 summation order, so a bf16 rounding may land one ulp apart
# (2^-7 relative) inside the MLP and move the output; held to the JAX
# package's own kernel tolerance (tests/test_fused_mlp.py).
K5_ATOL = 0.05
KERNEL_KEYS = ("K1", "K2", "K3", "K4", "K5", "K5_int8")
# decode busy share with every request traced (graphs phase): spans are
# stamped on the host as fetches land, so the device stays the bound; an
# untraced window reads 0.992-0.997 on the card
TRACED_BUSY_MIN = 0.97

RESULTS: dict = {}
# a baseline run (--root): the kernels of another checkout, timed on the
# same inputs; a case its wrappers refuse is recorded, not failed
BASELINE = False


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name_part, iters: int = 20, flush=None, span_from=None):
    """Device time per call of the CUDA kernels whose name holds
    name_part (None: of every kernel the call runs), from torch.profiler
    (excludes the wrapper's host work).  flush: run before every call (an
    L2 flush, so each call finds its inputs in device memory; its own
    kernels must not match name_part).

    Each kernel is averaged over the launches the profile caught, times
    its launches per call: a profile may drop events (now and then all of
    them), and a sum over the caught ones divided by `iters` reads low.
    Profiles that dropped events are listed in RESULTS["profile_drops"].

    span_from: for a call whose launches overlap (K5's passes start while
    the launch before them finishes), the span from the start of its
    first kernel (name holds span_from) to the end of its last kernel,
    averaged over the calls the profile caught whole, instead of the sum
    of kernel durations, which would count the overlap twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        if span_from is not None:
            ms = _span_ms(prof, span_from, name_part, iters)
            if ms is not None:
                return ms
            continue
        cuda = [e for e in prof.key_averages() if e.count and
                e.device_type == torch.autograd.DeviceType.CUDA]
        rows = [e for e in cuda if name_part is None or name_part in e.key]
        if not rows:  # none launched (a lane set with no merge), or lost
            if not cuda:
                RESULTS.setdefault("profile_drops", []).append(
                    {"kernels": name_part, "caught": 0.0})
            continue
        caught = min(e.count for e in rows) / iters
        RESULTS.setdefault("profile_caught", []).append(caught)
        if caught < 1:
            RESULTS.setdefault("profile_drops", []).append(
                {"kernels": name_part, "caught": caught})
        return sum(
            getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
            / e.count * max(1, round(e.count / iters)) for e in rows) / 1e3
    return None


def _span_ms(prof, first: str, name_part: str, iters: int):
    """device_ms's span mode over one profile: the calls split where a
    kernel named `first` starts, those caught whole averaged."""
    import torch

    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and name_part in e.name),
                 key=lambda e: e.time_range.start)
    calls, cur = [], []
    for e in evs:
        if first in e.name and cur:
            calls.append(cur)
            cur = []
        cur.append(e)
    if cur:
        calls.append(cur)
    n = max((len(c) for c in calls), default=0)
    whole = [c for c in calls if len(c) == n and first in c[0].name]
    if len(whole) < iters:
        RESULTS.setdefault("profile_drops", []).append(
            {"kernels": name_part, "caught": len(whole) / iters})
    if not whole:
        return None
    return sum(max(e.time_range.end for e in c) - c[0].time_range.start
               for c in whole) / len(whole) / 1e3


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device wall time per call of fn: `reps` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events.  No host launch
    gaps, and launches that overlap (K5's passes) counted once."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


_FLUSH = []


def flush_l2(read_only: bool = False) -> None:
    """Pass 128 MB, more than the H100's 50 MB L2, through it, so the
    next call reads its inputs from device memory.  By default an
    overwrite (a fill kernel: no "paged_" or "mlp_" in its name), which
    leaves the L2 full of dirty lines; read_only: a sum over the buffer
    instead, which leaves it full of clean ones."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.zeros(128 << 20, dtype=torch.uint8,
                                  device="cuda"))
    if read_only:
        _FLUSH[0].sum()
    else:
        _FLUSH[0].zero_()


def check_close(name: str, got, want) -> float:
    """max |got - want|; raises past ATOL + RTOL * |want|."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - KERNEL_RTOL * want.float().abs()).max().item()
    log(f"{name} max_abs_err={err:.3e} (tol {KERNEL_ATOL} + "
        f"{KERNEL_RTOL:.4g}*|plain|)")
    if not excess <= KERNEL_ATOL:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max_abs_err {err}, excess {excess}")
    return err


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_HBM_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(seed: int, only: str = "") -> None:
    """Phase 1.  only="attention": K3 and K4 alone (their cases, timed);
    only="mlp": K5 alone; the inputs the same as in the full phase."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    Hq, Hkv, D, ps = 32, 8, 64, 16
    HD = Hkv * D

    # K1: B=8, shuffled page tables, ragged lengths on and around page
    # boundaries, lane 7 a trash lane (table row all page 0)
    B, P = 8, 128
    num_pages = B * P + 1
    k_pool = torch.randn(num_pages * ps, HD, generator=gen, device=dev
                         ).to(torch.bfloat16)
    v_pool = torch.randn(num_pages * ps, HD, generator=gen, device=dev
                         ).to(torch.bfloat16)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    table = perm.view(B, P).to(torch.int32).contiguous()
    table[7] = 0
    seq_lens = torch.tensor([15, 16, 31, 255, 511, 700, 2046, 5],
                            dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, table, seq_lens)
    # the other cases of K1, K3 and K4, and K5, draw from generators of
    # their own, so each kernel's inputs do not depend on which ran before
    if not only:
        kernel_k1(args, torch.Generator(device=dev).manual_seed(seed + 1))
        kernel_k2(k_pool, v_pool, gen)
    if only in ("", "attention"):
        kernel_k3(args, torch.Generator(device=dev).manual_seed(seed + 3))
        kernel_k4(args, torch.Generator(device=dev).manual_seed(seed + 4))
    if only in ("", "mlp"):
        kernel_k5(torch.Generator(device=dev).manual_seed(seed + 5))
    if only:
        return
    for k in KERNEL_KEYS:
        r = RESULTS[k]
        lib = r["library_ms"]
        log(f"{k} {r['name']}: {r['ms']:.4f} ms (device {r['device_ms']}, "
            f"plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.5f} by {r['bound_by']}, library "
            f"{'none' if lib is None else f'{lib:.4f}'}"
            f" (device {r.get('library_device_ms')})"
            + (f", torch formulation {r['torch_ms']:.4f}"
               if "torch_ms" in r else "") + f") at {r['shape']}")


# K1 cases beside the ragged head case (B 8, lengths 15..2046 on and
# around page boundaries, lane 7 a trash lane): (label, Hq, Hkv, D, table
# pages P, seq_lens, trash lanes).  Every lane at 2,047 tokens; every lane
# at <= 32 tokens in a 128-token window (one chunk per lane, no merge
# launch); windows ending on chunk (128-token) and page boundaries; two
# trash lanes with long lengths; G 8; G 1; and Llama-3.1-8B's geometry
# (D 128).  Together they launch both templates (D 64, D 128), the merge
# and its absence, and G 1, 4 and 8.
K1_CASES = (
    ("long", 32, 8, 64, 128, [2046] * 8, ()),
    ("short", 32, 8, 64, 8, [0, 1, 7, 15, 16, 17, 30, 31], ()),
    ("boundaries", 32, 8, 64, 128,
     [127, 128, 126, 255, 15, 16, 1023, 2047], ()),
    ("trash", 32, 8, 64, 128, [900, 40, 2046, 300, 1500, 7, 64, 511],
     (1, 4)),
    ("G8", 64, 8, 64, 128, [15, 16, 31, 255, 511, 700, 2046, 5], ()),
    ("G1", 8, 8, 64, 128, [15, 16, 31, 255, 511, 700, 2046, 5], ()),
    ("D128", 32, 8, 128, 128, [15, 16, 31, 255, 511, 700, 2046, 5], ()),
)


def k1_case(label: str, args, ps: int) -> dict:
    """One K1 case: held to the plain version elementwise and per row,
    then timed (CUDA events per wrapper call, profiler device time) beside
    SDPA on the pre-gathered padded window (a yardstick: it reads every
    slot of the window, not only the valid ones) and the bound."""
    import torch

    from kafka_tpu_torch.ops.kernels import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    q, k_pool, v_pool, table, seq_lens = args
    B, Hq, D = q.shape
    HD = k_pool.shape[1]
    Hkv, P = HD // D, table.shape[1]
    C = P * ps
    shape = (f"{label}: B={B} Hq={Hq} Hkv={Hkv} D={D} page={ps} P={P} "
             f"seq_lens={seq_lens.tolist()}")
    out_k = paged_decode_attention(*args, page_size=ps)
    out_p = paged_decode_attention_plain(*args, page_size=ps)
    torch.cuda.synchronize()
    err = check_close(f"K1 paged_decode_attention {shape}", out_k, out_p)
    rel = check_rows(f"K1 paged_decode_attention {shape}", out_k, out_p)
    tok = int((seq_lens.long() + 1).clamp(max=C).sum())
    b1, by1 = bound(
        2 * tok * HD * 2 + 2 * B * Hq * D * 2 + B * P * 4 + B * 4,
        4 * Hq * D * tok)
    win = windows(((k_pool, D), (v_pool, D)), table, ps)
    mask = (torch.arange(C, device=q.device)[None]
            <= seq_lens.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q4, win[0], win[1], attn_mask=mask,  # noqa: E731
                       enable_gqa=True)
    kern = lambda: paged_decode_attention(*args, page_size=ps)  # noqa: E731
    case = {
        "shape": shape, "max_abs_err": err, "row_rel_err": rel,
        "ms": time_ms(kern), "device_ms": device_ms(kern, "paged_"),
        # the two kernels apart: the chunks, and the merge of long lanes
        "device_ms_chunks": device_ms(kern, "paged_decode_chunk"),
        "device_ms_merge": device_ms(kern, "paged_merge"),
        "plain_ms": time_ms(
            lambda: paged_decode_attention_plain(*args, page_size=ps),
            iters=10, warmup=2),
        "bound_ms": b1, "bound_by": by1, "valid_tokens": tok,
        "library_ms": time_ms(lib), "library_device_ms": device_ms(lib, None),
    }
    log(f"K1 {shape}: {case['ms']:.4f} ms (device {case['device_ms']}: "
        f"chunks {case['device_ms_chunks']}, merge "
        f"{case['device_ms_merge']}), "
        f"SDPA {case['library_ms']:.4f} (device {case['library_device_ms']}),"
        f" plain {case['plain_ms']:.4f}, bound {b1:.5f} by {by1}")
    return case


def kernel_k1(head_args, gen) -> None:
    """K1 at the ragged head case and every case of K1_CASES, each held
    elementwise and per row to its plain version and timed; at the head
    case a planted dropped-chunk fault must fail the row check."""
    import torch

    from kafka_tpu_torch.ops.kernels import paged_decode_attention_plain

    ps = 16
    cases = [k1_case("ragged", head_args, ps)]
    q, k_pool, v_pool, table, seq_lens = head_args
    want = paged_decode_attention_plain(*head_args, page_size=ps)
    b = int(seq_lens.argmax())
    D, HD = q.shape[-1], k_pool.shape[1]
    win = [t.view(-1, ps, HD)[table[b].long()].view(-1, HD // D, D)
           for t in (k_pool, v_pool)]
    bad = want.clone()
    bad[b] = planted_window_fault(q[b][None], *win, int(seq_lens[b]) + 1,
                                  128, 256)[0]
    cases[0]["planted_fault"] = fault_check(
        "K1 (the longest lane loses its second chunk)", bad, want)
    dev = head_args[0].device
    for label, Hq, Hkv, D, P, lens, trash in K1_CASES:
        B, HD = len(lens), Hkv * D
        num_pages = B * P + 1
        kp, vp = (torch.randn(num_pages * ps, HD, generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, Hq, D, generator=gen, device=dev
                        ).to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        table = perm.view(B, P).to(torch.int32).contiguous()
        for b in trash:
            table[b] = 0
        seq = torch.tensor(lens, dtype=torch.int32, device=dev)
        cases.append(k1_case(label, (q, kp, vp, table, seq), ps))
    head = cases[0]
    RESULTS["K1"] = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "kafka_tpu_torch/csrc/paged_decode.cu",
        "replaces": "kafka_tpu/ops/pallas/paged_attention.py:180",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms",
                                "device_ms", "shape")},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "row_rel_err": max(c["row_rel_err"] for c in cases),
        "cases": cases,
    }


# K2 cases: (S, start, chunk_len, Hq, Hkv, D).  The engine phase's 512-row
# chunks, its 256-row remainder chunk and its turn-2 suffix (a 64 bucket
# at start 304); the repaired thread turn's cold prefill (the built-in
# tools' schemas make the server phase's turn 1 3,218 byte tokens: a
# 2048-row chunk at start 0, then its last 1,170 rows at start 2048,
# padded to the 2048 bucket; a 1024-row chunk of 1000 rows is the same
# kind of chunk one bucket down) and its turn-2 suffix (86 rows at start
# 3216 in the 128 bucket); and Llama-3.1-8B's attention geometry (D 128)
# at a long, a 512-row and a short chunk, random tensors.  At G 4 the
# launcher picks 4 warps of 2 16-row tiles (4x2) from S 1024 up and 4x1
# below; each case also runs both shapes pinned.
K2_CASES = (
    (512, 0, 512, 32, 8, 64),
    (512, 512, 300, 32, 8, 64),
    (256, 512, 256, 32, 8, 64),
    (64, 304, 52, 32, 8, 64),
    (2048, 0, 2048, 32, 8, 64),
    (1024, 2048, 1000, 32, 8, 64),
    (2048, 2048, 1170, 32, 8, 64),
    (128, 3216, 86, 32, 8, 64),
    (2048, 0, 2048, 32, 8, 128),
    (512, 0, 512, 32, 8, 128),
    (128, 1024, 100, 32, 8, 128),
)


def row_rel_err(got, want) -> float:
    """max over (row, head) of ||got - want|| / ||want|| along D."""
    got, want = got.float(), want.float()
    n = want.norm(dim=-1)
    return ((got - want).norm(dim=-1) / n.clamp_min(1e-6)).max().item()


def check_rows(name: str, got, want) -> float:
    """The per-row relative check beside check_close's elementwise one: a
    row that attends n random keys has |o| ~ sqrt(e / n), so at n ~ 2000
    the absolute floor is half a typical element and only a relative
    reading sees a dropped or mis-masked tile."""
    rel = row_rel_err(got, want)
    log(f"{name} row_rel_err={rel:.3e} (tol {K2_ROW_RTOL})")
    if not rel <= K2_ROW_RTOL:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"row_rel_err {rel}")
    return rel


def planted_tile_fault(a2, ps: int, rows: int = 64):
    """The plain output with one planted fault: the last `rows` positions
    of the chunk lose the window's second 64-token kv tile, the fault a
    kernel's tile or causal bookkeeping could make."""
    import torch

    from kafka_tpu_torch.ops.attention import causal_attention
    from kafka_tpu_torch.ops.kernels import paged_prefill_attention_plain

    q, kp, vp, row, start, clen = a2
    S, Hq, D = q.shape
    HD = kp.shape[1]
    C = row.shape[0] * ps
    out = paged_prefill_attention_plain(*a2, page_size=ps)
    win = [t.view(-1, ps, HD)[row.long()].reshape(1, C, HD // D, D)
           for t in (kp, vp)]
    kv_pos = torch.arange(C, device=q.device)[None]
    lo = clen - rows
    out[lo:clen] = causal_attention(
        q[None, lo:clen], win[0], win[1],
        q_positions=start + torch.arange(lo, clen, device=q.device)[None],
        kv_positions=kv_pos,
        kv_valid=(kv_pos < start + clen) & ((kv_pos < 64) | (kv_pos >= 128)),
    )[0]
    return out


def kernel_k2(k_pool, v_pool, gen) -> None:
    """K2 at every case of K2_CASES against its plain version (rows past
    chunk_len must come back as zeros), held elementwise and per row, the
    launcher's pick and every block shape pinned; each timed with CUDA
    events and the profiler's device time beside its bound and SDPA on the
    pre-gathered window (causal from the lower right, the kernel's
    function).  The first case heads the kernels line.  At the cold turn's
    first chunk a planted dropped-tile fault must fail the row check."""
    import torch
    from torch.nn.attention.bias import causal_lower_right

    from kafka_tpu_torch.ops.kernels import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )
    from kafka_tpu_torch.ops.kernels.flash_prefill import ROW_TILES

    dev = k_pool.device
    ps = 16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pools = {k_pool.shape[1]: (k_pool, v_pool)}
    cases = []
    for S, start, clen, Hq, Hkv, D in K2_CASES:
        HD = Hkv * D
        if HD not in pools or pools[HD][0].shape[0] < 2 * (start + S):
            n = 2 * (start + S) // ps + 1
            pools[HD] = tuple(
                torch.randn(n * ps, HD, generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        kp, vp = pools[HD]
        P = (start + S) // ps
        row = (torch.randperm(kp.shape[0] // ps - 1, generator=gen,
                              device=dev)[:P] + 1).to(torch.int32)
        qs = torch.randn(S, Hq, D, generator=gen, device=dev
                         ).to(torch.bfloat16)
        a2 = (qs, kp, vp, row, start, clen)
        shape = (f"S={S} start={start} chunk_len={clen} Hq={Hq} Hkv={Hkv} "
                 f"D={D} page={ps} P={P}")
        out_p = paged_prefill_attention_plain(*a2, page_size=ps)
        errs, rels, tiles_ms = [], [], {}
        for rt in (None,) + ROW_TILES:
            tag = "auto" if rt is None else f"4x{rt}"
            out_k = paged_prefill_attention(*a2, page_size=ps, row_tiles=rt)
            torch.cuda.synchronize()
            name = f"K2 paged_prefill_attention {shape} [{tag}]"
            errs.append(check_close(name, out_k[:clen], out_p[:clen]))
            rels.append(check_rows(name, out_k[:clen], out_p[:clen]))
            if clen < S and out_k[clen:].abs().max().item() != 0:
                raise AssertionError(f"K2 rows past chunk_len not zero: "
                                     f"{shape} [{tag}]")
            if rt is not None:  # device time: short calls are host-bound
                tiles_ms[tag] = device_ms(lambda: paged_prefill_attention(
                    *a2, page_size=ps, row_tiles=rt), "flash_prefill")  # noqa
        kv = start + clen
        pairs = clen * start + clen * (clen + 1) // 2  # sum of start + i + 1
        b2, by2 = bound(2 * clen * Hq * D * 2 + 2 * kv * HD * 2 + P * 4,
                        4 * Hq * D * pairs)
        # yardstick: SDPA over the pre-gathered window, causal from the
        # lower right (query i of the chunk sees keys <= start + i)
        win = [t.view(-1, ps, HD)[row.long()].reshape(1, P * ps, Hkv, D)
               [:, :kv].transpose(1, 2).contiguous() for t in (kp, vp)]
        qw = qs[:clen].transpose(0, 1)[None].contiguous()
        bias = causal_lower_right(clen, kv)
        lib = lambda: sdpa(qw, win[0], win[1], attn_mask=bias,  # noqa
                           enable_gqa=True)
        ms = time_ms(lambda: paged_prefill_attention(*a2, page_size=ps))
        dms = device_ms(lambda: paged_prefill_attention(*a2, page_size=ps),
                        "flash_prefill")
        case = {
            "shape": shape, "max_abs_err": max(errs),
            "row_rel_err": max(rels), "ms": ms, "device_ms": dms,
            "tiles_device_ms": tiles_ms,
            "plain_ms": time_ms(
                lambda: paged_prefill_attention_plain(*a2, page_size=ps),
                iters=10, warmup=2),
            "bound_ms": b2, "bound_by": by2, "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib, None),
            "tflops": 4 * Hq * D * pairs / (ms * 1e-3) / 1e12,
        }
        log(f"K2 {shape}: {ms:.4f} ms (device {dms}; pinned shapes, device: "
            f"{tiles_ms}), "
            f"SDPA {case['library_ms']:.4f} (device "
            f"{case['library_device_ms']}), plain {case['plain_ms']:.4f}, "
            f"bound {b2:.5f} by {by2}, {case['tflops']:.1f} TFLOP/s")
        if (S, start, clen, D) == (2048, 0, 2048, 64):
            bad = planted_tile_fault(a2, ps)
            case["planted_fault"] = fault_check(
                f"K2 (last 64 rows lose kv tile 1) {shape}", bad[:clen],
                out_p[:clen])
        cases.append(case)
    head = cases[0]
    RESULTS["K2"] = {
        "name": "paged_prefill_attention",
        "route": "cuda",
        "source": "kafka_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "kafka_tpu/ops/pallas/flash_prefill.py:164",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "shape")},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "row_rel_err": max(c["row_rel_err"] for c in cases),
        "cases": cases,
    }


def ptxas_report(logs: dict) -> dict:
    """Per kernel function: registers and spill bytes from nvcc's
    -Xptxas -v output ({source: [{fn, registers, spill_stores,
    spill_loads}]})."""
    import re

    report = {}
    for name, text in logs.items():
        rows, fn = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = {"fn": m.group(1)}
                rows.append(fn)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and fn is not None:
                fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                fn["registers"] = int(m.group(1))
        report[name] = rows
    return report


def sass_count(name: str, opcode: str) -> int:
    """Instructions of `opcode` in the built library of csrc/<name>.cu
    (cuobjdump -sass)."""
    from kafka_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum(1 for line in sass.splitlines() if f" {opcode}" in line)


# K3 cases beside the ragged head case (B 8, S 5 = speculative_k 4,
# lengths 15..2040 with q_lens 1..5, lane 7 a trash lane): (label, Hq, Hkv,
# D, table pages P, S, seq_lens, q_lens, trash lanes).  Every lane at
# ~2,040 tokens; every lane at <= 32 slots in a 128-token window (one chunk
# per lane, no merge); windows (seq_len + q_len) ending on chunk (128) and
# page (16) boundaries; two trash lanes; G 8 at S 5 (40 rows per kv head);
# G 4 at S 9 and S 17 (speculative_k 8 and 16: the 36 and 68 rows the
# 32-row kernel refused, fault C4); G 8 at S 17 (136 rows: two row blocks);
# and D 128.  Rows j >= q_len must come back as zeros.
K3_RAGGED = ([15, 16, 31, 255, 511, 700, 2040, 5], [1, 2, 3, 4, 5, 5, 3, 1])
K3_CASES = (
    ("long", 32, 8, 64, 128, 5,
     [2040, 2041, 2042, 2043, 2039, 2038, 2040, 2036], [5] * 8, ()),
    ("short", 32, 8, 64, 8, 5, [0, 1, 7, 15, 16, 17, 26, 27],
     [1, 2, 5, 5, 4, 3, 5, 5], ()),
    ("boundaries", 32, 8, 64, 128, 5,
     [123, 128, 126, 251, 11, 16, 1019, 2043], [5, 5, 2, 5, 5, 1, 5, 5], ()),
    ("trash", 32, 8, 64, 128, 5, [900, 40, 2040, 300, 1500, 7, 64, 511],
     [5, 5, 3, 5, 2, 5, 1, 4], (1, 4)),
    ("G8", 64, 8, 64, 128, 5, *K3_RAGGED, ()),
    ("K8", 32, 8, 64, 128, 9, [15, 16, 31, 255, 511, 700, 2030, 5],
     [1, 9, 3, 9, 5, 9, 9, 2], ()),
    ("K16", 32, 8, 64, 128, 17, [15, 16, 31, 255, 511, 700, 2020, 5],
     [1, 17, 3, 9, 17, 5, 17, 2], ()),
    ("G8_K16", 64, 8, 64, 128, 17, [15, 16, 31, 255, 511, 700, 2020, 5],
     [1, 17, 3, 9, 17, 5, 17, 2], ()),
    ("D128", 32, 8, 128, 128, 5, *K3_RAGGED, ()),
)
# K4 takes K1's eight cases (the ragged head case and K1_CASES) over an
# int8 pool: each case's bf16 rows quantized per slot, as the engine's KV
# write does.
K4_CASES = K1_CASES


def windows(pools, table, ps: int):
    """Each lane's gathered window [B, Hkv, C, D] of every pool, for the
    SDPA yardstick (it reads the whole padded window)."""
    B, P = table.shape
    out = []
    for t, D in pools:
        HD = t.shape[1]
        out.append(t.view(-1, ps, HD)[table.long()]
                   .view(B, P * ps, HD // D, D).transpose(1, 2).contiguous())
    return out


def planted_window_fault(q, win_k, win_v, n_valid, lo: int, hi: int):
    """One lane's rows attending their window with slots [lo, hi) dropped:
    the fault a kernel's chunk bookkeeping or merge could make.  q [S, Hq,
    D] at positions n_valid - S .. n_valid - 1 (causal), windows [C, Hkv,
    D] in any float type; returns [S, Hq, D] in q's type."""
    import torch

    from kafka_tpu_torch.ops.attention import causal_attention

    S = q.shape[0]
    C = win_k.shape[0]
    kv_pos = torch.arange(C, device=q.device)[None]
    qpos = n_valid - S + torch.arange(S, device=q.device)[None]
    return causal_attention(
        q[None], win_k[None], win_v[None], q_positions=qpos,
        kv_positions=kv_pos,
        kv_valid=(kv_pos < n_valid) & ((kv_pos < lo) | (kv_pos >= hi)),
    )[0]


def fault_check(name: str, bad, want) -> dict:
    """A planted fault must fail the row check (and is logged)."""
    f_rel = row_rel_err(bad, want)
    f_abs = (bad.float() - want.float()).abs()
    f_exc = (f_abs - KERNEL_RTOL * want.float().abs()).max()
    out = {"max_abs_err": f_abs.max().item(), "row_rel_err": f_rel,
           "elementwise_check_passes": bool(f_exc <= KERNEL_ATOL)}
    log(f"{name} planted fault: {out}")
    if not f_rel > K2_ROW_RTOL:
        raise AssertionError(f"{name}'s row check does not see the planted "
                             f"fault: row_rel_err {f_rel}")
    return out


def k3_case(label: str, a3, ps: int) -> dict:
    """One K3 case: live rows (j < q_len) held to the plain version
    elementwise and per row, rows j >= q_len checked to be zeros, then
    timed (CUDA events per wrapper call; profiler device time with the L2
    warm and flushed) beside SDPA on the pre-gathered padded window and
    the bound.  In a baseline run (--root), a case the baseline's wrapper
    refuses is recorded as refused."""
    import torch

    from kafka_tpu_torch.ops.kernels import (
        paged_verify_attention,
        paged_verify_attention_plain,
    )

    q, k_pool, v_pool, table, seq, ql = a3
    B, S, Hq, D = q.shape
    HD = k_pool.shape[1]
    Hkv, P = HD // D, table.shape[1]
    C = P * ps
    shape = (f"{label}: B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} page={ps} P={P} "
             f"seq_lens={seq.tolist()} q_lens={ql.tolist()}")
    try:
        out_k = paged_verify_attention(*a3, page_size=ps)
    except ValueError as e:
        if not BASELINE:
            raise
        log(f"K3 {shape}: refused by the baseline ({e})")
        return {"shape": shape, "refused": str(e)}
    out_p = paged_verify_attention_plain(*a3, page_size=ps)
    torch.cuda.synchronize()
    live = [(b, j) for b in range(B) for j in range(int(ql[b]))]
    dead = [(b, j) for b in range(B) for j in range(int(ql[b]), S)]
    bi, ji = (torch.tensor(x, device=q.device) for x in zip(*live))
    name = f"K3 paged_verify_attention {shape}"
    err = check_close(name, out_k[bi, ji], out_p[bi, ji])
    rel = check_rows(name, out_k[bi, ji], out_p[bi, ji])
    if dead:
        db, dj = (torch.tensor(x, device=q.device) for x in zip(*dead))
        if out_k[db, dj].abs().max().item() != 0:
            raise AssertionError(f"{name}: rows j >= q_len are not zeros")
    n_win = (seq.long() + ql.long()).clamp(max=C)
    # each live row j sees slots < min(seq_len + j + 1, n_valid)
    pairs = sum(min(int(seq[b]) + j + 1, int(n_win[b])) for b, j in live)
    b3, by3 = bound(
        2 * int(n_win.sum()) * HD * 2 + 2 * B * S * Hq * D * 2
        + B * P * 4 + 2 * B * 4,
        4 * Hq * D * pairs)
    k_win, v_win = windows(((k_pool, D), (v_pool, D)), table, ps)
    qpos = seq.long()[:, None] + torch.arange(S, device=q.device)[None]
    kv = torch.arange(C, device=q.device)[None, None]
    mask = ((kv <= qpos[:, :, None]) & (kv < n_win[:, None, None]))[:, None]
    qw = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qw, k_win, v_win, attn_mask=mask,  # noqa: E731
                       enable_gqa=True)
    kern = lambda: paged_verify_attention(*a3, page_size=ps)  # noqa: E731
    case = {
        "shape": shape, "max_abs_err": err, "row_rel_err": rel,
        "live_rows": len(live), "window_tokens": int(n_win.sum()),
        "ms": time_ms(kern),
        "device_ms": device_ms(kern, "paged_"),
        "device_ms_cold_l2": device_ms(kern, "paged_", flush=flush_l2),
        "device_ms_merge": device_ms(kern, "merge"),
        "plain_ms": time_ms(
            lambda: paged_verify_attention_plain(*a3, page_size=ps),
            iters=10, warmup=2),
        "bound_ms": b3, "bound_by": by3,
        "library_ms": time_ms(lib), "library_device_ms": device_ms(lib, None),
    }
    log(f"K3 {shape}: {case['ms']:.4f} ms (device {case['device_ms']}, "
        f"L2 flushed {case['device_ms_cold_l2']}, merge "
        f"{case['device_ms_merge']}), SDPA {case['library_ms']:.4f} (device "
        f"{case['library_device_ms']}), plain {case['plain_ms']:.4f}, bound "
        f"{b3:.5f} by {by3}")
    return case


def kernel_k3(k1_args, gen) -> None:
    """K3 at the ragged head case (K1's pools and table, S 5) and every
    case of K3_CASES; at the head case a planted fault (the longest lane's
    rows lose the second 128-token chunk of their window) must fail the
    row check."""
    import torch

    from kafka_tpu_torch.ops.kernels import paged_verify_attention_plain

    _, k_pool, v_pool, table, _ = k1_args
    dev = k_pool.device
    ps, Hq, D = 16, 32, 64
    B = table.shape[0]
    seq3, ql3 = (torch.tensor(x, dtype=torch.int32, device=dev)
                 for x in K3_RAGGED)
    q3 = torch.randn(B, 5, Hq, D, generator=gen, device=dev
                     ).to(torch.bfloat16)
    head = (q3, k_pool, v_pool, table, seq3, ql3)
    cases = [k3_case("ragged", head, ps)]
    if "refused" not in cases[0] and not BASELINE:
        want = paged_verify_attention_plain(*head, page_size=ps)
        b = int(seq3.argmax())
        n = int(ql3[b])
        n_valid = int(seq3[b]) + n
        HD = k_pool.shape[1]
        win = [t.view(-1, ps, HD)[table[b].long()].view(-1, HD // D, D)
               for t in (k_pool, v_pool)]
        bad = want.clone()
        bad[b, :n] = planted_window_fault(q3[b, :n], *win, n_valid, 128, 256)
        cases[0]["planted_fault"] = fault_check(
            "K3 (the longest lane loses its second chunk)", bad[b, :n],
            want[b, :n])
    for label, Hq, Hkv, D, P, S, lens, qls, trash in K3_CASES:
        B, HD = len(lens), Hkv * D
        num_pages = B * P + 1
        kp, vp = (torch.randn(num_pages * ps, HD, generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev
                        ).to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        tab = perm.view(B, P).to(torch.int32).contiguous()
        for b in trash:
            tab[b] = 0
        seq, ql = (torch.tensor(x, dtype=torch.int32, device=dev)
                   for x in (lens, qls))
        cases.append(k3_case(label, (q, kp, vp, tab, seq, ql), ps))
    done = [c for c in cases if "refused" not in c]
    head = cases[0]
    RESULTS["K3"] = {
        "name": "paged_verify_attention",
        "route": "cuda",
        "source": "kafka_tpu_torch/csrc/paged_verify.cu",
        "replaces": "kafka_tpu/ops/pallas/paged_attention.py:384",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms",
                                "device_ms", "shape") if k in head},
        "max_abs_err": max(c["max_abs_err"] for c in done),
        "row_rel_err": max(c["row_rel_err"] for c in done),
        "cases": cases,
    }


def k4_case(label: str, a4, ps: int) -> dict:
    """One K4 case: held to the plain version elementwise and per row,
    then timed (CUDA events; profiler device time with the L2 warm and
    flushed, and at the other chunk length) beside SDPA on the
    dequantized, pre-gathered padded window and the bound."""
    import torch

    from kafka_tpu_torch.models.quant import QTensor, dequantize
    from kafka_tpu_torch.ops.kernels import (
        paged_decode_attention_int8,
        paged_decode_attention_int8_plain,
    )
    from kafka_tpu_torch.ops.kernels import paged_decode_int8 as k4_module

    q, kq, ks, vq, vs, table, seq_lens = a4
    B, Hq, D = q.shape
    HD = kq.shape[1]
    Hkv, P = HD // D, table.shape[1]
    C = P * ps
    shape = (f"{label}: B={B} Hq={Hq} Hkv={Hkv} D={D} page={ps} P={P} "
             f"seq_lens={seq_lens.tolist()} int8 pool")
    out_k = paged_decode_attention_int8(*a4, page_size=ps)
    out_p = paged_decode_attention_int8_plain(*a4, page_size=ps)
    torch.cuda.synchronize()
    name = f"K4 paged_decode_attention_int8 {shape}"
    err = check_close(name, out_k, out_p)
    rel = check_rows(name, out_k, out_p)
    tok = int((seq_lens.long() + 1).clamp(max=C).sum())
    b4, by4 = bound(
        tok * (2 * HD + 2 * 4) + 2 * B * Hq * D * 2 + B * P * 4 + B * 4,
        4 * Hq * D * tok)
    win = windows(((dequantize(QTensor(q=kq, s=ks), torch.bfloat16), D),
                   (dequantize(QTensor(q=vq, s=vs), torch.bfloat16), D)),
                  table, ps)
    mask = (torch.arange(C, device=q.device)[None]
            <= seq_lens.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q4, win[0], win[1], attn_mask=mask,  # noqa: E731
                       enable_gqa=True)
    kern = lambda: paged_decode_attention_int8(*a4, page_size=ps)  # noqa
    case = {
        "shape": shape, "max_abs_err": err, "row_rel_err": rel,
        "valid_tokens": tok, "ms": time_ms(kern),
        "device_ms": device_ms(kern, "paged_"),
        "device_ms_cold_l2": device_ms(kern, "paged_", flush=flush_l2),
        "plain_ms": time_ms(
            lambda: paged_decode_attention_int8_plain(*a4, page_size=ps),
            iters=10, warmup=2),
        "bound_ms": b4, "bound_by": by4,
        "library_ms": time_ms(lib), "library_device_ms": device_ms(lib, None),
    }
    # the chunk length: the kernel at 256-token chunks too, same inputs
    chunk = getattr(k4_module, "CHUNK_TOKENS", None)
    if chunk is not None:
        k4_module.CHUNK_TOKENS = 256
        try:
            alt = paged_decode_attention_int8(*a4, page_size=ps)
            check_rows(f"{name} [chunk 256]", alt, out_p)
            case["device_ms_chunk256"] = device_ms(kern, "paged_")
        finally:
            k4_module.CHUNK_TOKENS = chunk
    log(f"K4 {shape}: {case['ms']:.4f} ms (device {case['device_ms']}, "
        f"L2 flushed {case['device_ms_cold_l2']}, at 256-token chunks "
        f"{case.get('device_ms_chunk256')}), SDPA {case['library_ms']:.4f} "
        f"(device {case['library_device_ms']}), plain "
        f"{case['plain_ms']:.4f}, bound {b4:.5f} by {by4}")
    return case


def kernel_k4(k1_args, gen) -> None:
    """K4 at every case of K4_CASES (K1's cases over int8 pools: the same
    windows, their rows quantized per slot as the engine's KV write does);
    at the head case a planted fault (the longest lane loses its second
    256-token chunk) must fail the row check."""
    import torch

    from kafka_tpu_torch.models.quant import quantize_array
    from kafka_tpu_torch.ops.kernels import paged_decode_attention_int8_plain

    ps = 16

    def int8_args(q, kp, vp, table, seq):
        kq, vq = quantize_array(kp, (-1,)), quantize_array(vp, (-1,))
        return (q, kq.q, kq.s, vq.q, vq.s, table, seq)

    head = int8_args(*k1_args)
    cases = [k4_case("ragged", head, ps)]
    if not BASELINE:
        q, kq, ks, vq, vs, table, seq = head
        want = paged_decode_attention_int8_plain(*head, page_size=ps)
        b = int(seq.argmax())
        HD, D = kq.shape[1], q.shape[-1]
        win = [(c.float() * s).view(-1, ps, HD)[table[b].long()]
               .view(-1, HD // D, D) for c, s in ((kq, ks), (vq, vs))]
        bad = want.clone()
        bad[b] = planted_window_fault(q[b][None].float(), *win,
                                      int(seq[b]) + 1, 256, 512)[0]
        cases[0]["planted_fault"] = fault_check(
            "K4 (the longest lane loses its second chunk)", bad, want)
    dev = k1_args[0].device
    for label, Hq, Hkv, D, P, lens, trash in K4_CASES:
        B, HD = len(lens), Hkv * D
        num_pages = B * P + 1
        kp, vp = (torch.randn(num_pages * ps, HD, generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, Hq, D, generator=gen, device=dev
                        ).to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        tab = perm.view(B, P).to(torch.int32).contiguous()
        for b in trash:
            tab[b] = 0
        seq = torch.tensor(lens, dtype=torch.int32, device=dev)
        cases.append(k4_case(label, int8_args(q, kp, vp, tab, seq), ps))
    head = cases[0]
    RESULTS["K4"] = {
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": "kafka_tpu_torch/csrc/paged_decode_int8.cu",
        "replaces": "kafka_tpu/ops/pallas/paged_attention.py:690",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms",
                                "device_ms", "shape")},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "row_rel_err": max(c["row_rel_err"] for c in cases),
        "cases": cases,
    }


# K5's rows: one N tile of the product (1, 8), a ragged second (9), four
# (32) and the most a launch takes (64), so every N-tile count the kernel
# picks (1, 2, 4, 8) runs; each is held to the plain version in bf16 and
# int8, and timed with the L2 warm and flushed.  B 8 is the kernel line's
# case and the sweep's.
K5_ROWS = (1, 8, 9, 32, 64)


def kernel_k5(gen) -> None:
    """K5 at the llama-3.2-1b decode MLP shape (H 2048, F 8192), bf16 and
    int8 weights, at K5_ROWS rows.  K5 is not on the serving path (as in
    the JAX package): its path is the function itself, driven over the
    16-layer MLP stack of a full-width layer stack below at B 8, with the
    counter read around that sweep alone.  That stack's weights (1.6 GB
    bf16, 0.8 GB int8) cannot sit in the 50 MB L2, so the sweep's
    per-layer device time reads every layer's weights from device memory;
    the single-layer times are taken with the L2 warm (layer 0 again and
    again: its 50 MB int8 layer may partly hit) and flushed.

    K5's passes start while the launch before them finishes, so a sum of
    kernel durations would count the overlap twice: the warm and sweep
    times are CUDA-graph replays between events (graph_ms), the flushed
    time the span of each call's launches (device_ms's span mode).  At B
    8 the flushed time is also taken after a read-only eviction, which
    leaves no dirty lines to write back."""
    import torch

    from kafka_tpu_torch.models.quant import (
        QTensor,
        dequantize,
        quantize_array,
    )
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.ops.kernels import (
        fused_mlp_args,
        fused_mlp_block,
        fused_mlp_block_plain,
    )
    from kafka_tpu_torch.ops.norms import rms_norm

    dev = torch.device("cuda")
    B, H, F, L, eps = 8, 2048, 8192, 16, 1e-5

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5
                ).to(torch.bfloat16)

    stack = {"ln_mlp": (1 + 0.1 * torch.randn(L, H, generator=gen,
                                              device=dev)).to(torch.bfloat16),
             "wg": normal((L, H, F), H), "wu": normal((L, H, F), H),
             "wd": normal((L, F, H), F)}
    qstack = dict(stack)
    for name in ("wg", "wu", "wd"):
        qstack[name] = quantize_array(stack[name], (1,))
    h_rows = torch.randn(max(K5_ROWS), H, generator=gen, device=dev
                         ).to(torch.bfloat16)
    h0 = h_rows[:B].contiguous()

    def torch_formulation(h, ln, wg, wu, wd, sg=None, su=None, sd=None):
        # the port's decode MLP (models/llama.py): norm, dequant, matmuls
        if sg is not None:
            wg, wu, wd = (dequantize(QTensor(q=w, s=s_), torch.bfloat16)
                          for w, s_ in ((wg, sg), (wu, su), (wd, sd)))
        x = rms_norm(h, ln, eps)
        g, u = x @ wg, x @ wu
        return h + (torch.nn.functional.silu(g) * u) @ wd

    def sweep(layers, h):
        for l in range(L):
            h = fused_mlp_block(h, *fused_mlp_args(layers, l), eps=eps)
        return h

    # each input read once (h, ln, the weights and scales), the output
    # written once; flops of the three products
    w_bytes = {"bf16": 3 * H * F * 2, "int8": 3 * H * F + (2 * F + H) * 4}
    for key, label, layers in (("K5", "bf16", stack),
                               ("K5_int8", "int8", qstack)):
        a5 = fused_mlp_args(layers, 0)
        cases = []
        for rows in K5_ROWS:
            hb = h_rows[:rows].contiguous()
            out_k = fused_mlp_block(hb, *a5, eps=eps)
            out_p = fused_mlp_block_plain(hb, *a5, eps=eps)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            bnd, _ = bound(w_bytes[label] + 2 * rows * H * 2 + H * 2,
                           2 * rows * 3 * H * F)
            run = lambda: fused_mlp_block(hb, *a5, eps=eps)  # noqa: E731
            case = {"B": rows, "max_abs_err": err,
                    "device_ms": graph_ms(run),
                    "device_ms_cold_l2": device_ms(run, "mlp_",
                                                   flush=flush_l2,
                                                   span_from="rmsnorm"),
                    "bound_ms": bnd}
            if rows == B:
                case["device_ms_cold_l2_read"] = device_ms(
                    run, "mlp_", flush=lambda: flush_l2(read_only=True),
                    span_from="rmsnorm")
            log(f"K5 fused_mlp_block ({label}) B {rows}: max_abs_err="
                f"{err:.3e} (tol {K5_ATOL}); device {case['device_ms']} ms, "
                f"L2 flushed {case['device_ms_cold_l2']} ms (read-only "
                f"eviction {case.get('device_ms_cold_l2_read')}), bound "
                f"{bnd:.5f} ms")
            if not err <= K5_ATOL:
                raise AssertionError(f"K5 ({label}) at B {rows} disagrees "
                                     f"with its plain version: {err}")
            cases.append(case)
        # its path: one decode MLP sweep over the layer stack
        kernels.reset_launch_counts()
        h = sweep(layers, h0)
        launches = fused_mlp_block.launches
        h_ref = h0
        for l in range(L):
            h_ref = torch_formulation(h_ref, *fused_mlp_args(layers, l))
        torch.cuda.synchronize()
        rel = ((h.float() - h_ref.float()).abs().max()
               / h_ref.float().abs().max()).item()
        per_layer = graph_ms(lambda: sweep(layers, h0), reps=2) / L
        log(f"K5 ({label}) path: {L}-layer MLP sweep, launches {launches}, "
            f"max|d|/max|ref| vs the torch formulation {rel:.4f} "
            f"(tol {LOGITS_RTOL}); device {per_layer} ms a layer (weights "
            f"from device memory)")
        if launches != L or not torch.isfinite(h).all() \
                or not rel <= LOGITS_RTOL:
            raise AssertionError(f"K5 ({label}) sweep: launches {launches}, "
                                 f"rel err {rel}")
        head = cases[K5_ROWS.index(B)]
        b5, by5 = bound(w_bytes[label] + 2 * B * H * 2 + H * 2,
                        2 * B * 3 * H * F)
        RESULTS[key] = {
            "name": f"fused_mlp_block ({label})",
            "route": "cuda",
            "source": "kafka_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "kafka_tpu/ops/pallas/fused_mlp.py:153",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": time_ms(lambda: fused_mlp_block(h0, *a5, eps=eps)),
            "plain_ms": time_ms(
                lambda: fused_mlp_block_plain(h0, *a5, eps=eps)),
            "bound_ms": b5,
            "bound_by": by5,
            # no single PyTorch call computes the block; the port's own
            # torch formulation is timed beside it instead
            "library_ms": None,
            "torch_ms": time_ms(lambda: torch_formulation(h0, *a5)),
            "device_ms": head["device_ms"],
            "device_ms_cold_l2": head["device_ms_cold_l2"],
            "device_ms_cold_l2_read": head["device_ms_cold_l2_read"],
            "sweep_layer_device_ms": per_layer,
            "sweep_rel_err": rel,
            "cases": cases,
            "shape": f"B={B} H={H} F={F} {label} weights",
        }
    del stack, qstack
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: the engine at full llama-3.2-1b width
# ---------------------------------------------------------------------------


def _engine_cfg(**kw):
    """The main-path engines' configuration: attention_backend "kernel"
    unless a caller asks for "plain", so a model or window the kernels
    refuse raises here instead of switching to plain attention."""
    from kafka_tpu_torch.runtime import EngineConfig

    kw.setdefault("attention_backend", "kernel")
    kw.setdefault("max_batch", 8)
    return EngineConfig(page_size=16, num_pages=1100,
                        max_pages_per_seq=128,
                        prefill_buckets=(64, 128, 256, 512),
                        keep_logits=True, **kw)


class ForcedSpeculator:
    """Stands in for the engine's n-gram proposer: proposes the next
    tokens of a known stream, so the verify path and acceptance are
    exercised whatever random weights emit."""

    def __init__(self, stream):
        self.stream = stream
        self.hist = []

    def push(self, token):
        self.hist.append(token)

    def propose(self, k_max):
        n = len(self.hist)
        return self.stream[n:n + max(0, k_max)]

    def observe(self, accepted, proposed):
        pass


def _drive(engine, prompts, max_new: int, streams=None):
    """The first prompt alone to completion, then the rest together.
    streams: per prompt, a stream a ForcedSpeculator proposes from."""
    from kafka_tpu_torch.runtime import GenRequest

    done = {}
    reqs = [GenRequest(request_id=f"r{i}", prompt_ids=p,
                       max_new_tokens=max_new)
            for i, p in enumerate(prompts)]

    def submit(i):
        engine.submit(reqs[i])
        if streams is not None:
            reqs[i].spec = ForcedSpeculator(streams[i])

    submit(0)
    done.update(engine.run_to_completion())
    for i in range(1, len(reqs)):
        submit(i)
    done.update(engine.run_to_completion())
    return [done[r.request_id] for r in reqs]


def _compare_streams(cfg, got, ref, max_new: int):
    """Greedy streams of two engines on the same weights: (identical
    streams, tokens in matching prefixes, worst logits max|d|/max|ref|
    up to and including the first divergence, where histories are still
    equal)."""
    import torch

    same = agree = 0
    worst = 0.0
    for a, b in zip(got, ref):
        if len(a.output_ids) != max_new or a.finish_reason != "length":
            raise AssertionError(f"{a.request_id}: {len(a.output_ids)} "
                                 f"tokens, finish {a.finish_reason}")
        n = 0
        while n < max_new and a.output_ids[n] == b.output_ids[n]:
            n += 1
        same += n == max_new
        agree += n
        for i in range(min(n + 1, max_new)):
            la, lb = a.logits[i], b.logits[i]
            if la.shape != (cfg.vocab_size,) or not torch.isfinite(la).all():
                raise AssertionError(f"{a.request_id}: bad logits row {i}")
            worst = max(worst, ((la - lb).abs().max() / lb.abs().max()).item())
    return same, agree, worst


def phase_engine(seed: int) -> None:
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import InferenceEngine

    cfg = get_config("llama-3.2-1b")
    if (cfg.vocab_size, cfg.hidden_size, cfg.dtype) != (128256, 2048,
                                                        "bfloat16"):
        raise AssertionError(f"not the published llama-3.2-1b width: {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.monotonic()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = params["embed"].numel() + sum(
        v.numel() for v in params["layers"].values())
    log(f"engine: llama-3.2-1b random weights ({n_params} params) in "
        f"{time.monotonic() - t0:.1f}s")
    rng = np.random.RandomState(seed)
    lens = [700, 40, 50, 90, 200, 300, 450, 600]  # first: > 512 bucket
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    max_new = 24

    eng = InferenceEngine(cfg, params, _engine_cfg())
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    got = _drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    k1 = kernels.paged_decode_attention.launches
    k2 = kernels.paged_prefill_attention.launches
    log(f"engine (kernels): 8 requests in {dt:.2f}s, launches K1={k1} "
        f"K2={k2}")
    if k1 == 0 or k2 == 0:
        raise AssertionError(f"engine phase did not launch both kernels: "
                             f"K1={k1} K2={k2}")
    RESULTS["K1"]["engine_launches"] = k1
    RESULTS["K2"]["engine_launches"] = k2

    plain = InferenceEngine(cfg, params, _engine_cfg(attention_backend="plain"))
    kernels.reset_launch_counts()
    ref = _drive(plain, prompts, max_new)
    if kernels.paged_decode_attention.launches or \
            kernels.paged_prefill_attention.launches:
        raise AssertionError("the plain engine launched a kernel")

    same_streams, agree, worst = _compare_streams(cfg, got, ref, max_new)
    total = max_new * len(prompts)
    log(f"engine vs plain engine: {same_streams}/8 identical greedy streams, "
        f"token agreement {agree}/{total} (matching prefix), worst logits "
        f"max|d|/max|ref| = {worst:.4f} (tol {LOGITS_RTOL})")
    RESULTS["engine"] = {
        "seconds": dt, "identical_streams": same_streams,
        "token_agreement": [agree, total], "logits_rel_err": worst,
    }
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"engine logits disagree: {worst}")

    # (a) speculation: K = 4, each lane's proposer offering the spec-off
    # kernel engine's own continuation, so acceptance is exercised.  At
    # fetch_lag 0 every dispatch drains in the step that made it, so a
    # lane proposes at every step (at the default 96 the host runs ahead
    # of the device and a lane rarely has its history drained: PERF.md
    # section 7)
    spec = InferenceEngine(cfg, params, _engine_cfg(speculative_k=4,
                                                    fetch_lag=0))
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    sgot = _drive(spec, prompts, max_new,
                  streams=[r.output_ids for r in got])
    torch.cuda.synchronize()
    sdt = time.monotonic() - t0
    k3 = kernels.paged_verify_attention.launches
    prop, acc = spec.speculation_proposed_tokens, \
        spec.speculation_accepted_tokens
    s_same, s_agree, s_worst = _compare_streams(cfg, sgot, got, max_new)
    log(f"engine (speculative_k=4, forced proposals): 8 requests in "
        f"{sdt:.2f}s over {spec.verify_steps} verify steps, launches "
        f"K3={k3} K1={kernels.paged_decode_attention.launches}; accepted "
        f"{acc}/{prop} proposed; vs spec-off: {s_same}/8 identical greedy "
        f"streams, token agreement {s_agree}/{total}, worst logits "
        f"max|d|/max|ref| = {s_worst:.4f} (tol {LOGITS_RTOL})")
    if spec.verify_steps == 0 or k3 == 0 or acc == 0:
        raise AssertionError(f"speculative engine: {spec.verify_steps} "
                             f"verify steps, K3 launches {k3}, accepted "
                             f"{acc}")
    if not s_worst <= LOGITS_RTOL:
        raise AssertionError(f"speculative engine logits disagree: {s_worst}")
    if spec.self_check():
        raise AssertionError(f"speculative engine: {spec.self_check()}")
    RESULTS["K3"]["launches"] = RESULTS["K3"]["engine_launches"] = k3
    RESULTS["engine_speculative"] = {
        "seconds": sdt, "verify_steps": spec.verify_steps,
        "proposed": prop, "accepted": acc, "identical_streams": s_same,
        "token_agreement": [s_agree, total], "logits_rel_err": s_worst,
    }
    RESULTS["engine_speculative_fsm"] = engine_fsm_speculation(eng, spec)
    del spec
    RESULTS["engine_speculative_k8"] = engine_speculative_k8(
        cfg, params, prompts, got, max_new)

    # (b) prefix reuse: a two-turn thread on the kernel engine; turn 2's
    # prefill must start past the cached pages (K2 at start > 0) and its
    # first logits row agree with a cold engine's
    RESULTS["engine_prefix"] = prefix_turns(eng, plain, cfg, rng)
    del eng, plain
    torch.cuda.empty_cache()
    # (c) int8 serving: the same weights quantized, an int8 KV pool
    RESULTS["engine_int8"] = engine_int8(cfg, params, prompts, max_new, rng)
    del params
    torch.cuda.empty_cache()


def _near_ties(got, ref, max_new: int) -> list:
    """Where two greedy streams first part: each must be a near-tie of the
    reference's logits.  With logits la = lb + d, |d| <= eps, the argmax of
    la can beat lb's argmax only if lb's margin between the two tokens is
    <= 2 eps; anything wider is a fault, not rounding."""
    out = []
    for a, b in zip(got, ref):
        n = 0
        while n < max_new and a.output_ids[n] == b.output_ids[n]:
            n += 1
        if n == max_new:
            continue
        la, lb = a.logits[n], b.logits[n]
        ta, tb = a.output_ids[n], b.output_ids[n]
        tie = {"request": a.request_id, "position": n,
               "margin": (lb[tb] - lb[ta]).item(),
               "max_abs_dlogit": (la - lb).abs().max().item()}
        if not tie["margin"] <= 2 * tie["max_abs_dlogit"]:
            raise AssertionError(f"streams part outside the flip bound: "
                                 f"{tie}")
        out.append(tie)
    return out


def engine_fsm_speculation(ref_eng, spec_eng) -> dict:
    """The verify step's grammar branch on the card: a device-FSM lane
    (tool_choice "required" over the agent's idle tool, byte tokenizer,
    the grammar compiled at the model's vocab) greedy on the spec-off
    kernel engine, then on the speculative_k 4 engine (fetch_lag 0) with
    its proposer offering that stream, so every verify step masks each
    position with the automaton state reached through the candidates,
    accepts on the device and rolls the state back to the accepted
    prefix.  Verify steps must run and accept; the lane must stay on the
    device FSM; both texts must be tool calls validate_tool_call_json
    accepts; the streams must be equal, or part only at a bf16 near-tie
    of the spec-off logits, with logits within LOGITS_RTOL up to there."""
    import torch

    from kafka_tpu_torch.agents import IDLE_TOOL
    from kafka_tpu_torch.llm import constrained as con
    from kafka_tpu_torch.models import ByteTokenizer
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import GenRequest

    tok, tools = ByteTokenizer(), [IDLE_TOOL]
    grammar = con.compile_tool_call_grammar(
        tok, tools, vocab_size=ref_eng.cfg.vocab_size)
    if grammar is None:
        raise AssertionError("the idle tool's grammar did not compile")
    keys = ("constrained_ondevice_tokens", "constrained_host_mask_steps",
            "constrained_degrades", "verify_steps",
            "speculation_proposed_tokens", "speculation_accepted_tokens")

    def lane(eng, rid, stream=None):
        before = {k: getattr(eng, k) for k in keys}
        req = GenRequest(request_id=rid,
                         prompt_ids=tok.encode(CONSTRAINED_PROMPT),
                         max_new_tokens=CONSTRAINED_MAX_TOKENS,
                         stop_token_ids=tuple(tok.stop_ids),
                         logits_mask_fn=con.ToolCallMaskFn(tok, tools),
                         grammar=grammar)
        eng.submit(req)
        if stream is not None:
            req.spec = ForcedSpeculator(stream)
        eng.run_to_completion()
        torch.cuda.synchronize()
        text = tok.decode([t for t in req.output_ids
                           if t not in tok.stop_ids])
        moved = {k: getattr(eng, k) - before[k] for k in keys}
        if moved["constrained_ondevice_tokens"] <= 0 or \
                moved["constrained_host_mask_steps"] or \
                moved["constrained_degrades"] or \
                not con.validate_tool_call_json(text, tools):
            raise AssertionError(f"{rid}: {moved}, text {text!r}")
        return req, moved

    ref, _ = lane(ref_eng, "fsm-off")
    kernels.reset_launch_counts()
    got, moved = lane(spec_eng, "fsm-spec", stream=list(ref.output_ids))
    k3 = kernels.paged_verify_attention.launches
    a, b = got.output_ids, ref.output_ids
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    worst = max(((got.logits[i] - ref.logits[i]).abs().max()
                 / ref.logits[i].abs().max()).item()
                for i in range(min(n + 1, len(a), len(b))))
    tie = None
    if a != b:
        if n == min(len(a), len(b)):
            raise AssertionError(f"FSM lane: one stream ends inside the "
                                 f"other: {a} vs {b}")
        la, lb = got.logits[n], ref.logits[n]
        tie = {"position": n, "margin": (lb[b[n]] - lb[a[n]]).item(),
               "max_abs_dlogit": (la - lb).abs().max().item()}
        if not tie["margin"] <= 2 * tie["max_abs_dlogit"]:
            raise AssertionError(f"FSM lane streams part outside the flip "
                                 f"bound: {tie}")
    out = {"tokens": len(a), "ref_tokens": len(b), "same_tokens": n,
           "identical": a == b, "logits_rel_err": worst, "near_tie": tie,
           "k3_launches": k3, "finish_reason": got.finish_reason, **moved}
    log(f"engine (speculative_k=4, fetch_lag 0, a device-FSM grammar lane "
        f"with forced proposals): {moved['verify_steps']} verify steps, "
        f"K3={k3}, accepted {moved['speculation_accepted_tokens']}/"
        f"{moved['speculation_proposed_tokens']} proposed; FSM tokens "
        f"{moved['constrained_ondevice_tokens']}; {len(a)} tokens, equal to "
        f"speculation off: {a == b} ({n} shared), worst logits "
        f"max|d|/max|ref| = {worst:.4f} (tol {LOGITS_RTOL}); near-tie {tie}")
    if moved["verify_steps"] == 0 or k3 == 0 or \
            moved["speculation_accepted_tokens"] == 0:
        raise AssertionError(f"the grammar lane did not speculate: {out}")
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"FSM lane logits disagree: {worst}")
    if spec_eng.self_check():
        raise AssertionError(f"FSM lane: {spec_eng.self_check()}")
    return out


def engine_speculative_k8(cfg, params, prompts, got, max_new: int) -> dict:
    """Fault C4 on the card: speculative_k = 8 (36 query rows per kv head
    at G 4, past the 32 the old K3 held) on the full-width model, each
    lane's proposer offering the spec-off kernel engine's continuation.
    K3 must launch and tokens be accepted; the greedy streams must equal
    the spec-off streams, where they part only at a bf16 near-tie of the
    spec-off logits (_near_ties), with logits within LOGITS_RTOL up to
    there."""
    import torch

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import InferenceEngine

    eng = InferenceEngine(cfg, params, _engine_cfg(speculative_k=8,
                                                   fetch_lag=0))
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    sgot = _drive(eng, prompts, max_new, streams=[r.output_ids for r in got])
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    k3 = kernels.paged_verify_attention.launches
    prop, acc = eng.speculation_proposed_tokens, \
        eng.speculation_accepted_tokens
    same, agree, worst = _compare_streams(cfg, sgot, got, max_new)
    ties = _near_ties(sgot, got, max_new)
    total = max_new * len(prompts)
    log(f"engine (speculative_k=8, forced proposals): 8 requests in "
        f"{dt:.2f}s over {eng.verify_steps} verify steps, launches K3={k3} "
        f"K1={kernels.paged_decode_attention.launches}; accepted {acc}/{prop} "
        f"proposed; vs spec-off: {same}/8 identical greedy streams, token "
        f"agreement {agree}/{total}, worst logits max|d|/max|ref| = "
        f"{worst:.4f} (tol {LOGITS_RTOL}); where streams part: {ties}")
    if eng.verify_steps == 0 or k3 == 0 or acc == 0:
        raise AssertionError(f"speculative_k=8 engine: {eng.verify_steps} "
                             f"verify steps, K3 launches {k3}, accepted "
                             f"{acc}")
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"speculative_k=8 logits disagree: {worst}")
    if eng.self_check():
        raise AssertionError(f"speculative_k=8 engine: {eng.self_check()}")
    RESULTS["K3"]["engine_launches_k8"] = k3
    return {"seconds": dt, "verify_steps": eng.verify_steps,
            "k3_launches": k3, "proposed": prop, "accepted": acc,
            "identical_streams": same, "token_agreement": [agree, total],
            "logits_rel_err": worst, "near_ties": ties}


def engine_int8(cfg, params, prompts, max_new: int, rng) -> dict:
    """int8 weights + int8 KV: decode must go through K4 (and K1/K2 stay
    idle: prefill reads the int8 pool through the dequantizing gather);
    logits against the same int8 engine on plain attention; the int8
    model's logit quality against the bf16 one; a decode profile."""
    import torch

    from kafka_tpu_torch.models.llama import _layer
    from kafka_tpu_torch.models.quant import dequantize, quantize_params
    from kafka_tpu_torch.models.quant_quality import logit_quality_metrics
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import InferenceEngine

    qparams = quantize_params(params)
    eng = InferenceEngine(cfg, qparams, _engine_cfg(kv_quantize="int8"))
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    got = _drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launched = {f.__name__: f.launches for f in kernels.KERNELS}
    k4 = launched["paged_decode_attention_int8"]
    log(f"engine (int8 weights + int8 KV): 8 requests in {dt:.2f}s, "
        f"launches {launched}")
    if k4 == 0 or launched["paged_decode_attention"] or \
            launched["paged_prefill_attention"]:
        raise AssertionError(f"int8 engine launches: {launched}")
    plain = InferenceEngine(cfg, qparams, _engine_cfg(
        kv_quantize="int8", attention_backend="plain"))
    kernels.reset_launch_counts()
    ref = _drive(plain, prompts, max_new)
    if any(f.launches for f in kernels.KERNELS):
        raise AssertionError("the plain int8 engine launched a kernel")
    same, agree, worst = _compare_streams(cfg, got, ref, max_new)
    total = max_new * len(prompts)
    log(f"int8 engine vs plain int8 engine: {same}/8 identical greedy "
        f"streams, token agreement {agree}/{total}, worst logits "
        f"max|d|/max|ref| = {worst:.4f} (tol {LOGITS_RTOL})")
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"int8 engine logits disagree: {worst}")
    if eng.self_check():
        raise AssertionError(f"int8 engine: {eng.self_check()}")
    del plain
    quality_prompts = [rng.randint(0, cfg.vocab_size, size=64).tolist()
                       for _ in range(4)]
    quality = logit_quality_metrics(cfg, params, qparams, quality_prompts)
    log(f"int8 vs bf16 logit quality: {quality}")
    if not quality["flip_margin_max"] <= 2 * quality["max_abs_dlogit"]:
        raise AssertionError(f"flip outside the analytic bound: {quality}")
    # what the int8 step adds: every matmul weight dequantized to bf16 once
    # per layer per step, and the LM head's codes cast to bf16
    layers = qparams["layers"]
    names = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

    def dequant_all():
        for l in range(cfg.num_layers):
            for n in names:
                dequantize(_layer(layers[n], l), torch.bfloat16)
        qparams["embed"].q.to(torch.bfloat16)

    dequant_ms = time_ms(dequant_all, iters=5, warmup=1)
    log(f"int8 decode step: weight dequant materialised per step "
        f"{dequant_ms:.3f} ms (CUDA events, all layers + LM head)")
    RESULTS["K4"]["engine_launches"] = k4
    return {"seconds": dt, "launches": launched, "identical_streams": same,
            "token_agreement": [agree, total], "logits_rel_err": worst,
            "logit_quality": quality, "dequant_ms_per_step": dequant_ms}


def prefix_turns(eng, cold, cfg, rng) -> dict:
    import torch

    from kafka_tpu_torch.models import llama
    from kafka_tpu_torch.ops import kernels

    first = rng.randint(0, cfg.vocab_size, size=300).tolist()
    t1 = eng.generate(first, max_new_tokens=16, prefix_key="smoke-thread")
    second = first + t1.output_ids + \
        rng.randint(0, cfg.vocab_size, size=40).tolist()
    starts = []
    real = llama.paged_prefill_attention

    def spy(q, k, v, row, start, chunk_len, **kw):
        starts.append(start)
        return real(q, k, v, row, start, chunk_len, **kw)

    llama.paged_prefill_attention = spy
    kernels.reset_launch_counts()
    try:
        t2 = eng.generate(second, max_new_tokens=16,
                          prefix_key="smoke-thread")
        torch.cuda.synchronize()
    finally:
        llama.paged_prefill_attention = real
    k2 = kernels.paged_prefill_attention.launches
    ref = cold.generate(second, max_new_tokens=1)
    rel = ((t2.logits[0] - ref.logits[0]).abs().max()
           / ref.logits[0].abs().max()).item()
    out = {"turn2_prompt_tokens": len(second),
           "turn2_cached_tokens": t2.cached_tokens,
           "cache_source": t2.cache_source, "k2_launches": k2,
           "k2_starts": sorted(set(starts)), "first_logits_rel_err": rel}
    log(f"prefix reuse: turn 2 of {len(second)} tokens cached "
        f"{t2.cached_tokens} ({t2.cache_source}); K2 launches {k2} at "
        f"starts {out['k2_starts']}; first logits vs a cold engine "
        f"max|d|/max|ref| = {rel:.4f} (tol {LOGITS_RTOL})")
    if t2.cached_tokens <= 0 or k2 == 0 or min(starts) <= 0:
        raise AssertionError(f"turn 2 did not reuse the prefix: {out}")
    if not rel <= LOGITS_RTOL:
        raise AssertionError(f"turn 2 logits disagree: {rel}")
    if eng.self_check():
        raise AssertionError(f"prefix engine: {eng.self_check()}")
    return out


# ---------------------------------------------------------------------------
# phase 2b: the decode pipeline's CUDA graphs at full width
# ---------------------------------------------------------------------------


class ReplayClock:
    """Stands in for an engine's _run_step: counts the decode steps each
    dispatch runs and, while `timing`, brackets each replay with CUDA
    events (the device time of the graph, whatever the host does around
    it) and records the host's time inside the replay call."""

    def __init__(self, eng):
        self.real = eng._run_step
        self.steps = 0
        self.timed_steps = 0
        self.pairs = []
        self.host_s = []
        self.starts = []
        self.timing = False
        eng._run_step = self

    def __call__(self, k, *args):
        import torch

        self.steps += k
        if not self.timing:
            return self.real(k, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        self.starts.append(t0)
        self.real(k, *args)
        self.host_s.append(time.perf_counter() - t0)
        end.record()
        self.pairs.append((start, end))
        self.timed_steps += k

    def device_ms(self) -> float:
        return sum(self.pair_ms())

    def pair_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def eager_body(eng):
    """Run an engine's step body eagerly on the card instead of replaying
    its graphs: the smoke's reference for the graphs (the engine itself
    never runs the body outside a graph on CUDA)."""
    def run(k, fsm, mode, masked):
        keep = eng.ecfg.keep_logits
        eng._step_buffers(k, keep)
        eng._decode_body(k, fsm, mode, masked, keep)

    eng._run_step = run


def _graph_engine_run(cfg, params, prompts, max_new, name, eager=False,
                      sampled=(), **kw):
    """8 requests submitted together through one engine; returns (requests,
    engine, clock, K1/K4 launches).  The counters are zeroed just before
    and read just after; `sampled` indexes take temperature 0.8, top_p
    0.95."""
    import torch

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import GenRequest, InferenceEngine

    eng = InferenceEngine(cfg, params, _engine_cfg(**kw))
    clock = None
    if eager:
        eager_body(eng)
    else:
        clock = ReplayClock(eng)
    reqs = [GenRequest(request_id=f"{name}{i}", prompt_ids=p,
                       max_new_tokens=max_new,
                       **(dict(temperature=0.8, top_p=0.95, seed=7 + i)
                          if i in sampled else {}))
            for i, p in enumerate(prompts)]
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launched = {f.__name__: f.launches for f in kernels.KERNELS}
    if eng.self_check():
        raise AssertionError(f"{name}: {eng.self_check()}")
    return reqs, eng, clock, launched, dt


def _check_replay_launches(name, eng, clock, launched, kernel, layers):
    """The decode kernel's counter against the graphs that ran: each
    replay of a k-step graph adds k x layers (a replay launches without
    Python), each capture's eager warm-up k x layers.  Both sides are
    derived from the same bookkeeping, so this holds the accounting, not
    the launches: the proof that a replay ran the kernel is the graph
    logits equal to the eager body's bit for bit (phase_graphs), and the
    kernel events the profiler catches inside replays (replay_kernels)."""
    warm = sum(key[0] for key in eng._graphs)
    want = (clock.steps + warm) * layers
    got = launched[kernel]
    log(f"  {name}: {kernel} launches {got} = ({clock.steps} replayed "
        f"steps + {warm} warm-up steps) x {layers} layers; "
        f"{eng.graph_replays} replays, {eng.multi_step_dispatches} fused, "
        f"graphs {sorted(eng._graphs)}")
    if got != want or got == 0:
        raise AssertionError(f"{name}: {kernel} launches {got}, want {want}")


def replay_kernels(eng, clock, steps: int = 4) -> dict:
    """Device time by kernel name inside the graph replays of `steps`
    scheduler steps (torch.profiler), beside the CUDA-event time of the
    same replays: the profiler may drop events (PERF.md §7), so the
    caught share is reported with the split."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    clock.pairs, clock.starts, clock.timed_steps = [], [], 0
    clock.timing = True
    try:
        prof_ctx = profile(activities=[ProfilerActivity.CUDA],
                           acc_events=True)
    except TypeError:  # a torch without acc_events
        prof_ctx = profile(activities=[ProfilerActivity.CUDA])
    with prof_ctx as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    clock.timing = False
    event_ms = clock.device_ms()
    n = max(clock.timed_steps, 1)
    kern = [(e.key, getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0)))
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    caught_ms = sum(t for _, t in kern) / 1e3
    kern.sort(key=lambda kv: -kv[1])
    # the decode kernels' launches the profiler saw inside the replays, a
    # direct count beside the engine's derived one (its counters add the
    # capture's ticks per replay)
    caught = {name: sum(e.count for e in prof.key_averages()
                        if getattr(e, "device_type", None) == DeviceType.CUDA
                        and name in e.key)
              for name in ("paged_decode_chunk_kernel",
                           "paged_decode_int8_chunk_kernel")}
    out = {"steps": clock.timed_steps, "event_ms_per_step": event_ms / n,
           "profiler_ms_per_step": caught_ms / n,
           "profiler_decode_kernel_launches": caught,
           "top": [(k[:70], t / 1e3 / n) for k, t in kern[:10]]}
    log(f"    by kernel over {clock.timed_steps} replayed steps: profiler "
        f"{out['profiler_ms_per_step']:.3f} ms/step of the events' "
        f"{out['event_ms_per_step']:.3f}; decode chunk kernel launches "
        f"caught {caught}")
    for name, ms in out["top"]:
        log(f"      {ms:.4f} ms/step  {name}")
    return out


def _trace_requests(reqs) -> list:
    """Give each request a trace of its own, as the server's tracing
    middleware does: the engine then records its queue, prefill, decode
    and emit spans.  Returns the root spans (finish_trace them)."""
    from kafka_tpu_torch import tracing

    roots = []
    for r in reqs:
        root = tracing.start_trace(request_id=r.request_id,
                                   name="smoke.request")
        r.trace = tracing.current()
        if r.trace is None:
            raise AssertionError("tracing is off (KAFKA_TORCH_TRACE_SAMPLE)")
        roots.append((root, r.trace.trace_id))
    return roots


def _finish_traces(roots) -> int:
    """Close the traces; the engine.decode spans they recorded."""
    from kafka_tpu_torch import tracing

    n = 0
    for root, trace_id in roots:
        tracing.finish_trace(root)
        trace = tracing.get_trace(trace_id)
        n += sum(sp.name == "engine.decode" for sp in trace.spans)
    return n


def graph_profile(eng, clock, cfg, rng, width: int = 8, ctx: int = 256,
                  max_new: int = 200, sampled: bool = False,
                  by_kernel: bool = False, traced: bool = False,
                  registry: bool = False) -> dict:
    """The decode pipeline at `width` lanes of ~`ctx` tokens: host-clock
    wall time over a steady window of scheduler steps (every lane active,
    ending in a synchronize), CUDA events around each graph replay in it,
    and the tokens the window dispatched.  `sampled`: every lane at
    temperature 0.8, top_p 0.95 (the threefry draw and the filter's sort
    inside each step).  `by_kernel`: first a profiled pass over a few
    steps (replay_kernels).  `traced`: every request carries a trace, so
    the engine records its spans (decode spans as each fetch lands).
    `registry`: the metrics registry's decode counters over the same
    window, its bandwidth utilization beside the window's modeled bytes
    over the CUDA-event device time."""
    import torch

    from kafka_tpu_torch.runtime import GenRequest

    eng.ecfg.keep_logits = False  # no per-step logits copy in the window
    kw = dict(temperature=0.8, top_p=0.95) if sampled else {}
    reqs = [GenRequest(request_id=f"prof{'t' if traced else ''}{i}",
                       max_new_tokens=max_new,
                       prompt_ids=rng.randint(0, cfg.vocab_size,
                                              size=ctx).tolist(),
                       seed=i, **kw)
            for i in range(width)]
    roots = _trace_requests(reqs) if traced else []
    for r in reqs:
        eng.submit(r)
    while any(r.state != "active" for r in reqs):
        eng.step()
    # one fused burst and every graph captured before the window
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    split = replay_kernels(eng, clock) if by_kernel else None
    k = eng.ecfg.multi_step
    clock.pairs, clock.starts, clock.timed_steps = [], [], 0
    clock.timing = True
    d0 = sum(r.dispatched for r in reqs)
    u = eng.metrics.util["decode"]
    u0 = (u.hbm_bytes, u.busy_s, u.dispatches)
    t0 = time.perf_counter()
    while all(r.state == "active" and r.max_new_tokens - r.dispatched > k + 1
              for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    du = (u.hbm_bytes - u0[0], u.busy_s - u0[1], u.dispatches - u0[2])
    clock.timing = False
    tokens = sum(r.dispatched for r in reqs) - d0
    pair_ms = clock.pair_ms()
    dev_ms = sum(pair_ms)
    gaps = [b - a for a, b in zip(clock.starts, clock.starts[1:])]
    steps = clock.timed_steps
    for r in reqs:
        eng.cancel(r.request_id)
    while eng.has_work:
        eng.step()
    decode_spans = _finish_traces(roots)
    if traced and decode_spans == 0:
        raise AssertionError("traced requests recorded no engine.decode span")
    out = {
        "lanes": width, "ctx": ctx, "multi_step": k, "sampled": sampled,
        "traced": traced, "decode_spans": decode_spans, "steps": steps,
        "tokens": tokens, "wall_ms": wall_ms,
        "host_ms_per_step": wall_ms / steps,
        "host_ms_per_token": wall_ms / tokens,
        "device_ms_per_step": dev_ms / steps,
        "device_busy_share": dev_ms / wall_ms,
        "tokens_per_s": tokens / wall_ms * 1e3,
        # each replay's CUDA-event span and the host's gaps between
        # replay calls: a short span or a long gap places a low busy share
        "replays": len(pair_ms),
        "replay_ms_min": min(pair_ms, default=0.0),
        "replay_ms_max": max(pair_ms, default=0.0),
        "call_gap_ms_max": max(gaps, default=0.0) * 1e3,
        "by_kernel": split,
    }
    if registry:
        # the registry charges a dispatch when its tokens land, so its
        # window holds the dispatches that landed in it; per dispatch its
        # modeled bytes over its busy time, against the same bytes per
        # step over the window's CUDA-event time per step
        peak = eng.metrics.peak_hbm_bps or PEAK_HBM_BYTES
        util = du[0] / du[1] / peak if du[1] > 0 else 0.0
        step_bytes = du[0] / max(du[2], 1) / k
        ev = step_bytes / (dev_ms / steps / 1e3) / peak
        out["registry"] = {"hbm_bytes": du[0], "busy_s": du[1],
                           "dispatches": du[2], "hbm_bw_util": util,
                           "modeled_bytes_per_step": step_bytes,
                           "event_hbm_bw_util": ev, "ratio": util / ev}
    log(f"  decode, {width} {'sampled' if sampled else 'greedy'}"
        f"{' traced' if traced else ''} lanes at ~{ctx} tokens, multi_step "
        f"{k}: "
        f"{out['host_ms_per_step']:.3f} ms host clock per step (each "
        f"lane's token), {out['host_ms_per_token']:.4f} ms per generated "
        f"token, device {out['device_ms_per_step']:.3f} ms/step (CUDA "
        f"events around replays), busy share "
        f"{out['device_busy_share']:.3f}, {out['tokens_per_s']:.0f} "
        f"tokens/s over {steps} steps ({len(pair_ms)} replays of "
        f"{out['replay_ms_min']:.3f}-{out['replay_ms_max']:.3f} ms, the "
        f"longest host gap between replay calls "
        f"{out['call_gap_ms_max']:.3f} ms)")
    return out


def host_step_cost(eng, clock, cfg, rng, width: int, reps: int = 32,
                   traced: bool = False) -> dict:
    """The host's own time per scheduler step() at `width` lanes of ~64
    tokens, at multi_step 1 and 16 (the engine's depth is switched
    between windows), with the device kept out of it: fetch_lag and
    fetch_wait_s are raised inside each window so no step() pops, and so
    waits on, a fetch; a step() then only enqueues its work.  Each depth
    runs a warm window (captures, pinned staging blocks) and a measured
    one, each followed by a full drain.  Reports the median host ms per
    step() and per replay call, the per-decode-step host ms, and the
    device ms per step from CUDA events around the measured replays: the
    pipeline is host-bound at a depth where the host's ms per decode step
    exceeds the device's.  The window's fetches are then processed after
    a synchronize, so that drain is host work alone: reported per step()
    call (`host_ms_per_drained_call`).  `traced`: every request carries a
    trace; its decode spans are recorded in that drain."""
    import torch

    from kafka_tpu_torch.runtime import GenRequest

    eng.ecfg.keep_logits = False
    ecfg = eng.ecfg
    lag, wait, depth = ecfg.fetch_lag, ecfg.fetch_wait_s, ecfg.multi_step
    reqs = [GenRequest(request_id=f"host{width}{'t' if traced else ''}_{i}",
                       max_new_tokens=2 * (reps + 2) * 16 + 32,
                       prompt_ids=rng.randint(0, cfg.vocab_size,
                                              size=64).tolist())
            for i in range(width)]
    roots = _trace_requests(reqs) if traced else []
    for r in reqs:
        eng.submit(r)
    while any(r.state != "active" for r in reqs):
        eng.step()
    out = {"lanes": width}
    try:
        for k in (1, 16):
            ecfg.multi_step = k
            n = reps if k == 1 else max(4, reps // 8)
            for measured in (False, True):
                ecfg.fetch_lag, ecfg.fetch_wait_s = 1 << 30, 1e9
                clock.pairs, clock.host_s, clock.timed_steps = [], [], 0
                clock.timing = True
                d0 = sum(r.dispatched for r in reqs)
                calls = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    eng.step()
                    calls.append(time.perf_counter() - t0)
                clock.timing = False
                steps = (sum(r.dispatched for r in reqs) - d0) // width
                ecfg.fetch_lag, ecfg.fetch_wait_s = lag, wait
                dev_ms = clock.device_ms()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._drain(block=True)
                drain_ms = (time.perf_counter() - t0) * 1e3
                if not measured:
                    continue
                if any(r.state != "active" for r in reqs) or \
                        steps != n * k:
                    raise AssertionError(
                        f"host cost window at {width} lanes, multi_step "
                        f"{k}: {steps} steps of {n * k}, states "
                        f"{[r.state for r in reqs]}")
                step_ms = 1e3 * sorted(calls)[n // 2]
                out[k] = {
                    "step_calls": n, "decode_steps": steps,
                    "host_ms_per_step_call": step_ms,
                    "host_ms_per_decode_step": step_ms / k,
                    "host_ms_per_replay_call":
                        1e3 * sorted(clock.host_s)[len(clock.host_s) // 2],
                    "device_ms_per_step": dev_ms / clock.timed_steps,
                    "host_ms_per_drained_call": drain_ms / n,
                }
    finally:
        ecfg.fetch_lag, ecfg.fetch_wait_s, ecfg.multi_step = lag, wait, depth
        clock.timing = False
    for r in reqs:
        eng.cancel(r.request_id)
    while eng.has_work:
        eng.step()
    out["traced"], out["decode_spans"] = traced, _finish_traces(roots)
    if traced and out["decode_spans"] == 0:
        raise AssertionError("traced requests recorded no engine.decode span")
    for k in (1, 16):
        o = out[k]
        log(f"  host cost, {width}{' traced' if traced else ''} lanes, "
            f"multi_step {k}: "
            f"{o['host_ms_per_step_call']:.3f} ms host per step() call "
            f"({o['host_ms_per_decode_step']:.3f} per decode step), "
            f"{o['host_ms_per_replay_call']:.3f} ms inside the replay call; "
            f"device {o['device_ms_per_step']:.3f} ms/step (median of "
            f"{o['step_calls']} calls, no fetch popped); then "
            f"{o['host_ms_per_drained_call']:.3f} ms host per call's fetch "
            f"processed")
    return out


def _parked_first_token(eng, cfg, rng) -> dict:
    """12 requests on 8 slots: each of the 4 past the slots must reach the
    host with its first token (prefilled off-slot, parked) while all 8
    slot lanes still hold their slots."""
    import torch

    from kafka_tpu_torch.runtime import GenRequest

    max_new = 120
    reqs = [GenRequest(request_id=f"park{i}", max_new_tokens=max_new,
                       prompt_ids=rng.randint(0, cfg.vocab_size,
                                              size=64).tolist())
            for i in range(12)]
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    extra = reqs[8:]
    parked_seen = 0
    while any(r.first_token_time is None for r in extra):
        eng.step()
        parked_seen = max(parked_seen, len(eng.parked))
        if any(r.state in ("draining", "finished") for r in reqs[:8]):
            raise AssertionError("a slot freed before the parked requests' "
                                 "first tokens arrived")
    last = max(r.first_token_time for r in extra) - t0
    eng.run_to_completion()
    torch.cuda.synchronize()
    done = [len(r.output_ids) for r in reqs]
    out = {"parked_max": parked_seen, "finished_tokens": done,
           "last_parked_first_token_s": last}
    log(f"  parking: 12 requests on 8 slots, up to {parked_seen} parked; "
        f"the four past the slots had their first tokens {last:.3f}s after "
        f"submit, every slot lane still active; tokens {done}")
    if parked_seen == 0 or done != [max_new] * 12:
        raise AssertionError(f"parking: {out}")
    return out


def _caught_launches(split: dict, key: str, kernel: str, layers: int):
    """The profiler's count of a decode kernel inside the profiled
    replays, beside the engine's derived count (replayed steps x
    layers); the profiler may drop events, so it must only see some."""
    caught = split["profiler_decode_kernel_launches"][kernel]
    derived = split["steps"] * layers
    log(f"  {kernel}: the profiler caught {caught} launches inside "
        f"{split['steps']} replayed steps; the counter's derived count "
        f"is {derived}")
    if caught == 0:
        raise AssertionError(f"no {kernel} event inside the replays")
    if key in RESULTS:
        RESULTS[key]["replay_profiler_launches"] = {
            "caught": caught, "derived": derived, "steps": split["steps"]}
        RESULTS[key]["launch_count_basis"] = (
            "decode graph replays x layers, ticked per replay from the "
            "capture (derived); replay_profiler_launches is the "
            "profiler's direct count")


def _profile_engine(cfg, params, **kw):
    from kafka_tpu_torch.runtime import InferenceEngine

    eng = InferenceEngine(cfg, params, _engine_cfg(**kw))
    return eng, ReplayClock(eng)


def phase_graphs(seed: int) -> None:
    """The decode pipeline on the card: every decode a graph replay, at
    multi_step 1 and 16, against the eager body and plain attention, K1
    and K4 counted per replay, a sampled lane, a parked request, and the
    host / device / busy / tokens-per-second profile."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params
    from kafka_tpu_torch.models.quant import quantize_params

    cfg = get_config("llama-3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(seed + 1)
    lens = [40, 50, 90, 120, 200, 300, 450, 600]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    max_new = 40
    L = cfg.num_layers
    res = {}
    log("graphs: llama-3.2-1b, 8 greedy requests, every decode a replay")
    runs = {}
    for name, kw in (("g1_", dict(multi_step=1)),
                     ("g16_", dict(multi_step=16)),
                     ("eager_", dict(multi_step=16, eager=True)),
                     ("plain_", dict(multi_step=16,
                                     attention_backend="plain"))):
        reqs, eng, clock, launched, dt = _graph_engine_run(
            cfg, params, prompts, max_new, name, **kw)
        if clock is not None and name != "plain_":
            _check_replay_launches(name, eng, clock, launched,
                                   "paged_decode_attention", L)
        if name == "g16_" and eng.multi_step_dispatches == 0:
            raise AssertionError("multi_step=16 never fused a burst")
        runs[name] = (reqs, eng, clock)
        log(f"  {name}: {dt:.2f}s, launches {launched}")
    streams = {n: [r.output_ids for r in v[0]] for n, v in runs.items()}
    same = streams["g1_"] == streams["g16_"] == streams["eager_"]
    d_eager = max(
        (a - b).abs().max().item()
        for ra, rb in zip(runs["g16_"][0], runs["eager_"][0])
        for a, b in zip(ra.logits, rb.logits))
    d_g1 = max(
        (a - b).abs().max().item()
        for ra, rb in zip(runs["g16_"][0], runs["g1_"][0])
        for a, b in zip(ra.logits, rb.logits))
    p_same, p_agree, p_worst = _compare_streams(
        cfg, runs["g16_"][0], runs["plain_"][0], max_new)
    log(f"  streams multi_step 1 == 16 == eager body: {same}; logits "
        f"max|d| graph16 vs eager {d_eager}, vs graph1 {d_g1}; vs plain "
        f"attention: {p_same}/8 identical, worst max|d|/max|ref| "
        f"{p_worst:.4f} (tol {LOGITS_RTOL})")
    if not same:
        raise AssertionError("graph streams differ from the eager body's")
    # the replays run the eager body's kernels in its order: their logits
    # equal it bit for bit, which shows K1 ran inside the graphs
    if d_eager != 0.0 or d_g1 != 0.0:
        raise AssertionError(f"graph logits differ from the eager body's: "
                             f"{d_eager} (16-step), {d_g1} (1-step vs "
                             f"16-step)")
    if not p_worst <= LOGITS_RTOL:
        raise AssertionError(f"graph logits vs plain: {p_worst}")
    res["streams_equal"] = same
    res["logits_max_abs_vs_eager"] = d_eager
    res["logits_max_abs_g16_vs_g1"] = d_g1
    res["vs_plain"] = {"identical_streams": p_same,
                       "token_agreement": p_agree, "logits_rel_err": p_worst}
    del runs["plain_"], runs["g1_"]
    torch.cuda.empty_cache()

    # a sampled lane riding fused bursts beside three greedy ones
    samp = {}
    for name, kw in (("s16_", {}), ("seager_", dict(eager=True))):
        reqs, eng, _, _, _ = _graph_engine_run(
            cfg, params, prompts[:4], max_new, name, sampled=(1,),
            multi_step=16, **kw)
        samp[name] = [r.output_ids for r in reqs]
        if name == "s16_" and eng.multi_step_dispatches == 0:
            raise AssertionError("the sampled batch never fused")
    log(f"  sampled lane (temperature 0.8, top_p 0.95) in fused bursts: "
        f"stream equals the eager body's: {samp['s16_'] == samp['seager_']}")
    if samp["s16_"] != samp["seager_"]:
        raise AssertionError("sampled graph stream differs from eager")
    res["sampled_equal"] = True

    eng16, clock16 = runs["g16_"][1], runs["g16_"][2]
    del runs
    res["parking"] = _parked_first_token(eng16, cfg, rng)
    profiles = {"bf16": {}, "int8": {}}
    profiles["bf16"][16] = graph_profile(eng16, clock16, cfg, rng)
    profiles["bf16"]["16_sampled"] = graph_profile(eng16, clock16, cfg, rng,
                                                   sampled=True)
    profiles["bf16"]["16_traced"] = graph_profile(eng16, clock16, cfg, rng,
                                                  traced=True)
    del eng16
    eng1, clock1 = _profile_engine(cfg, params, multi_step=1)
    profiles["bf16"][1] = graph_profile(eng1, clock1, cfg, rng,
                                        by_kernel=True)
    profiles["bf16"]["1_traced"] = graph_profile(eng1, clock1, cfg, rng,
                                                 traced=True)
    # tracing keeps decode device-bound: spans are stamped as fetches land
    for key in ("16_traced", "1_traced"):
        if profiles["bf16"][key]["device_busy_share"] < TRACED_BUSY_MIN:
            raise AssertionError(f"traced decode busy share "
                                 f"{profiles['bf16'][key]}")
    _caught_launches(profiles["bf16"][1]["by_kernel"], "K1",
                     "paged_decode_chunk_kernel", L)
    del eng1
    torch.cuda.empty_cache()
    # the host's own cost per step, at the 8 lanes of the profile and at
    # a 32-lane batch: the device step time below which fusion would pay
    host = {}
    for width in (8, 32):
        eng, clock = _profile_engine(cfg, params, multi_step=16,
                                     max_batch=width)
        host[width] = host_step_cost(eng, clock, cfg, rng, width)
        if width == 8:
            # the host's cost of tracing: the same windows, every request
            # traced
            host["8_traced"] = host_step_cost(eng, clock, cfg, rng, width,
                                              traced=True)
        del eng
        torch.cuda.empty_cache()
    res["host_cost"] = host

    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    for k in (1, 16):
        reqs, eng, clock, launched, dt = _graph_engine_run(
            cfg, qparams, prompts, max_new, f"q{k}_", multi_step=k,
            kv_quantize="int8")
        _check_replay_launches(f"int8 KV, multi_step {k}", eng, clock,
                               launched, "paged_decode_attention_int8", L)
        if launched["paged_decode_attention"]:
            raise AssertionError("the int8-KV engine launched K1")
        profiles["int8"][k] = graph_profile(eng, clock, cfg, rng,
                                            by_kernel=k == 1)
        if k == 1:
            _caught_launches(profiles["int8"][1]["by_kernel"], "K4",
                             "paged_decode_int8_chunk_kernel", L)
        del eng
        torch.cuda.empty_cache()
    res["profiles"] = profiles
    RESULTS["graphs"] = res


# ---------------------------------------------------------------------------
# phase 3: the HTTP server
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _stream(session, url: str, body: dict, timing=None,
                  headers=None, allow_error: bool = False) -> list:
    """POST a streamed request; its parsed events.  timing (a dict), if
    given, gets `ttft_s`: host-clock seconds from the request to the first
    event carrying generated content or a tool call.  An error event
    raises unless allow_error."""
    events = []
    t0 = time.monotonic()
    async with session.post(url, json=body, headers=headers) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url}: HTTP {resp.status} "
                                 f"{await resp.text()}")
        async for raw in resp.content:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
                if timing is not None and "ttft_s" not in timing and \
                        ('"content"' in line or '"tool_calls"' in line):
                    timing["ttft_s"] = time.monotonic() - t0
    if not events or events[-1] != "[DONE]":
        raise AssertionError(f"{url}: stream did not end with [DONE]: "
                             f"{events[-3:]}")
    parsed = [json.loads(e) for e in events[:-1]]
    errors = [e for e in parsed if e.get("type") == "error"]
    if errors and not allow_error:
        raise AssertionError(f"{url}: error event {errors[0]}")
    return parsed


def _usage(events: list) -> dict:
    for e in events:
        if e.get("object") == "chat.completion.chunk" and e.get("usage"):
            return e["usage"]
    raise AssertionError("no usage chunk in stream")


async def _serve_and_query(db_path: str) -> dict:
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app

    from kafka_tpu_torch.agents import IDLE_TOOL
    from kafka_tpu_torch.server.app import STATE_KEY

    # the built-in tools (create_app's default): a 4096-token window and
    # buckets up to 2048, so a cold turn prefills 2048-row chunks
    cfg = ServingConfig(
        model_name="llama-3.2-1b", max_batch=8, page_size=16,
        num_pages=8 * 256 + 64, max_pages_per_seq=256,
        prefill_buckets=(64, 128, 256, 512, 1024, 2048),
        max_new_tokens_default=32, db_path=db_path, multi_step=16,
        system_prompt="You are a terse assistant.",
    )
    t0 = time.monotonic()
    # no MCP server: the reference's default dials a remote one
    app = await create_app(cfg, mcp_servers=[])
    log(f"server: create_app(llama-3.2-1b) built in "
        f"{time.monotonic() - t0:.1f}s")
    state = app[STATE_KEY]
    tool_defs = state["kafka"].get_tools() + [IDLE_TOOL]
    schema_tokens = len(state["llm"].tokenizer.encode(
        json.dumps(tool_defs, indent=2)))
    names = sorted(t["function"]["name"] for t in tool_defs)
    log(f"server: {len(tool_defs)} tools rendered ({', '.join(names)}), "
        f"{schema_tokens} tokens of schemas")
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    base = f"http://127.0.0.1:{port}"
    kernels.reset_launch_counts()
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            t1 = time.monotonic()
            timing: dict = {}
            ev1 = await _stream(s, f"{base}/v1/threads/smoke/chat/completions",
                                {"model": "llama-3.2-1b", "stream": True,
                                 "temperature": 0, "max_tokens": 16,
                                 "messages": [{"role": "user", "content":
                                               "Tell me about paged "
                                               "attention on a GPU."}]},
                                timing, headers={"X-Request-Id": "turn1"})
            ev2 = await _stream(s, f"{base}/v1/threads/smoke/chat/completions",
                                {"model": "llama-3.2-1b", "stream": True,
                                 "temperature": 0, "max_tokens": 16,
                                 "messages": [{"role": "user",
                                               "content": "And in short?"}]})
            # a second cold prefill of the tool-laden prompt, after turn 1
            # has met every shape once
            timing3: dict = {}
            ev3 = await _stream(s, f"{base}/v1/chat/completions",
                                {"model": "llama-3.2-1b", "stream": True,
                                 "temperature": 0, "max_tokens": 16,
                                 "messages": [{"role": "user",
                                               "content": "Hello!"}]},
                                timing3)
            out["seconds"] = time.monotonic() - t1
            u1, u2 = _usage(ev1), _usage(ev2)
            if u1["prompt_tokens"] <= schema_tokens:
                raise AssertionError(f"turn 1's prompt ({u1['prompt_tokens']}"
                                     f") does not hold the tool schemas "
                                     f"({schema_tokens} tokens)")
            reasons = [e.get("reason") for e in ev1 + ev2 if
                       e.get("type") == "agent_done"]
            if len(reasons) != 2 or not set(reasons) <= {
                    "text_response", "idle", "max_iterations"}:
                raise AssertionError(f"agent_done reasons {reasons}")
            if u2["prompt_tokens"] <= u1["prompt_tokens"] + \
                    u1["completion_tokens"]:
                raise AssertionError(f"turn 2 prompt ({u2['prompt_tokens']}) "
                                     "does not hold turn 1")
            cached = (u2.get("prompt_tokens_details") or {}).get(
                "cached_tokens", 0)
            if not 0 < cached < u2["prompt_tokens"]:
                raise AssertionError(f"turn 2 did not hit the prefix cache: "
                                     f"{u2}")
            async with s.get(f"{base}/v1/threads/smoke/messages") as r:
                msgs = (await r.json())["messages"]
            roles = [m["role"] for m in msgs]
            if roles != ["user", "assistant", "user", "assistant"]:
                raise AssertionError(f"thread history {roles}")
            async with s.get(f"{base}/health") as r:
                health = await r.json()
            async with s.get(f"{base}/v1/models") as r:
                models = await r.json()
            # the cold turn's TTFT from its span tree
            async with s.get(f"{base}/debug/trace/turn1") as r:
                out["turn1_spans"] = ttft_breakdown(await r.json(),
                                                    timing.get("ttft_s"))
            out.update(turn1=u1, turn2=u2, turn3=_usage(ev3),
                       history=roles, health=health,
                       models=[m["id"] for m in models["data"]],
                       tool_schema_tokens=schema_tokens, tools=names,
                       agent_done_reasons=reasons,
                       turn1_ttft_s=timing.get("ttft_s"),
                       chat_ttft_s=timing3.get("ttft_s"))
    finally:
        out["K1"] = kernels.paged_decode_attention.launches
        out["K2"] = kernels.paged_prefill_attention.launches
        await runner.cleanup()
    return out


def ttft_breakdown(trace: dict, client_ttft_s) -> dict:
    """A turn's time to first token from its span tree (Chrome trace
    JSON of /debug/trace): the serving layer before the engine
    (http.request start -> the first engine.queue start: auth, the agent's
    setup, prompt render, tokenize), then the first model call's
    engine.queue (submit -> first prefill chunk), engine.prefill (first
    chunk -> last chunk dispatched) and emit (last dispatch -> first token
    on the host).  Their sum is the server's time to its first token;
    beside it the client's host-clock TTFT, every engine.prefill, the
    first engine.decode and every tool.exec."""
    spans = sorted((e for e in trace["traceEvents"] if e["ph"] == "X"),
                   key=lambda e: e["ts"])
    by: dict = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    root = by["http.request"][0]
    queue, prefill, emit = (by[n][0] for n in ("engine.queue",
                                               "engine.prefill", "emit"))
    out = {
        "serving_before_engine_ms": (queue["ts"] - root["ts"]) / 1e3,
        "engine.queue_ms": queue["dur"] / 1e3,
        "engine.prefill_ms": prefill["dur"] / 1e3,
        "emit_ms": emit["dur"] / 1e3,
        "first_token_on_host_ms": (emit["ts"] + emit["dur"]
                                   - root["ts"]) / 1e3,
        "client_ttft_ms": client_ttft_s * 1e3 if client_ttft_s else None,
        "engine.prefill_all_ms": [e["dur"] / 1e3 for e in by["engine.prefill"]],
        "prefill_tokens": [e["args"].get("tokens")
                           for e in by["engine.prefill"]],
        "first_engine.decode_ms": by["engine.decode"][0]["dur"] / 1e3
        if "engine.decode" in by else None,
        "tool.exec_ms": [e["dur"] / 1e3 for e in by.get("tool.exec", [])],
    }
    out["sum_ms"] = (out["serving_before_engine_ms"] + out["engine.queue_ms"]
                     + out["engine.prefill_ms"] + out["emit_ms"])
    return out


def _fmt_spans(b: dict) -> str:
    tools = ", ".join(f"{t:.2f}" for t in b["tool.exec_ms"]) or "none"
    return (f"serving before the engine {b['serving_before_engine_ms']:.2f} "
            f"+ engine.queue {b['engine.queue_ms']:.2f} + engine.prefill "
            f"{b['engine.prefill_ms']:.2f} ({b['prefill_tokens'][0]} tokens) "
            f"+ emit {b['emit_ms']:.2f} = {b['sum_ms']:.2f} ms to the first "
            f"token on the host (client host-clock TTFT "
            f"{b['client_ttft_ms']} ms); first engine.decode "
            f"{b['first_engine.decode_ms']} ms; tool.exec {tools} ms")


CONSTRAINED_PROMPT = "List what you can do for me, then finish."
CONSTRAINED_MAX_TOKENS = 96


def _wrap_free(g, stream: list, budget: int) -> int:
    """Tokens of `stream` emitted before either constrained path's wrap-up
    window (budget_left <= dist + wrap_slack; the compiled slack is at
    least the host mask's 4 characters): there the device FSM's and the
    host mask's rows are provably equal, so their greedy tokens must be.
    Inside it each path closes the JSON by its own rule (the host mask's
    fixed 4-character slack engages later), as in the JAX package."""
    state = 0
    for i, t in enumerate(stream):
        if budget - i <= int(g.dist[state]) + g.wrap_slack:
            return i
        state = g.walk([t], start=state)
        if state < 0:
            return i + 1
    return len(stream)


def _spy_submits(engine) -> list:
    """Record every request the provider hands the engine."""
    seen = []
    real = engine.submit

    def submit(req, *a, **kw):
        seen.append(req)
        return real(req, *a, **kw)

    engine.submit = submit
    return seen


async def _constrained_turn(session, url: str, tool_choice, engine, seen,
                            tokenizer, tool_defs) -> dict:
    """One greedy thread turn with `tool_choice`: it must be one model turn
    that ends `finish_reason: "tool_calls"`, its text a tool call that
    validate_tool_call_json accepts.  Returns its tokens and the engine's
    constrained counters moved by it."""
    from kafka_tpu_torch.llm.constrained import validate_tool_call_json

    keys = ("constrained_ondevice_tokens", "constrained_host_mask_steps",
            "constrained_mask_overtight", "constrained_degrades",
            "graph_captures", "graph_capture_s")
    before = {k: getattr(engine, k) for k in keys}
    n0 = len(seen)
    ev = await _stream(session, url, {
        "model": "llama-3.2-1b", "stream": True, "temperature": 0,
        "max_tokens": CONSTRAINED_MAX_TOKENS, "tool_choice": tool_choice,
        "messages": [{"role": "user", "content": CONSTRAINED_PROMPT}]})
    if len(seen) != n0 + 1:
        raise AssertionError(f"{tool_choice}: {len(seen) - n0} model turns")
    req = seen[-1]
    chunks = [e["choices"][0] for e in ev
              if e.get("object") == "chat.completion.chunk"
              and e.get("choices")]
    finishes = [c.get("finish_reason") for c in chunks
                if c.get("finish_reason")]
    calls = [tc["function"] for c in chunks
             for tc in c.get("delta", {}).get("tool_calls") or []]
    text = tokenizer.decode([t for t in req.output_ids
                             if t not in tokenizer.stop_ids])
    if finishes != ["tool_calls"] or not calls or \
            not validate_tool_call_json(text, tool_defs):
        raise AssertionError(f"{tool_choice}: finish {finishes}, calls "
                             f"{calls}, text {text!r}")
    return {"tool_choice": tool_choice, "tokens": len(req.output_ids),
            "output_ids": list(req.output_ids), "call": calls[0],
            "finish_reason": req.finish_reason, "grammar": req.grammar,
            **{k: getattr(engine, k) - before[k] for k in keys}}


async def _serve_constrained(db_path: str) -> dict:
    """Fault C3 on the card: greedy thread turns with tool_choice
    "required" and a named function, served through the device FSM, then
    the "required" turn again with KAFKA_TORCH_GRAMMAR_ONDEVICE=0 (the
    host mask path), whose tokens must be the same.  No tools but the
    agent's idle tool (so a forced call ends the run and no tool reaches
    the network); no prefix cache, so every turn prefills cold."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.agents import IDLE_TOOL
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    cfg = ServingConfig(
        model_name="llama-3.2-1b", max_batch=8, page_size=16,
        num_pages=1100, max_pages_per_seq=128,
        prefill_buckets=(64, 128, 256, 512), db_path=db_path,
        system_prompt="You are a terse assistant.", prefix_cache_pages=0)
    app = await create_app(cfg, tools=[], mcp_servers=[])
    llm = app[STATE_KEY]["llm"]
    engine, tok = llm.engine, llm.tokenizer
    if engine.cfg.vocab_size != tok.vocab_size:
        raise AssertionError(f"model vocab {engine.cfg.vocab_size} != "
                             f"tokenizer vocab {tok.vocab_size}: the engine "
                             "would drop the grammar to the host path")
    if not llm.get_model_info()["grammar_ondevice"]:
        raise AssertionError("KAFKA_TORCH_GRAMMAR_ONDEVICE is off")
    seen = _spy_submits(engine)
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}/v1/threads"
    kernels.reset_launch_counts()
    turns = {}
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.monotonic()
            for label, choice in (
                    ("required", "required"),
                    ("named", {"type": "function",
                               "function": {"name": "idle"}})):
                turns[label] = await _constrained_turn(
                    s, f"{base}/c3-{label}/chat/completions", choice, engine,
                    seen, tok, [IDLE_TOOL])
            os.environ["KAFKA_TORCH_GRAMMAR_ONDEVICE"] = "0"
            try:
                turns["required_host"] = await _constrained_turn(
                    s, f"{base}/c3-host/chat/completions", "required",
                    engine, seen, tok, [IDLE_TOOL])
            finally:
                del os.environ["KAFKA_TORCH_GRAMMAR_ONDEVICE"]
            dt = time.monotonic() - t0
    finally:
        k1 = kernels.paged_decode_attention.launches
        await runner.cleanup()
    for label in ("required", "named"):
        t = turns[label]
        if t["constrained_ondevice_tokens"] <= 0 or \
                t["constrained_host_mask_steps"] or t["constrained_degrades"]:
            raise AssertionError(f"{label} turn did not run on the device "
                                 f"FSM: {t}")
    host = turns["required_host"]
    if host["constrained_ondevice_tokens"] or \
            host["constrained_host_mask_steps"] <= 0:
        raise AssertionError(f"ONDEVICE=0 turn did not take the host mask: "
                             f"{host}")
    fsm_ids = turns["required"]["output_ids"]
    n = _wrap_free(turns["required"]["grammar"], fsm_ids,
                   CONSTRAINED_MAX_TOKENS)
    host["same_tokens_before_wrap_up"] = n
    host["whole_stream_equal"] = host["output_ids"] == fsm_ids
    if n < min(40, len(fsm_ids)) or host["output_ids"][:n] != fsm_ids[:n]:
        raise AssertionError(
            f"host-mask stream differs from the device-FSM stream before "
            f"the wrap-up window ({n} tokens): {host['output_ids']} vs "
            f"{fsm_ids}")
    for t in turns.values():
        t.pop("grammar")
    return {"seconds": dt, "K1": k1, "turns": turns}


async def _serve_speculative(db_path: str, constrained_ref: list) -> dict:
    """One streamed request to a server configured from the environment
    with KAFKA_TORCH_SPECULATIVE_K=4, as an operator would enable it; then
    the constrained server's greedy "required" turn, whose grammar lane
    speculates with its proposer offering constrained_ref, the spec-off
    stream: its tokens must be constrained_ref.  The engine's fetch_lag
    is set to 0 (an EngineConfig field ServingConfig does not carry, as
    in the reference), so every dispatch drains in the step that made it
    and a lane proposes at every step; at the default 96 a lone stream's
    host runs ahead of the device and never proposes (PERF.md section 7).
    Both must run verify steps.  No prefix cache, so that turn prefills
    cold as it did there."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    os.environ["KAFKA_TORCH_SPECULATIVE_K"] = "4"
    try:
        cfg = ServingConfig.from_env(
            model_name="llama-3.2-1b", max_batch=8, page_size=16,
            num_pages=1100, max_pages_per_seq=128,
            prefill_buckets=(64, 128, 256, 512), db_path=db_path,
            system_prompt="You are a terse assistant.", prefix_cache_pages=0)
    finally:
        del os.environ["KAFKA_TORCH_SPECULATIVE_K"]
    if cfg.speculative_k != 4:
        raise AssertionError(f"KAFKA_TORCH_SPECULATIVE_K not read: {cfg}")
    # no tools but the agent's idle tool: the built-in schemas would not
    # fit this 2048-token window (the first server phase serves them)
    app = await create_app(cfg, tools=[], mcp_servers=[])
    llm = app[STATE_KEY]["llm"]
    engine = llm.engine
    engine.ecfg.fetch_lag = 0
    real_submit = engine.submit

    def submit(req, *a, **kw):  # on the engine thread, before any step
        out = real_submit(req, *a, **kw)
        if req.grammar is not None:
            req.spec = ForcedSpeculator(list(constrained_ref))
        return out

    engine.submit = submit
    seen = _spy_submits(engine)
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    kernels.reset_launch_counts()
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.monotonic()
            ev = await _stream(
                s, f"http://127.0.0.1:{port}/v1/threads/spec/chat/"
                   "completions",
                {"model": "llama-3.2-1b", "stream": True, "temperature": 0,
                 "max_tokens": 48, "messages": [{
                     "role": "user",
                     "content": "one two three four " * 12}]})
            dt = time.monotonic() - t0
            out = {"seconds": dt, "usage": _usage(ev),
                   "proposed": engine.speculation_proposed_tokens,
                   "accepted": engine.speculation_accepted_tokens,
                   "verify_steps": engine.verify_steps}
            from kafka_tpu_torch.agents import IDLE_TOOL

            p0, a0, v0 = (engine.speculation_proposed_tokens,
                          engine.speculation_accepted_tokens,
                          engine.verify_steps)
            turn = await _constrained_turn(
                s, f"http://127.0.0.1:{port}/v1/threads/spec-c3/chat/"
                   "completions", "required", engine, seen, llm.tokenizer,
                [IDLE_TOOL])
            turn.update(proposed=engine.speculation_proposed_tokens - p0,
                        accepted=engine.speculation_accepted_tokens - a0,
                        verify_steps=engine.verify_steps - v0)
            turn.pop("grammar")
            out["constrained"] = turn
    finally:
        out_k = {k: f.launches for k, f in (
            ("K1", kernels.paged_decode_attention),
            ("K2", kernels.paged_prefill_attention),
            ("K3", kernels.paged_verify_attention))}
        await runner.cleanup()
    out.update(out_k)
    turn = out["constrained"]
    if out["verify_steps"] <= 0:
        raise AssertionError(f"the speculative request ran no verify step: "
                             f"{out}")
    if turn["verify_steps"] <= 0 or turn["proposed"] <= 0 or \
            turn["accepted"] <= 0 or turn["constrained_ondevice_tokens"] <= 0:
        raise AssertionError(f"the grammar lane did not speculate on the "
                             f"device FSM: {turn}")
    if turn["output_ids"] != constrained_ref:
        raise AssertionError(
            f"speculation changed the grammar lane's greedy stream: "
            f"{turn['output_ids']} vs {constrained_ref}")
    return out


async def _serve_int8(db_path: str) -> dict:
    """Two streamed turns on one thread to a server configured from the
    environment with KAFKA_TORCH_QUANTIZE=int8 and
    KAFKA_TORCH_KV_QUANTIZE=int8."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.models.quant import QTensor
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    knobs = {"KAFKA_TORCH_QUANTIZE": "int8", "KAFKA_TORCH_KV_QUANTIZE": "int8"}
    os.environ.update(knobs)
    try:
        cfg = ServingConfig.from_env(
            model_name="llama-3.2-1b", max_batch=8, page_size=16,
            num_pages=1100, max_pages_per_seq=128,
            prefill_buckets=(64, 128, 256, 512), db_path=db_path,
            system_prompt="You are a terse assistant.")
    finally:
        for k in knobs:
            del os.environ[k]
    if (cfg.quantize, cfg.kv_quantize) != ("int8", "int8"):
        raise AssertionError(f"int8 knobs not read: {cfg}")
    # 2048-token window, as above
    app = await create_app(cfg, tools=[], mcp_servers=[])
    engine = app[STATE_KEY]["llm"].engine
    if not isinstance(engine.k_pool, QTensor) or \
            not isinstance(engine.params["layers"]["wq"], QTensor):
        raise AssertionError("the int8 server holds dense weights or pool")
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/v1/threads/int8/chat/completions"
    kernels.reset_launch_counts()
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.monotonic()
            ev1 = await _stream(s, url, {
                "model": "llama-3.2-1b", "stream": True, "temperature": 0,
                "max_tokens": 16, "messages": [{
                    "role": "user", "content": "Explain int8 KV caches "
                    "and per-slot scales in two sentences. " * 6}]})
            ev2 = await _stream(s, url, {
                "model": "llama-3.2-1b", "stream": True, "temperature": 0,
                "max_tokens": 16, "messages": [{
                    "role": "user", "content": "Shorter, please."}]})
            out["seconds"] = time.monotonic() - t0
        out["turn1"], out["turn2"] = _usage(ev1), _usage(ev2)
    finally:
        out.update({f.__name__: f.launches for f in kernels.KERNELS})
        await runner.cleanup()
    cached = (out["turn2"].get("prompt_tokens_details") or {}).get(
        "cached_tokens", 0)
    if cached <= 0:
        raise AssertionError(f"int8 turn 2 did not hit the prefix cache: "
                             f"{out['turn2']}")
    if out["paged_decode_attention_int8"] == 0:
        raise AssertionError(f"int8 server did not launch K4: {out}")
    return out


async def _serve_tiny(db_path: str) -> dict:
    """Fault C5: the tiny float32 model (D 16) served on the card.  The
    kernels do not take it, so "auto" resolves to plain attention, the
    engine logs why, and the provider reports "plain"; one streamed thread
    turn must end in [DONE] without a kernel launch."""
    import logging

    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    class Catch(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    catch = Catch()
    engine_log = logging.getLogger("kafka_tpu_torch.engine")
    engine_log.addHandler(catch)
    try:
        # the agent's idle tool alone needs a ~1024-token window
        app = await create_app(ServingConfig(
            tiny_model=True, max_batch=2, page_size=16, num_pages=2 * 64 + 8,
            max_pages_per_seq=64, prefill_buckets=(64, 128, 256, 512),
            max_new_tokens_default=16, db_path=db_path,
            system_prompt="You are a terse assistant."), tools=[],
            mcp_servers=[])
    finally:
        engine_log.removeHandler(catch)
    llm = app[STATE_KEY]["llm"]
    info = llm.get_model_info()
    logged = [m for m in catch.messages if "resolved to 'plain'" in m]
    out = {"attention_backend": info["attention_backend"],
           "reasons": llm.engine.attention_backend_reasons, "logged": logged,
           "device": info["device"], "dtype": llm.engine.cfg.dtype}
    if info["attention_backend"] != "plain" or not out["reasons"] or \
            not logged:
        raise AssertionError(f"tiny server: {out}")
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    kernels.reset_launch_counts()
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.monotonic()
            ev = await _stream(
                s, f"http://127.0.0.1:{port}/v1/threads/tiny/chat/completions",
                {"model": "tiny", "stream": True, "temperature": 0,
                 "max_tokens": 16, "messages": [{"role": "user",
                                                 "content": "Hello!"}]})
            out["seconds"] = time.monotonic() - t0
        out["usage"] = _usage(ev)
    finally:
        out["launches"] = {f.__name__: f.launches for f in kernels.KERNELS}
        await runner.cleanup()
    if any(out["launches"].values()):
        raise AssertionError(f"tiny server launched kernels: {out}")
    return out


SMOKE_TOKEN = "smoke-api-token"


async def _sandbox_server(port: int):
    """`python -m kafka_tpu_torch.sandbox.server` on `port`, from this
    checkout; returns the process once /health answers."""
    import aiohttp

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_tpu_torch.sandbox.server",
         "--port", str(port)], cwd=here, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    async with aiohttp.ClientSession() as s:
        while True:
            try:
                async with s.get(f"http://127.0.0.1:{port}/health") as r:
                    if r.status == 200:
                        return proc
            except aiohttp.ClientError:
                pass
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(f"sandbox server did not start "
                                     f"(exit {proc.poll()})")
            await asyncio.sleep(0.1)


def _tool_results(events: list) -> list:
    return [e for e in events if e.get("type") == "tool_result"]


async def _serve_thread_api(db_path: str, device=None,
                            small: bool = False) -> dict:
    """The thread API on the full-width bf16 server of _serve_and_query's
    configuration (llama-3.2-1b, 4096 window, multi_step 16, kernel
    attention), with an API token, the port's sandbox server as a
    subprocess and the stub MCP server over stdio.  Its tools are the
    sandbox's and the stub's (the built-in tools' schemas beside them
    would not fit the 4096 window).  In order: auth and thread setup; a
    forced `create_shell` and a forced MCP `echo` run; the cold run's span
    tree; a step failure in the middle of four decoding streams; graceful
    drain.  `small`: the tiny model on the CPU, to try the flow."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch import failpoints
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.sandbox.tools import sandbox_builtin_tools
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY
    from kafka_tpu_torch.tools import MCPServerConfig

    here = os.path.dirname(os.path.abspath(__file__))
    sport = _free_port()
    sandbox = await _sandbox_server(sport)
    sandbox_url = f"http://127.0.0.1:{sport}"
    shape = dict(tiny_model=True, warmup=False) if small else dict(
        model_name="llama-3.2-1b")
    cfg = ServingConfig(
        max_batch=8, page_size=16, num_pages=8 * 256 + 64,
        max_pages_per_seq=256,
        prefill_buckets=(64, 128, 256, 512, 1024, 2048),
        max_new_tokens_default=32, db_path=db_path, multi_step=16,
        api_token=SMOKE_TOKEN,
        local_sandbox_url=sandbox_url, drain_timeout_s=60.0,
        system_prompt="You are a terse assistant.", **shape)
    stub = os.path.join(here, "tests", "mcp_stub_server.py")
    runner = None
    out: dict = {}
    try:
        t0 = time.monotonic()
        app = await create_app(
            cfg, tools=sandbox_builtin_tools(sandbox_url),
            mcp_servers=[MCPServerConfig(name="stub",
                                         command=sys.executable,
                                         args=[stub])],
            device=device)
        out["boot_s"] = time.monotonic() - t0
        state = app[STATE_KEY]
        llm = state["llm"]
        engine, worker = llm.engine, llm.worker
        names = sorted(t["function"]["name"]
                       for t in state["kafka"].get_tools())
        want = {"create_shell", "shell_exec", "notebook_run_cell", "echo",
                "progress_echo", "fail"}
        if not want <= set(names):
            raise AssertionError(f"thread-API server tools {names}")
        out["tools"] = names
        port = _free_port()
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        base = f"http://127.0.0.1:{port}"
        kernels.reset_launch_counts()
        async with aiohttp.ClientSession() as s:
            # 1. auth and thread setup
            async with s.get(f"{base}/v1/threads") as r:
                if r.status != 401:
                    raise AssertionError(f"no token: HTTP {r.status}")
            machine = {"Authorization": f"Bearer {SMOKE_TOKEN}"}
            cred = {"email": "smoke@example.com", "password": "smoke-pass"}
            async with s.post(f"{base}/v1/auth/signup", json=cred,
                              headers=machine) as r:
                if r.status != 200:
                    raise AssertionError(f"signup: HTTP {r.status}")
            async with s.post(f"{base}/v1/auth/login", json=cred) as r:
                session = (await r.json())["token"]
            user = {"Authorization": f"Bearer {session}"}
            async with s.post(f"{base}/v1/profiles", headers=user, json={
                    "name": "smoke", "config": {
                        "global_prompt": "Call the tool you are asked "
                                         "for."}}) as r:
                profile = await r.json()
                if r.status != 201:
                    raise AssertionError(f"profile: {profile}")
            async with s.post(f"{base}/v1/threads", headers=user, json={
                    "profile_id": profile["profile_id"]}) as r:
                tid = (await r.json())["thread_id"]
            thread_cfg = {"global_prompt": "Use the tools.",
                          "profile_id": profile["profile_id"]}
            async with s.put(f"{base}/v1/threads/{tid}/config",
                             headers=user, json=thread_cfg) as r:
                if r.status != 200 or (await r.json())["config"] != \
                        thread_cfg:
                    raise AssertionError(f"thread config: HTTP {r.status}")
            async with s.get(f"{base}/v1/threads", headers=user) as r:
                if [t["thread_id"] for t in (await r.json())["threads"]] \
                        != [tid]:
                    raise AssertionError("session user's threads")
            out["auth"] = {"no_token": 401, "thread": tid}

            # 2. forced tool calls: the sandbox's create_shell (cold, traced)
            # and the stub's MCP echo
            runs = {}
            for name, rid in (("create_shell", "cold-run"),
                              ("echo", "mcp-run")):
                timing: dict = {}
                t1 = time.monotonic()
                ev = await _stream(
                    s, f"{base}/v1/threads/{tid}/agent/run",
                    {"model": "llama-3.2-1b", "temperature": 0,
                     "max_tokens": 64,
                     "tool_choice": {"type": "function",
                                     "function": {"name": name}},
                     "messages": [{"role": "user",
                                   "content": f"Call {name}."}]},
                    timing, headers={**user, "X-Request-Id": rid})
                results = _tool_results(ev)
                if not results or results[0]["name"] != name or \
                        ev[-1].get("type") != "agent_done":
                    raise AssertionError(f"{name} run: {results} "
                                         f"{ev[-1:]}")
                runs[name] = {"seconds": time.monotonic() - t1,
                              "result": results[0]["data"],
                              "kind": results[0]["kind"],
                              "agent_done": ev[-1]["reason"],
                              "client_ttft_s": timing.get("ttft_s")}
            if "shell_id" not in runs["create_shell"]["result"] or \
                    not runs["echo"]["result"].startswith("echo: "):
                raise AssertionError(f"tool results {runs}")
            async with s.get(f"{base}/v1/threads/{tid}/messages",
                             headers=user) as r:
                msgs = (await r.json())["messages"]
            tool_msgs = [m for m in msgs if m["role"] == "tool"]
            if len(tool_msgs) < 2:
                raise AssertionError(f"thread history "
                                     f"{[m['role'] for m in msgs]}")
            out["runs"], out["history"] = runs, [m["role"] for m in msgs]

            # 3. the cold run's span tree
            async with s.get(f"{base}/debug/trace/cold-run",
                             headers=user) as r:
                out["cold_run_spans"] = ttft_breakdown(
                    await r.json(), runs["create_shell"]["client_ttft_s"])
            if not out["cold_run_spans"]["tool.exec_ms"]:
                raise AssertionError("the cold run's trace has no tool.exec")

            # 5. a step failure while four streams decode in fused graphs
            # with the fetch FIFO full
            chat = {"model": "llama-3.2-1b", "stream": True,
                    "temperature": 0, "max_tokens": 48,
                    "messages": [{"role": "user", "content": "Say hello."}]}
            seen = _spy_submits(engine)
            await _stream(s, f"{base}/v1/chat/completions", chat,
                          headers=user)
            before = list(seen[0].output_ids)
            async with s.get(f"{base}/health") as r:
                idle_free = (await r.json())["engine"]["free_pages"]
            rec: dict = {}
            real_recover = engine.recover_from_failure

            def recover():
                rec.update(pending_steps=engine._pending_steps,
                           pending_entries=len(engine._pending),
                           active=engine.num_active,
                           graphs=len(engine._graphs))
                t = time.monotonic()
                evs = real_recover()
                rec["recover_s"] = time.monotonic() - t
                rec["terminal"] = sorted({e.finish_reason for e in evs
                                          if e.finished})
                return evs

            terminal, late, delivered = set(), [], {}
            real_deliver = worker._deliver

            def deliver(ev):
                if ev.request_id in terminal:
                    late.append(ev)
                if ev.finished:
                    terminal.add(ev.request_id)
                else:
                    delivered[ev.request_id] = \
                        delivered.get(ev.request_id, 0) + 1
                return real_deliver(ev)

            engine.recover_from_failure = recover
            worker._deliver = deliver
            long = {**chat, "max_tokens": 900,
                    "messages": [{"role": "user",
                                  "content": "Write a long story."}]}
            streams = [asyncio.create_task(_stream(
                s, f"{base}/v1/threads/fail-{i}/chat/completions", long,
                headers=user, allow_error=True)) for i in range(4)]
            # every stream has had tokens, and on the card the host runs
            # up to fetch_lag steps ahead (the CPU's steps land at once and
            # pop by age)
            fifo = 16 if small else engine.ecfg.fetch_lag // 2
            deadline = time.monotonic() + 120
            while not (engine.num_active == 4 and engine._pending_steps
                       >= fifo and engine.multi_step_dispatches > 0 and
                       len(delivered) == 4 and
                       min(delivered.values()) >= 16):
                if time.monotonic() > deadline or all(
                        t.done() for t in streams):
                    raise AssertionError(
                        f"the four streams never filled the fetch FIFO: "
                        f"{engine.num_active} active, "
                        f"{engine._pending_steps} steps in flight, "
                        f"tokens delivered {sorted(delivered.values())}, "
                        f"{[t.done() for t in streams]} done")
                await asyncio.sleep(0.005)
            failpoints.configure("engine.step", "error", "chip", nth=2)
            try:
                failed = await asyncio.wait_for(asyncio.gather(*streams),
                                                120)
            finally:
                failpoints.clear()
                engine.recover_from_failure = real_recover
            worker._deliver = real_deliver
            for ev in failed:
                if ev[-1].get("type") != "error":
                    raise AssertionError(f"failed stream ended {ev[-1]}")
            if late:
                raise AssertionError(f"{len(late)} events after a terminal "
                                     f"event")
            deadline = time.monotonic() + 30
            while True:
                async with s.get(f"{base}/health") as r:
                    health = (await r.json())["engine"]
                if health["free_pages"] == idle_free and \
                        health["active"] == 0:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"pages after recovery {health}, "
                                         f"idle {idle_free}")
                await asyncio.sleep(0.05)
            cap0, ncap0 = engine.graph_capture_s, engine.graph_captures
            t1 = time.monotonic()
            n_seen = len(seen)
            await _stream(s, f"{base}/v1/chat/completions", chat,
                          headers=user)
            after = list(seen[n_seen].output_ids)
            rec["next_turn_s"] = time.monotonic() - t1
            rec["recapture_s"] = engine.graph_capture_s - cap0
            rec["recaptures"] = engine.graph_captures - ncap0
            rec["streams_error"] = [ev[-1]["error"] for ev in failed]
            # tokens each failed stream received before its terminal event
            rec["tokens_before_failure"] = sorted(
                n for rid, n in delivered.items() if rid in terminal)
            rec["next_turn_equal"] = after == before
            rec["next_turn_tokens"] = len(after)
            if not rec.get("terminal") or after != before:
                raise AssertionError(f"failure mid-stream: {rec}; next turn "
                                     f"{after} != {before}")
            out["failure"] = rec

            # 6. graceful drain: shut down mid-stream, after a thread
            # DELETE that reads 404.  The stream is a prompt seen to run
            # to its token budget (greedy: the same prompt, the same
            # tokens), so no stop token ends it before the shutdown
            for i in range(8):
                budget = {**chat, "max_tokens": 256, "messages": [{
                    "role": "user", "content": f"Write story number {i}."}]}
                n_seen = len(seen)
                await _stream(s, f"{base}/v1/chat/completions", budget,
                              headers=user)
                if seen[n_seen].finish_reason == "length":
                    break
            else:
                raise AssertionError("no prompt ran to its token budget")
            n_seen = len(seen)
            drained = asyncio.create_task(_stream(
                s, f"{base}/v1/chat/completions", budget, headers=user))
            deadline = time.monotonic() + 60
            while len(seen) == n_seen or len(seen[n_seen].output_ids) < 8:
                if time.monotonic() > deadline or drained.done():
                    raise AssertionError("the drain stream never decoded")
                await asyncio.sleep(0.002)
            async with s.delete(f"{base}/v1/threads/{tid}",
                                headers=user) as r:
                deleted = r.status
            async with s.get(f"{base}/v1/threads/{tid}", headers=user) as r:
                gone = r.status
            in_flight = not drained.done() and \
                seen[n_seen].state != "finished"
            t1 = time.monotonic()
            await runner.cleanup()
            runner = None
            ev = await asyncio.wait_for(drained, 60)
            out["drain"] = {"shutdown_s": time.monotonic() - t1,
                            "in_flight_at_shutdown": in_flight,
                            "stream_end": ev[-1].get("type"),
                            "delete": deleted, "get_after_delete": gone,
                            "draining": state["draining"],
                            "engine_idle": not engine.has_work}
            if (deleted, gone) != (200, 404) or \
                    ev[-1].get("type") != "agent_done" or \
                    not state["draining"] or engine.has_work or \
                    not (in_flight or small):
                raise AssertionError(f"drain: {out['drain']}")
    finally:
        out["launches"] = {f.__name__: f.launches for f in kernels.KERNELS}
        if runner is not None:
            await runner.cleanup()
        sandbox.terminate()
        try:
            sandbox.wait(timeout=10)
        except subprocess.TimeoutExpired:
            sandbox.kill()
            sandbox.wait()
    return out


def phase_server() -> None:
    with tempfile.TemporaryDirectory() as td:
        tiny = asyncio.run(_serve_tiny(os.path.join(td, "tiny.db")))
        out = asyncio.run(_serve_and_query(os.path.join(td, "threads.db")))
        api = asyncio.run(_serve_thread_api(os.path.join(td, "api.db")))
        con = asyncio.run(_serve_constrained(os.path.join(td, "c3.db")))
        spec = asyncio.run(_serve_speculative(
            os.path.join(td, "spec.db"),
            con["turns"]["required"]["output_ids"]))
        int8 = asyncio.run(_serve_int8(os.path.join(td, "int8.db")))
    log(f"server (tiny_model=True, {tiny['dtype']}, fault C5): "
        f"attention_backend {tiny['attention_backend']!r} on "
        f"{tiny['device']}, logged: {tiny['logged'][0]}; 1 thread turn of "
        f"{tiny['usage']['completion_tokens']} tokens ended with [DONE] in "
        f"{tiny['seconds']:.2f}s, no kernel launched")
    RESULTS["server_tiny"] = tiny
    log(f"server (KAFKA_TORCH_QUANTIZE=int8 KAFKA_TORCH_KV_QUANTIZE=int8): "
        f"2 thread turns ended with [DONE] in {int8['seconds']:.2f}s; turn 2 "
        f"prompt {int8['turn2']['prompt_tokens']} tokens, cached "
        f"{int8['turn2']['prompt_tokens_details']['cached_tokens']}; "
        f"launches K4={int8['paged_decode_attention_int8']} "
        f"K1={int8['paged_decode_attention']} "
        f"K2={int8['paged_prefill_attention']}")
    RESULTS["server_int8"] = int8
    if "K4" in RESULTS:
        RESULTS["K4"]["launches"] = RESULTS["K4"]["server_launches"] = \
            int8["paged_decode_attention_int8"]
    log(f"server: 3 streams ended with [DONE] in {out['seconds']:.2f}s; "
        f"TTFT turn 1 {out['turn1_ttft_s']} s, chat {out['chat_ttft_s']} s "
        f"(host clock, cold prefills of the prompt with the built-in tools); "
        f"agent_done {out['agent_done_reasons']}; "
        f"prompt tokens turn1={out['turn1']['prompt_tokens']} "
        f"turn2={out['turn2']['prompt_tokens']} (cached "
        f"{out['turn2']['prompt_tokens_details']['cached_tokens']}) "
        f"chat={out['turn3']['prompt_tokens']}; history {out['history']}; "
        f"launches K1={out['K1']} K2={out['K2']}")
    log(f"server turn 1 span tree (cold, built-in tools): "
        f"{_fmt_spans(out['turn1_spans'])}")
    runs = api["runs"]
    log(f"server thread API (llama-3.2-1b, API token, sandbox subprocess, "
        f"stub MCP over stdio; booted in {api['boot_s']:.1f}s): no token "
        f"-> 401; signup, login, profile, thread {api['auth']['thread']} "
        f"from it, config set; forced create_shell -> "
        f"{runs['create_shell']['result'][:60]!r} "
        f"({runs['create_shell']['seconds']:.2f}s, agent_done "
        f"{runs['create_shell']['agent_done']}); forced MCP echo -> "
        f"{runs['echo']['result'][:60]!r} ({runs['echo']['seconds']:.2f}s); "
        f"history {api['history']}")
    log(f"server thread API cold run span tree (create_shell forced): "
        f"{_fmt_spans(api['cold_run_spans'])}")
    f = api["failure"]
    log(f"server thread API step failure (engine.step=error(chip):nth=2) "
        f"with {f['active']} lanes decoding, {f['pending_steps']} steps "
        f"({f['pending_entries']} fetches) in flight, {f['graphs']} graphs "
        f"captured: every stream ended with an error event and [DONE] "
        f"({f['streams_error'][0]!r}) after {f['tokens_before_failure']} "
        f"tokens, no event after a terminal one, free "
        f"pages back to idle; recovery {f['recover_s'] * 1e3:.2f} ms, then "
        f"{f['recaptures']} graph recaptures in {f['recapture_s']:.3f}s "
        f"inside the next turn ({f['next_turn_s']:.2f}s), whose "
        f"{f['next_turn_tokens']} tokens equal the same turn before the "
        f"failure: {f['next_turn_equal']}")
    d = api["drain"]
    log(f"server thread API drain: DELETE -> {d['delete']}, GET -> "
        f"{d['get_after_delete']}; shutdown with a stream in flight "
        f"({d['in_flight_at_shutdown']}) took {d['shutdown_s']:.2f}s and the "
        f"stream ended with {d['stream_end']} and [DONE]")
    RESULTS["server_thread_api"] = api
    log(f"server (KAFKA_TORCH_SPECULATIVE_K=4, fetch_lag 0): 1 stream of "
        f"{spec['usage']['completion_tokens']} tokens in "
        f"{spec['seconds']:.2f}s; {spec['verify_steps']} verify steps, "
        f"accepted {spec['accepted']}/{spec['proposed']} proposed; "
        f"launches K1={spec['K1']} K2={spec['K2']} K3={spec['K3']}")
    RESULTS["server_speculative"] = spec
    for label, t in con["turns"].items():
        log(f"server constrained turn ({label}, tool_choice "
            f"{json.dumps(t['tool_choice'])}): {t['tokens']} tokens, finish "
            f"tool_calls, call {t['call']['name']}({t['call']['arguments']}); "
            f"device-FSM tokens {t['constrained_ondevice_tokens']}, host-mask "
            f"steps {t['constrained_host_mask_steps']}; graphs captured "
            f"{t['graph_captures']} in {t['graph_capture_s']:.3f}s")
    sc = spec["constrained"]
    host = con["turns"]["required_host"]
    log(f"server constrained turns: the host-mask rerun equals the device "
        f"FSM's first {host['same_tokens_before_wrap_up']} tokens (all "
        f"before either wrap-up window; whole stream equal: "
        f"{host['whole_stream_equal']}); with speculation "
        f"({sc['verify_steps']} verify steps, {sc['accepted']}/"
        f"{sc['proposed']} proposed accepted, forced proposals) the grammar "
        f"lane's {sc['tokens']} tokens equal speculation off; graphs "
        f"captured in that turn {sc['graph_captures']} in "
        f"{sc['graph_capture_s']:.3f}s; launches "
        f"K1={con['K1']} in {con['seconds']:.2f}s")
    RESULTS["server_constrained"] = con
    if "K3" in RESULTS:
        RESULTS["K3"]["server_launches"] = spec["K3"]
    if out["K1"] == 0 or out["K2"] == 0:
        raise AssertionError(f"server phase did not launch both kernels: "
                             f"K1={out['K1']} K2={out['K2']}")
    RESULTS["server"] = out
    for k in ("K1", "K2"):
        RESULTS[k]["launches"] = RESULTS[k]["server_launches"] = out[k]


# ---------------------------------------------------------------------------
# phase 4: the telemetry plane on the card
# ---------------------------------------------------------------------------

# MFU and bandwidth utilization against the H100's datasheet roofline: a
# ratio over 1 means the busy time the registry charged is shorter than
# the device took; 1.05 leaves room for the rounding of a window's edges
UTIL_MAX = 1.05
# decode with the flight ring on stays device-bound, as untraced (0.992-
# 0.997, PERF.md section 5)
FLIGHT_BUSY_MIN = 0.99
# the registry's decode bandwidth utilization over a steady window,
# against the same window's modeled bytes over its CUDA-event device time
HBM_AGREE = 0.25
# the plan's weights and KV pool against the bytes of the engine's own
# tensors: both are arithmetic over the same shapes, so they agree
PLAN_EXACT = 0.01
# the server's growth of torch.cuda.memory_reserved over boot and
# serving, less the two terms the plan does not model and the allocator
# measures (the CUDA-graph pools, and the cache of freed blocks the
# eager prefill's transient tensors leave), against the plan's total,
# as a fraction of it.  What remains is the live bytes of the default
# pool: beyond the weights and the pool the plan charges an activation
# estimate and a grammar-table reservation, and what is live at rest
# besides them is the cuBLAS workspaces and the decode loop's buffers
# (~0.1-0.2 GB), a few percent of the plan
PLAN_MARGIN = 0.10
K1_KERNEL = "paged_decode_chunk_kernel"
K2_KERNEL = "flash_prefill_mma_kernel"
K4_KERNEL = "paged_decode_int8_chunk_kernel"


def check_prometheus(text: str) -> dict:
    """The rules of the reference's exposition checker
    (tests/test_prometheus.py parse_exposition): every sample belongs to a
    TYPEd family (histogram samples by their _bucket/_sum/_count suffix),
    no series twice, no TYPE twice, each family one contiguous group,
    values parse as floats, labels well formed.  Returns family counts."""
    import re

    sample_re = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                           r"(?:\{(?P<labels>[^}]*)\})? (?P<value>[^ ]+)$")
    label_re = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\["\\n])*)"$')
    families, seen, closed, current = {}, set(), set(), None
    n = 0
    for line in text.splitlines():
        if not line.strip() or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if name in families or kind not in (
                    "counter", "gauge", "summary", "histogram"):
                raise AssertionError(f"prometheus: bad TYPE {line!r}")
            families[name] = kind
            continue
        m = sample_re.match(line)
        if line.startswith("#") or not m:
            raise AssertionError(f"prometheus: bad line {line!r}")
        name, raw, value = m.group("name", "labels", "value")
        labels = []
        for part in (raw.split(",") if raw else []):
            lm = label_re.match(part)
            if not lm:
                raise AssertionError(f"prometheus: bad label {line!r}")
            labels.append((lm.group(1), lm.group(2)))
        float(value)
        key = (name, tuple(sorted(labels)))
        if key in seen:
            raise AssertionError(f"prometheus: duplicate series {key}")
        seen.add(key)
        base = name
        if name not in families:
            for suffix in ("_bucket", "_sum", "_count"):
                stem = name[:-len(suffix)] if name.endswith(suffix) else None
                if stem and families.get(stem) == "histogram":
                    base = stem
                    break
        if base not in families:
            raise AssertionError(f"prometheus: {name} has no TYPE line")
        if name != current:
            if name in closed:
                raise AssertionError(f"prometheus: {name} not contiguous")
            if current is not None:
                closed.add(current)
            current = name
        n += 1
    return {"families": len(families), "samples": n}


def check_utilization(util: dict, label: str) -> dict:
    """Every kind that dispatched: MFU and bandwidth utilization in
    (0, UTIL_MAX] since boot and over the last minute; the roofline is the
    datasheet's.  Returns the readings (raises after logging them)."""
    read = {"peak_tflops": util.get("peak_tflops"),
            "peak_hbm_gbps": util.get("peak_hbm_gbps"),
            "peak_source": util.get("peak_source")}
    bad = []
    if util.get("peak_source") != "datasheet" or \
            abs((util.get("peak_tflops") or 0) - 989.0) > 0.5 or \
            abs((util.get("peak_hbm_gbps") or 0) - 3350.0) > 0.5:
        bad.append("roofline")
    for kind in ("prefill", "decode", "verify"):
        sec = util.get(kind) or {}
        if not sec.get("dispatches"):
            continue
        read[kind] = {k: sec.get(k) for k in (
            "dispatches", "busy_s", "mfu", "hbm_bw_util", "mfu_1m",
            "hbm_bw_util_1m", "model_skew", "kernel_samples",
            "kernel_skew", "achieved_tflops", "achieved_gb_s")}
        for k in ("mfu", "hbm_bw_util", "mfu_1m", "hbm_bw_util_1m"):
            if k.endswith("_1m") and not sec["window_1m"]["busy_s"]:
                continue
            if not 0 < sec[k] <= UTIL_MAX:
                bad.append(f"{kind}.{k}={sec[k]}")
    log(f"  {label} utilization: {json.dumps(read)}")
    read["out_of_range"] = bad
    return read


class _EnvKnobs:
    """Set KAFKA_TORCH_* knobs for a block and restore the environment."""

    def __init__(self, **knobs):
        self.knobs = {f"KAFKA_TORCH_{k}": str(v) for k, v in knobs.items()}
        self.saved = {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def _get_json(s, url):
    async with s.get(url) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status} {await r.text()}")
        return await r.json()


async def _serve_telemetry(td: str) -> dict:
    """The bf16 server with the flight ring, the compile ring and the
    kernel sampler on: eight concurrent streamed thread turns, then
    sequential turns until the sampler has named K1 and K2, every
    telemetry route read and checked, a failed step's postmortem, and
    the memory plan against the caching allocator."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    flight_dir = os.path.join(td, "flight")
    # the knobs stay set while the server runs: the postmortem directory
    # and the profiling gate are read when they are used
    with _EnvKnobs(PROFILE_SAMPLE=8, FLIGHT_DIR=flight_dir,
                   PROFILE_SPILL_DIR=os.path.join(td, "kernels"),
                   PROFILING=1):
        return await _telemetry_turns(td, flight_dir)


async def _telemetry_turns(td: str, flight_dir: str) -> dict:
    import aiohttp
    import torch
    from aiohttp import web

    from kafka_tpu_torch import failpoints
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime.planner import _device_stats
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    # what earlier phases left in the caching allocator (the process's
    # reserved bytes and graph pools) is not this server's
    dev = torch.device("cuda", torch.cuda.current_device())
    before = _device_stats(dev)
    split0 = allocator_split(dev)
    reserved0 = torch.cuda.memory_reserved(dev)

    # prefill buckets to 256: a thread turn's ~700-token prompt (the
    # agent's idle tool) prefills in three K2 chunks
    cfg = ServingConfig(
        model_name="llama-3.2-1b", max_batch=8, page_size=16,
        num_pages=8 * 128 + 64, max_pages_per_seq=128,
        prefill_buckets=(64, 128, 256), max_new_tokens_default=64,
        db_path=os.path.join(td, "telemetry.db"), multi_step=16,
        system_prompt="You are a terse assistant.")
    t0 = time.monotonic()
    app = await create_app(cfg, tools=[], mcp_servers=[])
    boot_s = time.monotonic() - t0
    llm = app[STATE_KEY]["llm"]
    engine = llm.engine
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    # the memory monitor's own cost: one allocator sample (the 1 Hz poll)
    t_poll = time.perf_counter()
    for _ in range(20):
        engine.memory_monitor.poll(force=True)
    poll_ms = (time.perf_counter() - t_poll) / 20 * 1e3
    out = {"boot_s": boot_s, "memory_poll_ms": poll_ms,
           "flight_ring": engine.flight.size if engine.flight else 0,
           "sampler_period": engine.kernel_sampler.period}
    kernels.reset_launch_counts()

    def turn(i, n=64):
        return {"model": "llama-3.2-1b", "stream": True, "temperature": 0,
                "max_tokens": n, "messages": [{
                    "role": "user",
                    "content": f"Thread {i}: describe paged attention."}]}

    try:
        async with aiohttp.ClientSession() as s:
            t1 = time.monotonic()
            await asyncio.gather(*(
                _stream(s, f"{base}/v1/threads/tel{i}/chat/completions",
                        turn(i)) for i in range(8)))
            out["concurrent_s"] = time.monotonic() - t1
            named, extra = set(), 0
            while extra < 16:
                ks = await _get_json(s, f"{base}/debug/kernels?top_k=200")
                named = {r["kernel"] for r in ks["kernels"]}
                if any(K1_KERNEL in n for n in named) and \
                        any(K2_KERNEL in n for n in named):
                    break
                await _stream(s, f"{base}/v1/threads/seq{extra}/chat/"
                                 "completions", turn(100 + extra, 24))
                extra += 1
            out["sequential_turns"] = extra
            out["launches"] = {f.__name__: f.launches
                               for f in kernels.KERNELS}
            m = await _get_json(s, f"{base}/metrics")
            served_s = time.monotonic() - t1
            # the allocator at rest after the turns, beside the engine's
            # own weight and KV-pool tensors
            split1 = allocator_split(dev)
            reserved1 = torch.cuda.memory_reserved(dev)
            real = {"weights": tensor_bytes(engine.params),
                    "kv_pool": tensor_bytes((engine.k_pool, engine.v_pool))}
            plan = engine.memory_monitor.plan
            async with s.get(f"{base}/metrics?format=prometheus") as r:
                prom = await r.text()
            sig = await _get_json(s, f"{base}/admin/signals")
            comp = await _get_json(s, f"{base}/debug/compiles")
            fl = await _get_json(s, f"{base}/debug/flight/0")
            ks = await _get_json(s, f"{base}/debug/kernels?top_k=30")
            async with s.post(f"{base}/debug/profile",
                              json={"seconds": 0.2}) as r:
                prof = (r.status, await r.json())
            # a failed step: the engine.step failpoint mid-turn
            failpoints.configure("engine.step", "error", "telemetry", nth=3)
            try:
                ev = await _stream(
                    s, f"{base}/v1/threads/fail/chat/completions",
                    turn(999, 32), allow_error=True)
            finally:
                failpoints.clear()
            out["failed_turn_errors"] = [
                e.get("error") for e in ev if e.get("type") == "error"]
            after = await _get_json(s, f"{base}/metrics")
    finally:
        await runner.cleanup()
    util = check_utilization(m["utilization"], "bf16 server")
    # mfu and hbm_bw_util are shares of the device's busy time (each
    # dispatch's CUDA-event span); the busy seconds over the turns' wall
    # seconds is the device's busy share, and their product the share of
    # the whole window
    busy_s = sum(m["utilization"].get(k, {}).get("busy_s", 0.0)
                 for k in ("prefill", "decode", "verify"))
    whole = {k: {f"{u}_whole": m["utilization"].get(k, {}).get(u, 0.0)
                 * busy_s / served_s for u in ("mfu", "hbm_bw_util")}
             for k in ("prefill", "decode")}
    prom_stats = check_prometheus(prom)
    kern = ks["kernels"]
    names = sorted({r["kernel"] for r in kern})
    dec = m["utilization"]["decode"]
    records = comp["records"]
    by_label = {}
    for r in records:
        kind = r["label"].split("[")[0]
        by_label.setdefault(kind, {}).setdefault(r["phase"], 0)
        by_label[kind][r["phase"]] += 1
    causes = {}
    for r in fl["records"]:
        for c, k in r["causes"].items():
            causes[c] = causes.get(c, 0) + k
    pms = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) \
        else []
    pm = None
    if pms:
        with open(os.path.join(flight_dir, pms[-1])) as f:
            pm = json.load(f)
    mem = m.get("memory") or {}
    comp_bytes = mem.get("hbm_component_bytes") or {}
    plan_total = sum(comp_bytes.get(k, 0) for k in (
        "weights", "kv_pool", "activations", "grammar_tables"))
    graph_pool = comp_bytes.get("graph_pool", 0)
    grown = mem.get("hbm_bytes_in_use", 0) - before["bytes_in_use"]
    grown_pool = graph_pool - before["graph_pool_bytes"]
    plan_err = ((grown - plan_total - grown_pool) / plan_total
                if plan_total else None)
    # memory_reserved's growth less the graph pools and the allocator's
    # cache of freed blocks (what is left is the default pool's live
    # bytes) against the plan
    reserved = reserved1 - reserved0
    live = split1["default_allocated"] - split0["default_allocated"]
    cache = (split1["default_reserved"] - split1["default_allocated"]) - \
        (split0["default_reserved"] - split0["default_allocated"])
    pools = split1["graph_reserved"] - split0["graph_reserved"]
    planned = {"weights": plan.weight_bytes, "kv_pool": plan.kv_pool_bytes}
    exact = {k: (planned[k] - real[k]) / real[k] for k in real}
    live_err = (reserved - pools - cache - plan.total_bytes) / \
        plan.total_bytes
    out.update({
        "utilization": util, "prometheus": prom_stats,
        "signals_version": sig.get("version"),
        "signals_memory": sig.get("memory"),
        "kernels": {"samples_total": ks["samples_total"],
                    "sample_failures": ks["sample_failures"],
                    "names": names, "top": kern[:8]},
        "kernel_skew": dec.get("kernel_skew"),
        "compiles": {"totals": comp["totals"], "by_label_phase": by_label},
        "flight": {"records": len(fl["records"]), "causes": causes,
                   "ring_size": fl["ring_size"],
                   "measured_ms": sum(r["measured_ms"]
                                      for r in fl["records"])},
        "profile_capture": prof,
        "postmortems": pms,
        "postmortem_reason": pm and pm["reason"],
        "postmortem_records": pm and len(pm["records"]),
        "flight_postmortems": after["flight"]["flight_postmortems"],
        "memory": {k: mem.get(k) for k in (
            "source", "hbm_bytes_in_use", "hbm_bytes_peak",
            "hbm_bytes_limit", "hbm_plan_skew", "hbm_pressure")},
        "memory_components": comp_bytes,
        "plan_total_bytes": plan_total,
        "reserved_before_boot": before["bytes_in_use"],
        "graph_pools_before_boot": before["graph_pool_bytes"],
        "plan_vs_reserved": plan_err,
        "plan_vs_live": live_err,
        "reserved_growth_bytes": reserved,
        "live_bytes": live, "live_unplanned_bytes": live - real["weights"]
        - real["kv_pool"], "allocator_cache_bytes": cache,
        "graph_pool_growth_bytes": pools,
        "real_bytes": real, "plan_vs_real": exact,
        "served_s": served_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / served_s, "whole_window": whole,
        "requests": m["requests"], "slo": {
            k: m["slo"][k] for k in ("slo_attainment", "goodput_tokens")},
        "ttft_ms": m["ttft_ms"], "tpot_ms": m["tpot_ms"],
    })
    log(f"telemetry server (llama-3.2-1b bf16, flight ring "
        f"{out['flight_ring']}, sampler every {out['sampler_period']} "
        f"steps; booted in {boot_s:.1f}s): 8 concurrent turns in "
        f"{out['concurrent_s']:.2f}s, then {extra} sequential turns until "
        f"the sampler named K1 and K2; launches {out['launches']}")
    log(f"  /metrics: requests {m['requests']}, TTFT {m['ttft_ms']} ms, "
        f"TPOT {m['tpot_ms']} ms; prometheus {prom_stats}")
    log(f"  device busy {busy_s:.3f} s of the turns' {served_s:.3f} s "
        f"(share {busy_s / served_s:.4f}); over the whole window {whole}")
    log(f"  /debug/kernels: {ks['samples_total']} samples "
        f"({ks['sample_failures']} failed), kernel_skew decode "
        f"{dec.get('kernel_skew')}; top: "
        + "; ".join(f"{r['kind']} {r['kernel'][:48]} {r['total_us']:.0f} us"
                    f" x{r['count']}" for r in kern[:6]))
    log(f"  /debug/compiles: {comp['totals']}; by label and phase "
        f"{by_label}")
    log(f"  /debug/flight/0: {len(fl['records'])} records, causes "
        f"{causes}; postmortems {pms} ({out['postmortem_reason']}, "
        f"{out['postmortem_records']} records); failed turn errors "
        f"{out['failed_turn_errors']}")
    log(f"  memory: {out['memory']}, components {comp_bytes}; reserved "
        f"before boot {before['bytes_in_use']} (graph pools "
        f"{before['graph_pool_bytes']}); the server's growth vs plan + its "
        f"graph pools: {plan_err}; one allocator poll {poll_ms:.3f} ms")
    log(f"  memory at rest after the turns: memory_reserved +{reserved} B"
        f", less graph pools +{pools} B and the allocator's cache of freed "
        f"blocks +{cache} B, against the plan's {plan.total_bytes} B "
        f"({live_err:+.4f}); live +{live} B, of it the engine's weights {real['weights']} B and KV pool "
        f"{real['kv_pool']} B (plan - real: {exact}), "
        f"{live - real['weights'] - real['kv_pool']} B else (the plan "
        f"charges {plan.activation_bytes} B of activations and "
        f"{plan.grammar_table_bytes} B of grammar tables)")
    log(f"  /debug/profile: {prof[0]}")
    fails = list(util["out_of_range"])
    if not any(K1_KERNEL in n for n in names) or \
            not any(K2_KERNEL in n for n in names):
        fails.append(f"sampler names {names}")
    ks_val = dec.get("kernel_skew")
    if not (isinstance(ks_val, (int, float)) and 0 < ks_val < float("inf")):
        fails.append(f"kernel_skew {ks_val}")
    if "nvcc" not in by_label or "decode_graph" not in by_label or \
            not by_label["decode_graph"].get("warmup"):
        fails.append(f"compiles {by_label}")
    if not causes or not fl["records"]:
        fails.append("flight records without causes")
    if not pms or out["postmortem_reason"] != "engine_failure" or \
            not out["failed_turn_errors"]:
        fails.append(f"postmortem {pms}")
    if mem.get("source") != "device" or plan_err is None:
        fails.append(f"memory section {mem.get('source')}")
    if any(abs(v) > PLAN_EXACT for v in exact.values()):
        fails.append(f"memory plan vs the engine's tensors {exact}")
    if abs(live_err) > PLAN_MARGIN:
        fails.append(f"memory plan vs memory_reserved less graph pools "
                     f"and cache {live_err}")
    if prof[0] != 200 or out["signals_version"] != 9:
        fails.append(f"profile {prof[0]} / signals {out['signals_version']}")
    out["fails"] = fails
    return out


async def _serve_telemetry_variant(td: str, name: str, knobs: dict,
                                   prompt: str, max_tokens: int,
                                   fetch_lag=None) -> dict:
    """One streamed thread turn on a server configured from the
    environment (int8 weights + KV, or speculative_k), flight ring on;
    the utilization windows of its /metrics."""
    import gc

    import aiohttp
    import torch
    from aiohttp import web

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    gc.collect()
    torch.cuda.empty_cache()
    with _EnvKnobs(**knobs):
        cfg = ServingConfig.from_env(
            model_name="llama-3.2-1b", max_batch=8, page_size=16,
            num_pages=1100, max_pages_per_seq=128,
            prefill_buckets=(64, 128, 256, 512),
            db_path=os.path.join(td, f"{name}.db"),
            system_prompt="You are a terse assistant.")
        app = await create_app(cfg, tools=[], mcp_servers=[])
    engine = app[STATE_KEY]["llm"].engine
    if fetch_lag is not None:
        engine.ecfg.fetch_lag = fetch_lag
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    kernels.reset_launch_counts()
    try:
        async with aiohttp.ClientSession() as s:
            ev = await _stream(
                s, f"http://127.0.0.1:{port}/v1/threads/{name}/chat/"
                   "completions",
                {"model": "llama-3.2-1b", "stream": True, "temperature": 0,
                 "max_tokens": max_tokens,
                 "messages": [{"role": "user", "content": prompt}]})
            m = await _get_json(s, f"http://127.0.0.1:{port}/metrics")
    finally:
        launches = {f.__name__: f.launches for f in kernels.KERNELS}
        await runner.cleanup()
    out = {"usage": _usage(ev), "launches": launches,
           "utilization": check_utilization(m["utilization"],
                                            f"{name} server"),
           "speculation": m["speculation"]}
    log(f"  {name} server: {out['usage']['completion_tokens']} tokens, "
        f"launches {launches}, speculation "
        f"{m['speculation']['speculation_verify_steps']} verify steps")
    return out


def profile_catch(seed: int) -> dict:
    """The profiler's dropped kernel events, settled on a bare loop: N
    launches of K1 at the ragged decode shape, timed with CUDA events,
    then profiled with acc_events on and off, then inside a kernel
    sampler window; each reports the launches it caught out of N."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kafka_tpu_torch.ops.kernels import paged_decode_attention
    from kafka_tpu_torch.runtime.kernel_profiler import KernelSampler

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, P, ps, Hq, Hkv, D = 8, 128, 16, 32, 8, 64
    pages = B * P + 1
    k_pool = torch.randn(pages * ps, Hkv * D, generator=gen, device=dev
                         ).to(torch.bfloat16)
    v_pool = torch.randn_like(k_pool)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    table = (torch.randperm(pages - 1, generator=gen, device=dev) + 1
             ).view(B, P).to(torch.int32)
    lens = torch.tensor([15, 16, 31, 255, 511, 700, 2046, 5],
                        dtype=torch.int32, device=dev)
    call = lambda: paged_decode_attention(  # noqa: E731
        q, k_pool, v_pool, table, lens, page_size=ps)
    N = 200
    out = {"launches": N, "event_ms_per_call": time_ms(call, iters=N)}

    def caught(prof):
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and K1_KERNEL in e.key)

    for acc in (True, False):
        counts = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA],
                         acc_events=acc) as prof:
                for _ in range(N):
                    call()
                torch.cuda.synchronize()
            counts.append(caught(prof))
        out[f"acc_events_{acc}"] = counts
    td = tempfile.mkdtemp()
    try:
        sampler = KernelSampler(1, spill_dir=td, device_type="cuda")
        counts = []
        for _ in range(3):
            sampler.on_step_begin(None)
            for _ in range(N):
                call()
            torch.cuda.synchronize()
            sampler.close(None)
            counts.append(sum(r["count"] for r in sampler.table(100)
                              if K1_KERNEL in r["kernel"]) - sum(counts))
        out["sampler"] = counts
    finally:
        import shutil

        shutil.rmtree(td, ignore_errors=True)
    log(f"profiler catch, {N} K1 launches ({out['event_ms_per_call']:.4f} ms"
        f" each by CUDA events): acc_events on {out['acc_events_True']}, off"
        f" {out['acc_events_False']}, kernel sampler windows "
        f"{out['sampler']}")
    return out


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a nest of dicts, lists, tuples and
    named tuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def allocator_split(dev) -> dict:
    """The caching allocator's segments on `dev`, split into the default
    pool and the private (CUDA-graph) pools: bytes reserved and bytes
    allocated in each."""
    import torch

    out = dict.fromkeys(("default_reserved", "default_allocated",
                         "graph_reserved", "graph_allocated"), 0)
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev.index) != dev.index:
            continue
        kind = "default" if tuple(seg.get("segment_pool_id", (0, 0))) == \
            (0, 0) else "graph"
        out[f"{kind}_reserved"] += int(seg.get("total_size", 0))
        out[f"{kind}_allocated"] += int(seg.get("allocated_size", 0))
    return out


def leftovers(threads_before: set, wait_s: float = 5.0) -> list:
    """What the telemetry phase left running in the process: a Python
    thread started since `threads_before` that does not end within
    `wait_s`, an open torch.profiler session, or the process trace lock
    (kernel sampler / POST /debug/profile) still held."""
    import torch

    from kafka_tpu_torch.runtime import kernel_profiler

    left = []
    deadline = time.monotonic() + wait_s
    for t in threading.enumerate():
        if t.ident not in threads_before and t is not \
                threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                left.append(f"thread {t.name} (daemon {t.daemon})")
    if torch.autograd.profiler._is_profiler_enabled or \
            torch._C._autograd._profiler_enabled():
        left.append("a torch.profiler session is open")
    if kernel_profiler._TRACE_LOCK.locked():
        left.append("the profiler trace lock is held")
    return left


def phase_telemetry(seed: int) -> None:
    """The telemetry plane on the card: the bf16 server's routes and
    gates, an int8 and a speculative server's utilization, the decode
    step's busy share with the flight ring on (and off, its cost), the
    registry's bandwidth utilization against CUDA events, and the
    profiler's catch on a bare loop."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params

    threads_before = {t.ident for t in threading.enumerate()}
    res = {"profile_catch": profile_catch(seed)}
    with tempfile.TemporaryDirectory() as td:
        res["server"] = asyncio.run(_serve_telemetry(td))
        res["int8"] = asyncio.run(_serve_telemetry_variant(
            td, "int8", dict(QUANTIZE="int8", KV_QUANTIZE="int8"),
            "Explain int8 KV caches in two sentences. " * 4, 48))
        res["speculative"] = asyncio.run(_serve_telemetry_variant(
            td, "spec", dict(SPECULATIVE_K=4),
            "one two three four " * 12, 48, fetch_lag=0))
    torch.cuda.empty_cache()
    cfg = get_config("llama-3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(seed + 7)
    busy = {}
    for k in (16, 1):
        for ring in (256, 0):
            eng, clock = _profile_engine(cfg, params, multi_step=k,
                                         flight_ring=ring)
            busy[f"{k}_{ring}"] = graph_profile(eng, clock, cfg, rng,
                                                registry=True)
            del eng
            torch.cuda.empty_cache()
        on, off = busy[f"{k}_256"], busy[f"{k}_0"]
        log(f"  multi_step {k}, flight ring 256 vs off: busy "
            f"{on['device_busy_share']:.4f} vs {off['device_busy_share']:.4f}"
            f", host {on['host_ms_per_step']:.3f} vs "
            f"{off['host_ms_per_step']:.3f} ms/step; registry decode "
            f"hbm_bw_util over the window {on['registry']['hbm_bw_util']:.4f}"
            f" against {on['registry']['event_hbm_bw_util']:.4f} from CUDA "
            f"events (ratio {on['registry']['ratio']:.3f})")
    res["busy"] = busy
    res["leftovers"] = leftovers(threads_before)
    log(f"  left behind by the telemetry phase: {res['leftovers'] or 'none'}")
    RESULTS["telemetry"] = res
    fails = list(res["server"]["fails"]) + res["leftovers"]
    for v in ("int8", "speculative"):
        fails += [f"{v}: {b}" for b in res[v]["utilization"]["out_of_range"]]
    if not res["speculative"]["speculation"]["speculation_verify_steps"]:
        fails.append("speculative server ran no verify step")
    for key in ("16_256", "1_256"):
        if busy[key]["device_busy_share"] < FLIGHT_BUSY_MIN:
            fails.append(f"busy with the flight ring {key}: {busy[key]}")
        reg = busy[key]["registry"]
        if not abs(reg["ratio"] - 1) <= HBM_AGREE:
            fails.append(f"registry hbm_bw_util vs CUDA events {key}: {reg}")
    if fails:
        raise AssertionError(f"telemetry phase: {fails}")
    # each kernel's launches on the telemetry servers (the kernel table
    # carries them beside the engine and server phases')
    res["launches"] = {
        "K1": res["server"]["launches"]["paged_decode_attention"],
        "K2": res["server"]["launches"]["paged_prefill_attention"],
        "K3": res["speculative"]["launches"]["paged_verify_attention"],
        "K4": res["int8"]["launches"]["paged_decode_attention_int8"]}


def main() -> int:
    global BASELINE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernels,engine,graphs,server,telemetry",
                    help="comma list of kernels, engine, graphs, server, "
                         "telemetry (default: all; telemetry runs first), "
                         "or attention (K3 and K4 alone, timed) or mlp (K5 "
                         "alone, timed)")
    ap.add_argument("--root", default=None,
                    help="time another checkout's kernels (the package "
                         "under this directory) on the same inputs; "
                         "prints no result line")
    ap.add_argument("--out", default="chip_smoke.json",
                    help="the record's file name under chiprun_out/")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    BASELINE = args.root is not None
    sys.path.insert(0, os.path.abspath(args.root) if BASELINE else here)
    try:
        from kafka_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: kafka_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    phases = args.phases.split(",")
    # the card's machine has no network: no server booted here may fall
    # back to the reference's remote MCP default (each passes its own)
    os.environ.setdefault("KAFKA_TORCH_MCP_SERVERS", "[]")
    gpu = gpu_line()
    log(f"card: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    # the compile observatory records this run's nvcc builds (boot) and
    # every graph capture after them
    from kafka_tpu_torch.runtime import compile_log

    compile_log.init()
    compile_log.set_phase("boot")
    build_s, build_logs = build.build_all()
    log(f"build: {build_s:.1f}s (nvcc, sm_90a, parallel)")
    ptxas = ptxas_report(build_logs)
    for name, rows in ptxas.items():
        for r in rows:
            log(f"  ptxas {name}: {r['fn']}: {r.get('registers')} registers, "
                f"spill stores {r.get('spill_stores')} B, loads "
                f"{r.get('spill_loads')} B")
    # K2 runs on the tensor cores without spilling, at D 64 and D 128
    k2_fns = ptxas.get("flash_prefill", [])
    if build_logs.get("flash_prefill"):
        spills = [r for r in k2_fns if r.get("spill_stores") or
                  r.get("spill_loads")]
        if len(k2_fns) < 2 or spills:
            raise AssertionError(f"K2 ptxas: {k2_fns}")
    hmma = sass_count("flash_prefill", "HMMA")
    log(f"K2 SASS: {hmma} HMMA instructions (tensor cores)")
    if hmma == 0:
        raise AssertionError("K2 has no tensor-core instructions")
    RESULTS["ptxas"], RESULTS["k2_hmma"] = ptxas, hmma
    RESULTS["build_s"] = build_s
    k5_hmma = sass_count("fused_mlp", "HMMA")
    log(f"K5 SASS: {k5_hmma} HMMA instructions (tensor cores)")
    RESULTS["k5_hmma"] = k5_hmma
    if "telemetry" in phases:
        phase_telemetry(args.seed)
    if "kernels" in phases:
        phase_kernels(args.seed)
    for only in ("attention", "mlp"):
        if only in phases and "kernels" not in phases:
            phase_kernels(args.seed, only=only)
    if "engine" in phases:
        phase_engine(args.seed)
    if "graphs" in phases:
        phase_graphs(args.seed)
    if "server" in phases:
        phase_server()
    for k, n in RESULTS.get("telemetry", {}).get("launches", {}).items():
        if k in RESULTS:
            RESULTS[k]["telemetry_launches"] = n
    RESULTS["total_s"] = time.monotonic() - t0
    RESULTS["card"] = gpu
    drops = RESULTS.get("profile_drops", [])
    caught = RESULTS.get("profile_caught", [])
    log(f"profiles (acc_events=True) that dropped kernel events: "
        f"{len(drops)} of {len(caught)} {drops[:8]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = {"kernels": [
        {**{k: RESULTS[n].get(k) for k in keys},
         **{k: RESULTS[n][k] for k in ("engine_launches", "server_launches",
                                       "telemetry_launches",
                                       "launch_count_basis",
                                       "replay_profiler_launches",
                                       "device_ms", "device_ms_cold_l2",
                                       "sweep_layer_device_ms",
                                       "library_device_ms", "torch_ms",
                                       "cases")
            if k in RESULTS[n]}}
        for n in KERNEL_KEYS if n in RESULTS
    ]}
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", args.out), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    # K5 runs on the tensor cores without spilling (checked after the
    # phases and the record, so that a failing build leaves its numbers)
    k5_fns = ptxas.get("fused_mlp", [])
    k5_spills = [r for r in k5_fns if r.get("spill_stores") or
                 r.get("spill_loads")]
    if not BASELINE and (k5_hmma == 0 or k5_spills or
                         (build_logs.get("fused_mlp") and not k5_fns)):
        raise AssertionError(f"K5: {k5_hmma} HMMA; ptxas {k5_fns}")
    if BASELINE:  # a measurement of another tree, not this one's result
        log(f"baseline {args.root}: record in chiprun_out/{args.out}")
        return 0
    print(json.dumps(kernels_line))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
