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
  5. tiers   — a thread's KV leaves the card and comes back, at full
               llama-3.2-1b width (random weights from --seed, page 16,
               4096 window).  Ship buckets: demote (gather + D2H into
               pinned memory, resolved) and promote (H2D + in-place
               scatter) ms and GB/s per SHIP_BUCKETS size.  (a) bf16:
               eight threads of 3,000 tokens on a tier engine and on one
               whose pages never leave the card; every thread is demoted
               to the host, and turn 2 promotes it (cache_source
               "host_tier"): the streams must equal, and the promoted
               rows equal the rows before demotion byte for byte.
               (d) the tier engine sleeps to an object directory
               (`sleep_to_object`) and a fresh engine over it wakes every
               thread for turn 3 (cache_source "object_tier"), the
               streams equal to the reference engine's.  Thread 0's turn
               3 wake to first token from the host tier, from the object
               tier and by a full re-prefill of the same prompt.
               (b) int8 weights + int8 KV, four threads, as (a): K4 must
               launch.  (c) a thread of two radix nodes under a host
               budget smaller than the thread: demoting it spills to
               disk, the next turn wakes it from the host and from disk.
               (f) a torn promote (`kv.promote` error at the second
               chunk) and a torn object get degrade to a re-prefill whose
               stream equals a cold engine's.  (e) the built-in-tools
               server with KAFKA_TORCH_AGENT_DEMOTE=host and a 0 ms
               linger: a forced `sequentialthinking` turn's gap demotes
               the thread (agent_gap_demotions >= 1, the bytes it freed
               printed), the follow-up model turn promotes it (its
               engine.prefill span reads "host_tier"), the Prometheus
               kv_tier families are non-zero, and /admin/drain/0 returns
               the reference's statistics (401 without the token).  The
               phase's launches are counted from its start
               (`tiers_launches`).  The server phase also makes the
               built-in-tools server's first traffic a forced tool call
               ("required"): after the warmup its grammar compile is a
               cache hit, no table registers and /debug/compiles shows no
               graph capture under first_traffic.
  6. replicas — data-parallel replicas: two full-width llama-3.2-1b bf16
               replicas over [cuda:0, cuda:0] (one copy of the weights,
               random from --seed), each at the tier phase's shape, eight
               threads of 3,000 tokens.  (a) colocated: two turns per
               thread; each thread's turns land on one replica, the
               routing splits 4/4, turn 2 hits the thread's own cache, and
               every stream equals a single engine's fed the same batch.
               (b) `prefill:1,decode:1`: every thread prefills on
               replica 0, its run ships device to device to replica 1,
               whose first lookup reads "shipped", the shipped rows equal
               the source rows byte for byte, the
               streams equal (a)'s (or part at a bf16 near-tie within the
               flip bound: the decode replica re-prefills the last page's
               tokens), and one 3k-token run's ship is timed (ms, GB/s).
               (c) supervision: with a request in flight on replica 1,
               replica 0's step raises three times while its queue waits:
               quarantine, migration to replica 1, probation after the
               0.2 s window, healthy after three clean steps on fresh
               work; every request ends "length", streams equal (a)'s,
               quarantine-to-healthy time logged.  (e) a background
               3k-token tool-result turn beside four interactive streams:
               bg_yields > 0 and every stream equals an engine's that runs
               each turn alone (or a near-tie).  (d) the server from
               KAFKA_TORCH_DP_SIZE=2, KAFKA_TORCH_REPLICA_DEVICES=
               cuda:0,cuda:0 and KAFKA_TORCH_AUTOSCALE=recommend: twelve
               streamed thread turns, POST /admin/resize {"dp": 1} then
               {"dp": 2} while they stream; every stream ends with
               agent_done and [DONE], the server's live bytes after each
               rebuild (the process's less those held before it booted)
               stay within the card's plan (PLAN_MARGIN), the old fleet
               is freed (weak references), the worker's park for
               each rebuild is logged, /admin/signals reports dp 2 with a
               pool section and the supervisor, /admin/autoscaler has
               logged decisions.  The phase's launches are counted from its
               start and summed over replicas (`replicas_launches`).

  7. tp      — tensor parallelism (kafka_tpu_torch/parallel).  The
               per-rank kernel leg runs on any card count: for llama-3.2-1b
               at tp 2 and tp 4 (D 64), a grouped split with one kv head
               per rank (tp 8 x tq 2), llama-3-8b at tp 2 and llama-3-70b
               at tp 4 (D 128, G 4 and 8), every rank's K1, K3 and K4
               through the per-rank wrappers (ops/kernels/sharded.py) on
               its q-head block and pool column block, held to the plain
               version (KERNEL_ATOL / KERNEL_RTOL) and compared bit for bit
               with the full-head kernel's rows; rank 0 of each layout is
               timed beside its plain version, bound and SDPA.  The engine
               leg needs one card per rank (NCCL refuses two ranks on one
               card: with one card visible that refusal is probed and
               quoted, and the leg is reported as not run).  On 2+ cards:
               (a) llama-3.2-1b full width, bf16, tp 2, 8 lanes at a 2048
               window over NCCL with decode graphs, against the
               single-card engine on the same weights (equal streams or
               partings at near-ties inside the flip bound) and a
               plain-attention tp-2 engine (logits within LOGITS_RTOL), K1
               on both ranks, the decode step's ms and busy share, NCCL's
               device time per layer; (b) int8 weights + int8 KV (K4) and
               speculative_k 4 (K3); on 4 cards (c) llama-3-70b at tp 4
               (~37 GB of random bf16 weights per card) against a plain
               engine, each rank's bytes against the planner's per-rank
               plan, and a streamed thread turn through the server from
               KAFKA_TORCH_TP_SIZE=4; then (d) in a child process a tp-2
               server whose rank 1 is killed mid-decode: the stream's
               error event within the guard's deadline, /health 503, no
               rank left running.  The per-rank kernels' kernels-line
               launches are the engine leg's, summed over ranks (0 when
               it did not run).
  8. moe     — Mixtral-class MoE (models/llama.py's dense-dispatch
               _moe_block, parallel/expert.py).  (a) mixtral-8x7b at full
               width and depth with int8 weights on one card (drawn one
               expert at a time and quantized as drawn: the bf16 model
               never exists), bf16 KV, page 16, 8 lanes, a 4096-token
               window, decode graphs at multi_step 16: eight greedy
               requests on the kernel engine (K2 and K1 must launch) held
               against a plain-attention engine on the same parameter
               tree (logits within LOGITS_RTOL, streams equal or parting
               at near-ties inside the flip bound); a cold 3,000-token
               prompt's prefill (host clock; device time by kernel, K2's
               and the GEMMs' shares); the decode step at 8 lanes x ~256
               tokens (graphs phase's profile: ms per step, busy share);
               the weights and pool against the plan and the graph pool's
               bytes beside the plan's activations.  (b) the same with an
               int8 KV pool (K4 must launch, K1 none) against its plain
               engine.  (c) the server from KAFKA_TORCH_MODEL=
               mixtral-8x7b and KAFKA_TORCH_QUANTIZE=int8 (byte
               tokenizer): a streamed thread turn to [DONE], then a
               forced tool call (tool_choice "required", the idle tool)
               whose text must parse.  On 2+ cards (d): bf16 mixtral-8x7b
               at full width and MOE_EP_LAYERS layers at ep 2 ("auto"
               resolves to plain attention, the reference's rule) against
               a single-card engine on the same weights, NCCL per layer,
               each rank's bytes against its plan; on 4 cards (e): full
               depth at ep 2 x tp 2, each rank's bytes against its plan,
               NCCL per layer, and a streamed turn through a server from
               KAFKA_TORCH_EP_SIZE=2 KAFKA_TORCH_TP_SIZE=2.  With fewer
               cards (d) and (e) report "skipped: cards".  The kernels
               line's `moe_launches` are legs (a)-(c)'s counts.
               `--moe-legs de` runs the multi-card legs alone.
  9. vision  — images as a ViT soft prompt (models/vision.py):
               llama-3.2-1b at full width with the reference's default
               VisionConfig() (32x32 images, 16 patches, width 64) and
               image_token_id 262, as in tiny-vision, random weights from
               --seed.  (a) bf16: four images encoded on the card (ms),
               four image prompts (60 to 700 tokens; the 700-token one
               chunks at 512 with its image across the boundary) each
               streamed alone through the kernel engine (K2 on every
               prompt chunk, K1 after) and a plain-attention engine on
               the same weights: logits within LOGITS_RTOL, first-token
               logits printed; the same prompt showing another image must
               move the first-token logits by more than VISION_DIFF_MIN
               and ten times the kernel engine's error; the 700-token
               prompt's prefill and first token timed.  (b) the same with
               int8 weights and an int8 KV pool (K4; K1 and K2 none:
               prefill over an int8 pool is the dequantizing gather).
               (c) when Pillow is installed, the HTTP leg: create_app over
               a provider holding the tower (vocab 263 for the byte
               tokenizer): an image turn as `image_url` and as
               Anthropic-style `image` streams to [DONE] with num_patches
               more prompt tokens than its text alone; a malformed image
               is a 400.  The kernels line's `vision_launches` sum the
               legs' counts, each zeroed just before its main-path drive.
               The server phase's host-masked forced call (ONDEVICE=0)
               chains its grammar-forced tokens: its round trips per call
               are printed and must equal its choice points (positions
               the grammar does not force) and be fewer than its tokens.

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
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref

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
            # the first traffic: a forced tool call on the built-in tools
            out["forced_first"] = await _forced_first_call(
                s, base, state["llm"], tool_defs)
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
            async with s.get(f"{base}/debug/compiles") as r:
                comp = await r.json()
            out["captures_by_phase"] = {}
            for rec in comp["records"]:
                if rec["label"].startswith("decode_graph"):
                    ph = out["captures_by_phase"]
                    ph[rec["phase"]] = ph.get(rec["phase"], 0) + 1
    finally:
        out["K1"] = kernels.paged_decode_attention.launches
        out["K2"] = kernels.paged_prefill_attention.launches
        await runner.cleanup()
    return out


async def _forced_first_call(s, base: str, llm, tool_defs) -> dict:
    """The server's first traffic after its warmup: one model turn with
    tool_choice "required" over the built-in tools plus the idle tool,
    through the provider as the agent loop makes it (no tool runs: the
    forced call may be get_weather, which dials the network).  Warmup
    registered this grammar and captured its FSM step graphs, so the
    grammar compile is a cache hit, no table registers, and
    /debug/compiles shows no graph capture in first_traffic."""
    from kafka_tpu_torch import tracing
    from kafka_tpu_torch.llm.constrained import compile_grammar_for_mask_fn

    async def first_traffic_captures():
        async with s.get(f"{base}/debug/compiles") as r:
            comp = await r.json()
        return [rec for rec in comp["records"]
                if rec["phase"] == "first_traffic"
                and rec["label"].startswith("decode_graph")]

    before = await first_traffic_captures()
    tables = llm.engine._grammars
    n_tables, version = len(tables.grammars), tables.version
    mask = llm.build_tool_call_mask_fn(tool_defs, "required")
    t0 = time.perf_counter()
    grammar = await asyncio.to_thread(compile_grammar_for_mask_fn, mask,
                                      llm.model_cfg.vocab_size)
    grammar_ms = (time.perf_counter() - t0) * 1e3
    root = tracing.start_trace(request_id="forced-first")
    t0 = time.monotonic()
    try:
        chunks = [c async for c in llm.stream_completion(
            [{"role": "user", "content": "Use one of your tools."}],
            tools=tool_defs, temperature=0.7, max_tokens=64,
            logits_mask_fn=mask)]
    finally:
        tracing.finish_trace(root)
    seconds = time.monotonic() - t0
    after = await first_traffic_captures()
    async with s.get(f"{base}/debug/trace/forced-first") as r:
        trace = await r.json()
    by = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            by.setdefault(e["name"], []).append(e["dur"] / 1e3)
    out = {"grammar_compile_ms": grammar_ms, "seconds": seconds,
           "grammar_cached": grammar is not None,
           "new_tables": len(tables.grammars) - n_tables,
           "tables_version_moved": tables.version != version,
           "first_traffic_captures": len(after) - len(before),
           "finish": [c.finish_reason for c in chunks if c.finish_reason],
           "emit_ms": by.get("emit", [None])[0],
           "engine.prefill_ms": by.get("engine.prefill", [None])[0],
           "constrained_ondevice_tokens":
               llm.engine.constrained_ondevice_tokens}
    if grammar is None or out["new_tables"] or out["tables_version_moved"] \
            or out["first_traffic_captures"] or \
            out["finish"] != ["tool_calls"]:
        raise AssertionError(f"forced first call after warmup: {out}")
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


def _wrap_free(g, stream: list, budget: int, slack=None) -> int:
    """Tokens of `stream` emitted before either constrained path's wrap-up
    window (budget_left <= dist + wrap_slack; the compiled slack is at
    least the host mask's 4 characters): there the device FSM's and the
    host mask's rows are provably equal, so their greedy tokens must be.
    Inside it each path closes the JSON by its own rule (the host mask's
    fixed 4-character slack engages later), as in the JAX package.
    `slack`: the engine's table-set slack, the largest of its registered
    grammars' (the warmup registers the built-in tools' grammar), which
    the device FSM applies to every lane; default the grammar's own."""
    slack = g.wrap_slack if slack is None else slack
    state = 0
    for i, t in enumerate(stream):
        if budget - i <= int(g.dist[state]) + slack:
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


def _choice_points(req) -> int:
    """Decode positions of a host-masked request whose token the grammar
    does not force (the mask fn's forced_id is None and it allows more
    than one id): the round trips singleton-mask chaining must leave.
    The first token comes from the prefill; the mask fn is a function of
    the output so far."""
    fn = req.logits_mask_fn
    if fn is None or req.grammar is not None:
        return 0
    n = 0
    for i in range(1, len(req.output_ids)):
        ctx = req.output_ids[:i]
        fid = fn.forced_id(ctx) if hasattr(fn, "forced_id") else None
        allowed = fn(ctx) if fid is None else [fid]
        n += allowed is None or len(allowed) != 1
    return n


async def _constrained_turn(session, url: str, tool_choice, engine, seen,
                            tokenizer, tool_defs,
                            model: str = "llama-3.2-1b") -> dict:
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
        "model": model, "stream": True, "temperature": 0,
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
            # host-masked lanes: the choice points that awaited a round
            # trip (grammar-forced tokens chain without one)
            "roundtrips": req.constrained_roundtrips,
            "choice_points": _choice_points(req),
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
    # singleton-mask chaining: the host-masked lane's grammar-forced
    # tokens dispatch without a round trip, so it makes exactly one round
    # trip per genuine choice point, and fewer than its decoded tokens
    log(f"constrained host-mask turn (chained): {host['roundtrips']} round "
        f"trips for {host['tokens']} tokens in one forced call "
        f"({host['choice_points']} choice points, "
        f"{host['tokens'] - 1 - host['roundtrips']} tokens chained)")
    if host["roundtrips"] != host["choice_points"] or \
            not host["roundtrips"] < host["tokens"] - 1:
        raise AssertionError(f"the host-masked lane did not chain: {host}")
    fsm_ids = turns["required"]["output_ids"]
    slack = max(g.wrap_slack for g in engine._grammars.grammars)
    n = _wrap_free(turns["required"]["grammar"], fsm_ids,
                   CONSTRAINED_MAX_TOKENS, slack=slack)
    host["table_set_slack"] = slack
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
    ff = out["forced_first"]
    log(f"server first traffic after warmup: forced tool call (required, "
        f"built-in tools) in {ff['seconds']:.3f}s; grammar compile "
        f"{ff['grammar_compile_ms']:.3f} ms (cache hit), new tables "
        f"{ff['new_tables']}, graph captures in first_traffic "
        f"{ff['first_traffic_captures']}; prefill "
        f"{ff['engine.prefill_ms']} ms, emit {ff['emit_ms']} ms; decode-graph "
        f"captures by phase over the whole server {out['captures_by_phase']}")
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
# phase 5: the KV tiers — a thread's KV leaves the card and comes back
# ---------------------------------------------------------------------------

# thread prompt length ("about 3k tokens": a cold agent turn with the
# built-in tools' schemas is 3,218 byte tokens) and the turns' lengths
TIER_PROMPT = 3000
TIER_TURN_NEW = 8
TIER_SUFFIX = 16


def _tier_cfg(**kw):
    """The tier phase's engines: full-width llama-3.2-1b, page 16, a
    4096-token window (a 3k-token thread and its next turns fit), kernel
    attention, 8 slots, room for eight threads' runs."""
    from kafka_tpu_torch.runtime import EngineConfig

    kw.setdefault("attention_backend", "kernel")
    return EngineConfig(max_batch=8, page_size=16, num_pages=2400,
                        max_pages_per_seq=256,
                        prefill_buckets=(64, 128, 256, 512, 1024, 2048),
                        **kw)


def _tier_turn(eng, prompts, max_new: int, keys, alone: int = 0):
    """One turn of each thread (prefix_key per thread): the first `alone`
    threads one at a time, the rest together.  Returns the requests."""
    from kafka_tpu_torch.runtime import GenRequest

    reqs = [GenRequest(request_id=f"{k}-{len(p)}", prompt_ids=list(p),
                       max_new_tokens=max_new, prefix_key=k)
            for k, p in zip(keys, prompts)]
    for r in reqs[:alone]:
        eng.submit(r)
        eng.run_to_completion()
    for r in reqs[alone:]:
        eng.submit(r)
    eng.run_to_completion()
    for r in reqs:
        if len(r.output_ids) != max_new:
            raise AssertionError(f"{r.request_id}: {len(r.output_ids)} "
                                 f"tokens, finish {r.finish_reason}")
    return reqs


def _ttft_ms(req) -> float:
    return (req.first_token_time - req.submit_time) * 1e3


def _chain_rows(eng, key: str):
    """The device rows (every pool leaf) of thread `key`'s radix chain,
    copied, with the chain's token runs."""
    import torch

    from kafka_tpu_torch.runtime.kv_tier import pool_leaves

    ps = eng.ecfg.page_size
    out = []
    for node in eng.prefix_cache._claimed_chain(key):
        if not node.pages:
            raise AssertionError(f"{key}: chain node not on the card")
        idx = torch.tensor([p * ps + i for p in node.pages
                            for i in range(ps)], device=eng.device)
        out.append((list(node.tokens), [
            a.index_select(1, idx).clone()
            for a in pool_leaves(eng.k_pool) + pool_leaves(eng.v_pool)]))
    return out


def _rows_equal(before, after) -> bool:
    import torch

    return len(before) == len(after) and all(
        tb == ta and all(torch.equal(x, y) for x, y in zip(rb, ra))
        for (tb, rb), (ta, ra) in zip(before, after))


def _warm_engine(eng, vocab: int, rng) -> None:
    """A cold prompt of the thread length, no prefix key: builds the
    prefill chunk shapes and the decode graph before anything is timed."""
    from kafka_tpu_torch.runtime import GenRequest

    p = rng.randint(0, vocab, size=TIER_PROMPT).tolist()
    eng.submit(GenRequest(request_id="warm", prompt_ids=p, max_new_tokens=2))
    eng.run_to_completion()
    eng.warmup_kv_tier()


def tiers_ships(eng) -> list:
    """Demote (gather + D2H into pinned memory, resolved) and promote (H2D
    + in-place scatter) of one run per ship bucket on the card, CUDA-
    synchronized, median of 5; GB/s over the run's pool bytes."""
    import torch

    from kafka_tpu_torch.runtime.kv_tier import SHIP_BUCKETS

    ship = eng.kv_tier.shipper
    rows = []
    for b in SHIP_BUCKETS:
        pages = eng.pool.alloc(b)
        d, p = [], []
        try:
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k_l, v_l = ship.resolve(ship.export_run(pages))
                t1 = time.perf_counter()
                ship.import_run(k_l, v_l, b, pages)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                d.append(t1 - t0)
                p.append(t2 - t1)
        finally:
            eng.pool.release(pages)
        nbytes = b * ship.bytes_per_page()
        dm, pm = sorted(d)[2], sorted(p)[2]
        rows.append({"pages": b, "bytes": nbytes,
                     "demote_ms": dm * 1e3, "promote_ms": pm * 1e3,
                     "demote_gbps": nbytes / dm / 1e9,
                     "promote_gbps": nbytes / pm / 1e9})
    return rows


def tiers_engine(cfg, params, rng, label: str, n: int, objdir=None,
                 **ekw) -> dict:
    """(a) / (b) and (d): n threads of TIER_PROMPT tokens on a tier engine
    and on an engine whose pages never leave the card.  Turn 1 on both;
    the tier engine demotes every thread to the host; turn 2 promotes
    them: the streams must equal the reference engine's and the promoted
    rows the rows before demotion, byte for byte.  With `objdir`, the tier
    engine then sleeps to the object store and a fresh engine over it
    wakes every thread for turn 3 (cache_source "object_tier"), its
    streams equal to the reference engine's turn 3.  Wake-to-first-token
    of thread 0's turn 3 from the host tier, from the object tier, and by
    a full re-prefill of the same prompt."""
    import torch

    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import GenRequest, InferenceEngine

    keys = [f"{label}-t{i}" for i in range(n)]
    p1 = [rng.randint(0, cfg.vocab_size, size=TIER_PROMPT).tolist()
          for _ in range(n)]
    ref = InferenceEngine(cfg, params, _tier_cfg(**ekw))
    tier = InferenceEngine(cfg, params, _tier_cfg(
        kv_host_tier_mb=n * 160, kv_object_dir=objdir, **ekw))
    for e in (ref, tier):
        _warm_engine(e, cfg.vocab_size, rng)
    r1 = _tier_turn(ref, p1, TIER_TURN_NEW, keys)
    t1 = _tier_turn(tier, p1, TIER_TURN_NEW, keys)
    if [r.output_ids for r in r1] != [r.output_ids for r in t1]:
        raise AssertionError(f"{label}: turn 1 streams differ")
    before = {k: _chain_rows(tier, k) for k in keys}
    pc, mgr = tier.prefix_cache, tier.kv_tier
    free0 = tier.pool.free_pages
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = sum(pc.demote_thread(k)["pages"] for k in keys)
    t_enq = time.perf_counter() - t0
    mgr.flush()
    t_res = time.perf_counter() - t0
    freed = tier.pool.free_pages - free0
    if pc.host_nodes < n or freed < pages:
        raise AssertionError(f"{label}: demoted {pc.host_nodes} nodes, "
                             f"freed {freed} of {pages} pages")
    demoted_bytes = mgr.bytes_demoted
    p2 = [p + r.output_ids + rng.randint(0, cfg.vocab_size,
                                         size=TIER_SUFFIX).tolist()
          for p, r in zip(p1, r1)]
    r2 = _tier_turn(ref, p2, TIER_SUFFIX, keys)
    fns = {"K1": kernels.paged_decode_attention,
           "K2": kernels.paged_prefill_attention,
           "K4": kernels.paged_decode_attention_int8}
    start = {k: f.launches for k, f in fns.items()}
    t2 = _tier_turn(tier, p2, TIER_SUFFIX, keys)
    torch.cuda.synchronize()
    launches = {k: f.launches - start[k] for k, f in fns.items()}
    sources = sorted({r.cache_source for r in t2})
    if sources != ["host_tier"] or any(
            r.cached_tokens != q.cached_tokens for r, q in zip(t2, r2)):
        raise AssertionError(f"{label}: turn 2 sources {sources}, cached "
                             f"{[r.cached_tokens for r in t2]} vs "
                             f"{[r.cached_tokens for r in r2]}")
    same = [a.output_ids == b.output_ids for a, b in zip(t2, r2)]
    if not all(same):
        raise AssertionError(f"{label}: turn 2 streams differ from the "
                             f"engine whose pages stayed: {same}")
    rows_ok = all(_rows_equal(before[k], _chain_rows(tier, k)[:len(before[k])])
                  for k in keys)
    if not rows_ok:
        raise AssertionError(f"{label}: promoted rows differ")
    # the threads' short suffixes prefill together in one batched
    # dispatch (plain attention, as in the JAX package); a lone wake's
    # suffix goes through K2 (below)
    quant = ekw.get("kv_quantize") == "int8"
    if (launches["K4"] if quant else launches["K1"]) == 0:
        raise AssertionError(f"{label}: turn 2 launches {launches}")
    out = {
        "threads": n, "prompt_tokens": TIER_PROMPT,
        "pages_demoted": pages, "bytes_demoted": demoted_bytes,
        "demote_enqueue_ms": t_enq * 1e3, "demote_resolved_ms": t_res * 1e3,
        "demote_gbps": demoted_bytes / t_res / 1e9,
        "turn2_cached_tokens": [r.cached_tokens for r in t2],
        "turn2_launches": launches, "streams_equal": True,
        "rows_equal": True, "tier": mgr.snapshot(),
        "bytes_per_token": mgr.bytes_for_pages(1) / 16,
    }
    # thread 0's turn 3, three ways, the same prompt
    p3 = [p + r.output_ids + rng.randint(0, cfg.vocab_size,
                                         size=TIER_SUFFIX).tolist()
          for p, r in zip(p2, r2)]
    r3 = _tier_turn(ref, p3, TIER_SUFFIX, keys, alone=1)
    if objdir is not None:
        stats = tier.sleep_to_object()
        if not stats.get("enabled") or stats["runs_failed"] or \
                stats["manifests"] < n:
            raise AssertionError(f"{label}: sleep_to_object {stats}")
        out["sleep"] = stats
    pc.demote_thread(keys[0])
    mgr.flush()
    k2 = kernels.paged_prefill_attention.launches
    h = _tier_turn(tier, p3[:1], TIER_SUFFIX, keys[:1])[0]
    out["wake_k2_launches"] = kernels.paged_prefill_attention.launches - k2
    # (an int8 pool's prefill reads through the dequantizing page gather,
    # as in the JAX package: no K2)
    if h.cache_source != "host_tier" or h.output_ids != r3[0].output_ids \
            or not (quant or out["wake_k2_launches"]):
        raise AssertionError(f"{label}: host wake {h.cache_source}, K2 "
                             f"{out['wake_k2_launches']}")
    # a full re-prefill of the same prompts (threads 0 and 1, alone): the
    # stream a failed promote or wake must give.  Its prefix KV comes
    # from prefill GEMMs, the cached KV partly from decode steps, so in
    # bf16 the two streams may part at a near-tie: recorded, not held
    cold = InferenceEngine(cfg, params, _tier_cfg(**ekw))
    _warm_engine(cold, cfg.vocab_size, rng)
    c = [cold.generate(p, max_new_tokens=TIER_SUFFIX) for p in p3[:2]]
    out["wake_ttft_ms"] = {"host_tier": _ttft_ms(h),
                           "reprefill": _ttft_ms(c[0])}
    out["wake_cached_tokens"] = {"host_tier": h.cached_tokens}
    out["reprefill_equals_cached_stream"] = [
        a.output_ids == b.output_ids for a, b in zip(c, r3)]
    del cold
    if objdir is not None:
        del tier
        torch.cuda.empty_cache()
        fresh = InferenceEngine(cfg, params, _tier_cfg(
            kv_host_tier_mb=n * 160, kv_object_dir=objdir, **ekw))
        _warm_engine(fresh, cfg.vocab_size, rng)
        w3 = _tier_turn(fresh, p3, TIER_SUFFIX, keys, alone=1)
        srcs = sorted({r.cache_source for r in w3})
        if srcs != ["object_tier"]:
            raise AssertionError(f"{label}: object wake sources {srcs}")
        if [r.output_ids for r in w3] != [r.output_ids for r in r3]:
            raise AssertionError(f"{label}: object wake streams differ")
        out["wake_ttft_ms"]["object_tier"] = _ttft_ms(w3[0])
        out["wake_cached_tokens"]["object_tier"] = w3[0].cached_tokens
        out["object"] = fresh.kv_tier.object.snapshot()
        out["object_wake_streams_equal"] = True
        # (f) a torn object get: the wake aborts, the request re-prefills
        from kafka_tpu_torch import failpoints

        fresh2 = InferenceEngine(cfg, params, _tier_cfg(
            kv_host_tier_mb=n * 160, kv_object_dir=objdir, **ekw))
        failpoints.configure("kv.object_get", "error", "chip")
        try:
            g = fresh2.generate(p3[1], max_new_tokens=TIER_SUFFIX,
                                prefix_key=keys[1])
        finally:
            failpoints.clear()
        if g.cache_source == "object_tier" or \
                g.output_ids != c[1].output_ids or fresh2.self_check():
            raise AssertionError(f"{label}: torn object get {g.cache_source}")
        out["torn_object_get"] = {"cache_source": g.cache_source,
                                  "stream_equal": True}
        fresh.close()
        fresh2.close()
        del fresh, fresh2
    else:
        # (f) a torn promote (the second chunk's copy fails): pages freed,
        # the request re-prefills with the same stream
        from kafka_tpu_torch import failpoints

        pc.demote_thread(keys[1])
        mgr.flush()
        failpoints.configure("kv.promote", "error", "chip", nth=2)
        try:
            g = _tier_turn(tier, p3[1:2], TIER_SUFFIX, keys[1:2])[0]
        finally:
            failpoints.clear()
        if g.cache_source == "host_tier" or \
                g.output_ids != c[1].output_ids or tier.self_check():
            raise AssertionError(f"{label}: torn promote {g.cache_source}")
        out["torn_promote"] = {"cache_source": g.cache_source,
                               "promote_failures": mgr.promote_failures,
                               "stream_equal": True}
        tier.close()
        del tier
    del ref
    torch.cuda.empty_cache()
    return out


def tiers_disk(cfg, params, rng, td: str) -> dict:
    """(c) a thread of two radix nodes (a 1600-token turn, then 1500 more
    tokens) under a host budget of 1.25x its larger node: smaller than
    the thread's run (~97 MB), larger than each node, so demoting the
    thread spills a node to disk; the next turn wakes the thread from the
    host and from disk, its stream equal to the reference engine's."""
    from kafka_tpu_torch.runtime import InferenceEngine

    ref = InferenceEngine(cfg, params, _tier_cfg())
    eng = InferenceEngine(cfg, params, _tier_cfg(
        kv_host_tier_mb=64, kv_disk_tier_dir=os.path.join(td, "disk")))
    p1 = rng.randint(0, cfg.vocab_size, size=1600).tolist()
    extra = rng.randint(0, cfg.vocab_size, size=1500).tolist()
    tail = rng.randint(0, cfg.vocab_size, size=TIER_SUFFIX).tolist()
    outs = []
    for e in (ref, eng):
        a = _tier_turn(e, [p1], TIER_TURN_NEW, ["disk-t"])[0]
        p2 = p1 + a.output_ids + extra
        b = _tier_turn(e, [p2], TIER_TURN_NEW, ["disk-t"])[0]
        p3 = p2 + b.output_ids + tail
        if e is eng:
            chain = e.prefix_cache._claimed_chain("disk-t")
            thread_bytes = e.kv_tier.bytes_for_pages(
                sum(len(n.pages) for n in chain))
            e.kv_tier.host_budget_bytes = int(1.25 * e.kv_tier.bytes_for_pages(
                max(len(n.pages) for n in chain)))
            e.prefix_cache.demote_thread("disk-t")
            e.kv_tier.flush()
            snap = e.kv_tier.snapshot()
            if snap["disk_spills"] < 1 or len(chain) < 2:
                raise AssertionError(f"disk: no spill ({len(chain)} nodes, "
                                     f"{snap})")
        c = _tier_turn(e, [p3], TIER_SUFFIX, ["disk-t"])[0]
        outs.append(c)
    got, want = outs[1], outs[0]
    snap = eng.kv_tier.snapshot()
    if got.cache_source != "host_tier" or snap["disk_loads"] < 1 or \
            got.output_ids != want.output_ids:
        raise AssertionError(f"disk wake: {got.cache_source}, {snap}")
    eng.close()
    return {"thread_bytes": thread_bytes,
            "host_budget_bytes": snap["host_budget_bytes"],
            "nodes": len(chain), "tier": snap,
            "cached_tokens": got.cached_tokens, "stream_equal": True}


async def _serve_tiers(db_path: str, store: str) -> dict:
    """(e) the server with the built-in tools, KAFKA_TORCH_AGENT_DEMOTE=host
    and a 0 ms linger: a thread turn forcing the built-in
    `sequentialthinking` tool ends in a tool call, its gap demotes the
    thread's KV, and the follow-up model turn of the same agent run
    promotes it (cache_source "host_tier" on its engine.prefill span);
    the /metrics tier families are non-zero; /admin/drain/0 with the
    token returns the reference's statistics."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    os.environ["KAFKA_TORCH_AGENT_DEMOTE"] = "host"
    os.environ["KAFKA_TORCH_AGENT_LINGER_MS"] = "0"
    try:
        cfg = ServingConfig(
            model_name="llama-3.2-1b", max_batch=8, page_size=16,
            num_pages=8 * 256 + 64, max_pages_per_seq=256,
            prefill_buckets=(64, 128, 256, 512, 1024, 2048),
            max_new_tokens_default=32, db_path=db_path, multi_step=16,
            system_prompt="You are a terse assistant.", api_token="tok",
            kv_host_tier_mb=1024, kv_object_dir=store)
        app = await create_app(cfg, mcp_servers=[])
    finally:
        del os.environ["KAFKA_TORCH_AGENT_DEMOTE"]
        del os.environ["KAFKA_TORCH_AGENT_LINGER_MS"]
    engine = app[STATE_KEY]["llm"].engine
    if engine.ecfg.agent_demote != "host" or engine.ecfg.agent_linger_s:
        raise AssertionError(f"agent knobs not read: {engine.ecfg}")
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    auth = {"Authorization": "Bearer tok"}
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.monotonic()
            ev = await _stream(
                s, f"{base}/v1/threads/gap/chat/completions",
                {"model": "llama-3.2-1b", "stream": True, "temperature": 0,
                 "max_tokens": 48,
                 "tool_choice": {"type": "function", "function": {
                     "name": "sequentialthinking"}},
                 "messages": [{"role": "user",
                               "content": "Think it through."}]},
                headers={**auth, "X-Request-Id": "gap-turn"})
            out["seconds"] = time.monotonic() - t0
            calls = [e for e in ev if e.get("object") ==
                     "chat.completion.chunk" and any(
                         (c.get("delta") or {}).get("tool_calls")
                         for c in e.get("choices", []))]
            if not calls:
                raise AssertionError("the forced turn made no tool call")
            async with s.get(f"{base}/debug/trace/gap-turn",
                             headers=auth) as r:
                trace = await r.json()
            spans = [e for e in trace.get("traceEvents", [])
                     if e.get("name") == "engine.prefill"]
            out["prefill_sources"] = [
                (e.get("args") or {}).get("cache_source") for e in spans]
            async with s.get(f"{base}/metrics", headers=auth) as r:
                snap = await r.json()
            async with s.get(f"{base}/metrics?format=prometheus",
                             headers=auth) as r:
                prom = await r.text()
            async with s.post(f"{base}/admin/drain/0", headers=auth) as r:
                out["drain_status"] = r.status
                out["drain"] = await r.json()
            async with s.post(f"{base}/admin/drain/0") as r:
                out["drain_no_token"] = r.status
    finally:
        await runner.cleanup()
    ag = snap["agent"]
    out["agent"] = ag
    out["kv_tier"] = snap.get("kv_tier")
    out["prefix_cache"] = snap.get("prefix_cache")
    fams = {}
    for line in prom.splitlines():
        if line.startswith("kafka_tpu_kv_tier_"):
            name, _, val = line.rpartition(" ")
            fams[name] = float(val)
    out["prometheus_kv_tier"] = fams
    if ag["agent_gap_demotions"] < 1 or ag["agent_gap_bytes_demoted"] <= 0:
        raise AssertionError(f"server: no gap demotion: {ag}")
    if "host_tier" not in out["prefill_sources"]:
        raise AssertionError(f"server: the follow-up turn did not promote: "
                             f"{out['prefill_sources']}")
    if not any(v > 0 for k, v in fams.items()
               if k.startswith("kafka_tpu_kv_tier_total")):
        raise AssertionError(f"server: kv_tier families all zero: {fams}")
    ref_keys = {"enabled", "runs_archived", "runs_failed",
                "runs_skipped_store_down", "manifests", "manifests_failed",
                "threads", "bytes_put", "dedupe_hits", "breaker_state",
                "replica"}
    d = out["drain"]
    if out["drain_status"] != 200 or set(d) != ref_keys or \
            d["runs_archived"] < 1 or d["manifests"] < 1 or \
            out["drain_no_token"] != 401:
        raise AssertionError(f"server: /admin/drain/0 {out['drain_status']} "
                             f"{d}")
    return out


def phase_tiers(seed: int) -> None:
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params
    from kafka_tpu_torch.models.quant import quantize_params
    from kafka_tpu_torch.runtime import InferenceEngine

    from kafka_tpu_torch.ops import kernels

    cfg = get_config("llama-3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    params = init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(seed + 5)
    out = {}
    # the phase's own path: counts from 0 here, read at its end
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as td:
        eng = InferenceEngine(cfg, params, _tier_cfg(kv_host_tier_mb=256))
        eng.warmup_kv_tier()
        out["ships_bf16"] = tiers_ships(eng)
        eng.close()
        del eng
        for r in out["ships_bf16"]:
            log(f"tiers ship bf16 {r['pages']:>2} pages ({r['bytes']} B): "
                f"demote {r['demote_ms']:.3f} ms "
                f"({r['demote_gbps']:.2f} GB/s), promote "
                f"{r['promote_ms']:.3f} ms ({r['promote_gbps']:.2f} GB/s)")
        out["bf16"] = tiers_engine(cfg, params, rng, "bf16", 8,
                                   objdir=os.path.join(td, "objects"))
        out["bf16_torn"] = tiers_engine(cfg, params, rng, "bf16t", 2)
        out["disk"] = tiers_disk(cfg, params, rng, td)
        q = quantize_params(params, cfg)
        out["int8"] = tiers_engine(cfg, q, rng, "int8", 4,
                                   kv_quantize="int8")
        del q
        torch.cuda.empty_cache()
        out["server"] = asyncio.run(_serve_tiers(
            os.path.join(td, "tiers.db"), os.path.join(td, "srv-objects")))
    del params
    torch.cuda.empty_cache()
    launches = {"K1": kernels.paged_decode_attention.launches,
                "K2": kernels.paged_prefill_attention.launches,
                "K3": kernels.paged_verify_attention.launches,
                "K4": kernels.paged_decode_attention_int8.launches}
    out["launches"] = launches
    for k, n in launches.items():
        if k in RESULTS:
            RESULTS[k]["tiers_launches"] = n
    if not (launches["K1"] and launches["K2"] and launches["K4"]):
        raise AssertionError(f"tiers phase launches {launches}")
    log(f"tiers launches (counted from the phase's start): {launches}")
    for label in ("bf16", "int8"):
        o = out[label]
        w = o["wake_ttft_ms"]
        log(f"tiers ({label}): {o['threads']} threads x {TIER_PROMPT} "
            f"tokens; demoted {o['pages_demoted']} pages "
            f"({o['bytes_demoted']} B) in {o['demote_resolved_ms']:.2f} ms "
            f"resolved ({o['demote_gbps']:.2f} GB/s; enqueue "
            f"{o['demote_enqueue_ms']:.2f} ms); turn 2 promoted "
            f"{o['turn2_cached_tokens'][0]} tokens a thread, streams equal "
            f"the engine whose pages stayed, promoted rows byte-equal; "
            f"launches {o['turn2_launches']}; thread 0 wake to first token: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in w.items()))
    b = out["bf16"]
    log(f"tiers (d) object: sleep {b['sleep']}; fresh engine woke "
        f"{b['object']['wake_threads']} threads "
        f"({b['object']['wake_tokens']} tokens, "
        f"{b['object']['object_bytes_got']} B), streams equal; torn get -> "
        f"{b['torn_object_get']}")
    log(f"tiers (f) torn promote -> {out['bf16_torn']['torn_promote']}")
    d = out["disk"]
    log(f"tiers (c) disk: thread {d['thread_bytes']} B over {d['nodes']} "
        f"nodes, host budget {d['host_budget_bytes']} B: spills "
        f"{d['tier']['disk_spills']}, loads {d['tier']['disk_loads']}; "
        f"wake cached {d['cached_tokens']} tokens, stream equal")
    s = out["server"]
    log(f"tiers (e) server: forced sequentialthinking turn in "
        f"{s['seconds']:.2f}s; gap freed {s['agent']['agent_gap_bytes_demoted']}"
        f" B ({s['agent']['agent_gap_pages_demoted']} pages, "
        f"{s['agent']['agent_gap_demotions']} demotions); prefill sources "
        f"{s['prefill_sources']}; /admin/drain/0 -> {s['drain_status']} "
        f"{s['drain']}")
    RESULTS["tiers"] = out


# ---------------------------------------------------------------------------
# phase 6: data-parallel replicas on one card
# ---------------------------------------------------------------------------

REP_THREADS = 8
REP_PROMPT = 3000
REP_NEW = 8
REP_SUFFIX = 16


def _rep_cfg(**kw):
    """One replica's engine: the tier phase's shape (full-width
    llama-3.2-1b, page 16, a 4096-token window, kernel attention, 8
    slots), with each sampled row's logits kept for the near-tie check."""
    return _tier_cfg(keep_logits=True, **kw)


def _rep_router(cfg, params, dev, rng, **kw):
    """Two replicas of llama-3.2-1b over [dev, dev] (one copy of the
    weights), each warmed like the tier phase's engines."""
    from kafka_tpu_torch.runtime.dp_router import DataParallelEngines

    router = DataParallelEngines(cfg, params, _rep_cfg(), dp=2,
                                 devices=[dev, dev], **kw)
    for e in router.engines:
        _warm_engine(e, cfg.vocab_size, rng)
    return router


def _rep_streams_match(got, want, label: str) -> list:
    """Greedy streams equal, or parting only at a bf16 near-tie of the
    reference's logits (the flip bound); the near-ties found."""
    ties = []
    for a, b in zip(got, want):
        if len(a.output_ids) != len(a.logits) or \
                len(a.output_ids) != len(b.output_ids) or \
                a.finish_reason not in ("length", "stop"):
            raise AssertionError(f"{label}: {a.request_id} finished "
                                 f"{a.finish_reason} with "
                                 f"{len(a.output_ids)} tokens / "
                                 f"{len(a.logits)} logit rows, reference "
                                 f"{len(b.output_ids)}")
        ties += _near_ties([a], [b], len(a.output_ids))
    return ties


def _rep_turns(eng, keys, prompts, max_new: int, tag: str):
    """One turn of each thread through `eng` (router or engine), all
    submitted together; the requests and, for a router, each one's route
    at submit."""
    from kafka_tpu_torch.runtime import GenRequest

    reqs = [GenRequest(request_id=f"{k}-{tag}", prompt_ids=list(p),
                       max_new_tokens=max_new, prefix_key=k)
            for k, p in zip(keys, prompts)]
    routes = []
    for r in reqs:
        eng.submit(r)
        routes.append(getattr(eng, "_route", {}).get(r.request_id))
    eng.run_to_completion()
    return reqs, routes


def replicas_colocated(cfg, params, dev, keys, p1, suffixes, rng) -> dict:
    """(a) eight threads, two turns each, over two colocated replicas:
    each thread's turns land on one replica, the load splits 4/4, turn 2
    hits the thread's own cache, and every stream equals a single
    engine's on the same weights (each replica's threads run there
    together, the batch the replica saw)."""
    from kafka_tpu_torch.runtime import InferenceEngine

    router = _rep_router(cfg, params, dev, rng)
    t1, r1 = _rep_turns(router, keys, p1, REP_NEW, "1")
    p2 = [p + r.output_ids + s for p, r, s in zip(p1, t1, suffixes)]
    t2, r2 = _rep_turns(router, keys, p2, REP_SUFFIX, "2")
    split = [r1.count(0), r1.count(1)]
    if r1 != r2 or split != [4, 4]:
        raise AssertionError(f"(a) routes turn 1 {r1}, turn 2 {r2}")
    if any(r.cache_source != "own" or r.cached_tokens <= 0 for r in t2):
        raise AssertionError(f"(a) turn 2 sources "
                             f"{[(r.cache_source, r.cached_tokens) for r in t2]}")
    if router.self_check():
        raise AssertionError(f"(a) self_check {router.self_check()}")
    router.close()
    del router
    single = InferenceEngine(cfg, params, _rep_cfg())
    _warm_engine(single, cfg.vocab_size, rng)
    s1, s2 = [None] * len(keys), [None] * len(keys)
    for rep in (0, 1):
        idx = [i for i, r in enumerate(r1) if r == rep]
        a, _ = _rep_turns(single, [keys[i] for i in idx],
                          [p1[i] for i in idx], REP_NEW, "s1")
        b, _ = _rep_turns(single, [keys[i] for i in idx],
                          [p2[i] for i in idx], REP_SUFFIX, "s2")
        for i, x, y in zip(idx, a, b):
            s1[i], s2[i] = x, y
    ties = (_rep_streams_match(t1, s1, "(a) turn 1")
            + _rep_streams_match(t2, s2, "(a) turn 2"))
    single.close()
    del single
    return {"t1": t1, "t2": t2, "p2": p2, "routes": r1, "split": split,
            "turn2_cached_tokens": [r.cached_tokens for r in t2],
            "near_ties": ties,
            "streams_equal": all(a.output_ids == b.output_ids
                                 for a, b in zip(t1 + t2, s1 + s2))}


def _chain_pages(eng, key: str, n: int) -> list:
    pages = []
    for node in eng.prefix_cache._claimed_chain(key):
        pages.extend(node.pages)
    return pages[:n]


def _page_rows(eng, pages):
    import torch

    from kafka_tpu_torch.runtime.kv_tier import pool_leaves

    ps = eng.ecfg.page_size
    idx = torch.tensor([p * ps + i for p in pages for i in range(ps)],
                       device=eng.device)
    return [a.index_select(1, idx)
            for a in pool_leaves(eng.k_pool) + pool_leaves(eng.v_pool)]


def replicas_ship_timing(src, dst, pages) -> dict:
    """The cross-replica ship of one thread's run (`pages` of the source
    pool) into fresh destination pages, CUDA-synchronized, median of 5."""
    import torch

    from kafka_tpu_torch.runtime.kv_tier import CrossReplicaPageShipper

    ship = CrossReplicaPageShipper(src, dst, src.ecfg.page_size)
    dest = dst.pool.alloc(len(pages))
    times = []
    try:
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = ship.ship(pages, dest)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        equal = all(torch.equal(a, b) for a, b in zip(
            _page_rows(src, pages), _page_rows(dst, dest)))
    finally:
        dst.pool.release(dest)
    t = sorted(times)[2]
    if not equal:
        raise AssertionError("ship timing: rows differ")
    return {"pages": len(pages), "bytes": nbytes,
            "ms": t * 1e3, "gbps": nbytes / t / 1e9,
            "tokens": len(pages) * src.ecfg.page_size}


def replicas_disagg(cfg, params, dev, keys, p1, want, rng) -> dict:
    """(b) prefill:1,decode:1: each thread's turn prefills on replica 0
    as a hand-off, its run ships to replica 1, whose first lookup reads
    "shipped"; the shipped rows equal the source rows
    byte for byte and the streams equal (a)'s (or part at a bf16 near-
    tie: the decode replica re-prefills the page boundary's tokens)."""
    import torch

    router = _rep_router(cfg, params, dev, rng,
                         dp_roles="prefill:1,decode:1")
    router.warmup_disagg()
    t1, routes = _rep_turns(router, keys, p1, REP_NEW, "b")
    src, dst = router.engines
    n_full = (REP_PROMPT // 16)
    if routes != [0] * len(keys) or any(
            r.cache_source != "shipped" for r in t1):
        raise AssertionError(f"(b) routes {routes}, sources "
                             f"{[r.cache_source for r in t1]}")
    rows_equal = all(
        all(torch.equal(a, b) for a, b in zip(
            _page_rows(src, _chain_pages(src, k, n_full)),
            _page_rows(dst, _chain_pages(dst, k, n_full))))
        for k in keys)
    if not rows_equal:
        raise AssertionError("(b) shipped rows differ")
    snap = router.disagg.snapshot()
    if snap["disagg_shipped_runs"] != len(keys) or \
            snap["disagg_ship_device_runs"] != len(keys):
        raise AssertionError(f"(b) ship counters {snap}")
    ties = _rep_streams_match(t1, want, "(b)")
    timing = replicas_ship_timing(src, dst, _chain_pages(src, keys[0],
                                                         n_full))
    problems = router.self_check()
    if problems:
        raise AssertionError(f"(b) self_check {problems}")
    router.close()
    del router
    torch.cuda.empty_cache()
    return {"near_ties": ties,
            "streams_equal": all(a.output_ids == b.output_ids
                                 for a, b in zip(t1, want)),
            "cached_tokens": [r.cached_tokens for r in t1],
            "rows_equal": rows_equal, "ship": timing,
            "disagg": {k: v for k, v in snap.items() if k != "ship_ms"},
            "ship_enqueue_ms_max": snap["ship_ms"]["max"]}


def replicas_supervision(cfg, params, dev, keys, p1, want, rng) -> dict:
    """(c) a request in flight on replica 1 (a copy of thread 0's turn),
    then the eight threads: replica 0's step raises on its next three
    calls while its queue waits.  The breaker trips on the third, the
    queue migrates to replica 1, the in-flight request is untouched, the
    window (0.2 s) ends in probation, and fresh work routed there makes
    replica 0 healthy after three clean steps.  Every stream equals (a)'s;
    the quarantine-to-healthy wall time is recorded."""
    from kafka_tpu_torch.runtime import GenRequest

    router = _rep_router(cfg, params, dev, rng, quarantine_threshold=3,
                         quarantine_window_s=0.2)
    first = GenRequest(request_id="inflight", prompt_ids=list(p1[0]),
                       max_new_tokens=REP_NEW)
    router.engines[1].submit(first)
    router._route[first.request_id] = 1
    router.step()  # replica 0 is idle: replica 1 starts the request
    engine0 = router.engines[0]
    orig, left = engine0.step, [3]

    def failing_step():
        if left[0] > 0:
            left[0] -= 1
            raise RuntimeError("replica 0 device lost (injected)")
        return orig()

    engine0.step = failing_step
    reqs = [GenRequest(request_id=f"{k}-c", prompt_ids=list(p),
                       max_new_tokens=REP_NEW, prefix_key=k)
            for k, p in zip(keys, p1)]
    for r in reqs:
        router.submit(r)
    routes = [router._route[r.request_id] for r in reqs]
    trans = [("healthy", time.monotonic())]  # replica 0's transitions
    terminal = {}

    def drive():
        while router.has_work:
            try:
                events = router.step()
            except Exception:
                events = router.recover_from_failure()
            state = router.health[0].state
            if state != trans[-1][0]:
                trans.append((state, time.monotonic()))
            for ev in events:
                if ev.finished:
                    if ev.request_id in terminal:
                        raise AssertionError(f"(c) two terminal events "
                                             f"for {ev.request_id}")
                    terminal[ev.request_id] = ev.finish_reason

    drive()
    states_seen = [s for s, _ in trans]
    if states_seen[:2] != ["healthy", "quarantined"]:
        raise AssertionError(f"(c) replica 0 transitions {states_seen}")
    t_q = trans[1][1]
    while time.monotonic() - t_q < 0.25:
        time.sleep(0.01)  # the quarantine window ends
    fresh = [GenRequest(request_id=f"fresh{i}", prompt_ids=list(p1[i][:64]),
                        max_new_tokens=REP_NEW) for i in range(2)]
    for r in fresh:
        router.submit(r)
    fresh_routes = [router._route[r.request_id] for r in fresh]
    drive()
    sup = router.supervisor.snapshot()
    states = [h.state for h in router.health]
    states_seen = [s for s, _ in trans]
    if states_seen != ["healthy", "quarantined", "probation", "healthy"] \
            or states != ["healthy", "healthy"] or sup["quarantines"] != 1 or \
            sup["readmits"] != 1 or \
            sup["waiting_migrated"] != routes.count(0) or \
            0 not in fresh_routes:
        raise AssertionError(f"(c) states {states}, supervisor {sup}, "
                             f"routes {routes} / {fresh_routes}")
    done = [first] + reqs + fresh
    if any(terminal.get(r.request_id) != "length" for r in done):
        raise AssertionError(f"(c) terminal {terminal}")
    ties = _rep_streams_match([first] + reqs, [want[0]] + want, "(c)")
    problems = router.self_check()
    router.close()
    del router
    if problems:
        raise AssertionError(f"(c) self_check {problems}")
    return {"routes": routes, "fresh_routes": fresh_routes,
            "supervisor": sup, "near_ties": ties,
            "transitions": states_seen,
            "quarantine_to_probation_s": trans[2][1] - t_q,
            "quarantine_to_healthy_s": trans[3][1] - t_q,
            "streams_equal": all(a.output_ids == b.output_ids for a, b in
                                 zip([first] + reqs, [want[0]] + want))}


def replicas_background(cfg, params, rng) -> dict:
    """(e) a background tool-result turn (a 3k-token prompt) beside four
    interactive streams on one engine: it yields its chunks to their
    prefills (bg_yields > 0), shrinks them while they decode, and every
    stream equals the one an engine gives each turn alone (or parts at a
    bf16 near-tie: the background prefill's chunking differs)."""
    from kafka_tpu_torch.runtime import GenRequest, InferenceEngine

    eng = InferenceEngine(cfg, params, _rep_cfg())
    _warm_engine(eng, cfg.vocab_size, rng)
    inter = [rng.randint(0, cfg.vocab_size, size=600).tolist()
             for _ in range(4)]
    tool = rng.randint(0, cfg.vocab_size, size=REP_PROMPT).tolist()
    bg = GenRequest(request_id="bg", prompt_ids=tool, max_new_tokens=REP_NEW,
                    background=True)
    fg = [GenRequest(request_id=f"fg{i}", prompt_ids=p,
                     max_new_tokens=4 * REP_NEW) for i, p in enumerate(inter)]
    eng.submit(bg)
    for r in fg:
        eng.submit(r)
    eng.run_to_completion()
    counters = {k: getattr(eng, k) for k in ("bg_admitted", "bg_chunks",
                                               "bg_yields")}
    alone = InferenceEngine(cfg, params, _rep_cfg())
    _warm_engine(alone, cfg.vocab_size, rng)
    want = [alone.generate(r.prompt_ids, max_new_tokens=r.max_new_tokens)
            for r in [bg] + fg]
    ties = _rep_streams_match([bg] + fg, want, "(e)")
    if counters["bg_yields"] <= 0 or counters["bg_admitted"] != 1 or \
            eng.self_check():
        raise AssertionError(f"(e) background counters {counters}")
    eng.close()
    alone.close()
    del eng, alone
    return {**counters, "near_ties": ties,
            "streams_equal": all(a.output_ids == b.output_ids
                                 for a, b in zip([bg] + fg, want)),
            "bg_ttft_ms": _ttft_ms(bg),
            "fg_ttft_ms": [_ttft_ms(r) for r in fg]}


def _fleet_bytes(router) -> dict:
    """The tensors a router's fleet holds: the weights once (the replicas
    share them) and each replica's KV pool."""
    from kafka_tpu_torch.runtime.kv_tier import pool_leaves

    return {"weights": tensor_bytes(router.engines[0].params),
            "pools": [tensor_bytes(pool_leaves(e.k_pool)
                                   + pool_leaves(e.v_pool))
                      for e in router.engines]}


async def _serve_replicas(db_path: str) -> dict:
    """(d) the server from the environment (KAFKA_TORCH_DP_SIZE=2,
    KAFKA_TORCH_REPLICA_DEVICES=cuda:0,cuda:0, KAFKA_TORCH_AUTOSCALE=
    recommend): twelve streamed thread turns on 2 x 4 slots (four wait
    in a queue), POST /admin/resize {"dp": 1} while they stream, then
    {"dp": 2}; every stream ends with [DONE], live bytes after each
    rebuild stay within the card's plan, /admin/signals reports dp 2 and
    a per-pool section, and /admin/autoscaler has logged decisions."""
    import aiohttp
    import torch
    from aiohttp import web

    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    # the server's own live bytes: what the process holds beyond this
    gc.collect()
    torch.cuda.synchronize()
    live0 = allocator_split(torch.device("cuda", torch.cuda.current_device())
                            )["default_allocated"]
    env = {"KAFKA_TORCH_DP_SIZE": "2",
           "KAFKA_TORCH_REPLICA_DEVICES": "cuda:0,cuda:0",
           "KAFKA_TORCH_AUTOSCALE": "recommend",
           "KAFKA_TORCH_AUTOSCALE_INTERVAL_S": "0.2"}
    os.environ.update(env)
    try:
        cfg = ServingConfig.from_env(
            model_name="llama-3.2-1b", max_batch=4, page_size=16,
            num_pages=4 * 128 + 64, max_pages_per_seq=128,
            prefill_buckets=(64, 128, 256, 512, 1024, 2048),
            max_new_tokens_default=48, db_path=db_path, multi_step=16,
            system_prompt="You are a terse assistant.", api_token="tok")
        app = await create_app(cfg, tools=[], mcp_servers=[])
    finally:
        for k in env:
            del os.environ[k]
    llm = app[STATE_KEY]["llm"]
    router = llm.engine
    plan = router.memory_plan
    if len(router.engines) != 2 or plan is None:
        raise AssertionError(f"(d) dp {len(router.engines)}, plan {plan}")
    parks = []
    pause, resume = llm.worker.pause, llm.worker.resume
    t_park = [None]

    def timed_pause(*a, **kw):
        ok = pause(*a, **kw)
        t_park[0] = time.monotonic()
        return ok

    def timed_resume():
        if t_park[0] is not None:
            parks.append(time.monotonic() - t_park[0])
            t_park[0] = None
        resume()

    llm.worker.pause, llm.worker.resume = timed_pause, timed_resume
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    auth = {"Authorization": "Bearer tok"}
    out = {"resizes": [],
           "plan": {k: getattr(plan, k) for k in (
               "weight_bytes", "kv_pool_bytes", "activation_bytes",
               "grammar_table_bytes", "total_bytes")}}
    dev = router.device
    gc.collect()
    torch.cuda.synchronize()
    out["live_bytes_boot"] = allocator_split(dev)["default_allocated"] - live0
    out["tensor_bytes_boot"] = _fleet_bytes(router)
    try:
        async with aiohttp.ClientSession() as s:
            body = {"model": "llama-3.2-1b", "stream": True,
                    "temperature": 0, "max_tokens": 48,
                    "messages": [{"role": "user",
                                  "content": "Count to ten."}]}
            turns = [asyncio.ensure_future(_stream(
                s, f"{base}/v1/threads/rep-{i}/chat/completions", body,
                headers=auth)) for i in range(12)]
            # every turn reaches the engine before the resize gate closes
            for _ in range(400):
                if sum(e.metrics.requests_submitted
                       for e in router.engines) >= 12:
                    break
                await asyncio.sleep(0.05)
            for dp in (1, 2):
                parks.clear()
                old = [weakref.ref(e) for e in router.engines]
                t0 = time.monotonic()
                async with s.post(f"{base}/admin/resize", json={"dp": dp},
                                  headers=auth) as r:
                    status, res = r.status, await r.json()
                took = time.monotonic() - t0
                gc.collect()
                torch.cuda.synchronize()
                split = allocator_split(dev)
                alive = sum(r() is not None for r in old)
                out["resizes"].append({
                    "dp": dp, "status": status, "body": res,
                    # the last park holds the rebuild; the ones before
                    # it are the drain loop's checks
                    "post_s": took, "parked_s": parks[-1] if parks else 0.0,
                    "drain_checks": max(0, len(parks) - 1),
                    "drain_parked_s": sum(parks[:-1]),
                    "live_bytes": split["default_allocated"] - live0,
                    "graph_bytes": split["graph_allocated"],
                    "tensor_bytes": _fleet_bytes(router),
                    "old_engines_alive": alive,
                    "plan_bytes": plan.total_bytes})
                if status != 200 or len(router.engines) != dp or alive:
                    raise AssertionError(f"(d) resize to {dp}: {status} "
                                         f"{res}, {alive} old engines "
                                         "still alive")
                live = split["default_allocated"] - live0
                if live > plan.total_bytes * (1 + PLAN_MARGIN):
                    raise AssertionError(
                        f"(d) live bytes after resize to {dp}: {live} "
                        f"over the plan {plan.total_bytes} "
                        f"(+{PLAN_MARGIN:.0%})")
            events = await asyncio.gather(*turns)
            out["streams"] = len(events)
            out["queued_survived"] = sum(
                1 for ev in events if any(e.get("type") == "agent_done"
                                          for e in ev))
            async with s.post(f"{base}/v1/threads/rep-after/chat/"
                              "completions", json=body, headers=auth) as r:
                out["after_status"] = r.status
                await r.read()
            async with s.get(f"{base}/admin/signals", headers=auth) as r:
                sig = await r.json()
            async with s.get(f"{base}/admin/autoscaler", headers=auth) as r:
                scaler = await r.json()
            async with s.get(f"{base}/metrics?format=prometheus",
                             headers=auth) as r:
                prom = await r.text()
    finally:
        await runner.cleanup()
    out["signals"] = {k: sig.get(k) for k in ("version", "dp", "pools",
                                              "supervisor")}
    out["autoscaler"] = {"mode": scaler["mode"],
                         "decisions": len(scaler["decisions"]),
                         "polls": scaler["counters"]["autoscaler_polls"]}
    if sig["dp"] != 2 or not sig.get("pools") or sig["pools"][0][
            "replicas"] != [0, 1] or not sig.get("supervisor"):
        raise AssertionError(f"(d) signals {out['signals']}")
    if scaler["mode"] != "recommend" or not scaler["decisions"]:
        raise AssertionError(f"(d) autoscaler {out['autoscaler']}")
    if out["queued_survived"] != 12 or out["after_status"] != 200:
        raise AssertionError(f"(d) streams {out['queued_survived']}/12, "
                             f"after {out['after_status']}")
    check_prometheus(prom)
    return out


def phase_replicas(seed: int) -> None:
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params
    from kafka_tpu_torch.ops import kernels

    cfg = get_config("llama-3.2-1b")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    params = init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(seed + 6)
    keys = [f"rep-t{i}" for i in range(REP_THREADS)]
    p1 = [rng.randint(0, cfg.vocab_size, size=REP_PROMPT).tolist()
          for _ in keys]
    suffixes = [rng.randint(0, cfg.vocab_size, size=REP_SUFFIX).tolist()
                for _ in keys]
    out = {}
    # the phase's own path: counts from 0 here, read at its end
    kernels.reset_launch_counts()
    a = replicas_colocated(cfg, params, dev, keys, p1, suffixes, rng)
    out["colocated"] = {k: v for k, v in a.items()
                        if k not in ("t1", "t2", "p2")}
    log(f"replicas (a) colocated: routes {a['routes']} (split "
        f"{a['split'][0]}/{a['split'][1]}), turn 2 cached "
        f"{a['turn2_cached_tokens']}; streams equal a single engine's: "
        f"{a['streams_equal']} (near-ties {a['near_ties']})")
    b = replicas_disagg(cfg, params, dev, keys, p1, a["t1"], rng)
    out["disagg"] = b
    sh = b["ship"]
    log(f"replicas (b) disagg: {len(keys)} hand-offs, first lookups "
        f"shipped ({b['cached_tokens'][0]} tokens), rows byte-equal; "
        f"streams equal (a): {b['streams_equal']} (near-ties "
        f"{b['near_ties']}); device ship of a {sh['tokens']}-token run "
        f"({sh['bytes']} B): {sh['ms']:.3f} ms, {sh['gbps']:.2f} GB/s")
    c = replicas_supervision(cfg, params, dev, keys, p1, a["t1"], rng)
    out["supervision"] = c
    log(f"replicas (c) supervision: routes {c['routes']}, fresh "
        f"{c['fresh_routes']}; {c['supervisor']}; {c['transitions']}: "
        f"quarantine -> probation {c['quarantine_to_probation_s']:.3f} s, "
        f"-> healthy {c['quarantine_to_healthy_s']:.3f} s; streams equal (a): "
        f"{c['streams_equal']} (near-ties {c['near_ties']})")
    e = replicas_background(cfg, params, rng)
    out["background"] = e
    log(f"replicas (e) background: admitted {e['bg_admitted']}, chunks "
        f"{e['bg_chunks']}, yields {e['bg_yields']}; streams equal alone: "
        f"{e['streams_equal']} (near-ties {e['near_ties']}); TTFT bg "
        f"{e['bg_ttft_ms']:.1f} ms, interactive "
        f"{[round(x, 1) for x in e['fg_ttft_ms']]} ms")
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        d = asyncio.run(_serve_replicas(os.path.join(td, "rep.db")))
    out["server"] = d
    for r in d["resizes"]:
        log(f"replicas (d) boot: live {d['live_bytes_boot']} B, tensors "
            f"{d['tensor_bytes_boot']}, plan {d['plan']}") if r["dp"] == 1 \
            else None
        log(f"replicas (d) resize to dp {r['dp']}: {r['status']} "
            f"{r['body']}, POST {r['post_s']:.2f} s, worker parked "
            f"{r['parked_s']:.3f} s for the rebuild ({r['drain_checks']} "
            f"drain checks, {r['drain_parked_s']:.3f} s parked), live "
            f"{r['live_bytes']} B (+ graphs "
            f"{r['graph_bytes']} B; tensors {r['tensor_bytes']}) vs plan "
            f"{r['plan_bytes']} B")
    log(f"replicas (d) server: {d['queued_survived']}/{d['streams']} "
        f"streams ended, signals {d['signals']['dp']} replicas "
        f"{[p['role'] for p in d['signals']['pools']]}, autoscaler "
        f"{d['autoscaler']}")
    torch.cuda.empty_cache()
    launches = {"K1": kernels.paged_decode_attention.launches,
                "K2": kernels.paged_prefill_attention.launches,
                "K3": kernels.paged_verify_attention.launches,
                "K4": kernels.paged_decode_attention_int8.launches}
    out["launches"] = launches
    for k, n in launches.items():
        if k in RESULTS:
            RESULTS[k]["replicas_launches"] = n
    if not (launches["K1"] and launches["K2"]):
        raise AssertionError(f"replicas phase launches {launches}")
    log(f"replicas launches (counted from the phase's start, summed over "
        f"replicas): {launches}")
    RESULTS["replicas"] = out


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


# ---------------------------------------------------------------------------
# phase 7: tensor parallelism (per-rank kernels on any card count; the rank
# group's engine on tp cards)
# ---------------------------------------------------------------------------

# (label, model, tp, tq): the per-rank head layouts the kernel leg runs.
# llama-3.2-1b at tp 2 and 4 (D 64, G 4), a grouped split with one kv head
# per rank (degree 16 over 8 kv heads: tp 8 x tq 2, G 2), llama-3-8b at tp
# 2 and llama-3-70b at tp 4 (D 128, G 4 and 8: the kernels' limit)
TP_LAYOUTS = (
    ("llama-3.2-1b tp2", "llama-3.2-1b", 2, 1),
    ("llama-3.2-1b tp4", "llama-3.2-1b", 4, 1),
    ("llama-3.2-1b tp8 tq2", "llama-3.2-1b", 8, 2),
    ("llama-3-8b tp2", "llama-3-8b", 2, 1),
    ("llama-3-70b tp4", "llama-3-70b", 4, 1),
)
TP_LENS = [15, 16, 31, 255, 511, 700, 2046, 5]
TP_QLENS = [5, 1, 3, 5, 2, 4, 5, 1]
TP_KERNEL_KEYS = ("K1tp", "K3tp", "K4tp")
# the guard's deadline in the engine leg's rank groups
TP_GUARD_S = 60.0


def tp_kernel_leg(seed: int) -> dict:
    """Each layout's full q heads and pool on the card; then every rank's
    K1, K3 and K4 through the per-rank wrappers (ops/kernels/sharded.py)
    on its q-head block and pool column block, held to the plain version
    (KERNEL_ATOL / KERNEL_RTOL), and compared bit for bit with the
    full-head kernel's rows of the same heads.  Rank 0 of each layout is
    timed (k1_case / k3_case / k4_case at the per-rank shape, SDPA at that
    shape as the library call), and so is the per-rank wrapper itself."""
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.models.quant import quantize_array
    from kafka_tpu_torch.ops.kernels import (
        kernel_mesh_ok,
        paged_decode_attention,
        paged_decode_attention_int8,
        paged_decode_attention_int8_plain,
        paged_decode_attention_int8_sharded,
        paged_decode_attention_plain,
        paged_decode_attention_sharded,
        paged_verify_attention,
        paged_verify_attention_plain,
        paged_verify_attention_sharded,
    )
    from kafka_tpu_torch.parallel import MeshConfig, RankMesh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    ps, B, P, S = 16, 8, 128, 5
    C = P * ps
    bf16 = torch.bfloat16
    out = {k: {"layouts": []} for k in TP_KERNEL_KEYS}
    for label, name, tp, tq in TP_LAYOUTS:
        cfg = get_config(name)
        Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if not kernel_mesh_ok(MeshConfig(tp=tp, tq=tq), Hq, Hkv):
            raise AssertionError(f"{label}: the per-rank kernels refuse it")
        n, hq, hkv = tp * tq, Hq // (tp * tq), Hkv // tp
        num_pages = B * P + 1
        kp, vp = (torch.randn(num_pages * ps, Hkv * D, generator=gen,
                              device=dev).to(bf16) for _ in range(2))
        q = torch.randn(B, Hq, D, generator=gen, device=dev).to(bf16)
        qv = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(bf16)
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        table = perm.view(B, P).to(torch.int32).contiguous()
        seq = torch.tensor(TP_LENS, dtype=torch.int32, device=dev)
        seqv = seq.clamp(max=C - S - 1)
        ql = torch.tensor(TP_QLENS, dtype=torch.int32, device=dev)
        # whole-row per-slot scales, the same on every rank
        kq, vq = quantize_array(kp, (-1,)), quantize_array(vp, (-1,))
        full = {
            "K1tp": paged_decode_attention(q, kp, vp, table, seq,
                                           page_size=ps),
            "K3tp": paged_verify_attention(qv, kp, vp, table, seqv, ql,
                                           page_size=ps),
            "K4tp": paged_decode_attention_int8(q, kq.q, kq.s, vq.q, vq.s,
                                                table, seq, page_size=ps),
        }
        live = [(b, j) for b in range(B) for j in range(int(ql[b]))]
        bi, ji = (torch.tensor(x, device=dev) for x in zip(*live))
        rows = {k: {"label": label, "ranks": n, "q_heads": hq,
                    "kv_heads": hkv, "head_dim": D, "max_abs_err": 0.0,
                    "bit_equal_ranks": 0} for k in TP_KERNEL_KEYS}
        rank0 = {}
        for r in range(n):
            mesh = RankMesh(tp, tq, r, dev)
            qs = slice(r * hq, (r + 1) * hq)
            cs = slice((r // tq) * hkv * D, (r // tq + 1) * hkv * D)
            lk, lv = kp[:, cs].contiguous(), vp[:, cs].contiguous()
            lkq, lvq = kq.q[:, cs].contiguous(), vq.q[:, cs].contiguous()
            a1 = (q[:, qs].contiguous(), lk, lv, table, seq)
            a3 = (qv[:, :, qs].contiguous(), lk, lv, table, seqv, ql)
            a4 = (q[:, qs].contiguous(), lkq, kq.s, lvq, vq.s, table, seq)
            got = {
                "K1tp": paged_decode_attention_sharded(mesh, *a1,
                                                       page_size=ps),
                "K3tp": paged_verify_attention_sharded(mesh, *a3,
                                                       page_size=ps),
                "K4tp": paged_decode_attention_int8_sharded(mesh, *a4,
                                                            page_size=ps),
            }
            want = {
                "K1tp": paged_decode_attention_plain(*a1, page_size=ps),
                "K3tp": paged_verify_attention_plain(*a3, page_size=ps),
                "K4tp": paged_decode_attention_int8_plain(*a4, page_size=ps),
            }
            torch.cuda.synchronize()
            for k in TP_KERNEL_KEYS:
                g, w, f = got[k], want[k], full[k]
                if k == "K3tp":  # live rows only (j < q_len)
                    g, w, f = g[bi, ji], w[bi, ji], f[:, :, qs][bi, ji]
                else:
                    f = f[:, qs]
                err = check_close(f"{k} {label} rank {r}", g, w)
                rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err)
                rows[k]["bit_equal_ranks"] += bool(torch.equal(g, f))
            if r == 0:
                rank0 = {"mesh": mesh, "a1": a1, "a3": a3, "a4": a4}
        # rank 0 timed: the kernel at the per-rank shape beside its plain
        # version, its bound and SDPA, and the per-rank wrapper's own call
        mesh = rank0["mesh"]
        timed = {
            "K1tp": (k1_case(f"{label} rank 0", rank0["a1"], ps),
                     lambda: paged_decode_attention_sharded(
                         mesh, *rank0["a1"], page_size=ps)),
            "K3tp": (k3_case(f"{label} rank 0", rank0["a3"], ps),
                     lambda: paged_verify_attention_sharded(
                         mesh, *rank0["a3"], page_size=ps)),
            "K4tp": (k4_case(f"{label} rank 0", rank0["a4"], ps),
                     lambda: paged_decode_attention_int8_sharded(
                         mesh, *rank0["a4"], page_size=ps)),
        }
        for k, (case, wrapper) in timed.items():
            case["wrapper_ms"] = time_ms(wrapper)
            rows[k].update({f: case.get(f) for f in (
                "shape", "wrapper_ms", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_device_ms")})
            out[k]["layouts"].append(rows[k])
            log(f"{k} {label}: {n} ranks x ({hq} q heads over {hkv} kv "
                f"heads, D {D}): max_abs_err {rows[k]['max_abs_err']:.3e}, "
                f"{rows[k]['bit_equal_ranks']}/{n} ranks bit-equal to the "
                f"full-head kernel; rank 0 wrapper {case['wrapper_ms']:.4f} "
                f"ms, plain {case['plain_ms']:.4f}, bound "
                f"{case['bound_ms']:.5f} by {case['bound_by']}, SDPA "
                f"{case['library_ms']:.4f}")
        del kp, vp, kq, vq, full
        torch.cuda.empty_cache()
    return out


def _nccl_probe_rank(path: str, rank: int, queue) -> None:
    """One rank of the two-ranks-on-one-card probe (a spawned process)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        store = dist.FileStore(path, 2)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timedelta(seconds=60)
        group = dist.ProcessGroupNCCL(store, rank, 2, opts)
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        queue.put((rank, "ok", float(t.item())))
        group.shutdown()
    except Exception as e:  # the refusal is the result
        queue.put((rank, "error", f"{type(e).__name__}: {e}"))


def nccl_one_card_probe(timeout_s: float = 120.0) -> dict:
    """Two NCCL ranks on one card, as a rank group would place them with
    one card visible: NCCL's answer, quoted (it refuses a duplicate GPU)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "store")
        procs = [ctx.Process(target=_nccl_probe_rank, args=(path, r, queue),
                             daemon=True) for r in (0, 1)]
        for p in procs:
            p.start()
        answers = []
        deadline = time.monotonic() + timeout_s
        while len(answers) < 2 and time.monotonic() < deadline:
            try:
                answers.append(queue.get(timeout=1.0))
            except Exception:
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    res = {"answers": sorted(answers),
           "refused": any(a[1] == "error" for a in answers),
           "timed_out": len(answers) < 2}
    log(f"tp: two NCCL ranks on one card: {res}")
    return res


def _tp_prompts(cfg, seed: int, lens):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def _rank_launches(eng, name: str) -> list:
    return [r[name] for r in eng.rank_query("rank_launches")]


def tp_nccl_profile(eng, cfg, rng, steps: int = 4) -> dict:
    """Device time of the NCCL kernels inside rank 0's decode graph
    replays, 8 lanes at ~256 tokens over a few fused steps: per step and
    per layer (two all-reduces a layer; a tied head adds no gather)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kafka_tpu_torch.runtime import GenRequest

    reqs = [GenRequest(request_id=f"nccl{i}", max_new_tokens=200,
                       prompt_ids=rng.randint(0, cfg.vocab_size,
                                              size=256).tolist())
            for i in range(8)]
    for r in reqs:
        eng.submit(r)
    while any(r.state != "active" for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    n0 = eng.graph_replays
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    replays = eng.graph_replays - n0
    for r in reqs:
        eng.cancel(r.request_id)
    while eng.has_work:
        eng.step()
    rows = [(e.key, e.count, getattr(e, "device_time_total",
                                      getattr(e, "cuda_time_total", 0)))
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(t for _, _, t in rows) / 1e3
    nccl = [(k, c, t / 1e3) for k, c, t in rows if "nccl" in k.lower()]
    nccl_ms = sum(t for _, _, t in nccl)
    k = eng.ecfg.multi_step
    out = {"replays": replays, "steps": replays * k, "device_ms": total,
           "nccl_ms": nccl_ms, "nccl_kernels": [(n[:60], c) for n, c, _
                                                in nccl]}
    if replays and nccl:
        out["nccl_ms_per_step"] = nccl_ms / (replays * k)
        out["nccl_ms_per_layer"] = out["nccl_ms_per_step"] / cfg.num_layers
        out["nccl_share"] = nccl_ms / total if total else None
    log(f"  NCCL in rank 0's decode replays: {out}")
    return out


def tp_engine_leg_1b(seed: int) -> dict:
    """(a) and (b): llama-3.2-1b at full width, bf16, tp 2, 8 lanes at a
    2048-token window, over NCCL with decode graphs; then int8 weights +
    int8 KV (K4 per rank) and speculative_k 4 with forced proposals (K3
    per rank) on the same group."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.parallel import (MeshConfig, RandomWeights,
                                          RankGroup, init_params_shard)
    from kafka_tpu_torch.runtime import InferenceEngine

    cfg = get_config("llama-3.2-1b")
    prompts = _tp_prompts(cfg, seed, [700, 40, 50, 90, 200, 300, 450, 600])
    max_new = 24
    total = max_new * len(prompts)
    res = {}
    t0 = time.monotonic()
    group = RankGroup(MeshConfig(tp=2), timeout_s=TP_GUARD_S)
    res["group_start_s"] = time.monotonic() - t0
    log(f"tp (a): rank group of 2 (NCCL) up in {res['group_start_s']:.1f}s")
    try:
        t0 = time.monotonic()
        eng = InferenceEngine(cfg, RandomWeights(seed=seed), _engine_cfg(),
                              mesh=group)
        res["engine_build_s"] = time.monotonic() - t0
        eng.rank_query("rank_reset_launches")
        t0 = time.monotonic()
        got = _drive(eng, prompts, max_new)
        res["drive_s"] = time.monotonic() - t0
        k1 = _rank_launches(eng, "paged_decode_attention_sharded")
        res["launches_k1"] = k1
        if min(k1) == 0:
            raise AssertionError(f"tp (a): a rank launched no K1: {k1}")
        clock = ReplayClock(eng)
        res["profile"] = graph_profile(eng, clock, cfg,
                                       np.random.RandomState(seed + 1))
        res["nccl"] = tp_nccl_profile(eng, cfg,
                                      np.random.RandomState(seed + 2))
        res["memory"] = eng.rank_query("rank_memory")
        eng.close()
        del eng, clock
        gc.collect()
        plain = InferenceEngine(cfg, RandomWeights(seed=seed),
                                _engine_cfg(attention_backend="plain"),
                                mesh=group)
        ref_plain = _drive(plain, prompts, max_new)
        plain.close()
        del plain
        same, agree, worst = _compare_streams(cfg, got, ref_plain, max_new)
        res["vs_plain_tp2"] = {"identical_streams": same,
                               "token_agreement": [agree, total],
                               "logits_rel_err": worst}
        log(f"tp (a): tp-2 kernel engine vs tp-2 plain engine: {same}/8 "
            f"identical, agreement {agree}/{total}, worst logits "
            f"{worst:.4f} (tol {LOGITS_RTOL}); K1 launches per rank {k1}")
        if not worst <= LOGITS_RTOL:
            raise AssertionError(f"tp (a) logits vs plain: {worst}")
        # (b) int8 weights + int8 KV, then speculation
        eng = InferenceEngine(cfg, RandomWeights(seed=seed, quantize="int8"),
                              _engine_cfg(kv_quantize="int8"), mesh=group)
        eng.rank_query("rank_reset_launches")
        igot = _drive(eng, prompts, max_new)
        k4 = _rank_launches(eng, "paged_decode_attention_int8_sharded")
        eng.close()
        del eng
        plain = InferenceEngine(cfg, RandomWeights(seed=seed, quantize="int8"),
                                _engine_cfg(kv_quantize="int8",
                                            attention_backend="plain"),
                                mesh=group)
        iref = _drive(plain, prompts, max_new)
        plain.close()
        del plain
        i_same, i_agree, i_worst = _compare_streams(cfg, igot, iref, max_new)
        res["int8"] = {"launches_k4": k4, "identical_streams": i_same,
                       "token_agreement": [i_agree, total],
                       "logits_rel_err": i_worst}
        log(f"tp (b): int8 weights + int8 KV at tp 2: K4 launches per rank "
            f"{k4}; vs the plain int8 tp-2 engine {i_same}/8 identical, "
            f"worst logits {i_worst:.4f}")
        if min(k4) == 0 or not i_worst <= LOGITS_RTOL:
            raise AssertionError(f"tp (b) int8: {res['int8']}")
        spec = InferenceEngine(cfg, RandomWeights(seed=seed),
                               _engine_cfg(speculative_k=4, fetch_lag=0),
                               mesh=group)
        spec.rank_query("rank_reset_launches")
        sgot = _drive(spec, prompts, max_new,
                      streams=[r.output_ids for r in got])
        k3 = _rank_launches(spec, "paged_verify_attention_sharded")
        s_same, s_agree, s_worst = _compare_streams(cfg, sgot, got, max_new)
        res["speculative"] = {
            "launches_k3": k3, "verify_steps": spec.verify_steps,
            "proposed": spec.speculation_proposed_tokens,
            "accepted": spec.speculation_accepted_tokens,
            "identical_streams": s_same, "token_agreement": [s_agree, total],
            "logits_rel_err": s_worst}
        spec.close()
        del spec
        log(f"tp (b): speculative_k 4 at tp 2: {res['speculative']}")
        if min(k3) == 0 or not res["speculative"]["accepted"] or \
                not s_worst <= LOGITS_RTOL:
            raise AssertionError(f"tp (b) speculation: {res['speculative']}")
    finally:
        group.close()
    # the single-card engine on the same weights
    torch.cuda.empty_cache()
    single = InferenceEngine(cfg, init_params_shard(cfg, seed, None,
                                                    device="cuda:0"),
                             _engine_cfg())
    ref = _drive(single, prompts, max_new)
    single.close()
    del single
    gc.collect()
    torch.cuda.empty_cache()
    same, agree, worst = _compare_streams(cfg, got, ref, max_new)
    ties = _near_ties(got, ref, max_new)
    res["vs_single_card"] = {"identical_streams": same,
                             "token_agreement": [agree, total],
                             "logits_rel_err": worst, "near_ties": ties}
    log(f"tp (a): tp-2 engine vs the single-card engine: {same}/8 "
        f"identical greedy streams, agreement {agree}/{total}, worst logits "
        f"{worst:.4f}, partings {ties} (each inside the flip bound)")
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"tp (a) vs single card: {worst}")
    return res


def tp_engine_leg_70b(seed: int) -> dict:
    """(c) llama-3-70b at tp 4: the kernel engine against a plain-attention
    engine on the same group and weights (each rank draws its ~37 GB
    shard on its own card), every rank's bytes against the planner's
    per-rank plan, then a streamed thread turn through the port's server
    built from KAFKA_TORCH_TP_SIZE=4."""
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.parallel import MeshConfig, RandomWeights, RankGroup
    from kafka_tpu_torch.runtime import InferenceEngine
    from kafka_tpu_torch.runtime.planner import hbm_for_device, plan_memory

    cfg = get_config("llama-3-70b")
    prompts = _tp_prompts(cfg, seed + 2, [300, 40, 50, 90, 200, 120, 64, 30])
    max_new = 8
    res = {}
    t0 = time.monotonic()
    group = RankGroup(MeshConfig(tp=4), timeout_s=300)
    log(f"tp (c): rank group of 4 up in {time.monotonic() - t0:.1f}s")
    try:
        t0 = time.monotonic()
        eng = InferenceEngine(cfg, RandomWeights(seed=seed), _engine_cfg(),
                              mesh=group)
        res["engine_build_s"] = time.monotonic() - t0
        log(f"tp (c): llama-3-70b tp 4 engine built in "
            f"{res['engine_build_s']:.1f}s")
        eng.rank_query("rank_reset_launches")
        t0 = time.monotonic()
        got = _drive(eng, prompts, max_new)
        res["drive_s"] = time.monotonic() - t0
        res["launches_k1"] = _rank_launches(eng,
                                            "paged_decode_attention_sharded")
        mem = eng.rank_query("rank_memory")
        ecfg = eng.ecfg
        plan = plan_memory(cfg, hbm_bytes=hbm_for_device("cuda:0"), tp=4,
                           num_pages=ecfg.num_pages, page_size=ecfg.page_size,
                           max_pages_per_seq=ecfg.max_pages_per_seq,
                           max_batch=ecfg.max_batch,
                           prefill_bucket=max(ecfg.prefill_buckets))
        res["memory"] = mem
        res["plan"] = {"weight_bytes": plan.weight_bytes,
                       "kv_pool_bytes": plan.kv_pool_bytes,
                       "activation_bytes": plan.activation_bytes,
                       "total_bytes": plan.total_bytes}
        log(f"tp (c): per-rank bytes {mem} against the plan {res['plan']}")
        for m in mem:
            if abs(m["weights"] - plan.weight_bytes) > 0.01 * \
                    plan.weight_bytes or m["kv_pool"] != plan.kv_pool_bytes:
                raise AssertionError(f"tp (c): rank bytes {m} vs plan "
                                     f"{res['plan']}")
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        plain = InferenceEngine(cfg, RandomWeights(seed=seed),
                                _engine_cfg(attention_backend="plain"),
                                mesh=group)
        ref = _drive(plain, prompts, max_new)
        plain.close()
        del plain
        same, agree, worst = _compare_streams(cfg, got, ref, max_new)
        res["vs_plain_tp4"] = {"identical_streams": same,
                               "token_agreement": [agree, max_new * 8],
                               "logits_rel_err": worst}
        log(f"tp (c): 70B kernel engine vs plain engine at tp 4: {same}/8 "
            f"identical, worst logits {worst:.4f}; K1 launches per rank "
            f"{res['launches_k1']}")
        if min(res["launches_k1"]) == 0 or not worst <= LOGITS_RTOL:
            raise AssertionError(f"tp (c): {res}")
    finally:
        group.close()
    gc.collect()
    torch.cuda.empty_cache()
    res["server"] = asyncio.run(_serve_tp(
        "llama-3-70b", 4, "Summarise tensor parallelism in one line."))
    if res["server"]["left_running"]:
        raise AssertionError(f"tp (c): ranks left running after the "
                             f"server's shutdown: {res['server']}")
    return res


async def _serve_tp(model: str, tp: int, content: str,
                    kill_after: int = 0, ep: int = 1) -> dict:
    """A server from the environment (KAFKA_TORCH_TP_SIZE=tp, and
    KAFKA_TORCH_EP_SIZE=ep when ep > 1) on a free port: one streamed
    thread turn, /health; with kill_after > 0 rank 1 is killed once that
    many content events have arrived, and the stream must carry an error
    event and end, /health must answer 503, and the shutdown must leave
    no rank behind."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    os.environ["KAFKA_TORCH_TP_SIZE"] = str(tp)
    if ep > 1:
        os.environ["KAFKA_TORCH_EP_SIZE"] = str(ep)
    try:
        with tempfile.TemporaryDirectory() as td:
            cfg = ServingConfig.from_env(
                model_name=model, max_batch=8, page_size=16, num_pages=600,
                max_pages_per_seq=128, prefill_buckets=(64, 128, 256, 512),
                max_new_tokens_default=16, db_path=os.path.join(td, "t.db"),
                system_prompt="You are terse.", warmup=False)
            t0 = time.monotonic()
            app = await create_app(cfg, tools=[], mcp_servers=[])
            out = {"build_s": time.monotonic() - t0}
            engine = app[STATE_KEY]["llm"].engine
            pids = engine._group.pids
            port = _free_port()
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            base = f"http://127.0.0.1:{port}"
            body = {"model": model, "stream": True, "temperature": 0,
                    "max_tokens": 400 if kill_after else 16,
                    "messages": [{"role": "user", "content": content}]}
            try:
                async with aiohttp.ClientSession() as s:
                    if not kill_after:
                        timing: dict = {}
                        ev = await _stream(
                            s, f"{base}/v1/threads/tp/chat/completions",
                            body, timing)
                        out["usage"] = _usage(ev)
                        out["ttft_s"] = timing.get("ttft_s")
                        async with s.get(f"{base}/health") as r:
                            out["health"] = await r.json()
                    else:
                        out.update(await _stream_and_kill(
                            s, base, body, pids[0], kill_after))
                        async with s.get(f"{base}/health") as r:
                            out["health_status"] = r.status
                            out["health"] = await r.json()
                        # what the stream and /health showed, before the
                        # shutdown (a line the parent reads if it hangs)
                        print(json.dumps({"partial": out}, default=str),
                              flush=True)
            finally:
                t0 = time.monotonic()
                await runner.cleanup()
                out["shutdown_s"] = time.monotonic() - t0
            out["left_running"] = [p for p in pids if _pid_alive(p)]
    finally:
        os.environ.pop("KAFKA_TORCH_TP_SIZE", None)
        os.environ.pop("KAFKA_TORCH_EP_SIZE", None)
    log(f"tp server {model} tp {tp} ep {ep}"
        f"{' (kill)' if kill_after else ''}: {out}")
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


async def _stream_and_kill(s, base: str, body: dict, pid: int,
                           after: int, quiet_s: float = 90.0) -> dict:
    """Stream a long turn; SIGKILL `pid` after `after` content events;
    return when the stream ends (or stays silent for `quiet_s` after the
    kill): the error event and the seconds from the kill to it."""
    import signal

    events = []
    t_kill = t_err = None
    silent = False
    async with s.post(f"{base}/v1/threads/kill/chat/completions",
                      json=body) as resp:
        while True:
            try:
                raw = await asyncio.wait_for(resp.content.readline(),
                                             quiet_s if t_kill else 600)
            except asyncio.TimeoutError:
                silent = True
                log(f"tp (d): no event for {quiet_s}s after the kill")
                break
            if not raw:
                break
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            events.append(line[len("data: "):])
            if t_kill is None and sum('"content"' in e for e in events) \
                    >= after:
                os.kill(pid, signal.SIGKILL)
                t_kill = time.monotonic()
                log(f"tp (d): rank 1 (pid {pid}) killed after "
                    f"{len(events)} events")
            if t_err is None and t_kill is not None and '"error"' in line:
                t_err = time.monotonic()
                log(f"tp (d): error event {t_err - t_kill:.3f}s after the "
                    f"kill: {line[:300]}")
    errors = [e for e in events if '"error"' in e]
    return {"events": len(events), "done": bool(events) and
            events[-1] == "[DONE]", "error_events": errors[:2],
            "silent_after_kill": silent,
            "kill_to_error_s": (t_err - t_kill) if t_err and t_kill
            else None}


def tp_kill_leg() -> dict:
    """(d), in a child process of its own (its NCCL state is poisoned by
    design): a tp-2 llama-3.2-1b server, rank 1 killed mid-decode.  The
    child's output goes to chiprun_out/tp_kill.log as it runs."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "chiprun_out", "tp_kill.log")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--tp-kill"]
    t0 = time.monotonic()
    with open(path, "w") as f:
        try:
            proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                  timeout=300)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = None
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    res = json.loads(lines[-1]) if lines else {"ok": False}
    if "partial" in res:
        res = {"ok": False, "why": "the shutdown hung", **res["partial"]}
    res["child_rc"] = rc
    res["child_s"] = time.monotonic() - t0
    if rc != 0:
        res["tail"] = text[-3000:]
    return res


def tp_kill_child() -> int:
    """The --tp-kill child: print one JSON line with what (d) saw."""
    os.environ["KAFKA_TORCH_DIST_STEP_TIMEOUT_S"] = "30"
    out = asyncio.run(_serve_tp("llama-3.2-1b", 2,
                                "Count slowly from one to four hundred.",
                                kill_after=8))
    out["ok"] = bool(
        out["done"] and out["error_events"] and out["health_status"] == 503
        and out["health"]["status"] == "unhealthy" and not out["left_running"]
        and out["kill_to_error_s"] is not None
        and out["kill_to_error_s"] < 30)
    print(json.dumps(out, default=str), flush=True)
    # its ranks are stopped (left_running); skip the interpreter's
    # teardown of a CUDA context whose NCCL peer died by design
    os._exit(0)


def phase_tp(seed: int) -> None:
    """Phase 7: tensor parallelism.  The per-rank kernel leg runs on any
    card count.  The engine leg needs a card per rank: with fewer than 2
    visible it does not run (and is never counted as passed); NCCL's
    refusal of two ranks on one card is probed and quoted instead.  Each
    engine leg runs even when one before it failed; the phase fails after
    the last, with its record in chiprun_out/tp_phase.json."""
    import traceback

    import torch

    res = {"kernels": tp_kernel_leg(seed)}
    cards = torch.cuda.device_count()
    res["cards"] = cards
    launches = {k: 0 for k in TP_KERNEL_KEYS}
    failed = []

    def leg(key, fn, *args):
        try:
            res["engine_leg"][key] = fn(*args)
        except Exception as e:
            log(f"tp leg {key} FAILED:\n{traceback.format_exc()}")
            res["engine_leg"][key] = {"failed": f"{type(e).__name__}: {e}"}
            failed.append(key)

    if cards < 2:
        log(f"tp engine leg: needs 2 cards (one per rank), {cards} visible: "
            "NOT RUN (not counted as passed)")
        res["engine_leg"] = "not run: needs 2 cards"
        res["one_card_nccl"] = nccl_one_card_probe()
    else:
        res["engine_leg"] = {}
        leg("1b", tp_engine_leg_1b, seed)
        if cards >= 4:
            leg("70b", tp_engine_leg_70b, seed)
        else:
            log(f"tp (c): llama-3-70b needs 4 cards, {cards} visible: NOT RUN")
            res["engine_leg"]["70b"] = "not run: needs 4 cards"
        kill = tp_kill_leg()
        res["engine_leg"]["kill"] = kill
        log(f"tp (d): rank 1 killed mid-decode: {kill}")
        if not kill.get("ok"):
            failed.append("kill")
        one = res["engine_leg"]["1b"]
        if "failed" not in one:
            launches["K1tp"] = sum(one["launches_k1"])
            launches["K4tp"] = sum(one["int8"]["launches_k4"])
            launches["K3tp"] = sum(one["speculative"]["launches_k3"])
        big = res["engine_leg"]["70b"]
        if isinstance(big, dict) and "launches_k1" in big:
            launches["K1tp"] += sum(big["launches_k1"])
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "tp_phase.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    if failed:
        raise AssertionError(f"tp phase: legs {failed} failed")
    RESULTS["tp"] = res
    names = {"K1tp": ("paged_decode_attention_sharded", "paged_decode.cu",
                      "kafka_tpu/ops/pallas/paged_attention.py:521"),
             "K3tp": ("paged_verify_attention_sharded", "paged_verify.cu",
                      "kafka_tpu/ops/pallas/paged_attention.py:461"),
             "K4tp": ("paged_decode_attention_int8_sharded",
                      "paged_decode_int8.cu",
                      "kafka_tpu/ops/pallas/paged_attention.py:777")}
    for k, (name, src, replaces) in names.items():
        layouts = res["kernels"][k]["layouts"]
        head = layouts[-1]  # llama-3-70b at tp 4: the rank the server runs
        RESULTS[k] = {
            "name": name, "route": "cuda",
            "source": f"kafka_tpu_torch/csrc/{src}",
            "wrapper": "kafka_tpu_torch/ops/kernels/sharded.py",
            "replaces": replaces,
            # the engine leg's launches over every rank (0: not run)
            "launches": launches[k],
            "launch_count_basis": ("the tp engine leg, every rank"
                                   if cards >= 2 else
                                   "the tp engine leg did not run (1 card)"),
            "max_abs_err": max(c["max_abs_err"] for c in layouts),
            "ms": head["wrapper_ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            "cases": layouts,
        }


# ---------------------------------------------------------------------------
# phase 8: Mixtral-class MoE
# ---------------------------------------------------------------------------

MOE_PAGES = 256              # a 4096-token window at page 16
MOE_PROMPT = 3000            # a cold agent turn's prompt
MOE_NEW = 16
MOE_EP_LAYERS = 4            # leg (d)'s depth: bf16 at full width


def _moe_cfg(**kw):
    """The Mixtral engines: 8 lanes, page 16, a 4096-token window, prefill
    chunks up to 2048, decode graphs at the default multi_step (16), the
    kernels unless a caller asks for "plain" or "auto"."""
    from kafka_tpu_torch.runtime import EngineConfig

    kw.setdefault("attention_backend", "kernel")
    kw.setdefault("num_pages", 8 * MOE_PAGES + 1)
    return EngineConfig(max_batch=8, page_size=16,
                        max_pages_per_seq=MOE_PAGES,
                        prefill_buckets=(64, 256, 512, 1024, 2048),
                        keep_logits=True, **kw)


def _moe_launches() -> dict:
    from kafka_tpu_torch.ops import kernels

    return {f.__name__: f.launches for f in kernels.KERNELS}


def _moe_compare(label, cfg, got, ref, max_new: int) -> dict:
    """Greedy streams of two engines on one parameter tree: logits within
    LOGITS_RTOL up to each first parting, and every parting a near-tie
    inside the flip bound."""
    same, agree, worst = _compare_streams(cfg, got, ref, max_new)
    ties = _near_ties(got, ref, max_new)
    out = {"identical_streams": same, "streams": len(got),
           "token_agreement": [agree, max_new * len(got)],
           "logits_rel_err": worst, "near_ties": ties}
    log(f"moe {label}: {same}/{len(got)} identical greedy streams, token "
        f"agreement {agree}/{max_new * len(got)}, worst logits "
        f"max|d|/max|ref| = {worst:.4f} (tol {LOGITS_RTOL}), partings "
        f"{[(t['position'], round(t['margin'], 4)) for t in ties]}")
    if not worst <= LOGITS_RTOL:
        raise AssertionError(f"moe {label}: logits disagree: {worst}")
    return out


class RoutingTrace:
    """Records every MoE layer's router logits (f32 [T, E]) while active,
    by wrapping models/llama.py's _routing_weights (called by name from
    _moe_block, eagerly in prefill)."""

    def __init__(self):
        from kafka_tpu_torch.models import llama

        self.llama = llama
        self.real = llama._routing_weights
        self.calls = []
        self.active = False
        llama._routing_weights = self

    def __call__(self, t, router, top_k):
        if self.active:
            self.calls.append(
                self.llama._matmul_f32(t, router).float().cpu())
        return self.real(t, router, top_k)

    def restore(self):
        self.llama._routing_weights = self.real


def routing_trace(eng, prompt) -> list:
    """The router logits of every layer for one prompt's prefill (a
    request of one token, so only the prefill's chunks run the model)."""
    from kafka_tpu_torch.runtime import GenRequest

    tr = RoutingTrace()
    try:
        tr.active = True
        eng.submit(GenRequest(request_id="moe-route", prompt_ids=prompt,
                              max_new_tokens=1))
        eng.run_to_completion()
    finally:
        tr.restore()
    # one chunk per layer (the prompt fits the largest bucket); the rows
    # past the prompt are the bucket's padding
    if len(tr.calls) != eng.cfg.num_layers:
        raise AssertionError(f"routing trace: {len(tr.calls)} calls for "
                             f"{eng.cfg.num_layers} layers")
    return [c[:len(prompt)] for c in tr.calls]


def routing_flips(cfg, got: list, ref: list) -> dict:
    """Where two engines' top-k expert choices for the same prompt first
    differ.  Each such token must be a router near-tie: the reference's
    margin between its k-th and (k+1)-th logit at most twice the two
    runs' largest router-logit difference for that token (a flip needs
    the perturbation to close the gap).  Tokens routed alike everywhere
    give no layer."""
    import torch

    k = cfg.num_experts_per_tok
    out = {"layers": len(ref), "first_layer": None, "tokens": 0,
           "flips": []}
    if k >= cfg.num_experts:
        return out
    for layer, (a, b) in enumerate(zip(got, ref)):
        ia = torch.sort(a, dim=-1, descending=True, stable=True)[1][:, :k]
        vb, ib = torch.sort(b, dim=-1, descending=True, stable=True)
        diff = (ia.sort(-1)[0] != ib[:, :k].sort(-1)[0]).any(-1)
        if not diff.any():
            continue
        tokens = diff.nonzero().flatten().tolist()
        out.update(first_layer=layer, tokens=len(tokens))
        for t in tokens[:8]:
            flip = {"token": t,
                    "margin": (vb[t, k - 1] - vb[t, k]).item(),
                    "max_abs_dlogit": (a[t] - b[t]).abs().max().item()}
            if not flip["margin"] <= 2 * flip["max_abs_dlogit"]:
                raise AssertionError(f"routing parts outside the flip "
                                     f"bound at layer {layer}: {flip}")
            out["flips"].append(flip)
        break
    return out


def moe_prefill(eng, cfg, rng, n: int) -> dict:
    """A cold ~n-token prompt's prefill to its first token on the host
    clock (the second of two prompts of that size: the first warms the
    GEMM heuristics), then a third under the profiler: device time by
    kernel, K2's and the GEMMs' shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kafka_tpu_torch.runtime import GenRequest

    def one(tag):
        req = GenRequest(request_id=f"moe-prefill-{tag}", max_new_tokens=1,
                         prompt_ids=rng.randint(0, cfg.vocab_size,
                                                size=n).tolist())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(req)
        eng.run_to_completion()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    one("warm")
    ms = one("timed")
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        one("profiled")
    rows = [(e.key, e.count, getattr(e, "device_time_total",
                                      getattr(e, "cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    total = sum(t for _, _, t in rows)
    k2 = sum(t for k, _, t in rows if "flash_prefill" in k)
    gemm = sum(t for k, _, t in rows if any(
        g in k.lower() for g in ("gemm", "cutlass", "xmma", "nvjet")))
    top = sorted(rows, key=lambda r: -r[2])[:8]
    out = {"tokens": n, "host_ms": ms, "device_ms": total, "k2_ms": k2,
           "k2_share": k2 / total if total else None, "gemm_ms": gemm,
           "gemm_share": gemm / total if total else None,
           "top_kernels": [(k[:70], c, round(t, 3)) for k, c, t in top]}
    log(f"moe prefill of {n} tokens: {ms:.1f} ms host clock; device "
        f"{total:.1f} ms, K2 {k2:.2f} ms ({out['k2_share']}), GEMMs "
        f"{gemm:.1f} ms ({out['gemm_share']}); top {out['top_kernels']}")
    return out


def moe_one_card(seed: int) -> dict:
    """(a) and (b): mixtral-8x7b at full width with int8 weights (drawn
    one expert at a time on the card and quantized as drawn: the bf16
    model, ~93 GB, never exists), held against a plain-attention engine
    on the same parameter tree, bf16 KV (K2, K1) then int8 KV (K4)."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.models.quant import QTensor, param_bytes
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.parallel import init_params_shard
    from kafka_tpu_torch.runtime import InferenceEngine
    from kafka_tpu_torch.runtime.planner import hbm_for_device, plan_memory

    cfg = get_config("mixtral-8x7b")
    if (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_experts, cfg.head_dim, cfg.num_heads,
            cfg.num_kv_heads) != (4096, 14336, 32, 8, 128, 32, 8):
        raise AssertionError(f"not the published mixtral-8x7b: {cfg}")
    res = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params_shard(cfg, seed, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    res["draw_s"] = time.monotonic() - t0
    res["draw_peak_bytes"] = torch.cuda.max_memory_allocated()
    if not isinstance(params["layers"]["wg"], QTensor):
        raise AssertionError("the experts are not int8")
    weights = param_bytes(params)
    log(f"moe: mixtral-8x7b int8 weights, {weights / 1e9:.2f} GB, drawn in "
        f"{res['draw_s']:.1f}s (peak allocated "
        f"{res['draw_peak_bytes'] / 1e9:.2f} GB)")
    rng = np.random.RandomState(seed + 8)
    lens = [700, 40, 90, 200, 300, 450, 600, 120]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    # a prompt no engine has cached, for the routing trace
    route_prompt = rng.randint(0, cfg.vocab_size, size=600).tolist()

    # (a) bf16 KV: K2 for every prompt chunk, K1 for every decode step
    eng = InferenceEngine(cfg, params, _moe_cfg())
    clock = ReplayClock(eng)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    got = _drive(eng, prompts, MOE_NEW)
    torch.cuda.synchronize()
    res["drive_s"] = time.monotonic() - t0
    launched = _moe_launches()
    k1, k2 = launched["paged_decode_attention"], \
        launched["paged_prefill_attention"]
    log(f"moe (a): 8 requests in {res['drive_s']:.1f}s, launches K1={k1} "
        f"K2={k2}, {eng.graph_replays} replays, graphs {sorted(eng._graphs)}")
    if k1 == 0 or k2 == 0:
        raise AssertionError(f"moe (a): K1={k1} K2={k2}")
    res["launches_a"] = launched
    route_kernel = routing_trace(eng, route_prompt)
    res["prefill"] = moe_prefill(eng, cfg, rng, MOE_PROMPT)
    res["decode"] = graph_profile(eng, clock, cfg, rng, width=8, ctx=256,
                                  max_new=112)
    ecfg = eng.ecfg
    plan = plan_memory(cfg, hbm_bytes=hbm_for_device("cuda:0"),
                       num_pages=ecfg.num_pages, page_size=ecfg.page_size,
                       max_pages_per_seq=ecfg.max_pages_per_seq,
                       max_batch=ecfg.max_batch,
                       prefill_bucket=max(ecfg.prefill_buckets),
                       quantize="int8", kv_dtype="bfloat16")
    pool = tensor_bytes((eng.k_pool, eng.v_pool))
    split = allocator_split(torch.device("cuda:0"))
    res["memory"] = {
        "weights": weights, "kv_pool": pool,
        "graph_pool_reserved": split["graph_reserved"],
        "graph_pool_allocated": split["graph_allocated"],
        "allocated": torch.cuda.memory_allocated(),
        "reserved": torch.cuda.memory_reserved(),
        "plan": {"weight_bytes": plan.weight_bytes,
                 "kv_pool_bytes": plan.kv_pool_bytes,
                 "activation_bytes": plan.activation_bytes,
                 "total_bytes": plan.total_bytes}}
    log(f"moe (a) bytes: {res['memory']}")
    if abs(weights - plan.weight_bytes) > PLAN_EXACT * plan.weight_bytes \
            or pool != plan.kv_pool_bytes:
        raise AssertionError(f"moe (a): bytes {res['memory']} vs the plan")
    eng.close()
    del eng, clock
    gc.collect()
    torch.cuda.empty_cache()
    plain = InferenceEngine(cfg, params, _moe_cfg(attention_backend="plain"))
    kernels.reset_launch_counts()
    ref = _drive(plain, prompts, MOE_NEW)
    if any(_moe_launches()[k] for k in ("paged_decode_attention",
                                        "paged_prefill_attention")):
        raise AssertionError("moe (a): the plain engine launched a kernel")
    route_plain = routing_trace(plain, route_prompt)
    plain.close()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    # top-2 routing is discontinuous: where a token's 2nd and 3rd router
    # logits are nearer than attention's rounding moves them, the two
    # engines route it to different experts and their logits part by far
    # more than rounding.  So the streams are reported, every routing
    # parting is held to the router's flip bound, and the logits gate
    # (LOGITS_RTOL) runs on the same widths and tree with every expert
    # routed (top-8 of 8: continuous weights), which holds K2 and K1 end
    # to end inside the MoE model.
    same, agree, worst = _compare_streams(cfg, got, ref, MOE_NEW)
    res["vs_plain_top2"] = {
        "identical_streams": same, "token_agreement": [agree,
                                                       MOE_NEW * len(got)],
        "logits_rel_err": worst,
        "routing": routing_flips(cfg, route_kernel, route_plain)}
    log(f"moe (a) top-2, kernel vs plain engine: {same}/8 identical, "
        f"agreement {agree}/{MOE_NEW * len(got)}, worst logits {worst:.4f}; "
        f"routing on a 600-token prefill: {res['vs_plain_top2']['routing']}")
    del got, ref
    dense = cfg.replace(num_experts_per_tok=cfg.num_experts)
    short = prompts[:4]
    runs = []
    for backend in ("kernel", "plain"):
        e = InferenceEngine(dense, params,
                            _moe_cfg(attention_backend=backend))
        kernels.reset_launch_counts()
        runs.append(_drive(e, short, MOE_NEW))
        if backend == "kernel":
            res["launches_a_top8"] = _moe_launches()
        e.close()
        del e
        gc.collect()
        torch.cuda.empty_cache()
    res["vs_plain"] = _moe_compare("(a) every expert routed, kernel vs "
                                   "plain engine", dense, *runs, MOE_NEW)
    del runs

    # (b) int8 KV: K4 for every decode step, on the model as published
    # (top-2), then held to plain attention with every expert routed
    kv8 = InferenceEngine(cfg, params, _moe_cfg(kv_quantize="int8"))
    kernels.reset_launch_counts()
    _drive(kv8, short, MOE_NEW)
    torch.cuda.synchronize()
    res["launches_b"] = _moe_launches()
    k4 = res["launches_b"]["paged_decode_attention_int8"]
    log(f"moe (b): int8 KV, launches {res['launches_b']}")
    if k4 == 0 or res["launches_b"]["paged_decode_attention"]:
        raise AssertionError(f"moe (b): {res['launches_b']}")
    kv8.close()
    del kv8
    runs = []
    for backend in ("kernel", "plain"):
        gc.collect()
        torch.cuda.empty_cache()
        e = InferenceEngine(dense, params, _moe_cfg(
            kv_quantize="int8", attention_backend=backend))
        runs.append(_drive(e, short, MOE_NEW))
        e.close()
        del e
    res["int8_kv_vs_plain"] = _moe_compare(
        "(b) int8 KV, every expert routed, K4 vs plain", dense, *runs,
        MOE_NEW)
    del runs, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


async def _serve_moe(db_path: str) -> dict:
    """(c) A server from the environment (KAFKA_TORCH_MODEL=mixtral-8x7b,
    KAFKA_TORCH_QUANTIZE=int8; byte tokenizer, so the vocab is 262, full
    width otherwise): one streamed thread turn to [DONE], then a forced
    tool call (tool_choice "required" over the agent's idle tool) whose
    text must parse."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.agents import IDLE_TOOL
    from kafka_tpu_torch.models.quant import QTensor
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    knobs = {"KAFKA_TORCH_MODEL": "mixtral-8x7b",
             "KAFKA_TORCH_QUANTIZE": "int8"}
    os.environ.update(knobs)
    try:
        cfg = ServingConfig.from_env(
            max_batch=8, page_size=16, num_pages=8 * MOE_PAGES + 1,
            max_pages_per_seq=MOE_PAGES,
            prefill_buckets=(64, 256, 512, 1024, 2048), db_path=db_path,
            system_prompt="You are a terse assistant.", warmup=False)
    finally:
        for k in knobs:
            del os.environ[k]
    t0 = time.monotonic()
    app = await create_app(cfg, tools=[], mcp_servers=[])
    out = {"build_s": time.monotonic() - t0}
    llm = app[STATE_KEY]["llm"]
    engine, tok = llm.engine, llm.tokenizer
    if not engine.cfg.is_moe or \
            not isinstance(engine.params["layers"]["wg"], QTensor):
        raise AssertionError("the server does not hold int8 Mixtral experts")
    seen = _spy_submits(engine)
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}/v1/threads"
    kernels.reset_launch_counts()
    try:
        async with aiohttp.ClientSession() as s:
            timing: dict = {}
            ev = await _stream(s, f"{base}/moe/chat/completions", {
                "model": "mixtral-8x7b", "stream": True, "temperature": 0,
                "max_tokens": 16, "messages": [{
                    "role": "user",
                    "content": "Name one use of a mixture of experts."}]},
                timing)
            out["turn"] = _usage(ev)
            out["ttft_s"] = timing.get("ttft_s")
            t0 = time.monotonic()
            out["forced"] = await _constrained_turn(
                s, f"{base}/moe-forced/chat/completions", "required",
                engine, seen, tok, [IDLE_TOOL], model="mixtral-8x7b")
            out["forced"].pop("grammar")
            out["forced_s"] = time.monotonic() - t0
    finally:
        out["launches"] = _moe_launches()
        await runner.cleanup()
    log(f"moe (c) server: {out}")
    if not out["launches"]["paged_prefill_attention"] or \
            not out["launches"]["paged_decode_attention"]:
        raise AssertionError(f"moe (c): the server launched {out['launches']}")
    return out


def moe_ep_leg(seed: int) -> dict:
    """(d) bf16 mixtral-8x7b at full width and MOE_EP_LAYERS layers at ep 2
    (experts 0-3 on cuda:0, 4-7 on cuda:1; attention and the pool
    replicated; "auto" resolves to plain attention, the reference's rule)
    against a single-card engine on the same weights: the published
    top-2 streams and where their routing parts (each parting held to the
    router's flip bound), and with every expert routed (continuous
    weights) logits within LOGITS_RTOL; NCCL's device time per layer (one
    all-reduce a layer: the MoE combine) and each rank's bytes against
    the per-rank plan."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.parallel import (
        MeshConfig,
        RandomWeights,
        RankGroup,
        init_params_shard,
    )
    from kafka_tpu_torch.runtime import InferenceEngine

    cfg = get_config("mixtral-8x7b").replace(num_layers=MOE_EP_LAYERS)
    dense = cfg.replace(num_experts_per_tok=cfg.num_experts)
    prompts = _tp_prompts(cfg, seed + 9, [700, 40, 90, 200, 300, 450, 600,
                                          120, 600])
    # the last prompt is no engine's cached prefix: the routing trace's
    route_prompt = prompts.pop()
    res = {"layers": MOE_EP_LAYERS}
    params = init_params_shard(cfg, seed, device="cuda:0")
    ref, route = {}, {}
    for name, c in (("top2", cfg), ("top8", dense)):
        single = InferenceEngine(c, params, _moe_cfg())
        ref[name] = _drive(single, prompts, MOE_NEW)
        if name == "top2":
            route["single"] = routing_trace(single, route_prompt)
        single.close()
        del single
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    group = RankGroup(MeshConfig(ep=2), timeout_s=300)
    res["group_s"] = time.monotonic() - t0
    try:
        for name, c in (("top2", cfg), ("top8", dense)):
            eng = InferenceEngine(c, RandomWeights(seed=seed),
                                  _moe_cfg(attention_backend="auto"),
                                  mesh=group)
            res["backend"] = [eng.cfg.attention_backend,
                              eng.attention_backend_reasons]
            if eng.cfg.attention_backend != "plain":
                raise AssertionError(f"moe (d): ep 2 resolved to "
                                     f"{res['backend']}")
            t0 = time.monotonic()
            got = _drive(eng, prompts, MOE_NEW)
            if name == "top8":
                res["vs_single_card"] = _moe_compare(
                    "(d) ep 2 vs one card, every expert routed", c, got,
                    ref[name], MOE_NEW)
                eng.close()
                del eng, got
                continue
            res["drive_s"] = time.monotonic() - t0
            same, agree, worst = _compare_streams(c, got, ref[name],
                                                  MOE_NEW)
            res["top2_vs_single_card"] = {
                "identical_streams": same,
                "token_agreement": [agree, MOE_NEW * len(got)],
                "logits_rel_err": worst,
                "routing": routing_flips(c, routing_trace(
                    eng, route_prompt), route["single"])}
            log(f"moe (d) top-2, ep 2 vs one card: "
                f"{res['top2_vs_single_card']}")
            res["nccl"] = tp_nccl_profile(eng, c, np.random.RandomState(seed))
            res["memory"] = _moe_rank_bytes(eng, c, tp=1, ep=2)
            eng.close()
            del eng, got
    finally:
        group.close()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _moe_rank_bytes(eng, cfg, tp: int, ep: int) -> dict:
    """Each rank's weight and pool bytes against the per-rank plan
    (weights within PLAN_EXACT, the pool exact)."""
    from kafka_tpu_torch.runtime.planner import hbm_for_device, plan_memory

    ecfg = eng.ecfg
    plan = plan_memory(cfg, hbm_bytes=hbm_for_device("cuda:0"), tp=tp,
                       ep=ep, num_pages=ecfg.num_pages,
                       page_size=ecfg.page_size,
                       max_pages_per_seq=ecfg.max_pages_per_seq,
                       max_batch=ecfg.max_batch,
                       prefill_bucket=max(ecfg.prefill_buckets))
    mem = eng.rank_query("rank_memory")
    out = {"ranks": mem, "plan": {"weight_bytes": plan.weight_bytes,
                                  "kv_pool_bytes": plan.kv_pool_bytes,
                                  "total_bytes": plan.total_bytes}}
    log(f"  per-rank bytes at tp {tp} x ep {ep}: {out}")
    for m in mem:
        if abs(m["weights"] - plan.weight_bytes) > \
                PLAN_EXACT * plan.weight_bytes or \
                m["kv_pool"] != plan.kv_pool_bytes:
            raise AssertionError(f"rank bytes {m} vs plan {out['plan']}")
    return out


def moe_ep_tp_leg(seed: int) -> dict:
    """(e) full-depth bf16 mixtral-8x7b at ep 2 x tp 2 (~24 GB a rank):
    eight requests through the engine, each rank's bytes against the
    per-rank plan, NCCL per layer, then a streamed thread turn through a
    server from KAFKA_TORCH_EP_SIZE=2 KAFKA_TORCH_TP_SIZE=2."""
    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config
    from kafka_tpu_torch.parallel import MeshConfig, RandomWeights, RankGroup
    from kafka_tpu_torch.runtime import InferenceEngine

    cfg = get_config("mixtral-8x7b")
    prompts = _tp_prompts(cfg, seed + 10, [700, 40, 90, 200, 300, 450, 600,
                                           120])
    res = {}
    t0 = time.monotonic()
    group = RankGroup(MeshConfig(tp=2, ep=2), timeout_s=600)
    res["group_s"] = time.monotonic() - t0
    try:
        t0 = time.monotonic()
        eng = InferenceEngine(cfg, RandomWeights(seed=seed),
                              _moe_cfg(attention_backend="auto"), mesh=group)
        res["build_s"] = time.monotonic() - t0
        got = _drive(eng, prompts, 8)
        for r in got:
            if len(r.output_ids) != 8 or not all(
                    torch.isfinite(x).all() for x in r.logits):
                raise AssertionError(f"moe (e): {r.request_id} "
                                     f"{r.output_ids} {r.finish_reason}")
        res["memory"] = _moe_rank_bytes(eng, cfg, tp=2, ep=2)
        res["nccl"] = tp_nccl_profile(eng, cfg, np.random.RandomState(seed))
        eng.close()
        del eng, got
    finally:
        group.close()
    gc.collect()
    torch.cuda.empty_cache()
    res["server"] = asyncio.run(_serve_tp(
        "mixtral-8x7b", 2, "Summarise expert parallelism in one line.",
        ep=2))
    if res["server"]["left_running"]:
        raise AssertionError(f"moe (e): ranks left running: {res['server']}")
    return res


def phase_moe(seed: int, legs: str = "abcde") -> None:
    """Phase 8: Mixtral-class MoE.  (a)-(c) on one card; (d) needs 2 cards
    and (e) 4, and report `skipped: cards` with fewer.  Every leg runs
    even when one before it failed; the phase fails after the last, its
    record in chiprun_out/moe_phase.json."""
    import traceback

    import torch

    cards = torch.cuda.device_count()
    res = {"cards": cards}
    failed = []

    def leg(key, fn, *args):
        try:
            res[key] = fn(*args)
        except Exception as e:
            log(f"moe leg {key} FAILED:\n{traceback.format_exc()}")
            res[key] = {"failed": f"{type(e).__name__}: {e}"}
            failed.append(key)
        gc.collect()
        torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.empty_cache()
    if "a" in legs or "b" in legs:
        leg("one_card", moe_one_card, seed)
    if "c" in legs:
        with tempfile.TemporaryDirectory() as td:
            leg("server", lambda: asyncio.run(
                _serve_moe(os.path.join(td, "moe.db"))))
    for key, need, fn in (("d", 2, moe_ep_leg), ("e", 4, moe_ep_tp_leg)):
        if key not in legs:
            continue
        if cards < need:
            log(f"moe ({key}): needs {need} cards, {cards} visible: "
                "skipped: cards (not counted as passed)")
            res[key] = "skipped: cards"
        else:
            leg(key, fn, seed)
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "moe_phase.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    if failed:
        raise AssertionError(f"moe phase: legs {failed} failed")
    RESULTS["moe"] = res
    one = res.get("one_card", {})
    server = res.get("server", {})
    # the kernels line's `moe_launches`: each leg's counts, zeroed just
    # before it and read just after ((a), (b), (c) on one card; at ep > 1
    # attention is the plain gather, so (d) and (e) launch none)
    names = {"K1": "paged_decode_attention", "K2": "paged_prefill_attention",
             "K3": "paged_verify_attention",
             "K4": "paged_decode_attention_int8", "K5": "fused_mlp_block",
             "K5_int8": None}
    res["launches"] = {}
    for k, name in names.items():
        res["launches"][k] = sum(
            r.get(name, 0) for r in (one.get("launches_a", {}),
                                     one.get("launches_b", {}),
                                     server.get("launches", {}))) \
            if name else 0
    for k in KERNEL_KEYS + TP_KERNEL_KEYS:
        if k in RESULTS:
            RESULTS[k]["moe_launches"] = res["launches"].get(k, 0)


# the vision phase's image prompts: (prompt tokens, first placeholder's
# position).  Lane 0 is longer than the largest bucket and its image
# straddles the chunk boundary at 512, so K2 runs on a chunk holding part
# of the image and the next holds the rest
VISION_LANES = ((700, 500), (60, 10), (120, 40), (300, 250))
VISION_NEW = 16
# two different images must move the first-token logits by more than this
# share of the row's largest logit (and by more than ten times the kernel
# engine's own error against plain attention)
VISION_DIFF_MIN = 1e-3


def _vision_prompts(cfg, rng) -> list:
    """(prompt ids, placeholder positions) per VISION_LANES entry: random
    text ids around num_patches image_token_id placeholders."""
    import numpy as np

    P = cfg.vision.num_patches
    out = []
    for n, at in VISION_LANES:
        ids = rng.randint(0, cfg.vocab_size, size=n)
        ids[at:at + P] = cfg.image_token_id
        out.append((ids.tolist(), np.arange(at, at + P, dtype=np.int32)))
    return out


def _vision_run(eng, prompts, rows, max_new: int, tag: str = "v") -> list:
    """Each image prompt alone through the engine (a single-lane prefill:
    K2 on a bf16 pool), lane i showing rows[i] ([P, H] f32)."""
    from kafka_tpu_torch.runtime import GenRequest

    reqs = []
    for i, (ids, pos) in enumerate(prompts):
        req = GenRequest(request_id=f"{tag}{i}", prompt_ids=list(ids),
                         max_new_tokens=max_new, override_pos=pos,
                         override_rows=rows[i])
        eng.submit(req)
        eng.run_to_completion()
        reqs.append(req)
    return reqs


def vision_leg(label: str, cfg, params, vparams, prompts, pixels,
               kv_quantize: str = "") -> dict:
    """One leg of the vision phase: encode the images on the card, stream
    every image prompt through the kernel engine and a plain-attention
    engine on the same parameters, and hold them together."""
    import torch

    from kafka_tpu_torch.models.vision import encode_images
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import InferenceEngine

    vcfg = cfg.vision
    pix = torch.from_numpy(pixels).cuda()
    with torch.no_grad():
        emb = encode_images(vparams, vcfg, pix)
        encode_ms = time_ms(lambda: encode_images(vparams, vcfg, pix),
                            iters=20, warmup=3)
    if emb.shape != (len(pixels), vcfg.num_patches, cfg.hidden_size) or \
            not torch.isfinite(emb).all():
        raise AssertionError(f"vision {label}: tower output {emb.shape}")
    rows = list(emb.float().cpu().numpy())
    eng = InferenceEngine(cfg, params, _engine_cfg(kv_quantize=kv_quantize))
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    got = _vision_run(eng, prompts, rows, VISION_NEW)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launched = {f.__name__: f.launches for f in kernels.KERNELS}
    want = (("paged_decode_attention_int8",) if kv_quantize
            else ("paged_prefill_attention", "paged_decode_attention"))
    if any(not launched[n] for n in want) or (kv_quantize and (
            launched["paged_decode_attention"]
            or launched["paged_prefill_attention"])):
        raise AssertionError(f"vision {label}: launches {launched}")
    plain = InferenceEngine(cfg, params, _engine_cfg(
        kv_quantize=kv_quantize, attention_backend="plain"))
    kernels.reset_launch_counts()
    ref = _vision_run(plain, prompts, rows, VISION_NEW)
    if any(f.launches for f in kernels.KERNELS):
        raise AssertionError(f"vision {label}: the plain engine launched")
    same, agree, worst = _compare_streams(cfg, got, ref, VISION_NEW)
    first = max(((a.logits[0] - b.logits[0]).abs().max()
                 / b.logits[0].abs().max()).item()
                for a, b in zip(got, ref))
    # the same prompt showing another image (lane 0's) on the kernel
    # engine: the first-token logits must move
    alt = _vision_run(eng, prompts[3:], rows[:1], 1, tag="alt")[0]
    row = got[3].logits[0]
    img_diff = ((row - alt.logits[0]).abs().max() / row.abs().max()).item()
    # host clock of lane 0's prefill (700 tokens: two chunks, the image
    # across their boundary) and its first token
    prefill_ms = time_ms(lambda: _vision_run(eng, prompts[:1], rows, 1,
                                             tag="t"), iters=5, warmup=1)
    total = VISION_NEW * len(prompts)
    out = {"seconds": dt, "launches": launched, "encode_ms": encode_ms,
           "images": len(pixels), "prefill_ms_700": prefill_ms,
           "identical_streams": same, "token_agreement": [agree, total],
           "logits_rel_err": worst, "first_token_rel_err": first,
           "two_images_rel_diff": img_diff}
    log(f"vision {label}: encode {len(pixels)} images {encode_ms:.3f} ms, "
        f"700-token image prompt prefill + first token {prefill_ms:.2f} ms "
        f"(CUDA events), launches {launched}; vs plain: {same}/"
        f"{len(prompts)} identical streams, agreement {agree}/{total}, "
        f"first-token logits {first:.4f}, worst {worst:.4f} (tol "
        f"{LOGITS_RTOL}); another image moves the first-token logits by "
        f"{img_diff:.4f}")
    if not worst <= LOGITS_RTOL or not first <= LOGITS_RTOL:
        raise AssertionError(f"vision {label}: logits disagree: {out}")
    if not img_diff > max(VISION_DIFF_MIN, 10 * first):
        raise AssertionError(f"vision {label}: two images give the same "
                             f"logits: {out}")
    if eng.self_check():
        raise AssertionError(f"vision {label}: {eng.self_check()}")
    return out


async def _serve_vision(cfg, params, vparams, db_path: str) -> dict:
    """The HTTP image leg: create_app over a provider holding the tower
    (the byte tokenizer's vocab + the placeholder id, full width
    otherwise).  An image turn in each wire form (`image_url`, and
    Anthropic-style `image`) streams to [DONE] with num_patches more
    prompt tokens than the same text alone; a malformed image is a 400."""
    import aiohttp
    from aiohttp import web

    from kafka_tpu_torch.llm import TorchLLMProvider
    from kafka_tpu_torch.models import ByteTokenizer
    from kafka_tpu_torch.ops import kernels
    from kafka_tpu_torch.runtime import InferenceEngine
    from kafka_tpu_torch.server import ServingConfig, create_app

    engine = InferenceEngine(cfg, params, _engine_cfg())
    provider = TorchLLMProvider(engine, ByteTokenizer(),
                                model_name="llama-3.2-1b-vision",
                                vision_params=vparams)
    app = await create_app(
        ServingConfig(db_path=db_path,
                      system_prompt="You are a terse assistant."),
        llm_provider=provider, tools=[], mcp_servers=[])
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    png = _png_data_url()
    out = {}
    kernels.reset_launch_counts()
    try:
        async with aiohttp.ClientSession() as s:
            for label, content in (
                    ("text", "What is in the picture?"),
                    ("image_url", [
                        {"type": "text", "text": "What is in the picture?"},
                        {"type": "image_url", "image_url": {"url": png}}]),
                    ("image", [
                        {"type": "text", "text": "What is in the picture?"},
                        {"type": "image", "source": {"data": png}}])):
                ev = await _stream(s, url, {
                    "model": "llama-3.2-1b-vision", "stream": True,
                    "temperature": 0, "max_tokens": 8,
                    "messages": [{"role": "user", "content": content}]})
                out[label] = _usage(ev)["prompt_tokens"]
            async with s.post(url, json={
                    "model": "llama-3.2-1b-vision", "max_tokens": 4,
                    "messages": [{"role": "user", "content": [{
                        "type": "image_url", "image_url": {
                            "url": "data:image/png;base64,@@"}}]}]}) as r:
                out["malformed_status"] = r.status
    finally:
        out["launches"] = {f.__name__: f.launches for f in kernels.KERNELS}
        await runner.cleanup()
    P = cfg.vision.num_patches
    log(f"vision server: prompt tokens {out}")
    if out["image_url"] != out["text"] + P or out["image"] != out["text"] \
            + P or out["malformed_status"] != 400:
        raise AssertionError(f"vision server: {out}")
    if not out["launches"]["paged_prefill_attention"] or \
            not out["launches"]["paged_decode_attention"]:
        raise AssertionError(f"vision server: launches {out['launches']}")
    return out


def _png_data_url(size: int = 48) -> str:
    import base64
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.RandomState(5).randint(0, 255, (size, size, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def phase_vision(seed: int) -> None:
    """Phase 9: vision.  llama-3.2-1b at full width (random weights from
    --seed) with the reference's default VisionConfig() tower and
    image_token_id 262, as in tiny-vision: (a) bf16 (K2 on every image
    prompt's chunks, K1 for the decode after them), (b) int8 weights and
    an int8 KV pool (K4; prefill over an int8 pool reads it through the
    dequantizing gather, as in the reference), (c) the HTTP image leg when
    Pillow is installed."""
    import importlib.util

    import numpy as np
    import torch

    from kafka_tpu_torch.models import get_config, init_params
    from kafka_tpu_torch.models.quant import quantize_params
    from kafka_tpu_torch.models.vision import VisionConfig, vision_init_params

    cfg = get_config("llama-3.2-1b").replace(vision=VisionConfig(),
                                             image_token_id=262)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    vparams = vision_init_params(cfg.vision, cfg.hidden_size, gen,
                                 dtype=torch.bfloat16, device="cuda")
    rng = np.random.RandomState(seed + 9)
    prompts = _vision_prompts(cfg, rng)
    pixels = rng.rand(len(prompts), cfg.vision.image_size,
                      cfg.vision.image_size, 3).astype(np.float32)
    res = {"bf16": vision_leg("bf16", cfg, params, vparams, prompts, pixels)}
    gc.collect()
    torch.cuda.empty_cache()
    qparams = quantize_params(params)
    res["int8"] = vision_leg("int8 weights + int8 KV", cfg, qparams, vparams,
                             prompts, pixels, kv_quantize="int8")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    if importlib.util.find_spec("PIL") is None:
        log("vision (c) HTTP image leg left out: Pillow is not installed")
        res["server"] = "left out: no Pillow"
    else:
        scfg = cfg.replace(vocab_size=cfg.image_token_id + 1)
        sparams = init_params(scfg, gen, device="cuda")
        with tempfile.TemporaryDirectory() as td:
            res["server"] = asyncio.run(_serve_vision(
                scfg, sparams, vparams, os.path.join(td, "vision.db")))
        del sparams
    del params
    gc.collect()
    torch.cuda.empty_cache()
    names = {"K1": "paged_decode_attention", "K2": "paged_prefill_attention",
             "K3": "paged_verify_attention",
             "K4": "paged_decode_attention_int8", "K5": "fused_mlp_block",
             "K5_int8": None}
    legs = [res["bf16"]["launches"], res["int8"]["launches"]]
    if isinstance(res["server"], dict):
        legs.append(res["server"]["launches"])
    res["launches"] = {k: sum(l.get(n, 0) for l in legs) if n else 0
                       for k, n in names.items()}
    RESULTS["vision"] = res
    for k in KERNEL_KEYS:
        if k in RESULTS:
            RESULTS[k]["vision_launches"] = res["launches"][k]


def main() -> int:
    global BASELINE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernels,engine,graphs,server,tiers,"
                            "replicas,telemetry,tp,moe,vision",
                    help="comma list of kernels, engine, graphs, server, "
                         "tiers, replicas, telemetry, tp, moe, vision "
                         "(default: "
                         "all; telemetry runs first), "
                         "or attention (K3 and K4 alone, timed) or mlp (K5 "
                         "alone, timed)")
    ap.add_argument("--root", default=None,
                    help="time another checkout's kernels (the package "
                         "under this directory) on the same inputs; "
                         "prints no result line")
    ap.add_argument("--out", default="chip_smoke.json",
                    help="the record's file name under chiprun_out/")
    ap.add_argument("--moe-legs", default="abcde",
                    help="the moe phase's legs: a-c one card, d two "
                         "cards, e four (default: all)")
    # the tp phase's dead-rank leg runs itself in a child process
    ap.add_argument("--tp-kill", action="store_true",
                    help=argparse.SUPPRESS)
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
    if args.tp_kill:
        return tp_kill_child()
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
    if "tiers" in phases:
        phase_tiers(args.seed)
    if "replicas" in phases:
        phase_replicas(args.seed)
    if "tp" in phases:
        phase_tp(args.seed)
    if "moe" in phases:
        phase_moe(args.seed, args.moe_legs)
    if "vision" in phases:
        phase_vision(args.seed)
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
                                       "telemetry_launches", "tiers_launches",
                                       "replicas_launches",
                                       "moe_launches", "vision_launches",
                                       "launch_count_basis",
                                       "replay_profiler_launches",
                                       "device_ms", "device_ms_cold_l2",
                                       "sweep_layer_device_ms",
                                       "library_device_ms", "torch_ms",
                                       "wrapper", "cases")
            if k in RESULTS[n]}}
        for n in KERNEL_KEYS + TP_KERNEL_KEYS if n in RESULTS
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
