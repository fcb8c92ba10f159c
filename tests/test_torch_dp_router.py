"""kafka_tpu_torch.runtime.dp_router against kafka_tpu.runtime.dp_router.

Both routers run over the reference's `dp-test` model (vocab 128, hidden
64, 2 layers, f32) with the same weights: the JAX router over the eight
virtual CPU devices tests/conftest.py sets, the port's over eight CPU
replica slots.  Held equal between the packages:

* routing: the same keyed and unkeyed requests land on the same replica,
  and the greedy streams equal each other and a single engine's;
* affinity: a thread's second turn lands on its first turn's replica and
  hits its prefix cache the same way;
* supervision: one failure schedule on replica 0 (its step monkeypatched
  to raise) gives the same health transitions at the same router step
  indices (healthy -> quarantined -> probation -> healthy), the same
  migrated request ids and the same forced probation when every replica
  is quarantined;
* rebuild(dp=1) then rebuild(dp=2) keeps the same WAITING ids per replica;
* validate_dp's errors;
* a provider over each router reports the same /admin/signals snapshot at
  dp 2 (the key tree, and every value a fixed workload decides);
* the provider's resize path over each router's live worker thread: dp
  2 -> 1 -> 2 with a stream in flight and a request queued behind the
  parked worker, and a resize cancelled mid-rebuild; every stream
  finishes equal to a single engine's, and the worker ends alive and
  unparked.

Quarantine windows end on an injected clock (the port's `clock`, the
reference module's `time`); nothing sleeps.
"""

import asyncio
import queue
import threading
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.runtime import EngineConfig as JEngineConfig
from kafka_tpu.runtime import GenRequest as JGenRequest
from kafka_tpu.runtime import dp_router as ref
from kafka_tpu_torch.models import params_from_jax
from kafka_tpu_torch.models.config import ModelConfig
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime import dp_router as port

ECFG = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8,
            prefill_buckets=(8, 16, 32))
DIMS = dict(name="dp-test", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, dtype="float32")
SLOTS = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(17))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ModelConfig(**DIMS), params


def routers(model, dp=2, **kw):
    """(reference router, port router) over the same weights."""
    jcfg, jparams, cfg, params = model
    j = ref.DataParallelEngines(jcfg, jparams, JEngineConfig(**ECFG), dp=dp,
                                kv_dtype=jnp.float32, **kw)
    p = port.DataParallelEngines(cfg, params, EngineConfig(**ECFG), dp=dp,
                                 kv_dtype=torch.float32, devices=SLOTS, **kw)
    return j, p


def prompt(seed, n):
    return [int(x) for x in np.random.RandomState(seed).randint(1, 128, n)]


def drive(dp, on_step=None, cap=500):
    """The worker's loop (step, recover on exception) over a router; calls
    on_step(index) after every router step.  Returns {request_id:
    finish_reason}, asserting one terminal event per request."""
    terminal = {}
    for i in range(cap):
        if not dp.has_work:
            break
        try:
            events = dp.step()
        except Exception:
            events = dp.recover_from_failure()
        for ev in events:
            if ev.finished:
                assert ev.request_id not in terminal
                terminal[ev.request_id] = ev.finish_reason
        if on_step is not None:
            on_step(i)
    return terminal


def test_routing_and_streams_match(model):
    j, p = routers(model)
    jcfg, jparams, cfg, params = model
    single = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                             kv_dtype=torch.float32, device="cpu")
    work = [(f"u{i}", None, prompt(i, 9)) for i in range(4)] + [
        (f"k{i}", f"thread-{i}", prompt(10 + i, 12)) for i in range(3)]
    outs = []
    for dp, Req in ((j, JGenRequest), (p, GenRequest)):
        reqs = [Req(request_id=rid, prompt_ids=list(pr), max_new_tokens=5,
                    prefix_key=key) for rid, key, pr in work]
        for r in reqs:
            dp.submit(r)
        routes = dict(dp._route)
        done = dp.run_to_completion()
        outs.append((routes, {rid: done[rid].output_ids for rid in done},
                     dict(dp._affinity)))
    assert outs[1] == outs[0]
    assert sorted(outs[1][0].values()) == [0, 0, 0, 0, 1, 1, 1]
    for rid, _, pr in work:
        assert outs[1][1][rid] == single.generate(
            list(pr), max_new_tokens=5).output_ids, rid


def test_affinity_survives_second_turn(model):
    j, p = routers(model)
    first = prompt(9, 10)
    got = []
    for dp, Req in ((j, JGenRequest), (p, GenRequest)):
        # a filler on the other replica, so load alone would move turn 2
        r1 = Req(request_id="t1", prompt_ids=list(first), max_new_tokens=4,
                 prefix_key="thread-A")
        dp.submit(r1)
        dp.run_to_completion()
        home = dp._affinity["thread-A"]
        dp.engines[home].submit(Req(request_id="fill", prompt_ids=[9] * 8,
                                    max_new_tokens=8))
        r2 = Req(request_id="t2", prompt_ids=first + r1.output_ids + [5],
                 max_new_tokens=4, prefix_key="thread-A")
        dp.submit(r2)
        route = dp._route["t2"]
        dp.run_to_completion()
        got.append((home, route, r2.cached_tokens, r2.cache_source,
                    r2.output_ids, dp.engines[home].prefix_cache.hits))
    assert got[1] == got[0]
    home, route, cached, source = got[1][:4]
    assert route == home and cached == 8 and source == "own"


def fail_first(dp, idx, n):
    """Replica idx's step raises on its next n calls, then steps normally
    (a dead device / process stand-in)."""
    engine = dp.engines[idx]
    orig = engine.step
    left = [n]

    def step():
        if left[0] > 0:
            left[0] -= 1
            raise RuntimeError(f"replica {idx} device lost")
        return orig()

    engine.step = step


def test_failure_schedule_same_transitions(model, monkeypatch):
    """Replica 0 fails its first three steps while its queue waits: the
    breaker trips on the third, the queue migrates to replica 1, the
    window's end (an injected clock) puts replica 0 on probation, and new
    work routed there promotes it back to healthy after three clean
    steps."""
    now = [1000.0]
    monkeypatch.setattr(ref, "time", types.SimpleNamespace(
        monotonic=lambda: now[0]))
    records = []
    for dp, Req in zip(routers(model, quarantine_threshold=3,
                                quarantine_window_s=5.0, probation_steps=3),
                       (JGenRequest, GenRequest)):
        if isinstance(dp, port.DataParallelEngines):
            dp.clock = lambda: now[0]
        now[0] = 1000.0
        fail_first(dp, 0, 3)
        for i in range(4):
            dp.submit(Req(request_id=f"q{i}", prompt_ids=prompt(20 + i, 9),
                          max_new_tokens=4, prefix_key=f"t{i}"))
        first_routes = dict(dp._route)
        trans = [(-1, ("healthy", "healthy"))]
        step_i = [0]

        def on_step(i, dp=dp, trans=trans):
            step_i[0] += 1
            states = tuple(h.state for h in dp.health)
            if trans[-1][1] != states:
                trans.append((step_i[0], states))

        terminal = drive(dp, on_step)
        now[0] += 10.0  # the quarantine window ends
        for i in range(2):
            dp.submit(Req(request_id=f"n{i}", prompt_ids=prompt(30 + i, 9),
                          max_new_tokens=4))
        trans.append((step_i[0], tuple(h.state for h in dp.health)))
        late_routes = dict(dp._route)
        terminal.update(drive(dp, on_step))
        records.append((first_routes, late_routes, trans, terminal,
                        dp.supervisor.snapshot()))
    assert records[1] == records[0]
    first_routes, late_routes, trans, terminal, sup = records[1]
    assert [t[1][0] for t in trans] == ["healthy", "quarantined",
                                        "probation", "healthy"]
    assert trans[1][0] == 3  # the third failing step trips the breaker
    assert late_routes["n0"] == 0
    assert sup["quarantines"] == 1 and sup["readmits"] == 1
    assert sup["waiting_migrated"] == sum(
        1 for r in first_routes.values() if r == 0) == 2
    assert set(terminal.values()) == {"length"} and len(terminal) == 6


def test_forced_probation_when_all_quarantined(model):
    records = []
    for dp, Req in zip(routers(model, quarantine_threshold=1,
                                quarantine_window_s=30.0),
                       (JGenRequest, GenRequest)):
        fail_first(dp, 0, 1)
        fail_first(dp, 1, 1)
        for i in range(2):
            dp.submit(Req(request_id=f"a{i}", prompt_ids=prompt(40 + i, 9),
                          max_new_tokens=3))
        terminal = drive(dp, cap=2)
        quarantined = [h.state for h in dp.health]
        dp.submit(Req(request_id="s", prompt_ids=prompt(42, 9),
                      max_new_tokens=3))
        route = dp._route["s"]
        terminal.update(drive(dp))
        records.append((quarantined, route, [h.state for h in dp.health],
                        terminal))
    assert records[1] == records[0]
    # replica 1's trip left no routable replica: its queue's migration
    # force-probated replica 0, whose window ends first
    assert records[1][0] == ["probation", "quarantined"]
    assert records[1][1] == 0 and records[1][3]["s"] == "length"


def test_rebuild_keeps_waiting_ids(model):
    got = []
    for dp, Req in zip(routers(model), (JGenRequest, GenRequest)):
        for i in range(5):
            dp.submit(Req(request_id=f"w{i}", prompt_ids=prompt(50 + i, 9),
                          max_new_tokens=3,
                          prefix_key=f"th{i}" if i % 2 else None))
        before = [sorted(r.request_id for r in e.waiting)
                  for e in dp.engines]
        dp.rebuild(dp=1)
        one = [sorted(r.request_id for r in e.waiting) for e in dp.engines]
        dp.rebuild(dp=2)
        two = [sorted(r.request_id for r in e.waiting) for e in dp.engines]
        terminal = drive(dp)
        got.append((before, one, two, dict(dp._affinity), terminal,
                    dp.supervisor.rebuilds, dp.self_check()))
    assert got[1] == got[0]
    assert got[1][1] == [[f"w{i}" for i in range(5)]]
    assert sorted(sum(got[1][2], [])) == [f"w{i}" for i in range(5)]
    assert got[1][6] == []


@pytest.mark.parametrize("dp", [1, 3, 8, 9, 64])
def test_validate_dp_errors(model, dp):
    j, p = routers(model)
    errs = []
    for r in (j, p):
        try:
            r.validate_dp(dp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[1] == errs[0]
    assert (errs[1] is None) == (dp <= 8)


def test_port_refuses_what_it_does_not_port(model):
    _, _, cfg, params = model
    for kw in ({"tp": 2}, {"sp": 2}, {"ep": 2}):
        with pytest.raises(ValueError, match="ROADMAP A9"):
            port.DataParallelEngines(cfg, params, EngineConfig(**ECFG), dp=2,
                                     devices=SLOTS, **kw)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        port.DataParallelEngines(cfg, params, EngineConfig(**ECFG), dp=4,
                                 devices=SLOTS[:2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.DataParallelEngines(cfg, params, EngineConfig(**ECFG), dp=2)


def _signals_over(dp, side):
    if side == "ref":
        from kafka_tpu.llm import TPULLMProvider as Provider
        from kafka_tpu.models.tokenizer import ByteTokenizer
    else:
        from kafka_tpu_torch.llm.torch_provider import TorchLLMProvider \
            as Provider
        from kafka_tpu_torch.models.tokenizer import ByteTokenizer

    provider = Provider(dp, ByteTokenizer(), model_name="dp-test")

    async def go():
        try:
            return provider.signals()
        finally:
            await provider.aclose()

    return asyncio.run(go())


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v) for v in x]
    return type(x).__name__ if x is not None else None


def _first_diff(got, want, path="signals"):
    """The first key path where two snapshots differ, with both values."""
    if isinstance(got, dict) and isinstance(want, dict):
        for k in sorted(set(got) | set(want), key=str):
            if got.get(k) != want.get(k):
                return _first_diff(got.get(k), want.get(k), f"{path}.{k}")
    elif isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return _first_diff(g, w, f"{path}[{i}]")
    return f"{path}: port {got!r} != reference {want!r}"


def test_signals_at_dp2_match(model, monkeypatch):
    """The provider over each router: the same key tree, and the same dp,
    pools, replica rows and supervisor section after the same turns."""
    # the port ships device to device: the reference's device transport
    monkeypatch.setenv("KAFKA_TPU_SHIP_TRANSPORT", "device")
    # Both packages' process-wide state as a fresh process has it under
    # tests/conftest.py: no compile observatory (conftest turns the
    # reference's off; a port server built earlier on the same xdist
    # worker leaves the port's on, and its `compiles` section then
    # differs from the reference's null) and no SLO target override
    from kafka_tpu.runtime import compile_log as rcomp
    from kafka_tpu.runtime import metrics as rmetrics
    from kafka_tpu_torch.runtime import compile_log as pcomp
    from kafka_tpu_torch.runtime import metrics as pmetrics

    for mod in (rcomp, pcomp):
        monkeypatch.setattr(mod, "_OBS", None)
    for mod in (rmetrics, pmetrics):
        monkeypatch.setattr(mod, "_slo_override",
                            {"ttft_ms": None, "tpot_ms": None})
    j, p = routers(model, dp_roles="prefill:1,decode:1",
                   disagg_min_prefill_tokens=8)
    snaps = []
    for dp, Req, side in ((j, JGenRequest, "ref"), (p, GenRequest, "port")):
        for i in range(3):
            dp.submit(Req(request_id=f"s{i}", prompt_ids=prompt(60 + i, 20),
                          max_new_tokens=3, prefix_key=f"t{i}"))
        dp.run_to_completion()
        snaps.append(_signals_over(dp, side))
    want, got = snaps
    # the port's utilization rows carry measured-time fields the JAX
    # engine also has; the trees (names and value types) must agree
    assert _tree(got) == _tree(want), _first_diff(_tree(got), _tree(want))
    for key in ("version", "dp", "supervisor", "batch", "autoscaler",
                "object_tier"):
        assert got[key] == want[key], key
    strip = ("utilization", "batch_occupancy")
    for g, w in zip(got["pools"], want["pools"]):
        assert {k: v for k, v in g.items() if k not in strip} == \
            {k: v for k, v in w.items() if k not in strip}
    assert [r["state"] for r in got["replicas"]] == ["healthy", "healthy"]
    assert [(r["active"], r["waiting"], r["pages_free"])
            for r in got["replicas"]] == [
        (r["active"], r["waiting"], r["pages_free"])
        for r in want["replicas"]]
    assert {k: v for k, v in got["disagg"].items()
            if k != "disagg_ship_staging_bytes"} == \
        {k: v for k, v in want["disagg"].items()
         if k != "disagg_ship_staging_bytes"}


class _GatedRebuild:
    """Holds a router's rebuild at its start until released.  By then the
    resize has drained the started work and parked the worker.  Once
    released it first hands the worker's queued inbox to the router (as
    the worker would on resume), so those requests are WAITING when the
    real rebuild runs and must ride through it."""

    def __init__(self, provider):
        self.provider = provider
        self.real = provider.engine.rebuild
        self.entered = threading.Event()
        self.release = threading.Event()
        provider.engine.rebuild = self

    def __call__(self, **kw):
        self.entered.set()
        assert self.release.wait(60)
        worker = self.provider.worker
        while True:
            try:
                kind, payload = worker._inbox.get_nowait()
            except queue.Empty:
                break
            worker._handle(kind, payload)
        return self.real(**kw)

    async def wait_entered(self):
        assert await asyncio.to_thread(self.entered.wait, 60)
        self.entered.clear()


async def _tokens(events):
    """(token ids, finish reason) of one request's event queue."""
    ids = []
    while True:
        ev = await asyncio.wait_for(events.get(), 60)
        if ev.token_id is not None:
            ids.append(ev.token_id)
        if ev.finished:
            return ids, ev.finish_reason


def _provider_over(dp, side):
    if side == "ref":
        from kafka_tpu.llm import TPULLMProvider as Provider
        from kafka_tpu.models.tokenizer import ByteTokenizer
    else:
        from kafka_tpu_torch.llm.torch_provider import TorchLLMProvider \
            as Provider
        from kafka_tpu_torch.models.tokenizer import ByteTokenizer
    return Provider(dp, ByteTokenizer(), model_name="dp-test")


RESIZE_WORK = {"A": (70, 12), "B": (71, 6), "C": (72, 6), "D": (73, 5)}


def _resize_expected(model):
    _, _, cfg, params = model
    single = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                             kv_dtype=torch.float32, device="cpu")
    return {rid: single.generate(prompt(seed, 9), max_new_tokens=n
                                 ).output_ids
            for rid, (seed, n) in RESIZE_WORK.items()}


def _resize_req(Req, rid):
    seed, n = RESIZE_WORK[rid]
    return Req(request_id=rid, prompt_ids=prompt(seed, 9), max_new_tokens=n,
               prefix_key=f"th-{rid}")


def test_provider_resize_rides_through(model):
    """resize_dp(1) with stream A in flight and B queued behind the parked
    worker, then resize_dp(2) with D queued: A drains before the rebuild
    (clean), B and D ride through it, every stream equals a single
    engine's, and the worker ends alive and unparked, in both
    packages."""
    got = []
    for dp, Req, side in zip(routers(model), (JGenRequest, GenRequest),
                             ("ref", "port")):
        provider = _provider_over(dp, side)

        async def go():
            loop = asyncio.get_running_loop()
            worker = provider.worker
            gate = _GatedRebuild(provider)
            try:
                qa = worker.submit(_resize_req(Req, "A"), loop)
                first = await asyncio.wait_for(qa.get(), 60)
                steps = []
                for n, late in ((1, "B"), (2, "D")):
                    resize = asyncio.ensure_future(provider.resize_dp(n))
                    await gate.wait_entered()
                    queued = worker.submit(_resize_req(Req, late), loop)
                    parked = worker._pause_req.is_set()
                    gate.release.set()
                    clean = await resize
                    gate.release.clear()
                    steps.append((clean, parked, len(dp.engines),
                                  await _tokens(queued)))
                ids, reason = await _tokens(qa)
                return ([first.token_id] + ids, reason, steps,
                        worker.alive, worker._pause_req.is_set())
            finally:
                await provider.aclose()

        got.append(asyncio.run(go()))
    assert got[1] == got[0]
    want = _resize_expected(model)
    a_ids, a_reason, steps, alive, parked_after = got[1]
    assert (a_ids, a_reason) == (want["A"], "length")
    assert [s[:3] for s in steps] == [(True, True, 1), (True, True, 2)]
    assert steps[0][3] == (want["B"], "length")
    assert steps[1][3] == (want["D"], "length")
    assert alive and not parked_after


def test_provider_resize_cancelled_mid_rebuild(model):
    """A resize cancelled while its rebuild runs: the rebuild finishes on
    its own and owns the worker's resume until then (the worker stays
    parked), C queued meanwhile rides through it, and a later resize and
    request find the new topology, in both packages."""
    got = []
    for dp, Req, side in zip(routers(model), (JGenRequest, GenRequest),
                             ("ref", "port")):
        provider = _provider_over(dp, side)

        async def go():
            loop = asyncio.get_running_loop()
            worker = provider.worker
            gate = _GatedRebuild(provider)
            try:
                resize = asyncio.ensure_future(provider.resize_dp(1))
                await gate.wait_entered()
                qc = worker.submit(_resize_req(Req, "C"), loop)
                resize.cancel()
                try:
                    await resize
                    cancelled = False
                except asyncio.CancelledError:
                    cancelled = True
                held = (worker._pause_req.is_set(),
                        provider._rebuild_owns_resume)
                orphan = provider._orphan_rebuild
                gate.release.set()
                await orphan
                after = (len(dp.engines), worker._pause_req.is_set(),
                         provider._rebuild_owns_resume)
                c = await _tokens(qc)
                # the next resize waits the orphan out, then rebuilds
                gate.release.set()
                clean = await provider.resize_dp(2)
                d = await _tokens(worker.submit(_resize_req(Req, "D"), loop))
                return (cancelled, held, after, c, clean, len(dp.engines),
                        d, worker.alive, worker._pause_req.is_set())
            finally:
                await provider.aclose()

        got.append(asyncio.run(go()))
    assert got[1] == got[0]
    want = _resize_expected(model)
    cancelled, held, after, c, clean, n, d, alive, parked = got[1]
    assert cancelled and held == (True, True)
    assert after == (1, False, False)
    assert c == (want["C"], "length") and d == (want["D"], "length")
    assert clean and n == 2 and alive and not parked
