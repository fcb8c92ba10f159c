"""Fault C7 closed: the port's failpoints fire where the reference's do.

The engine-failure cases of tests/test_failpoints.py, run on the port's
tiny CPU engine, its worker and its server, each against the JAX
package's under the same rule:

* the chaos matrix (`engine.step`, `engine.prefill`, `kv.alloc` armed at
  the nth call) gives the reference's terminal events on identical
  weights, every request gets exactly one terminal event, every page
  returns, and the next request's greedy stream equals that of an engine
  that never failed;
* the worker survives `worker.dispatch` faults without hanging a stream;
* `db.write` fails thread-store mutations and leaves reads alone;
* a streamed thread turn through both servers, with each of the five
  sites armed, ends with the reference's events (ids masked), frees its
  pages, and the next turn equals the turn before any fault;
* SITES lists exactly the sites the port fires, and KAFKA_TORCH_FAILPOINTS
  arms them.
"""

import asyncio
import json
import pathlib
import re
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu import failpoints as rfp
from kafka_tpu.llm.worker import EngineWorker as RefWorker
from kafka_tpu.models import ModelConfig as RefCfg
from kafka_tpu.models import init_params as ref_init
from kafka_tpu.runtime import EngineConfig as RefEC
from kafka_tpu.runtime import GenRequest as RefReq
from kafka_tpu.runtime import InferenceEngine as RefEngine
from kafka_tpu_torch import failpoints as pfp
from kafka_tpu_torch.llm.worker import EngineWorker as PortWorker
from kafka_tpu_torch.models import ModelConfig as PortCfg
from kafka_tpu_torch.models import params_from_jax
from kafka_tpu_torch.runtime import EngineConfig as PortEC
from kafka_tpu_torch.runtime import GenRequest as PortReq
from kafka_tpu_torch.runtime import InferenceEngine as PortEngine

MODEL = dict(name="failpoint-test", vocab_size=128, hidden_size=64,
             intermediate_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, dtype="float32")
ENGINE = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=4,
              prefill_buckets=(8, 16, 32))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    rfp.clear()
    pfp.clear()
    yield
    rfp.clear()
    pfp.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jparams = ref_init(RefCfg(**MODEL), jax.random.PRNGKey(7))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def engines(weights, **kw):
    jparams, params = weights
    ref = RefEngine(RefCfg(**MODEL), jparams, RefEC(**{**ENGINE, **kw}),
                    kv_dtype=jnp.float32)
    port = PortEngine(PortCfg(**MODEL), params, PortEC(**{**ENGINE, **kw}),
                      device="cpu")
    return ref, port


def armed(site, *args, **kw):
    """The same rule armed in both packages."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(rfp.armed(site, *args, **kw))
    stack.enter_context(pfp.armed(site, *args, **kw))
    return stack


def run_chaos(eng, Req, n_requests=3, max_new=3, step_cap=500):
    """Drive the engine as the worker does (step, recover on exception)
    until idle; returns {request_id: finish_reason}."""
    for i in range(n_requests):
        eng.submit(Req(request_id=f"r{i}", prompt_ids=[1, 2, 3],
                       max_new_tokens=max_new))
    terminal = {}
    steps = 0
    while eng.has_work and steps < step_cap:
        steps += 1
        try:
            events = eng.step()
        except Exception:
            events = eng.recover_from_failure()
        for ev in events:
            if ev.finished:
                assert ev.request_id not in terminal, (
                    f"{ev.request_id} got TWO terminal events")
                terminal[ev.request_id] = ev.finish_reason
    return terminal


def assert_clean(eng, terminal, n_requests=3):
    assert len(terminal) == n_requests, terminal
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert all(s is None for s in eng.slots)
    assert not eng.self_check(), eng.self_check()
    assert not eng._requests


def both_chaos(weights, rule, n_requests=3, **ekw):
    ref, port = engines(weights, **ekw)
    with armed(*rule[0], **rule[1]):
        want = run_chaos(ref, RefReq, n_requests)
        got = run_chaos(port, PortReq, n_requests)
    return ref, port, want, got


CHAOS_MATRIX = [
    ("engine.step", 1), ("engine.step", 4), ("engine.step", 9),
    ("engine.prefill", 1), ("engine.prefill", 3),
    ("kv.alloc", 1), ("kv.alloc", 2), ("kv.alloc", 3),
]


@pytest.mark.parametrize("site,nth", CHAOS_MATRIX)
def test_fault_gives_the_reference_terminal_events(weights, site, nth):
    ref, port, want, got = both_chaos(
        weights, ((site, "error"), {"nth": nth}))
    assert got == want
    assert_clean(port, got)
    # the engine keeps serving, and serves what a fresh engine serves
    fresh = engines(weights)[1].generate([5, 6, 7], max_new_tokens=3)
    after = port.generate([5, 6, 7], max_new_tokens=3)
    assert after.finish_reason == "length"
    assert after.output_ids == fresh.output_ids
    assert after.output_ids == ref.generate([5, 6, 7],
                                            max_new_tokens=3).output_ids


@pytest.mark.parametrize("rule,kw", [
    (("engine.step", "delay", "0.02"), {"count": 2}),
    (("engine.step", "error"), {"count": 3}),
], ids=["step_delay", "repeated_step_faults"])
def test_delays_and_repeated_faults_converge(weights, rule, kw):
    _, port, want, got = both_chaos(weights, (rule, kw))
    assert got == want
    assert_clean(port, got)


def test_waiting_requests_survive_recovery(weights):
    """A step failure fails the STARTED request; the two queued behind it
    are kept and finish normally, as in the reference."""
    _, port, want, got = both_chaos(
        weights, (("engine.step", "error"), {"nth": 2}), max_batch=1,
        max_parked=0)
    assert got == want
    assert_clean(port, got)
    assert sum(r == "length" for r in got.values()) >= 2, got


def test_env_armed_rule_fires_on_the_port(weights, monkeypatch):
    """KAFKA_TORCH_FAILPOINTS arms the engine's site: before C7 the port
    ignored it."""
    monkeypatch.setenv(pfp.ENV_VAR, "engine.step=error(env-armed):nth=1")
    assert pfp.load_env() == 1
    port = engines(weights)[1]
    port.submit(PortReq(request_id="e", prompt_ids=[1, 2, 3],
                        max_new_tokens=2))
    with pytest.raises(pfp.FailpointError, match="env-armed"):
        port.step()


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def drive_worker(Worker, eng, Req, n, timeout=60):
    """Submit n requests through a started worker; returns each stream's
    (tokens, terminal reason) after exactly one terminal event."""
    worker = Worker(eng).start()

    async def go():
        loop = asyncio.get_running_loop()
        queues = [worker.submit(Req(request_id=f"w{i}", prompt_ids=[1, 2, 3],
                                    max_new_tokens=4), loop)
                  for i in range(n)]

        async def drain(q):
            toks = []
            while True:
                ev = await asyncio.wait_for(q.get(), timeout=timeout)
                if ev.finished:
                    return toks, ev.finish_reason
                toks.append(ev.token_id)

        return await asyncio.gather(*(drain(q) for q in queues))

    try:
        out = asyncio.run(go())
        deadline = time.monotonic() + 10
        # the consumer sees its terminal event a beat before the worker
        # pops the route: quiesce on the route table too
        while (eng.has_work or worker.check_routes()) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.self_check(), eng.self_check()
        assert not worker.check_routes()
        return out
    finally:
        worker.stop()


def test_step_fault_through_the_worker_ends_every_stream(weights):
    _, port = engines(weights)
    with pfp.armed("engine.step", "error", nth=3):
        out = drive_worker(PortWorker, port, PortReq, 3)
    assert len(out) == 3
    assert {r for _, r in out} <= {"length", "stop", "error:engine"}
    assert port.pool.free_pages == port.pool.num_pages - 1


@pytest.mark.parametrize("kw", [{"nth": 2}, {"count": 4}, {}],
                         ids=["nth2", "count4", "unbounded"])
def test_dispatch_faults_never_hang_a_stream(weights, kw):
    """A routing fault drops a token or parks a terminal event; the
    terminal event always arrives (after the paced retries, with the
    failpoint bypassed), as in the reference."""
    ref, port = engines(weights)
    with armed("worker.dispatch", "error", **kw):
        got = drive_worker(PortWorker, port, PortReq, 1)
        # the unbounded rule's retries are paced by the idle worker's 1 s
        # inbox wait: the reference's run would only double the time
        want = drive_worker(RefWorker, ref, RefReq, 1) if kw else got
    assert [r for _, r in got] == [r for _, r in want]
    assert got[0][1] in ("length", "stop")


# ---------------------------------------------------------------------------
# the thread store
# ---------------------------------------------------------------------------


def test_db_write_fails_mutations_and_spares_reads(tmp_path):
    from kafka_tpu.db import LocalDBClient as RefDB
    from kafka_tpu_torch.db import LocalDBClient as PortDB

    async def side(DB, fp, name):
        db = DB(str(tmp_path / f"{name}.db"))
        await db.initialize()
        try:
            await db.create_thread("t1")
            with fp.armed("db.write", "error", "disk gone"):
                with pytest.raises(fp.FailpointError, match="disk gone"):
                    await db.create_thread(thread_id="t-fault")
                with pytest.raises(fp.FailpointError, match="disk gone"):
                    await db.set_thread_config("t1", {"model": "m"})
                # SELECTs are not gated
                seen = (await db.thread_exists("t1"),
                        await db.thread_exists("t-fault"))
            # the store is intact once the fault clears
            await db.create_thread(thread_id="t-ok")
            return seen, await db.thread_exists("t-ok"), \
                await db.get_thread_config("t1")
        finally:
            await db.close()

    want = asyncio.run(side(RefDB, rfp, "ref"))
    got = asyncio.run(side(PortDB, pfp, "port"))
    assert got == want
    assert got[:2] == ((True, False), True)


# ---------------------------------------------------------------------------
# the server: one streamed thread turn per armed site
# ---------------------------------------------------------------------------


WINDOW = dict(max_batch=2, page_size=16, num_pages=2 * 64 + 8,
              max_pages_per_seq=64, prefill_buckets=(256, 1024),
              prefix_cache_pages=0)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both packages' providers over a tiny model with the same weights
    (no tools but the agent's idle tool, a 1024 window, no prefix cache
    so every turn prefills alike), and a fresh-engine probe turn."""
    from kafka_tpu.llm import TPULLMProvider
    from kafka_tpu.models import llama as jllama
    from kafka_tpu.models.config import get_config as jax_get_config
    from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
    from kafka_tpu_torch.llm import TorchLLMProvider
    from kafka_tpu_torch.models import ByteTokenizer, get_config

    jcfg = jax_get_config("tiny-gqa").replace(vocab_size=262,
                                               dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    jeng = RefEngine(jcfg, jparams,
                     RefEC(**WINDOW, attention_backend="xla", flight_ring=0),
                     kv_dtype=jnp.float32)
    cfg = get_config("tiny-gqa").replace(vocab_size=262, dtype="float32")
    eng = PortEngine(cfg, params_from_jax(jax.tree.map(np.asarray, jparams)),
                     PortEC(**WINDOW), kv_dtype=torch.float32, device="cpu")
    provs = {"ref": TPULLMProvider(jeng, JByteTokenizer(), model_name="m"),
             "port": TorchLLMProvider(eng, ByteTokenizer(), model_name="m")}
    # one provider serves every app of the module: its worker outlives
    # each app's cleanup and is stopped at teardown
    closers = {}
    for side, prov in provs.items():
        closers[side] = prov.aclose

        async def _noop():
            return None

        prov.aclose = _noop
    tmp = tmp_path_factory.mktemp("fp-servers")
    probe = {side: asyncio.run(server_turn(side, provs[side], tmp, "probe"))
             for side in provs}
    yield provs, tmp, probe
    for close in closers.values():
        asyncio.run(close())


async def server_turn(side, prov, tmp, thread, rule=None):
    """One streamed thread turn on a fresh app over `prov`, with `rule`
    armed in the side's package for the turn; returns the masked events
    and the engine's free pages once idle."""
    from aiohttp.test_utils import TestClient, TestServer

    if side == "ref":
        from kafka_tpu.db import LocalDBClient as DB
        from kafka_tpu.server import ServingConfig
        from kafka_tpu.server.app import create_app
        fp = rfp
    else:
        from kafka_tpu_torch.db import LocalDBClient as DB
        from kafka_tpu_torch.server import ServingConfig
        from kafka_tpu_torch.server.app import create_app
        fp = pfp
    db_path = str(tmp / f"{side}-{thread}.db")
    app = await create_app(cfg=ServingConfig(db_path=db_path,
                                             system_prompt="terse"),
                           llm_provider=prov, db=DB(db_path), tools=[],
                           mcp_servers=[])
    async with TestClient(TestServer(app)) as c:
        body = {"model": "m", "stream": True, "temperature": 0,
                "max_tokens": 6,
                "messages": [{"role": "user", "content": "say hi"}]}
        if rule is not None:
            fp.configure(*rule[0], **rule[1])
        try:
            r = await c.post(f"/v1/threads/{thread}/chat/completions",
                             json=body)
            raw = await r.text()
        finally:
            fp.clear()
        engine = prov.engine
        deadline = time.monotonic() + 10
        while engine.has_work and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        free = engine.pool.free_pages
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]", raw
    return [mask(json.loads(e)) for e in events[:-1]], free, r.status


def mask(event):
    """An event without completion ids and timestamps; an error names the
    provider ("[tpu]" or "[torch]"), masked too."""
    out = {k: v for k, v in event.items() if k not in ("id", "created")}
    if isinstance(out.get("error"), str):
        out["error"] = re.sub(r"^\[(tpu|torch)\] ", "[provider] ",
                              out["error"])
    return out


SERVER_RULES = {
    "engine.step": (("engine.step", "error", "chaos"), {"nth": 3}),
    "engine.prefill": (("engine.prefill", "error", "chaos"), {"nth": 1}),
    "kv.alloc": (("kv.alloc", "error", "chaos"), {"nth": 1}),
    "worker.dispatch": (("worker.dispatch", "error", "chaos"), {"nth": 3}),
    "db.write": (("db.write", "error", "chaos"), {"nth": 1}),
}


@pytest.mark.parametrize("site", list(SERVER_RULES))
def test_server_turn_under_fault_matches_the_reference(servers, site):
    provs, tmp, probe = servers
    rule = SERVER_RULES[site]
    out = {side: asyncio.run(asyncio.wait_for(
        server_turn(side, provs[side], tmp, f"{site}-x", rule), 120))
        for side in provs}
    (want, _, want_status), (got, free, status) = out["ref"], out["port"]
    assert status == want_status == 200
    assert got == want
    kinds = [e.get("type") for e in got]
    assert kinds.count("agent_done") + kinds.count("error") >= 1
    assert free == provs["port"].engine.pool.num_pages - 1
    # the next turn streams what the engine streamed before any fault
    again = asyncio.run(server_turn("port", provs["port"], tmp,
                                    f"{site}-after"))
    assert again[0] == probe["port"][0] == probe["ref"][0]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def wired_sites():
    import kafka_tpu_torch

    root = pathlib.Path(kafka_tpu_torch.__file__).parent
    wired = set()
    for path in root.rglob("*.py"):
        if path.name == "failpoints.py":
            continue  # the definition module, not a call site
        wired.update(re.findall(r'failpoint\(\s*["\']([^"\']+)["\']',
                                path.read_text()))
    return wired


def test_every_wired_site_is_documented():
    assert wired_sites() - set(pfp.SITES) == set()


def test_every_documented_site_is_wired():
    assert set(pfp.SITES) - wired_sites() == set()
    # nine, plus the seven tier sites, plus the cross-replica ship, plus
    # the tensor-parallel group's two
    assert len(pfp.SITES) == 19


@pytest.mark.cuda
def test_step_failure_with_graphs_in_flight_recovers_on_the_card():
    """On the card: a step fails while fused decode graphs and their
    token copies are in flight.  Every started request ends once with
    error:engine, no token of the dropped work is processed, the pages
    return, and the recaptured graphs (a new memory pool: the old one went
    with its last graph) serve the fresh engine's greedy stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from kafka_tpu_torch.models import get_config, init_params

    cfg = get_config("tiny-gqa").replace(dtype="bfloat16", head_dim=64)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    ecfg = dict(max_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
                prefill_buckets=(16, 32), multi_step=16)

    def fresh():
        return PortEngine(cfg, params, PortEC(**ecfg), device="cuda")

    want = fresh().generate([3, 4, 5], max_new_tokens=20).output_ids
    eng = fresh()
    for i in range(4):
        eng.submit(PortReq(request_id=f"c{i}", prompt_ids=[2 + i] * 5,
                           max_new_tokens=100))
    while not (eng.multi_step_dispatches and eng._pending):
        eng.step()
    drained = {r: len(eng._requests[r].output_ids) for r in eng._requests}
    with pfp.armed("engine.step", "error", nth=1):
        with pytest.raises(pfp.FailpointError):
            eng.step()
    events = eng.recover_from_failure()
    assert sorted(e.request_id for e in events if e.finished) == \
        sorted(drained)
    assert all(e.finish_reason == "error:engine" for e in events
               if e.finished)
    assert not eng._pending and not eng._graphs
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    captures = eng.graph_captures
    assert eng.generate([3, 4, 5], max_new_tokens=20).output_ids == want
    assert eng.graph_captures > captures
