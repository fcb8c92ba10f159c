"""kafka_tpu_torch constrained tool-call decoding against the JAX package.

The port copies the reference's grammar compiler (llm/constrained.py) and
serves `tool_choice` "required" / a named function the way the reference
does by default: the mask is lowered to a token DFA whose state the engine
masks and advances on the device in its decode and verify steps, with the
host mask fn as the fallback.  Held here, on the CPU, at the small size of
tests/test_grammar_fsm.py (byte tokenizer, vocab 262, 2 layers, width 64):

* the compiled tables equal the JAX compiler's array for array, for the
  reference's tool set and a seeded matrix of random schemas, and the
  host mask fns allow the same ids along a trajectory;
* `grammar_allowed_mask` / `grammar_advance` equal JAX's exactly, on
  states including the -1 sentinel, inactive lanes and budgets inside the
  wrap-up window;
* greedy constrained streams — device FSM and host mask, free and forced
  name — are token-identical to the JAX engine's (speculation off: the
  reference's speculative outcomes depend on host timing), and parse;
* wrap-up, mixed batches, preemption churn, slot reuse, degrades and the
  speculation rule (device-FSM lanes speculate, host-masked lanes do not;
  a proposed illegal token is cut where it stands);
* fault C3: a thread turn through the port's server with "required" or a
  named function ends in the same valid tool call as the JAX server's.
"""

import asyncio
import json
import logging
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.llm import constrained as jcon
from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from kafka_tpu.ops import sampling as jsampling
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.llm import constrained as pcon
from kafka_tpu_torch.models import ByteTokenizer, ModelConfig, params_from_jax
from kafka_tpu_torch.ops import sampling as psampling
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather",
        "parameters": {"type": "object", "properties": {
            "city": {"type": "string"}, "units": {"type": "string"}}}}},
    {"type": "function", "function": {
        "name": "get_time",
        "parameters": {"type": "object", "properties": {}}}},
]
SHAPE = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=16,
             prefill_buckets=(16, 32, 64))
V = 262


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    kw = dict(name="gfsm-test", vocab_size=V, hidden_size=64,
              intermediate_size=128, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=16, dtype="float32")
    jcfg = JModelConfig(**kw)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(3))
    return (jcfg, jparams, ModelConfig(**kw),
            params_from_jax(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module")
def toks():
    return JByteTokenizer(), ByteTokenizer()


def random_tools(rng: random.Random):
    """A random small tool schema (tests/test_grammar_fsm.py's)."""
    def word():
        return "".join(rng.choice("abcdefgh_")
                       for _ in range(rng.randint(2, 8)))

    tools = []
    for _ in range(rng.randint(1, 3)):
        props = {word(): {"type": "string"}
                 for _ in range(rng.randint(0, 3))}
        params = {"type": "object", "properties": props}
        if rng.random() < 0.2:
            params["additionalProperties"] = True
        tools.append({"type": "function",
                      "function": {"name": word(), "parameters": params}})
    return tools


def port_engine(model, **kw):
    cfg, params = model[2], model[3]
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")


def jax_engine(model, **kw):
    jcfg, jparams = model[0], model[1]
    return JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**{**SHAPE, **kw}, multi_step=1, prefix_cache_entries=0,
                      max_parked=0, attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)


def constrained_req(side, tok, tools=TOOLS, force=None, ondevice=True,
                    prompt="call a tool", max_new=120, rid="con", **kw):
    """A constrained request for the port ("port") or JAX ("jax"): the
    side's own mask fn, and its compiled grammar when `ondevice`."""
    con, Req = (pcon, GenRequest) if side == "port" else (jcon, JGenRequest)
    mask = con.ToolCallMaskFn(tok, tools, force_name=force)
    g = (con.compile_tool_call_grammar(tok, tools, force_name=force,
                                       vocab_size=V) if ondevice else None)
    return Req(request_id=rid, prompt_ids=tok.encode(prompt),
               max_new_tokens=max_new, stop_token_ids=tuple(tok.stop_ids),
               logits_mask_fn=mask, grammar=g, **kw)


def run(engine, *reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    return reqs


def text_of(tok, req):
    return tok.decode([t for t in req.output_ids if t not in tok.stop_ids])


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def assert_same_grammar(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for name in ("token_class", "trans", "dist"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.wrap_slack == b.wrap_slack
    assert (a.num_states, a.num_classes, a.eot_id) == \
        (b.num_states, b.num_classes, b.eot_id)


@pytest.mark.parametrize("force", [None, "get_weather", "get_time"])
def test_compiled_tables_equal_jax(toks, force):
    jt, pt = toks
    assert_same_grammar(
        pcon.compile_tool_call_grammar(pt, TOOLS, force_name=force,
                                       vocab_size=V),
        jcon.compile_tool_call_grammar(jt, TOOLS, force_name=force,
                                       vocab_size=V))


@pytest.mark.parametrize("seed", range(6))
def test_compiled_tables_equal_jax_random_schemas(toks, seed):
    rng = random.Random(100 + seed)
    tools = random_tools(rng)
    names = [t["function"]["name"] for t in tools]
    force = rng.choice(names) if seed % 2 else None
    jt, pt = toks
    p = pcon.compile_tool_call_grammar(pt, tools, force_name=force,
                                       vocab_size=V)
    assert p is not None, tools
    assert_same_grammar(p, jcon.compile_tool_call_grammar(
        jt, tools, force_name=force, vocab_size=V))


def test_compiler_fallbacks_match_jax(toks):
    """Over the table cap and an eot outside the vocab: both refuse."""
    jt, pt = toks
    for kw in (dict(vocab_size=V, max_table_bytes=1024),
               dict(vocab_size=16)):
        assert pcon.compile_tool_call_grammar(pt, TOOLS, **kw) is None
        assert jcon.compile_tool_call_grammar(jt, TOOLS, **kw) is None


@pytest.mark.parametrize("force", [None, "get_weather"])
def test_mask_fn_ids_equal_jax_along_a_trajectory(toks, force):
    """The two packages' host mask fns allow the same ids, position by
    position, along a random legal walk, and the compiled rows agree."""
    jt, pt = toks
    rng = random.Random(7)
    pfn = pcon.ToolCallMaskFn(pt, TOOLS, force_name=force)
    jfn = jcon.ToolCallMaskFn(jt, TOOLS, force_name=force)
    g = pcon.compile_tool_call_grammar(pt, TOOLS, force_name=force,
                                       vocab_size=V)
    out, state = [], 0
    for _ in range(150):
        ids = sorted(int(x) for x in pfn(out))
        assert ids == sorted(int(x) for x in jfn(out))
        assert set(ids) == set(np.nonzero(g.allowed_row(state))[0].tolist())
        if ids == [pt.eot_id]:
            return
        t = rng.choice(ids)
        out.append(t)
        state = g.walk([t], start=state)
        assert state >= 0
    pytest.fail("walk never reached done")


def test_env_gate_and_cache(toks, monkeypatch):
    """KAFKA_TORCH_GRAMMAR_ONDEVICE=0 keeps the host path; compiles are
    cached per (schema, vocab); custom mask fns are never lowered."""
    pt = toks[1]
    monkeypatch.setenv("KAFKA_TORCH_GRAMMAR_ONDEVICE", "0")
    assert not pcon.grammar_ondevice_enabled()
    assert pcon.compile_grammar_for_mask_fn(
        pcon.ToolCallMaskFn(pt, TOOLS), V) is None
    monkeypatch.delenv("KAFKA_TORCH_GRAMMAR_ONDEVICE")
    g1 = pcon.compile_grammar_for_mask_fn(pcon.ToolCallMaskFn(pt, TOOLS), V)
    g2 = pcon.compile_grammar_for_mask_fn(pcon.ToolCallMaskFn(pt, TOOLS), V)
    assert g1 is not None and g1 is g2
    assert pcon.compile_grammar_for_mask_fn(lambda out: None, V) is None
    assert pcon.background_deferred() is False


# ---------------------------------------------------------------------------
# the device mask / advance ops
# ---------------------------------------------------------------------------


def op_inputs(toks, seed):
    """Two grammars registered in the engine's padded table set and a
    batch of lane states: -1 sentinels, inactive lanes, and budgets
    inside and outside the wrap window."""
    from kafka_tpu_torch.runtime.engine import _GrammarTables

    pt = toks[1]
    gs = [pcon.compile_tool_call_grammar(pt, TOOLS, vocab_size=V),
          pcon.compile_tool_call_grammar(pt, TOOLS, force_name="get_time",
                                         vocab_size=V)]
    tables = _GrammarTables(V, torch.device("cpu"))
    assert [tables.register(g) for g in gs] == [0, 1]
    tc, trans, dist, slack = (t.numpy() for t in tables.args())
    rng = np.random.RandomState(seed)
    B = 16
    gidx = rng.randint(0, 2, B).astype(np.int32)
    state = np.array([tables.offsets[g] + rng.randint(0, gs[g].num_states)
                      for g in gidx], np.int32)
    state[:3] = -1
    dd = dist[np.maximum(state, 0)]
    budget = np.where(rng.rand(B) < 0.5, dd + rng.randint(0, 6, B),
                      dd + 50).astype(np.int32)
    active = rng.rand(B) < 0.8
    active[0] = True
    tokens = rng.randint(0, V, B).astype(np.int32)
    return state, gidx, budget, active, tokens, tc, trans, dist, slack


@pytest.mark.parametrize("seed", range(4))
def test_grammar_ops_equal_jax(toks, seed):
    state, gidx, budget, active, tokens, tc, trans, dist, slack = \
        op_inputs(toks, seed)
    want_mask = np.asarray(jsampling.grammar_allowed_mask(
        *map(jnp.asarray, (state, gidx, budget, active, tc, trans, dist,
                           slack))))
    got_mask = psampling.grammar_allowed_mask(
        *map(torch.from_numpy, (state, gidx, budget, active, tc, trans,
                                dist)), torch.tensor(slack))
    assert got_mask.dtype == torch.bool
    assert np.array_equal(got_mask.numpy(), want_mask)
    assert got_mask[:3].all() and got_mask[~torch.from_numpy(active)].all()
    # a legal token of each lane's mask, and the random tokens (mostly
    # illegal: parks the lane at -1)
    legal = np.array([np.nonzero(r)[0][0] for r in want_mask], np.int32)
    for tk in (legal, tokens):
        want = np.asarray(jsampling.grammar_advance(
            *map(jnp.asarray, (state, gidx, tk, active, tc, trans))))
        got = psampling.grammar_advance(
            *map(torch.from_numpy, (state, gidx, tk, active, tc, trans)))
        assert np.array_equal(got.numpy(), want)


def test_fully_false_row_falls_back_to_unconstrained():
    """An over-tight (all-False) row samples as if unmasked, as the JAX
    sampler's docstring says (kafka_tpu/ops/sampling.py:199-201)."""
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(3, 50, dtype=torch.bool)
    mask[1, 7] = True
    params = psampling.SamplingParams.make(3)
    got = psampling.sample_tokens_per_slot(logits, params, [0] * 3, [0] * 3,
                                           allowed_mask=mask)
    assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()
    assert got[1] == 7


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

FORCES = [None, "get_weather", "get_time"]


@pytest.fixture(scope="module")
def jax_streams(model, toks):
    """The JAX engine's greedy constrained streams, per forced name, on
    its device-FSM path (key `f`) and its host-mask path (`(f, "host")`)."""
    jt = toks[0]
    out = {}
    for f in FORCES:
        for ondevice in (True, False):
            req, = run(jax_engine(model), constrained_req(
                "jax", jt, force=f, ondevice=ondevice))
            out[f if ondevice else (f, "host")] = list(req.output_ids)
    return out


def wrap_free(g, stream, budget=120):
    """Tokens of `stream` emitted before either path's wrap-up window:
    while budget_left > dist + wrap_slack (the compiled slack is >= the
    host mask's 4 characters) the two paths' masks are provably equal."""
    state = 0
    for i, t in enumerate(stream):
        if budget - i <= int(g.dist[state]) + g.wrap_slack:
            return i
        state = g.walk([t], start=state)
        if state < 0:
            return i + 1
    return len(stream)


@pytest.mark.parametrize("ondevice", [True, False], ids=["fsm", "host"])
@pytest.mark.parametrize("force", FORCES)
def test_greedy_stream_equals_jax_engine(model, toks, jax_streams, force,
                                         ondevice):
    pt = toks[1]
    eng = port_engine(model)
    req, = run(eng, constrained_req("port", pt, force=force,
                                    ondevice=ondevice))
    assert req.output_ids == jax_streams[force if ondevice
                                         else (force, "host")]
    # the two paths agree wherever neither is wrapping up (wrap timing
    # differs in the reference too: the compiled slack is jump-aware)
    g = pcon.compile_tool_call_grammar(pt, TOOLS, force_name=force,
                                       vocab_size=V)
    n = wrap_free(g, jax_streams[force])
    assert n >= 20  # non-vacuous
    assert req.output_ids[:n] == jax_streams[force][:n]
    assert req.finish_reason == "stop"
    assert pcon.validate_tool_call_json(text_of(pt, req), TOOLS)
    if force:
        assert json.loads(text_of(pt, req))["name"] == force
    if ondevice:
        assert eng.constrained_ondevice_tokens == len(req.output_ids)
        assert eng.constrained_host_mask_steps == 0
    else:
        assert eng.constrained_ondevice_tokens == 0
        assert eng.constrained_host_mask_steps == len(req.output_ids)


@pytest.mark.parametrize("seed", range(3))
def test_random_schema_streams_equal_jax_engine(model, toks, seed):
    """Random schemas, greedy: each of the port's paths equals the JAX
    engine's same path, and the two agree outside the wrap-up window."""
    rng = random.Random(42 + seed)
    tools = random_tools(rng)
    force = rng.choice([t["function"]["name"] for t in tools]) \
        if seed % 2 else None
    jt, pt = toks
    got = {}
    for ondevice in (True, False):
        want, = run(jax_engine(model), constrained_req(
            "jax", jt, tools=tools, force=force, ondevice=ondevice))
        got[ondevice], = run(port_engine(model), constrained_req(
            "port", pt, tools=tools, force=force, ondevice=ondevice))
        assert got[ondevice].output_ids == list(want.output_ids), ondevice
    assert pcon.validate_tool_call_json(text_of(pt, got[True]), tools)
    g = got[True].grammar
    n = wrap_free(g, got[True].output_ids)
    assert n >= 10
    assert got[True].output_ids[:n] == got[False].output_ids[:n]


@pytest.mark.parametrize("budget,seed", [(48, 11), (56, 13), (64, 12)])
def test_tight_budget_still_parses(model, toks, budget, seed):
    """Device-side wrap-up closes the JSON inside a tight budget, sampled
    at temperature 2."""
    pt = toks[1]
    req, = run(port_engine(model), constrained_req(
        "port", pt, prompt="go", max_new=budget, temperature=2.0, seed=seed))
    assert len(req.output_ids) <= budget
    assert pcon.validate_tool_call_json(text_of(pt, req), TOOLS)


def test_mixed_batch_free_lane_unperturbed(model, toks, jax_streams):
    """A free lane beside a constrained one gives its solo (and the JAX
    engine's) tokens; the constrained lane gives its solo stream."""
    jt, pt = toks
    prompt = pt.encode("stream me a story")
    solo = port_engine(model).generate(prompt, max_new_tokens=48)
    jsolo = jax_engine(model).generate(prompt, max_new_tokens=48)
    assert solo.output_ids == list(jsolo.output_ids)
    free = GenRequest(request_id="free", prompt_ids=prompt,
                      max_new_tokens=48)
    con = constrained_req("port", pt)
    run(port_engine(model), free, con)
    assert free.output_ids == solo.output_ids
    assert con.output_ids == jax_streams[None]


@pytest.mark.parametrize("ondevice", [True, False], ids=["fsm", "host"])
def test_preemption_churn_keeps_the_stream(model, toks, jax_streams,
                                           ondevice):
    """The constrained lane is preempted by a long free lane (the pool
    runs out) and re-derives its FSM state by replaying its output."""
    pt = toks[1]
    eng = port_engine(model, num_pages=18)
    free = GenRequest(request_id="free", prompt_ids=[5] * 180,
                      max_new_tokens=60)
    con = constrained_req("port", pt, ondevice=ondevice)
    run(eng, free, con)
    assert eng.preemptions >= 1
    assert con.output_ids == jax_streams[None if ondevice
                                         else (None, "host")]
    assert (eng.constrained_host_mask_steps == 0) == ondevice


def test_slot_reuse_resets_the_fsm_lane(model, toks):
    """A free lane seated where a cancelled FSM lane ran must not inherit
    its automaton state."""
    pt = toks[1]
    eng = port_engine(model, max_batch=1)
    eng.submit(constrained_req("port", pt))
    for _ in range(6):
        eng.step()
    assert int(eng._fsm[0]) >= 0
    eng.cancel("con")
    assert int(eng._fsm[0]) == -1
    solo = port_engine(model, max_batch=1).generate(
        pt.encode("plain text"), max_new_tokens=24)
    free = GenRequest(request_id="free", prompt_ids=pt.encode("plain text"),
                      max_new_tokens=24)
    run(eng, free)
    assert free.output_ids == solo.output_ids


def test_grammar_that_cannot_register_degrades_to_host_mask(
        model, toks, jax_streams, monkeypatch):
    """A table set over the KAFKA_TORCH_GRAMMAR_TABLE_MB budget: the lane
    falls back to the host mask and still gives the same stream."""
    pt = toks[1]
    req = constrained_req("port", pt)
    assert req.grammar is not None
    monkeypatch.setenv("KAFKA_TORCH_GRAMMAR_TABLE_MB", "0.001")
    eng = port_engine(model)
    run(eng, req)
    assert req.grammar is None and eng.constrained_degrades == 1
    assert eng.constrained_host_mask_steps > 0
    # the first token was sampled from the compiled row (the degrade
    # happens when the lane joins the decode batch), the rest host-masked
    assert req.output_ids == jax_streams[(None, "host")]


def test_overtight_rows_counted_and_logged_once(model, caplog):
    """A mask fn returning an empty allow-list degrades the row to
    unconstrained; every such row is counted, the log says it once."""
    eng = port_engine(model)

    def tight(out):
        return [] if 1 <= len(out) <= 3 else None

    req = GenRequest(request_id="ot", prompt_ids=[3] * 4, max_new_tokens=8,
                     logits_mask_fn=tight)
    with caplog.at_level(logging.WARNING, logger="kafka_tpu_torch.engine"):
        run(eng, req)
    assert req.finish_reason == "length" and len(req.output_ids) == 8
    assert eng.constrained_mask_overtight == 3
    assert sum("over-tight constrained mask" in r.getMessage()
               for r in caplog.records) == 1


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------

SPEC = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
            prefill_buckets=(8, 16, 32, 64))


class ForcedSpeculator:
    """Scripted proposal fn (deterministic engagement)."""

    def __init__(self, fn):
        self._fn = fn
        self.hist = []
        self.observed = []

    def push(self, token):
        self.hist.append(token)

    def propose(self, k_max):
        return list(self._fn(self.hist, k_max))[:max(0, k_max)]

    def observe(self, accepted, proposed):
        self.observed.append((accepted, proposed))


def test_device_fsm_lanes_speculate_host_masked_lanes_do_not(model, toks):
    """The speculation rule: a device-FSM lane gets a speculator at
    submit, a host-masked lane does not (the port's submit used to give
    every lane one)."""
    pt = toks[1]
    eng = port_engine(model, speculative_k=4, **SPEC)
    fsm = constrained_req("port", pt, rid="g")
    host = constrained_req("port", pt, rid="h", ondevice=False)
    eng.submit(fsm)
    eng.submit(host)
    assert fsm.spec is not None and host.spec is None
    eng.run_to_completion()
    n = wrap_free(fsm.grammar, fsm.output_ids)
    assert n >= 20 and fsm.output_ids[:n] == host.output_ids[:n]


@pytest.mark.parametrize("ondevice", [True, False], ids=["fsm", "host"])
def test_greedy_equal_with_speculation_on_and_off(model, toks, jax_streams,
                                                  ondevice):
    pt = toks[1]
    outs = {}
    for k in (0, 4):
        eng = port_engine(model, speculative_k=k, **SPEC)
        req, = run(eng, constrained_req("port", pt, ondevice=ondevice))
        outs[k] = req.output_ids
    assert outs[0] == outs[4] == jax_streams[None if ondevice
                                             else (None, "host")]


def test_oracle_proposals_accepted_through_the_fsm(model, toks, jax_streams):
    """Proposals of the sequential stream are accepted through the
    per-position FSM masks; the stream stays the sequential one."""
    pt = toks[1]
    base = jax_streams[None]
    eng = port_engine(model, speculative_k=4, **SPEC)
    req = constrained_req("port", pt)
    eng.submit(req)
    # a speculator installed after submit sees the output only
    req.spec = ForcedSpeculator(lambda hist, k: base[len(hist):len(hist) + k])
    eng.run_to_completion()
    assert req.output_ids == base
    assert eng.speculation_proposed_tokens > len(base) // 2
    assert eng.speculation_accepted_tokens == eng.speculation_proposed_tokens


def test_illegal_proposal_cut_and_fsm_state_follows_the_walk(
        model, toks, jax_streams):
    """A proposer whose third candidate is a token the grammar forbids
    there: the run is cut at that position every time, and after every
    step the lane's device FSM state equals the sequential walk of its
    output."""
    pt = toks[1]
    base = jax_streams[None]
    eng = port_engine(model, speculative_k=4, **SPEC)
    req = constrained_req("port", pt)
    g = req.grammar
    eng.submit(req)

    def cands(hist, k):
        n = len(hist)
        out = list(base[n:n + k])
        if len(out) >= 3:
            state = g.walk(base[:n + 2])
            row = g.allowed_row(state)
            out[2] = int(np.nonzero(~row)[0][0])  # illegal here
        return out

    req.spec = ForcedSpeculator(cands)
    while req.state != "finished":
        eng.step()
        if req.state == "active":
            off = eng._grammars.offsets[eng._grammars.register(g)]
            assert int(eng._fsm[req.slot]) == off + g.walk(req.output_ids)
            assert int(eng._budget[req.slot]) == \
                req.max_new_tokens - req.dispatched
    assert req.output_ids == base
    cut = [(a, p) for a, p in req.spec.observed if p >= 3]
    assert cut and all(a == 2 for a, _ in cut)


# ---------------------------------------------------------------------------
# fault C3: tool_choice through the server
# ---------------------------------------------------------------------------

WINDOW = dict(max_batch=2, page_size=16, num_pages=2 * 128 + 8,
              max_pages_per_seq=128, prefill_buckets=(256, 1024))


def add(a: int = 0, b: int = 0):
    return a + b


ADD_SCHEMA = {"type": "object", "properties": {
    "a": {"type": "integer"}, "b": {"type": "integer"}}}


def providers(model):
    from kafka_tpu.llm import TPULLMProvider
    from kafka_tpu_torch.llm import TorchLLMProvider

    jeng = JInferenceEngine(
        model[0], model[1],
        JEngineConfig(**WINDOW, multi_step=1, max_parked=0,
                      attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)
    eng = InferenceEngine(model[2], model[3], EngineConfig(**WINDOW),
                          kv_dtype=torch.float32, device="cpu")
    return (TPULLMProvider(jeng, JByteTokenizer(), model_name="m"),
            TorchLLMProvider(eng, ByteTokenizer(), model_name="m"))


async def thread_turn(app, **body):
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as c:
        r = await c.post("/v1/threads/c3/chat/completions", json={
            "model": "m", "stream": True, "temperature": 0,
            "max_tokens": 40, **body,
            "messages": [{"role": "user", "content": "add 2 and 3"}]})
        assert r.status == 200, await r.text()
        raw = await r.text()
    return [json.loads(line[6:]) for line in raw.splitlines()
            if line.startswith("data: {")]


@pytest.mark.parametrize("tool_choice", [
    "required", {"type": "function", "function": {"name": "add"}}],
    ids=["required", "named"])
def test_tool_choice_turn_ends_in_the_reference_tool_call(
        model, tmp_path, tool_choice):
    """C3: `tool_choice` now constrains the port.  "required" with no tools
    but the agent's idle tool, and a named `add`: the first model turn of
    the port's server ends `finish_reason: "tool_calls"` with arguments
    the schema accepts, token for token the JAX server's, through the
    device FSM."""
    from kafka_tpu.db import LocalDBClient as RefDB
    from kafka_tpu.server import ServingConfig as RefServingConfig
    from kafka_tpu.server.app import create_app as ref_create_app
    from kafka_tpu.tools import Tool as RefTool
    from kafka_tpu_torch.agents import IDLE_TOOL
    from kafka_tpu_torch.db import LocalDBClient as PortDB
    from kafka_tpu_torch.server import ServingConfig as PortServingConfig
    from kafka_tpu_torch.server.app import create_app as port_create_app
    from kafka_tpu_torch.tools import Tool as PortTool

    named = isinstance(tool_choice, dict)
    jprov, pprov = providers(model)
    assert pprov.build_tool_call_mask_fn([IDLE_TOOL], "required") is not None
    assert pprov.get_model_info()["grammar_ondevice"] is True
    seen = {}
    for side, prov in (("ref", jprov), ("port", pprov)):
        seen[side] = []
        real = prov.engine.submit
        prov.engine.submit = (lambda req, _s=seen[side], _r=real:
                              (_s.append(req), _r(req))[1])

    async def go():
        out = {}
        for side, prov in (("ref", jprov), ("port", pprov)):
            db_path = str(tmp_path / f"{side}.db")
            Tool = RefTool if side == "ref" else PortTool
            tools = [Tool(name="add", description="add two integers",
                          handler=add, parameters=ADD_SCHEMA)] \
                if named else []
            if side == "ref":
                app = await ref_create_app(
                    cfg=RefServingConfig(db_path=db_path,
                                         system_prompt="terse"),
                    llm_provider=prov, db=RefDB(db_path), tools=tools,
                    mcp_servers=[])
            else:
                app = await port_create_app(
                    cfg=PortServingConfig(db_path=db_path,
                                          system_prompt="terse"),
                    llm_provider=prov, db=PortDB(db_path), tools=tools,
                    mcp_servers=[])
            out[side] = await thread_turn(app, tool_choice=tool_choice)
        return out

    out = asyncio.run(go())
    ref, port = seen["ref"][0], seen["port"][0]
    assert port.logits_mask_fn is not None and port.grammar is not None
    assert list(port.prompt_ids) == list(ref.prompt_ids)
    assert list(port.output_ids) == list(ref.output_ids)
    assert pprov.engine.constrained_ondevice_tokens >= len(port.output_ids)
    assert pprov.engine.constrained_host_mask_steps == 0
    tool_defs = [IDLE_TOOL] + ([{"type": "function", "function": {
        "name": "add", "parameters": ADD_SCHEMA}}] if named else [])
    text = ByteTokenizer().decode(
        [t for t in port.output_ids if t not in ByteTokenizer().stop_ids])
    assert pcon.validate_tool_call_json(text, tool_defs), text
    calls = {}
    for side in ("ref", "port"):
        chunks = [e["choices"][0] for e in out[side]
                  if e.get("object") == "chat.completion.chunk"
                  and e.get("choices")]
        assert "tool_calls" in [c.get("finish_reason") for c in chunks]
        calls[side] = [tc["function"] for c in chunks
                       for tc in c.get("delta", {}).get("tool_calls") or []]
    assert calls["port"] == calls["ref"]
    assert calls["port"][0]["name"] == ("add" if named else "idle")
