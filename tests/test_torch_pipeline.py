"""kafka_tpu_torch's decode pipeline against the JAX engine's defaults.

The port's engine runs the reference's decode pipeline: device-resident
control state, one step body (a CUDA graph per variant on the card, the
same function eagerly here), fused multi-step dispatch, the fetch_lag
FIFO of asynchronous token copies, off-slot parking, and sampling with
the reference's own per-(seed, position) threefry draw.  Held here on the
CPU, with the same seeded numpy weights in both packages:

* the threefry bits equal `jax.random.bits(fold_in(key(seed), position))`
  exactly, and sampled tokens at fixed logits equal JAX's
  `sample_tokens_per_slot`, any disagreement being a near-tie;
* both engines at the reference's defaults (multi_step=16, fetch_lag=96,
  max_parked=64) give identical greedy streams and finish reasons: fused
  bursts, a stop token mid-burst, preemption, the four parking cases, a
  device-FSM lane riding a burst and a host-masked lane that never fuses;
  sampled streams equal JAX's at multi_step=1;
* with fetches held unready until fetch_lag depth, a stop token found in
  flight, a cancel with entries in flight and a failed step stay
  token-exact against the JAX engine (and the port at multi_step=1,
  fetch_lag=0);
* speculation under the pipeline (speculative_k 4 and 8, multi_step 16)
  keeps its invariants: greedy output equals the JAX engine's without
  speculation, verify writes never touch shared pages, spec_ahead returns
  to 0.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.llm import constrained as jcon
from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.models import llama as jllama
from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from kafka_tpu.ops import sampling as jsampling
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.llm import constrained as pcon
from kafka_tpu_torch.models import (
    ByteTokenizer,
    ModelConfig,
    get_config,
    params_from_jax,
)
from kafka_tpu_torch.ops import sampling as psampling
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-gqa").replace(dtype="float32")
    cfg = get_config("tiny-gqa").replace(dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


# window 96: budgets of 24 leave room for a 16-step burst
SHAPE = dict(max_batch=4, page_size=8, num_pages=96, max_pages_per_seq=12,
             prefill_buckets=(8, 16, 32))


def jax_engine(model, **kw):
    """The JAX engine at its own defaults (multi_step=16, fetch_lag=96,
    max_parked=64), the prefix cache off as in the other parity tests."""
    jcfg, jparams = model[0], model[1]
    ecfg = JEngineConfig(**{**SHAPE, "prefix_cache_entries": 0,
                            "attention_backend": "xla", "flight_ring": 0,
                            **kw})
    return JInferenceEngine(jcfg, jparams, ecfg, kv_dtype=jnp.float32)


def port_engine(model, **kw):
    cfg, params = model[2], model[3]
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")


def outputs(reqs):
    return {r.request_id: (list(r.output_ids), r.finish_reason)
            for r in reqs}


def jax_outputs(model, specs, **kw):
    """The requests ((rid, prompt, kwargs)) through the JAX engine at its
    defaults."""
    eng = jax_engine(model, **kw)
    reqs = [JGenRequest(request_id=rid, prompt_ids=list(p), **a)
            for rid, p, a in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return outputs(reqs)


def run_both(model, specs, **kw):
    """The same requests through both engines at the defaults: (jax
    outputs, port outputs, port engine)."""
    eng = port_engine(model, **kw)
    reqs = [GenRequest(request_id=rid, prompt_ids=list(p), **a)
            for rid, p, a in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return jax_outputs(model, specs, **kw), outputs(reqs), eng


def burst_specs(stops=None, n=4, temps=False):
    specs = []
    for i in range(n):
        a = dict(max_new_tokens=24)
        if temps:
            a.update(temperature=0.9 if i % 2 else 1.3, seed=1000 + i,
                     top_k=(0, 20)[i % 2], top_p=(1.0, 0.9)[i // 2 % 2])
        if stops is not None:
            a["stop_token_ids"] = (stops[i],)
        specs.append((f"ms-{i}", [2 + i, 9, 23, 54, 7], a))
    return specs


# ---------------------------------------------------------------------------
# the threefry draw
# ---------------------------------------------------------------------------


class TestThreefryDraw:
    @pytest.mark.parametrize("vocab", [1000, 128256])
    @pytest.mark.parametrize("position", [0, 2 ** 31 - 1])
    @pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 2 ** 32 - 1])
    def test_bits_equal_jax(self, seed, position, vocab):
        key = jax.random.fold_in(jax.random.key(np.uint32(seed)),
                                 np.int32(position))
        want = np.asarray(jax.random.bits(key, (vocab,), jnp.uint32))
        got = psampling.random_bits(psampling.fold_in_keys(
            torch.tensor([seed]), torch.tensor([position])), vocab)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got[0].numpy(),
                                      want.astype(np.int64))

    def test_rows_draw_with_their_own_keys(self):
        """The engine's [B] seeds and positions: each row's bits are its
        own key's, whatever the other rows hold."""
        seeds = np.array([7, 7, 2 ** 32 - 1, 0], np.uint32)
        positions = np.array([0, 1, 513, 4095], np.int32)
        got = psampling.random_bits(psampling.fold_in_keys(
            torch.from_numpy(seeds.astype(np.int64)),
            torch.from_numpy(positions)), 300).numpy()
        for i, (s, p) in enumerate(zip(seeds, positions)):
            key = jax.random.fold_in(jax.random.key(s), p)
            np.testing.assert_array_equal(
                got[i], np.asarray(jax.random.bits(key, (300,), jnp.uint32)))

    def test_gumbel_is_jax_gumbel(self):
        """uniform's bits-to-float step and -log(-log(u)): equal to
        jax.random.gumbel up to the two libraries' log rounding (a few
        float32 ulps)."""
        key = jax.random.fold_in(jax.random.key(np.uint32(5)), np.int32(3))
        want = np.asarray(jax.random.gumbel(key, (4096,), jnp.float32))
        got = psampling.gumbel_from_bits(psampling.random_bits(
            psampling.fold_in_keys(torch.tensor([5]), torch.tensor([3])),
            4096))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)

    @pytest.mark.parametrize("filtered", [False, True],
                             ids=["plain", "topk_topp"])
    @pytest.mark.parametrize("temp", [0.7, 1.3])
    def test_sampled_tokens_equal_jax(self, temp, filtered):
        """1000 draws at seeded random logits: the port's tokens equal the
        JAX sampler's, except at most one near-tie (the top two perturbed
        scores within 1e-5, where log rounding may order them apart)."""
        rng = np.random.RandomState(int(temp * 10) + filtered)
        N, V = 1000, 512
        logits = (rng.randn(N, V) * 3).astype(np.float32)
        seeds = rng.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
        positions = rng.randint(0, 1 << 20, N).astype(np.int32)
        temps = np.full(N, temp, np.float32)
        top_k = np.full(N, 40 if filtered else 0, np.int32)
        top_p = np.full(N, 0.9 if filtered else 1.0, np.float32)
        keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.key(s), p)
                        )(jnp.asarray(seeds), jnp.asarray(positions))
        want = np.asarray(jsampling.sample_tokens_per_slot(
            jnp.asarray(logits), jsampling.SamplingParams(
                jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p)),
            keys))
        params = psampling.SamplingParams(
            torch.from_numpy(temps), torch.from_numpy(top_k).long(),
            torch.from_numpy(top_p))
        t_seeds = torch.from_numpy(seeds.astype(np.int64))
        t_pos = torch.from_numpy(positions)
        got = psampling.sample_tokens_per_slot(
            torch.from_numpy(logits), params, t_seeds, t_pos).numpy()
        scaled = torch.from_numpy(logits) / temp
        if filtered:
            scaled = psampling._filtered(scaled, params)
        score = scaled + psampling.gumbel_from_bits(psampling.random_bits(
            psampling.fold_in_keys(t_seeds, t_pos), V))
        top2 = torch.topk(score, 2, dim=-1).values.numpy()
        apart = np.nonzero(got != want)[0]
        assert len(apart) <= 1, apart
        for i in apart:
            assert top2[i, 0] - top2[i, 1] <= 1e-5, (i, top2[i])

    def test_greedy_rows_ignore_the_draw(self):
        """Temperature 0 rows are the argmax in any batch mode."""
        logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(1))
        params = psampling.SamplingParams(
            torch.tensor([0.0, 1.0, 0.0, 0.5]), torch.tensor([0, 0, 5, 5]),
            torch.tensor([1.0, 1.0, 0.5, 1.0]))
        got = psampling.sample_tokens_per_slot(
            logits, params, torch.arange(4), torch.arange(4),
            sampled=True, filtered=True)
        assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()


# ---------------------------------------------------------------------------
# both engines at the reference's defaults
# ---------------------------------------------------------------------------


class TestDefaultsParity:
    def test_fused_bursts(self, model):
        jout, tout, eng = run_both(model, burst_specs())
        assert tout == jout
        assert eng.multi_step_dispatches > 0
        assert all(len(t) == 24 for t, _ in tout.values())
        assert eng.self_check() == [] and not eng._pending

    def test_stop_token_mid_burst(self, model):
        """Each lane's stop token is its sixth greedy token: the burst
        overshoots on the device, emission truncates exactly."""
        single = port_engine(model, multi_step=1, fetch_lag=0)
        base = [single.generate(p, **a).output_ids
                for _, p, a in burst_specs()]
        jout, tout, eng = run_both(model, burst_specs(
            stops=[b[5] for b in base]))
        assert tout == jout
        assert all(r == "stop" for _, r in tout.values())
        assert eng.multi_step_dispatches > 0

    def test_preemption_small_pool(self, model):
        rng = np.random.RandomState(4)
        specs = [(f"p{i}", rng.randint(0, 256, n).tolist(),
                  dict(max_new_tokens=22)) for i, n in enumerate((8, 6, 10))]
        jout, tout, eng = run_both(model, specs, num_pages=10,
                                   max_pages_per_seq=8)
        assert tout == jout
        assert eng.preemptions > 0
        assert eng.pool.free_pages == 9

    def test_sampled_lanes_equal_jax_single_step(self, model):
        """Sampled streams (threefry draws) through fused bursts equal the
        JAX engine's at multi_step=1 token for token."""
        specs = burst_specs(temps=True)
        jeng = jax_engine(model, multi_step=1)
        jreqs = [JGenRequest(request_id=r, prompt_ids=list(p), **a)
                 for r, p, a in specs]
        for r in jreqs:
            jeng.submit(r)
        jeng.run_to_completion()
        eng = port_engine(model)
        reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert outputs(reqs) == outputs(jreqs)
        assert eng.multi_step_dispatches > 0


class TestParking:
    """tests/test_engine.py::TestOffSlotAdmission's four cases, each held
    to the JAX engine at the same settings."""

    def test_first_tokens_precede_queue_drain(self, model):
        shape = dict(max_batch=2, max_pages_per_seq=8)
        specs = [(f"p-{i}", [5 + i, 9, 23], dict(max_new_tokens=24))
                 for i in range(8)]
        eng = port_engine(model, **shape)
        reqs = [GenRequest(request_id=r, prompt_ids=p, **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        finished_at_all_started = None
        for _ in range(3000):
            eng.step()
            if all(r.first_token_time is not None for r in reqs):
                finished_at_all_started = sum(r.state == "finished"
                                              for r in reqs)
                break
        assert finished_at_all_started is not None
        assert finished_at_all_started <= 4
        eng.run_to_completion()
        jout, _, _ = run_both(model, specs, **shape)
        assert outputs(reqs) == jout

    def test_parked_rollback_under_page_pressure(self, model):
        specs = [(f"r-{i}", [7 + i, 3], dict(max_new_tokens=30))
                 for i in range(6)]
        jout, tout, eng = run_both(model, specs, max_batch=2, num_pages=14,
                                   max_pages_per_seq=6, park_reserve_pages=2)
        assert tout == jout
        assert all(len(t) == 30 for t, _ in tout.values())
        assert eng.self_check() == []

    def test_cancel_parked_request_frees_pages(self, model):
        shape = dict(max_batch=2, max_pages_per_seq=8)
        out = []
        for make, Req in ((jax_engine, JGenRequest),
                          (port_engine, GenRequest)):
            eng = make(model, **shape)
            reqs = [Req(request_id=f"c-{i}", prompt_ids=[11 + i, 2, 9],
                        max_new_tokens=20) for i in range(5)]
            for r in reqs:
                eng.submit(r)
            for _ in range(500):
                eng.step()
                if eng.parked:
                    break
            victim = eng.parked[0]
            assert eng.cancel(victim.request_id)
            assert victim not in eng.parked and victim.seq is None
            eng.run_to_completion()
            out.append(outputs([r for r in reqs if r is not victim]))
        assert out[1] == out[0]
        assert all(len(t) == 20 for t, _ in out[1].values())

    def test_disabled_parking_keeps_fifo_waiting(self, model):
        shape = dict(max_batch=2, max_pages_per_seq=8, max_parked=0)
        specs = [(f"d-{i}", [4 + i, 8], dict(max_new_tokens=8))
                 for i in range(5)]
        eng = port_engine(model, **shape)
        reqs = [GenRequest(request_id=r, prompt_ids=p, **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert not eng.parked and len(eng.waiting) == 3
        eng.run_to_completion()
        jout, _, _ = run_both(model, specs, **shape)
        assert outputs(reqs) == jout


# ---------------------------------------------------------------------------
# constrained lanes under fusion
# ---------------------------------------------------------------------------

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather",
        "parameters": {"type": "object", "properties": {
            "city": {"type": "string"}}}}},
]
GV = 262


@pytest.fixture(scope="module")
def gmodel():
    kw = dict(name="gfsm-test", vocab_size=GV, hidden_size=64,
              intermediate_size=128, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=16, dtype="float32")
    jcfg = JModelConfig(**kw)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(3))
    return (jcfg, jparams, ModelConfig(**kw),
            params_from_jax(jax.tree.map(np.asarray, jparams)))


GSHAPE = dict(max_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
              prefill_buckets=(16, 32, 64))


def constrained_streams(gmodel, ondevice):
    """A constrained lane beside three free ones, through both engines
    at the defaults; returns (jax outputs, port outputs, port engine,
    bursts the port dispatched while the constrained lane was active)."""
    out, eng, fused = [], None, []
    for side in ("jax", "port"):
        con, Req, tok = ((jcon, JGenRequest, JByteTokenizer()) if side == "jax"
                         else (pcon, GenRequest, ByteTokenizer()))
        if side == "jax":
            jcfg, jparams = gmodel[0], gmodel[1]
            eng = JInferenceEngine(jcfg, jparams, JEngineConfig(
                **GSHAPE, prefix_cache_entries=0, attention_backend="xla",
                flight_ring=0), kv_dtype=jnp.float32)
        else:
            eng = InferenceEngine(gmodel[2], gmodel[3],
                                  EngineConfig(**GSHAPE),
                                  kv_dtype=torch.float32, device="cpu")
            real = eng._dispatch_multi

            def spy(k, eng=eng, real=real):
                fused.append(any(s is not None and s.request_id == "con"
                                 for s in eng.slots))
                return real(k)

            eng._dispatch_multi = spy
        mask = con.ToolCallMaskFn(tok, TOOLS)
        g = (con.compile_tool_call_grammar(tok, TOOLS, vocab_size=GV)
             if ondevice else None)
        reqs = [Req(request_id="con", prompt_ids=tok.encode("call a tool"),
                    max_new_tokens=40, stop_token_ids=tuple(tok.stop_ids),
                    logits_mask_fn=mask, grammar=g)]
        reqs += [Req(request_id=f"f{i}",
                     prompt_ids=tok.encode(f"free text {i}"),
                     max_new_tokens=40) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out.append(outputs(reqs))
    return out[0], out[1], eng, fused


class TestConstrainedUnderFusion:
    def test_device_fsm_lane_rides_fused_bursts(self, gmodel):
        jout, tout, eng, fused = constrained_streams(gmodel, ondevice=True)
        assert tout == jout
        assert any(fused), "the FSM lane never rode a fused burst"
        assert eng.constrained_ondevice_tokens > 0
        assert eng.constrained_host_mask_steps == 0

    def test_host_masked_lane_never_fuses(self, gmodel):
        jout, tout, eng, fused = constrained_streams(gmodel, ondevice=False)
        assert tout == jout
        assert not any(fused)
        assert eng.constrained_host_mask_steps > 0


def test_grammar_registration_refills_fixed_tables():
    """Registering a grammar refills the padded tables in place: the
    tensors a captured step graph reads stay the same objects, and only a
    registration that grows a padded size reallocates them and bumps the
    version the graphs are keyed by.  After every registration the tables
    equal a table set built from scratch over the same grammars."""
    from kafka_tpu_torch.runtime.engine import _GrammarTables

    tok = ByteTokenizer()
    cpu = torch.device("cpu")
    tables = _GrammarTables(GV, cpu)
    grammars, kept = [], 0
    for i in range(_GrammarTables.MAX_LIVE):
        g = pcon.compile_tool_call_grammar(
            tok, TOOLS, force_name="get_weather" if i % 2 else None,
            vocab_size=GV)
        before = (tables.version, tables.args())
        assert tables.register(g) == i
        grammars.append(g)
        grew = before[1][0] is None or \
            tables.token_class.shape != before[1][0].shape or \
            tables.trans.shape != before[1][1].shape
        assert (tables.version != before[0]) == grew
        if not grew:
            kept += 1
            assert all(a is b for a, b in zip(tables.args(), before[1]))
        fresh = _GrammarTables(GV, cpu)
        for h in grammars:
            fresh.register(h)
        for a, b in zip(tables.args(), fresh.args()):
            assert torch.equal(a, b)
    assert kept > 0, "every registration reallocated the tables"


# ---------------------------------------------------------------------------
# the pipeline with fetches held unready
# ---------------------------------------------------------------------------


def held(eng):
    """Entries never report landed: they pop only past fetch_lag depth,
    or when the engine blocks on them (preemption, an idle flush)."""
    eng._entry_ready = lambda entry: False
    return eng


def sync_outputs(model, specs, **kw):
    eng = port_engine(model, multi_step=1, fetch_lag=0, **kw)
    reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
            for r, p, a in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return outputs(reqs)


class TestHeldPipeline:
    def test_stop_token_found_in_flight(self, model):
        base = jax_outputs(model, burst_specs())
        specs = burst_specs(stops=[base[r][0][3] for r, _, _ in
                                   burst_specs()])
        eng = held(port_engine(model, fetch_lag=24))
        reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        want = jax_outputs(model, specs)
        assert all(reason == "stop" for _, reason in want.values())
        assert outputs(reqs) == want
        assert outputs(reqs) == sync_outputs(model, specs)
        # the device ran on past each stop: those tokens were dropped
        assert eng.fetch_pipeline_wasted > 0
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_cancel_with_entries_in_flight(self, model):
        specs = burst_specs()
        eng = held(port_engine(model))
        reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        victim = reqs[1]
        while victim.dispatched - victim.drained < 3:
            eng.step()
        pages = len(victim.seq.pages)
        free = eng.pool.free_pages
        seen = list(victim.output_ids)
        assert eng.cancel(victim.request_id)
        assert victim.seq is None and eng.pool.free_pages == free + pages
        eng.run_to_completion()
        assert victim.output_ids == seen  # nothing emitted after the cancel
        rest = [s for s in specs if s[0] != victim.request_id]
        got = outputs([r for r in reqs if r is not victim])
        assert got == jax_outputs(model, rest)
        assert got == sync_outputs(model, rest)
        assert eng.self_check() == []
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_failed_step_recovers(self, model):
        """A step that raises with entries in flight: every request that
        started gets exactly one terminal error event and no token after
        it; the waiting ones are served afterwards, token-exact."""
        specs = burst_specs(n=6)
        eng = held(port_engine(model, max_batch=3, max_parked=0))
        reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        while not eng._pending or eng._pending_steps < 4:
            eng.step()
        started = {r.request_id for r in reqs if r.state != "waiting"}
        real = eng._run_step

        def boom(*args):
            raise RuntimeError("injected")

        eng._run_step = boom
        with pytest.raises(RuntimeError):
            eng.step()
        events = eng.recover_from_failure()
        assert sorted(e.request_id for e in events if e.finished) == \
            sorted(started)
        assert all(e.finish_reason == "error:engine" for e in events
                   if e.finished)
        eng._run_step = real
        more = []
        while eng.has_work:
            more += eng.step()
        assert not any(e.request_id in started for e in more)
        waiting = [s for s in specs if s[0] not in started]
        assert waiting
        got = outputs([r for r in reqs if r.request_id not in started])
        assert got == jax_outputs(model, waiting, max_batch=3, max_parked=0)
        assert got == sync_outputs(model, waiting, max_batch=3,
                                   max_parked=0)
        assert eng.self_check() == []


# ---------------------------------------------------------------------------
# speculation under the pipeline
# ---------------------------------------------------------------------------

# prompts that repeat themselves, so the n-gram proposer finds anchors
REPEATS = [[3, 4, 5] * 4, [7, 1, 9, 2, 8] * 2, [9, 9, 1, 2] * 3 + [9, 9],
           [6, 6, 6, 6, 6, 6]]


class TestSpeculationUnderPipeline:
    @pytest.mark.parametrize("k", [4, 8])
    def test_greedy_equals_spec_off(self, model, k):
        specs = [(f"s{i}", p, dict(max_new_tokens=40))
                 for i, p in enumerate(REPEATS)]
        jout, _, _ = run_both(model, specs)
        eng = port_engine(model, speculative_k=k)
        reqs = [GenRequest(request_id=r, prompt_ids=list(p), **a)
                for r, p, a in specs]
        for r in reqs:
            eng.submit(r)
        while eng.has_work:
            eng.step()
            for s in eng.slots:
                # a lane with a verify in flight has exactly one entry for
                # it, and nothing else dispatched after it
                if s is not None and s.spec_ahead:
                    assert sum(e.spec is not None and s in e.items
                               for e in eng._pending) == 1
        assert outputs(reqs) == jout
        assert eng.verify_steps > 0 and eng.speculation_accepted_tokens > 0
        assert all(r.spec_ahead == 0 for r in reqs)
        assert eng.self_check() == []

    def test_verify_writes_never_touch_shared_pages(self, model):
        """A thread's second turn shares its first turn's pages through
        the prefix cache and speculates: every verify dispatch's write
        span is checked private (the engine's tripwire), and both turns
        equal the JAX engine's without a prefix cache, and the port's
        with speculation off."""
        first = REPEATS[0] * 2
        jeng = jax_engine(model)
        j1 = jeng.generate(first, max_new_tokens=12).output_ids
        j2 = jeng.generate(first + j1 + [3, 4, 5],
                           max_new_tokens=30).output_ids
        out = {}
        for k in (0, 4):
            eng = port_engine(model, speculative_k=k, prefix_cache_entries=8)
            spans = []
            real = eng._assert_private_tail

            def spy(req, cl, real=real, spans=spans):
                spans.append(cl)
                return real(req, cl)

            eng._assert_private_tail = spy
            t1 = eng.generate(first, max_new_tokens=12, prefix_key="t")
            t2 = eng.generate(first + t1.output_ids + [3, 4, 5],
                              max_new_tokens=30, prefix_key="t")
            assert t2.cached_tokens > 0
            out[k] = (t1.output_ids, t2.output_ids, spans)
            assert eng.self_check() == []
        assert out[4][:2] == (j1, j2)
        assert out[4][:2] == out[0][:2]
        assert out[4][2], "no verify step ran"


def test_serving_config_multi_step(monkeypatch):
    """ServingConfig.multi_step (the reference's name and default) and
    its KAFKA_TORCH_MULTI_STEP override reach the engine."""
    from kafka_tpu_torch.server.app import build_provider
    from kafka_tpu_torch.server.config import ServingConfig

    assert ServingConfig().multi_step == 16
    monkeypatch.setenv("KAFKA_TORCH_MULTI_STEP", "1")
    cfg = ServingConfig.from_env(tiny_model=True, warmup=False,
                                 num_pages=32, max_pages_per_seq=8)
    assert cfg.multi_step == 1
    provider = build_provider(cfg, device="cpu")
    assert provider.engine.ecfg.multi_step == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16])
def test_graph_replay_equals_eager_body(model, k):
    """On the card: a captured k-step graph gives the eager body's tokens
    and logits bit for bit, and a replay adds k x layers to K1's
    counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from kafka_tpu_torch.models import init_params
    from kafka_tpu_torch.ops import kernels

    cfg = get_config("tiny-gqa").replace(dtype="bfloat16", head_dim=64)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    eng = InferenceEngine(cfg, params, EngineConfig(
        **SHAPE, keep_logits=True, multi_step=k), device="cuda")
    for i in range(4):
        eng.submit(GenRequest(request_id=f"g{i}", prompt_ids=[2 + i] * 5,
                              max_new_tokens=40))
    while any(s is None or s.state != "active" for s in eng.slots):
        eng.step()
    eng._refresh_ctl()
    eng._step_buffers(k, True)
    state = [t.clone() for t in (eng._d_last, eng._d_seq_lens)]
    eng._d_run.fill_(True)
    eng._decode_body(k, False, 0, False, True)
    eager = (eng._toks_buf[k].clone(), eng._logits_buf[k].clone())
    eng._d_last.copy_(state[0])
    eng._d_seq_lens.copy_(state[1])
    eng._run_step(k, False, 0, False)  # captures, then replays
    assert torch.equal(eng._toks_buf[k], eager[0])
    assert torch.equal(eng._logits_buf[k], eager[1])
    kernels.reset_launch_counts()
    eng._run_step(k, False, 0, False)
    assert kernels.paged_decode_attention.launches == k * cfg.num_layers
