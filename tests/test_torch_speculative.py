"""kafka_tpu_torch draft-free speculative decoding, held to invariants.

The JAX package's own speculative engine is not the reference here (its
verify path is red in this suite); the port is held to what speculation
must preserve:

* with speculative_k = 4 the greedy stream equals the JAX engine's stream
  with speculation OFF, token for token — with the organic n-gram
  proposer, an oracle proposer (everything accepted), an adversarial one
  (everything rejected), under preemption, and with a stop token, the
  token budget or the window cutting inside an accepted run;
* sampled output (temperature > 0) equals the port's own output with
  speculation off (every position draws with the sequential path's
  (seed, position) generator);
* verify writes never touch radix-shared prefix pages.

Also: the verify forward (S = K+1 queries per lane over the paged pool)
against the JAX forward on the same view, f32 logits atol 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import llama as jllama
from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.models import (
    KVCache,
    PagedView,
    forward,
    get_config,
    params_from_jax,
)
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime.engine import kernel_backend_problems
from kafka_tpu_torch.runtime.speculative import LaneSpeculator

SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))
K = 4


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


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


# prompts that repeat themselves, so the n-gram proposer finds anchors
REPEATS = [[3, 4, 5] * 4, prompts(0, [7])[0] * 2, [9, 9, 1, 2] * 3 + [9, 9]]
MIXED = REPEATS + prompts(1, [14, 5])


def run_jax(model, reqs, **shape):
    """The JAX engine with speculation off: {rid: (tokens, reason)}."""
    jcfg, jparams, _, _ = model
    eng = JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**{**SHAPE, **shape}, multi_step=1,
                      prefix_cache_entries=0, max_parked=0,
                      attention_backend="xla", flight_ring=0),
        kv_dtype=jnp.float32)
    for rid, p, kw in reqs:
        eng.submit(JGenRequest(request_id=rid, prompt_ids=list(p), **kw))
    return {rid: (list(r.output_ids), r.finish_reason)
            for rid, r in eng.run_to_completion().items()}


def run_port(model, reqs, spec=None, **shape):
    """The port's engine; spec(rid, reference) may install a scripted
    proposer.  Returns ({rid: (tokens, reason)}, engine)."""
    _, _, cfg, params = model
    eng = InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **shape}),
                          kv_dtype=torch.float32, device="cpu")
    for rid, p, kw in reqs:
        req = GenRequest(request_id=rid, prompt_ids=list(p), **kw)
        eng.submit(req)
        if spec is not None:
            req.spec = spec(rid)
    done = eng.run_to_completion()
    return {rid: (list(r.output_ids), r.finish_reason)
            for rid, r in done.items()}, eng


class ForcedSpeculator:
    """Scripted stand-in for LaneSpeculator: proposes fn(history) — the
    verify path engages whatever the model emits."""

    def __init__(self, fn):
        self._fn = fn
        self.hist = []
        self.observed = []

    def push(self, token):
        self.hist.append(token)

    def propose(self, k_max):
        return list(self._fn(self.hist))[:max(0, k_max)]

    def observe(self, accepted, proposed):
        self.observed.append((accepted, proposed))


def oracle(ref):
    """Proposes the reference continuation: every candidate accepted."""
    return lambda rid: ForcedSpeculator(
        lambda hist: ref[rid][0][len(hist):len(hist) + K])


@pytest.fixture(scope="module")
def mixed_ref(model):
    reqs = [(f"m{i}", p, dict(max_new_tokens=18))
            for i, p in enumerate(MIXED)]
    return reqs, run_jax(model, reqs)


class TestGreedyEqualsSpecOff:
    def test_ngram_proposer(self, model, mixed_ref):
        reqs, ref = mixed_ref
        got, eng = run_port(model, reqs, speculative_k=K)
        assert got == ref
        assert eng.speculation_proposed_tokens > 0
        assert eng.self_check() == []
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_oracle_proposals_all_accepted(self, model, mixed_ref):
        reqs, ref = mixed_ref
        got, eng = run_port(model, reqs, spec=oracle(ref), speculative_k=K)
        assert got == ref
        assert eng.speculation_accepted_tokens == \
            eng.speculation_proposed_tokens > 0
        # five lanes of 18 tokens in far fewer steps than 18 per lane
        assert eng.verify_steps < 18

    @pytest.mark.parametrize("k", [8, 16])
    def test_oracle_proposals_past_32_rows(self, model, mixed_ref, k):
        """speculative_k 8 and 16 at G 4: 36 and 68 query rows per kv head
        in each verify step, past the 32 the CUDA kernel once held (fault
        C4); the greedy stream still equals the JAX engine's with
        speculation off."""
        reqs, ref = mixed_ref

        def spec(rid):
            return ForcedSpeculator(
                lambda hist: ref[rid][0][len(hist):len(hist) + k])

        got, eng = run_port(model, reqs, spec=spec, speculative_k=k)
        assert got == ref
        assert eng.speculation_accepted_tokens == \
            eng.speculation_proposed_tokens > 0
        assert eng.self_check() == []

    def test_adversarial_proposals_all_rejected(self, model, mixed_ref):
        reqs, ref = mixed_ref

        def wrong(rid):
            return ForcedSpeculator(
                lambda hist: [(t + 1) % 256 for t in
                              ref[rid][0][len(hist):len(hist) + K]])

        got, eng = run_port(model, reqs, spec=wrong, speculative_k=K)
        assert got == ref
        assert eng.speculation_proposed_tokens > 0
        assert eng.speculation_accepted_tokens == 0
        assert eng.self_check() == []

    @pytest.mark.parametrize("limit", ["stop", "max_new_tokens", "window"])
    def test_limit_cuts_inside_an_accepted_run(self, model, limit):
        """With every candidate accepted, a stop token, the token budget
        or the window must end the stream exactly where plain decode
        does — in the middle of a run."""
        p = REPEATS[0]
        kw = dict(max_new_tokens=30)
        if limit == "stop":
            base = run_jax(model, [("s", p, kw)])["s"][0]
            kw["stop_token_ids"] = (base[6],)
        elif limit == "max_new_tokens":
            kw["max_new_tokens"] = 7
        else:
            kw["max_new_tokens"] = 60  # past the 64-slot window
        reqs = [("s", p, kw)]
        ref = run_jax(model, reqs)
        # the oracle proposes past the end of the reference stream too
        long_ref = {"s": (ref["s"][0] + [1] * K, None)}
        got, eng = run_port(model, reqs, spec=oracle(long_ref),
                            speculative_k=K)
        assert got == ref
        want = {"stop": "stop", "max_new_tokens": "length",
                "window": "length"}[limit]
        assert got["s"][1] == want
        if limit == "window":
            assert len(p) + len(got["s"][0]) == SHAPE["max_pages_per_seq"] \
                * SHAPE["page_size"]
        assert eng.speculation_accepted_tokens > 0
        if limit == "stop":
            # the stop token cut a verify step's accepted run short: the
            # tokens that step produced after it were dropped (the first
            # decode step after the prefill is a plain one — a lane
            # proposes only once its prefill token is drained)
            assert eng.fetch_pipeline_wasted > 0

    def test_preemption_between_verify_steps(self, model):
        """Ten pages for three growing lanes that speculate: lanes are
        preempted and re-prefilled between verify steps, and the streams
        still match."""
        reqs = [(f"p{i}", p, dict(max_new_tokens=22))
                for i, p in enumerate(prompts(4, [8, 6, 10]))]
        ref = run_jax(model, reqs, num_pages=10)
        got, eng = run_port(model, reqs, spec=oracle(ref), num_pages=10,
                            speculative_k=K)
        assert got == ref
        assert eng.preemptions > 0
        assert eng.speculation_accepted_tokens > 0
        assert eng.self_check() == []
        assert eng.pool.free_pages == 9


def test_sampled_output_equals_spec_off(model):
    reqs = [(f"t{i}", p, dict(max_new_tokens=16, temperature=0.9, top_k=40,
                              seed=100 + i))
            for i, p in enumerate(REPEATS)]
    off, _ = run_port(model, reqs)
    on, eng = run_port(model, reqs, spec=oracle(off), speculative_k=K)
    assert on == off
    assert eng.speculation_accepted_tokens > 0
    organic, eng = run_port(model, reqs, speculative_k=K)
    assert organic == off


def test_verify_writes_never_touch_shared_pages(model):
    """Thread B reuses thread A's radix-cached prefix while speculating:
    every verify write span is private (refcount 1, unknown to the
    cache), checked live on every proposing step."""
    _, _, cfg, params = model
    eng = InferenceEngine(cfg, params,
                          EngineConfig(**SHAPE, speculative_k=K),
                          kv_dtype=torch.float32, device="cpu")
    checks = []
    real = eng._assert_private_tail
    eng._assert_private_tail = lambda req, cl: (
        checks.append((req.request_id, cl)), real(req, cl))[1]
    a = eng.generate([7] * 20 + [3, 9], max_new_tokens=12, prefix_key="tA")
    b = eng.generate([7] * 20 + [3, 9, 4], max_new_tokens=12,
                     prefix_key="tB")
    assert eng.prefix_cache.total_pages > 0
    assert b.cached_tokens == 16 and b.cache_source == "cross"
    assert any(rid == b.request_id for rid, _ in checks)
    assert eng.self_check() == []
    ref = run_jax(model, [("a", a.prompt_ids, dict(max_new_tokens=12)),
                          ("b", b.prompt_ids, dict(max_new_tokens=12))])
    assert (a.output_ids, b.output_ids) == (ref["a"][0], ref["b"][0])


def test_config_validation(model):
    _, _, cfg, params = model
    for k in (-1, SHAPE["max_pages_per_seq"] * SHAPE["page_size"] - 1):
        with pytest.raises(ValueError):
            InferenceEngine(cfg, params, EngineConfig(**SHAPE,
                                                      speculative_k=k),
                            device="cpu")
    eng = InferenceEngine(cfg, params, EngineConfig(**SHAPE), device="cpu")
    eng.submit(GenRequest(request_id="x", prompt_ids=[1, 2]))
    assert eng._requests["x"].spec is None  # off by default: no proposer
    assert isinstance(LaneSpeculator([1, 2]).propose(2), list)


@pytest.mark.parametrize("name,k", [
    ("llama-3.2-1b", 8), ("llama-3.2-1b", 16), ("llama-3-70b", 4)])
def test_kernel_backend_takes_speculative_k_the_reference_serves(name, k):
    """Fault C4: the CUDA backend once refused G * (speculative_k + 1) > 32
    query rows per kv head (K3's 32-row block), so speculative_k >= 8 at
    Llama-3.2-1B's G 4 and >= 4 at a G 8 model.  The reference engine
    checks only that speculative_k + 2 fits the window; so does the port's
    kernel backend now."""
    cfg = get_config(name)
    g = cfg.num_heads // cfg.num_kv_heads
    assert g * (k + 1) > 32  # what the 32-row K3 refused
    shape = dict(page_size=16, num_pages=1100, max_pages_per_seq=128,
                 speculative_k=k)
    assert k + 2 <= JEngineConfig(**shape).max_window  # the reference's rule
    assert kernel_backend_problems(cfg, EngineConfig(**shape)) == []


def test_kernel_backend_problems_name_what_the_kernels_refuse():
    """What the kernels do not take is still refused, and said: a head dim
    outside 64 and 128, and a window of more chunks than the merge holds."""
    tiny = get_config("tiny")  # D 16
    assert len(kernel_backend_problems(tiny, EngineConfig())) == 1
    long = EngineConfig(page_size=16, num_pages=200_000,
                        max_pages_per_seq=100_000, speculative_k=4)
    (why,) = kernel_backend_problems(get_config("llama-3.2-1b"), long)
    assert "chunks" in why


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_verify_forward_matches_jax(model, backend):
    """One verify step over two prefilled lanes (q_lens 5 and 2) and an
    idle lane: the port's forward with a verify PagedView — K3's plain
    version on the kernel backend — against the JAX forward."""
    jcfg, jparams, cfg, params = model
    cfg = cfg.replace(attention_backend=backend)
    ps, P, n_pages, S = 8, 4, 12, K + 1
    rng = np.random.RandomState(7)
    rows = np.array([[5, 2, 9, 7], [3, 11, 4, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([13, 20, 0], np.int32)
    q_lens = np.array([5, 2, 1], np.int32)
    active = np.array([True, True, False])
    HD = cfg.num_kv_heads * cfg.head_dim
    pool = rng.randn(2, cfg.num_layers, n_pages * ps, HD).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (3, S))
    pos = lens[:, None] + np.arange(S)[None]
    local = np.arange(S)[None]
    in_run = (local < q_lens[:, None]) & active[:, None]
    page = np.take_along_axis(rows, np.minimum(pos // ps, P - 1), axis=1)
    write = np.where(in_run, page * ps + pos % ps, local % ps)
    C = P * ps
    kv_pos = np.broadcast_to(np.arange(C)[None], (3, C))
    valid = (kv_pos < (lens + q_lens)[:, None]) & active[:, None]
    jl, jcache = jllama.forward(
        jparams, jcfg, jnp.asarray(toks, jnp.int32),
        jnp.asarray(pos, jnp.int32),
        kv_cache=jllama.KVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1])),
        paged=jllama.PagedView(
            jnp.asarray(write), None, jnp.asarray(kv_pos),
            jnp.asarray(valid), page_table=jnp.asarray(rows),
            seq_lens=jnp.asarray(lens), page_size=ps,
            chunk_len=jnp.asarray(q_lens)))
    tk, tv = (torch.from_numpy(pool[i].copy()) for i in (0, 1))
    tl, _ = forward(
        params, cfg, torch.from_numpy(toks), torch.from_numpy(pos),
        kv_cache=KVCache(tk, tv),
        paged=PagedView(
            torch.from_numpy(write), None,
            torch.from_numpy(np.ascontiguousarray(kv_pos)),
            torch.from_numpy(valid), page_table=torch.from_numpy(rows),
            seq_lens=torch.from_numpy(lens), page_size=ps,
            q_lens=torch.from_numpy(q_lens)))
    for b in range(2):
        np.testing.assert_allclose(tl.numpy()[b, :q_lens[b]],
                                   np.asarray(jl)[b, :q_lens[b]],
                                   atol=1e-4, rtol=0)
    # the written KV, past the trash page (whose slots the padding rows
    # of several lanes overwrite in no defined order)
    np.testing.assert_allclose(tk.numpy()[:, ps:],
                               np.asarray(jcache.k)[:, ps:], atol=1e-4,
                               rtol=0)
