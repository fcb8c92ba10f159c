"""kafka_tpu_torch radix prefix cache and engine prefix reuse vs the JAX
package.

* The same seeded random sequence of store / lookup / reclaim /
  invalidate runs on the port's PrefixCache and on the JAX PrefixCache,
  each over its own page pool: every hit must give the same pages, token
  count and source, and both pools the same refcounts after every step.
* The same thread turns run through the port's engine and the JAX engine
  (prefix cache on, XLA attention, the features the port leaves out
  turned off): greedy streams token-exact, equal cached_tokens and
  cache_source, and a clean self_check on the port.
* Turn 2 of a thread through the port's server reports
  prompt_tokens_details.cached_tokens.
"""

import asyncio
import json

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
from kafka_tpu.runtime.kv_cache import (
    PagePool as JPagePool,
    SequencePages as JSequencePages,
)
from kafka_tpu.runtime.prefix_cache import PrefixCache as JPrefixCache
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.runtime import (
    EngineConfig,
    GenRequest,
    InferenceEngine,
    PagePool,
    SequencePages,
)
from kafka_tpu_torch.runtime.prefix_cache import PrefixCache
from kafka_tpu_torch.server import ServingConfig, create_app

SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))


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


# ---------------------------------------------------------------------------
# the radix tree alone
# ---------------------------------------------------------------------------


class TestRadixCacheParity:
    @pytest.mark.parametrize("max_pages", [None, 10])
    def test_random_operations_match_jax(self, max_pages):
        """300 seeded operations over four threads whose prompts share
        prefixes of whole and partial pages."""
        ps, n_pages = 4, 48
        rng = np.random.RandomState(0 if max_pages is None else 1)
        pools = (PagePool(n_pages, ps), JPagePool(n_pages, ps))
        caches = (PrefixCache(pools[0], max_pages=max_pages),
                  JPrefixCache(pools[1], max_pages=max_pages))
        heads = [rng.randint(0, 9, size=n).tolist() for n in (8, 10, 13)]
        live = []  # (port pages, jax pages) held by "running requests"

        def tokens():
            head = heads[rng.randint(len(heads))]
            cut = rng.randint(len(head) + 1)
            return head[:cut] + rng.randint(0, 9, size=rng.randint(1, 12)
                                            ).tolist()

        n_hits = 0
        for _ in range(300):
            op = rng.choice(["store", "lookup", "reclaim", "invalidate",
                             "finish"], p=[.35, .35, .1, .1, .1])
            key = f"t{rng.randint(4)}"
            if op == "store":
                toks = tokens()
                seqs = (SequencePages("s"), JSequencePages("s"))
                try:
                    for pool, seq in zip(pools, seqs):
                        pool.ensure_capacity(seq, len(toks))
                except Exception:
                    for pool, seq in zip(pools, seqs):
                        pool.free_sequence(seq)
                    caches[0].reclaim(len(toks) // ps + 1)
                    caches[1].reclaim(len(toks) // ps + 1)
                    continue
                assert seqs[0].pages == seqs[1].pages
                for cache, pool, seq in zip(caches, pools, seqs):
                    cache.store(key, toks, seq.pages)
                    pool.free_sequence(seq)
            elif op == "lookup":
                toks = tokens()
                a = caches[0].lookup(key, toks)
                b = caches[1].lookup(key, toks)
                assert (a is None) == (b is None)
                if a is not None:
                    n_hits += 1
                    assert (a.pages, a.tokens, a.source) == \
                        (b.pages, b.tokens, b.source)
                    live.append((a.pages, b.pages))
            elif op == "reclaim":
                want = rng.randint(1, n_pages)
                assert caches[0].reclaim(want) == caches[1].reclaim(want)
            elif op == "invalidate":
                for cache in caches:
                    cache.invalidate(key)
            elif live:
                pa, pb = live.pop(rng.randint(len(live)))
                pools[0].release(pa)
                pools[1].release(pb)
            np.testing.assert_array_equal(pools[0].refcount,
                                          pools[1].refcount)
            assert pools[0].free_pages == pools[1].free_pages
            assert caches[0].page_owners() == caches[1].page_owners()
            assert caches[0].total_pages == caches[1].total_pages
        assert n_hits > 20
        assert pools[0].check_consistency() == []
        for pa, _ in live:
            pools[0].release(pa)
        caches[0].clear()
        assert pools[0].free_pages == n_pages - 1


# ---------------------------------------------------------------------------
# the engine: thread turns against the JAX engine
# ---------------------------------------------------------------------------


def jax_engine(jcfg, jparams, **kw):
    ecfg = JEngineConfig(**{**SHAPE, **kw}, multi_step=1, max_parked=0,
                         attention_backend="xla", flight_ring=0)
    return JInferenceEngine(jcfg, jparams, ecfg, kv_dtype=jnp.float32)


def port_engine(cfg, params, **kw):
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")


def turns(model, rounds, **shape):
    """Run `rounds` (lists of (rid, key, prompt-or-fn, max_new)) through
    both engines, one round after another; a prompt fn builds its prompt
    from the outputs so far.  Returns ({rid: result}, engine) per engine."""
    jcfg, jparams, cfg, params = model
    out = []
    for eng, Req in ((jax_engine(jcfg, jparams, **shape), JGenRequest),
                     (port_engine(cfg, params, **shape), GenRequest)):
        got = {}
        for rnd in rounds:
            for rid, key, prompt, n in rnd:
                p = prompt(got) if callable(prompt) else prompt
                eng.submit(Req(request_id=rid, prompt_ids=list(p),
                               max_new_tokens=n, prefix_key=key))
            for rid, r in eng.run_to_completion().items():
                got[rid] = (list(r.output_ids), r.finish_reason,
                            r.cached_tokens, r.cache_source)
        out.append((got, eng))
    return out


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


class TestEnginePrefixReuse:
    def test_two_turn_thread_and_cross_thread_prefix(self, model):
        """Turn 2 of thread A reuses its own turn; thread B, sharing A's
        first two pages, reuses them across threads."""
        (p,) = prompts(0, [21])
        other = p[:17] + prompts(1, [6])[0]
        rounds = [
            [("a1", "A", p, 6)],
            [("a2", "A", lambda got: p + got["a1"][0] + [5, 6, 7], 6)],
            [("b1", "B", other, 5)],
        ]
        (jout, _), (tout, eng) = turns(model, rounds)
        assert tout == jout
        assert tout["a2"][2:] == (24, "own")
        assert tout["b1"][2:] == (16, "cross")
        assert eng.prefix_cache.hits == 2
        assert eng.self_check() == []

    def test_concurrent_hits_batch_their_suffix_prefill(self, model):
        """Three threads warm one shared prefix, then return together:
        their suffixes start at the cached length and share one batched
        prefill dispatch."""
        (head,) = prompts(2, [16])
        tails = prompts(3, [4, 6, 9])
        rounds = [[("w", "W", head + [1, 2], 4)],
                  [(f"c{i}", f"C{i}", head + t, 7)
                   for i, t in enumerate(tails)]]
        (jout, _), (tout, eng) = turns(model, rounds)
        assert tout == jout
        assert [tout[f"c{i}"][2] for i in range(3)] == [16, 16, 16]
        assert eng.self_check() == []

    def test_cache_pages_reclaimed_under_pressure(self, model):
        """A small pool: admission and decode growth evict cache leaves
        before anyone is preempted, and the streams still match."""
        rounds = [[(f"t{i}", f"T{i}", p, 10)]
                  for i, p in enumerate(prompts(4, [20, 18, 22, 19]))]
        rounds.append([("t0b", "T0", prompts(4, [20])[0] + [9, 9], 12),
                       ("u", "U", prompts(5, [30])[0], 20)])
        (jout, jeng), (tout, eng) = turns(model, rounds, num_pages=14)
        assert tout == jout
        assert eng.prefix_cache.evictions > 0
        assert eng.prefix_cache.evictions == jeng.prefix_cache.evictions
        assert eng.preemptions == 0
        assert eng.self_check() == []

    def test_budget_and_off_switches(self, model):
        _, _, cfg, params = model
        (p,) = prompts(6, [30])
        eng = port_engine(cfg, params, prefix_cache_pages=2)
        eng.generate(p, max_new_tokens=4, prefix_key="x")
        assert eng.prefix_cache.total_pages == 2
        assert eng.generate(p + [3], max_new_tokens=2,
                            prefix_key="x").cached_tokens == 16
        for kw in (dict(prefix_cache_pages=0), dict(prefix_cache_entries=0)):
            assert port_engine(cfg, params, **kw).prefix_cache is None
        with pytest.raises(ValueError):
            port_engine(cfg, params, prefix_cache_pages=-1)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_thread_turn_two_reports_cached_tokens(tmp_path):
    """The thread route keys the cache by thread: turn 2 reports the
    cached span in usage.prompt_tokens_details, streamed and not.  No
    tools but the agent's idle tool (`tools=[]`) and a short system
    prompt keep the turns inside this 1024-token window."""
    from aiohttp.test_utils import TestClient, TestServer

    cfg = ServingConfig(tiny_model=True, max_batch=2, page_size=16,
                        num_pages=160, max_pages_per_seq=64,
                        prefill_buckets=(16, 32, 64, 128),
                        max_new_tokens_default=6, warmup=True,
                        system_prompt="terse",
                        db_path=str(tmp_path / "threads.db"))

    async def run():
        app = await create_app(cfg, tools=[], mcp_servers=[], device="cpu")
        usages = []
        async with TestClient(TestServer(app)) as c:
            for i, content in enumerate(("tell me a story about pages",
                                         "and then?", "and then?")):
                r = await c.post(
                    "/v1/threads/th/chat/completions",
                    json={"model": "tiny", "stream": i < 2,
                          "temperature": 0, "max_tokens": 6,
                          "messages": [{"role": "user",
                                        "content": content}]})
                assert r.status == 200
                if i < 2:
                    events = [json.loads(line[len("data: "):])
                              for line in (await r.text()).splitlines()
                              if line.startswith("data: {")]
                    usages.append(next(e["usage"] for e in events
                                       if e.get("usage") and "object" in e))
                else:
                    usages.append((await r.json())["usage"])
        return usages

    usages = asyncio.run(run())
    assert "prompt_tokens_details" not in usages[0]
    for u in usages[1:]:
        cached = u["prompt_tokens_details"]["cached_tokens"]
        assert 0 < cached < u["prompt_tokens"] and cached % 16 == 0


def test_serving_config_reads_the_new_knobs(monkeypatch):
    monkeypatch.setenv("KAFKA_TORCH_PREFIX_CACHE_PAGES", "128")
    monkeypatch.setenv("KAFKA_TORCH_SPECULATIVE_K", "4")
    cfg = ServingConfig.from_env()
    assert (cfg.prefix_cache_pages, cfg.speculative_k) == (128, 4)
    monkeypatch.delenv("KAFKA_TORCH_PREFIX_CACHE_PAGES")
    monkeypatch.delenv("KAFKA_TORCH_SPECULATIVE_K")
    cfg = ServingConfig.from_env()
    assert (cfg.prefix_cache_pages, cfg.speculative_k) == (None, 0)
