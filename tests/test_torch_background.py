"""The engine's background request class in kafka_tpu_torch against
kafka_tpu (`GenRequest.background`, `waiting_bg`, `_admit_background`,
the chunk rules and the preemption order).

* The same mix of interactive and background requests (prompts longer
  than the largest bucket, so prefills chunk) gives the same admission
  order, the same bg_admitted / bg_chunks / bg_yields, the same agent
  section and token-exact outputs in both engines; a full interactive
  queue (max_waiting) still takes a background request.
* Under page pressure the preemption victim is the background lane, even
  when it is the older request, in both engines.

Both engines dispatch one step at a time with fetch_lag 0 and no parking,
so every fetch is processed in the step that made it and the two
schedulers' per-step decisions line up.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.runtime import EngineConfig as JEngineConfig
from kafka_tpu.runtime import GenRequest as JGenRequest
from kafka_tpu.runtime import InferenceEngine as JInferenceEngine
from kafka_tpu_torch.models import params_from_jax
from kafka_tpu_torch.models.config import ModelConfig
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine

DIMS = dict(name="bg-test", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, dtype="float32")
# one step per dispatch, fetches processed in the step that made them
STEP = dict(multi_step=1, fetch_lag=0, max_parked=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(23))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ModelConfig(**DIMS), params


def engines(model, **shape):
    jcfg, jparams, cfg, params = model
    shape = {**shape, **STEP}
    j = JInferenceEngine(jcfg, jparams,
                         JEngineConfig(**shape, attention_backend="xla",
                                       flight_ring=0),
                         kv_dtype=jnp.float32)
    p = InferenceEngine(cfg, params, EngineConfig(**shape),
                        kv_dtype=torch.float32, device="cpu")
    return j, p


def spy(engine, name):
    """Record the request ids `engine.<name>(req, ...)` is called with."""
    seen = []
    orig = getattr(engine, name)

    def wrapped(req, *a, **kw):
        seen.append(req.request_id)
        return orig(req, *a, **kw)

    setattr(engine, name, wrapped)
    return seen


def prompt(seed, n):
    return [int(x) for x in np.random.RandomState(seed).randint(1, 128, n)]


def test_mix_matches_the_reference(model):
    shape = dict(max_batch=2, page_size=8, num_pages=64,
                 max_pages_per_seq=16, prefill_buckets=(8, 16, 32),
                 max_waiting=3)
    mix = [("b0", True, 40), ("i0", False, 36), ("b1", True, 20),
           ("i1", False, 44), ("i2", False, 12)]
    got = []
    for eng, Req in zip(engines(model, **shape), (JGenRequest, GenRequest)):
        admitted = spy(eng, "_start_prefill")
        reqs = {}
        for rid, bg, n in mix:
            reqs[rid] = Req(request_id=rid, prompt_ids=prompt(len(rid) + n,
                                                              n),
                            max_new_tokens=6, background=bg)
            eng.submit(reqs[rid])
        # the interactive queue is at max_waiting: background work is
        # exempt from the bound
        late = Req(request_id="b2", prompt_ids=prompt(99, 10),
                   max_new_tokens=3, background=True)
        eng.submit(late)
        reqs["b2"] = late
        eng.run_to_completion()
        got.append((admitted, eng.bg_admitted, eng.bg_chunks, eng.bg_yields,
                    {k: r.output_ids for k, r in reqs.items()},
                    eng.agent_section()))
    assert got[1] == got[0]
    admitted, n_admitted, chunks, yields = got[1][:4]
    assert n_admitted == 3 and chunks > 0 and yields > 0
    # interactive requests admit ahead of the older background ones
    assert admitted.index("i0") < admitted.index("b0")
    assert all(len(o) == (3 if k == "b2" else 6)
               for k, o in got[1][4].items())


def test_page_pressure_preempts_the_background_lane(model):
    shape = dict(max_batch=2, page_size=8, num_pages=12,
                 max_pages_per_seq=8, prefill_buckets=(8, 16, 32))
    got = []
    for eng, Req in zip(engines(model, **shape), (JGenRequest, GenRequest)):
        victims = spy(eng, "_preempt")
        bg = Req(request_id="bg", prompt_ids=prompt(5, 20),
                 max_new_tokens=40, background=True)
        fg = Req(request_id="fg", prompt_ids=prompt(6, 20),
                 max_new_tokens=40)
        eng.submit(bg)  # the OLDER request is the background one
        eng.submit(fg)
        done = eng.run_to_completion()
        got.append((victims, done["bg"].output_ids, done["fg"].output_ids,
                    eng.metrics.requests_preempted, eng.bg_admitted,
                    eng.self_check()))
    assert got[1] == got[0]
    victims, _, _, preemptions, _, problems = got[1]
    assert victims and set(victims) == {"bg"}
    assert preemptions == len(victims) and problems == []
