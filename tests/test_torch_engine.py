"""kafka_tpu_torch engine vs the JAX InferenceEngine on the same weights.

Greedy streams must be token-exact: the same tiny float32 weights (JAX
init_params, handed over via params_from_jax) and the same requests go
through both engines on the CPU, covering admission past the batch width,
chunked prefill, batched prefill, retirement by length and by stop token,
and preemption under page pressure.  The JAX engine runs with the features
the port's slice leaves out turned off (prefix cache, parking, fused
multi-step) — each is token-identical by the JAX package's own tests.
Sampled streams are held to determinism per (seed, position) within the
port.  Deadlines, the waiting-queue bound, cancel and failure recovery are
checked on the port alone.
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
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.runtime import (
    AdmissionError,
    EngineConfig,
    GenRequest,
    InferenceEngine,
)


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


SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))


def jax_engine(jcfg, jparams, **kw):
    ecfg = JEngineConfig(**{**SHAPE, **kw}, multi_step=1,
                         prefix_cache_entries=0, max_parked=0,
                         attention_backend="xla", flight_ring=0)
    return JInferenceEngine(jcfg, jparams, ecfg, kv_dtype=jnp.float32)


def port_engine(cfg, params, **kw):
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")


def run_both(model, requests, **shape):
    """Submit the same requests to both engines; {rid: (tokens, reason)}."""
    jcfg, jparams, cfg, params = model
    out = []
    for eng, Req in ((jax_engine(jcfg, jparams, **shape), JGenRequest),
                     (port_engine(cfg, params, **shape), GenRequest)):
        for rid, prompt, kw in requests:
            eng.submit(Req(request_id=rid, prompt_ids=list(prompt), **kw))
        done = eng.run_to_completion()
        out.append(({rid: (list(r.output_ids), r.finish_reason)
                     for rid, r in done.items()}, eng))
    return out


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


class TestGreedyParity:
    def test_admission_chunked_and_batched_prefill(self, model):
        """Six requests through three slots: a 45-token prompt chunks
        through the 32 bucket, same-bucket admissions batch, and waiting
        requests are admitted as earlier ones retire."""
        lens = [5, 12, 45, 9, 30, 3]
        news = [10, 6, 12, 8, 5, 9]
        reqs = [(f"r{i}", p, dict(max_new_tokens=n))
                for i, (p, n) in enumerate(zip(prompts(0, lens), news))]
        (jout, _), (tout, eng) = run_both(model, reqs)
        assert tout == jout
        assert all(len(tout[f"r{i}"][0]) == n for i, n in enumerate(news))
        assert eng.self_check() == []
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_lone_request_single_prefill_and_window_limit(self, model):
        """A lone long prompt (single-sequence prefill, the K2 path) that
        runs into the attention window retires with "length"."""
        (p,) = prompts(1, [50])
        reqs = [("solo", p, dict(max_new_tokens=40))]
        (jout, _), (tout, _) = run_both(model, reqs)
        assert tout == jout
        assert tout["solo"][1] == "length"
        assert len(p) + len(tout["solo"][0]) == SHAPE["max_pages_per_seq"] \
            * SHAPE["page_size"]

    def test_stop_token_retires(self, model):
        jcfg, jparams, cfg, params = model
        (p,) = prompts(2, [7])
        first = port_engine(cfg, params).generate(p, max_new_tokens=8)
        stop = first.output_ids[3]
        reqs = [("s", p, dict(max_new_tokens=20, stop_token_ids=(stop,))),
                ("t", prompts(3, [4])[0], dict(max_new_tokens=5))]
        (jout, _), (tout, _) = run_both(model, reqs)
        assert tout == jout
        assert tout["s"][1] == "stop" and tout["s"][0][-1] == stop

    def test_preemption_resumes_token_exact(self, model):
        """Nine usable pages for three growing sequences: the youngest is
        rolled back and re-prefilled, and every stream still matches."""
        ps = prompts(4, [8, 6, 10])
        reqs = [(f"p{i}", p, dict(max_new_tokens=22))
                for i, p in enumerate(ps)]
        (jout, jeng), (tout, eng) = run_both(model, reqs, num_pages=10)
        assert tout == jout
        assert eng.preemptions > 0
        assert jeng.metrics.requests_preempted > 0
        assert eng.self_check() == []
        assert eng.pool.free_pages == 9


    def test_kept_logits_match_jax_forward(self, model):
        """EngineConfig.keep_logits (the chip smoke's comparison hook) keeps
        the exact rows each token was sampled from: prefill's last row and
        each decode step's, equal to a full JAX forward over the history."""
        jcfg, jparams, cfg, params = model
        (p,) = prompts(6, [19])
        req = port_engine(cfg, params, keep_logits=True).generate(
            p, max_new_tokens=4)
        assert len(req.logits) == 4
        seq = p + req.output_ids[:-1]
        ref, _ = jllama.forward(
            jparams, jcfg, jnp.asarray([seq], jnp.int32),
            jnp.arange(len(seq), dtype=jnp.int32)[None])
        ref = np.asarray(ref[0, len(p) - 1:])
        np.testing.assert_allclose(torch.stack(req.logits).numpy(), ref,
                                   atol=1e-4, rtol=0)


class TestSampling:
    def test_filters_keep_the_same_tokens_as_jax(self):
        """top-k, top-p and the shared-sort sequential filter keep exactly
        the tokens the JAX sampler keeps (continuous random logits: no
        ties)."""
        from kafka_tpu.ops.sampling import (
            SamplingParams as JParams,
            _filtered_logits,
            apply_top_k as j_top_k,
            apply_top_p as j_top_p,
        )
        from kafka_tpu_torch.ops.sampling import (
            SamplingParams,
            _filtered,
            apply_top_k,
            apply_top_p,
        )

        rng = np.random.RandomState(0)
        logits = (rng.randn(5, 50) * 3).astype(np.float32)
        top_k = np.array([0, 1, 5, 17, 50], np.int32)
        top_p = np.array([1.0, 0.5, 0.9, 0.3, 0.99], np.float32)
        temp = np.array([0.7, 1.0, 0.5, 1.3, 0.9], np.float32)
        tl = torch.from_numpy(logits)
        got = apply_top_k(tl, torch.from_numpy(top_k)).numpy() > -1e29
        want = np.asarray(j_top_k(jnp.asarray(logits),
                                  jnp.asarray(top_k))) > -1e29
        np.testing.assert_array_equal(got, want)
        got = apply_top_p(tl, torch.from_numpy(top_p)).numpy() > -1e29
        want = np.asarray(j_top_p(jnp.asarray(logits),
                                  jnp.asarray(top_p))) > -1e29
        np.testing.assert_array_equal(got, want)
        scaled = tl / torch.from_numpy(temp)[:, None]
        got = _filtered(scaled, SamplingParams(
            torch.from_numpy(temp), torch.from_numpy(top_k).long(),
            torch.from_numpy(top_p))).numpy()
        _, want = _filtered_logits(jnp.asarray(logits), JParams(
            jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)), None)
        np.testing.assert_array_equal(got > -1e29, np.asarray(want) > -1e29)

    def test_sampled_stream_deterministic_per_seed_and_position(self, model):
        _, _, cfg, params = model
        kw = dict(max_new_tokens=10, temperature=0.9, top_k=40, top_p=0.95,
                  seed=1234)
        solo = port_engine(cfg, params).generate([7, 7, 7], **kw)
        eng = port_engine(cfg, params)
        eng.submit(GenRequest(request_id="noise", prompt_ids=[9, 2],
                              max_new_tokens=10, temperature=1.3, seed=77))
        eng.submit(GenRequest(request_id="probe", prompt_ids=[7, 7, 7], **kw))
        done = eng.run_to_completion()
        assert done["probe"].output_ids == solo.output_ids
        other = port_engine(cfg, params).generate(
            [7, 7, 7], **{**kw, "seed": 99})
        assert other.output_ids != solo.output_ids

    def test_sampled_stream_survives_preemption(self, model):
        _, _, cfg, params = model
        kw = dict(max_new_tokens=20, temperature=0.8, seed=5)
        ps = prompts(5, [8, 6, 10])
        solo = {i: port_engine(cfg, params).generate(p, **kw).output_ids
                for i, p in enumerate(ps)}
        eng = port_engine(cfg, params, num_pages=10)
        for i, p in enumerate(ps):
            eng.submit(GenRequest(request_id=f"q{i}", prompt_ids=p, **kw))
        done = eng.run_to_completion()
        assert eng.preemptions > 0
        assert {i: done[f"q{i}"].output_ids for i in range(3)} == solo


class TestLifecycle:
    def test_ttft_deadline_times_out(self, model):
        _, _, cfg, params = model
        eng = port_engine(cfg, params, max_ttft_s=0.0)
        eng.submit(GenRequest(request_id="late", prompt_ids=[1, 2, 3],
                              max_new_tokens=4))
        events = eng.step()
        assert [(e.request_id, e.finish_reason) for e in events] == \
            [("late", "timeout")]
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_waiting_queue_bound(self, model):
        _, _, cfg, params = model
        eng = port_engine(cfg, params, max_waiting=2)
        for i in range(2):
            eng.submit(GenRequest(request_id=f"w{i}", prompt_ids=[1, 2]))
        with pytest.raises(AdmissionError) as e:
            eng.submit(GenRequest(request_id="w2", prompt_ids=[1, 2]))
        assert e.value.retry_after_s >= 1.0

    def test_cancel_frees_slot_and_pages(self, model):
        _, _, cfg, params = model
        # fetch_lag=0: the step's token is processed in that step, so no
        # fetch is in flight (has_work counts in-flight fetches)
        eng = port_engine(cfg, params, fetch_lag=0)
        eng.submit(GenRequest(request_id="c", prompt_ids=[4] * 20,
                              max_new_tokens=30))
        eng.step()
        assert eng.num_active == 1
        assert eng.cancel("c")
        assert not eng.cancel("c")
        assert eng.num_active == 0 and not eng.has_work
        assert eng.pool.free_pages == SHAPE["num_pages"] - 1

    def test_recover_from_failure(self, model, monkeypatch):
        """A step that raises: started requests get one terminal error
        event, waiting ones stay queued and are served afterwards."""
        _, _, cfg, params = model
        # max_parked=0: "b" must still be waiting (not prefilled off-slot)
        # when the step fails.  fetch_lag=0: every fetch is processed in
        # the step that dispatched it, so none is in flight when the step
        # fails.  Recovery returns the failed step's already-popped events
        # too, so with a fetch in flight the events would depend on
        # whether it landed before the failure (both packages alike).
        eng = port_engine(cfg, params, max_batch=1, max_parked=0,
                          fetch_lag=0)
        eng.submit(GenRequest(request_id="a", prompt_ids=[1, 2, 3],
                              max_new_tokens=6))
        eng.submit(GenRequest(request_id="b", prompt_ids=[4, 5],
                              max_new_tokens=3))
        # "a" prefills and takes the only slot; its tokens reach the host
        assert {e.request_id for e in eng.step()} == {"a"}
        assert not eng._pending
        real = eng._run_step

        def boom(*args):
            raise RuntimeError("injected")

        monkeypatch.setattr(eng, "_run_step", boom)
        with pytest.raises(RuntimeError):
            eng.step()
        events = eng.recover_from_failure()
        assert [(e.request_id, e.finish_reason) for e in events] == \
            [("a", "error:engine")]
        monkeypatch.setattr(eng, "_run_step", real)
        done = eng.run_to_completion()
        assert len(done["b"].output_ids) == 3
        assert eng.self_check() == []

    def test_prompt_longer_than_window_rejected(self, model):
        _, _, cfg, params = model
        eng = port_engine(cfg, params)
        with pytest.raises(ValueError):
            eng.submit(GenRequest(request_id="x", prompt_ids=[1] * 64))
        with pytest.raises(ValueError):
            eng.submit(GenRequest(request_id="y", prompt_ids=[]))

    @pytest.mark.cuda
    def test_kernel_backend_rejects_unsupported_cuda_model(self, model):
        """On CUDA the kernels take bf16 D 64/128 only; anything else must
        choose the plain backend explicitly (never a silent switch)."""
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        _, _, cfg, params = model
        with pytest.raises(ValueError):
            InferenceEngine(cfg, params, EngineConfig(**SHAPE),
                            device="cuda")
