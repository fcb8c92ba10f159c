"""kafka_tpu_torch int8 serving vs the JAX package.

* Quantization: the same numpy weights through both packages'
  `quantize_array` / `quantize_params` give byte-equal int8 codes and
  equal f32 scales, and equal dequantized weights.
* The int8 paged KV pool: the same rows written by both `_kv_write` give
  byte-equal codes and equal per-slot scales; the dequantizing page
  gather reads back equal windows.
* Engines on a tiny float32 model (the `kvq-test` shape of
  tests/test_kv_quant.py): greedy streams token-exact against the JAX
  engine for int8 weights, int8 KV (the port's default backend — K4's
  plain version on the CPU — against the JAX engine forced onto its
  Pallas int8 kernel in interpret mode, and the port's plain backend
  against JAX's XLA path), both together on a two-turn thread that
  reuses quantized pages, and preemption under int8 KV.
* `logit_quality_metrics` equals the JAX package's on the same weights.
* Serving: the env knobs reach ServingConfig, and build_provider on the
  CPU serves a streamed int8 thread turn.

No test here changes process-global state (thread counts, default
dtypes, JAX config); env changes go through monkeypatch.
"""

import asyncio
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jax_init_params
from kafka_tpu.models.llama import (
    _kv_read_pages as jax_kv_read_pages,
    _kv_write as jax_kv_write,
)
from kafka_tpu.models.quant import (
    QTensor as JQTensor,
    dequantize as jax_dequantize,
    param_bytes as jax_param_bytes,
    quantize_array as jax_quantize_array,
    quantize_params as jax_quantize_params,
)
from kafka_tpu.models.quant_quality import (
    logit_quality_metrics as jax_logit_quality_metrics,
)
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.models import (
    ModelConfig,
    QTensor,
    dequantize,
    param_bytes,
    params_from_jax,
    quantize_array,
    quantize_params,
)
from kafka_tpu_torch.models.llama import _kv_read_pages, _kv_write
from kafka_tpu_torch.models.quant_quality import logit_quality_metrics
from kafka_tpu_torch.ops import kernels
from kafka_tpu_torch.runtime import (
    EngineConfig,
    GenRequest,
    InferenceEngine,
    make_kv_pool_arrays,
)
from kafka_tpu_torch.server import ServingConfig, create_app

KVQ = dict(name="kvq-test", vocab_size=128, hidden_size=64,
           intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=16, dtype="float32")
SHAPE = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, jax int8 params, port cfg, port params, port
    int8 params); the port's trees come from the JAX ones as numpy."""
    jcfg = JModelConfig(**KVQ)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    jq = jax_quantize_params(jparams, jcfg)
    return (jcfg, jparams, jq, ModelConfig(**KVQ),
            params_from_jax(jax.tree.map(np.asarray, jparams)),
            params_from_jax(jax.tree.map(np.asarray, jq)))


def assert_q_equal(port: QTensor, ref) -> None:
    np.testing.assert_array_equal(port.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(port.s.numpy(), np.asarray(ref.s))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


class TestQuantize:
    @pytest.mark.parametrize("shape,axes", [
        ((64, 32), (0,)),          # an LM head [H, V]
        ((3, 16, 4, 8), (1,)),     # wq [L, H, hq, d]
        ((3, 4, 8, 16), (1, 2)),   # wo [L, hq, d, H]
        ((2, 5, 24), (-1,)),       # KV rows [B, S, Hkv*D]
    ])
    def test_array_byte_equal(self, shape, axes):
        rng = np.random.RandomState(sum(shape))
        w = (rng.randn(*shape) * rng.uniform(0.01, 5, shape[-1:])
             ).astype(np.float32)
        w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 scale floor
        port = quantize_array(t(w), axes)
        ref = jax_quantize_array(jnp.asarray(w), axes)
        assert port.q.dtype == torch.int8 and port.s.dtype == torch.float32
        assert_q_equal(port, ref)
        for pdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(
                dequantize(port, pdt).float().numpy(),
                np.asarray(jax_dequantize(ref, jdt).astype(jnp.float32)))

    @pytest.mark.parametrize("tied", [True, False])
    def test_params_byte_equal(self, tied):
        jcfg = JModelConfig(**{**KVQ, "tie_word_embeddings": tied})
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(7))
        ref = jax_quantize_params(jparams, jcfg)
        port = quantize_params(
            params_from_jax(jax.tree.map(np.asarray, jparams)))
        carried = params_from_jax(jax.tree.map(np.asarray, ref))
        names = ["embed"] + (["lm_head"] if not tied else [])
        for name in names:
            assert_q_equal(port[name], ref[name])
            assert isinstance(carried[name], QTensor)
        for name, w in ref["layers"].items():
            if isinstance(w, JQTensor):
                assert_q_equal(port["layers"][name], w)
                assert_q_equal(carried["layers"][name], w)
            else:  # norms stay dense
                np.testing.assert_array_equal(
                    port["layers"][name].numpy(), np.asarray(w))
        assert param_bytes(port) == jax_param_bytes(ref)


# ---------------------------------------------------------------------------
# the int8 KV pool
# ---------------------------------------------------------------------------


class TestInt8Pool:
    def test_pool_shapes_and_modes(self):
        cfg = ModelConfig(num_layers=3, num_kv_heads=2, head_dim=16)
        k, v = make_kv_pool_arrays(cfg, num_pages=10, page_size=8,
                                   quantize="int8")
        assert isinstance(k, QTensor) and k.q.dtype == torch.int8
        assert k.q.shape == (3, 80, 32) and v.q.shape == (3, 80, 32)
        assert k.s.shape == (3, 80, 1) and k.s.dtype == torch.float32
        with pytest.raises(ValueError):
            make_kv_pool_arrays(cfg, 10, 8, quantize="fp4")

    def test_write_and_page_gather_match_jax(self):
        """The same rows (one per slot, no duplicate indices) written into
        both packages' int8 pools; then both gather a paged window."""
        rng = np.random.RandomState(3)
        slots, hd, ps = 48, 32, 8
        rows = (rng.randn(2, 5, hd) * 3).astype(np.float32)
        idx = rng.permutation(np.arange(ps, slots))[:10].reshape(2, 5)
        ref = JQTensor(q=jnp.zeros((slots, hd), jnp.int8),
                       s=jnp.zeros((slots, 1), jnp.float32))
        ref = jax_kv_write(ref, jnp.asarray(idx), jnp.asarray(rows))
        pool = QTensor(q=torch.zeros(slots, hd, dtype=torch.int8),
                       s=torch.zeros(slots, 1))
        _kv_write(pool, t(idx), t(rows))
        assert_q_equal(pool, ref)
        table = np.array([[1, 3, 5], [2, 0, 4]], np.int32)
        got = _kv_read_pages(pool, t(table), ps, torch.float32)
        want = jax_kv_read_pages(ref, jnp.asarray(table), ps, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def jax_engine(jcfg, jparams, **kw):
    base = dict(multi_step=1, prefix_cache_entries=0, max_parked=0,
                attention_backend="xla", flight_ring=0)
    ecfg = JEngineConfig(**{**SHAPE, **base, **kw})
    return JInferenceEngine(jcfg, jparams, ecfg, kv_dtype=jnp.float32)


def port_engine(cfg, params, **kw):
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu")


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, KVQ["vocab_size"], n).tolist() for n in lens]


def run(eng, Req, requests):
    """Submit requests in rounds (each round runs to completion before the
    next); {rid: (tokens, reason, cached_tokens)}."""
    got = {}
    for rnd in requests:
        for rid, prompt, kw in rnd:
            p = prompt(got) if callable(prompt) else prompt
            eng.submit(Req(request_id=rid, prompt_ids=list(p), **kw))
        for rid, r in eng.run_to_completion().items():
            got[rid] = (list(r.output_ids), r.finish_reason,
                        r.cached_tokens)
    return got


def _batch(seed):
    lens, news = [7, 20, 5, 13], [12, 9, 10, 11]
    return [[(f"r{i}", p, dict(max_new_tokens=n))
             for i, (p, n) in enumerate(zip(prompts(seed, lens), news))]]


def _thread(seed):
    (p,) = prompts(seed, [21])
    return [[("a1", p, dict(max_new_tokens=6, prefix_key="A"))],
            [("a2", lambda got: p + got["a1"][0] + [5, 6, 7],
              dict(max_new_tokens=6, prefix_key="A"))]]


def _preempt(seed):
    ps = prompts(seed, [8, 6, 10])
    return [[(f"p{i}", p, dict(max_new_tokens=22))
             for i, p in enumerate(ps)]]


# (case, weights int8, kv_quantize, JAX backend, port backend, requests,
#  shape overrides)
CASES = {
    "int8_weights": (True, "", "xla", "auto", _batch(0), {}),
    "int8_kv_kernel_vs_pallas": (False, "int8", "pallas", "auto",
                                 _batch(1), {}),
    "int8_kv_plain_vs_xla": (False, "int8", "xla", "plain", _batch(2), {}),
    "both_int8_thread": (True, "int8", "xla", "auto", _thread(3),
                         dict(prefix_cache_entries=64)),
    "int8_kv_preemption": (False, "int8", "xla", "auto", _preempt(4),
                           dict(num_pages=10, max_batch=3)),
}


class TestEngineParity:
    @pytest.mark.parametrize("case", list(CASES))
    def test_greedy_streams_token_exact(self, model, case):
        jcfg, jparams, jq, cfg, params, qparams = model
        int8_w, kvq, jback, tback, requests, shape = CASES[case]
        jeng = jax_engine(jcfg, jq if int8_w else jparams, kv_quantize=kvq,
                          attention_backend=jback, **shape)
        port_shape = {k: v for k, v in shape.items()
                      if k != "prefix_cache_entries"}
        eng = port_engine(cfg, qparams if int8_w else params,
                          kv_quantize=kvq, attention_backend=tback,
                          **port_shape)
        assert isinstance(eng.k_pool, QTensor) == bool(kvq)
        want = run(jeng, JGenRequest, requests)
        kernels.reset_launch_counts()
        got = run(eng, GenRequest, requests)
        assert got == want
        assert eng.self_check() == []
        assert all(f.launches == 0 for f in kernels.KERNELS)  # CPU: plain
        if case == "both_int8_thread":
            assert got["a2"][2] > 0  # turn 2 read its quantized pages
        if case == "int8_kv_preemption":
            assert eng.preemptions > 0
            assert jeng.metrics.requests_preempted > 0

    def test_kv_quantize_is_validated(self, model):
        cfg, params = model[3], model[4]
        with pytest.raises(ValueError, match="unknown kv quantize mode"):
            port_engine(cfg, params, kv_quantize="fp8")


def test_logit_quality_metrics_match_jax(model):
    jcfg, jparams, jq, cfg, params, qparams = model
    ps = prompts(9, [12, 17])
    want = jax_logit_quality_metrics(jcfg, jparams, jq, ps)
    got = logit_quality_metrics(cfg, params, qparams, ps)
    assert got["positions"] == want["positions"] == 29
    for k in ("max_abs_dlogit", "kl_mean", "kl_p99", "margin_p50"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-5), k
    assert got["flip_rate"] == want["flip_rate"]
    assert got["flip_margin_max"] <= 2 * got["max_abs_dlogit"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serving_config_reads_the_quantize_knobs(monkeypatch):
    monkeypatch.setenv("KAFKA_TORCH_QUANTIZE", "int8")
    monkeypatch.setenv("KAFKA_TORCH_KV_QUANTIZE", "int8")
    cfg = ServingConfig.from_env()
    assert (cfg.quantize, cfg.kv_quantize) == ("int8", "int8")
    assert ServingConfig().quantize == ServingConfig().kv_quantize == ""


def test_int8_server_streams_a_thread_turn(monkeypatch, tmp_path):
    """build_provider quantizes the weights and allocates the int8 pool;
    a streamed thread turn ends with [DONE]; an unknown mode is refused.
    No tools but the agent's idle tool and a short system prompt keep the
    turn inside this 1024-token window."""
    from aiohttp.test_utils import TestClient, TestServer

    from kafka_tpu_torch.server.app import STATE_KEY, build_provider

    monkeypatch.setenv("KAFKA_TORCH_QUANTIZE", "int8")
    monkeypatch.setenv("KAFKA_TORCH_KV_QUANTIZE", "int8")
    cfg = ServingConfig.from_env(
        tiny_model=True, max_batch=2, page_size=16, num_pages=160,
        max_pages_per_seq=64, prefill_buckets=(16, 32, 64, 128),
        max_new_tokens_default=6, warmup=False, system_prompt="terse",
        db_path=str(tmp_path / "threads.db"))

    async def serve():
        app = await create_app(cfg, tools=[], mcp_servers=[], device="cpu")
        engine = app[STATE_KEY]["llm"].engine
        async with TestClient(TestServer(app)) as c:
            r = await c.post(
                "/v1/threads/q/chat/completions",
                json={"model": "tiny", "stream": True, "temperature": 0,
                      "max_tokens": 6,
                      "messages": [{"role": "user", "content": "int8?"}]})
            assert r.status == 200
            lines = [ln for ln in (await r.text()).splitlines()
                     if ln.startswith("data: ")]
        return engine, lines

    engine, lines = asyncio.run(serve())
    assert lines[-1] == "data: [DONE]"
    usage = next(json.loads(ln[6:])["usage"] for ln in lines[:-1]
                 if json.loads(ln[6:]).get("usage"))
    assert usage["completion_tokens"] == 6
    assert isinstance(engine.k_pool, QTensor)
    assert isinstance(engine.params["layers"]["wq"], QTensor)
    assert isinstance(engine.params["embed"], QTensor)
    with pytest.raises(ValueError, match="unknown kv_quantize"):
        build_provider(ServingConfig(tiny_model=True, kv_quantize="int4",
                                     warmup=False), device="cpu")
