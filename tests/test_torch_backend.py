"""kafka_tpu_torch attention backend resolution and model info (faults C5
and C6).

C5: the reference engine resolves `attention_backend="auto"` to its XLA
formulation wherever the Pallas kernels cannot take the model or the
device (kafka_tpu/runtime/engine.py `_resolve_backend`), so it serves the
tiny float32 model and any float32 model.  The port's "auto" resolves the
same way and says so: on CUDA it is "kernel" when `kernel_backend_problems`
is empty and otherwise "plain" with those problems as the logged reasons;
an explicit "kernel" with problems is still refused.  The resolution takes
the device type, so the CUDA rule is tested here on the CPU; one
`cuda`-marked test builds the tiny server's provider on the card.

C6: the port's `get_model_info` carries every key of the reference's
`TPULLMProvider.get_model_info`, with the same configuration values.
"""

import asyncio
import logging

import numpy as np
import pytest

import jax
import torch

from kafka_tpu.llm import TPULLMProvider
from kafka_tpu.models.config import ModelConfig as JModelConfig
from kafka_tpu.models.llama import init_params as jax_init_params
from kafka_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.llm import TorchLLMProvider
from kafka_tpu_torch.models import (
    ByteTokenizer,
    ModelConfig,
    get_config,
    params_from_jax,
)
from kafka_tpu_torch.runtime import EngineConfig, InferenceEngine
from kafka_tpu_torch.runtime.engine import (
    kernel_backend_problems,
    resolve_attention_backend,
)
from kafka_tpu_torch.server import ServingConfig, build_provider


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# C5: "auto" resolves the way the reference's does, out loud
# ---------------------------------------------------------------------------

# what the tiny server builds (server/app.py build_provider): the `tiny`
# preset in float32, D 16
TINY_F32 = get_config("tiny").replace(vocab_size=262, dtype="float32")
ECFG = EngineConfig(page_size=16, num_pages=160, max_pages_per_seq=64)


@pytest.mark.parametrize("cfg", [
    TINY_F32, get_config("llama-3.2-1b").replace(dtype="float32"),
], ids=["tiny-f32", "llama-3.2-1b-f32"])
def test_auto_resolves_to_plain_on_cuda_with_reasons(cfg):
    backend, reasons = resolve_attention_backend(cfg, ECFG, "cuda")
    assert backend == "plain"
    assert reasons and reasons == kernel_backend_problems(cfg, ECFG)
    assert all(isinstance(r, str) and r for r in reasons)
    assert "float32" in reasons[0]


def test_auto_resolves_to_kernel_on_cuda_for_bf16_llama():
    cfg = get_config("llama-3.2-1b")
    assert cfg.dtype == "bfloat16"
    assert resolve_attention_backend(cfg, ECFG, "cuda") == ("kernel", [])


def test_explicit_kernel_with_problems_is_refused_on_cuda():
    ecfg = EngineConfig(**{**vars(ECFG), "attention_backend": "kernel"})
    with pytest.raises(ValueError, match="head_dim 64 or 128"):
        resolve_attention_backend(TINY_F32, ecfg, "cuda")
    # without problems an explicit "kernel" is taken as asked
    assert resolve_attention_backend(get_config("llama-3.2-1b"), ecfg,
                                     "cuda") == ("kernel", [])


@pytest.mark.parametrize("choice", ["auto", "kernel"])
def test_cpu_resolves_to_kernel_as_before(choice):
    """On the CPU the wrappers run their plain versions: "auto" (and
    "kernel") stay "kernel" for any model, so no CPU test moves."""
    ecfg = EngineConfig(**{**vars(ECFG), "attention_backend": choice})
    assert resolve_attention_backend(TINY_F32, ecfg, "cpu") == ("kernel", [])


def test_plain_stays_plain_and_unknown_values_are_refused():
    ecfg = EngineConfig(**{**vars(ECFG), "attention_backend": "plain"})
    assert resolve_attention_backend(get_config("llama-3.2-1b"), ecfg,
                                     "cuda") == ("plain", [])
    bad = EngineConfig(**{**vars(ECFG), "attention_backend": "xla"})
    with pytest.raises(ValueError, match="'auto', 'kernel' or 'plain'"):
        resolve_attention_backend(TINY_F32, bad, "cpu")


def test_engine_keeps_the_resolution_and_reports_it(caplog):
    """The engine on the CPU: "auto" is the kernel backend (its plain
    versions) with no reasons and no warning; the provider reports it."""
    from kafka_tpu_torch.models import init_params

    params = init_params(TINY_F32, torch.Generator().manual_seed(0))
    with caplog.at_level(logging.WARNING, "kafka_tpu_torch.engine"):
        eng = InferenceEngine(TINY_F32, params, ECFG, device="cpu")
    assert eng.cfg.attention_backend == "kernel"
    assert eng.attention_backend_reasons == []
    assert not [r for r in caplog.records if "resolved" in r.getMessage()]
    provider = TorchLLMProvider(eng, ByteTokenizer())
    try:
        assert provider.get_model_info()["attention_backend"] == "kernel"
    finally:
        asyncio.run(provider.aclose())


@pytest.mark.cuda
def test_tiny_server_boots_on_the_card_with_plain_attention(tmp_path,
                                                            caplog):
    """The tiny float32 server on CUDA: "auto" resolves to "plain", the
    reasons are logged, and the provider reports the choice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA resolution of 'auto')")
    cfg = ServingConfig(tiny_model=True, max_batch=2, page_size=16,
                        num_pages=160, max_pages_per_seq=64,
                        prefill_buckets=(16, 32, 64, 128), warmup=False,
                        db_path=str(tmp_path / "t.db"))
    with caplog.at_level(logging.WARNING, "kafka_tpu_torch.engine"):
        provider = build_provider(cfg)
    try:
        assert provider.get_model_info()["attention_backend"] == "plain"
        assert provider.engine.attention_backend_reasons
        assert [r for r in caplog.records
                if "resolved to 'plain'" in r.getMessage()]
    finally:
        asyncio.run(provider.aclose())


# ---------------------------------------------------------------------------
# C6: get_model_info parity with the reference's provider
# ---------------------------------------------------------------------------

# tests/test_llm_provider.py's provider model and engine shape
MODEL = dict(name="llm-test", vocab_size=262, hidden_size=64,
             intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, dtype="float32", max_context=2048)
SHAPE = dict(max_batch=4, page_size=16, num_pages=128, max_pages_per_seq=8,
             prefill_buckets=(16, 32, 64, 128), speculative_k=2)


def test_model_info_carries_every_key_of_the_reference():
    jcfg = JModelConfig(**MODEL)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(11))
    jeng = JInferenceEngine(jcfg, jparams, JEngineConfig(**SHAPE),
                            kv_dtype=None)
    eng = InferenceEngine(
        ModelConfig(**MODEL),
        params_from_jax(jax.tree.map(np.asarray, jparams)),
        EngineConfig(**SHAPE), device="cpu")
    ref = TPULLMProvider(jeng, JByteTokenizer(), model_name="tiny-test")
    port = TorchLLMProvider(eng, ByteTokenizer(), model_name="tiny-test")
    try:
        want, got = ref.get_model_info(), port.get_model_info()
    finally:
        asyncio.run(ref.aclose())
        asyncio.run(port.aclose())
    assert set(want) <= set(got), set(want) - set(got)
    shared = set(want) - {"id", "provider"}
    assert {"max_context", "max_window", "vocab_size", "supports_tools",
            "supports_streaming", "speculative_k",
            "grammar_ondevice"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["speculative_k"] == 2
