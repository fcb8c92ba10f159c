"""The tensor-parallel engine on two cards (NCCL, decode graphs).

Marked `cuda`: it needs two NVIDIA GPUs (NCCL refuses two ranks on one
card) and skips without them.  On a machine with them:

    python -m pytest tests/test_torch_tp_cuda.py -q

A small bf16 model (D 64, kernel geometry) with random weights drawn per
rank (RandomWeights) runs as a tp-2 rank group and as one engine on one
card over the same weights (init_params_shard with no mesh): the first
greedy token and its logits agree within chip_smoke.py's 5% logits
tolerance, and both ranks launched the per-rank decode kernel (K1) inside
their decode graph replays.  The CPU parity tests are in
tests/test_torch_tp.py.
"""

import pytest
import torch

from kafka_tpu_torch.models import ModelConfig
from kafka_tpu_torch.parallel import MeshConfig, RandomWeights, init_params_shard
from kafka_tpu_torch.runtime import EngineConfig, InferenceEngine

pytestmark = pytest.mark.cuda

CFG = ModelConfig(name="tp-cuda", vocab_size=512, hidden_size=512,
                  intermediate_size=1024, num_layers=2, num_heads=8,
                  num_kv_heads=4, head_dim=64, tie_word_embeddings=False)
ECFG = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=16,
            prefill_buckets=(16, 32), keep_logits=True,
            attention_backend="kernel")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (one per rank: NCCL refuses two "
                    "ranks on one card)")


def test_tp_engine_on_two_cards(two_cards):
    prompt = [5, 99, 23, 4, 17, 42, 7, 300]
    single = InferenceEngine(
        CFG, init_params_shard(CFG, 1, None, device="cuda:0"),
        EngineConfig(**ECFG), device="cuda:0")
    want = single.generate(prompt, max_new_tokens=6)
    eng = InferenceEngine(CFG, RandomWeights(seed=1), EngineConfig(**ECFG),
                          mesh=MeshConfig(tp=2))
    try:
        eng.rank_query("rank_reset_launches")
        got = eng.generate(prompt, max_new_tokens=6)
        launches = eng.rank_query("rank_launches")
    finally:
        eng.close()
    assert got.output_ids[0] == want.output_ids[0]
    la, lb = got.logits[0], want.logits[0]
    assert ((la - lb).abs().max() / lb.abs().max()).item() <= 0.05
    for per_rank in launches:
        assert per_rank["paged_decode_attention_sharded"] > 0
