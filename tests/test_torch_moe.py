"""kafka_tpu_torch's Mixtral-class MoE and expert parallelism vs the JAX
package.

Mirrors tests/test_moe.py and tests/test_pp_ep.py's TestExpertParallel on
the same numpy-seeded inputs (JAX init_params weights handed over with
params_from_jax), on the CPU:

* the MoE block and moe_mlp_reference equal JAX's in float32 (atol/rtol
  2e-5, the reference's own tolerance for the block), and the
  expert-sharded MLP over a two-rank gloo group equals JAX's over its ep
  mesh (1e-5);
* routing with forced top-k ties equals lax.top_k's order exactly;
* greedy engine streams on the reference's `moe-test` shape are
  token-exact against the JAX engine: float32, int8 experts (whose codes
  and scales equal JAX's quantize_params byte for byte), ep 2 and
  ep 2 x tp 2 rank groups against the JAX ep and ep x tp mesh engines;
* the Mixtral checkpoint layout: a tiny in-memory
  transformers.MixtralForCausalLM converted by both loaders gives equal
  params and logits within 2e-4 of transformers'; config_from_hf_json
  reads a Mixtral config.json;
* kernel_mesh_ok equals pallas_mesh_ok on ep meshes, so "auto" resolves
  to the plain attention at ep > 1, with the reason;
* the refusals: ep on a dense model, experts ep does not divide, MoE at
  pp > 1, dp x ep; random shards equal slices of the whole; the memory
  plan's MoE weights equal the engine's tensors.

Rank groups are gloo processes spawned once per module (FileStore under
tmp_path) and closed by their fixture; environment through monkeypatch.
"""

import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.models import quantize_params as jquantize_params
from kafka_tpu.models.config import get_config as jget_config
from kafka_tpu.models.llama import _moe_block as j_moe_block
from kafka_tpu.models.llama import _routing_weights as j_routing_weights
from kafka_tpu.ops.pallas import pallas_mesh_ok
from kafka_tpu.parallel import MeshConfig as JMeshConfig
from kafka_tpu.parallel import make_mesh as jmake_mesh
from kafka_tpu.parallel.expert import init_moe_params as jinit_moe_params
from kafka_tpu.parallel.expert import moe_mlp_reference as jmoe_reference
from kafka_tpu.parallel.expert import moe_mlp_sharded as jmoe_sharded
from kafka_tpu.parallel.expert import shard_moe_params as jshard_moe
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.models import (
    ModelConfig,
    get_config,
    params_from_jax,
    quantize_params,
)
from kafka_tpu_torch.models.llama import _moe_block, _routing_weights
from kafka_tpu_torch.models.quant import QTensor, param_bytes
from kafka_tpu_torch.ops.kernels import kernel_mesh_ok
from kafka_tpu_torch.parallel import (
    MeshConfig,
    RankGroup,
    RankMesh,
    init_params_shard,
    moe_mlp_reference,
    moe_mlp_sharded,
    param_specs,
    shard_moe_params,
    shard_params,
)
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime.engine import resolve_attention_backend

CPU = torch.device("cpu")
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_moe.py's block check
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_pp_ep.py's ep check
HF_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_moe.py's HF check

# tests/test_moe.py's model
MOE = dict(name="moe-test", vocab_size=128, hidden_size=64,
           intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=16, dtype="float32", num_experts=4,
           num_experts_per_tok=2)
SHAPE = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))
PROMPTS = {"a": [3, 9, 27, 81], "b": [100] * 11, "c": [7, 6, 5]}
PROMPT = [5, 2, 9, 31, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**MOE)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jparams, ModelConfig(**MOE), params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """One gloo rank group per (tp, ep), shared across the module."""
    made = {}

    def get(tp, ep):
        if (tp, ep) not in made:
            made[(tp, ep)] = RankGroup(
                MeshConfig(tp=tp, ep=ep), device="cpu", timeout_s=60,
                store_dir=str(tmp_path_factory.mktemp(f"tp{tp}ep{ep}")))
        return made[(tp, ep)]

    yield get
    for g in made.values():
        g.close()


def jax_engine(jcfg, jparams, mesh=None, **kw):
    ecfg = JEngineConfig(**{**SHAPE, **kw}, multi_step=1,
                         prefix_cache_entries=0, max_parked=0,
                         attention_backend="xla", flight_ring=0)
    return JInferenceEngine(jcfg, jparams, ecfg, kv_dtype=jnp.float32,
                            mesh=mesh)


def port_engine(cfg, params, mesh=None, **kw):
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu", mesh=mesh)


def run_all(eng, Req, prompts, **kw):
    for rid, p in prompts.items():
        eng.submit(Req(request_id=rid, prompt_ids=list(p), **kw))
    done = eng.run_to_completion()
    return {rid: list(done[rid].output_ids) for rid in prompts}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# the block, routing, the expert module
# ---------------------------------------------------------------------------


def test_moe_block_matches_jax_and_reference(model):
    """_moe_block equals JAX's layer by layer, and the port's
    moe_mlp_reference equals both (tests/test_moe.py:43)."""
    jcfg, jparams, cfg, params = model
    x = np.random.RandomState(3).randn(2, 5, 64).astype(np.float32)
    for layer in range(cfg.num_layers):
        lp = {k: v[layer] for k, v in jparams["layers"].items()}
        want = np.asarray(j_moe_block(jnp.asarray(x), lp, jcfg))
        got = _moe_block(torch.from_numpy(x), params["layers"], layer, cfg)
        np.testing.assert_allclose(_np(got), want, **BLOCK_TOL)
        ref = moe_mlp_reference(
            torch.from_numpy(x).reshape(-1, 64),
            {k: params["layers"][k][layer]
             for k in ("router", "wg", "wu", "wd")},
            top_k=cfg.num_experts_per_tok)
        np.testing.assert_allclose(_np(ref).reshape(x.shape), want,
                                   **BLOCK_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_reference_matches_jax(top_k):
    jp = jinit_moe_params(jax.random.PRNGKey(3), num_experts=8, hidden=32,
                          ffn=64)
    x = np.random.RandomState(4).randn(10, 32).astype(np.float32)
    want = np.asarray(jmoe_reference(jnp.asarray(x), jp, top_k=top_k))
    got = moe_mlp_reference(
        torch.from_numpy(x),
        {k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
        top_k=top_k)
    np.testing.assert_allclose(_np(got), want, **SHARD_TOL)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_routing_with_forced_ties_matches_lax_top_k(top_k):
    """Equal router columns force equal logits: lax.top_k takes the lower
    expert first, and so must the port (torch.topk does not promise
    it).  Whole rows tie, pairs tie, and a k-th place ties."""
    rng = np.random.RandomState(7)
    h, e = 16, 6
    base = rng.randn(h, 3).astype(np.float32)
    # columns 0=2=5, 1=4, 3 alone: ties everywhere in the ranking
    router = np.stack([base[:, 0], base[:, 1], base[:, 0], base[:, 2],
                       base[:, 1], base[:, 0]], axis=1)
    x = rng.randn(12, h).astype(np.float32)
    x[0] = 0.0                                # a row of six equal logits
    want = np.asarray(j_routing_weights(jnp.asarray(x), jnp.asarray(router),
                                        top_k))
    got = _routing_weights(torch.from_numpy(x), torch.from_numpy(router),
                           top_k)
    assert got.shape == (12, e) and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got) > 0, want > 0)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)
    assert ((_np(got) > 0).sum(1) == top_k).all()
    # the all-equal row picks experts 0..k-1
    assert list(np.nonzero(_np(got)[0])[0]) == list(range(top_k))


def test_expert_sharded_mlp_over_a_gloo_group_matches_jax(tmp_path):
    """moe_mlp_sharded on two in-process gloo ranks equals JAX's
    moe_mlp_sharded over an ep=2 mesh and the dense reference
    (tests/test_pp_ep.py:138)."""
    jp = jinit_moe_params(jax.random.PRNGKey(5), num_experts=4, hidden=16,
                          ffn=32)
    x = np.random.RandomState(6).randn(6, 16).astype(np.float32)
    mesh = jmake_mesh(JMeshConfig(ep=2))
    want = np.asarray(jmoe_sharded(mesh, jnp.asarray(x),
                                   jshard_moe(jp, mesh), top_k=2))
    full = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    store = torch.distributed.FileStore(str(tmp_path / "store"), 2)
    outs, errs = [None, None], []

    def rank(r):
        try:
            pg = torch.distributed.ProcessGroupGloo(store, r, 2)
            outs[r] = moe_mlp_sharded(torch.from_numpy(x),
                                      shard_moe_params(full, 2, r), pg,
                                      ep=2, index=r, top_k=2)
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and not any(t.is_alive() for t in threads), errs
    for out in outs:
        np.testing.assert_allclose(_np(out), want, **SHARD_TOL)
    np.testing.assert_allclose(
        _np(moe_mlp_reference(torch.from_numpy(x), full)), want, **SHARD_TOL)


def test_registry_configs_equal_the_reference():
    for name in ("tiny-moe", "mixtral-8x7b"):
        j, p = jget_config(name), get_config(name)
        for field in ("vocab_size", "hidden_size", "intermediate_size",
                      "num_layers", "num_heads", "num_kv_heads", "head_dim",
                      "rope_theta", "max_context", "tie_word_embeddings",
                      "num_experts", "num_experts_per_tok", "dtype"):
            assert getattr(p, field) == getattr(j, field), (name, field)
        assert p.is_moe
    assert not get_config("tiny").is_moe


# ---------------------------------------------------------------------------
# engines on one device
# ---------------------------------------------------------------------------


def test_engine_streams_match_jax(model):
    """Greedy streams of the serving engine (paged prefill and decode,
    three lanes) on the MoE model, token-exact against the JAX engine."""
    jcfg, jparams, cfg, params = model
    want = run_all(jax_engine(jcfg, jparams), JGenRequest, PROMPTS,
                   max_new_tokens=8)
    got = run_all(port_engine(cfg, params), GenRequest, PROMPTS,
                  max_new_tokens=8)
    assert got == want


def test_int8_experts_equal_the_reference_byte_for_byte(model):
    """quantize_params on a MoE tree: every QTensor's codes and scales
    equal JAX's quantize_params (experts contract axis 2, one scale per
    layer, expert and output channel; the router stays dense), and the
    int8 engine's streams are token-exact against the JAX int8 engine."""
    jcfg, jparams, cfg, params = model
    jq = jquantize_params(jparams, jcfg)
    got = quantize_params(params, cfg)
    assert quantize_params(params)["layers"]["wg"].s.shape == \
        got["layers"]["wg"].s.shape == (2, 4, 1, 96)
    assert not isinstance(got["layers"]["router"], QTensor)
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        j, p = jq["layers"][name], got["layers"][name]
        np.testing.assert_array_equal(_np(p.q), np.asarray(j.q))
        np.testing.assert_array_equal(_np(p.s), np.asarray(j.s))
    np.testing.assert_array_equal(_np(got["embed"].q), np.asarray(
        jq["embed"].q))
    want = run_all(jax_engine(jcfg, jq), JGenRequest, PROMPTS,
                   max_new_tokens=8)
    q8 = params_from_jax(jax.tree.map(np.asarray, jq))
    assert run_all(port_engine(cfg, q8), GenRequest, PROMPTS,
                   max_new_tokens=8) == want


# ---------------------------------------------------------------------------
# the Mixtral checkpoint layout
# ---------------------------------------------------------------------------


def test_hf_mixtral_state_dict_converts_like_the_reference():
    """A tiny in-memory MixtralForCausalLM through both loaders: equal
    parameters, and the port's logits within 2e-4 of transformers'
    (tests/test_moe.py:123)."""
    transformers = pytest.importorskip("transformers")
    from kafka_tpu.models.loader import convert_hf_state_dict as jconvert
    from kafka_tpu_torch.models import convert_hf_state_dict, forward

    hf_cfg = transformers.MixtralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2, rope_theta=10000.0,
        max_position_embeddings=128)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg).eval()
    kw = dict(name="tiny-mixtral", vocab_size=96, hidden_size=32,
              intermediate_size=48, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=8, rope_theta=10000.0,
              dtype="float32", tie_word_embeddings=False, num_experts=4,
              num_experts_per_tok=2)
    cfg = ModelConfig(**kw)
    state = hf.state_dict()
    params = convert_hf_state_dict(state, cfg, dtype=torch.float32)
    jparams = jconvert(state, JModelConfig(**kw), dtype=jnp.float32)
    assert params["layers"]["wg"].shape == (2, 4, 32, 48)
    assert params["layers"]["wd"].shape == (2, 4, 48, 32)
    assert params["layers"]["router"].shape == (2, 32, 4)
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(_np(params["layers"][k]),
                                      np.asarray(v), err_msg=k)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_np(params[k]), np.asarray(jparams[k]))
    ids = [[1, 17, 3, 44, 9, 60, 2]]
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    got, _ = forward(params, cfg, torch.tensor(ids),
                     torch.arange(len(ids[0]))[None])
    np.testing.assert_allclose(_np(got), want, **HF_TOL)


def test_config_from_hf_json_reads_mixtral(tmp_path):
    from kafka_tpu.models.config import config_from_hf_json as jfrom_json
    from kafka_tpu_torch.models import config_from_hf_json

    d = tmp_path / "Mixtral-8x7B-v0.1"
    d.mkdir()
    hf = {"architectures": ["MixtralForCausalLM"], "vocab_size": 32000,
          "hidden_size": 4096, "intermediate_size": 14336,
          "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 8, "rope_theta": 1e6,
          "max_position_embeddings": 32768, "num_local_experts": 8,
          "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
          "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    (d / "config.json").write_text(json.dumps(hf))
    got = config_from_hf_json(str(d / "config.json"))
    want = jfrom_json(str(d / "config.json"))
    mix = get_config("mixtral-8x7b")
    assert got.is_moe and got.num_experts == 8 == want.num_experts
    assert got.num_experts_per_tok == 2 == want.num_experts_per_tok
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "rope_theta", "max_context", "num_experts"):
        assert getattr(got, field) == getattr(mix, field), field
    # a dense config.json stays dense
    hf.pop("num_local_experts")
    (d / "config.json").write_text(json.dumps(hf))
    assert not config_from_hf_json(str(d / "config.json")).is_moe


# ---------------------------------------------------------------------------
# expert parallelism: rank groups against the JAX mesh engines
# ---------------------------------------------------------------------------


def test_ep2_engine_matches_jax(model, groups):
    """ep 2 (two gloo ranks, two experts each, attention replicated):
    token-exact against the JAX ep=2 mesh engine over three lanes; the
    attention is the plain gather, as the reference resolves it."""
    jcfg, jparams, cfg, params = model
    want = run_all(jax_engine(jcfg, jparams,
                              mesh=jmake_mesh(JMeshConfig(ep=2))),
                   JGenRequest, PROMPTS, max_new_tokens=8)
    eng = port_engine(cfg, params, groups(1, 2))
    try:
        assert eng.cfg.attention_backend == "plain"
        assert "ep=2" in eng.attention_backend_reasons[0]
        assert eng.tp.experts == slice(0, 2)
        got = run_all(eng, GenRequest, PROMPTS, max_new_tokens=8)
        mem = eng.rank_query("rank_memory")
    finally:
        eng.close()
    assert got == want
    # every rank holds half the experts and the whole attention and pool
    shard = init_params_shard(cfg, 0, RankMesh(1, 1, 1, CPU, ep=2))
    assert [m["weights"] for m in mem] == [param_bytes(shard)] * 2


def test_ep2_x_tp2_engine_matches_jax(model, groups):
    """ep 2 x tp 2 (four ranks: tensor groups {0, 2} and {1, 3}):
    token-exact against the JAX (ep 2, tp 2) mesh engine, fused
    multi-step decode included."""
    jcfg, jparams, cfg, params = model
    mesh = jmake_mesh(JMeshConfig(ep=2, tp=2))
    want = jax_engine(jcfg, jparams, mesh=mesh).generate(
        PROMPT, max_new_tokens=8).output_ids
    eng = port_engine(cfg, params, groups(2, 2))
    try:
        assert eng.mesh.size == 4 and eng.mesh.tensor_size == 2
        assert eng.generate(PROMPT, max_new_tokens=8).output_ids == want
    finally:
        eng.close()
    want = run_all(jax_engine(jcfg, jparams, mesh=mesh), JGenRequest,
                   PROMPTS, max_new_tokens=12)
    eng = port_engine(cfg, params, groups(2, 2), multi_step=4)
    try:
        assert run_all(eng, GenRequest, PROMPTS, max_new_tokens=12) == want
    finally:
        eng.close()


def test_ep2_int8_experts_and_kv_match_jax(model, groups):
    """ep 2 over int8 experts and an int8 KV pool: token-exact against the
    JAX ep=2 mesh engine over the same quantized tree."""
    jcfg, jparams, cfg, _ = model
    jq = jquantize_params(jparams, jcfg)
    want = jax_engine(jcfg, jq, mesh=jmake_mesh(JMeshConfig(ep=2)),
                      kv_quantize="int8").generate(
        PROMPT, max_new_tokens=8).output_ids
    eng = port_engine(cfg, params_from_jax(jax.tree.map(np.asarray, jq)),
                      groups(1, 2), kv_quantize="int8")
    try:
        assert eng.generate(PROMPT, max_new_tokens=8).output_ids == want
    finally:
        eng.close()


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_random_moe_shard_equals_the_whole(model, quantize):
    """init_params_shard draws every (tensor, layer, expert) from its own
    seed: rank r of ep 2 x tp 2 holds exactly shard_params' slice of the
    whole model drawn from the same seed, so a single-card engine and an
    ep group hold the same weights; only the rank's experts are drawn."""
    cfg = model[2]
    whole = init_params_shard(cfg, 5, None, quantize=quantize)
    wg = whole["layers"]["wg"]
    assert (wg.q if quantize else wg).shape == (2, 4, 64, 96)
    for r in range(4):
        mesh = RankMesh(2, 1, r, CPU, ep=2)
        got = init_params_shard(cfg, 5, mesh, quantize=quantize)
        want = shard_params(whole, cfg, mesh)
        flat_g = jax.tree_util.tree_leaves({**got, "layers": got["layers"]})
        flat_w = jax.tree_util.tree_leaves({**want,
                                            "layers": want["layers"]})
        assert len(flat_g) == len(flat_w)
        for a, b in zip(flat_g, flat_w):
            assert torch.equal(a, b)
        wg = got["layers"]["wg"]
        assert (wg.q if quantize else wg).shape == (2, 2, 64, 48)


def test_param_specs_equal_the_reference(model):
    """The MoE branch of param_specs: the same axes as the JAX
    PartitionSpecs at ep 2, ep 2 x tp 2, and ep that does not divide."""
    from kafka_tpu.parallel import param_specs as jparam_specs

    jcfg, _, cfg, _ = model
    for kw in (dict(ep=2), dict(ep=2, tp=2), dict(ep=4, tp=2)):
        jspecs = jparam_specs(jcfg, jmake_mesh(JMeshConfig(**kw)))
        specs = param_specs(cfg, MeshConfig(**kw))
        for k, v in jspecs["layers"].items():
            want = tuple(v) + (None,) * (
                len(specs["layers"][k]) - len(tuple(v)))
            assert specs["layers"][k] == want or (
                not any(specs["layers"][k]) and not any(tuple(v))), (kw, k)


def test_kernel_mesh_ok_equals_pallas_mesh_ok_on_ep_meshes():
    """The per-rank kernels' rule equals the reference's on ep meshes (no
    kernel at ep > 1), and "auto" resolves to plain there with a
    reason; an explicit "kernel" is refused."""
    for kw in (dict(ep=2), dict(ep=4), dict(ep=2, tp=2), dict(ep=4, tp=2),
               dict(ep=2, tp=2, tq=2), dict(ep=8)):
        jmesh = jmake_mesh(JMeshConfig(**kw))
        for hq, hkv in ((4, 2), (8, 4), (32, 8), (8, 1)):
            assert kernel_mesh_ok(MeshConfig(**kw), hq, hkv) == \
                pallas_mesh_ok(jmesh, hq, hkv) is False, (kw, hq, hkv)
    cfg = get_config("tiny-moe")
    backend, why = resolve_attention_backend(cfg, EngineConfig(), "cpu",
                                             mesh=MeshConfig(ep=2))
    assert backend == "plain" and "ep=2" in why[0]
    with pytest.raises(ValueError, match="ep=2"):
        resolve_attention_backend(
            cfg, EngineConfig(attention_backend="kernel"), "cpu",
            mesh=MeshConfig(ep=2))


def test_engine_refusals(model):
    """The reference's construction checks (tests/test_moe.py:109): ep on
    a dense model names "dense", experts that ep does not divide name
    "divisible", MoE at pp > 1 is refused; all before any rank spawns.
    The DP router and the server name dp x ep."""
    from kafka_tpu_torch.runtime.dp_router import DataParallelEngines
    from kafka_tpu_torch.runtime.engine import validate_tensor_parallel
    from kafka_tpu_torch.server import ServingConfig
    from kafka_tpu_torch.server.app import _tensor_mesh

    _, _, cfg, params = model
    dense = ModelConfig(dtype="float32")
    with pytest.raises(ValueError, match="dense"):
        port_engine(dense, init_params_shard(dense, 0), MeshConfig(ep=2))
    with pytest.raises(ValueError, match="divisible"):
        port_engine(cfg, params, MeshConfig(ep=8))
    with pytest.raises(ValueError, match="MoE"):
        validate_tensor_parallel(cfg, EngineConfig(), MeshConfig(pp=2))
    with pytest.raises(ValueError, match="dp x ep"):
        DataParallelEngines(cfg, params, EngineConfig(**SHAPE), dp=2, ep=2,
                            devices=[CPU, CPU])
    with pytest.raises(ValueError, match="dp x ep"):
        _tensor_mesh(ServingConfig(model_name="tiny-moe", ep_size=2,
                                   dp_size=2))
    with pytest.raises(ValueError, match="A9"):
        _tensor_mesh(ServingConfig(model_name="tiny-moe", ep_size=2,
                                   checkpoint_dir="/nonexistent"))
    assert _tensor_mesh(ServingConfig(model_name="mixtral-8x7b", ep_size=2,
                                      tp_size=2)) == MeshConfig(tp=2, ep=2)


def test_serving_config_reads_the_ep_axis(monkeypatch):
    from kafka_tpu_torch.server import ServingConfig

    monkeypatch.delenv("KAFKA_TORCH_EP", raising=False)
    monkeypatch.setenv("KAFKA_TORCH_EP_SIZE", "2")
    assert ServingConfig.from_env().ep_size == 2
    monkeypatch.delenv("KAFKA_TORCH_EP_SIZE")
    monkeypatch.setenv("KAFKA_TORCH_EP", "4")
    assert ServingConfig.from_env().ep_size == 4
    monkeypatch.delenv("KAFKA_TORCH_EP")
    assert ServingConfig.from_env().ep_size == 1


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_plan_weights_equal_the_engine_tensors(model, quantize):
    """The planner's MoE weight term against real trees: one device, and
    each rank of ep 2 (tp 1, where every scale follows its weight), dense
    and int8 — within the embedding's scale bytes, which the reference's
    arithmetic counts per column instead of per row.  The int8 MoE plan
    also charges one dequantized expert stack (f32 product + copy)."""
    from kafka_tpu_torch.runtime.planner import (
        moe_activation_bytes,
        weight_bytes_per_device,
    )

    cfg = model[2]
    slack = (cfg.vocab_size - cfg.hidden_size) * 4 if quantize else 0
    whole = init_params_shard(cfg, 1, None, quantize=quantize)
    assert param_bytes(whole) - weight_bytes_per_device(
        cfg, quantize=quantize) == slack
    for r in range(2):
        shard = init_params_shard(cfg, 1, RankMesh(1, 1, r, CPU, ep=2),
                                  quantize=quantize)
        assert param_bytes(shard) - weight_bytes_per_device(
            cfg, ep=2, quantize=quantize) == slack
    e, h, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    extra = moe_activation_bytes(cfg, prefill_bucket=8, quantize=quantize)
    trio = 8 * e * (3 * f + h) * 4 - 8 * (h + 2 * f) * 2
    assert extra == trio + (e * h * f * 8 if quantize else 0)
    mix = get_config("mixtral-8x7b")
    dq = moe_activation_bytes(mix, prefill_bucket=1, quantize="int8") - \
        moe_activation_bytes(mix, prefill_bucket=1)
    assert dq == 8 * 4096 * 14336 * 6   # ~2.8 GB on one card
