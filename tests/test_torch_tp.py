"""kafka_tpu_torch tensor parallelism vs the JAX package's tp(/tq) mesh.

Each case mirrors a test of tests/test_parallel.py on the 8-device CPU
mesh that tests/conftest.py sets up, on the same numpy-seeded weights and
prompts: the JAX engine runs over a real mesh; the port's engine is rank
0 of a gloo rank group whose other ranks are spawned processes (rendezvous
through a FileStore under tmp_path, one intra-op thread per rank, every
join and collective under a deadline).  One rank group per (tp, tq) is
shared across the module and torn down by its fixture.

Greedy streams are token-exact against the JAX mesh engine (tp 2 and
tp 2 x tq 2, fused multi-step, int8 weights + int8 KV, speculation);
logits are held to atol 1e-4 against the port's single-device engine,
as tests/test_torch_llama.py holds them; rank r's pool equals column
block r // tq of the JAX engine's pool.  The per-rank plain K1/K3/K4
are held against the JAX sharded wrappers run with interpret=True.  A
killed rank gives DistributedStepError, not a hang, and leaves no
process behind.  The two-card run of the same engine is in
tests/test_torch_tp_cuda.py (marked `cuda`).
"""

import asyncio
import json
import os
import signal
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.models import quantize_params as jquantize_params
from kafka_tpu.models.config import ModelConfig as JModelConfig
from kafka_tpu.ops.pallas import (
    paged_decode_attention_int8_sharded as jdecode_int8_sharded,
    paged_decode_attention_sharded as jdecode_sharded,
    paged_verify_attention_sharded as jverify_sharded,
    pallas_mesh_ok,
)
from kafka_tpu.parallel import (
    MeshConfig as JMeshConfig,
    make_mesh as jmake_mesh,
    param_specs as jparam_specs,
    shard_params as jshard_params,
)
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu_torch.models import ModelConfig, params_from_jax
from kafka_tpu_torch.models.quant import quantize_array
from kafka_tpu_torch.ops.kernels import (
    kernel_mesh_ok,
    paged_decode_attention_int8_sharded,
    paged_decode_attention_sharded,
    paged_verify_attention_sharded,
)
from kafka_tpu_torch.parallel import (
    DistributedStepError,
    MeshConfig,
    RankGroup,
    RankMesh,
    factor_tp_for_kv,
    init_params_shard,
    param_specs,
    resolve_tensor_axes,
    shard_kv_pool,
    shard_params,
)
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime.engine import resolve_attention_backend

CPU = torch.device("cpu")
ATOL = 1e-4  # logits (tests/test_torch_llama.py)
KTOL = dict(atol=2e-5, rtol=2e-5)  # kernels (tests/test_torch_kernels.py)

MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=8, head_dim=8, dtype="float32")
SHAPE = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8,
             prefill_buckets=(8, 16))
PROMPT = [5, 99, 23, 4, 17, 42]
PROMPTS = {"a": [3, 9, 27, 81], "b": [100] * 11, "c": [7, 6, 5], "d": [1, 2]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(kv_heads, seed, tied=True):
    kw = dict(MODEL, num_kv_heads=kv_heads, tie_word_embeddings=tied)
    jcfg = JModelConfig(name=f"par-test-kv{kv_heads}", **kw)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(seed))
    cfg = ModelConfig(name=jcfg.name, **kw)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


@pytest.fixture(scope="module")
def model():
    """tests/test_parallel.py's model: Hq 8 over Hkv 4."""
    return _models(4, 3)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """One gloo rank group per (tp, tq), shared across the module."""
    made = {}

    def get(tp, tq=1):
        if (tp, tq) not in made:
            made[(tp, tq)] = RankGroup(
                MeshConfig(tp=tp, tq=tq), device="cpu", timeout_s=60,
                store_dir=str(tmp_path_factory.mktemp(f"tp{tp}tq{tq}")))
        return made[(tp, tq)]

    yield get
    for g in made.values():
        g.close()


def jax_engine(jcfg, jparams, tp, tq=1, **kw):
    mesh = jmake_mesh(JMeshConfig(tp=tp, tq=tq))
    return JInferenceEngine(jcfg, jparams, JEngineConfig(**{**SHAPE, **kw}),
                            kv_dtype=jnp.float32, mesh=mesh)


def port_engine(cfg, params, mesh=None, **kw):
    return InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                           kv_dtype=torch.float32, device="cpu", mesh=mesh)


def run_all(eng, Req, prompts, **kw):
    for rid, p in prompts.items():
        eng.submit(Req(request_id=rid, prompt_ids=list(p), **kw))
    done = eng.run_to_completion()
    return {rid: list(done[rid].output_ids) for rid in prompts}


# ---------------------------------------------------------------------------
# engines (tests/test_parallel.py TestTPSharding)
# ---------------------------------------------------------------------------


def test_tp_engine_matches_single_device(model, groups):
    """tp 2: the JAX mesh engine's stream token for token, logits within
    1e-4 of the single-device engine's, and rank r's pool equal to column
    block r of the JAX engine's pool (test_parallel.py:55)."""
    jcfg, jparams, cfg, params = model
    jeng = jax_engine(jcfg, jparams, tp=2)
    want = jeng.generate(PROMPT, max_new_tokens=10).output_ids

    eng = port_engine(cfg, params, groups(2), keep_logits=True)
    try:
        assert eng.cfg.attention_backend == "kernel"
        got = eng.generate(PROMPT, max_new_tokens=10)
        assert got.output_ids == want
        single = port_engine(cfg, params, keep_logits=True).generate(
            PROMPT, max_new_tokens=10)
        np.testing.assert_allclose(torch.stack(got.logits).numpy(),
                                   torch.stack(single.logits).numpy(),
                                   atol=ATOL, rtol=0)
        jk, jv = (np.array(jeng.k_pool), np.array(jeng.v_pool))
        for r, (k, v) in enumerate(eng.rank_query("rank_pools")):
            mesh = RankMesh(2, 1, r, CPU)
            wk, wv = shard_kv_pool(torch.from_numpy(jk),
                                   torch.from_numpy(jv), cfg, mesh)
            assert k.shape == wk.shape == (2, 32 * 8, 2 * 8)
            # page 0 is the trash page: idle lanes' writes land there
            np.testing.assert_allclose(k[:, 8:].numpy(), wk[:, 8:].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(v[:, 8:].numpy(), wv[:, 8:].numpy(),
                                       atol=1e-5)
            assert k[:, 8:].abs().sum() > 0
    finally:
        eng.close()


def test_tp_engine_fused_multistep_matches(model, groups):
    """Fused 4-step decode on the rank group is token-exact against the
    JAX mesh engine, and the fused dispatch actually ran
    (test_parallel.py:86)."""
    jcfg, jparams, cfg, params = model
    shape = dict(max_batch=4, num_pages=64)
    want = run_all(jax_engine(jcfg, jparams, tp=2, multi_step=4, **shape),
                   JGenRequest, PROMPTS, max_new_tokens=16)
    eng = port_engine(cfg, params, groups(2), multi_step=4, **shape)
    try:
        depths = []
        real = eng._dispatch_multi
        eng._dispatch_multi = lambda k: (depths.append(k), real(k))[1]
        got = run_all(eng, GenRequest, PROMPTS, max_new_tokens=16)
    finally:
        eng.close()
    assert depths and set(depths) == {4}
    assert got == want


def test_tp_engine_int8_weights_and_kv_matches(model, groups):
    """tp 2 over int8 weights and an int8 KV pool (K4 per rank): token-exact
    against the JAX mesh engine over the same quantized tree; the pools'
    per-slot scales are the whole row's on every rank."""
    jcfg, jparams, cfg, _ = model
    qp = jquantize_params(jparams, jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, qp))
    jeng = jax_engine(jcfg, qp, tp=2, kv_quantize="int8")
    want = jeng.generate(PROMPT, max_new_tokens=10).output_ids
    eng = port_engine(cfg, params, groups(2), kv_quantize="int8")
    try:
        assert eng.generate(PROMPT, max_new_tokens=10).output_ids == want
        (k0, _), (k1, _) = eng.rank_query("rank_pools")
        np.testing.assert_array_equal(k0[1].numpy(), k1[1].numpy())
        # past the trash page (page 0), which idle lanes write
        np.testing.assert_allclose(k0[1][:, 8:].numpy(),
                                   np.asarray(jeng.k_pool.s)[:, 8:],
                                   rtol=1e-5)
    finally:
        eng.close()


def test_tp_engine_speculation_matches(model, groups):
    """speculative_k 4 on the rank group (K3 per rank): the greedy stream
    equals the JAX mesh engine's plain decode, and verify steps ran."""
    jcfg, jparams, cfg, params = model
    want = jax_engine(jcfg, jparams, tp=2).generate(
        PROMPT, max_new_tokens=10).output_ids
    eng = port_engine(cfg, params, groups(2), speculative_k=4, fetch_lag=0)
    try:
        got = eng.generate(PROMPT, max_new_tokens=10).output_ids
        assert got == want
        assert eng.verify_steps > 0
    finally:
        eng.close()


@pytest.mark.parametrize("kv_heads,kernel", [(4, False), (2, True)],
                         ids=["kv-map", "one-kv-head"])
def test_grouped_gqa_engine_matches_single_device(kv_heads, kernel, groups):
    """tp 2 x tq 2 (test_parallel.py:152): Hkv 4 leaves two kv heads per
    rank, which the per-rank kernels cannot map, so "auto" resolves to
    the plain attention with each rank's q->kv map; Hkv 2 leaves one kv
    head per rank and runs the per-rank kernels' plain versions, with an
    untied head whose vocab shards are gathered.  Both token-exact
    against the JAX (tp 2, tq 2) mesh engine."""
    jcfg, jparams, cfg, params = _models(kv_heads, 7, tied=kv_heads == 4)
    want = jax_engine(jcfg, jparams, tp=2, tq=2).generate(
        PROMPT, max_new_tokens=10).output_ids
    eng = port_engine(cfg, params, groups(2, 2))
    try:
        assert (eng.cfg.attention_backend == "kernel") == kernel
        assert bool(eng.attention_backend_reasons) != kernel
        assert eng.generate(PROMPT, max_new_tokens=10).output_ids == want
    finally:
        eng.close()


def test_grouped_gqa_with_int8_weights_and_kv(model, groups):
    """The grouped layout with both quantization tiers
    (test_parallel.py:218): int8 leaves sliced under ("tp","tq") specs,
    the int8 pool over "tp" alone."""
    jcfg, jparams, cfg, _ = model
    qp = jquantize_params(jparams, jcfg)
    want = jax_engine(jcfg, qp, tp=2, tq=2, kv_quantize="int8").generate(
        PROMPT, max_new_tokens=10).output_ids
    eng = port_engine(cfg, params_from_jax(jax.tree.map(np.asarray, qp)),
                      groups(2, 2), kv_quantize="int8")
    try:
        assert eng.generate(PROMPT, max_new_tokens=10).output_ids == want
    finally:
        eng.close()


def test_random_weights_shard_equals_the_whole(model):
    """init_params_shard: rank r's draw equals the slice of the whole
    model drawn from the same seed (int8 too), so a rank group and a
    single-card engine hold the same weights without a full copy."""
    cfg = model[2]
    for quantize in ("", "int8"):
        whole = init_params_shard(cfg, 5, None, quantize=quantize)
        for r in range(4):
            mesh = RankMesh(2, 2, r, CPU)
            got = init_params_shard(cfg, 5, mesh, quantize=quantize)
            want = shard_params(whole, cfg, mesh)
            flat_g = jax.tree_util.tree_leaves(
                {**got, "layers": got["layers"]})
            flat_w = jax.tree_util.tree_leaves(
                {**want, "layers": want["layers"]})
            assert len(flat_g) == len(flat_w)
            for a, b in zip(flat_g, flat_w):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# sharding rules and the axis resolver
# ---------------------------------------------------------------------------


def _spec_tree(specs):
    return jax.tree.map(tuple, specs,
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def test_kv_head_replication_when_tp_exceeds_kv(model):
    """A tp axis wider than Hkv replicates the kv params, as the JAX rule
    does (test_parallel.py:122); every spec equals the JAX one."""
    jcfg, _, cfg, _ = model
    specs = param_specs(cfg, MeshConfig(tp=8))
    assert specs["layers"]["wk"] == (None, None, None, None)
    assert specs["layers"]["wq"] == (None, None, "tp", None)
    assert specs == _spec_tree(jparam_specs(jcfg, jmake_mesh(
        JMeshConfig(tp=8))))


def test_grouped_gqa_specs_and_placement(model):
    """factor_tp_for_kv(8, 4) = (4, 2): the specs equal the JAX rule's,
    and rank r's slice of every tensor equals the shard JAX places on the
    device at mesh position (r // tq, r % tq) (test_parallel.py:132)."""
    jcfg, jparams, cfg, params = model
    assert factor_tp_for_kv(8, cfg.num_kv_heads) == (4, 2)
    jmesh = jmake_mesh(JMeshConfig(tp=4, tq=2))
    specs = param_specs(cfg, MeshConfig(tp=4, tq=2))
    assert specs["layers"]["wq"] == (None, None, ("tp", "tq"), None)
    assert specs["layers"]["wk"] == (None, None, "tp", None)
    assert specs["layers"]["wd"] == (None, ("tp", "tq"), None)
    assert specs == _spec_tree(jparam_specs(jcfg, jmesh))
    sharded = jshard_params(jparams, jcfg, jmesh)
    grid = jmesh.devices.reshape(4, 2)
    for r in range(8):
        mesh = RankMesh(4, 2, r, CPU)
        mine = shard_params(params, cfg, mesh)
        dev = grid[r // 2, r % 2]
        for name in ("wq", "wk", "wo", "wg", "wd"):
            shard = next(s for s in sharded["layers"][name].addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(mine["layers"][name].numpy(),
                                          np.asarray(shard.data))
        assert mine["layers"]["wq"].shape[2] == 1
        assert mine["layers"]["wk"].shape[2] == 1


def test_factorization_cases():
    """test_parallel.py:244."""
    assert factor_tp_for_kv(16, 8) == (8, 2)
    assert factor_tp_for_kv(8, 8) == (8, 1)
    assert factor_tp_for_kv(4, 8) == (4, 1)
    assert factor_tp_for_kv(4, 6) == (2, 2)
    assert factor_tp_for_kv(3, 8) == (1, 3)
    assert factor_tp_for_kv(1, 8) == (1, 1)


def test_resolver_keeps_plain_axis_for_ulysses_and_pp():
    """test_parallel.py:253."""
    assert resolve_tensor_axes(16, 8) == (8, 2)
    assert resolve_tensor_axes(16, 8, cp_strategy="ulysses", sp=4) == (16, 1)
    assert resolve_tensor_axes(16, 8, cp_strategy="ulysses", sp=1) == (8, 2)
    assert resolve_tensor_axes(16, 8, pp=2) == (16, 1)


def test_kernel_mesh_rule_is_the_reference_rule():
    """kernel_mesh_ok decides as pallas_mesh_ok on every (tp, tq) layout
    of up to 8 devices, for several head counts; "auto" on the CPU
    resolves to plain exactly where it refuses, with the reason, and an
    explicit "kernel" raises there."""
    for tp in (1, 2, 4, 8):
        for tq in (1, 2, 4):
            if tp * tq > 8:
                continue
            jmesh = jmake_mesh(JMeshConfig(tp=tp, tq=tq))
            for hq, hkv in ((8, 4), (8, 2), (8, 8), (16, 4), (8, 1)):
                mesh = MeshConfig(tp=tp, tq=tq)
                assert kernel_mesh_ok(mesh, hq, hkv) == \
                    pallas_mesh_ok(jmesh, hq, hkv), (tp, tq, hq, hkv)
    cfg = ModelConfig(name="m", num_kv_heads=4, **MODEL)
    backend, why = resolve_attention_backend(
        cfg, EngineConfig(), "cpu", mesh=MeshConfig(tp=2, tq=2))
    assert backend == "plain" and "one kv head per rank" in why[0]
    with pytest.raises(ValueError, match="per-rank kernels"):
        resolve_attention_backend(cfg, EngineConfig(attention_backend="kernel"),
                                  "cpu", mesh=MeshConfig(tp=2, tq=2))
    assert resolve_attention_backend(
        cfg, EngineConfig(), "cpu", mesh=MeshConfig(tp=4)) == ("kernel", [])


def test_what_the_slice_does_not_port_is_refused(model):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="ROADMAP A9, KV tiers"):
        port_engine(cfg, params, MeshConfig(tp=2), kv_host_tier_mb=4)
    for kw, item in (({"dp": 2}, "dp x tp"), ({"sp": 2}, "ring"),
                     ({"pp": 2}, "pipeline")):
        with pytest.raises(ValueError, match=item):
            RankGroup(MeshConfig(tp=2, **kw), device="cpu")
    # ep is ported with MoE (tests/test_torch_moe.py); what the reference
    # refuses is refused before any rank spawns (tests/test_moe.py:109)
    with pytest.raises(ValueError, match="dense"):
        port_engine(cfg, params, MeshConfig(tp=2, ep=2))
    with pytest.raises(ValueError, match="divisible"):
        port_engine(cfg.replace(num_experts=4), params, MeshConfig(ep=3))


def test_serving_config_axis_spellings(monkeypatch):
    from kafka_tpu_torch.server import ServingConfig

    monkeypatch.delenv("KAFKA_TORCH_TP", raising=False)
    monkeypatch.setenv("KAFKA_TORCH_TP_SIZE", "4")
    assert ServingConfig.from_env().tp_size == 4
    monkeypatch.delenv("KAFKA_TORCH_TP_SIZE")
    monkeypatch.setenv("KAFKA_TORCH_TP", "2")
    assert ServingConfig.from_env().tp_size == 2


# ---------------------------------------------------------------------------
# per-rank K1 / K3 / K4 vs the JAX sharded wrappers
# ---------------------------------------------------------------------------


def _case(seed, B, P, ps, Hq, Hkv, D, S=None):
    rng = np.random.RandomState(seed)
    num_pages = B * P + 1
    kp = rng.randn(num_pages * ps, Hkv * D).astype(np.float32)
    vp = rng.randn(num_pages * ps, Hkv * D).astype(np.float32)
    shape = (B, Hq, D) if S is None else (B, S, Hq, D)
    q = rng.randn(*shape).astype(np.float32)
    table = (rng.permutation(B * P) + 1).reshape(B, P).astype(np.int32)
    lens = rng.randint(1, P * ps - (S or 1) - 1, size=B).astype(np.int32)
    q_lens = rng.randint(1, (S or 1) + 1, size=B).astype(np.int32)
    return q, kp, vp, table, lens, q_lens


CASES = [("K1", 2, 1, 8, 4), ("K1", 2, 2, 8, 2), ("K3", 2, 1, 8, 4),
         ("K4", 2, 2, 8, 2)]


@pytest.mark.parametrize("kernel,tp,tq,Hq,Hkv", CASES,
                         ids=[f"{k}-tp{a}tq{b}" for k, a, b, _, _ in CASES])
def test_per_rank_kernels_match_the_sharded_wrappers(kernel, tp, tq, Hq, Hkv):
    """Each rank's K1, K3 or K4 (plain versions here) over its q head
    block and pool column block equals that block of the JAX sharded
    wrapper's output (Pallas in interpret mode on the JAX mesh)."""
    D, ps = 16, 8
    jmesh = jmake_mesh(JMeshConfig(tp=tp, tq=tq))
    assert kernel_mesh_ok(MeshConfig(tp=tp, tq=tq), Hq, Hkv)
    n, hq, hkv = tp * tq, Hq // (tp * tq), Hkv // tp
    q, kp, vp, table, lens, qlens = _case(
        0, 2, 4, ps, Hq, Hkv, D, S=3 if kernel == "K3" else None)
    j = [jnp.asarray(a) for a in (q, kp, vp, table, lens, qlens)]
    if kernel == "K1":
        want = jdecode_sharded(jmesh, *j[:5], page_size=ps, interpret=True)
    elif kernel == "K3":
        want = jverify_sharded(jmesh, *j, page_size=ps, interpret=True)
    else:
        kq, vq = (quantize_array(torch.from_numpy(a), (-1,))
                  for a in (kp, vp))
        want = jdecode_int8_sharded(
            jmesh, j[0], *(jnp.asarray(a.numpy()) for a in
                           (kq.q, kq.s, vq.q, vq.s)), j[3], j[4],
            page_size=ps, interpret=True)
    want = np.asarray(want)
    t = torch.from_numpy
    for r in range(n):
        mesh = RankMesh(tp, tq, r, CPU)
        qs = slice(r * hq, (r + 1) * hq)
        cs = slice((r // tq) * hkv * D, (r // tq + 1) * hkv * D)
        if kernel == "K1":
            out = paged_decode_attention_sharded(
                mesh, t(q[:, qs].copy()), t(kp[:, cs].copy()),
                t(vp[:, cs].copy()), t(table), t(lens), page_size=ps)
            np.testing.assert_allclose(out.numpy(), want[:, qs], **KTOL)
        elif kernel == "K3":
            out = paged_verify_attention_sharded(
                mesh, t(q[:, :, qs].copy()), t(kp[:, cs].copy()),
                t(vp[:, cs].copy()), t(table), t(lens), t(qlens),
                page_size=ps)
            for b in range(2):
                m = int(qlens[b])
                np.testing.assert_allclose(out[b, :m].numpy(),
                                           want[b, :m, qs], **KTOL)
        else:
            out = paged_decode_attention_int8_sharded(
                mesh, t(q[:, qs].copy()), kq.q[:, cs].contiguous(), kq.s,
                vq.q[:, cs].contiguous(), vq.s, t(table), t(lens),
                page_size=ps)
            np.testing.assert_allclose(out.numpy(), want[:, qs], atol=1e-5,
                                       rtol=1e-5)


def test_per_rank_wrapper_refuses_a_split_the_kernels_cannot_map():
    mesh = RankMesh(2, 2, 0, CPU)
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(64, 2 * 16)  # two kv heads on a grouped rank
    with pytest.raises(ValueError, match="one kv head per rank"):
        paged_decode_attention_sharded(
            mesh, q, pool, pool, torch.zeros(1, 8, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), page_size=8)


# ---------------------------------------------------------------------------
# a dead rank
# ---------------------------------------------------------------------------


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_killed_rank_raises_instead_of_hanging(model, tmp_path):
    """SIGKILL one rank mid-decode: the next step raises
    DistributedStepError well inside the guard's deadline, recovery fails
    every request with an error event, the engine refuses new work, and
    closing it leaves no process behind."""
    _, _, cfg, params = model
    group = RankGroup(MeshConfig(tp=2), device="cpu", timeout_s=20,
                      store_dir=str(tmp_path))
    pids = group.pids
    eng = port_engine(cfg, params, group, fetch_lag=0)
    try:
        for rid in ("a", "b"):
            eng.submit(GenRequest(request_id=rid, prompt_ids=PROMPT,
                                  max_new_tokens=40))
        for _ in range(4):
            eng.step()
        assert eng.num_active == 2
        os.kill(pids[0], signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(DistributedStepError):
            for _ in range(100):
                eng.step()
        assert time.monotonic() - t0 < 10.0
        events = eng.recover_from_failure()
        assert sorted(e.request_id for e in events) == ["a", "b"]
        assert {e.finish_reason for e in events} == {"error:distributed"}
        assert eng.group_broken and not eng.has_work
        with pytest.raises(DistributedStepError):
            eng.submit(GenRequest(request_id="c", prompt_ids=PROMPT))
    finally:
        eng.close()
        group.close()
    assert all(_gone(p) for p in pids)


# ---------------------------------------------------------------------------
# the server at tp_size 2
# ---------------------------------------------------------------------------


@pytest.fixture
def _process_state_restored(monkeypatch):
    """create_app sets the port's process-wide tracing config, trace
    ring, SLO targets and compile observatory: put back after the test."""
    from collections import OrderedDict

    from kafka_tpu_torch import tracing as ptracing
    from kafka_tpu_torch.runtime import compile_log as pcomp
    from kafka_tpu_torch.runtime import metrics as pmetrics

    for name in ("_sample", "_capacity", "_span_cap", "_slow_ttft_ms",
                 "_slow_total_ms", "_profiling", "_persist_dir"):
        monkeypatch.setattr(ptracing, name, getattr(ptracing, name))
    monkeypatch.setattr(ptracing, "_traces", OrderedDict(ptracing._traces))
    monkeypatch.setattr(ptracing, "_by_request", dict(ptracing._by_request))
    monkeypatch.setattr(ptracing, "_counters", dict(ptracing._counters))
    monkeypatch.setattr(pmetrics, "_slo_override",
                        dict(pmetrics._slo_override))
    monkeypatch.setattr(pcomp, "_OBS", None)


def test_server_at_tp_size_two_streams_then_fails_cleanly(
        tmp_path, monkeypatch, _process_state_restored):
    """KAFKA_TORCH_TP_SIZE=2 on the CPU: a streamed thread turn ends with
    [DONE]; after one rank is killed the next turn's stream carries an
    error event and ends, /health answers 503 "unhealthy", and shutdown
    leaves no rank running."""
    from aiohttp.test_utils import TestClient, TestServer

    from kafka_tpu_torch.server import ServingConfig, create_app
    from kafka_tpu_torch.server.app import STATE_KEY

    monkeypatch.setenv("KAFKA_TORCH_TP_SIZE", "2")
    monkeypatch.setenv("KAFKA_TORCH_DIST_STEP_TIMEOUT_S", "20")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg = ServingConfig.from_env(
        tiny_model=True, max_batch=2, page_size=16, num_pages=96,
        max_pages_per_seq=64, prefill_buckets=(16, 32, 64, 128),
        max_new_tokens_default=6, db_path=str(tmp_path / "threads.db"),
        system_prompt="terse", warmup=False)
    body = {"model": "tiny", "stream": True, "temperature": 0,
            "max_tokens": 6,
            "messages": [{"role": "user", "content": "hello"}]}

    async def run():
        app = await create_app(cfg, tools=[], mcp_servers=[], device="cpu")
        async with TestClient(TestServer(app)) as c:
            first = await (await c.post("/v1/threads/t1/chat/completions",
                                        json=body)).text()
            health = await (await c.get("/health")).json()
            engine = app[STATE_KEY]["llm"].engine
            pids = engine._group.pids
            os.kill(pids[0], signal.SIGKILL)
            second = await (await c.post("/v1/threads/t1/chat/completions",
                                         json=body)).text()
            sick = await c.get("/health")
            sick_body = await sick.json()
        return first, health, second, sick.status, sick_body, pids

    first, health, second, status, sick, pids = asyncio.run(run())
    lines = [ln[6:] for ln in first.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    assert not [e for e in map(json.loads, lines[:-1])
                if e.get("type") == "error"]
    assert health["engine"]["tp"] == 2 and health["status"] == "ok"
    lines = [ln[6:] for ln in second.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    assert any("error" in json.dumps(e) for e in map(json.loads, lines[:-1]))
    assert status == 503 and sick["status"] == "unhealthy"
    assert all(_gone(p) for p in pids)


# ---------------------------------------------------------------------------
# the guard and the barrier (kafka_tpu/parallel/distributed.py)
# ---------------------------------------------------------------------------


def test_guarded_collective_turns_a_hang_into_an_error():
    from kafka_tpu_torch.parallel import guarded_collective

    assert guarded_collective(lambda a, b: a + b, 2, 3, timeout_s=5) == 5
    with pytest.raises(ZeroDivisionError):
        guarded_collective(lambda: 1 / 0, timeout_s=5)
    t0 = time.monotonic()
    with pytest.raises(DistributedStepError, match="did not complete"):
        guarded_collective(time.sleep, 2, timeout_s=0.2, label="sleep")
    assert time.monotonic() - t0 < 5


def test_barrier_waits_for_every_rank(tmp_path):
    import threading

    import torch.distributed as dist

    from kafka_tpu_torch.parallel import barrier

    assert barrier(None, "x", 2) is False
    store = dist.FileStore(str(tmp_path / "store"), 2)
    with pytest.raises(DistributedStepError, match="not every rank"):
        barrier(store, "alone", 2, timeout_s=0.2)
    done = []
    t = threading.Thread(target=lambda: done.append(
        barrier(store, "pair", 2, timeout_s=10)))
    t.start()
    assert barrier(store, "pair", 2, timeout_s=10)
    t.join(10)
    assert done == [True]
