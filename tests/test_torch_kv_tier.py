"""kafka_tpu_torch.runtime.kv_tier (the host and disk KV tiers) against the
JAX package's kafka_tpu.runtime.kv_tier.

* The ship chunking (`_bucketize`, `_flat_slots`) equals the reference's.
* The wire format: a run the reference encodes decodes in the port to the
  same bytes and the reverse, for f32, bf16 and int8 pools (rows + f32
  scales).
* One scripted demote / touch / split / promote / spill / discard
  sequence leaves both KVTierManagers with equal `snapshot()` counters and
  both pools with equal bytes after every step.
* End to end on the tiny model: a two-turn thread whose run leaves the
  device between turns (host tier, disk tier) serves turn 2 token-exact
  against the JAX engine with the same tier settings, with equal
  cached_tokens and cache_source; the promoted pages equal the pages
  before demotion byte for byte; a torn promote (kv.promote error at the
  second chunk) degrades to a re-prefill with the same stream.
* On the card (cuda marker): a captured decode graph reads promoted pages.

Every manager and engine is closed by a fixture (spill writers joined);
nothing sleeps.
"""

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu import failpoints as jfailpoints
from kafka_tpu.models import llama as jllama
from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.runtime import (
    EngineConfig as JEngineConfig,
    GenRequest as JGenRequest,
    InferenceEngine as JInferenceEngine,
)
from kafka_tpu.runtime import kv_tier as ref
from kafka_tpu_torch import failpoints
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime import kv_tier as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_failpoints():
    failpoints.clear()
    jfailpoints.clear()
    yield
    failpoints.clear()
    jfailpoints.clear()


def _stop_ref_spill(mgr):
    t = mgr._spill_thread
    if t is not None:
        mgr.flush()
        mgr._spill_q.put(None)
        t.join(timeout=10.0)
        mgr._spill_thread = None


@pytest.fixture
def closer():
    """Registers managers / engines of either package; closes them all."""
    items = []
    yield items.append
    for x in items:
        if isinstance(x, ref.KVTierManager):
            _stop_ref_spill(x)
        elif isinstance(x, JInferenceEngine):
            if x.kv_tier is not None:
                _stop_ref_spill(x.kv_tier)
                if x.kv_tier.object is not None:
                    x.kv_tier.object.stop_janitor()
        else:
            x.close()


def as_bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# chunking and wire format
# ---------------------------------------------------------------------------


def test_bucketize_and_flat_slots_equal_the_reference():
    assert port.SHIP_BUCKETS == ref.SHIP_BUCKETS
    for n in range(0, 300):
        assert port._bucketize(n) == ref._bucketize(n), n
    rng = np.random.RandomState(0)
    for _ in range(20):
        pages = rng.randint(1, 50, rng.randint(1, 9)).tolist()
        pad = port._bucketize(len(pages))[0]
        np.testing.assert_array_equal(port._flat_slots(pages, 4, pad),
                                      ref._flat_slots(pages, 4, pad))


def leaves_np(kind, seed, rows=24, layers=2, width=8):
    """One side's pool leaves as numpy, the reference's host form."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(layers, rows, width)).astype(np.float32)
    if kind == "f32":
        return [x]
    if kind == "bf16":
        return [x.astype(ml_dtypes.bfloat16)]
    q = rng.randint(-127, 128, size=(layers, rows, width)).astype(np.int8)
    s = rng.uniform(0.01, 1, size=(layers, rows, 1)).astype(np.float32)
    return [q, s]


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_npz_crosses_between_packages(kind):
    k, v = leaves_np(kind, 1), leaves_np(kind, 2)
    data = ref.encode_run_npz(k, v, 3)
    pk, pv, n = port.decode_run_npz(data)
    assert n == 3
    assert [as_bytes(a) for a in pk] == [as_bytes(a) for a in k]
    assert [as_bytes(a) for a in pv] == [as_bytes(a) for a in v]
    assert [str(a.dtype) for a in pk] == [
        {"float32": "torch.float32", "bfloat16": "torch.bfloat16",
         "int8": "torch.int8"}[a.dtype.name] for a in k]
    back = port.encode_run_npz([to_torch(a) for a in k],
                               [to_torch(a) for a in v], 3)
    rk, rv, n = ref.decode_run_npz(back)
    assert n == 3
    assert [a.dtype.name for a in rk] == [a.dtype.name for a in k]
    assert [as_bytes(a) for a in rk] == [as_bytes(a) for a in k]
    assert [as_bytes(a) for a in rv] == [as_bytes(a) for a in v]


# ---------------------------------------------------------------------------
# the manager, scripted on both packages
# ---------------------------------------------------------------------------


class JOwner:
    def __init__(self, k, v):
        self.k_pool, self.v_pool = jnp.asarray(k), jnp.asarray(v)


class POwner:
    def __init__(self, k, v):
        self.k_pool = torch.from_numpy(k.copy())
        self.v_pool = torch.from_numpy(v.copy())


def pools_equal(jo, po):
    return (as_bytes(jo.k_pool) == as_bytes(po.k_pool)
            and as_bytes(jo.v_pool) == as_bytes(po.v_pool))


def test_scripted_sequence_leaves_equal_counters(tmp_path, closer):
    ps, n_pages = 4, 24
    rng = np.random.RandomState(3)
    shape = (2, n_pages * ps, 8)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jo, po = JOwner(k, v), POwner(k, v)
    mgrs = []
    for mod, owner, d in ((ref, jo, "ref"), (port, po, "port")):
        m = mod.KVTierManager(mod.LocalPageShipper(owner, ps),
                              host_budget_bytes=1 << 20,
                              disk_dir=str(tmp_path / d), page_size=ps)
        closer(m)
        # spills run inline: with the writer thread, how many runs one
        # overflow spills depends on whether the previous spill finished
        # (the bytes of a run being written still count), in both packages
        m._spill = m._spill_one
        mgrs.append(m)
    ids = [{}, {}]

    def both(label, fn):
        outs = []
        for i, m in enumerate(mgrs):
            outs.append(fn(i, m))
            m.flush()  # pending copies resolved, spills written
        assert mgrs[0].snapshot() == mgrs[1].snapshot(), label
        assert pools_equal(jo, po), label
        return outs

    def demote(name, pages):
        def f(i, m):
            ids[i][name] = m.demote(pages)
            return ids[i][name] is not None
        assert both(f"demote {name}", f) == [True, True]

    demote("a", [3, 7, 5])
    demote("b", [1, 2])
    both("touch", lambda i, m: m.touch(ids[i]["a"]))

    def split(i, m):
        front, back = m.split(ids[i]["a"], 1)
        ids[i]["a1"], ids[i]["a2"] = front, back
    both("split", split)
    assert both("promote a1", lambda i, m: m.promote(ids[i]["a1"], [9])) \
        == [True, True]
    # shrink the budget below what is resident: the next demote spills
    per_page = mgrs[0].bytes_for_pages(1)
    assert per_page == mgrs[1].bytes_for_pages(1)
    for m in mgrs:
        m.host_budget_bytes = 3 * per_page
    demote("c", [10])
    for m in mgrs:
        m.flush()
    assert mgrs[0].snapshot() == mgrs[1].snapshot()
    assert mgrs[1].snapshot()["disk_spills"] > 0
    assert both("promote b", lambda i, m: m.promote(ids[i]["b"], [11, 12])) \
        == [True, True]
    both("discard a2", lambda i, m: m.discard(ids[i]["a2"]))
    assert both("promote gone", lambda i, m: m.promote(ids[i]["a2"], [13])) \
        == [False, False]
    snap = mgrs[1].snapshot()
    assert snap["promotions"] == 2 and snap["disk_loads"] >= 1


def test_torn_multichunk_promote(closer):
    ps, n = 2, port.SHIP_BUCKETS[-1] + 3  # two chunks
    rng = np.random.RandomState(4)
    k = rng.normal(size=(1, (2 * n + 4) * ps, 4)).astype(np.float32)
    po = POwner(k, k.copy())
    mgr = port.KVTierManager(port.LocalPageShipper(po, ps),
                             host_budget_bytes=1 << 30, page_size=ps)
    closer(mgr)
    rid = mgr.demote(list(range(1, 1 + n)))
    assert rid is not None
    failpoints.configure("kv.promote", "error", "torn", nth=2)
    assert not mgr.promote(rid, list(range(1 + n, 1 + 2 * n)))
    assert mgr.promote_failures == 1


# ---------------------------------------------------------------------------
# end to end: a two-turn thread whose KV leaves the device
# ---------------------------------------------------------------------------


SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-gqa").replace(dtype="float32")
    cfg = get_config("tiny-gqa").replace(dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


def engines(model, closer, shape=SHAPE, disk=None, **kw):
    """The JAX and the port engine with the same tier settings (each its
    own spill dir under `disk`)."""
    jcfg, jparams, cfg, params = model
    dirs = ((str(disk / "jax"), str(disk / "port")) if disk is not None
            else (None, None))
    j = JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**{**shape, **kw}, kv_disk_tier_dir=dirs[0],
                      multi_step=1, max_parked=0, attention_backend="xla",
                      flight_ring=0),
        kv_dtype=jnp.float32)
    p = InferenceEngine(cfg, params,
                        EngineConfig(**{**shape, **kw},
                                     kv_disk_tier_dir=dirs[1]),
                        kv_dtype=torch.float32, device="cpu")
    closer(j)
    closer(p)
    return j, p


def run(eng, Req, rid, key, prompt, n=6):
    r = Req(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
            prefix_key=key)
    eng.submit(r)
    eng.run_to_completion()
    return r


def slot_rows(pool, pages, ps):
    idx = torch.tensor([p * ps + i for p in pages for i in range(ps)])
    return [as_bytes(a.index_select(1, idx)) for a in port.pool_leaves(pool)]


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_two_turn_thread_off_the_device(model, closer, tmp_path, tier):
    """Turn 1 of thread A, then its run leaves the device: demoted to the
    host tier, or (disk) demoted with a host budget that holds one run
    while a second thread's demotion spills A's run to disk.  Turn 2
    promotes it and matches the JAX engine token for token."""
    a, b = prompts(5, [30, 30])
    outs = []
    js, ps_ = engines(model, closer, kv_host_tier_mb=64,
                      disk=tmp_path if tier == "disk" else None)
    for eng, Req in ((js, JGenRequest), (ps_, GenRequest)):
        r1 = run(eng, Req, "a1", "A", a)
        pc, tierm = eng.prefix_cache, eng.kv_tier
        before = None
        if Req is GenRequest:
            chain = pc._claimed_chain("A")
            before = [(n.tokens[:], slot_rows(eng.k_pool, n.pages, 8)
                       + slot_rows(eng.v_pool, n.pages, 8)) for n in chain]
        stats = pc.demote_thread("A")
        assert stats["pages"] > 0
        if tier == "disk":
            run(eng, Req, "b1", "B", b)
            tierm.host_budget_bytes = tierm.bytes_for_pages(stats["pages"])
            pc.demote_thread("B")
            tierm.flush()
            assert tierm.snapshot()["disk_spills"] >= 1
        tierm.drain(force=True)
        r2 = run(eng, Req, "a2", "A", a + r1.output_ids + [5, 6, 7])
        outs.append((r1.output_ids, r2.output_ids, r2.cached_tokens,
                     r2.cache_source, r2.promoted_tokens,
                     tierm.snapshot()))
        if before is not None:
            after = [(n.tokens[:], slot_rows(eng.k_pool, n.pages, 8)
                      + slot_rows(eng.v_pool, n.pages, 8))
                     for n in pc._claimed_chain("A")[:len(before)]]
            assert after == before  # promoted pages, byte for byte
            assert eng.self_check() == []
    want, got = outs
    assert got[:5] == want[:5]
    assert got[3] == "host_tier" and got[2] > 0
    # the tier's counters too; how many runs a budget overflow spills
    # depends on whether the writer thread finished the previous spill
    # (in both packages), so only the resident-state keys are left out
    racy = ("disk_spills", "disk_runs", "disk_bytes", "host_bytes",
            "host_runs") if tier == "disk" else ()
    assert {k: v for k, v in got[5].items() if k not in racy} == \
        {k: v for k, v in want[5].items() if k not in racy}
    if tier == "disk":
        assert got[5]["disk_loads"] >= 1 and got[5]["disk_spills"] >= 1


def test_torn_promote_degrades_to_reprefill(model, closer):
    """A run of two ship chunks (page 2, > 64 pages): kv.promote errors at
    the second chunk.  The destination pages are freed, the node goes, and
    the request re-prefills: the stream equals the JAX engine's."""
    shape = dict(max_batch=2, page_size=2, num_pages=200,
                 max_pages_per_seq=80, prefill_buckets=(16, 64, 128))
    (a,) = prompts(7, [140])
    js, ps_ = engines(model, closer, shape=shape, kv_host_tier_mb=64)
    want = []
    for eng, Req in ((js, JGenRequest), (ps_, GenRequest)):
        r1 = run(eng, Req, "a1", "A", a, n=4)
        want.append(r1.output_ids)
        assert eng.prefix_cache.demote_thread("A")["pages"] > 64
        eng.kv_tier.drain(force=True)
        if Req is GenRequest:
            failpoints.configure("kv.promote", "error", "torn", nth=2)
        r2 = run(eng, Req, "a2", "A", a + r1.output_ids + [9], n=4)
        failpoints.clear()
        want.append((r2.output_ids, r2.cache_source))
    assert want[0] == want[2]
    jr2, pr2 = want[1], want[3]
    assert jr2[1] == "host_tier" and pr2[1] != "host_tier"
    assert pr2[0] == jr2[0]
    assert ps_.kv_tier.promote_failures == 1
    assert ps_.self_check() == []


def test_tier_knobs_and_planner(monkeypatch):
    from kafka_tpu_torch.runtime.planner import plan_for_serving
    from kafka_tpu_torch.server import ServingConfig

    monkeypatch.setenv("KAFKA_TORCH_KV_HOST_TIER_MB", "48")
    monkeypatch.setenv("KAFKA_TORCH_KV_DISK_TIER_DIR", "/spill")
    monkeypatch.setenv("KAFKA_TORCH_KV_OBJECT_MB", "-3")
    cfg = ServingConfig.from_env()
    assert (cfg.kv_host_tier_mb, cfg.kv_disk_tier_dir, cfg.kv_object_mb) \
        == (48, "/spill", 0)
    plan = plan_for_serving(cfg, 80 << 30,
                            model_cfg=get_config("tiny-gqa"))
    assert plan.kv_host_tier_bytes == 48 << 20
    assert EngineConfig().kv_host_tier_mb == 0
    with pytest.raises(ValueError):
        InferenceEngine(get_config("tiny-gqa"), None,
                        EngineConfig(kv_host_tier_mb=-1), device="cpu")


@pytest.mark.cuda
def test_captured_graph_reads_promoted_pages():
    """On the card: promote writes the pool in place, so a decode graph
    captured before the demotion reads the promoted pages — turn 2's
    greedy stream equals an engine whose pages never left the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from kafka_tpu_torch.models import init_params

    cfg = get_config("tiny-gqa").replace(dtype="float32",
                                         attention_backend="plain")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")
    (a,) = prompts(8, [30])
    streams = []
    for mb in (64, 0):
        eng = InferenceEngine(cfg, params,
                              EngineConfig(**SHAPE, kv_host_tier_mb=mb,
                                           attention_backend="plain"),
                              kv_dtype=torch.float32)
        r1 = eng.generate(a, max_new_tokens=6, prefix_key="A")
        assert eng._graphs  # decode ran as graph replays
        if mb:
            assert eng.prefix_cache.demote_thread("A")["pages"] > 0
            eng.kv_tier.drain(force=True)
        r2 = eng.generate(a + r1.output_ids + [5], max_new_tokens=6,
                          prefix_key="A")
        streams.append((r1.output_ids, r2.output_ids, r2.cache_source))
        eng.close()
    assert streams[0][:2] == streams[1][:2]
    assert streams[0][2] == "host_tier" and streams[1][2] == "own"
