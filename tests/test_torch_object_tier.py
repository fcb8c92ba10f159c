"""kafka_tpu_torch.runtime.object_tier against the JAX package's object
tier: one store, two packages.

* The content-address fingerprint is the JAX engine's string, character
  for character, for f32, bf16 and int8 pools; run keys and manifest keys
  are equal for the same token path.
* A thread slept by one package wakes in the other: the JAX engine calls
  `sleep_to_object` into a directory and a FRESH port engine (weights
  converted from the JAX tree) wakes the thread from it with
  cache_source="object_tier" and the JAX engine's own greedy
  continuation — then the same with the packages swapped.  The drain
  statistics of the two packages are equal.
* Manifests (deeper kept, fingerprint-scoped), refcounted delete across
  two owners, and torn puts and gets through the kv.object_* failpoints.
* HTTPObjectStore (the S3-shaped backend) against tests/objstore_stub.py,
  torn bodies included.

Stores live under tmp_path; every janitor and prefetcher is stopped by
the fixture.
"""

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
from kafka_tpu.runtime import object_tier as ref
from kafka_tpu_torch import failpoints
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine
from kafka_tpu_torch.runtime import kv_tier as port_kv
from kafka_tpu_torch.runtime import object_tier as port
from tests.objstore_stub import StubS3Server

SHAPE = dict(max_batch=3, page_size=8, num_pages=40, max_pages_per_seq=8,
             prefill_buckets=(8, 16, 32))


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


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-gqa").replace(dtype="float32")
    cfg = get_config("tiny-gqa").replace(dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


@pytest.fixture
def made():
    """Engines of either package, closed at teardown (janitors, spill
    writers, prefetchers)."""
    engines = []
    yield engines.append
    for e in engines:
        tier = e.kv_tier
        if isinstance(e, InferenceEngine):
            e.close()
        elif tier is not None:
            t = tier._spill_thread
            if t is not None:
                tier._spill_q.put(None)
                t.join(timeout=10.0)
            if tier.object is not None:
                tier.object.stop_janitor()
                if tier.object.prefetcher is not None:
                    tier.object.prefetcher.close()


def jax_engine(model, made, kv_dtype=jnp.float32, **kw):
    jcfg, jparams = model[0], model[1]
    e = JInferenceEngine(
        jcfg, jparams,
        JEngineConfig(**{**SHAPE, **kw}, multi_step=1, max_parked=0,
                      attention_backend="xla", flight_ring=0),
        kv_dtype=kv_dtype)
    made(e)
    return e


def port_engine(model, made, kv_dtype=torch.float32, **kw):
    cfg, params = model[2], model[3]
    e = InferenceEngine(cfg, params, EngineConfig(**{**SHAPE, **kw}),
                        kv_dtype=kv_dtype, device="cpu")
    made(e)
    return e


def run(eng, Req, rid, key, prompt, n=6):
    r = Req(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
            prefix_key=key)
    eng.submit(r)
    eng.run_to_completion()
    return r


# ---------------------------------------------------------------------------
# addressing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_fingerprint_and_keys_equal_the_reference(model, made, tmp_path,
                                                  pool):
    kw = dict(kv_host_tier_mb=8, kv_object_dir=str(tmp_path))
    if pool == "int8":
        kw["kv_quantize"] = "int8"
    jd = jnp.bfloat16 if pool == "bf16" else jnp.float32
    pd = torch.bfloat16 if pool == "bf16" else torch.float32
    j = jax_engine(model, made, kv_dtype=jd, **kw)
    p = port_engine(model, made, kv_dtype=pd, **kw)
    fp = j._object_fingerprint()
    assert p._object_fingerprint() == fp
    assert ("bfloat16" in fp) == (pool == "bf16")
    if pool == "int8":
        assert "int8:" in fp and "float32:" in fp
    jt, pt = j.kv_tier.object, p.kv_tier.object
    toks = list(range(40))
    for n_pages in (1, 2, 5):
        assert pt.run_key(toks, n_pages) == jt.run_key(toks, n_pages)
    runs = [toks[:16], toks[16:40]]
    assert pt.manifest_runs(runs) == jt.manifest_runs(runs)
    assert pt._manifest_store_key("thread/a b") == \
        jt._manifest_store_key("thread/a b")
    assert port_kv.pool_leaves(p.k_pool)[0].shape[1] == \
        jax.tree.leaves(j.k_pool)[0].shape[1]


# ---------------------------------------------------------------------------
# a thread slept by one package wakes in the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sleeper", ["jax", "port"])
def test_cross_package_wake(model, made, tmp_path, sleeper):
    rng = np.random.RandomState(6)
    a = rng.randint(0, 256, 30).tolist()
    b = a[:16] + rng.randint(0, 256, 12).tolist()  # shares two pages
    store = str(tmp_path / "store")
    kw = dict(kv_host_tier_mb=64, kv_object_dir=store)
    makers = {"jax": (lambda: jax_engine(model, made, **kw), JGenRequest),
              "port": (lambda: port_engine(model, made, **kw), GenRequest)}
    waker = "port" if sleeper == "jax" else "jax"
    mk, Req = makers[sleeper]
    eng = mk()
    ra = run(eng, Req, "a1", "A", a)
    rb = run(eng, Req, "b1", "B", b)
    stats = eng.sleep_to_object()
    assert stats["enabled"] and stats["manifests"] == 2
    turn2 = a + ra.output_ids + [5, 6, 7]
    outs = {}
    for side in (sleeper, waker):
        mk2, Req2 = makers[side]
        fresh = mk2()
        r = run(fresh, Req2, "a2", "A", turn2)
        outs[side] = (r.output_ids, r.cached_tokens, r.cache_source,
                      r.object_tokens,
                      fresh.kv_tier.object.snapshot()["wake_threads"])
    assert outs[waker] == outs[sleeper]
    assert outs[waker][2] == "object_tier" and outs[waker][1] > 0
    # the same warm state drained by the other package: equal statistics
    mk3, Req3 = makers[waker]
    other = mk3()
    run(other, Req3, "a1", "A", a)
    run(other, Req3, "b1", "B", b)
    ostats = other.sleep_to_object()
    for k in ("enabled", "runs_archived", "runs_failed", "manifests",
              "threads", "bytes_put"):
        assert k in ostats and k in stats
    assert ostats["runs_archived"] == stats["runs_archived"]
    assert ostats["manifests"] == stats["manifests"]
    # every run the other package archived is present already: dedupe
    assert ostats["bytes_put"] == 0
    assert ostats["dedupe_hits"] == stats["runs_archived"]
    assert rb.output_ids  # thread B served before the drain


def test_drain_stats_equal_between_packages(model, made, tmp_path):
    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, 30).tolist()
    got = []
    for side, (mk, Req) in enumerate((
            (lambda d: jax_engine(model, made, kv_host_tier_mb=64,
                                  kv_object_dir=d), JGenRequest),
            (lambda d: port_engine(model, made, kv_host_tier_mb=64,
                                   kv_object_dir=d), GenRequest))):
        eng = mk(str(tmp_path / f"s{side}"))
        run(eng, Req, "a1", "A", a)
        stats = eng.sleep_to_object()
        got.append(stats)
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the tier alone: manifests, refcounts, torn ops
# ---------------------------------------------------------------------------


def leaves(seed, rows=16):
    g = torch.Generator().manual_seed(seed)
    return ([torch.randn(2, rows, 8, generator=g)],
            [torch.randn(2, rows, 8, generator=g)])


def test_manifests_and_refcounted_delete(tmp_path):
    store = port.LocalFSObjectStore(str(tmp_path))
    t1 = port.ObjectTier(store, fingerprint="fp", page_size=8)
    t2 = port.ObjectTier(store, fingerprint="fp", page_size=8)
    toks = list(range(16))
    k, v = leaves(0)
    key = t1.put_run(toks, k, v, 2)
    assert key is not None and t1.has_run(key)
    assert t2.put_run(toks, k, v, 2) == key and t2.dedupe_hits == 1
    got = t2.get_run(key)
    assert got is not None and got[2] == 2
    assert torch.equal(got[0][0], k[0]) and torch.equal(got[1][0], v[0])
    t1.release(key)
    assert t2.has_run(key)  # the other owner's reference keeps it
    t2.release(key)
    assert not t2.has_run(key)
    # manifests: a deeper manifest survives a shallower write
    assert t1.write_manifest("A", list(range(32)),
                             [{"key": "k1", "tokens": 32}])
    assert t1.write_manifest("A", list(range(16)),
                             [{"key": "k0", "tokens": 16}])
    assert len(t1.read_manifest("A")["tokens"]) == 32
    # another fingerprint never reads it
    other = port.ObjectTier(store, fingerprint="other", page_size=8)
    assert other.read_manifest("A") is None


def test_manifest_written_by_the_reference_reads_in_the_port(tmp_path):
    rt = ref.ObjectTier(ref.LocalFSObjectStore(str(tmp_path)),
                        fingerprint="fp", page_size=8)
    pt = port.ObjectTier(port.LocalFSObjectStore(str(tmp_path)),
                         fingerprint="fp", page_size=8)
    runs = rt.manifest_runs([list(range(16))])
    assert rt.write_manifest("thread-1", list(range(16)), runs)
    doc = pt.read_manifest("thread-1")
    assert doc is not None and doc["runs"] == runs


def test_torn_put_and_get_through_failpoints(tmp_path):
    tier = port.ObjectTier(port.LocalFSObjectStore(str(tmp_path)),
                           fingerprint="fp", page_size=8)
    toks = list(range(16))
    k, v = leaves(1)
    failpoints.configure("kv.object_put", "error", "torn put")
    assert tier.put_run(toks, k, v, 2) is None
    assert tier.object_put_failures == 1
    assert not tier.has_run(tier.run_key(toks, 2))  # nothing partial
    assert not tier.write_manifest("A", toks, [])
    failpoints.clear()
    key = tier.put_run(toks, k, v, 2)
    assert key is not None
    failpoints.configure("kv.object_get", "error", "torn get")
    assert tier.get_run(key) is None
    assert tier.object_get_failures == 1
    failpoints.clear()
    failpoints.configure("kv.object_head", "error", "probe")
    assert not tier.has_run(key)  # fails closed
    failpoints.clear()
    failpoints.configure("kv.object_list", "error", "walk")
    tier.release(key)  # the marker walk fails: an orphan, never a crash
    failpoints.clear()
    assert tier.objects_released == 1
    report = port.fsck(tier.store, grace_s=0.0, repair=True)
    assert report["repaired"] >= 0


def test_torn_object_get_aborts_the_wake(model, made, tmp_path):
    """A failed object get during a wake frees every page allocated for
    it: the request re-prefills and its stream is unchanged."""
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, 30).tolist()
    kw = dict(kv_host_tier_mb=64, kv_object_dir=str(tmp_path))
    eng = port_engine(model, made, **kw)
    r1 = run(eng, GenRequest, "a1", "A", a)
    eng.sleep_to_object()
    turn2 = a + r1.output_ids + [1, 2]
    clean = run(port_engine(model, made, **kw), GenRequest, "c", "A", turn2)
    fresh = port_engine(model, made, **kw)
    free0 = fresh.pool.free_pages
    failpoints.configure("kv.object_get", "error", "torn get")
    r2 = run(fresh, GenRequest, "a2", "A", turn2)
    failpoints.clear()
    assert clean.cache_source == "object_tier"
    assert r2.cache_source is None and r2.output_ids == clean.output_ids
    assert fresh.self_check() == []
    assert fresh.kv_tier.object.object_get_failures >= 1
    assert fresh.pool.free_pages <= free0


# ---------------------------------------------------------------------------
# the S3-shaped backend
# ---------------------------------------------------------------------------


def test_http_store_against_the_stub():
    with StubS3Server() as srv:
        st = port.HTTPObjectStore(srv.url)
        assert st.get("objects/x.npz") is None
        st.put("objects/x.npz", b"abcdef")
        assert st.get("objects/x.npz") == b"abcdef"
        assert st.head("objects/x.npz")[0] == 6
        assert st.put_if_absent("refs/x/a", b"")
        assert not st.put_if_absent("refs/x/a", b"")
        assert st.list("refs/x/") == ["refs/x/a"]
        srv.torn_next = 1
        with pytest.raises(OSError):
            st.get("objects/x.npz")  # a torn body is never decoded
        assert st.torn_bodies == 1
        st.delete("objects/x.npz")
        assert st.head("objects/x.npz") is None
        # a run round trip through the tier over HTTP
        tier = port.ObjectTier(port.build_object_store(srv.url),
                               fingerprint="fp", page_size=8)
        k, v = leaves(2)
        key = tier.put_run(list(range(16)), k, v, 2)
        got = tier.get_run(key)
        assert torch.equal(got[0][0], k[0])
        g = tier.guard
        if g._executor is not None:
            g._executor.shutdown(wait=True)
