"""Disaggregated prefill/decode in kafka_tpu_torch against kafka_tpu.

Two-replica routers with role pools ("prefill:1,decode:1") over the
reference's `dp-test` model, the same weights in both packages (the JAX
router over the virtual CPU devices, the port's over CPU replica slots).

* `parse_dp_roles` / `validate_roles_spec` accept and reject the same
  specs with the same results and messages.
* A thread's hand-off: the first turn prefills on replica 0, its page run
  ships to replica 1, which decodes it — `cache_source="shipped"`, the
  same `cached_tokens`, token-exact streams in both packages, the shipped
  destination rows byte-equal to the source rows.  The port ships device
  to device only; it is held against both of the reference's transports
  (KAFKA_TPU_SHIP_TRANSPORT host / device).  The two packages' prefills
  compute the KV in different op orders, so their rows agree to f32
  rounding; the ship itself is held byte for byte against the
  reference's: the same run shipped between the same seeded pools leaves
  byte-equal destination pools (one pool layout), in one and two chunks.
* A torn ship (`kv.ship=error:nth=2` on a two-chunk run) frees every
  destination page and the thread re-prefills, its stream unchanged, in
  both packages.
* The routers' `DisaggMetrics` snapshots have the same keys and counts.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu import failpoints as jfailpoints
from kafka_tpu.models import ModelConfig as JModelConfig
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.runtime import EngineConfig as JEngineConfig
from kafka_tpu.runtime import GenRequest as JGenRequest
from kafka_tpu.runtime import dp_router as ref
from kafka_tpu_torch import failpoints
from kafka_tpu_torch.models import params_from_jax
from kafka_tpu_torch.models.config import ModelConfig
from kafka_tpu_torch.runtime import EngineConfig, GenRequest
from kafka_tpu_torch.runtime import dp_router as port
from kafka_tpu_torch.runtime.kv_tier import pool_leaves

ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16,
            prefill_buckets=(8, 16, 32, 64, 128))
DIMS = dict(name="disagg-test", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, dtype="float32")
SLOTS = [torch.device("cpu")] * 8


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
    jcfg = JModelConfig(**DIMS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(17))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ModelConfig(**DIMS), params


def routers(model, ecfg=ECFG, **kw):
    jcfg, jparams, cfg, params = model
    kw = {"dp_roles": "prefill:1,decode:1", "disagg_min_prefill_tokens": 16,
          **kw}
    j = ref.DataParallelEngines(jcfg, jparams, JEngineConfig(**ecfg), dp=2,
                                kv_dtype=jnp.float32, **kw)
    p = port.DataParallelEngines(cfg, params, EngineConfig(**ecfg), dp=2,
                                 kv_dtype=torch.float32, devices=SLOTS, **kw)
    return j, p


def prompt_of(seed, n):
    return [int(x) for x in np.random.RandomState(seed).randint(1, 128, n)]


def _err(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec,dp", [
    (None, 2), ("", 2), ("prefill:1,decode:1", 2), ("prefill:2,decode:6", 8),
    ("decode:3, prefill:1", 4), ("prefill:1,prefill:1,decode:2", 4),
    ("PREFILL:1,Decode:1", 2), ("prefill:1,decode:1,", 2),
    ("prefill:1,decode:1", 3), ("prefill:2,decode:1", 2),
    ("prefill:0,decode:2", 2), ("decode:2", 2), ("prefill:x,decode:1", 2),
    ("verify:1,decode:1", 2), ("prefill:-1,decode:3", 2), ("prefill", 2),
])
def test_role_specs_agree(spec, dp):
    assert _err(lambda: port.parse_dp_roles(spec)) == \
        _err(lambda: ref.parse_dp_roles(spec))
    assert _err(lambda: port.validate_roles_spec(spec, dp)) == \
        _err(lambda: ref.validate_roles_spec(spec, dp))


def _rows(pool_list, pages, ps):
    """Bytes of `pages`' slots in every pool leaf (either package)."""
    out = []
    for a in pool_list:
        arr = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out.append(np.concatenate(
            [arr[:, p * ps:(p + 1) * ps] for p in pages], axis=1).tobytes())
    return out


def _leaves(engine):
    if isinstance(engine.k_pool, torch.Tensor) or hasattr(engine.k_pool,
                                                          "q"):
        return pool_leaves(engine.k_pool) + pool_leaves(engine.v_pool)
    return jax.tree.leaves(engine.k_pool) + jax.tree.leaves(engine.v_pool)


def _shipped_pages(engine, key, n):
    """The first n pages of thread `key`'s radix chain on `engine`."""
    pages = []
    for node in engine.prefix_cache._claimed_chain(key):
        pages.extend(node.pages)
    return pages[:n]


# the per-transport run counters split the same shipped runs differently
_TRANSPORT_KEYS = ("disagg_ship_host_runs", "disagg_ship_device_runs")


@pytest.mark.parametrize("ref_transport", ["host", "device"])
def test_handoff_ships_and_matches(model, monkeypatch, ref_transport):
    monkeypatch.setenv("KAFKA_TPU_SHIP_TRANSPORT", ref_transport)
    j, p = routers(model)
    ps = ECFG["page_size"]
    prompt = prompt_of(20, 5 * ps + 1)
    got, rows = [], []
    for dp, Req in ((j, JGenRequest), (p, GenRequest)):
        r = Req(request_id="A", prompt_ids=list(prompt), max_new_tokens=4,
                prefix_key="T-ship")
        dp.submit(r)
        assert r.handoff and dp._route["A"] == 0
        done = dp.run_to_completion()
        assert done["A"] is r
        src, dst = dp.engines
        src_rows = _rows(_leaves(src), _shipped_pages(src, "T-ship", 5), ps)
        dst_rows = _rows(_leaves(dst), _shipped_pages(dst, "T-ship", 5), ps)
        assert dst_rows == src_rows
        snap = dp.disagg.snapshot()
        got.append((r.output_ids, r.cache_source, r.cached_tokens,
                     r.usage_cached_tokens, dst.prefix_cache.shipped_hits,
                     dp._affinity["T-ship"],
                     {k: v for k, v in snap.items()
                      if k not in ("ship_ms", "disagg_ship_staging_bytes")
                      + _TRANSPORT_KEYS},
                     sorted(snap), [e.self_check() for e in dp.engines],
                     [snap[k] for k in _TRANSPORT_KEYS]))
        rows.append(dst_rows)
    assert got[1][:9] == got[0][:9]
    assert got[0][9] == ([1, 0] if ref_transport == "host" else [0, 1])
    assert got[1][9] == [0, 1]
    # the two packages compute the prefill's KV in different op orders:
    # the shipped rows agree to f32 rounding (the ship itself is held
    # byte for byte in test_shipper_bytes_equal_the_reference)
    for a, b in zip(*rows):
        np.testing.assert_allclose(np.frombuffer(a, np.float32),
                                   np.frombuffer(b, np.float32),
                                   rtol=1e-5, atol=1e-5)
    out, source, cached, usage, hits, home = got[1][:6]
    assert source == "shipped" and cached == len(prompt) - 1
    assert usage == 0 and hits == 1 and home == 1
    counts = got[1][6]
    assert counts["disagg_shipped_runs"] == 1
    assert counts["disagg_shipped_pages"] == 5
    assert got[1][8] == [[], []]


class _Owner:
    """A pool holder standing in for a replica engine: the same numpy
    pools (seeded) as the reference's jax arrays or the port's tensors."""

    def __init__(self, side, num_pages, ps, seed, layers=2, width=8):
        rng = np.random.default_rng(seed)
        shape = (layers, num_pages * ps, width)
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        conv = jnp.asarray if side == "ref" else torch.from_numpy
        self.k_pool, self.v_pool = conv(k), conv(v)


@pytest.mark.parametrize("ref_transport", ["host", "device"])
@pytest.mark.parametrize("n_pages", [3, 67])
def test_shipper_bytes_equal_the_reference(ref_transport, n_pages):
    """The same page run shipped between the same pools by both packages'
    CrossReplicaPageShipper (the reference over each of its transports,
    the port device to device): destination pools byte-equal (the whole
    pool: untouched pages stay, the trash page takes the padding), equal
    byte counts; one and two chunks (> 64 pages)."""
    from kafka_tpu.runtime.kv_tier import CrossReplicaPageShipper as JShip
    from kafka_tpu_torch.runtime.kv_tier import CrossReplicaPageShipper

    ps = 2
    src_pages = list(range(1, 1 + n_pages))
    dst_pages = list(range(80, 80 - n_pages, -1))
    out = []
    for side, Ship in (("ref", JShip), ("port", CrossReplicaPageShipper)):
        src, dst = _Owner(side, 90, ps, 1), _Owner(side, 90, ps, 2)
        ship = (Ship(src, dst, ps, transport=ref_transport)
                if side == "ref" else Ship(src, dst, ps))
        nbytes = ship.ship(src_pages, dst_pages)
        pools = [np.asarray(a)[:, ps:].tobytes() for a in (
            dst.k_pool, dst.v_pool)]
        want = _rows([src.k_pool, src.v_pool], src_pages, ps)
        assert _rows([dst.k_pool, dst.v_pool], dst_pages, ps) == want
        out.append((nbytes, ship.bytes_per_page(), pools))
        assert ship.transport == (ref_transport if side == "ref"
                                  else "device")
    assert out[1] == out[0]


@pytest.mark.cuda
def test_ship_across_two_cards_is_byte_equal():
    """Replicas on two cards: a three-chunk run (64 + 64 + 8 pages) ships
    from cuda:0's pool into each other card's, and every destination row
    equals its source row byte for byte.  GEMMs queued first on cuda:0
    delay the source gathers: the peer copy must order the two cards'
    current streams (nothing here synchronizes between the chunks)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from kafka_tpu_torch.runtime.kv_tier import CrossReplicaPageShipper

    class Pools:
        def __init__(self, device, seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            shape = (2, 200 * 16, 512)
            self.k_pool = torch.randn(shape, generator=gen, device=device,
                                      dtype=torch.bfloat16)
            self.v_pool = torch.randn(shape, generator=gen, device=device,
                                      dtype=torch.bfloat16)

    def rows(owner, pages):
        idx = torch.tensor([p * 16 + i for p in pages for i in range(16)],
                           device=owner.k_pool.device)
        return [a.index_select(1, idx).cpu().view(torch.int16)
                for a in (owner.k_pool, owner.v_pool)]

    src_pages = list(range(1, 137))
    dst_pages = list(range(199, 63, -1))
    for d in range(1, torch.cuda.device_count()):
        src, dst = Pools("cuda:0", 1), Pools(f"cuda:{d}", 2 + d)
        busy = torch.randn(8192, 8192, device="cuda:0")
        for _ in range(20):
            busy = busy @ busy / 90.0
        CrossReplicaPageShipper(src, dst, 16).ship(src_pages, dst_pages)
        torch.cuda.synchronize(f"cuda:{d}")
        for a, b in zip(rows(src, src_pages), rows(dst, dst_pages)):
            assert torch.equal(a, b), f"cuda:0 -> cuda:{d}"


def test_torn_ship_reprefills(model):
    """A two-chunk ship (70 pages at page 4, chunks of 64 + 6) torn at
    chunk 2: the first chunk already landed, every destination page is
    freed, the thread re-prefills on replica 1 and its stream equals the
    reference's."""
    ecfg = dict(max_batch=2, page_size=4, num_pages=256,
                max_pages_per_seq=96, prefill_buckets=(16, 64, 128, 256, 512))
    j, p = routers(model, ecfg=ecfg)
    prompt = prompt_of(42, 281)
    got = []
    for dp, Req, fp in ((j, JGenRequest, jfailpoints),
                        (p, GenRequest, failpoints)):
        dst = dp.engines[1]
        free_before = dst.pool.free_pages
        r = Req(request_id="T2", prompt_ids=list(prompt), max_new_tokens=4,
                prefix_key="T-torn2")
        fp.configure("kv.ship", "error", "torn", nth=2)
        try:
            dp.submit(r)
            assert r.handoff
            done = dp.run_to_completion()
        finally:
            fp.clear()
        pc = dst.prefix_cache
        got.append((done["T2"].output_ids, r.cache_source,
                    dp.disagg.ship_failures, dp.disagg.shipped_runs,
                    dst.pool.free_pages - (free_before - pc.total_pages),
                    dst.pool.check_consistency(),
                    [e.self_check() for e in dp.engines]))
    assert got[1] == got[0]
    assert got[1][1] != "shipped" and got[1][2] == 1 and got[1][3] == 0
    assert got[1][4] == 0 and got[1][5] == [] and got[1][6] == [[], []]


def test_short_prompt_prefills_in_place(model):
    j, p = routers(model)
    got = []
    for dp, Req in ((j, JGenRequest), (p, GenRequest)):
        r = Req(request_id="s", prompt_ids=prompt_of(3, 9), max_new_tokens=3,
                prefix_key="T-short")
        dp.submit(r)
        route, handoff = dp._route["s"], r.handoff
        dp.run_to_completion()
        got.append((route, handoff, r.output_ids, dp.disagg.snapshot()[
            "disagg_prefill_in_place"]))
    assert got[1] == got[0] == [(1, False, got[0][2], 1)][0]
