"""kafka_tpu_torch kernels (K1 paged decode, K2 flash prefill, K3 paged
verify, K4 int8 paged decode, K5 fused decode MLP) vs the JAX package's
Pallas kernels, and the port's ops vs the JAX ops.

On the CPU the port's wrappers run their plain versions; each is held to
the Pallas kernel run in interpret mode on the same numpy inputs (random
page layouts), atol/rtol 2e-5 in float32 — the tolerance the JAX
package's own kernel tests use; K4 at atol 1e-5 in f32; K5 at 0.05 in
bf16 and int8 (tests/test_fused_mlp.py's own tolerance: the two round
the same bf16 values at the same points but sum in another order, so a
rounding may land one bf16 ulp apart) and 1e-4 in f32.  The CUDA kernels
themselves need a card: those tests carry the `cuda` marker and skip
here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.models.config import get_config as jax_get_config
from kafka_tpu.ops.attention import causal_attention as jax_causal
from kafka_tpu.ops.norms import rms_norm as jax_rms_norm
from kafka_tpu.models.quant import quantize_array as jax_quantize_array
from kafka_tpu.ops.pallas import (
    paged_decode_attention as pallas_decode,
    paged_decode_attention_int8 as pallas_decode_int8,
    paged_prefill_attention as pallas_prefill,
    paged_verify_attention as pallas_verify,
)
from kafka_tpu.ops.pallas.fused_mlp import fused_mlp_block as pallas_mlp
from kafka_tpu.ops.rope import (
    apply_rope as jax_apply_rope,
    rope_cos_sin as jax_rope_cos_sin,
    rope_frequencies as jax_rope_frequencies,
)
from kafka_tpu_torch.models.config import get_config
from kafka_tpu_torch.ops import (
    apply_rope,
    causal_attention,
    repeat_kv,
    rms_norm,
    rope_cos_sin,
    rope_frequencies,
)
from kafka_tpu_torch.ops import kernels
from kafka_tpu_torch.models.quant import quantize_array
from kafka_tpu_torch.ops.kernels import (
    fused_mlp_block,
    fused_mlp_block_plain,
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_verify_attention,
    paged_verify_attention_plain,
)
from kafka_tpu_torch.ops.kernels.common import (
    MAX_CHUNK_PAGES,
    MAX_MERGE_CHUNKS,
    chunk_plan,
    chunk_scratch,
)
from kafka_tpu_torch.ops.kernels.flash_prefill import ROW_TILES
from kafka_tpu_torch.ops.kernels.fused_mlp import check_args

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """6 xdist workers share the box's cores: one intra-op thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# plain ops vs the JAX ops
# ---------------------------------------------------------------------------


class TestOps:
    def test_rms_norm(self):
        rng = np.random.RandomState(0)
        x = rng.randn(3, 5, 64).astype(np.float32) * 3
        w = rng.randn(64).astype(np.float32)
        ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
        np.testing.assert_allclose(rms_norm(t(x), t(w), 1e-5).numpy(), ref,
                                   **TOL)

    @pytest.mark.parametrize("name", ["tiny", "llama-3.2-1b", "llama-3.1-8b"])
    def test_rope_with_scaling(self, name):
        cfg, jcfg = get_config(name), jax_get_config(name)
        inv = rope_frequencies(cfg)
        jinv = np.asarray(jax_rope_frequencies(jcfg))
        np.testing.assert_allclose(inv.numpy(), jinv, rtol=1e-6, atol=0)
        rng = np.random.RandomState(1)
        pos = rng.randint(0, 20000, size=(2, 7)).astype(np.int32)
        x = rng.randn(2, 7, 4, cfg.head_dim).astype(np.float32)
        cos, sin = rope_cos_sin(t(pos), inv)
        jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), jnp.asarray(jinv))
        ref = np.asarray(jax_apply_rope(jnp.asarray(x), jcos, jsin))
        # angles reach 2e4 rad: f32 cos/sin of large arguments differ in
        # the last bits between libraries
        np.testing.assert_allclose(apply_rope(t(x), cos, sin).numpy(), ref,
                                   atol=2e-3, rtol=1e-3)

    def test_rope_small_positions_tight(self):
        cfg, jcfg = get_config("tiny"), jax_get_config("tiny")
        pos = np.arange(12, dtype=np.int32)[None]
        x = np.random.RandomState(2).randn(1, 12, 4, 16).astype(np.float32)
        cos, sin = rope_cos_sin(t(pos), rope_frequencies(cfg))
        jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos),
                                      jax_rope_frequencies(jcfg))
        ref = np.asarray(jax_apply_rope(jnp.asarray(x), jcos, jsin))
        np.testing.assert_allclose(apply_rope(t(x), cos, sin).numpy(), ref,
                                   **TOL)

    @pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
    def test_causal_attention(self, hq, hkv):
        rng = np.random.RandomState(3)
        B, Sq, Skv, D = 2, 5, 11, 16
        q = rng.randn(B, Sq, hq, D).astype(np.float32)
        k = rng.randn(B, Skv, hkv, D).astype(np.float32)
        v = rng.randn(B, Skv, hkv, D).astype(np.float32)
        qp = np.array([[6, 7, 8, 9, 10], [0, 1, 2, 3, 4]], np.int32)
        kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
        valid = rng.rand(B, Skv) > 0.2
        valid[:, 0] = True
        ref = np.asarray(jax_causal(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
            kv_valid=jnp.asarray(valid)))
        out = causal_attention(t(q), t(k), t(v), q_positions=t(qp),
                               kv_positions=t(kp), kv_valid=t(valid))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_repeat_kv(self):
        x = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).view(2, 3, 2, 4)
        r = repeat_kv(x, 3)
        assert r.shape == (2, 3, 6, 4)
        assert torch.equal(r[:, :, 0], x[:, :, 0])
        assert torch.equal(r[:, :, 2], x[:, :, 0])
        assert torch.equal(r[:, :, 3], x[:, :, 1])


# ---------------------------------------------------------------------------
# K1 / K2 plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def make_decode_case(seed, B, P, ps, Hq, Hkv, D, num_pages):
    """Random paged layout: each sequence owns a random page list (page 0 =
    trash); lane B-1 is a trash lane whose table row is all page 0."""
    rng = np.random.RandomState(seed)
    HD = Hkv * D
    k_pool = rng.randn(num_pages * ps, HD).astype(np.float32)
    v_pool = rng.randn(num_pages * ps, HD).astype(np.float32)
    q = rng.randn(B, Hq, D).astype(np.float32)
    free = list(range(1, num_pages))
    rng.shuffle(free)
    table = np.zeros((B, P), np.int32)
    seq_lens = rng.randint(0, P * ps - 1, size=B).astype(np.int32)
    seq_lens[0] = ps - 1  # exactly one full page valid
    seq_lens[1] = ps      # one past a page boundary
    for b in range(B - 1):
        for i in range(int(np.ceil((seq_lens[b] + 1) / ps))):
            table[b, i] = free.pop()
    return q, k_pool, v_pool, table, seq_lens


class TestPagedDecodePlain:
    @pytest.mark.parametrize("seed,Hq,Hkv,D", [
        (0, 8, 4, 32), (1, 8, 2, 16), (2, 4, 1, 16), (3, 4, 4, 32),
    ])
    def test_matches_pallas(self, seed, Hq, Hkv, D):
        ps, P = 8, 6
        q, kp, vp, table, lens = make_decode_case(seed, 5, P, ps, Hq, Hkv, D,
                                                  num_pages=40)
        ref = np.asarray(pallas_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens), page_size=ps,
            interpret=True))
        out = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table),
                                           t(lens), page_size=ps)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        q, kp, vp, table, lens = make_decode_case(4, 3, 4, 8, 8, 2, 16, 20)
        kernels.reset_launch_counts()
        a = paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                                   page_size=8)
        b = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table),
                                         t(lens), page_size=8)
        assert torch.equal(a, b)
        assert paged_decode_attention.launches == 0  # no kernel on the CPU

    def test_single_token_sequence(self):
        q, kp, vp, table, _ = make_decode_case(5, 2, 4, 8, 4, 2, 16, 16)
        lens = np.zeros(2, np.int32)
        ref = np.asarray(pallas_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens), page_size=8,
            interpret=True))
        out = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table),
                                           t(lens), page_size=8)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


class TestFlashPrefillPlain:
    @pytest.mark.parametrize("start,chunk_len,S,Hq,Hkv,D", [
        # first chunk, full
        pytest.param(0, 16, 16, 8, 4, 16, id="0-16-16-8-4"),
        # first chunk, padded tail
        pytest.param(0, 11, 16, 8, 2, 16, id="0-11-16-8-2"),
        # later chunk with context
        pytest.param(32, 16, 16, 8, 4, 16, id="32-16-16-8-4"),
        # short final chunk, MQA
        pytest.param(48, 5, 16, 4, 1, 16, id="48-5-16-4-1"),
        # chunk not page-aligned at its start
        pytest.param(24, 30, 32, 8, 2, 16, id="24-30-32-8-2"),
        # Llama-3.1-8B's head_dim with G 8, first chunk with a padded tail
        pytest.param(0, 13, 16, 8, 1, 128, id="d128-g8-first"),
        # D 128, G 8, a later chunk whose window spans shuffled pages
        pytest.param(40, 20, 24, 16, 2, 128, id="d128-g8-start40"),
    ])
    def test_matches_pallas(self, start, chunk_len, S, Hq, Hkv, D):
        ps, P = 8, 12
        rng = np.random.RandomState(start + chunk_len)
        num_pages = P + 5
        HD = Hkv * D
        kp = rng.randn(num_pages * ps, HD).astype(np.float32)
        vp = rng.randn(num_pages * ps, HD).astype(np.float32)
        q = rng.randn(S, Hq, D).astype(np.float32)
        page_row = (rng.permutation(num_pages - 1)[:P] + 1).astype(np.int32)
        ref = np.asarray(pallas_prefill(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(page_row), jnp.int32(start), jnp.int32(chunk_len),
            page_size=ps, q_block=8, interpret=True))
        out = paged_prefill_attention_plain(t(q), t(kp), t(vp), t(page_row),
                                            start, chunk_len, page_size=ps)
        # rows past chunk_len are garbage on both paths
        np.testing.assert_allclose(out.numpy()[:chunk_len], ref[:chunk_len],
                                   **TOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        rng = np.random.RandomState(9)
        q = rng.randn(8, 4, 16).astype(np.float32)
        kp = rng.randn(10 * 8, 32).astype(np.float32)
        vp = rng.randn(10 * 8, 32).astype(np.float32)
        row = np.arange(1, 5, dtype=np.int32)
        kernels.reset_launch_counts()
        a = paged_prefill_attention(t(q), t(kp), t(vp), t(row), 8, 6,
                                    page_size=8)
        b = paged_prefill_attention_plain(t(q), t(kp), t(vp), t(row), 8, 6,
                                          page_size=8)
        assert torch.equal(a, b)
        assert paged_prefill_attention.launches == 0


def make_verify_case(seed, B=3, P=6, ps=8, Hq=4, Hkv=2, D=16, num_pages=24,
                     S=4):
    """The inputs of tests/test_pallas_kernels.py::TestPagedVerifyAttention:
    random page lists, ragged seq_lens, q_lens in 1..S."""
    rng = np.random.RandomState(seed)
    k_pool = rng.randn(num_pages * ps, Hkv * D).astype(np.float32)
    v_pool = rng.randn(num_pages * ps, Hkv * D).astype(np.float32)
    q = rng.randn(B, S, Hq, D).astype(np.float32)
    free = list(range(1, num_pages))
    rng.shuffle(free)
    table = np.zeros((B, P), np.int32)
    seq_lens = rng.randint(1, P * ps - S - 1, size=B).astype(np.int32)
    q_lens = rng.randint(1, S + 1, size=B).astype(np.int32)
    for b in range(B):
        for i in range(int(np.ceil((seq_lens[b] + S + 1) / ps))):
            table[b, i] = free.pop()
    return q, k_pool, v_pool, table, seq_lens, q_lens


class TestPagedVerifyPlain:
    @pytest.mark.parametrize("seed,Hq,Hkv,D,S", [
        (0, 4, 2, 16, 4), (1, 4, 2, 16, 4), (2, 8, 2, 16, 5),
        (3, 4, 1, 32, 3),
        # more than 32 query rows per kv head (G * S), which the CUDA
        # kernel once refused: G 4 at S 9 (speculative_k 8), G 8 at S 5
        (4, 16, 4, 16, 9), (5, 16, 2, 16, 5),
    ])
    def test_matches_pallas(self, seed, Hq, Hkv, D, S):
        """Rows j < q_len against the Pallas kernel in interpret mode."""
        args = make_verify_case(seed, Hq=Hq, Hkv=Hkv, D=D, S=S)
        q, kp, vp, table, lens, qlens = args
        ref = np.asarray(pallas_verify(
            *(jnp.asarray(a) for a in args), page_size=8, interpret=True))
        out = paged_verify_attention_plain(*(t(a) for a in args),
                                           page_size=8).numpy()
        for b in range(q.shape[0]):
            n = int(qlens[b])
            np.testing.assert_allclose(out[b, :n], ref[b, :n], **TOL)

    def test_one_query_equals_decode(self):
        """S = 1, q_len = 1 is a decode step: plain K3 equals plain K1."""
        q, kp, vp, table, lens = make_decode_case(6, 4, 6, 8, 8, 2, 16, 30)
        q1 = t(q)[:, None]
        ones = torch.ones(4, dtype=torch.int32)
        got = paged_verify_attention_plain(q1, t(kp), t(vp), t(table),
                                           t(lens), ones, page_size=8)
        want = paged_decode_attention_plain(t(q), t(kp), t(vp), t(table),
                                            t(lens), page_size=8)
        assert torch.equal(got[:, 0], want)

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = [t(a) for a in make_verify_case(7)]
        kernels.reset_launch_counts()
        a = paged_verify_attention(*args, page_size=8)
        b = paged_verify_attention_plain(*args, page_size=8)
        assert torch.equal(a, b)
        assert paged_verify_attention.launches == 0


# ---------------------------------------------------------------------------
# K4 / K5 plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def make_int8_case(seed, B, P, ps, Hq, Hkv, D, num_pages):
    """K1's random paged layout (lane B-1 a trash lane) with both pools
    quantized per slot, as the engine's KV write does; pages no sequence
    owns keep stale codes and scales."""
    q, kp, vp, table, lens = make_decode_case(seed, B, P, ps, Hq, Hkv, D,
                                              num_pages)
    kq, vq = quantize_array(t(kp), (-1,)), quantize_array(t(vp), (-1,))
    return (t(q), kq.q, kq.s, vq.q, vq.s, t(table), t(lens))


class TestPagedDecodeInt8Plain:
    @pytest.mark.parametrize("seed,Hq,Hkv,D", [
        (0, 8, 4, 32), (1, 8, 2, 16), (2, 4, 1, 16),
    ])
    def test_matches_pallas(self, seed, Hq, Hkv, D):
        args = make_int8_case(seed, 5, 6, 8, Hq, Hkv, D, num_pages=40)
        ref = np.asarray(pallas_decode_int8(
            *(jnp.asarray(a.numpy()) for a in args), page_size=8,
            interpret=True))
        out = paged_decode_attention_int8_plain(*args, page_size=8)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    def test_window_on_a_chunk_boundary(self):
        """A window of 256 slots, which ends on a chunk boundary of the
        CUDA kernel, one slot past it, and shorter ones, page 16."""
        ps, P = 16, 17
        args = list(make_int8_case(8, 4, P, ps, 8, 2, 16, 4 * P + 1))
        # every lane owns its whole window (shuffled pages, none trash)
        table = np.random.RandomState(9).permutation(4 * P) + 1
        args[5] = t(table.reshape(4, P).astype(np.int32))
        args[6] = torch.tensor([255, 256, 127, 100], dtype=torch.int32)
        ref = np.asarray(pallas_decode_int8(
            *(jnp.asarray(a.numpy()) for a in args), page_size=ps,
            interpret=True))
        out = paged_decode_attention_int8_plain(*args, page_size=ps)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = make_int8_case(4, 3, 4, 8, 8, 2, 16, 20)
        kernels.reset_launch_counts()
        a = paged_decode_attention_int8(*args, page_size=8)
        b = paged_decode_attention_int8_plain(*args, page_size=8)
        assert torch.equal(a, b)
        assert paged_decode_attention_int8.launches == 0


class TestChunkPlan:
    """The wrappers' chunk arithmetic (ops/kernels/common.py), against a
    numpy count of each lane's chunks: the grid bound covers every chunk
    and the scratch holds every partial."""

    @pytest.mark.parametrize("target,ps,P", [
        (128, 16, 128), (256, 16, 128), (128, 16, 8), (256, 8, 33),
        (128, 32, 5), (256, 1, 600), (128, 256, 3),
    ])
    def test_grid_and_scratch_cover_every_chunk(self, target, ps, P):
        plan = chunk_plan(P, ps, target)
        cap = P * ps
        assert plan.chunk % ps == 0
        assert 1 <= plan.chunk // ps <= MAX_CHUNK_PAGES
        assert plan.chunk == max(ps, min(target // ps, MAX_CHUNK_PAGES) * ps)
        rng = np.random.RandomState(P)
        B, Hkv, S, Hq, D = 7, 8, 5, 32, 64
        seq = rng.randint(0, cap + 4, size=B)
        seq[:4] = [0, cap - 1, plan.chunk - 1, cap + 3]
        # decode steps add one token, verify steps q_len (clamped to S);
        # a lane's chunks start at 0, chunk, ... below its window (one for
        # an empty window, so every row is written)
        for new in (np.ones(B, np.int64), rng.randint(0, S + 3, size=B)):
            n_valid = np.clip(seq + np.minimum(new, S), 0, cap)
            counts = np.array([max(1, len(range(0, n, plan.chunk)))
                               for n in n_valid])
            # the grid, B * max_chunks blocks a kv head, covers every chunk
            assert counts.max() <= plan.max_chunks
            assert counts.sum() <= B * plan.max_chunks
        # a full window takes every chunk the scratch holds, no more
        assert len(range(0, cap, plan.chunk)) == plan.max_chunks
        assert (plan.max_chunks - 1) * plan.chunk < cap
        assert plan.scratch_shapes(B, S * Hq, D) == (
            (B, plan.max_chunks, S * Hq, D), (B, plan.max_chunks, S * Hq, 2))

    def test_wrappers_chunks_and_one_chunk_scratch(self):
        from kafka_tpu_torch.ops.kernels import (
            paged_decode as k1, paged_decode_int8 as k4, paged_verify as k3)

        # K1, K3 and K4: 128-token chunks at page 16
        assert [chunk_plan(128, 16, m.CHUNK_TOKENS).chunk
                for m in (k1, k3, k4)] == [128, 128, 128]
        out = torch.zeros(2, 4, 8)
        plan = chunk_plan(4, 16, 128)  # a 64-token window: one chunk
        assert plan.max_chunks == 1
        acc, ml = chunk_scratch(plan, 2, 4, 8, out)
        assert acc is out and ml is out
        acc, ml = chunk_scratch(chunk_plan(9, 16, 128), 2, 4, 8, out)
        assert acc.shape == (2, 2, 4, 8) and ml.shape == (2, 2, 4, 2)
        assert acc.dtype == ml.dtype == torch.float32
        with pytest.raises(ValueError, match="merge at most"):
            chunk_plan(MAX_MERGE_CHUNKS * 8 + 1, 16, 128)


def make_mlp_case(seed, B=8, H=256, F=1024):
    """tests/test_fused_mlp.py's shapes and scales, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H).astype(np.float32),
            (rng.randn(H) * 0.1 + 1).astype(np.float32),
            (rng.randn(H, F) * H ** -0.5).astype(np.float32),
            (rng.randn(H, F) * H ** -0.5).astype(np.float32),
            (rng.randn(F, H) * F ** -0.5).astype(np.float32))


class TestFusedMLPPlain:
    @pytest.mark.parametrize("kind,tol", [
        ("bfloat16", 0.05), ("int8", 0.05), ("float32", 1e-4),
    ])
    def test_matches_pallas(self, kind, tol):
        h, ln, wg, wu, wd = make_mlp_case({"bfloat16": 0, "int8": 3,
                                           "float32": 5}[kind])
        dt = jnp.float32 if kind == "float32" else jnp.bfloat16
        pdt = torch.float32 if kind == "float32" else torch.bfloat16
        jh, jln = jnp.asarray(h, dt), jnp.asarray(ln, dt)
        ws = [jnp.asarray(w, dt) for w in (wg, wu, wd)]
        th, tln = t(h).to(pdt), t(ln).to(pdt)
        if kind == "int8":
            jq = [jax_quantize_array(w, (0,)) for w in ws]
            jargs = [q.q for q in jq] + [q.s for q in jq]
            targs = [t(np.array(a)) for a in jargs]
        else:
            jargs = ws
            targs = [t(np.array(w.astype(jnp.float32))).to(pdt)
                     for w in ws]
        ref = np.asarray(pallas_mlp(jh, jln, *jargs, eps=1e-5,
                                    interpret=True).astype(jnp.float32))
        out = fused_mlp_block_plain(th, tln, *targs, eps=1e-5)
        assert out.dtype == pdt
        assert np.abs(out.float().numpy() - ref).max() < tol

    def test_wrapper_takes_plain_version_on_cpu(self):
        h, ln, wg, wu, wd = (t(a) for a in make_mlp_case(7, B=2, H=64,
                                                          F=128))
        kernels.reset_launch_counts()
        a = fused_mlp_block(h, ln, wg, wu, wd, eps=1e-5)
        b = fused_mlp_block_plain(h, ln, wg, wu, wd, eps=1e-5)
        assert torch.equal(a, b)
        assert fused_mlp_block.launches == 0

    @pytest.mark.parametrize("B,H,F,limit", [
        (65, 256, 1024, "B <= 64"), (8, 192, 1024, "multiples of 128"),
        (8, 256, 1000, "multiples of 128"),
    ])
    def test_argument_checks_name_the_kernels_limits(self, B, H, F, limit):
        """What the CUDA kernel refuses, checked on CPU tensors: more than
        64 rows, and H or F off its 128-row tiles."""
        h, ln, wg, wu, wd = (t(a).to(torch.bfloat16) for a in
                             make_mlp_case(2, B=B, H=H, F=F))
        with pytest.raises(ValueError, match=limit):
            check_args(h, ln, wg, wu, wd, (None, None, None))

    def test_argument_checks_pass_the_llama_shape(self):
        h, ln, wg, wu, wd = (t(a).to(torch.bfloat16) for a in
                             make_mlp_case(2, B=64, H=256, F=1024))
        assert check_args(h, ln, wg, wu, wd, (None,) * 3) == (
            64, 256, 1024, False)


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestCudaKernels:
    """Each kernel against its plain version on the card at Llama-3.2-1B
    geometry, bf16: |kernel - plain| <= 2e-2 + 2^-7 |plain| (two bf16 ulps
    relative; chip_smoke.py states the same tolerance)."""

    def _close(self, got, want):
        diff = (got.float() - want.float()).abs()
        assert (diff <= 2e-2 + 2.0 ** -7 * want.float().abs()).all(), \
            diff.max().item()

    @pytest.mark.parametrize("case", [
        "ragged", "long", "short", "boundaries", "G8", "G1", "D128"])
    def test_paged_decode_kernel(self, cuda, case):
        """The chunked kernel at each of chip_smoke.py's K1 cases: every
        lane at 2,047 tokens, every lane <= 32 tokens in a one-chunk window,
        windows ending on chunk and page boundaries, G 8 and G 1, and D 128;
        held elementwise and per (row, head) (||d|| / ||plain|| <= 0.02)."""
        Hq, Hkv, D, P, lens = {
            "ragged": (32, 8, 64, 32, None),
            "long": (32, 8, 64, 128, [2046] * 8),
            "short": (32, 8, 64, 8, [0, 1, 7, 15, 16, 17, 30, 31]),
            "boundaries": (32, 8, 64, 128,
                           [127, 128, 126, 255, 15, 16, 1023, 2047]),
            "G8": (64, 8, 64, 128, [15, 16, 31, 255, 511, 700, 2046, 5]),
            "G1": (8, 8, 64, 128, [15, 16, 31, 255, 511, 700, 2046, 5]),
            "D128": (32, 8, 128, 128, [15, 16, 31, 255, 511, 700, 2046, 5]),
        }[case]
        q, kp, vp, table, rand_lens = make_decode_case(
            0, 8, P, 16, Hq, Hkv, D, 8 * P + 1)
        if lens is not None:
            rng = np.random.RandomState(1)
            table = (rng.permutation(8 * P).reshape(8, P) + 1
                     ).astype(np.int32)
            rand_lens = np.asarray(lens, np.int32)
        args = [t(a).to(cuda) for a in (q, kp, vp)]
        args = [a.to(torch.bfloat16) for a in args] + \
            [t(table).to(cuda), t(rand_lens).to(cuda)]
        before = paged_decode_attention.launches
        out = paged_decode_attention(*args, page_size=16)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_decode_attention_plain(*args, page_size=16)
        self._close(out, want)
        rel = ((out.float() - want.float()).norm(dim=-1)
               / want.float().norm(dim=-1).clamp_min(1e-6)).max().item()
        assert rel <= 0.02, rel

    def test_flash_prefill_kernel(self, cuda):
        """Short and long chunks (every block shape the launcher picks, and
        each shape pinned at every case), start > 0 over shuffled pages,
        D 128 with G 4 and G 8; rows past chunk_len come back as zeros."""
        rng = np.random.RandomState(1)
        for S, start, clen, Hq, Hkv, D in (
                (128, 0, 128, 32, 8, 64), (128, 64, 100, 32, 8, 64),
                (2048, 0, 2048, 32, 8, 64), (1024, 2048, 1000, 32, 8, 64),
                (2048, 2048, 1170, 32, 8, 64), (2048, 0, 1500, 32, 8, 128),
                (256, 100, 200, 64, 8, 128)):
            P = (start + S) // 16
            kp, vp = (t(rng.randn((P + 8) * 16, Hkv * D).astype(np.float32))
                      .to(cuda).to(torch.bfloat16) for _ in range(2))
            q = t(rng.randn(S, Hq, D).astype(np.float32)).to(cuda).to(
                torch.bfloat16)
            row = t((rng.permutation(P + 7)[:P] + 1).astype(np.int32)).to(
                cuda)
            before = paged_prefill_attention.launches
            out = paged_prefill_attention(q, kp, vp, row, start, clen,
                                          page_size=16)
            ref = paged_prefill_attention_plain(q, kp, vp, row, start, clen,
                                                page_size=16)
            torch.cuda.synchronize()
            assert paged_prefill_attention.launches == before + 1
            self._close(out[:clen], ref[:clen])
            assert (out[clen:] == 0).all()
            for row_tiles in ROW_TILES:
                out = paged_prefill_attention(q, kp, vp, row, start, clen,
                                              page_size=16,
                                              row_tiles=row_tiles)
                self._close(out[:clen], ref[:clen])
                assert (out[clen:] == 0).all()

    def test_paged_verify_kernel(self, cuda):
        """K = 4 verify shape at Llama-3.2-1B geometry; rows j < q_len."""
        q, kp, vp, table, lens, qlens = make_verify_case(
            0, B=8, P=32, ps=16, Hq=32, Hkv=8, D=64, num_pages=8 * 32 + 1,
            S=5)
        args = [t(a).to(cuda).to(torch.bfloat16) for a in (q, kp, vp)] + \
            [t(a).to(cuda) for a in (table, lens, qlens)]
        before = paged_verify_attention.launches
        out = paged_verify_attention(*args, page_size=16)
        ref = paged_verify_attention_plain(*args, page_size=16)
        torch.cuda.synchronize()
        assert paged_verify_attention.launches == before + 1
        for b in range(8):
            n = int(qlens[b])
            self._close(out[b, :n], ref[b, :n])

    @pytest.mark.parametrize("Hq,S", [(32, 9), (32, 17), (64, 5), (64, 17)])
    def test_paged_verify_kernel_past_32_rows(self, cuda, Hq, S):
        """G * S above the 32 rows per kv head the kernel once held (fault
        C4): G 4 at S 9 and 17 (speculative_k 8 and 16), G 8 at S 5 and 17
        (two row blocks); rows j < q_len held, rows j >= q_len zeros."""
        q, kp, vp, table, lens, qlens = make_verify_case(
            1, B=8, P=32, ps=16, Hq=Hq, Hkv=8, D=64, num_pages=8 * 32 + 1,
            S=S)
        args = [t(a).to(cuda).to(torch.bfloat16) for a in (q, kp, vp)] + \
            [t(a).to(cuda) for a in (table, lens, qlens)]
        out = paged_verify_attention(*args, page_size=16)
        ref = paged_verify_attention_plain(*args, page_size=16)
        torch.cuda.synchronize()
        for b in range(8):
            n = int(qlens[b])
            self._close(out[b, :n], ref[b, :n])
            assert (out[b, n:] == 0).all()

    def test_paged_decode_int8_kernel(self, cuda):
        args = [a.to(cuda) for a in make_int8_case(
            0, 8, 32, 16, 32, 8, 64, 8 * 32 + 1)]
        args[0] = args[0].to(torch.bfloat16)
        before = paged_decode_attention_int8.launches
        out = paged_decode_attention_int8(*args, page_size=16)
        torch.cuda.synchronize()
        assert paged_decode_attention_int8.launches == before + 1
        self._close(out, paged_decode_attention_int8_plain(*args,
                                                           page_size=16))

    @pytest.mark.parametrize("lens", [
        [2046] * 8, [0, 1, 7, 15, 16, 17, 30, 31],
        [255, 256, 511, 512, 15, 16, 1023, 2047]])
    def test_paged_decode_int8_kernel_chunks(self, cuda, lens):
        """Every lane long, every lane in one chunk, and windows ending on
        the 256-token chunk and page boundaries."""
        args = [a.to(cuda) for a in make_int8_case(
            2, 8, 128, 16, 32, 8, 64, 8 * 128 + 1)]
        args[0] = args[0].to(torch.bfloat16)
        args[5] = t((np.random.RandomState(3).permutation(8 * 128) + 1)
                    .reshape(8, 128).astype(np.int32)).to(cuda)
        args[6] = torch.tensor(lens, dtype=torch.int32, device=cuda)
        out = paged_decode_attention_int8(*args, page_size=16)
        want = paged_decode_attention_int8_plain(*args, page_size=16)
        torch.cuda.synchronize()
        self._close(out, want)
        rel = ((out.float() - want.float()).norm(dim=-1)
               / want.float().norm(dim=-1).clamp_min(1e-6)).max().item()
        assert rel <= 0.02, rel

    @pytest.mark.parametrize("int8,B", [
        pytest.param(False, 8, id="False"), pytest.param(True, 8, id="True"),
        *(pytest.param(q, b, id=f"{q}-B{b}")
          for b in (1, 9, 32, 64) for q in (False, True)),
    ])
    def test_fused_mlp_kernel(self, cuda, int8, B):
        """The llama-3.2-1b decode MLP shape at B 8 (and 1, 9, 32 and 64:
        one N tile, a ragged second, four, and the largest batch, so every
        N-tile count the kernel picks runs), within the
        JAX kernel test's 0.05 (chip_smoke.py states the same
        tolerance)."""
        h, ln, wg, wu, wd = (t(a).to(cuda) for a in make_mlp_case(
            1, B=B, H=2048, F=8192))
        h, ln = h.to(torch.bfloat16), ln.to(torch.bfloat16)
        ws = [w.to(torch.bfloat16) for w in (wg, wu, wd)]
        if int8:
            qs = [quantize_array(w, (0,)) for w in ws]
            ws = [q.q for q in qs] + [q.s for q in qs]
        before = fused_mlp_block.launches
        out = fused_mlp_block(h, ln, *ws, eps=1e-5)
        ref = fused_mlp_block_plain(h, ln, *ws, eps=1e-5)
        torch.cuda.synchronize()
        assert fused_mlp_block.launches == before + 1
        assert (out.float() - ref.float()).abs().max().item() < 0.05

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, cuda):
        q = torch.zeros(2, 8, 64, device=cuda)  # float32, not bf16
        pool = torch.zeros(64, 128, device=cuda)
        table = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
        lens = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError):
            paged_decode_attention(q, pool, pool, table, lens, page_size=16)
