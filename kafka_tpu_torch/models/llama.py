"""Llama-family decoder in plain PyTorch.

Counterpart of kafka_tpu/models/llama.py (dense and Mixtral-style MoE
models).  Parameters keep the JAX package's layer-stacked layout at the
public boundary, so the tests compare like with like:

    embed [V, H], final_norm [H], lm_head [H, V] (untied only),
    layers: ln_attn/ln_mlp [L, H], wq [L, H, Hq, D], wk/wv [L, H, Hkv, D],
            wo [L, Hq, D, H], wg/wu [L, H, F], wd [L, F, H]
    MoE (cfg.is_moe): router [L, H, E], wg/wu [L, E, H, F], wd [L, E, F, H]

A MoE layer's MLP is the reference's dense dispatch (_moe_block): every
expert computes every token and the [T, E] routing weights — a softmax
over exactly the top-k router logits, the rest zero — combine them.

The layer stack is a Python loop over views of those tensors.  bf16
weights and activations, f32 norms, rope, softmax and logits — the JAX
package's numerics recipe.

Two KV cache forms, as in the JAX package:
* contiguous: KVCache k/v [L, B, C, Hkv, D], slot == absolute position;
* paged: per-layer pools [L, TOTAL_SLOTS, Hkv*D] (runtime/kv_cache.py)
  addressed through a PagedView index plan.  Decode (S == 1) runs the
  paged decode kernel (K1), a speculative verify step (S = K+1 queries
  per lane, `seq_lens` and `q_lens` set) the paged verify kernel (K3) and
  a single-sequence prefill chunk the flash prefill kernel (K2) when
  cfg.attention_backend == "kernel"; everything else gathers the window
  by page and runs the plain attention with per-query causal masking.
Unlike JAX, caches are updated IN PLACE (the pools are the engine's
largest allocation; a functional copy per step would double it), and
forward returns the same cache object.

On a rank of a tensor-parallel group (`forward(..., tp=...)`,
parallel/tp.py) the parameters and the cache are the rank's shards
(parallel/sharding.py): attention runs over its local heads (the per-rank
K1/K3/K4 of ops/kernels/sharded.py; flash prefill stays single-device, as
in the reference), the row-parallel `wo` and `wd` products are summed over
the rank's tensor group, and an untied head's vocab shards are gathered.
A MoE layer's rank holds the experts of its "ep" slice, each over its F
columns; the combine of its local experts is summed over the whole group.

Int8 (models/quant.py), as in the JAX package: any matmul weight, the
embedding table and the LM head may be a QTensor, and the paged pools may
be QTensor pools (int8 rows, one f32 scale per slot).  Over an int8 pool a
decode step runs the int8 paged decode kernel (K4); prefill chunks and
verify steps read the window through the dequantizing page gather — the
JAX package gates its flash prefill and verify kernels off int8 pools and
has no int8 kernel for either.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from ..ops.attention import causal_attention
from ..ops.kernels import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_sharded,
    paged_decode_attention_sharded,
    paged_prefill_attention,
    paged_verify_attention,
    paged_verify_attention_sharded,
)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from .config import ModelConfig
from .quant import QTensor, dequantize, quantize_array

Params = Dict[str, Any]


def _layer(x: Any, l: int) -> Any:
    """Layer l of a layer-stacked tensor or QTensor (both parts)."""
    if isinstance(x, QTensor):
        return QTensor(q=x.q[l], s=x.s[l])
    return x[l]


def _w(layers: Params, name: str, l: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer l's weight, dequantized when it is an int8 QTensor (JAX
    models/llama.py _w: the matmul sees the dense weight)."""
    return dequantize(_layer(layers[name], l), dtype)


def _kv_write(cache: Any, idx: torch.Tensor, rows: torch.Tensor,
              tp: Any = None) -> None:
    """Scatter new KV rows into a pool at flat slot indices, in place.
    rows [..., Hkv*D]; idx [...] integer.  An int8 pool (QTensor) takes
    each row quantized against its own abs-max, with its f32 scale — the
    JAX package's per-slot recipe.  On a rank of a tensor-parallel group
    the rows are the rank's kv heads, and the abs-max is max-reduced over
    the ranks first: the scale is the whole row's, the same on every
    rank."""
    idx = idx.reshape(-1).long()
    if isinstance(cache, QTensor):
        if tp is not None:
            amax = tp.all_reduce_max(rows.float().abs().amax(-1, keepdim=True))
            s_ = torch.clamp(amax, min=1e-8) / 127.0
            qt = QTensor(q=torch.clamp(torch.round(rows.float() / s_), -127,
                                       127).to(torch.int8), s=s_)
        else:
            qt = quantize_array(rows, (-1,))
        hd = cache.q.shape[-1]
        cache.q.index_copy_(0, idx, qt.q.reshape(-1, hd))
        cache.s.index_copy_(0, idx, qt.s.reshape(-1, 1))
        return
    cache.index_copy_(0, idx,
                      rows.reshape(-1, cache.shape[-1]).to(cache.dtype))


def _kv_read(cache: Any, idx: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Gather pool rows at flat slot indices: idx [B, C] -> [B, C, Hkv*D];
    an int8 pool is dequantized to `dtype`."""
    if isinstance(cache, QTensor):
        return dequantize(QTensor(q=cache.q[idx], s=cache.s[idx]), dtype)
    return cache[idx]


def _kv_read_pages(cache: Any, page_table: torch.Tensor, page_size: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Gather a [B, P*page_size, Hkv*D] window by PAGE (B*P contiguous
    blocks instead of B*C rows).  page_table: [B, P].  An int8 pool's
    rows and per-slot scales are gathered the same way and dequantized to
    `dtype`."""
    pt = page_table.long()
    lead = page_table.shape[:-1]
    if isinstance(cache, QTensor):
        slots, hd = cache.q.shape
        q = cache.q.view(slots // page_size, page_size, hd)[pt]
        s = cache.s.view(slots // page_size, page_size, 1)[pt]
        return dequantize(QTensor(q=q.reshape(*lead, -1, hd),
                                  s=s.reshape(*lead, -1, 1)), dtype)
    slots, hd = cache.shape
    win = cache.view(slots // page_size, page_size, hd)[pt]
    return win.reshape(*lead, -1, hd)


class KVCache(NamedTuple):
    """Contiguous per-layer KV cache: k/v are [L, B, C, Hkv, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


class PagedView(NamedTuple):
    """Index plan for one step against a paged KV pool [L, SLOTS, Hkv*D].

    write_idx:    [B, S]  flat slot for each new token's k/v (int64)
    read_idx:     [B, C]  flat slots of each sequence's window (slot-gather
                          form; None when page_table is given)
    kv_positions: [B, C]  absolute position of each window slot
    kv_valid:     [B, C]  False for unallocated/beyond-length slots
    page_table:   [B, P]  physical page ids (int32)
    seq_lens:     [B]     cached token counts before the step, int32
                          (decode and verify kernels only)
    page_size:    int
    start, chunk_len: host ints bounding a prefill chunk (prefill kernel
                  only; B == 1)
    q_lens:       [B]     valid queries per lane of a verify step
                          (cand_len + 1), int32 (verify kernel only; the
                          JAX package carries it as chunk_len)
    """

    write_idx: torch.Tensor
    read_idx: Optional[torch.Tensor]
    kv_positions: torch.Tensor
    kv_valid: torch.Tensor
    page_table: Optional[torch.Tensor] = None
    seq_lens: Optional[torch.Tensor] = None
    page_size: Optional[int] = None
    start: Optional[int] = None
    chunk_len: Optional[int] = None
    q_lens: Optional[torch.Tensor] = None


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                  device=None) -> KVCache:
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                device=None) -> Params:
    """Random-init parameters (layer-stacked), normal * fan_in^-0.5 as in
    the JAX package.  `generator` lives on `device` (draws are made there,
    so a full-width model never passes through host memory)."""
    dtype = dtype or cfg.activation_dtype
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def norm01(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Params = {
        "ln_attn": ones((L, h)),
        "ln_mlp": ones((L, h)),
        "wq": norm01((L, h, hq, d), h),
        "wk": norm01((L, h, hkv, d), h),
        "wv": norm01((L, h, hkv, d), h),
        "wo": norm01((L, hq, d, h), hq * d),
    }
    if cfg.is_moe:
        # Mixtral-style MoE MLP: router [L, H, E] + E stacked SwiGLU
        # experts per layer (the expert axis shards over "ep")
        E = cfg.num_experts
        layers["wg"] = norm01((L, E, h, f), h)
        layers["wu"] = norm01((L, E, h, f), h)
        layers["wd"] = norm01((L, E, f, h), f)
        layers["router"] = norm01((L, h, E), h)
    else:
        layers["wg"] = norm01((L, h, f), h)
        layers["wu"] = norm01((L, h, f), h)
        layers["wd"] = norm01((L, f, h), f)
    params: Params = {
        "embed": norm01((cfg.vocab_size, h), h),
        "final_norm": ones((h,)),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm01((h, cfg.vocab_size), h)
    return params


def _to_torch(a: Any, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (what JAX bf16 arrays convert to): via f32
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(dtype) if dtype is not None else t


def _is_qtensor(v: Any) -> bool:
    """A QTensor of either package (the JAX one is a NamedTuple with the
    same fields; the port does not import it)."""
    return isinstance(v, tuple) and getattr(v, "_fields", None) == ("q", "s")


def _leaf_from_jax(v: Any, dtype, device) -> Any:
    # np.asarray of a QTensor would stack q and s: convert the parts, and
    # keep the int8 codes and f32 scales whatever `dtype` says
    if _is_qtensor(v):
        return QTensor(q=_to_torch(v.q).to(device), s=_to_torch(v.s).to(device))
    return _to_torch(v, dtype).to(device)


def params_from_jax(np_params: Mapping[str, Any], dtype=None,
                    device=None) -> Params:
    """The port's parameters from `kafka_tpu.models.init_params`' pytree
    (dense or MoE, or int8 from `quantize_params`), converted to numpy
    arrays.  Layouts are identical (MoE: the router and the 4-D expert
    stacks, dense or QTensor); `dtype` (default: keep each array's own)
    casts every dense tensor."""
    layers = {k: _leaf_from_jax(v, dtype, device)
              for k, v in np_params["layers"].items()}
    out: Params = {
        k: _leaf_from_jax(v, dtype, device)
        for k, v in np_params.items() if k != "layers"
    }
    out["layers"] = layers
    return out


def _leaf_to(v: Any, device, dtype) -> Any:
    if isinstance(v, QTensor):  # int8 codes and f32 scales keep their types
        return QTensor(q=v.q.to(device=device), s=v.s.to(device=device))
    return v.to(device=device, dtype=dtype)


def params_to(params: Params, device=None, dtype=None) -> Params:
    """Move (and optionally cast the dense tensors of) a parameter tree."""
    out = {k: _leaf_to(v, device, dtype)
           for k, v in params.items() if k != "layers"}
    out["layers"] = {k: _leaf_to(v, device, dtype)
                     for k, v in params["layers"].items()}
    return out


def _matmul_f32(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [N, H] @ w [H, V] with float32 output.  CUDA low-precision inputs
    accumulate straight into f32 (the JAX preferred_element_type recipe)
    instead of rounding the logits to bf16.  An int8 table (QTensor, one
    scale per output column) is multiplied as its codes in x's dtype and
    scaled on the f32 output (JAX models/llama.py:533-553)."""
    if isinstance(w, QTensor):
        return _matmul_f32(x, w.q.to(x.dtype)) * w.s.reshape(1, -1)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x, w, out_dtype=torch.float32)
    return (x @ w).float()


def _attention_block(
    x: torch.Tensor,
    layers: Params,
    l: int,
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    k_cache: Optional[torch.Tensor],
    v_cache: Optional[torch.Tensor],
    kv_valid: Optional[torch.Tensor],
    cache_positions: Optional[torch.Tensor],
    paged: Optional[PagedView],
    tp: Any = None,
) -> torch.Tensor:
    """One attention sublayer. x: [B, S, H] -> [B, S, H].  Writes the new
    k/v rows into this layer's cache (in place).  On a rank of a
    tensor-parallel group (`tp`, parallel/tp.py) the weights and the cache
    hold the rank's heads: attention runs over them alone, and the
    row-parallel `wo` product is summed over the ranks."""
    b, s, h = x.shape
    dt = x.dtype
    d = cfg.head_dim
    hq, hkv = ((cfg.num_heads, cfg.num_kv_heads) if tp is None
               else (tp.q_heads, tp.kv_heads))
    q = (x @ _w(layers, "wq", l, dt).reshape(h, hq * d)).view(b, s, hq, d)
    k = (x @ _w(layers, "wk", l, dt).reshape(h, hkv * d)).view(b, s, hkv, d)
    v = (x @ _w(layers, "wv", l, dt).reshape(h, hkv * d)).view(b, s, hkv, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if paged is not None:
        # paged pool: k_cache/v_cache are this layer's [SLOTS, Hkv*D]
        # (dense tensors, or QTensor int8 rows + [SLOTS, 1] scales)
        _kv_write(k_cache, paged.write_idx, k.reshape(b, s, hkv * d), tp)
        _kv_write(v_cache, paged.write_idx, v.reshape(b, s, hkv * d), tp)
        kernel = cfg.attention_backend == "kernel"
        int8 = isinstance(k_cache, QTensor)
        if kernel and tp is not None and s == 1 \
                and paged.seq_lens is not None:
            # the rank's K1 (K4 over an int8 pool) on its local heads
            if int8:
                out = paged_decode_attention_int8_sharded(
                    tp.mesh, q[:, 0], k_cache.q, k_cache.s, v_cache.q,
                    v_cache.s, paged.page_table, paged.seq_lens,
                    page_size=paged.page_size)[:, None]
            else:
                out = paged_decode_attention_sharded(
                    tp.mesh, q[:, 0], k_cache, v_cache, paged.page_table,
                    paged.seq_lens, page_size=paged.page_size)[:, None]
        elif kernel and tp is not None and s > 1 \
                and paged.seq_lens is not None and not int8:
            out = paged_verify_attention_sharded(
                tp.mesh, q.contiguous(), k_cache, v_cache, paged.page_table,
                paged.seq_lens, paged.q_lens, page_size=paged.page_size)
        elif kernel and s == 1 and paged.seq_lens is not None and int8:
            # int8 pool: K4 reads the int8 rows (half K1's bytes) and folds
            # the per-slot scales into scores and probabilities
            out = paged_decode_attention_int8(
                q[:, 0], k_cache.q, k_cache.s, v_cache.q, v_cache.s,
                paged.page_table, paged.seq_lens, page_size=paged.page_size,
            )[:, None]
        elif kernel and s == 1 and paged.seq_lens is not None:
            out = paged_decode_attention(
                q[:, 0], k_cache, v_cache, paged.page_table, paged.seq_lens,
                page_size=paged.page_size,
            )[:, None]
        elif kernel and s > 1 and paged.seq_lens is not None and not int8:
            out = paged_verify_attention(
                q.contiguous(), k_cache, v_cache, paged.page_table,
                paged.seq_lens, paged.q_lens, page_size=paged.page_size,
            )
        elif kernel and s > 1 and b == 1 and paged.start is not None \
                and not int8 and tp is None:
            # flash prefill (K2) is single-device only, as in the
            # reference (JAX models/llama.py:305-311): at tp > 1 prefill
            # chunks take the page gather below
            out = paged_prefill_attention(
                q[0], k_cache, v_cache, paged.page_table[0],
                paged.start, paged.chunk_len, page_size=paged.page_size,
            )[None]
        else:
            # the page gather + plain attention: every chunk and verify
            # step over an int8 pool comes here, on the card too — the JAX
            # package's own formulation (its flash prefill and verify
            # kernels take dense pools only, JAX models/llama.py:275-311)
            if paged.page_table is not None:
                k_win = _kv_read_pages(k_cache, paged.page_table,
                                       paged.page_size, dt)
                v_win = _kv_read_pages(v_cache, paged.page_table,
                                       paged.page_size, dt)
            else:
                k_win = _kv_read(k_cache, paged.read_idx, dt)
                v_win = _kv_read(v_cache, paged.read_idx, dt)
            k_win, v_win = k_win.view(b, -1, hkv, d), v_win.view(b, -1, hkv, d)
            if tp is not None and tp.kv_map is not None:
                # a rank whose q heads do not map to its kv heads
                # contiguously: one gathered kv head per q head
                k_win = k_win.index_select(2, tp.kv_map)
                v_win = v_win.index_select(2, tp.kv_map)
            out = causal_attention(
                q, k_win, v_win,
                q_positions=positions, kv_positions=paged.kv_positions,
                kv_valid=paged.kv_valid,
            )
    elif k_cache is None:
        out = causal_attention(q, k, v, q_positions=positions,
                               kv_positions=positions)
    else:
        # contiguous cache: slot == absolute position unless the caller
        # passes explicit slots (chunked prefill / decode)
        slots = positions if cache_positions is None else cache_positions
        b_idx = torch.arange(b, device=x.device)[:, None]
        k_cache[b_idx, slots] = k.to(k_cache.dtype)
        v_cache[b_idx, slots] = v.to(v_cache.dtype)
        cap = k_cache.shape[1]
        kv_pos = torch.arange(cap, device=x.device).expand(b, cap)
        out = causal_attention(q, k_cache, v_cache, q_positions=positions,
                               kv_positions=kv_pos, kv_valid=kv_valid)
    out = out.reshape(b, s, hq * d) @ _w(layers, "wo", l, dt).reshape(
        hq * d, h)
    return out if tp is None else tp.all_reduce(out)


def _mlp_block(x: torch.Tensor, layers: Params, l: int,
               tp: Any = None) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x)); on a rank of a
    tensor-parallel group over its F columns, the row-parallel down
    product summed over the ranks."""
    dt = x.dtype
    g = x @ _w(layers, "wg", l, dt)
    u = x @ _w(layers, "wu", l, dt)
    out = (torch.nn.functional.silu(g) * u) @ _w(layers, "wd", l, dt)
    return out if tp is None else tp.all_reduce(out)


def _routing_weights(t: torch.Tensor, router: torch.Tensor,
                     top_k: int) -> torch.Tensor:
    """Per-token expert weights [T, E] f32: a softmax over EXACTLY the
    top-k router logits, scattered back, the rest zero (HF
    MixtralSparseMoeBlock; JAX models/llama.py:413-426).  The logits are
    f32 from activation-dtype inputs (_matmul_f32).  lax.top_k puts the
    lower expert first among equal logits, which torch.topk does not
    promise: a stable descending sort over the E columns does.
    parallel/expert.py reuses this function, so the two cannot drift."""
    logits = _matmul_f32(t, router)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w_top = torch.softmax(vals[:, :top_k], dim=-1)
    return torch.zeros_like(logits).scatter_(1, idx[:, :top_k], w_top)


def _experts(t: torch.Tensor, weight: Callable[[str], torch.Tensor],
             w: torch.Tensor) -> torch.Tensor:
    """The dense-dispatch expert MLP: every expert of the stack computes
    every token, t [T, H] against weight("wg") / weight("wu") [E, H, F]
    and weight("wd") [E, F, H], and the outputs combine by the routing
    weights w [T, E] cast to the activation dtype: g/u `th,ehf->tef`, y
    `tef,efh->teh`, out `te,teh->th` (JAX models/llama.py:429-449), with
    the expert axis leading.  Each stack is fetched just before its
    product, so an int8 model holds one dequantized stack at a time."""
    g = torch.matmul(t, weight("wg"))                        # [E, T, F]
    u = torch.matmul(t, weight("wu"))
    y = torch.matmul(torch.nn.functional.silu(g) * u,
                     weight("wd"))                           # [E, T, H]
    return torch.bmm(w.to(t.dtype).unsqueeze(1),             # [T, 1, E]
                     y.transpose(0, 1)).squeeze(1)           # [T, H]


def _moe_block(x: torch.Tensor, layers: Params, l: int, cfg: ModelConfig,
               tp: Any = None) -> torch.Tensor:
    """Mixtral-style top-k routed MoE MLP, x [B, S, H] -> [B, S, H], by
    dense dispatch, as the reference serves it.  An int8 expert stack is
    dequantized whole, one at a time (_w).  On a rank group the router
    is replicated, so every rank routes alike; the rank holds experts
    [e*E/ep, (e+1)*E/ep) of its ep slice e over its F columns, takes its
    columns of the [T, E] weights, and one all-reduce over the whole
    group sums the partial outputs of every rank's experts and columns
    (parallel/tp.py)."""
    b, s, h = x.shape
    dt = x.dtype
    t = x.reshape(b * s, h)
    w = _routing_weights(t, layers["router"][l], cfg.num_experts_per_tok)
    if tp is not None:
        w = w[:, tp.experts]
    out = _experts(t, lambda name: _w(layers, name, l, dt), w)
    if tp is not None:
        out = tp.all_reduce_experts(out)
    return out.view(b, s, h)


def forward(
    params: Params,
    cfg: ModelConfig,
    token_ids: torch.Tensor,
    positions: torch.Tensor,
    kv_cache: Optional[KVCache] = None,
    kv_valid: Optional[torch.Tensor] = None,
    cache_positions: Optional[torch.Tensor] = None,
    paged: Optional[PagedView] = None,
    logits_at: Optional[torch.Tensor] = None,
    tp: Any = None,
    embed_override: Optional[torch.Tensor] = None,
    override_on: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder.

    token_ids, positions: [B, S] integer tensors.
    kv_cache: optional KVCache.  Contiguous form: k/v [L, B, C, Hkv, D],
        new k/v written at `cache_positions` (default `positions`),
        attention over the whole cache gated by `kv_valid` [B, C].  Paged
        form (`paged` given): k/v [L, TOTAL_SLOTS, Hkv*D], reads/writes
        follow the PagedView index plan.
    logits_at: optional [B] row index — return logits only for that
        position of each sequence ([B, 1, V]); the engine samples from one
        row per chunk and skips the rest of the LM head.
    embed_override [B, S, H] + override_on [B, S] bool: positions whose
        input embedding is replaced (image patches entering as soft-prompt
        tokens, models/vision.py), in the activation dtype.
    Returns (logits float32 [B, S, V] (or [B, 1, V]), the cache or None).
    """
    layers = params["layers"]
    embed = params["embed"]
    act = cfg.activation_dtype
    if isinstance(embed, QTensor):
        # per-row dequant of the looked-up rows only, the product in the
        # activation dtype (JAX models/llama.py:480-487)
        x = embed.q[token_ids].to(act) * embed.s[token_ids].to(act)
    else:
        x = embed[token_ids].to(act)
    if embed_override is not None:
        x = torch.where(override_on[..., None], embed_override.to(act), x)
    inv_freq = rope_frequencies(cfg, device=x.device)
    cos, sin = rope_cos_sin(positions, inv_freq)
    for l in range(cfg.num_layers):
        kc = vc = None
        if kv_cache is not None:
            kc, vc = _layer(kv_cache.k, l), _layer(kv_cache.v, l)
        attn_in = rms_norm(x, layers["ln_attn"][l], cfg.rms_norm_eps)
        x = x + _attention_block(attn_in, layers, l, cfg, cos, sin,
                                 positions, kc, vc, kv_valid,
                                 cache_positions, paged, tp)
        mlp_in = rms_norm(x, layers["ln_mlp"][l], cfg.rms_norm_eps)
        x = x + (_moe_block(mlp_in, layers, l, cfg, tp) if cfg.is_moe
                 else _mlp_block(mlp_in, layers, l, tp))
    if logits_at is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    b, s, h = x.shape
    if not cfg.tie_word_embeddings:
        head = params["lm_head"]  # [H, V]
    elif isinstance(embed, QTensor):  # [V, H] codes, [V, 1] scales
        head = QTensor(q=embed.q.t(), s=embed.s)
    else:
        head = embed.t()
    logits = _matmul_f32(x.reshape(b * s, h), head)
    if tp is not None and not cfg.tie_word_embeddings:
        # the vocab-sharded head: gather every rank's logits columns
        logits = tp.gather_vocab(logits)
    return logits.view(b, s, -1), kv_cache
