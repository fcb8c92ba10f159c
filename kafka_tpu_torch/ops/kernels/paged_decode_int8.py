"""K4: paged decode attention over an int8 KV pool — CUDA kernel wrapper
and its plain version.

Replaces the Pallas kernel `paged_decode_attention_int8`
(kafka_tpu/ops/pallas/paged_attention.py:690, body `_decode_kernel_int8`
at :558).  The pool holds int8 rows and one f32 scale per slot
(runtime/kv_cache.py, quantize="int8"); the kernel never dequantizes K/V
to a dense window: `score = (q . k_q) * scale * s_k[slot]` and the PV
product weighs each row by `p * s_v[slot]`, all in f32.  The kernel is
csrc/paged_decode_int8.cu (design and bound in its header: bytes-bound,
the valid window's int8 K+V and their scales — half of K1's bytes; K1's
chunked split over 128-token chunks).
`paged_decode_attention_int8` launches it for CUDA tensors and runs
`paged_decode_attention_int8_plain` — the same function in plain PyTorch
— for CPU tensors only; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import NEG_INF
from . import build
from .common import chunk_plan, chunk_scratch, stream_ptr


def paged_decode_attention_int8_plain(
    q: torch.Tensor,           # [B, Hq, D]
    k_q: torch.Tensor,         # [TOTAL_SLOTS, Hkv*D] int8
    k_s: torch.Tensor,         # [TOTAL_SLOTS, 1] f32 per-slot scales
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32 physical page ids
    seq_lens: torch.Tensor,    # [B] int32 tokens cached before the query
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Each query (position seq_len) attends its slots 0..seq_len through
    the page table, in the TPU kernel's f32 math: the int8 codes times the
    per-slot scales, never a bf16 window.  Returns [B, Hq, D] in q.dtype;
    trash-page lanes give garbage rows, as the kernel does."""
    B, Hq, D = q.shape
    HD = k_q.shape[1]
    Hkv = HD // D
    G = Hq // Hkv
    C = page_table.shape[1] * page_size
    if scale is None:
        scale = D ** -0.5
    pt = page_table.long()

    def window(codes, scales):
        rows = codes.view(-1, page_size, HD)[pt].reshape(B, C, Hkv, D)
        return rows.float(), scales.view(-1, page_size)[pt].reshape(B, C)

    kc, ks = window(k_q, k_s)
    vc, vs = window(v_q, v_s)
    valid = torch.arange(C, device=q.device)[None] <= seq_lens.long()[:, None]
    qg = q.float().view(B, Hkv, G, D)
    s = torch.einsum("bhgd,bchd->bhgc", qg, kc) * scale * ks[:, None, None]
    mask = valid[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    acc = torch.einsum("bhgc,bchd->bhgd", p * vs[:, None, None], vc)
    return (acc / denom).reshape(B, Hq, D).to(q.dtype)


# tokens per chunk of work (csrc/paged_decode_int8.cu): whole pages, ~128
# tokens, K1's chunk (256 lost to it on the H100: PERF.md)
CHUNK_TOKENS = 128


def _check(q, k_q, k_s, v_q, v_s, page_table, seq_lens):
    name = "paged_decode_attention_int8"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA or CPU tensor, "
                         f"got {q.device}")
    for t in (q, k_q, k_s, v_q, v_s, page_table, seq_lens):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    want = ((q, torch.bfloat16), (k_q, torch.int8), (v_q, torch.int8),
            (k_s, torch.float32), (v_s, torch.float32),
            (page_table, torch.int32), (seq_lens, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise ValueError(f"{name}: want q bf16, codes int8, scales "
                             f"float32, table and lengths int32; got a "
                             f"{t.dtype} where {dt} belongs")
    if q.dim() != 3 or k_q.dim() != 2 or k_q.shape != v_q.shape:
        raise ValueError(
            f"{name}: want q [B, Hq, D] and equal pools [SLOTS, Hkv*D], got "
            f"{tuple(q.shape)}, {tuple(k_q.shape)}, {tuple(v_q.shape)}")
    B, Hq, D = q.shape
    slots = k_q.shape[0]
    if k_s.shape != (slots, 1) or v_s.shape != (slots, 1):
        raise ValueError(f"{name}: scales must be [{slots}, 1], got "
                         f"{tuple(k_s.shape)}, {tuple(v_s.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table must be [B={B}, P], got "
                         f"{tuple(page_table.shape)}")
    if seq_lens.shape != (B,):
        raise ValueError(f"{name}: seq_lens must be [{B}], got "
                         f"{tuple(seq_lens.shape)}")
    if k_q.shape[1] % D:
        raise ValueError(f"{name}: pool row {k_q.shape[1]} is not a "
                         f"multiple of head_dim {D}")
    Hkv = k_q.shape[1] // D
    if Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128):
        raise ValueError(
            f"{name}: the kernel takes D in (64, 128) and <= 8 q heads per "
            f"kv head; got Hq={Hq} Hkv={Hkv} D={D}")
    return B, Hq, Hkv, D


def paged_decode_attention_int8(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_s: torch.Tensor,
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode-step attention straight off the int8 paged KV pool.

    CPU tensors: the plain version.  CUDA tensors: the csrc kernel (bf16
    q, int8 codes, f32 [SLOTS, 1] scales, int32 table and lengths, all
    contiguous) or an error.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_q, k_s, v_q, v_s, page_table, seq_lens,
            page_size=page_size, scale=scale,
        )
    B, Hq, Hkv, D = _check(q, k_q, k_s, v_q, v_s, page_table, seq_lens)
    P = page_table.shape[1]
    plan = chunk_plan(P, page_size, CHUNK_TOKENS)
    out = torch.empty_like(q)
    part_acc, part_ml = chunk_scratch(plan, B, Hq, D, out)
    lib = build.load("paged_decode_int8")
    rc = lib.kafka_paged_decode_int8(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        B, Hq, Hkv, D, P, page_size, plan.chunk,
        float(D ** -0.5 if scale is None else scale), stream_ptr(q.device),
    )
    if rc != 0:
        raise RuntimeError(
            f"int8 paged decode kernel launch failed: CUDA error {rc}")
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
