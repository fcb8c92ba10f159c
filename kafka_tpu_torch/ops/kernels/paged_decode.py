"""K1: paged decode attention — CUDA kernel wrapper and its plain version.

Replaces the Pallas kernel `paged_decode_attention`
(kafka_tpu/ops/pallas/paged_attention.py:180).  The kernel is
csrc/paged_decode.cu (design and bound in its header: bytes-bound, the
valid window's K+V).  `paged_decode_attention` launches it for CUDA
tensors and runs `paged_decode_attention_plain` — the same function in
plain PyTorch — for CPU tensors only; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import causal_attention
from . import build
from .common import check_pool_args, chunk_plan, chunk_scratch, stream_ptr


def paged_decode_attention_plain(
    q: torch.Tensor,           # [B, Hq, D]
    k_pool: torch.Tensor,      # [TOTAL_SLOTS, Hkv*D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32 physical page ids
    seq_lens: torch.Tensor,    # [B] int32 tokens cached before the query
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Each query (position seq_len) attends its sequence's slots
    0..seq_len through the page table.  Returns [B, Hq, D] in q.dtype;
    trash-page lanes give garbage rows, as the kernel does."""
    B, Hq, D = q.shape
    HD = k_pool.shape[1]
    Hkv = HD // D
    P = page_table.shape[1]
    C = P * page_size
    pt = page_table.long()
    k_win = k_pool.view(-1, page_size, HD)[pt].reshape(B, C, Hkv, D)
    v_win = v_pool.view(-1, page_size, HD)[pt].reshape(B, C, Hkv, D)
    kv_pos = torch.arange(C, device=q.device).expand(B, C)
    lens = seq_lens.long()
    out = causal_attention(
        q[:, None], k_win, v_win,
        q_positions=lens[:, None],
        kv_positions=kv_pos,
        kv_valid=kv_pos <= lens[:, None],
        scale=scale,
    )
    return out[:, 0]


# tokens per chunk of work (csrc/paged_decode.cu): whole pages, ~128 tokens
CHUNK_TOKENS = 128


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode-step attention straight off the paged KV pool.

    CPU tensors: the plain version.  CUDA tensors: the csrc kernel (bf16
    q and pool, int32 table and lengths, all contiguous) or an error.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, page_table, seq_lens,
            page_size=page_size, scale=scale,
        )
    B, Hq, D = check_pool_args("paged_decode_attention", q, k_pool, v_pool,
                               page_table, seq_lens)
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [B={B}, P], got "
                         f"{tuple(page_table.shape)}")
    if seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be [{B}], got {tuple(seq_lens.shape)}")
    Hkv = k_pool.shape[1] // D
    if Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128):
        raise ValueError(
            f"paged decode kernel takes D in (64, 128) and <= 8 q heads per "
            f"kv head; got Hq={Hq} Hkv={Hkv} D={D}")
    P = page_table.shape[1]
    plan = chunk_plan(P, page_size, CHUNK_TOKENS)
    out = torch.empty_like(q)
    part_acc, part_ml = chunk_scratch(plan, B, Hq, D, out)
    lib = build.load("paged_decode")
    rc = lib.kafka_paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        B, Hq, Hkv, D, P, page_size, plan.chunk,
        float(D ** -0.5 if scale is None else scale), stream_ptr(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
