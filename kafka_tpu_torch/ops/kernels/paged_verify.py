"""K3: paged verify attention — CUDA kernel wrapper and its plain version.

Replaces the Pallas kernel `paged_verify_attention`
(kafka_tpu/ops/pallas/paged_attention.py:384), the attention of the
speculative verify step: S = K+1 query tokens per sequence, each causally
masked to its own position, for any S (no cap on speculative_k).  The
kernel is csrc/paged_verify.cu (design and bound in its header:
bytes-bound, the valid windows' K+V; K1's chunked split, rows on the
tensor cores).
`paged_verify_attention` launches it for CUDA tensors and runs
`paged_verify_attention_plain` — the same function in plain PyTorch — for
CPU tensors only; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import causal_attention
from . import build
from .common import check_pool_args, chunk_plan, chunk_scratch, stream_ptr

# tokens per chunk of work (csrc/paged_verify.cu): whole pages, ~128 tokens
# (K1's chunk)
CHUNK_TOKENS = 128


def paged_verify_attention_plain(
    q: torch.Tensor,           # [B, S, Hq, D] roped queries
    k_pool: torch.Tensor,      # [TOTAL_SLOTS, Hkv*D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32 physical page ids
    seq_lens: torch.Tensor,    # [B] int32 tokens cached before the step
    q_lens: torch.Tensor,      # [B] int32 valid queries (cand_len + 1)
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Query j of sequence b (position seq_len + j) attends its slots
    <= seq_len + j among the seq_len + q_len valid ones.  Returns
    [B, S, Hq, D] in q.dtype; rows j >= q_len are garbage."""
    B, S, Hq, D = q.shape
    HD = k_pool.shape[1]
    Hkv = HD // D
    C = page_table.shape[1] * page_size
    pt = page_table.long()
    k_win = k_pool.view(-1, page_size, HD)[pt].reshape(B, C, Hkv, D)
    v_win = v_pool.view(-1, page_size, HD)[pt].reshape(B, C, Hkv, D)
    kv_pos = torch.arange(C, device=q.device).expand(B, C)
    lens = seq_lens.long()
    return causal_attention(
        q, k_win, v_win,
        q_positions=lens[:, None] + torch.arange(S, device=q.device)[None],
        kv_positions=kv_pos,
        kv_valid=kv_pos < (lens + q_lens.long())[:, None],
        scale=scale,
    )


def paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    q_lens: torch.Tensor,
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Verify-step attention straight off the paged KV pool.

    CPU tensors: the plain version.  CUDA tensors: the csrc kernel (bf16
    q and pool, int32 table and lengths, all contiguous) or an error.
    Rows j >= q_len come back as zeros from the kernel.
    """
    if q.device.type == "cpu":
        return paged_verify_attention_plain(
            q, k_pool, v_pool, page_table, seq_lens, q_lens,
            page_size=page_size, scale=scale,
        )
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"paged_verify_attention: want a contiguous q "
                         f"[B, S, Hq, D], got {tuple(q.shape)}")
    B, S = q.shape[:2]
    _, Hq, D = check_pool_args(
        "paged_verify_attention", q.view(B * S, *q.shape[2:]), k_pool,
        v_pool, page_table, seq_lens, q_lens)
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [B={B}, P], got "
                         f"{tuple(page_table.shape)}")
    if seq_lens.shape != (B,) or q_lens.shape != (B,):
        raise ValueError(f"seq_lens and q_lens must be [{B}], got "
                         f"{tuple(seq_lens.shape)}, {tuple(q_lens.shape)}")
    Hkv = k_pool.shape[1] // D
    if Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128):
        raise ValueError(
            f"paged verify kernel takes D in (64, 128) and <= 8 q heads per "
            f"kv head; got Hq={Hq} Hkv={Hkv} D={D}")
    P = page_table.shape[1]
    plan = chunk_plan(P, page_size, CHUNK_TOKENS)
    out = torch.empty_like(q)
    part_acc, part_ml = chunk_scratch(plan, B, S * Hq, D, out)
    lib = build.load("paged_verify")
    rc = lib.kafka_paged_verify_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        B, S, Hq, Hkv, D, P, page_size, plan.chunk,
        float(D ** -0.5 if scale is None else scale), stream_ptr(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged verify kernel launch failed: CUDA error {rc}")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
