"""K2: flash prefill attention — CUDA kernel wrapper and its plain version.

Replaces the Pallas kernel `paged_prefill_attention`
(kafka_tpu/ops/pallas/flash_prefill.py:164).  The kernel is
csrc/flash_prefill.cu, on the tensor cores (design and bound in its
header: operations-bound for long chunks).  `paged_prefill_attention`
launches it for CUDA tensors and runs `paged_prefill_attention_plain` —
the same function in plain PyTorch — for CPU tensors only; it never
falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import causal_attention
from . import build
from .common import check_pool_args, stream_ptr

# the kernel's block shapes: 4 warps of 2 or of 1 16-row tiles; both
# compute the same function
ROW_TILES = (2, 1)


def paged_prefill_attention_plain(
    q: torch.Tensor,         # [S, Hq, D] roped queries of this chunk
    k_pool: torch.Tensor,    # [TOTAL_SLOTS, Hkv*D]
    v_pool: torch.Tensor,
    page_row: torch.Tensor,  # [P] int32 pages of this sequence
    start: int,              # the chunk's first absolute position
    chunk_len: int,          # real tokens in the chunk
    *,
    page_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The chunk's queries attend the paged window causally, bounded by
    the written total start + chunk_len.  Returns [S, Hq, D] in q.dtype;
    rows past chunk_len are garbage."""
    S, Hq, D = q.shape
    HD = k_pool.shape[1]
    Hkv = HD // D
    C = page_row.shape[0] * page_size
    pr = page_row.long()
    k_win = k_pool.view(-1, page_size, HD)[pr].reshape(1, C, Hkv, D)
    v_win = v_pool.view(-1, page_size, HD)[pr].reshape(1, C, Hkv, D)
    kv_pos = torch.arange(C, device=q.device)[None]
    q_pos = start + torch.arange(S, device=q.device)[None]
    out = causal_attention(
        q[None], k_win, v_win,
        q_positions=q_pos, kv_positions=kv_pos,
        kv_valid=kv_pos < start + chunk_len,
        scale=scale,
    )
    return out[0]


def paged_prefill_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_row: torch.Tensor,
    start: int,
    chunk_len: int,
    *,
    page_size: int,
    scale: Optional[float] = None,
    row_tiles: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention of one prefill chunk against the paged window.

    CPU tensors: the plain version.  CUDA tensors: the csrc kernel (bf16
    q and pool, int32 page row, all contiguous) or an error.  Rows past
    chunk_len come back as zeros from the kernel.  `row_tiles` pins the
    kernel's block shape to one of ROW_TILES (to time them against each
    other); None lets the launcher pick from the grid size.
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pool, v_pool, page_row, start, chunk_len,
            page_size=page_size, scale=scale,
        )
    S, Hq, D = check_pool_args("paged_prefill_attention", q, k_pool, v_pool,
                               page_row)
    if page_row.dim() != 1:
        raise ValueError(f"page_row must be [P], got {tuple(page_row.shape)}")
    Hkv = k_pool.shape[1] // D
    if Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128):
        raise ValueError(f"flash prefill kernel takes D in (64, 128) and "
                         f"whole GQA groups of at most 8 heads; got Hq={Hq} "
                         f"Hkv={Hkv} D={D}")
    P = page_row.shape[0]
    if not 0 <= start or not 0 < chunk_len <= S \
            or start + chunk_len > P * page_size:
        raise ValueError(f"bad chunk bounds start={start} chunk_len="
                         f"{chunk_len} for S={S}, window {P * page_size}")
    if row_tiles is not None and row_tiles not in ROW_TILES:
        raise ValueError(f"row_tiles must be one of {ROW_TILES}, got "
                         f"{row_tiles}")
    out = torch.empty_like(q)
    lib = build.load("flash_prefill")
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_row.data_ptr(), out.data_ptr(),
            S, Hq, Hkv, D, P, page_size, int(start), int(chunk_len),
            float(D ** -0.5 if scale is None else scale),
            stream_ptr(q.device))
    rc = (lib.kafka_flash_prefill_bf16(*args) if row_tiles is None
          else lib.kafka_flash_prefill_bf16_tiles(*args, row_tiles))
    if rc != 0:
        raise RuntimeError(f"flash prefill kernel launch failed: CUDA error {rc}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
