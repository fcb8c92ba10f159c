"""Argument checks and launch helpers shared by the kernel wrappers."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_pool_args(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, *index_tensors: torch.Tensor
                    ) -> Tuple[int, int, int]:
    """Validate what every paged-attention kernel takes: a CUDA bf16 q of
    shape [N, Hq, D], bf16 pools [SLOTS, Hkv*D] on the same device, int32
    index tensors, everything contiguous.  Returns q's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA or CPU tensor, "
                         f"got {q.device}")
    tensors = (q, k_pool, v_pool) + index_tensors
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in (q, k_pool, v_pool):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: q and pools must be bfloat16, "
                             f"got {t.dtype}")
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index tensors must be int32, "
                             f"got {t.dtype}")
    if q.dim() != 3 or k_pool.dim() != 2 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"{name}: want q [N, Hq, D] and equal pools [SLOTS, Hkv*D], got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    n, hq, d = q.shape
    if k_pool.shape[1] % d:
        raise ValueError(f"{name}: pool row {k_pool.shape[1]} is not a "
                         f"multiple of head_dim {d}")
    return n, hq, d


# csrc/paged_chunks.cuh: a chunk spans at most this many pages, and the
# merge keeps a row's (m, l) pairs of every chunk in 48 KB of shared memory
MAX_CHUNK_PAGES = 128
MAX_MERGE_CHUNKS = 48 * 1024 // 8


class ChunkPlan(NamedTuple):
    """How K1, K3 and K4 cut the lanes' windows (csrc/paged_chunks.cuh):
    `chunk` tokens of whole pages, at most `max_chunks` a lane (a lane's
    window of n slots takes max(1, ceil(n / chunk)) of them).  The chunk
    kernel's grid is B * max_chunks * Hkv blocks, a bound: the lengths
    live on the device."""

    chunk: int
    max_chunks: int

    def scratch_shapes(self, B: int, rows: int, D: int
                       ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The partials (acc, then m and l) for `rows` output rows a lane:
        Hq for decode, S * Hq for verify."""
        return ((B, self.max_chunks, rows, D), (B, self.max_chunks, rows, 2))


def chunk_plan(P: int, page_size: int, target: int) -> ChunkPlan:
    """The whole pages that make ~`target` tokens (one page where a page is
    longer, at most MAX_CHUNK_PAGES), and the chunks of a full window of P
    pages; raises for a window the merge cannot hold."""
    chunk = page_size * min(MAX_CHUNK_PAGES, max(1, target // page_size))
    plan = ChunkPlan(chunk, -(-P * page_size // chunk))
    if plan.max_chunks > MAX_MERGE_CHUNKS:
        raise ValueError(
            f"a window of {P} pages of {page_size} tokens needs "
            f"{plan.max_chunks} chunks of {chunk} tokens; the paged "
            f"attention kernels merge at most {MAX_MERGE_CHUNKS}")
    return plan


def chunk_scratch(plan: ChunkPlan, B: int, rows: int, D: int,
                  like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partials' f32 scratch, or `like` twice where no lane can have two
    chunks (the kernel then writes every row itself and never reads it)."""
    if plan.max_chunks <= 1:
        return like, like
    acc, ml = plan.scratch_shapes(B, rows, D)
    return (torch.empty(acc, dtype=torch.float32, device=like.device),
            torch.empty(ml, dtype=torch.float32, device=like.device))
