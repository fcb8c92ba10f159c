"""Paged KV cache: device-side page pool + host-side allocator.

Counterpart of kafka_tpu/runtime/kv_cache.py.  The pool is two tensors
[L, num_pages * page_size, Hkv*D] (heads merged into the minor axis, the
JAX package's layout, so pools compare byte for byte); sequences own
ordered lists of physical pages.  The host-side allocator (copied) is
refcounted.  Physical page 0 is the trash page — inactive batch lanes
point their writes at it.  An int8 pool (`quantize="int8"`) holds each
pool as a QTensor: int8 slot rows [L, SLOTS, Hkv*D] and one f32 scale per
(layer, slot) [L, SLOTS, 1], the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.quant import QTensor

TRASH_PAGE = 0


class OutOfPagesError(RuntimeError):
    """Raised when the pool cannot satisfy an allocation; the scheduler
    reacts by preempting or queueing (never a user-facing crash)."""


@dataclasses.dataclass
class SequencePages:
    """Host-side record of the pages backing one sequence."""

    seq_id: str
    pages: List[int] = dataclasses.field(default_factory=list)
    length: int = 0  # tokens currently materialized in the cache

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size


class PagePool:
    """Refcounted allocator over the physical page axis (host only)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcount = np.zeros(num_pages, dtype=np.int32)
        self.refcount[TRASH_PAGE] = 1  # never allocated
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # stack

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise OutOfPagesError(f"need {n} pages, have {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refcount[p] = 1
        return out

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise RuntimeError(f"retain of unowned page {p}")
            self.refcount[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)

    # -- sequence-level helpers ------------------------------------------

    def ensure_capacity(self, seq: SequencePages, new_length: int) -> List[int]:
        """Grow seq's page list to cover new_length tokens; returns pages added."""
        needed = -(-new_length // self.page_size)  # ceil
        added: List[int] = []
        if needed > len(seq.pages):
            added = self.alloc(needed - len(seq.pages))
            seq.pages.extend(added)
        return added

    def free_sequence(self, seq: SequencePages) -> None:
        self.release(seq.pages)
        seq.pages.clear()
        seq.length = 0

    # -- leak detection (engine self-check) ------------------------------

    def check_consistency(self) -> List[str]:
        """Allocator invariants: every non-trash page is exactly one of
        {free-listed with refcount 0, owned with refcount > 0}."""
        problems: List[str] = []
        seen: set = set()
        for p in self._free:
            if p in seen:
                problems.append(f"page {p} duplicated in free list")
            seen.add(p)
            if p == TRASH_PAGE:
                problems.append("trash page in free list")
            elif self.refcount[p] != 0:
                problems.append(
                    f"page {p} free-listed with refcount {self.refcount[p]}")
        for p in range(self.num_pages):
            if p == TRASH_PAGE:
                continue
            rc = int(self.refcount[p])
            if rc < 0:
                problems.append(f"page {p} has negative refcount {rc}")
            elif rc == 0 and p not in seen:
                problems.append(
                    f"page {p} leaked: refcount 0 but not in free list")
        return problems

    def reconcile(self, expected: Dict[int, int],
                  repair: bool = False) -> List[str]:
        """Compare refcounts against the owners the caller enumerated
        (page -> live references); with `repair`, leaks are released and
        double frees re-pinned."""
        reports: List[str] = []
        for p in range(self.num_pages):
            if p == TRASH_PAGE:
                continue
            rc = int(self.refcount[p])
            want = expected.get(p, 0)
            if rc == want:
                continue
            kind = "leaked" if rc > want else "double-freed"
            reports.append(
                f"page {p} {kind}: refcount {rc}, {want} live owners"
                + (" (repaired)" if repair else ""))
            if not repair:
                continue
            if rc > want:
                self.refcount[p] = want
                if want == 0 and p not in self._free:
                    self._free.append(p)
            else:
                if rc == 0 and p in self._free:
                    self._free.remove(p)
                self.refcount[p] = want
        return reports


def make_kv_pool_arrays(
    cfg: ModelConfig, num_pages: int, page_size: int, dtype=None,
    device=None, quantize: str = "",
) -> Tuple[Any, Any]:
    """Allocate the K and V pools, [L, TOTAL_SLOTS, Hkv*D], zeroed.  Each
    layer's slice pool[l] is a contiguous [TOTAL_SLOTS, Hkv*D] tensor —
    what the paged kernels take.

    quantize="int8" returns each pool as a QTensor: int8 rows plus a
    per-(layer, slot) f32 scale [L, SLOTS, 1] — half the window bytes of
    a bf16 pool.  Rows are quantized at the write and dequantized at the
    gather or inside the int8 decode kernel (models/llama.py)."""
    shape = (cfg.num_layers, num_pages * page_size,
             cfg.num_kv_heads * cfg.head_dim)
    if quantize == "int8":
        def pool() -> QTensor:
            return QTensor(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                s=torch.zeros(shape[:2] + (1,), dtype=torch.float32,
                              device=device))

        return pool(), pool()
    if quantize:
        raise ValueError(f"unknown kv quantize mode {quantize!r}")
    dtype = dtype or cfg.activation_dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def page_table_array(seqs: Sequence[Optional[SequencePages]],
                     max_pages: int) -> np.ndarray:
    """Stack per-slot page lists into a dense [B, max_pages] int32 table.
    Empty slots (None) and unallocated tail entries point at TRASH_PAGE."""
    table = np.full((len(seqs), max_pages), TRASH_PAGE, dtype=np.int32)
    for i, s in enumerate(seqs):
        if s is None:
            continue
        if len(s.pages) > max_pages:
            raise ValueError(
                f"sequence {s.seq_id} has {len(s.pages)} pages > table "
                f"width {max_pages}")
        table[i, : len(s.pages)] = s.pages
    return table
