"""K1, K3 and K4 on one rank of a tensor-parallel group.

Replace kafka_tpu/ops/pallas/paged_attention.py's mesh wrappers:
`pallas_mesh_ok` (:493), `paged_decode_attention_sharded` (:521),
`paged_verify_attention_sharded` (:461) and
`paged_decode_attention_int8_sharded` (:777).  In JAX one controller runs
each Pallas kernel per device through shard_map; in the port each rank is
its own process, so a "sharded" kernel is the rank's own launch of K1, K3
or K4 over its local q heads ("tp","tq") and its local pool (the "tp"
block of the merged kv axis), with no collective: heads are independent
in attention, and the row-parallel `wo` after it pays the all-reduce
(parallel/tp.py).

No kernel body changes for this.  The kernels index a contiguous
[SLOTS, Hkv_local*D] pool (csrc/paged_decode.cu, paged_chunks.cuh) and map
q head h to kv head h // (Hq / Hkv); a rank's pool is allocated
contiguous at its local width, and `kernel_mesh_ok` admits only head
splits whose local q->kv map is exactly that: any split with tq == 1, and
a grouped one (tq > 1) only with one kv head per rank.  The int8 pool's
[SLOTS, 1] scales are whole-row scales, the same on every rank.

Each wrapper checks the local geometry, counts its launches on CUDA
tensors in `<wrapper>.launches` (beside the K1/K3/K4 wrapper's own count)
and runs the plain version for CPU tensors, as every kernel wrapper does.
"""

from __future__ import annotations

import torch

from .paged_decode import paged_decode_attention
from .paged_decode_int8 import paged_decode_attention_int8
from .paged_verify import paged_verify_attention


def kernel_mesh_ok(mesh, num_heads: int, num_kv_heads: int) -> bool:
    """Can K1/K3/K4 run per rank under this head split?  (The reference's
    pallas_mesh_ok: only the tensor axes may exceed 1, tp divides the kv
    heads, tp*tq the q heads, and a grouped split holds one kv head per
    rank.)  `mesh` is a RankMesh, a MeshConfig or None (one device)."""
    if mesh is None:
        return True
    for ax in ("dp", "pp", "sp", "ep"):
        if getattr(mesh, ax, 1) > 1:
            return False
    tp, tq = mesh.tp, mesh.tq
    if tp * tq == 1:
        return True
    if tp <= 1:
        return False
    if num_kv_heads % tp or num_heads % (tp * tq):
        return False
    if (num_heads // num_kv_heads) % tq:
        return False
    return tq == 1 or num_kv_heads // tp == 1


def _check_local(name: str, mesh, q_heads: int, pool_width: int,
                 head_dim: int) -> None:
    kv_heads = pool_width // head_dim
    if kv_heads < 1 or q_heads % kv_heads or (
            mesh.tq > 1 and kv_heads != 1):
        raise ValueError(
            f"{name}: rank {mesh.rank} of tp={mesh.tp} tq={mesh.tq} holds "
            f"{q_heads} q heads over {kv_heads} kv heads; the per-rank "
            "kernel needs whole kv groups (one kv head per rank when tq > 1)")


def paged_decode_attention_sharded(
    mesh, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    page_table: torch.Tensor, seq_lens: torch.Tensor, *, page_size: int,
) -> torch.Tensor:
    """K1 on this rank: q [B, Hq_local, D] over the rank's pool
    [SLOTS, Hkv_local*D]; returns this rank's [B, Hq_local, D]."""
    _check_local("paged_decode_attention_sharded", mesh, q.shape[1],
                 k_pool.shape[-1], q.shape[-1])
    out = paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens,
                                 page_size=page_size)
    if q.device.type != "cpu":
        paged_decode_attention_sharded.launches += 1
    return out


def paged_verify_attention_sharded(
    mesh, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    page_table: torch.Tensor, seq_lens: torch.Tensor, q_lens: torch.Tensor,
    *, page_size: int,
) -> torch.Tensor:
    """K3 on this rank: q [B, S, Hq_local, D] (S = speculative_k + 1)."""
    _check_local("paged_verify_attention_sharded", mesh, q.shape[2],
                 k_pool.shape[-1], q.shape[-1])
    out = paged_verify_attention(q, k_pool, v_pool, page_table, seq_lens,
                                 q_lens, page_size=page_size)
    if q.device.type != "cpu":
        paged_verify_attention_sharded.launches += 1
    return out


def paged_decode_attention_int8_sharded(
    mesh, q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
    v_q: torch.Tensor, v_s: torch.Tensor, page_table: torch.Tensor,
    seq_lens: torch.Tensor, *, page_size: int,
) -> torch.Tensor:
    """K4 on this rank: int8 rows [SLOTS, Hkv_local*D], the [SLOTS, 1]
    whole-row scales."""
    _check_local("paged_decode_attention_int8_sharded", mesh, q.shape[1],
                 k_q.shape[-1], q.shape[-1])
    out = paged_decode_attention_int8(q, k_q, k_s, v_q, v_s, page_table,
                                      seq_lens, page_size=page_size)
    if q.device.type != "cpu":
        paged_decode_attention_int8_sharded.launches += 1
    return out


paged_decode_attention_sharded.launches = 0
paged_verify_attention_sharded.launches = 0
paged_decode_attention_int8_sharded.launches = 0
