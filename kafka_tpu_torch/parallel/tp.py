"""The collectives of a tensor-parallel forward pass, for one rank.

GSPMD inserts the JAX package's psums; the port calls its own, and only
these (kafka_tpu/models/llama.py under shard_params' specs):

  * an all-reduce (sum) after the row-parallel `wo` and `wd` products;
  * an all-gather of the `lm_head` vocab shards into full logits (a tied
    head reads the replicated embedding and needs none), made as a sum of
    zero-padded blocks (gather_vocab);
  * over an int8 KV pool, a max-reduce of each written row's abs-max, so
    the per-slot scale is the whole row's, as the reference's replicated
    scale is.

Attention needs no collective: each rank attends its own q heads over its
own kv heads (ops/kernels/sharded.py).  Sums run in the activations'
dtype, as the reference's psum does.  On CUDA these are NCCL calls on the
current stream, so a decode step's collectives are captured into its
CUDA graph with the rest of the step.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from .mesh import RankMesh
from .sharding import local_heads, local_kv_map


class TensorParallel:
    """One rank's collectives and head geometry (forward(..., tp=...))."""

    def __init__(self, cfg: ModelConfig, mesh: RankMesh, group: Any):
        self.mesh = mesh
        self.size = mesh.size
        self.group = group
        self.vocab = cfg.vocab_size
        self.q_heads, self.kv_heads = local_heads(cfg, mesh)
        kv_map = local_kv_map(cfg, mesh)
        # the local kv head of each local q head where it is not the
        # contiguous GQA map (the plain attention gathers by it)
        self.kv_map: Optional[torch.Tensor] = (
            torch.tensor(kv_map, dtype=torch.long, device=mesh.device)
            if kv_map is not None else None)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks, in place; returns x."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[N, V_local] logits -> [N, V]: every rank's vocab block in rank
        order (blocks ceil(V / size) wide, a short last block padded and
        the padding trimmed).  The gather is an all-reduce of zero-padded
        blocks: each logit is summed with zeros only, so it arrives
        exactly, and the captured decode graph holds one kind of
        collective (NCCL's list all-gather copies out through a staging
        buffer of its own)."""
        n, width = logits.shape
        block = -(-self.vocab // self.size)
        full = logits.new_zeros((n, block * self.size))
        lo = self.mesh.rank * block
        full[:, lo:lo + width] = logits
        self.all_reduce(full)
        return full[:, :self.vocab]
