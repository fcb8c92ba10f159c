"""The collectives of a tensor- and expert-parallel forward pass, for one
rank.

GSPMD inserts the JAX package's psums; the port calls its own, and only
these (kafka_tpu/models/llama.py under shard_params' specs).  Over the
rank's tensor group — the tp*tq ranks of its ep slice (parallel/mesh.py):

  * an all-reduce (sum) after the row-parallel `wo` product, and after
    `wd` on a dense model;
  * an all-gather of the `lm_head` vocab shards into full logits (a tied
    head reads the replicated embedding and needs none), made as a sum of
    zero-padded blocks (gather_vocab);
  * over an int8 KV pool, a max-reduce of each written row's abs-max, so
    the per-slot scale is the whole row's, as the reference's replicated
    scale is.

Over the whole group, on a MoE model: one all-reduce (sum) of each MoE
block's combine, which adds the partial outputs of every rank's local
experts over its local F columns (all_reduce_experts; at ep 1 the whole
group is the tensor group).  At tp 1 x ep > 1 the tensor groups are
single ranks and attention runs no collective at all.

Attention needs no collective: each rank attends its own q heads over its
own kv heads (ops/kernels/sharded.py).  Sums run in the activations'
dtype, as the reference's psum does.  On CUDA these are NCCL calls on the
current stream, so a decode step's collectives are captured into its
CUDA graph with the rest of the step.  The tensor groups are made once,
when the ranks join (parallel/worker.py), so their NCCL communicators
exist before any capture.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from .mesh import RankMesh
from .sharding import local_experts, local_heads, local_kv_map


class TensorParallel:
    """One rank's collectives and geometry (forward(..., tp=...)): its
    heads, its experts, its tensor group and the whole group."""

    def __init__(self, cfg: ModelConfig, mesh: RankMesh, group: Any,
                 tensor_group: Any = None):
        self.mesh = mesh
        self.size = mesh.tensor_size
        self.group = group
        # the ranks of this rank's ep slice (the whole group at ep 1)
        self.tensor_group = group if mesh.ep == 1 else tensor_group
        if self.size > 1 and self.tensor_group is None:
            raise ValueError("a tensor group of several ranks needs its "
                             "process group")
        self.vocab = cfg.vocab_size
        self.q_heads, self.kv_heads = local_heads(cfg, mesh)
        # this rank's columns of a MoE layer's [T, E] routing weights
        self.experts = local_experts(cfg, mesh)
        kv_map = local_kv_map(cfg, mesh)
        # the local kv head of each local q head where it is not the
        # contiguous GQA map (the plain attention gathers by it)
        self.kv_map: Optional[torch.Tensor] = (
            torch.tensor(kv_map, dtype=torch.long, device=mesh.device)
            if kv_map is not None else None)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the tensor group, in place; returns x."""
        if self.size > 1:
            dist.all_reduce(x, group=self.tensor_group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX,
                            group=self.tensor_group)
        return x

    def all_reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a MoE block's partial combine over the whole group, in
        place; returns x."""
        dist.all_reduce(x, group=self.group)
        return x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[N, V_local] logits -> [N, V]: every tensor rank's vocab block
        in rank order (blocks ceil(V / size) wide, a short last block
        padded and the padding trimmed).  The gather is an all-reduce of
        zero-padded blocks: each logit is summed with zeros only, so it
        arrives exactly, and the captured decode graph holds one kind of
        collective (NCCL's list all-gather copies out through a staging
        buffer of its own)."""
        if self.size == 1:
            return logits
        n, width = logits.shape
        block = -(-self.vocab // self.size)
        full = logits.new_zeros((n, block * self.size))
        lo = self.mesh.tensor_rank * block
        full[:, lo:lo + width] = logits
        self.all_reduce(full)
        return full[:, :self.vocab]
