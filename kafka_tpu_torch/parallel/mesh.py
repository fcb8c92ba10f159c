"""Rank groups and axis conventions for tensor and expert parallelism.

Counterpart of kafka_tpu/parallel/mesh.py.  The axis vocabulary is the
JAX package's (dp, pp, sp, tp, tq, ep; see MeshConfig), and the (tp, tq)
split is decided by the same two functions, so the server and the
memory planner charge exactly what the engine places:

  tp  — tensor parallel: q heads / MLP hidden / vocab over ("tp","tq"),
        kv heads and the KV pool over "tp" alone;
  tq  — the kv-replica factor when the tensor degree exceeds the kv head
        count (factor_tp_for_kv): each kv head lives on tq ranks;
  ep  — expert parallel: a MoE model's experts over "ep", attention and
        the KV pool replicated over it.

JAX runs one controller over a device mesh and lets GSPMD insert the
collectives.  The port uses PyTorch's idiom instead: one process per rank,
rank r on `cuda:r`, NCCL collectives (gloo on the CPU) called by the
model code itself.  A `RankMesh` is one rank's view of that group: its
index on each axis and its device.  Only tp, tq and ep may exceed 1
here; dp x tp, sp and pp wait for later slices (ROADMAP A9).

Ranks are numbered in AXIS_ORDER with ep innermost, as the JAX mesh lays
its devices out: rank r = (tp_index * tq + tq_index) * ep + ep_index.
The ranks of one ep slice (equal ep_index) form a tensor group of tp*tq,
in which rank r is tensor rank r // ep.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from ..device import DeviceLike

AXIS_ORDER = ("dp", "pp", "sp", "tp", "tq", "ep")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    tq: int = 1
    ep: int = 1

    @property
    def total_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.tq * self.ep

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp, self.tq, self.ep)


def factor_tp_for_kv(tensor_degree: int, num_kv_heads: int) -> Tuple[int, int]:
    """Factorize a requested tensor-parallel degree into (tp, tq): tp is
    the largest divisor of the degree that also divides num_kv_heads, tq
    carries the rest as kv replication groups (70B's 8 kv heads at degree
    16 -> (8, 2))."""
    if tensor_degree <= 1:
        return max(tensor_degree, 1), 1
    kv = math.gcd(tensor_degree, num_kv_heads)
    return kv, tensor_degree // kv


def resolve_tensor_axes(
    tensor_degree: int,
    num_kv_heads: int,
    *,
    cp_strategy: str = "ring",
    sp: int = 1,
    pp: int = 1,
) -> Tuple[int, int]:
    """The one place the (tp, tq) split is decided for a serving config:
    grouped factorization, except where a composition assumes the plain
    tensor axis (ulysses context parallelism, pipeline stages), which keeps
    tq = 1."""
    if (cp_strategy == "ulysses" and sp > 1) or pp > 1:
        return tensor_degree, 1
    return factor_tp_for_kv(tensor_degree, num_kv_heads)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank's place in a ("tp", "tq", "ep") rank group.  Ranks are
    numbered ep-fastest, then tq, as the JAX mesh orders its axes: rank r
    is tensor rank r // ep of ep slice r % ep; it holds q-head, MLP and
    vocab block r // ep of tp*tq, kv-head block (r // ep) // tq of tp,
    and expert block r % ep of ep."""

    tp: int
    tq: int
    rank: int
    device: torch.device
    ep: int = 1

    @property
    def size(self) -> int:
        """Ranks in the whole group."""
        return self.tp * self.tq * self.ep

    @property
    def tensor_size(self) -> int:
        """Ranks in this rank's tensor group (its ep slice)."""
        return self.tp * self.tq

    @property
    def tensor_rank(self) -> int:
        return self.rank // self.ep

    @property
    def tp_index(self) -> int:
        return self.tensor_rank // self.tq

    @property
    def tq_index(self) -> int:
        return self.tensor_rank % self.tq

    @property
    def ep_index(self) -> int:
        return self.rank % self.ep


def rank_devices(size: int, device: DeviceLike = None) -> List[torch.device]:
    """The device of every rank: `cuda:r` for rank r, or the CPU for every
    rank when the caller asks for it (device="cpu", the tests).  NCCL
    refuses two ranks on one card, so a CUDA group needs `size` cards."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * size
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' explicitly to run "
            "the rank group on the CPU")
    have = torch.cuda.device_count()
    if have < size:
        raise ValueError(
            f"a rank group of {size} needs {size} cards (one per rank: "
            f"NCCL refuses two ranks on one card), {have} visible")
    return [torch.device("cuda", r) for r in range(size)]


def make_mesh(cfg: MeshConfig, rank: int = 0,
              device: DeviceLike = None) -> RankMesh:
    """The rank-group counterpart of make_mesh: rank `rank`'s view of a
    group over the tp, tq and ep axes, placed on `cuda:rank` unless the
    caller asks for device="cpu".  dp, sp and pp raise, naming the
    ROADMAP item that ports them."""
    if cfg.dp > 1:
        raise ValueError(
            f"dp={cfg.dp} x tp={cfg.tp * cfg.tq} x ep={cfg.ep}: "
            "data-parallel replicas of a rank group are not ported "
            "(ROADMAP A9, dp x tp)")
    if cfg.sp > 1:
        raise ValueError(
            f"sp={cfg.sp}: sequence parallelism is not ported (ROADMAP A9, "
            "ring and ulysses prefill)")
    if cfg.pp > 1:
        raise ValueError(
            f"pp={cfg.pp}: pipeline stages are not ported (ROADMAP A9)")
    size = cfg.tp * cfg.tq * cfg.ep
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a group of {size}")
    return RankMesh(tp=cfg.tp, tq=cfg.tq, ep=cfg.ep, rank=rank,
                    device=rank_devices(size, device)[rank])
