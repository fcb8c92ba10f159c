"""Tensor and expert parallelism over torch.distributed (counterpart of
kafka_tpu/parallel, its tp/tq/ep part): rank groups, sharding rules, the
forward pass's collectives, expert-sharded MoE, and fault containment
across ranks.  Sequence and pipeline parallelism, dp x tp and multi-host
initialization wait for later slices (ROADMAP A9)."""

from .distributed import DistributedStepError, barrier, guarded_collective
from .expert import (
    init_moe_params,
    moe_mlp_reference,
    moe_mlp_sharded,
    shard_moe_params,
)
from .mesh import (
    AXIS_ORDER,
    MeshConfig,
    RankMesh,
    factor_tp_for_kv,
    make_mesh,
    rank_devices,
    resolve_tensor_axes,
)
from .sharding import (
    init_params_shard,
    kv_pool_spec,
    local_experts,
    local_heads,
    local_kv_map,
    param_specs,
    shard_kv_pool,
    shard_params,
)
from .tp import TensorParallel
from .worker import EngineSpec, RandomWeights, RankGroup

__all__ = [
    "AXIS_ORDER",
    "DistributedStepError",
    "EngineSpec",
    "MeshConfig",
    "RandomWeights",
    "RankGroup",
    "RankMesh",
    "TensorParallel",
    "barrier",
    "factor_tp_for_kv",
    "guarded_collective",
    "init_moe_params",
    "init_params_shard",
    "kv_pool_spec",
    "local_experts",
    "local_heads",
    "local_kv_map",
    "make_mesh",
    "moe_mlp_reference",
    "moe_mlp_sharded",
    "param_specs",
    "rank_devices",
    "resolve_tensor_axes",
    "shard_kv_pool",
    "shard_moe_params",
    "shard_params",
]
