"""Hand-written CUDA kernels for Hopper — the port's native tier.

Each kernel replaces one Pallas TPU kernel of kafka_tpu/ops/pallas and
sits beside its plain PyTorch version in the same module:

  paged_decode_attention   csrc/paged_decode.cu   (K1, every decode step)
  paged_prefill_attention  csrc/flash_prefill.cu  (K2, single-sequence
                                                   prefill chunks)
  paged_verify_attention   csrc/paged_verify.cu   (K3, speculative verify
                                                   steps)
  paged_decode_attention_int8
                           csrc/paged_decode_int8.cu
                                                  (K4, every decode step
                                                   over an int8 KV pool)
  fused_mlp_block          csrc/fused_mlp.cu      (K5, the fused decode
                                                   MLP; not on the serving
                                                   path, as in the JAX
                                                   package)

On one rank of a tensor-parallel group (ops/kernels/sharded.py) K1, K3
and K4 run over the rank's local heads:

  paged_decode_attention_sharded, paged_verify_attention_sharded,
  paged_decode_attention_int8_sharded, and the head-split rule
  kernel_mesh_ok

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (raising on what the kernel does not take); each counts
its launches in `<wrapper>.launches`.  Sources compile at first use
(ops/kernels/build.py).
"""

from .flash_prefill import paged_prefill_attention, paged_prefill_attention_plain
from .fused_mlp import fused_mlp_args, fused_mlp_block, fused_mlp_block_plain
from .paged_decode import paged_decode_attention, paged_decode_attention_plain
from .paged_decode_int8 import (
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
)
from .paged_verify import paged_verify_attention, paged_verify_attention_plain
from .sharded import (
    kernel_mesh_ok,
    paged_decode_attention_int8_sharded,
    paged_decode_attention_sharded,
    paged_verify_attention_sharded,
)

KERNELS = (paged_decode_attention, paged_prefill_attention,
           paged_verify_attention, paged_decode_attention_int8,
           fused_mlp_block, paged_decode_attention_sharded,
           paged_verify_attention_sharded,
           paged_decode_attention_int8_sharded)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "fused_mlp_args",
    "fused_mlp_block",
    "fused_mlp_block_plain",
    "kernel_mesh_ok",
    "paged_decode_attention_int8_sharded",
    "paged_decode_attention_sharded",
    "paged_verify_attention_sharded",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "paged_verify_attention",
    "paged_verify_attention_plain",
    "reset_launch_counts",
]
