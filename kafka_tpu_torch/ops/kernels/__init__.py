"""Hand-written CUDA kernels for Hopper — the port's native tier.

Each kernel replaces one Pallas TPU kernel of kafka_tpu/ops/pallas and
sits beside its plain PyTorch version in the same module:

  paged_decode_attention   csrc/paged_decode.cu   (K1, every decode step)
  paged_prefill_attention  csrc/flash_prefill.cu  (K2, single-sequence
                                                   prefill chunks)
  paged_verify_attention   csrc/paged_verify.cu   (K3, speculative verify
                                                   steps)

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (raising on what the kernel does not take); each counts
its launches in `<wrapper>.launches`.  Sources compile at first use
(ops/kernels/build.py).
"""

from .flash_prefill import paged_prefill_attention, paged_prefill_attention_plain
from .paged_decode import paged_decode_attention, paged_decode_attention_plain
from .paged_verify import paged_verify_attention, paged_verify_attention_plain

KERNELS = (paged_decode_attention, paged_prefill_attention,
           paged_verify_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "paged_verify_attention",
    "paged_verify_attention_plain",
    "reset_launch_counts",
]
