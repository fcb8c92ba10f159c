"""kafka_tpu_torch — the PyTorch/CUDA port of kafka_tpu for NVIDIA Hopper.

A second package beside `kafka_tpu` (the JAX reference, unchanged).  It
imports torch and never jax, and nothing of kafka_tpu: the pure-Python
modules it needs are copied in.  Its module tree mirrors kafka_tpu's
(models/, ops/, ops/kernels/ + csrc/, runtime/, llm/, server/, core/, db/,
kafka/, agents/, tools/, server_tools/, sandbox/, prompts/,
llm/compaction/, and tracing.py, failpoints.py, logs.py).  Entry points run on CUDA unless the caller passes device="cpu".
"""
