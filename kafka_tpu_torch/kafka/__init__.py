"""Kafka orchestrator tier: wires LLM, tools, prompts, compaction, threads."""

from .base import KafkaAgent
from .utils import MessageAccumulator, playbooks_to_markdown
from .v1 import KafkaV1Provider

__all__ = [
    "KafkaAgent",
    "KafkaV1Provider",
    "MessageAccumulator",
    "playbooks_to_markdown",
]
