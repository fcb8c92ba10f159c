"""Kafka tier, main-path slice: thread persistence + one model turn."""

from .base import run_thread_turn, run_turn, run_with_thread
from .utils import MessageAccumulator

__all__ = ["MessageAccumulator", "run_thread_turn", "run_turn",
           "run_with_thread"]
