"""Agent tier: the tool-calling loop over LLM + tool providers."""

from .base import IDLE_TOOL, IDLE_TOOL_NAME, MAX_ITERATIONS_DEFAULT, Agent

__all__ = ["Agent", "IDLE_TOOL", "IDLE_TOOL_NAME", "MAX_ITERATIONS_DEFAULT"]
