"""Tool tier: definitions, provider ABC, and source-routed execution."""

from .base import ToolProvider
from .provider import AgentToolProvider
from .types import (
    MCPServerConfig,
    Tool,
    ToolEvent,
    ToolExecutionError,
    parse_tool_arguments,
)

__all__ = [
    "AgentToolProvider",
    "MCPServerConfig",
    "Tool",
    "ToolEvent",
    "ToolExecutionError",
    "ToolProvider",
    "parse_tool_arguments",
]
