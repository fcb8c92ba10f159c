"""Built-in tools (reference server_tools/): planner, counter, weather;
shell/notebook join once a sandbox is configured (sandbox tier)."""

from typing import List, Optional

from ..tools.types import Tool
from .counter import counter_tool
from .planner import PlannerTools, SequentialThinkingServer
from .weather import weather_tool


def builtin_tools(sandbox_url: Optional[str] = None) -> List[Tool]:
    tools: List[Tool] = [
        weather_tool(),
        counter_tool(),
        *PlannerTools().tools(),
    ]
    if sandbox_url:
        # sandbox tools are additive: their failure must not take down the
        # base tool set (mirrors MCP connect-failure handling)
        try:
            from ..sandbox.tools import sandbox_builtin_tools

            tools.extend(sandbox_builtin_tools(sandbox_url))
        except Exception as e:
            import logging

            logging.getLogger("kafka_tpu_torch.server_tools").warning(
                "sandbox tools unavailable (%s); continuing without them", e
            )
    return tools


__all__ = [
    "PlannerTools",
    "SequentialThinkingServer",
    "builtin_tools",
    "counter_tool",
    "weather_tool",
]
