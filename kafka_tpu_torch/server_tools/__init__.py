"""Built-in tools (reference server_tools/): planner, counter, weather.
Copied from kafka_tpu/server_tools; the shell/notebook tools of a
configured sandbox wait for the port's sandbox tier."""

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
        raise NotImplementedError(
            "sandbox tools are not ported to kafka_tpu_torch yet"
        )
    return tools


__all__ = [
    "PlannerTools",
    "SequentialThinkingServer",
    "builtin_tools",
    "counter_tool",
    "weather_tool",
]
