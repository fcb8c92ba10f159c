"""ToolProvider ABC — the contract the agent loop executes tools through.

Parity: reference src/tools/base.py:73-245 (`connect/disconnect/get_tools/
run_tool`) plus the streaming entry `run_tool_stream` the reference added on
its concrete provider (src/tools/agent.py:677).  Streaming is part of the
ABC here: the TPU serving path treats streamed tool output as first-class
(it rides the same SSE channel as tokens).
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Dict, List, Optional

from .types import Tool, ToolEvent


class ToolProvider(abc.ABC):
    """Source of tools for an agent run."""

    async def connect(self) -> None:
        """Establish connections (MCP servers, sandboxes). Idempotent."""

    async def disconnect(self) -> None:
        """Tear down connections. Idempotent."""

    @abc.abstractmethod
    def get_tools(self) -> List[Dict[str, Any]]:
        """Available tools in OpenAI function-calling format."""
        raise NotImplementedError

    @abc.abstractmethod
    def run_tool_stream(
        self,
        name: str,
        arguments: Any,
        tool_call_id: Optional[str] = None,
    ) -> AsyncIterator[ToolEvent]:
        """Execute a tool, yielding `ToolEvent`s; the last is terminal."""
        raise NotImplementedError

    async def run_tool(
        self,
        name: str,
        arguments: Any,
        tool_call_id: Optional[str] = None,
    ) -> Any:
        """Non-streaming execution; returns the terminal result value."""
        result: Any = None
        async for ev in self.run_tool_stream(name, arguments, tool_call_id):
            if ev.kind == "result":
                result = ev.data
            elif ev.kind == "error":
                raise RuntimeError(str(ev.data))
        return result

    def has_tool(self, name: str) -> bool:
        return any(
            t.get("function", {}).get("name") == name for t in self.get_tools()
        )

    async def __aenter__(self) -> "ToolProvider":
        await self.connect()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.disconnect()
