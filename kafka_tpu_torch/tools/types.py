"""Tool definitions and streaming tool events.

Parity targets: reference `Tool` (src/tools/types.py:39-219 — sync, async,
and async-generator handlers behind one `run`/`run_stream` interface) and
the sandbox `ToolEvent` streaming unit (src/sandbox/types.py:41-70).
`SandboxTool` lives in the sandbox tier (sandbox/tools.py) — this module is
dependency-free so the agent loop can import it without pulling IO code.
"""

from __future__ import annotations

import asyncio
import inspect
import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from ..core.toolcalls import parse_tool_arguments  # canonical impl (re-export)


@dataclass(slots=True)
class ToolEvent:
    """One streamed unit of tool output.

    kind: "delta" (incremental output), "log" (diagnostic), "result"
    (terminal value), "error" (terminal failure).
    """

    kind: str
    data: Any = None
    tool_name: Optional[str] = None
    tool_call_id: Optional[str] = None

    @property
    def terminal(self) -> bool:
        return self.kind in ("result", "error")

    def text(self) -> str:
        if isinstance(self.data, str):
            return self.data
        return json.dumps(self.data) if self.data is not None else ""


@dataclass
class Tool:
    """A callable tool exposed to the LLM.

    `handler(**arguments)` may be a plain function, an async function, or an
    async generator (streaming). All three are normalized to the streaming
    interface by `run_stream`; `run` collects the terminal result.
    """

    name: str
    description: str
    parameters: Dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )
    handler: Optional[Callable[..., Any]] = None
    source: str = "local"
    # extra metadata (e.g. which sandbox/MCP server owns it)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_openai(self) -> Dict[str, Any]:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.parameters,
            },
        }

    async def run_stream(
        self, arguments: Dict[str, Any]
    ) -> AsyncIterator[ToolEvent]:
        """Execute the handler, yielding events; always ends terminal."""
        if self.handler is None:
            yield ToolEvent("error", f"tool {self.name} has no handler",
                            tool_name=self.name)
            return
        try:
            if inspect.isasyncgenfunction(self.handler):
                parts: List[Any] = []
                async for item in self.handler(**arguments):
                    if isinstance(item, ToolEvent):
                        yield item
                        if item.terminal:
                            return
                        continue
                    parts.append(item)
                    yield ToolEvent("delta", item, tool_name=self.name)
                # terminal result aggregates the whole stream (the model must
                # see full output, not the last fragment): concatenate text
                # streams; otherwise the last value wins
                if parts and all(isinstance(p, str) for p in parts):
                    result: Any = "".join(parts)
                else:
                    result = parts[-1] if parts else None
                yield ToolEvent("result", result, tool_name=self.name)
            elif inspect.iscoroutinefunction(self.handler):
                result = await self.handler(**arguments)
                yield ToolEvent("result", result, tool_name=self.name)
            else:
                # sync handler: run off-loop so slow tools don't stall serving
                result = await asyncio.to_thread(self.handler, **arguments)
                yield ToolEvent("result", result, tool_name=self.name)
        except Exception as e:  # tool errors are data, not crashes
            yield ToolEvent("error", f"{type(e).__name__}: {e}",
                            tool_name=self.name)

    async def run(self, arguments: Dict[str, Any]) -> Any:
        """Non-streaming execution; returns the terminal result.

        Raises ToolExecutionError on a terminal error event.
        """
        last: Any = None
        async for ev in self.run_stream(arguments):
            if ev.kind == "result":
                return ev.data
            if ev.kind == "error":
                raise ToolExecutionError(str(ev.data), tool_name=self.name)
            last = ev.data
        return last


class ToolExecutionError(Exception):
    def __init__(self, message: str, tool_name: Optional[str] = None):
        super().__init__(message)
        self.tool_name = tool_name


@dataclass
class MCPServerConfig:
    """Connection config for an MCP tool server.

    Parity: reference src/tools/types.py:377 — stdio (command+args) or
    HTTP (url) transports.
    """

    name: str
    command: Optional[str] = None
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    url: Optional[str] = None
    transport: Optional[str] = None  # "stdio" | "streamable-http" | "sse"

    @property
    def effective_transport(self) -> str:
        if self.transport:
            return self.transport
        return "stdio" if self.command else "streamable-http"
