"""AgentToolProvider — routes tool execution by source.

Parity: reference src/tools/agent.py:416-833. Sources:
  * "local"   — in-process `Tool` handlers (sync/async/async-gen);
  * "sandbox" — `SandboxTool`s forwarding to a sandbox VM (sandbox tier);
  * "mcp"     — tools discovered from MCP servers (tools/mcp.py).

All are registered into one namespace; `get_tools` returns the merged
OpenAI-format list and `run_tool_stream` dispatches to the owner.  Unknown
tools yield a terminal error event (the model sees the failure and can
correct itself) rather than raising — an agent run must survive a bad tool
name, matching the reference's behavior.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

from .. import tracing
from ..failpoints import failpoint
from .base import ToolProvider
from .types import MCPServerConfig, Tool, ToolEvent, parse_tool_arguments

logger = logging.getLogger("kafka_tpu_torch.tools")


class AgentToolProvider(ToolProvider):
    def __init__(
        self,
        tools: Optional[Sequence[Tool]] = None,
        mcp_servers: Optional[Sequence[MCPServerConfig]] = None,
        on_tool_complete: Optional[Any] = None,
    ):
        self._tools: Dict[str, Tool] = {}
        for t in tools or []:
            self.register_tool(t)
        self._mcp_configs = list(mcp_servers or [])
        self._mcp_connections: List[Any] = []  # MCPConnection, tools/mcp.py
        self._connected = False
        # fired with (tool_name, tool_call_id) on each tool's
        # terminal event — the sandbox SSE stream's completion — so a
        # serving tier can kick the thread's expected-return hint (wake
        # prefetch) without waiting for the agent loop to come around.
        # Must never raise into the event stream.
        self.on_tool_complete = on_tool_complete

    # -- registry ------------------------------------------------------

    def register_tool(self, tool: Tool) -> None:
        if tool.name in self._tools:
            logger.warning("tool %s re-registered (overriding)", tool.name)
        self._tools[tool.name] = tool

    def unregister_tool(self, name: str) -> None:
        self._tools.pop(name, None)

    def get_tool(self, name: str) -> Optional[Tool]:
        return self._tools.get(name)

    # -- lifecycle -----------------------------------------------------

    async def connect(self) -> None:
        """Connect MCP servers; failures are logged and skipped (an
        unreachable tool server must not take down serving — reference
        src/tools/agent.py:494-496)."""
        if self._connected:
            return
        if self._mcp_configs:
            from .mcp import MCPConnection

            for cfg in self._mcp_configs:
                conn = MCPConnection(cfg)
                try:
                    await conn.connect()
                except Exception as e:
                    logger.warning(
                        "MCP server %s failed to connect: %s — skipping",
                        cfg.name, e,
                    )
                    continue
                self._mcp_connections.append(conn)
                for tool in conn.discovered_tools():
                    self.register_tool(tool)
        self._connected = True

    async def disconnect(self) -> None:
        for conn in self._mcp_connections:
            try:
                await conn.disconnect()
            except Exception as e:
                logger.warning("MCP disconnect failed: %s", e)
        self._mcp_connections.clear()
        self._connected = False

    # -- execution -----------------------------------------------------

    def get_tools(self) -> List[Dict[str, Any]]:
        return [t.to_openai() for t in self._tools.values()]

    async def run_tool_stream(
        self,
        name: str,
        arguments: Any,
        tool_call_id: Optional[str] = None,
    ) -> AsyncIterator[ToolEvent]:
        tool = self._tools.get(name)
        if tool is None:
            yield ToolEvent(
                "error",
                f"unknown tool: {name}. Available: {sorted(self._tools)}",
                tool_name=name,
                tool_call_id=tool_call_id,
            )
            self._notify_complete(name, tool_call_id)
            return
        args = parse_tool_arguments(arguments)
        # injected tool latency/faults (agent-gap benches arm
        # `agent.tool=delay(...)` to model a slow tool without a real
        # sandbox round trip)
        try:
            failpoint("agent.tool")
        except Exception as e:
            yield ToolEvent(
                "error", f"tool fault injected: {e}",
                tool_name=name, tool_call_id=tool_call_id,
            )
            self._notify_complete(name, tool_call_id)
            return
        # one span per tool call; sandbox tools propagate the resulting
        # context over the wire so child spans recorded INSIDE the sandbox
        # subprocess stitch back under this one (sandbox/local.py)
        with tracing.span(
            "tool.exec", attrs={"tool": name, "source": tool.source}
        ) as s:
            async for ev in tool.run_stream(args):
                ev.tool_call_id = tool_call_id
                ev.tool_name = ev.tool_name or name
                if s is not None and ev.kind == "error":
                    s.attrs["error"] = True
                yield ev
        self._notify_complete(name, tool_call_id)

    def _notify_complete(
        self, name: str, tool_call_id: Optional[str]
    ) -> None:
        """Terminal-event listener dispatch: a hint, never a failure."""
        cb = self.on_tool_complete
        if cb is None:
            return
        try:
            cb(name, tool_call_id)
        except Exception:
            logger.exception("on_tool_complete listener failed")
