"""SandboxTool — tools that execute inside a sandbox.

Parity: reference src/tools/types.py:222-374 (`SandboxTool` forwards to
`Sandbox.run_tool` after a health wait) and server_tools/shell.py:35-75 /
notebook.py:39-72 (the shell/notebook tool definitions with their 30s/300s
health timeouts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

from ..tools.types import Tool, ToolEvent
from .base import Sandbox
from .types import SandboxError

SHELL_HEALTH_TIMEOUT_S = 30.0  # reference server.py:121
NOTEBOOK_HEALTH_TIMEOUT_S = 300.0  # reference server.py:122


@dataclass
class SandboxTool(Tool):
    """A Tool executed by a sandbox rather than an in-process handler."""

    sandbox: Optional[Sandbox] = None
    health_timeout_s: float = SHELL_HEALTH_TIMEOUT_S
    #: sandbox-side tool name (defaults to this tool's name)
    remote_name: Optional[str] = None
    source: str = "sandbox"
    default_arguments: Dict[str, Any] = field(default_factory=dict)

    def bind(self, sandbox: Sandbox) -> "SandboxTool":
        self.sandbox = sandbox
        return self

    async def run_stream(
        self, arguments: Dict[str, Any]
    ) -> AsyncIterator[ToolEvent]:
        if self.sandbox is None:
            yield ToolEvent(
                "error",
                f"tool {self.name} has no sandbox bound for this thread",
                tool_name=self.name,
            )
            return
        try:
            await self.sandbox.wait_until_live(
                timeout=self.health_timeout_s, poll_interval=0.5
            )
        except SandboxError as e:
            yield ToolEvent("error", str(e), tool_name=self.name)
            return
        merged = {**self.default_arguments, **arguments}
        async for ev in self.sandbox.run_tool(
            self.remote_name or self.name, merged
        ):
            ev.tool_name = self.name
            yield ev


def shell_tools(sandbox: Optional[Sandbox] = None) -> List[SandboxTool]:
    """`create_shell` / `shell_exec` (reference server_tools/shell.py)."""
    return [
        SandboxTool(
            name="create_shell",
            description=(
                "Create (or reuse) a named persistent shell session in the "
                "sandbox. Returns the shell_id to pass to shell_exec."
            ),
            parameters={
                "type": "object",
                "properties": {"shell_id": {"type": "string"}},
            },
            sandbox=sandbox,
            health_timeout_s=SHELL_HEALTH_TIMEOUT_S,
        ),
        SandboxTool(
            name="shell_exec",
            description=(
                "Run a shell command in a persistent sandbox shell. Output "
                "streams as it is produced; the working directory and "
                "environment persist across calls to the same shell_id."
            ),
            parameters={
                "type": "object",
                "properties": {
                    "command": {"type": "string"},
                    "shell_id": {"type": "string"},
                    "timeout": {"type": "number", "default": 30},
                },
                "required": ["command"],
            },
            sandbox=sandbox,
            health_timeout_s=SHELL_HEALTH_TIMEOUT_S,
        ),
    ]


def notebook_tools(sandbox: Optional[Sandbox] = None) -> List[SandboxTool]:
    """`notebook_run_cell` (reference server_tools/notebook.py)."""
    return [
        SandboxTool(
            name="notebook_run_cell",
            description=(
                "Execute a Python cell in the sandbox's persistent notebook "
                "kernel. Variables persist across cells; the value of a "
                "trailing expression is echoed."
            ),
            parameters={
                "type": "object",
                "properties": {
                    "code": {"type": "string"},
                    "kernel_id": {"type": "string"},
                    "timeout": {"type": "number", "default": 300},
                },
                "required": ["code"],
            },
            sandbox=sandbox,
            health_timeout_s=NOTEBOOK_HEALTH_TIMEOUT_S,
        ),
    ]


def sandbox_builtin_tools(sandbox_url: str) -> List[SandboxTool]:
    """Shell + notebook tools bound to a URL-direct sandbox."""
    from .local import LocalSandbox

    sandbox = LocalSandbox(sandbox_url)
    return [*shell_tools(sandbox), *notebook_tools(sandbox)]
