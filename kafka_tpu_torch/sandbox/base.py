"""Sandbox ABC — the tool-execution runtime contract.

Parity: reference src/sandbox/base.py:41-130 — `check_health`,
`wait_until_live`, `run_tool` (streaming), `claim`, `stop`, `reset`,
`terminate`; classmethod-style `create`/`connect` live on factories here
(sandbox/manager.py, sandbox/process.py) because construction policy —
cloud VM vs local subprocess vs warm pool — is deployment configuration,
not sandbox behavior.
"""

from __future__ import annotations

import abc
import asyncio
import time
from typing import Any, AsyncIterator, Dict, Optional

from ..tools.types import ToolEvent
from .types import SandboxConfig, SandboxError, SandboxInfo

HEALTH_POLL_INTERVAL_S = 2.0  # reference daytona.py:51
WAIT_TIMEOUT_S = 300.0  # reference daytona.py:52


class Sandbox(abc.ABC):
    sandbox_id: str

    # -- health --------------------------------------------------------

    @abc.abstractmethod
    async def check_health(self) -> Dict[str, Any]:
        """Quick probe; returns at least {"healthy": bool, "claimed": bool}.
        Never raises — unreachable means {"healthy": False}."""

    async def wait_until_live(
        self,
        timeout: float = WAIT_TIMEOUT_S,
        poll_interval: float = HEALTH_POLL_INTERVAL_S,
    ) -> None:
        """Block until healthy; SandboxError on timeout
        (reference local.py:125-173, daytona.py:134-195)."""
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            status = await self.check_health()
            if status.get("healthy"):
                return
            attempt += 1
            if time.monotonic() >= deadline:
                raise SandboxError(
                    f"sandbox {self.sandbox_id} not live after {timeout:.0f}s "
                    f"({attempt} probes)"
                )
            await asyncio.sleep(poll_interval)

    # -- execution -----------------------------------------------------

    @abc.abstractmethod
    def run_tool(
        self,
        name: str,
        arguments: Dict[str, Any],
        tool_call_id: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[ToolEvent]:
        """Execute a tool inside the sandbox, streaming events; the last
        event is terminal ("result" or "error")."""

    # -- lifecycle -----------------------------------------------------

    @abc.abstractmethod
    async def claim(self, config: SandboxConfig) -> bool:
        """Bind this sandbox to a thread (injects env/keys). Returns False
        when already claimed by someone else."""

    async def reset(self) -> None:
        """Clear per-thread state, keep the sandbox alive (optional op)."""

    async def stop(self) -> None:
        """Stop the sandbox, keep it restartable (optional op)."""

    async def terminate(self) -> None:
        """Destroy the sandbox permanently (optional op)."""

    async def get_info(self) -> SandboxInfo:
        status = await self.check_health()
        from .types import SandboxState

        return SandboxInfo(
            sandbox_id=self.sandbox_id,
            state=SandboxState.RUNNING
            if status.get("healthy") else SandboxState.UNKNOWN,
            healthy=bool(status.get("healthy")),
            claimed=bool(status.get("claimed")),
        )
