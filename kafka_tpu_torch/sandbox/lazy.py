"""LazySandbox — deferred-resolution proxy.

Parity: reference src/sandbox/lazy.py:19-124.  The LLM starts streaming
immediately while the real sandbox boots in the background; the FIRST tool
call blocks in `_ensure_resolved`, polling the manager's ready cache every
200ms under an asyncio lock (double-checked) with a 120s timeout.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Any, AsyncIterator, Dict, Optional

from ..tools.types import ToolEvent
from .base import Sandbox
from .types import SandboxConfig, SandboxError

if TYPE_CHECKING:
    from .manager import SandboxManager

logger = logging.getLogger("kafka_tpu_torch.sandbox.lazy")

RESOLVE_POLL_INTERVAL_S = 0.2  # reference lazy.py:124
RESOLVE_TIMEOUT_S = 120.0  # reference server.py:228


class LazySandbox(Sandbox):
    def __init__(
        self,
        thread_id: str,
        manager: "SandboxManager",
        timeout: float = RESOLVE_TIMEOUT_S,
    ):
        self.thread_id = thread_id
        self.sandbox_id = f"lazy:{thread_id}"
        self.manager = manager
        self.timeout = timeout
        self._resolved: Optional[Sandbox] = None
        self._resolve_lock = asyncio.Lock()

    async def _ensure_resolved(self) -> Sandbox:
        if self._resolved is not None:
            return self._resolved
        async with self._resolve_lock:
            if self._resolved is not None:  # double-check under the lock
                return self._resolved
            deadline = (
                asyncio.get_running_loop().time() + self.timeout
            )
            while True:
                sandbox = await self.manager.get_sandbox_if_ready(self.thread_id)
                if sandbox is not None:
                    self._resolved = sandbox
                    self.sandbox_id = sandbox.sandbox_id
                    return sandbox
                if asyncio.get_running_loop().time() >= deadline:
                    raise SandboxError(
                        f"sandbox for thread {self.thread_id} not ready "
                        f"after {self.timeout:.0f}s"
                    )
                await asyncio.sleep(RESOLVE_POLL_INTERVAL_S)

    # -- Sandbox interface: everything defers --------------------------

    async def check_health(self) -> Dict[str, Any]:
        if self._resolved is None:
            return {"healthy": False, "claimed": False, "resolving": True}
        return await self._resolved.check_health()

    async def run_tool(
        self,
        name: str,
        arguments: Dict[str, Any],
        tool_call_id: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[ToolEvent]:
        try:
            sandbox = await self._ensure_resolved()
        except SandboxError as e:
            yield ToolEvent("error", str(e), tool_name=name,
                            tool_call_id=tool_call_id)
            return
        async for ev in sandbox.run_tool(
            name, arguments, tool_call_id=tool_call_id, timeout=timeout
        ):
            yield ev

    async def claim(self, config: SandboxConfig) -> bool:
        sandbox = await self._ensure_resolved()
        return await sandbox.claim(config)

    async def reset(self) -> None:
        if self._resolved is not None:
            await self._resolved.reset()
