"""Warm sandbox pools — pre-provisioned sandboxes for fast cold starts.

Parity: reference src/warm_sandbox/ — `WarmSandboxFactory` ABC (:base.py:9)
and an HTTP pool client that POSTs `{service}/claim/{env_id}` and swallows
connection errors so an unreachable pool degrades to cold creation
(:daytona.py:30-64).  `ProcessWarmPool` is the in-tree equivalent: it keeps
N subprocess sandboxes booted ahead of demand.
"""

from __future__ import annotations

import abc
import asyncio
import logging
from typing import List, Optional

logger = logging.getLogger("kafka_tpu_torch.sandbox.warm")


class WarmSandboxFactory(abc.ABC):
    @abc.abstractmethod
    async def claim_warm(self) -> Optional[str]:
        """Pop a pre-warmed sandbox id, or None (pool empty/unreachable)."""


class HTTPWarmSandboxFactory(WarmSandboxFactory):
    """Claims from a remote warm-pool service over HTTP."""

    def __init__(self, service_url: str, env_id: str = "default"):
        self.service_url = service_url.rstrip("/")
        self.env_id = env_id

    async def claim_warm(self) -> Optional[str]:
        try:
            import httpx

            async with httpx.AsyncClient(timeout=10.0) as client:
                r = await client.post(
                    f"{self.service_url}/claim/{self.env_id}"
                )
                if r.status_code != 200:
                    return None
                return r.json().get("sandbox_id")
        except Exception as e:  # unreachable pool -> cold create
            logger.warning("warm pool unreachable: %s", e)
            return None


class ProcessWarmPool(WarmSandboxFactory):
    """Keeps `size` subprocess sandboxes pre-booted (refilled lazily)."""

    def __init__(self, factory, size: int = 2):
        # factory: ProcessSandboxFactory (sandbox/process.py)
        self.factory = factory
        self.size = size
        self._pool: List[str] = []
        self._fill_lock = asyncio.Lock()

    async def fill(self) -> None:
        async with self._fill_lock:
            while len(self._pool) < self.size:
                sandbox = await self.factory.create("warm")
                self._pool.append(sandbox.sandbox_id)
                logger.info("warm pool: booted %s (%d/%d)",
                            sandbox.sandbox_id, len(self._pool), self.size)

    async def claim_warm(self) -> Optional[str]:
        if not self._pool:
            return None
        sandbox_id = self._pool.pop(0)
        # refill in the background; failure just means a colder next start
        asyncio.get_running_loop().create_task(self._safe_fill())
        return sandbox_id

    async def _safe_fill(self) -> None:
        try:
            await self.fill()
        except Exception as e:
            logger.warning("warm pool refill failed: %s", e)
