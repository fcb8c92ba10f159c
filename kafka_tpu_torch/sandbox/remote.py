"""Remote sandbox provisioning: cloud VMs behind a control-plane API.

The reference provisions tool VMs through the Daytona cloud SDK
(src/sandbox/daytona.py:394-441 create-from-snapshot with fire-and-forget
boot, :443-479 restart, :481-558 connect/stop/delete) and reaches each VM
through a per-sandbox proxy URL (:49-68,
``https://8081-<id>.proxy.daytona.works``).  This is the same capability
expressed as a plain HTTP control plane — no vendor SDK — so any
provisioner that speaks the small REST surface below can back it:

    POST   {api}/sandboxes                {"snapshot", "thread_id"} -> {"id"}
    GET    {api}/sandboxes/{id}           -> {"id", "state"}
    POST   {api}/sandboxes/{id}/restart   -> 200
    DELETE {api}/sandboxes/{id}           -> 200

Each provisioned VM exposes the standard in-VM tool server (sandbox/
server.py protocol: /health, /claim, /run) at a proxy URL derived from a
template, e.g. ``https://8081-{id}.proxy.example.com`` — the returned
handles are ordinary URL-direct sandboxes (sandbox/local.py), exactly the
way the reference's DaytonaSandbox is URL-direct once provisioned.

This factory plugs into SandboxManager wherever a deployment manages
per-thread sandboxes (the library path; see sandbox/manager.py).
`RemoteSandboxFactory.from_env()` builds one from:
    KAFKA_TORCH_SANDBOX_API_URL         control-plane base URL
    KAFKA_TORCH_SANDBOX_API_KEY         bearer token (optional)
    KAFKA_TORCH_SANDBOX_SNAPSHOT        snapshot/image id for new VMs
    KAFKA_TORCH_SANDBOX_PROXY_TEMPLATE  e.g. "https://8081-{id}.proxy.x.dev"
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

import httpx

from .base import Sandbox, SandboxError
from .local import LocalSandbox
from .manager import SandboxFactory

logger = logging.getLogger("kafka_tpu_torch.sandbox.remote")

DEFAULT_BOOT_TIMEOUT_S = 300.0  # reference daytona.py:51-52 (2s poll, 300s)


class RemoteSandboxFactory(SandboxFactory):
    """SandboxFactory over the provisioning REST surface above."""

    def __init__(
        self,
        api_url: str,
        proxy_template: str,
        snapshot: str = "default",
        api_key: str = "",
        boot_timeout_s: float = DEFAULT_BOOT_TIMEOUT_S,
    ):
        self.api_url = api_url.rstrip("/")
        self.proxy_template = proxy_template
        self.snapshot = snapshot
        self.boot_timeout_s = boot_timeout_s
        headers = {}
        if api_key:
            headers["Authorization"] = f"Bearer {api_key}"
        self._client = httpx.AsyncClient(
            base_url=self.api_url, headers=headers, timeout=30.0
        )

    @classmethod
    def from_env(cls) -> Optional["RemoteSandboxFactory"]:
        url = os.environ.get("KAFKA_TORCH_SANDBOX_API_URL")
        template = os.environ.get("KAFKA_TORCH_SANDBOX_PROXY_TEMPLATE")
        if not url or not template:
            return None
        return cls(
            url,
            template,
            snapshot=os.environ.get("KAFKA_TORCH_SANDBOX_SNAPSHOT", "default"),
            api_key=os.environ.get("KAFKA_TORCH_SANDBOX_API_KEY", ""),
        )

    def _url_for(self, sandbox_id: str) -> str:
        return self.proxy_template.format(id=sandbox_id)

    # -- SandboxFactory --------------------------------------------------

    async def create(self, thread_id: str) -> Sandbox:
        r = await self._client.post(
            "/sandboxes",
            json={"snapshot": self.snapshot, "thread_id": thread_id},
        )
        r.raise_for_status()
        sandbox_id = r.json()["id"]
        logger.info(
            "provisioned sandbox %s (snapshot %s) for thread %s",
            sandbox_id, self.snapshot, thread_id,
        )
        # fire-and-forget boot (reference daytona.py:431): the VM starts
        # asynchronously; we hand back a handle and wait on its tool server.
        # A VM that never comes up is torn down — it would otherwise keep
        # running (and billing) with nothing referencing it.
        sandbox = LocalSandbox(self._url_for(sandbox_id), sandbox_id)
        try:
            await sandbox.wait_until_live(
                timeout=self.boot_timeout_s, poll_interval=2.0
            )
        except Exception:
            await sandbox.aclose()
            await self.terminate(sandbox_id)
            raise
        return sandbox

    async def connect(self, sandbox_id: str) -> Optional[Sandbox]:
        try:
            r = await self._client.get(f"/sandboxes/{sandbox_id}")
            if r.status_code == 404:
                return None  # genuinely gone: the manager recreates
            r.raise_for_status()
        except httpx.HTTPError as e:
            # transient control-plane failure is NOT "gone" — returning
            # None would make the manager orphan the VM and provision a
            # fresh one, losing the thread's filesystem state; raise a
            # typed error so the attempt fails and retries keep the
            # binding
            raise SandboxError(
                f"control plane error for {sandbox_id}: {e}"
            ) from e
        # the GET is an existence probe: a stopped VM's handle comes back
        # unhealthy and the manager's 3-case lifecycle routes it to
        # restart(); a deleted VM returns None above and gets recreated
        return LocalSandbox(self._url_for(sandbox_id), sandbox_id)

    async def restart(self, sandbox_id: str) -> Optional[Sandbox]:
        try:
            r = await self._client.post(f"/sandboxes/{sandbox_id}/restart")
            if r.status_code == 404:
                return None
            r.raise_for_status()
        except httpx.HTTPError as e:
            logger.warning("restart of %s failed: %s", sandbox_id, e)
            return None
        sandbox = LocalSandbox(self._url_for(sandbox_id), sandbox_id)
        try:
            await sandbox.wait_until_live(
                timeout=self.boot_timeout_s, poll_interval=2.0
            )
        except Exception as e:
            logger.warning("sandbox %s not live after restart: %s",
                           sandbox_id, e)
            await sandbox.aclose()
            return None
        return sandbox

    async def terminate(self, sandbox_id: str) -> None:
        try:
            r = await self._client.delete(f"/sandboxes/{sandbox_id}")
            if r.status_code not in (200, 202, 204, 404):
                r.raise_for_status()
        except httpx.HTTPError as e:
            logger.warning("terminate of %s failed: %s", sandbox_id, e)

    async def aclose(self) -> None:
        await self._client.aclose()
