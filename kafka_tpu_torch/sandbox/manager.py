"""SandboxManager — thread↔sandbox lifecycle.

Parity: reference src/sandbox/manager.py:37-458 —
  * non-blocking `get_sandbox_if_ready` with a ready cache and
    claim-if-unclaimed reconciliation (:149-205);
  * `ensure_sandbox_background` spawning a creation task, deduped by a
    pending set (:252-314);
  * the three-case lifecycle: new→create, healthy→reuse, dead→restart
    (:316-377), with the warm-pool fast path (:388-400);
  * claim-config assembly injecting THREAD_ID / VM API key / env (:85-147);
  * `release_sandbox` (:445-458).

Construction policy is delegated to a `SandboxFactory` (process-spawned
local sandboxes in this tree; a cloud factory implements the same
protocol).  One reference bug fixed: `_ready_sandboxes` was mutated from
background tasks without coordination (SURVEY §5.2) — here all cache
mutation happens on the event loop (no threads), and the pending-set
discipline is enforced with try/finally.
"""

from __future__ import annotations

import abc
import asyncio
import logging
from typing import Any, Dict, Optional

from ..db.base import DBClient
from .base import Sandbox
from .types import SandboxConfig, SandboxError
from .warm import WarmSandboxFactory

logger = logging.getLogger("kafka_tpu_torch.sandbox.manager")

RESTART_GRACE_S = 60.0  # reference manager.py: 60s grace before declaring dead


async def _aclose_quiet(sandbox: Sandbox) -> None:
    """Close a dropped sandbox handle without letting close errors mask
    the drop decision (each handle owns an httpx client)."""
    aclose = getattr(sandbox, "aclose", None)
    if aclose is not None:
        try:
            await aclose()
        except Exception:
            logger.debug("sandbox aclose failed", exc_info=True)


class SandboxFactory(abc.ABC):
    """Provisioning policy: how sandboxes are created/found/restarted."""

    @abc.abstractmethod
    async def create(self, thread_id: str) -> Sandbox: ...

    @abc.abstractmethod
    async def connect(self, sandbox_id: str) -> Optional[Sandbox]:
        """Re-attach to an existing sandbox; None if it no longer exists."""

    async def restart(self, sandbox_id: str) -> Optional[Sandbox]:
        """Restart a dead sandbox in place; None if impossible."""
        return None

    async def terminate(self, sandbox_id: str) -> None: ...

    async def aclose(self) -> None: ...


class SandboxManager:
    def __init__(
        self,
        db: DBClient,
        factory: SandboxFactory,
        warm_factory: Optional[WarmSandboxFactory] = None,
        extra_claim_env: Optional[Dict[str, str]] = None,
        live_timeout_s: float = 300.0,
    ):
        self.db = db
        self.factory = factory
        self.warm_factory = warm_factory
        self.extra_claim_env = dict(extra_claim_env or {})
        self.live_timeout_s = live_timeout_s
        self._ready: Dict[str, Sandbox] = {}  # thread_id -> live sandbox
        self._pending: set = set()  # thread_ids with creation in flight
        self._tasks: Dict[str, asyncio.Task] = {}
        # fire-and-forget cleanup tasks: the loop only weak-refs tasks, so
        # hold them here until done or GC can collect one mid-await
        self._bg_tasks: set = set()
        # Crash supervision hookup (ProcessSandboxFactory exit watcher):
        # when a subprocess dies, evict the ready-cache entry immediately
        # rather than on the next health probe — in-flight tool execs get
        # their one terminal error from the broken stream, and the next
        # get_sandbox_if_ready goes straight to the reconnect/restart path
        # instead of serving a dead handle out of cache.
        register = getattr(factory, "set_crash_listener", None)
        if register is not None:
            register(self._on_sandbox_crash)

    def _on_sandbox_crash(self, sandbox_id: str) -> None:
        """Factory exit-watcher callback (runs on the event loop — all
        cache mutation stays loop-confined, the module invariant)."""
        for thread_id, sandbox in list(self._ready.items()):
            if sandbox.sandbox_id == sandbox_id:
                logger.warning(
                    "sandbox %s for thread %s crashed; evicting from "
                    "ready cache", sandbox_id, thread_id,
                )
                self._ready.pop(thread_id, None)
                task = asyncio.get_running_loop().create_task(
                    _aclose_quiet(sandbox)
                )
                self._bg_tasks.add(task)
                task.add_done_callback(self._bg_tasks.discard)

    # -- claim config (reference manager.py:85-147) --------------------

    async def build_claim_config(self, thread_id: str) -> SandboxConfig:
        vm_key = await self.db.get_or_create_vm_api_key(thread_id)
        env = {"THREAD_ID": thread_id, "VM_API_KEY": vm_key}
        cfg = await self.db.get_thread_config(thread_id) or {}
        if cfg.get("memory_dsn"):
            env["MEMORY_DSN"] = str(cfg["memory_dsn"])
        env.update(self.extra_claim_env)
        return SandboxConfig(thread_id=thread_id, vm_api_key=vm_key, env=env)

    # -- non-blocking readiness (reference manager.py:149-205) ---------

    async def get_sandbox_if_ready(self, thread_id: str) -> Optional[Sandbox]:
        """Return a healthy, claimed sandbox for the thread, or None
        without blocking on creation."""
        sandbox = self._ready.get(thread_id)
        if sandbox is not None:
            status = await sandbox.check_health()
            if status.get("healthy"):
                if not status.get("claimed"):
                    # claim reconciliation: re-claim with fresh config; a
                    # failure means someone else claimed it in the gap —
                    # drop it from the cache rather than serve a sandbox
                    # whose tools will be rejected
                    ok = await sandbox.claim(
                        await self.build_claim_config(thread_id)
                    )
                    if not ok:
                        logger.warning(
                            "re-claim failed for %s; dropping", thread_id
                        )
                        self._ready.pop(thread_id, None)
                        await _aclose_quiet(sandbox)
                        return None
                return sandbox
            logger.warning("cached sandbox for %s went unhealthy", thread_id)
            self._ready.pop(thread_id, None)
            await _aclose_quiet(sandbox)

        if thread_id in self._pending:
            return None

        # cold path: maybe a sandbox id is on record and still alive
        sandbox_id = await self.db.get_thread_sandbox_id(thread_id)
        if not sandbox_id:
            return None
        try:
            sandbox = await self.factory.connect(sandbox_id)
        except SandboxError as e:
            # transient control-plane failure on a POLLING path: report
            # "not ready yet" so LazySandbox keeps retrying until its
            # deadline — the binding (and the VM) must survive the blip
            logger.warning("connect for %s not ready: %s", thread_id, e)
            return None
        if sandbox is None:
            return None
        status = await sandbox.check_health()
        if not status.get("healthy"):
            await _aclose_quiet(sandbox)
            return None
        # Re-claim even when already claimed: a freshly connected client
        # must (re)learn the vm_api_key or its tool calls are rejected.
        # Same-thread re-claims presenting the key are idempotent
        # server-side; a False here means the sandbox belongs to someone
        # else (or the key rotated) — don't serve it. Close what we drop:
        # LazySandbox re-polls this path every 200ms and each miss would
        # otherwise leak a connected httpx client.
        if not await sandbox.claim(await self.build_claim_config(thread_id)):
            await _aclose_quiet(sandbox)
            return None
        self._ready[thread_id] = sandbox
        return sandbox

    # -- background creation (reference manager.py:252-314) ------------

    def ensure_sandbox_background(self, thread_id: str) -> None:
        """Fire-and-forget creation; deduped while one is in flight."""
        if thread_id in self._ready or thread_id in self._pending:
            return
        self._pending.add(thread_id)
        task = asyncio.get_running_loop().create_task(
            self._ensure_sandbox_task(thread_id)
        )
        self._tasks[thread_id] = task

    async def _ensure_sandbox_task(self, thread_id: str) -> None:
        sandbox: Optional[Sandbox] = None
        try:
            sandbox = await self._get_or_create(thread_id)
            await self.db.update_thread_sandbox_id(thread_id, sandbox.sandbox_id)
            await sandbox.wait_until_live(timeout=self.live_timeout_s)
            if not await sandbox.claim(await self.build_claim_config(thread_id)):
                raise SandboxError(
                    f"claim failed for thread {thread_id} on "
                    f"sandbox {sandbox.sandbox_id}"
                )
            self._ready[thread_id] = sandbox
            logger.info("sandbox %s ready for thread %s",
                        sandbox.sandbox_id, thread_id)
        except Exception:
            logger.exception("sandbox creation failed for thread %s", thread_id)
            if sandbox is not None:
                await _aclose_quiet(sandbox)
        finally:
            self._pending.discard(thread_id)
            self._tasks.pop(thread_id, None)

    async def ensure_sandbox(self, thread_id: str) -> Sandbox:
        """Blocking convenience: create/recover and wait until ready."""
        ready = await self.get_sandbox_if_ready(thread_id)
        if ready is not None:
            return ready
        if thread_id in self._pending:
            task = self._tasks.get(thread_id)
            if task is not None:
                await task
            sandbox = self._ready.get(thread_id)
            if sandbox is None:
                raise SandboxError(
                    f"sandbox creation failed for thread {thread_id}"
                )
            return sandbox
        self._pending.add(thread_id)
        try:
            sandbox = await self._get_or_create(thread_id)
            await self.db.update_thread_sandbox_id(thread_id, sandbox.sandbox_id)
            await sandbox.wait_until_live(timeout=self.live_timeout_s)
            if not await sandbox.claim(await self.build_claim_config(thread_id)):
                raise SandboxError(
                    f"claim failed for thread {thread_id} on "
                    f"sandbox {sandbox.sandbox_id}"
                )
            self._ready[thread_id] = sandbox
            return sandbox
        finally:
            self._pending.discard(thread_id)

    # -- three-case lifecycle (reference manager.py:316-377) -----------

    async def _get_or_create(self, thread_id: str) -> Sandbox:
        sandbox_id = await self.db.get_thread_sandbox_id(thread_id)
        if sandbox_id:
            sandbox = await self.factory.connect(sandbox_id)
            if sandbox is not None:
                status = await sandbox.check_health()
                if status.get("healthy"):
                    logger.info("reusing sandbox %s for %s",
                                sandbox_id, thread_id)
                    return sandbox
                restarted = await self.factory.restart(sandbox_id)
                if restarted is not None:
                    logger.info("restarted sandbox %s for %s",
                                sandbox_id, thread_id)
                    return restarted
            logger.info("sandbox %s is gone; creating fresh", sandbox_id)

        # warm-pool fast path (reference manager.py:388-400)
        if self.warm_factory is not None:
            warm_id = await self.warm_factory.claim_warm()
            if warm_id:
                sandbox = await self.factory.connect(warm_id)
                if sandbox is not None:
                    logger.info("claimed warm sandbox %s for %s",
                                warm_id, thread_id)
                    return sandbox

        return await self.factory.create(thread_id)

    # -- teardown ------------------------------------------------------

    async def release_sandbox(self, thread_id: str, terminate: bool = False) -> None:
        sandbox = self._ready.pop(thread_id, None)
        if sandbox is None:
            return
        try:
            if terminate:
                await self.factory.terminate(sandbox.sandbox_id)
                await self.db.update_thread_sandbox_id(thread_id, None)
            else:
                await sandbox.reset()
        except Exception as e:
            logger.warning("release failed for %s: %s", thread_id, e)

    async def aclose(self) -> None:
        for task in list(self._tasks.values()):
            task.cancel()
        self._ready.clear()
        await self.factory.aclose()
