"""ProcessSandboxFactory — sandboxes as local subprocesses, supervised.

The in-tree equivalent of the reference's Daytona cloud factory
(src/sandbox/daytona.py:394-479: create-from-snapshot, connect, restart):
each sandbox is a `python -m kafka_tpu_torch.sandbox.server` subprocess on its
own port, carrying the full sandbox protocol (health/claim/run/reset).
Sandbox ids encode the port (`proc-<port>-<suffix>`) so `connect` can
re-attach after a manager restart without any registry.

Cross-process fault tolerance:

* **Liveness-verified hand-back**: `connect`/`restart` check the
  subprocess exit code AND probe the port before returning a Sandbox —
  a crashed subprocess is never handed back as "connected", and its
  zombie handle is reaped from `_procs`.
* **Exit watcher**: every spawn registers a `proc.wait()` task.  An
  unexpected exit (not `terminate`/`restart`-initiated) reaps the
  handle, notifies a crash listener (SandboxManager evicts its ready
  cache so in-flight tool execs get exactly one terminal error from the
  broken HTTP stream, and the next request sees a restart, not a wedge),
  and auto-restarts the sandbox in place with exponential backoff
  (`KAFKA_TORCH_SANDBOX_RESTART_BACKOFF_S`, doubling per consecutive
  crash).
* **Crash-loop detector**: more than `KAFKA_TORCH_SANDBOX_MAX_RESTARTS`
  unexpected exits inside `crash_window_s` stops the restart loop and
  blacklists the sandbox id — `connect` answers None and the manager
  provisions a fresh sandbox instead of feeding a poisoned one forever.
* **Failpoint inheritance**: subprocesses spawn with
  `failpoints.subprocess_env()`, so specs armed in the parent (including
  the `sandbox.server.exec` site that fires INSIDE the subprocess, and
  the `exit` action that simulates a crash) are live in the child.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import sys
import time
import uuid
from typing import Callable, Dict, List, Optional, Set

from .. import failpoints as fp
from .. import tracing
from ..failpoints import failpoint
from .base import Sandbox
from .local import LocalSandbox
from .manager import SandboxFactory
from .types import SandboxError

logger = logging.getLogger("kafka_tpu_torch.sandbox.process")

RESTART_BACKOFF_ENV = "KAFKA_TORCH_SANDBOX_RESTART_BACKOFF_S"
MAX_RESTARTS_ENV = "KAFKA_TORCH_SANDBOX_MAX_RESTARTS"

# Module-level lifecycle counters, aggregated across factories so
# server/app.py /metrics can report sandbox supervision without a handle
# on every factory instance (factories are created per manager/test).
_counters: Dict[str, int] = {
    "crashes": 0,  # unexpected subprocess exits
    "restarts": 0,  # successful supervised restarts
    "crash_loops": 0,  # ids blacklisted by the crash-loop detector
    "reaped": 0,  # zombie handles removed from _procs
}


def supervisor_snapshot() -> Dict[str, int]:
    return dict(_counters)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProcessSandboxFactory(SandboxFactory):
    def __init__(
        self,
        boot_timeout_s: float = 30.0,
        restart_backoff_s: Optional[float] = None,
        max_restarts: Optional[int] = None,
        crash_window_s: float = 60.0,
        supervise: bool = True,
    ):
        self.boot_timeout_s = boot_timeout_s
        if restart_backoff_s is None:
            restart_backoff_s = float(
                os.environ.get(RESTART_BACKOFF_ENV, "0.5")
            )
        if max_restarts is None:
            max_restarts = int(os.environ.get(MAX_RESTARTS_ENV, "3"))
        self.restart_backoff_s = restart_backoff_s
        self.max_restarts = max_restarts
        self.crash_window_s = crash_window_s
        self.supervise = supervise
        self._procs: Dict[str, asyncio.subprocess.Process] = {}
        self._watchers: Dict[str, asyncio.Task] = {}
        self._crashes: Dict[str, List[float]] = {}  # recent crash stamps
        self._crash_looping: Set[str] = set()
        # ids being torn down on purpose: their exit is not a crash
        self._terminating: Set[str] = set()
        # SandboxManager registers here (set_crash_listener) to evict its
        # ready cache the moment a subprocess dies
        self._crash_listener: Optional[Callable[[str], None]] = None

    def set_crash_listener(self, fn: Optional[Callable[[str], None]]) -> None:
        self._crash_listener = fn

    @staticmethod
    def _url_for(sandbox_id: str) -> Optional[str]:
        # proc-<port>-<suffix>
        parts = sandbox_id.split("-")
        if len(parts) < 3 or parts[0] != "proc":
            return None
        try:
            port = int(parts[1])
        except ValueError:
            return None
        return f"http://127.0.0.1:{port}"

    # -- spawn + supervision -------------------------------------------

    async def _spawn(self, sandbox_id: str, port: int) -> None:
        failpoint("sandbox.boot")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "kafka_tpu_torch.sandbox.server",
            "--port", str(port), "--sandbox-id", sandbox_id,
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL,
            # armed failpoint specs AND the tracing/log config propagate:
            # chaos and observability both cross the PID line
            env=tracing.subprocess_env(fp.subprocess_env()),
        )
        self._procs[sandbox_id] = proc
        if self.supervise:
            old = self._watchers.pop(sandbox_id, None)
            # the supervised-restart path reaches here FROM the old
            # watcher task: cancelling ourselves would abort the restart
            if old is not None and old is not asyncio.current_task():
                old.cancel()
            self._watchers[sandbox_id] = asyncio.get_running_loop().create_task(
                self._watch(sandbox_id, proc)
            )

    async def _watch(self, sandbox_id: str,
                     proc: asyncio.subprocess.Process) -> None:
        """Exit watcher: reap, notify, auto-restart with backoff."""
        rc = await proc.wait()
        current = self._procs.get(sandbox_id)
        if (sandbox_id in self._terminating
                or (current is not None and current is not proc)):
            return  # intentional kill, or a newer generation took over
        # current may be None because connect()'s exit-code check reaped
        # the handle before we woke — that is still OUR crash to account
        # (crash-loop detection, listener, restart must not be skipped);
        # intentional paths (terminate/restart) cancel this task first.
        if self._procs.pop(sandbox_id, None) is proc:
            _counters["reaped"] += 1  # not already reaped by connect()
        _counters["crashes"] += 1
        crashed = self._note_crash(sandbox_id)
        logger.error(
            "sandbox %s subprocess died unexpectedly (exit code %s, "
            "crash %d in window)", sandbox_id, rc, crashed,
        )
        if self._crash_listener is not None:
            try:
                self._crash_listener(sandbox_id)
            except Exception:
                logger.exception("sandbox crash listener failed")
        if sandbox_id in self._crash_looping:
            return
        # exponential backoff keyed on the crash density, so a sandbox
        # that dies the moment it boots doesn't spin the CPU respawning
        backoff = self.restart_backoff_s * (2 ** max(0, crashed - 1))
        await asyncio.sleep(backoff)
        if sandbox_id in self._terminating:
            return
        if self._procs.get(sandbox_id) is not None:
            # a newer generation was installed during the backoff (the
            # manager's restart path raced us): killing it to spawn our
            # own would re-break a just-recovered sandbox
            return
        try:
            sandbox = await self.restart(sandbox_id)
        except Exception:
            logger.exception("supervised restart of %s failed", sandbox_id)
            return
        if sandbox is None:
            logger.error("supervised restart of %s failed", sandbox_id)
            return
        _counters["restarts"] += 1
        logger.warning("sandbox %s auto-restarted after crash", sandbox_id)
        await sandbox.aclose()  # the watcher only needed the process back

    def _note_crash(self, sandbox_id: str) -> int:
        """Record one unexpected exit; trip the crash-loop detector when
        the recent-crash count exceeds max_restarts.  Returns the count."""
        now = time.monotonic()
        stamps = self._crashes.setdefault(sandbox_id, [])
        stamps.append(now)
        cutoff = now - self.crash_window_s
        stamps[:] = [t for t in stamps if t >= cutoff]
        if (len(stamps) > self.max_restarts
                and sandbox_id not in self._crash_looping):
            self._crash_looping.add(sandbox_id)
            _counters["crash_loops"] += 1
            logger.error(
                "sandbox %s is crash-looping (%d crashes in %.0fs); "
                "giving up on restarts", sandbox_id, len(stamps),
                self.crash_window_s,
            )
        return len(stamps)

    def _reap_if_dead(
        self, sandbox_id: str
    ) -> Optional[asyncio.subprocess.Process]:
        """Exit-code check: drop a dead handle from _procs; return the
        live process (or None)."""
        proc = self._procs.get(sandbox_id)
        if proc is None:
            return None
        if proc.returncode is not None:
            # without supervision (or before the watcher ran) the handle
            # is a zombie: reap it here so it can't be handed back
            if self._procs.pop(sandbox_id, None) is proc:
                _counters["reaped"] += 1
            return None
        return proc

    async def _wait_live(self, sandbox: LocalSandbox,
                         sandbox_id: str) -> None:
        """Boot probe: poll /health, but fail FAST if the subprocess exits
        — waiting out the full boot timeout against a dead PID would turn
        every boot crash into a 30s stall."""
        deadline = time.monotonic() + self.boot_timeout_s
        while True:
            proc = self._procs.get(sandbox_id)
            if proc is None or proc.returncode is not None:
                rc = proc.returncode if proc is not None else None
                raise SandboxError(
                    f"sandbox {sandbox_id} subprocess exited during boot "
                    f"(exit code {rc})"
                )
            status = await sandbox.check_health()
            if status.get("healthy"):
                return
            if time.monotonic() >= deadline:
                raise SandboxError(
                    f"sandbox {sandbox_id} not live after "
                    f"{self.boot_timeout_s:.0f}s"
                )
            await asyncio.sleep(0.1)

    # -- factory protocol ----------------------------------------------

    async def create(self, thread_id: str) -> Sandbox:
        port = _free_port()
        sandbox_id = f"proc-{port}-{uuid.uuid4().hex[:8]}"
        await self._spawn(sandbox_id, port)
        sandbox = LocalSandbox(self._url_for(sandbox_id), sandbox_id)
        try:
            await self._wait_live(sandbox, sandbox_id)
        except Exception:
            await sandbox.aclose()
            await self.terminate(sandbox_id)
            raise
        logger.info("spawned sandbox %s for thread %s", sandbox_id, thread_id)
        return sandbox

    async def connect(self, sandbox_id: str) -> Optional[Sandbox]:
        url = self._url_for(sandbox_id)
        if url is None:
            return None
        if sandbox_id in self._crash_looping:
            # a poisoned sandbox must not be handed back; the manager
            # falls through to creating a fresh one
            return None
        proc = self._reap_if_dead(sandbox_id)
        sandbox = LocalSandbox(url, sandbox_id)
        # port probe: the only proof a subprocess is actually serving
        status = await sandbox.check_health()
        if status.get("healthy"):
            return sandbox
        if proc is not None:
            # process alive but not serving yet (mid-boot / mid-restart):
            # hand back the handle so the manager can health-poll/restart
            # through us
            return sandbox
        await sandbox.aclose()
        return None

    async def restart(self, sandbox_id: str) -> Optional[Sandbox]:
        url = self._url_for(sandbox_id)
        if url is None:
            return None
        if sandbox_id in self._crash_looping:
            return None
        # retire the old watcher BEFORE killing its process: an old
        # watcher that woke mid-restart would misread the intentional
        # kill as a crash (the supervised-restart path skips this — the
        # current task IS that watcher, past its proc.wait already)
        watcher = self._watchers.pop(sandbox_id, None)
        if watcher is not None and watcher is not asyncio.current_task():
            watcher.cancel()
        old = self._procs.pop(sandbox_id, None)
        if old is not None and old.returncode is None:
            self._terminating.add(sandbox_id)
            try:
                old.kill()
                await old.wait()
            finally:
                self._terminating.discard(sandbox_id)
        elif old is not None:
            _counters["reaped"] += 1
        port = int(sandbox_id.split("-")[1])
        try:
            await self._spawn(sandbox_id, port)
        except Exception as e:
            logger.warning("restart spawn of %s failed: %s", sandbox_id, e)
            return None
        sandbox = LocalSandbox(url, sandbox_id)
        try:
            await self._wait_live(sandbox, sandbox_id)
            return sandbox
        except Exception as e:
            logger.warning("restart of %s failed: %s", sandbox_id, e)
            await sandbox.aclose()
            proc = self._procs.get(sandbox_id)
            if proc is not None and proc.returncode is None:
                # spawned but never went healthy inside the boot budget:
                # orphan hygiene — kill it and retire its watcher.
                # _kill_quiet, NOT terminate(): the crash ledger must
                # survive a failed restart or the loop detector resets.
                await self._kill_quiet(sandbox_id)
            # else: the process DIED rather than stalling — its own
            # watcher is mid-crash-handling (count, backoff, restart);
            # killing that chain here would orphan the supervision
            return None

    async def _kill_quiet(self, sandbox_id: str) -> None:
        """Tear down a sandbox's process/watcher WITHOUT touching the
        crash ledger — failure hygiene, not the operator reset."""
        self._terminating.add(sandbox_id)
        try:
            watcher = self._watchers.pop(sandbox_id, None)
            if (watcher is not None
                    and watcher is not asyncio.current_task()):
                watcher.cancel()
            proc = self._procs.pop(sandbox_id, None)
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
        finally:
            self._terminating.discard(sandbox_id)

    async def terminate(self, sandbox_id: str) -> None:
        await self._kill_quiet(sandbox_id)
        # deliberate teardown also resets supervision history: an
        # operator terminating (or re-provisioning) a sandbox starts it
        # with a clean crash ledger
        self._crashes.pop(sandbox_id, None)
        self._crash_looping.discard(sandbox_id)

    async def aclose(self) -> None:
        # watchers first: one sleeping out a crash backoff would otherwise
        # respawn its sandbox mid-teardown (its id is absent from _procs,
        # so the terminate loop below cannot see the respawn coming)
        for watcher in list(self._watchers.values()):
            watcher.cancel()
        self._watchers.clear()
        for sandbox_id in list(self._procs):
            await self.terminate(sandbox_id)
