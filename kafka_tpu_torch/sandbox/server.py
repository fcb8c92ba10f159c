"""The sandbox-side server: what runs INSIDE a sandbox.

The reference's sandboxes are Daytona cloud VMs baked from a snapshot image
whose contents are out-of-repo; the app only speaks their HTTP protocol
(`GET /health`, `POST /claim`, `POST /run` streaming SSE — SURVEY §5.8).
This module implements that protocol in-tree as an aiohttp app, so the
whole sandbox tier runs end-to-end locally: the manager spawns one of these
as a subprocess per thread (sandbox/process.py) the way the reference
provisions a VM per thread.

Tools served:
  * `create_shell` / `shell_exec` — persistent bash sessions (stdout+stderr
    merged, streamed line-by-line; reference server_tools/shell.py)
  * `notebook_run_cell` — persistent Python namespace per kernel with
    stdout capture and last-expression echo (reference notebook.py)
  * `reset` clears shells/kernels; `claim` binds a thread config.

SSE framing: `data: {json ToolEvent}` frames, terminated by `data: [DONE]`
— byte-compatible with what LocalSandbox parses.
"""

from __future__ import annotations

import argparse
import ast
import asyncio
import contextlib
import io
import json
import logging
import os
import uuid
from typing import Any, AsyncIterator, Dict, Optional

from aiohttp import web

# Importing the failpoint module arms any KAFKA_TORCH_FAILPOINTS spec from
# the environment (load_env at module bottom) — this is how a spec armed
# in the parent reaches the sandbox subprocess (process.py spawns with
# failpoints.subprocess_env()).  kafka_tpu_torch.failpoints is import-light by
# design: no torch, nothing heavy enters the sandbox process.  The tracing
# module is import-light for the same reason: /run payloads carry the
# parent's trace context, the spans recorded HERE (the child side of the
# PID boundary) ship back as a trailing {"kind": "spans"} SSE frame.
from .. import tracing
from ..failpoints import failpoint

logger = logging.getLogger("kafka_tpu_torch.sandbox.server")

SBX_KEY = web.AppKey("sandbox_state", dict)


class ShellSession:
    """One persistent bash process with merged stdout/stderr."""

    def __init__(self, shell_id: str):
        self.shell_id = shell_id
        self.proc: Optional[asyncio.subprocess.Process] = None
        self._lock = asyncio.Lock()
        self._needs_respawn = False

    async def start(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
        self.proc = await asyncio.create_subprocess_exec(
            "bash", "--noprofile", "--norc", "-s",
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
        )

    async def exec(
        self, command: str, timeout: float = 30.0
    ) -> AsyncIterator[Dict[str, Any]]:
        """Run one command, yielding output lines then a terminal result.

        Commands run directly in the persistent shell (not a subshell) so
        state like `cd`/exports persists across calls. Recovery invariants:

        * a shell-terminating command (`exit 3`, a crash) ends the process
          before the sentinel prints — the shell's own exit status becomes
          the command's exit code and the next exec() respawns the shell;
        * a command that leaves the shell in an unknown state (timeout, or
          the HTTP client disconnecting mid-stream, which cancels this
          generator at a yield) is killed in the `finally` below — no
          `await` there, so it runs even under CancelledError/GeneratorExit
          — and the next exec() respawns.
        """
        async with self._lock:  # one command at a time per shell
            if (self._needs_respawn or self.proc is None
                    or self.proc.returncode is not None):
                await self.start()
                self._needs_respawn = False
            assert self.proc.stdin is not None and self.proc.stdout is not None
            # Per-exec random sentinel: output lines can never spoof it.
            # The printf SPLITS the sentinel across two arguments so the
            # contiguous sentinel string never appears in the command text
            # itself — a stdin-consuming command (`cat`) that swallows and
            # echoes the printf line as data therefore cannot false-match;
            # only the expanded printf output contains the joined sentinel.
            token = uuid.uuid4().hex
            sentinel = f"__KAFKA_TORCH_DONE_{token}__"
            sentinel_cmd = (
                f'\nprintf "%s%s %s\\n" "__KAFKA_TORCH_DONE_" "{token}__" "$?"\n'
            )
            # True while the shell may still be mid-command; cleared just
            # before the terminal yield so a consumer that stops at the
            # terminal event doesn't get its healthy shell killed.
            dirty = True
            try:
                try:
                    self.proc.stdin.write((command + sentinel_cmd).encode())
                    await self.proc.stdin.drain()
                except (BrokenPipeError, ConnectionResetError):
                    # the pipe may break before the child is reaped
                    # (returncode still None), so flag the respawn
                    # explicitly rather than relying on returncode
                    self._needs_respawn = True
                    dirty = False
                    yield {"kind": "error",
                           "data": "shell was dead; respawning — retry"}
                    return
                lines: list = []
                exit_code: Optional[int] = None
                try:
                    while True:
                        line = await asyncio.wait_for(
                            self.proc.stdout.readline(), timeout=timeout
                        )
                        if not line:  # stdout EOF: shell exited (`exit N`)…
                            try:
                                exit_code = await asyncio.wait_for(
                                    self.proc.wait(), timeout=5.0
                                )
                            except asyncio.TimeoutError:
                                # …or bash closed its own stdout but lives
                                # on (e.g. `exec >&-`) — unusable either
                                # way; kill rather than hold the lock
                                self.proc.kill()
                                exit_code = await self.proc.wait()
                            break
                        text = line.decode(errors="replace")
                        # match mid-line too: output without a trailing
                        # newline shares a line with the sentinel printf
                        idx = text.find(sentinel)
                        if idx != -1:
                            if idx > 0:
                                lines.append(text[:idx])
                                yield {"kind": "delta", "data": text[:idx]}
                            try:
                                exit_code = int(text[idx:].split()[1])
                            except (IndexError, ValueError):
                                exit_code = -1
                            break
                        lines.append(text)
                        yield {"kind": "delta", "data": text}
                except asyncio.TimeoutError:
                    # dirty stays True: the shell may still be running the
                    # command; the finally kills it, next exec respawns
                    yield {
                        "kind": "error",
                        "data": f"command timed out after {timeout:.0f}s "
                                f"(partial output: {''.join(lines)[-2000:]!r})",
                    }
                    return
                output = "".join(lines)
                result = output if exit_code == 0 else (
                    f"{output}\n[exit code: {exit_code}]"
                )
                dirty = False
                yield {"kind": "result", "data": result}
            finally:
                if dirty:
                    self._needs_respawn = True
                    if self.proc is not None and self.proc.returncode is None:
                        self.proc.kill()

    def close(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()


class NotebookKernel:
    """Persistent exec namespace with stdout capture + last-expr echo."""

    def __init__(self, kernel_id: str):
        self.kernel_id = kernel_id
        self.ns: Dict[str, Any] = {"__name__": "__main__"}

    def run_cell(self, code: str) -> str:
        buf = io.StringIO()
        try:
            tree = ast.parse(code, mode="exec")
        except SyntaxError as e:
            raise RuntimeError(f"SyntaxError: {e}") from e
        last_expr: Optional[ast.Expression] = None
        if tree.body and isinstance(tree.body[-1], ast.Expr):
            last_expr = ast.Expression(tree.body.pop().value)
        with contextlib.redirect_stdout(buf):
            exec(compile(tree, "<cell>", "exec"), self.ns)  # noqa: S102
            if last_expr is not None:
                value = eval(compile(last_expr, "<cell>", "eval"), self.ns)  # noqa: S307
                if value is not None:
                    print(repr(value), file=buf)
        return buf.getvalue()


def create_sandbox_app(sandbox_id: Optional[str] = None) -> web.Application:
    app = web.Application()
    app[SBX_KEY] = {
        "sandbox_id": sandbox_id or f"sbx-{uuid.uuid4().hex[:12]}",
        "claimed": False,
        "claim_config": None,
        "shells": {},  # shell_id -> ShellSession
        "kernels": {},  # kernel_id -> NotebookKernel
    }
    r = app.router
    r.add_get("/health", health)
    r.add_post("/claim", claim)
    r.add_post("/run", run_tool)
    r.add_post("/reset", reset)
    app.on_cleanup.append(_cleanup)
    return app


async def _cleanup(app: web.Application) -> None:
    for shell in app[SBX_KEY]["shells"].values():
        shell.close()


async def health(request: web.Request) -> web.Response:
    s = request.app[SBX_KEY]
    return web.json_response({
        "healthy": True,
        "claimed": s["claimed"],
        "sandbox_id": s["sandbox_id"],
        "shells": sorted(s["shells"]),
        "kernels": sorted(s["kernels"]),
    })


async def claim(request: web.Request) -> web.Response:
    s = request.app[SBX_KEY]
    try:
        config = await request.json()
    except Exception:
        # a malformed body must not become a real (keyless, threadless)
        # claim that then 409-blocks the legitimate owner
        return web.json_response(
            {"claimed": False, "error": "claim body must be a JSON object"},
            status=400,
        )
    if not isinstance(config, dict):
        return web.json_response(
            {"claimed": False, "error": "claim body must be a JSON object"},
            status=400,
        )
    existing = s["claim_config"] or {}
    existing_key = existing.get("vm_api_key")
    if s["claimed"]:
        if existing_key:
            # Once claimed with a key, re-claiming (which would overwrite
            # the claim config, including the key) itself requires the key
            # — otherwise an unauthenticated empty claim wipes the auth
            # contract. A key holder may refresh without a thread_id.
            presented = config.get("vm_api_key")
            header = request.headers.get("Authorization")
            if presented != existing_key and header != f"Bearer {existing_key}":
                return web.json_response(
                    {"claimed": False,
                     "error": "missing or invalid vm_api_key"},
                    status=401,
                )
            if config.get("thread_id") not in (None, existing.get("thread_id")):
                return web.json_response(
                    {"claimed": False,
                     "error": "already claimed by another thread"},
                    status=409,
                )
        # Keyless claim: only the exact same thread (or anyone, when no
        # thread owns it) may overwrite the claim config — a claim
        # presenting a NEW key must not be able to take over and lock the
        # keyless owner out.
        elif (existing.get("thread_id") is not None
              and config.get("thread_id") != existing.get("thread_id")):
            return web.json_response(
                {"claimed": False,
                 "error": "already claimed by another thread"},
                status=409,
            )
    # Merge rather than replace: a key-holder refresh that authenticated
    # via the Authorization header (body without vm_api_key) must not wipe
    # the stored key — that would disable /run//reset auth; same for an
    # omitted thread_id erasing the thread binding.
    merged = dict(config)
    for sticky in ("vm_api_key", "thread_id"):
        if merged.get(sticky) is None and existing.get(sticky) is not None:
            merged[sticky] = existing[sticky]
    s["claimed"] = True
    s["claim_config"] = merged
    return web.json_response({"claimed": True, "sandbox_id": s["sandbox_id"]})


def _auth_error(request: web.Request) -> Optional[web.Response]:
    """Enforce the claim-config contract: once a claim carries a
    vm_api_key, /run and /reset require it as a Bearer token."""
    s = request.app[SBX_KEY]
    key = (s["claim_config"] or {}).get("vm_api_key")
    if not key:
        return None
    if request.headers.get("Authorization") == f"Bearer {key}":
        return None
    return web.json_response(
        {"error": "missing or invalid vm_api_key"}, status=401
    )


async def reset(request: web.Request) -> web.Response:
    err = _auth_error(request)
    if err is not None:
        return err
    s = request.app[SBX_KEY]
    for shell in s["shells"].values():
        shell.close()
    s["shells"].clear()
    s["kernels"].clear()
    s["claimed"] = False
    s["claim_config"] = None
    return web.json_response({"reset": True})


async def run_tool(request: web.Request) -> web.StreamResponse:
    err = _auth_error(request)
    if err is not None:
        return err
    s = request.app[SBX_KEY]
    body = await request.json()
    name = body.get("tool") or body.get("name")
    args = body.get("arguments") or {}
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            args = {"_raw": args}

    resp = web.StreamResponse(
        status=200,
        headers={"Content-Type": "text/event-stream",
                 "Cache-Control": "no-cache"},
    )
    await resp.prepare(request)

    async def send(event: Dict[str, Any]) -> None:
        await resp.write(
            b"data: " + json.dumps(event, separators=(",", ":")).encode()
            + b"\n\n"
        )

    # child-side span collection: present iff the parent traced this
    # request (the /run payload carries its context).  Spans recorded here
    # live in THIS process; they ship back after the terminal event.
    collector = tracing.child_collector(body.get("trace"))
    span_cm = (
        collector.span(
            "sandbox.exec",
            attrs={"tool": name, "pid": os.getpid(),
                   "sandbox_id": s["sandbox_id"]},
        )
        if collector is not None else contextlib.nullcontext()
    )
    try:
        # chaos seam INSIDE the sandbox process: `error` degrades to a
        # terminal error event on the stream; `exit` simulates the whole
        # subprocess crashing mid-tool (the client sees the stream die and
        # must surface exactly one terminal error — sandbox/local.py)
        with span_cm:
            await _run_named_tool(s, name, args, send)
    except Exception as e:
        logger.exception("sandbox tool failed")
        with contextlib.suppress(Exception):
            await send({"kind": "error", "data": f"{type(e).__name__}: {e}"})
    if collector is not None and collector.spans:
        # trailing frame, before [DONE]: the parent's LocalSandbox stitches
        # these into its trace by trace id and drops them from tool output
        with contextlib.suppress(Exception):
            await send({"kind": "spans", "data": collector.export()})
    with contextlib.suppress(Exception):
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
    return resp


async def _run_named_tool(s, name, args, send) -> None:
    """Dispatch one named sandbox tool, streaming events through `send`."""
    failpoint("sandbox.server.exec")
    if name == "create_shell":
        shell_id = args.get("shell_id") or f"shell-{len(s['shells'])}"
        if shell_id not in s["shells"]:
            session = ShellSession(shell_id)
            await session.start()
            s["shells"][shell_id] = session
        await send({"kind": "result",
                    "data": json.dumps({"shell_id": shell_id})})
    elif name == "shell_exec":
        shell_id = args.get("shell_id") or "default"
        if shell_id not in s["shells"]:
            session = ShellSession(shell_id)
            await session.start()
            s["shells"][shell_id] = session
        timeout = float(args.get("timeout", 30.0))
        async for ev in s["shells"][shell_id].exec(
            args.get("command", ""), timeout=timeout
        ):
            await send(ev)
    elif name == "notebook_run_cell":
        kernel_id = args.get("kernel_id") or "default"
        kernel = s["kernels"].setdefault(
            kernel_id, NotebookKernel(kernel_id)
        )
        timeout = float(args.get("timeout", 300.0))
        try:
            out = await asyncio.wait_for(
                asyncio.to_thread(kernel.run_cell, args.get("code", "")),
                timeout=timeout,
            )
            await send({"kind": "result", "data": out})
        except asyncio.TimeoutError:
            await send({"kind": "error",
                        "data": f"cell timed out after {timeout:.0f}s"})
        except Exception as e:
            await send({"kind": "error",
                        "data": f"{type(e).__name__}: {e}"})
    else:
        await send({"kind": "error", "data": f"unknown sandbox tool: {name}"})


def main() -> None:
    p = argparse.ArgumentParser(prog="kafka_tpu_torch.sandbox.server")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--sandbox-id", default=None)
    args = p.parse_args()
    # KAFKA_TORCH_LOG_FORMAT=json inherited from the parent process
    # (tracing.subprocess_env): sandbox log lines carry the same
    # trace_id/thread_id correlation keys as the server's
    from ..logs import setup_logging

    setup_logging()
    web.run_app(
        create_sandbox_app(args.sandbox_id), host=args.host, port=args.port
    )


if __name__ == "__main__":
    main()
