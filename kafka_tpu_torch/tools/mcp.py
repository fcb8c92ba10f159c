"""Native MCP (Model Context Protocol) client.

Parity: reference src/tools/agent.py:63-380 (MCPConnection — stdio +
streamable-HTTP with SSE fallback transports, tool discovery to OpenAI
format, streamed call results). The reference delegates the protocol to the
`mcp` PyPI package; this environment does not ship it, so the protocol is
implemented natively here: JSON-RPC 2.0 over

  * stdio            — newline-delimited JSON to a subprocess (MCP stdio
                       transport framing),
  * streamable-http  — POST per message; responses arrive as JSON or as a
                       text/event-stream; session continuity via the
                       Mcp-Session-Id header,
  * sse (fallback)   — legacy HTTP+SSE transport: GET opens the event
                       stream, the first `endpoint` event names the POST
                       URL, responses arrive on the stream.

Connect failures raise MCPClientError; AgentToolProvider catches and skips
(an unreachable tool server must never take down serving — reference
src/tools/agent.py:494-496).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional
from urllib.parse import urljoin

from .types import MCPServerConfig, Tool, ToolEvent

logger = logging.getLogger("kafka_tpu_torch.tools.mcp")

PROTOCOL_VERSION = "2025-03-26"
CLIENT_INFO = {"name": "kafka-tpu", "version": "0.2.0"}


class MCPClientError(Exception):
    """Raised on transport/protocol failures talking to an MCP server."""


# ---------------------------------------------------------------------------
# Transports. Each exposes: start(), send(msg: dict), recv() -> dict, close().
# recv() yields every inbound JSON-RPC message (responses + notifications);
# the connection layer routes them.
# ---------------------------------------------------------------------------


class _StdioTransport:
    """MCP stdio framing: one JSON-RPC message per line on stdin/stdout."""

    def __init__(self, command: str, args: List[str], env: Dict[str, str]):
        self._command = command
        self._args = args
        self._env = env
        self._proc: Optional[asyncio.subprocess.Process] = None

    async def start(self) -> None:
        env = dict(os.environ)
        env.update(self._env)
        try:
            self._proc = await asyncio.create_subprocess_exec(
                self._command,
                *self._args,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
                env=env,
            )
        except (OSError, ValueError) as e:
            raise MCPClientError(f"failed to spawn {self._command}: {e}")

    async def send(self, msg: Dict[str, Any]) -> None:
        proc = self._proc
        if proc is None or proc.stdin is None:
            raise MCPClientError("stdio transport not started")
        if proc.returncode is not None:
            raise MCPClientError(
                f"MCP server process exited (code {proc.returncode})"
            )
        proc.stdin.write(json.dumps(msg).encode() + b"\n")
        await proc.stdin.drain()

    async def recv(self) -> Dict[str, Any]:
        proc = self._proc
        if proc is None or proc.stdout is None:
            raise MCPClientError("stdio transport not started")
        while True:
            line = await proc.stdout.readline()
            if not line:
                raise MCPClientError("MCP server closed stdout")
            line = line.strip()
            if not line:
                continue
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                # servers may emit stray diagnostics on stdout; skip them
                logger.debug("skipping non-JSON stdio line: %r", line[:200])

    async def close(self) -> None:
        proc = self._proc
        self._proc = None
        if proc is None:
            return
        with contextlib.suppress(Exception):
            if proc.stdin:
                proc.stdin.close()
        if proc.returncode is None:
            with contextlib.suppress(Exception):
                proc.terminate()
            try:
                await asyncio.wait_for(proc.wait(), timeout=3.0)
            except (asyncio.TimeoutError, Exception):
                with contextlib.suppress(Exception):
                    proc.kill()
        # drop the pipe transports now, not at GC after the loop closes
        # (late GC raises "Event loop is closed" from transport __del__)
        with contextlib.suppress(Exception):
            proc._transport.close()  # type: ignore[attr-defined]


class _StreamableHTTPTransport:
    """MCP streamable-HTTP: POST each message; parse JSON or SSE replies."""

    def __init__(self, url: str, timeout: float = 30.0):
        self._url = url
        self._timeout = timeout
        self._client: Any = None
        self._session_id: Optional[str] = None
        self._inbox: asyncio.Queue = asyncio.Queue()

    async def start(self) -> None:
        import httpx

        self._client = httpx.AsyncClient(timeout=self._timeout)

    def _headers(self) -> Dict[str, str]:
        h = {
            "Content-Type": "application/json",
            "Accept": "application/json, text/event-stream",
        }
        if self._session_id:
            h["Mcp-Session-Id"] = self._session_id
        return h

    async def send(self, msg: Dict[str, Any]) -> None:
        if self._client is None:
            raise MCPClientError("http transport not started")
        try:
            resp = await self._client.post(
                self._url, json=msg, headers=self._headers()
            )
        except Exception as e:
            raise MCPClientError(f"POST {self._url} failed: {e}")
        sid = resp.headers.get("mcp-session-id")
        if sid:
            self._session_id = sid
        if resp.status_code in (202, 204):
            return  # notification accepted, no body
        if resp.status_code >= 400:
            raise MCPClientError(
                f"MCP server returned HTTP {resp.status_code}: "
                f"{resp.text[:300]}"
            )
        ctype = resp.headers.get("content-type", "")
        if "text/event-stream" in ctype:
            for data in _iter_sse_datas(resp.text):
                with contextlib.suppress(json.JSONDecodeError):
                    await self._inbox.put(json.loads(data))
        elif resp.content:
            try:
                body = resp.json()
            except json.JSONDecodeError:
                raise MCPClientError(
                    f"MCP server sent non-JSON body: {resp.text[:300]}"
                )
            if isinstance(body, list):
                for item in body:
                    await self._inbox.put(item)
            else:
                await self._inbox.put(body)

    async def recv(self) -> Dict[str, Any]:
        return await self._inbox.get()

    async def close(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            with contextlib.suppress(Exception):
                await client.aclose()


class _SSETransport:
    """Legacy HTTP+SSE transport: GET stream + `endpoint` event for POSTs."""

    def __init__(self, url: str, timeout: float = 30.0):
        self._url = url
        self._timeout = timeout
        self._client: Any = None
        self._post_url: Optional[str] = None
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._reader_task: Optional[asyncio.Task] = None
        self._endpoint_ready = asyncio.Event()
        self._reader_error: Optional[Exception] = None

    async def start(self) -> None:
        import httpx

        self._client = httpx.AsyncClient(timeout=httpx.Timeout(self._timeout,
                                                               read=None))
        self._reader_task = asyncio.create_task(self._read_stream())
        try:
            await asyncio.wait_for(
                self._endpoint_ready.wait(), timeout=self._timeout
            )
        except asyncio.TimeoutError:
            await self.close()
            raise MCPClientError(
                f"SSE endpoint event not received from {self._url}"
                + (f" ({self._reader_error})" if self._reader_error else "")
            )
        if self._reader_error is not None:
            err = self._reader_error
            await self.close()
            raise MCPClientError(f"SSE stream failed: {err}")

    async def _read_stream(self) -> None:
        try:
            async with self._client.stream(
                "GET", self._url, headers={"Accept": "text/event-stream"}
            ) as resp:
                if resp.status_code >= 400:
                    raise MCPClientError(
                        f"SSE GET returned HTTP {resp.status_code}"
                    )
                event, datas = "message", []
                async for raw_line in resp.aiter_lines():
                    line = raw_line.rstrip("\r")
                    if line == "":
                        if datas:
                            self._dispatch(event, "\n".join(datas))
                        event, datas = "message", []
                    elif line.startswith("event:"):
                        event = line[6:].strip()
                    elif line.startswith("data:"):
                        datas.append(line[5:].lstrip())
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._reader_error = e
            self._endpoint_ready.set()  # unblock start()

    def _dispatch(self, event: str, data: str) -> None:
        if event == "endpoint":
            self._post_url = urljoin(self._url, data.strip())
            self._endpoint_ready.set()
        else:
            with contextlib.suppress(json.JSONDecodeError):
                self._inbox.put_nowait(json.loads(data))

    async def send(self, msg: Dict[str, Any]) -> None:
        if self._client is None or self._post_url is None:
            raise MCPClientError("SSE transport not started")
        try:
            resp = await self._client.post(self._post_url, json=msg)
        except Exception as e:
            raise MCPClientError(f"POST {self._post_url} failed: {e}")
        if resp.status_code >= 400:
            raise MCPClientError(
                f"MCP server returned HTTP {resp.status_code}"
            )

    async def recv(self) -> Dict[str, Any]:
        return await self._inbox.get()

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._reader_task
            self._reader_task = None
        client, self._client = self._client, None
        if client is not None:
            with contextlib.suppress(Exception):
                await client.aclose()


def _iter_sse_datas(text: str):
    """Yield the data payload of each event in a buffered SSE body."""
    datas: List[str] = []
    for raw_line in text.splitlines() + [""]:
        line = raw_line.rstrip("\r")
        if line == "":
            if datas:
                yield "\n".join(datas)
            datas = []
        elif line.startswith("data:"):
            datas.append(line[5:].lstrip())


# ---------------------------------------------------------------------------
# Connection
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    future: asyncio.Future
    progress: Optional[asyncio.Queue] = None


class MCPConnection:
    """Lifecycle + JSON-RPC routing for one MCP server.

    connect(): start transport, `initialize` handshake, `notifications/
    initialized`, `tools/list` discovery. discovered_tools() returns `Tool`
    objects whose handlers stream through call_tool_stream().
    """

    def __init__(self, config: MCPServerConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        self.connected = False
        self.server_info: Dict[str, Any] = {}
        self._transport: Any = None
        self._tools: List[Tool] = []
        self._pending: Dict[Any, _Pending] = {}
        self._next_id = 0
        self._router_task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------

    async def connect(self) -> None:
        cfg = self.config
        transport = cfg.effective_transport
        if transport == "stdio":
            if not cfg.command:
                raise MCPClientError(
                    f"MCP server {cfg.name}: stdio transport needs a command"
                )
            self._transport = _StdioTransport(cfg.command, cfg.args, cfg.env)
            await self._open_session()
        elif cfg.url:
            # streamable-HTTP first, SSE fallback (reference
            # src/tools/agent.py:113-162)
            try:
                self._transport = _StreamableHTTPTransport(
                    cfg.url, self.timeout
                )
                await self._open_session()
            except Exception as first_err:
                await self._teardown()
                logger.info(
                    "MCP %s: streamable-http failed (%s); trying SSE",
                    cfg.name, first_err,
                )
                self._transport = _SSETransport(cfg.url, self.timeout)
                try:
                    await self._open_session()
                except Exception:
                    await self._teardown()
                    raise
        else:
            raise MCPClientError(
                f"MCP server {cfg.name} must have either 'command' or 'url'"
            )
        self.connected = True

    async def _open_session(self) -> None:
        await self._transport.start()
        self._router_task = asyncio.create_task(self._route_inbound())
        try:
            init = await self._request(
                "initialize",
                {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {},
                    "clientInfo": CLIENT_INFO,
                },
            )
            self.server_info = init.get("serverInfo", {})
            await self._notify("notifications/initialized", {})
            await self._discover_tools()
        except Exception:
            await self._teardown()
            raise

    async def disconnect(self) -> None:
        self.connected = False
        await self._teardown()

    async def _teardown(self) -> None:
        if self._router_task is not None:
            self._router_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._router_task
            self._router_task = None
        for pending in self._pending.values():
            if not pending.future.done():
                pending.future.set_exception(
                    MCPClientError("connection closed")
                )
        self._pending.clear()
        transport, self._transport = self._transport, None
        if transport is not None:
            with contextlib.suppress(Exception):
                await transport.close()

    # -- JSON-RPC plumbing ---------------------------------------------

    async def _route_inbound(self) -> None:
        try:
            while True:
                msg = await self._transport.recv()
                if not isinstance(msg, dict):
                    continue
                if "id" in msg and ("result" in msg or "error" in msg):
                    pending = self._pending.pop(msg["id"], None)
                    if pending is not None and not pending.future.done():
                        if "error" in msg:
                            err = msg["error"]
                            pending.future.set_exception(MCPClientError(
                                f"{err.get('message', err)} "
                                f"(code {err.get('code')})"
                            ))
                        else:
                            pending.future.set_result(msg.get("result"))
                elif msg.get("method") == "notifications/progress":
                    params = msg.get("params", {})
                    tok = params.get("progressToken")
                    for pending in self._pending.values():
                        if pending.progress is not None and (
                            tok is None or pending.progress_token == tok
                        ):
                            pending.progress.put_nowait(params)
                # other notifications (logging, list_changed) are ignored
        except asyncio.CancelledError:
            raise
        except Exception as e:
            for pending in self._pending.values():
                if not pending.future.done():
                    pending.future.set_exception(
                        MCPClientError(f"transport failed: {e}")
                    )
            self._pending.clear()

    async def _request(
        self,
        method: str,
        params: Dict[str, Any],
        progress: Optional[asyncio.Queue] = None,
        timeout: Optional[float] = None,
    ) -> Any:
        self._next_id += 1
        msg_id = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        pending = _Pending(future=fut, progress=progress)
        pending.progress_token = msg_id  # type: ignore[attr-defined]
        self._pending[msg_id] = pending
        req = {"jsonrpc": "2.0", "id": msg_id, "method": method,
               "params": params}
        if progress is not None:
            req["params"] = dict(params)
            req["params"].setdefault("_meta", {})["progressToken"] = msg_id
        try:
            await self._transport.send(req)
            return await asyncio.wait_for(fut, timeout or self.timeout)
        except asyncio.TimeoutError:
            raise MCPClientError(f"{method} timed out after "
                                 f"{timeout or self.timeout}s")
        finally:
            self._pending.pop(msg_id, None)

    async def _notify(self, method: str, params: Dict[str, Any]) -> None:
        await self._transport.send(
            {"jsonrpc": "2.0", "method": method, "params": params}
        )

    # -- tools ---------------------------------------------------------

    async def _discover_tools(self) -> None:
        result = await self._request("tools/list", {})
        self._tools = []
        for td in result.get("tools", []):
            name = td.get("name")
            if not name:
                continue
            self._tools.append(Tool(
                name=name,
                description=td.get("description") or "",
                parameters=td.get("inputSchema")
                or {"type": "object", "properties": {}},
                handler=None,  # dispatched via call_tool_stream
                source="mcp",
                metadata={"mcp_server": self.config.name},
            ))

    def discovered_tools(self) -> List[Tool]:
        """Tools with streaming handlers bound to this connection."""
        bound = []
        for t in self._tools:
            bound.append(Tool(
                name=t.name,
                description=t.description,
                parameters=t.parameters,
                handler=self._make_handler(t.name),
                source="mcp",
                metadata=dict(t.metadata),
            ))
        return bound

    def _make_handler(self, tool_name: str):
        async def handler(**arguments):
            async for ev in self.call_tool_stream(tool_name, arguments):
                yield ev

        handler.__name__ = f"mcp_{tool_name}"
        return handler

    async def call_tool_stream(
        self, name: str, arguments: Dict[str, Any],
        timeout: Optional[float] = None,
    ) -> AsyncIterator[ToolEvent]:
        """Invoke a tool; progress notifications stream as log events,
        the terminal result flattens MCP content blocks to text."""
        if self._transport is None:
            yield ToolEvent("error", "MCP connection closed", tool_name=name)
            return
        progress: asyncio.Queue = asyncio.Queue()
        call = asyncio.create_task(self._request(
            "tools/call", {"name": name, "arguments": arguments},
            progress=progress, timeout=timeout or max(self.timeout, 120.0),
        ))
        try:
            while not call.done():
                getter = asyncio.create_task(progress.get())
                done, _ = await asyncio.wait(
                    {call, getter}, return_when=asyncio.FIRST_COMPLETED
                )
                if getter in done:
                    params = getter.result()
                    msg = params.get("message") or (
                        f"progress {params.get('progress')}"
                        + (f"/{params['total']}" if params.get("total")
                           else "")
                    )
                    yield ToolEvent("log", msg, tool_name=name)
                else:
                    getter.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await getter
            result = call.result()
        except MCPClientError as e:
            yield ToolEvent("error", str(e), tool_name=name)
            return
        finally:
            if not call.done():
                call.cancel()
                with contextlib.suppress(Exception):
                    await call
        # drain any progress that raced the completion
        while not progress.empty():
            params = progress.get_nowait()
            if params.get("message"):
                yield ToolEvent("log", params["message"], tool_name=name)
        text = _flatten_content(result)
        if isinstance(result, dict) and result.get("isError"):
            yield ToolEvent("error", text or "tool reported an error",
                            tool_name=name)
        else:
            yield ToolEvent("result", text, tool_name=name)

    async def call_tool(self, name: str, arguments: Dict[str, Any]) -> str:
        last_err: Optional[str] = None
        async for ev in self.call_tool_stream(name, arguments):
            if ev.kind == "result":
                return ev.text()
            if ev.kind == "error":
                last_err = ev.text()
        raise MCPClientError(last_err or "tool call produced no result")


def _flatten_content(result: Any) -> str:
    """MCP tool results carry a list of content blocks; flatten to text."""
    if not isinstance(result, dict):
        return json.dumps(result) if result is not None else ""
    blocks = result.get("content")
    if blocks is None:
        sc = result.get("structuredContent")
        return json.dumps(sc) if sc is not None else json.dumps(result)
    parts: List[str] = []
    for block in blocks:
        if not isinstance(block, dict):
            parts.append(str(block))
        elif block.get("type") == "text":
            parts.append(block.get("text", ""))
        elif block.get("type") == "resource":
            res = block.get("resource", {})
            parts.append(res.get("text") or res.get("uri", ""))
        else:
            parts.append(json.dumps(block))
    return "\n".join(p for p in parts if p)
