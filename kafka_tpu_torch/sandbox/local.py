"""LocalSandbox — URL-direct HTTP sandbox client.

Parity: reference src/sandbox/local.py:18-349 — health probe (:125),
`run_tool` as POST /run with the SSE stream parsed from raw BYTES as they
arrive (:207-274; line-buffered readers add latency to streamed tool
output), and /claim (:310).  Also used to talk to subprocess sandboxes
(sandbox/process.py) and any remote implementing the same protocol.
"""

from __future__ import annotations

import json
import logging
from typing import Any, AsyncIterator, Dict, Optional

import httpx

from .. import tracing
from ..failpoints import failpoint
from ..tools.types import ToolEvent
from .base import Sandbox
from .types import SandboxConfig

logger = logging.getLogger("kafka_tpu_torch.sandbox.local")

DEFAULT_TOOL_TIMEOUT_S = 300.0


class LocalSandbox(Sandbox):
    def __init__(
        self,
        url: str,
        sandbox_id: Optional[str] = None,
        client: Optional[httpx.AsyncClient] = None,
    ):
        self.url = url.rstrip("/")
        self.sandbox_id = sandbox_id or self.url
        self._client = client or httpx.AsyncClient(timeout=None)
        self._vm_api_key: Optional[str] = None

    def _auth_headers(self) -> Dict[str, str]:
        if self._vm_api_key:
            return {"Authorization": f"Bearer {self._vm_api_key}"}
        return {}

    async def aclose(self) -> None:
        await self._client.aclose()

    # -- health --------------------------------------------------------

    async def check_health(self) -> Dict[str, Any]:
        try:
            r = await self._client.get(f"{self.url}/health", timeout=5.0)
            r.raise_for_status()
            data = r.json()
            data.setdefault("healthy", True)
            return data
        except Exception as e:
            return {"healthy": False, "claimed": False, "error": str(e)}

    # -- execution -----------------------------------------------------

    async def run_tool(
        self,
        name: str,
        arguments: Dict[str, Any],
        tool_call_id: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[ToolEvent]:
        payload = {
            "tool": name,
            "arguments": arguments,
            "tool_call_id": tool_call_id,
            # cross-process trace propagation: the sandbox records its own
            # child spans under this context and ships them back as a
            # {"kind": "spans"} frame, stitched below by trace id
            "trace": tracing.wire_context(),
        }
        timeout = timeout or DEFAULT_TOOL_TIMEOUT_S
        terminal_seen = False
        try:
            # chaos seam: an injected fault takes the transport-error path
            # below, so the agent still receives a terminal tool event
            failpoint("sandbox.exec")
            async with self._client.stream(
                "POST",
                f"{self.url}/run",
                json=payload,
                headers=self._auth_headers(),
                timeout=httpx.Timeout(10.0, read=timeout),
            ) as resp:
                if resp.status_code != 200:
                    body = (await resp.aread()).decode(errors="replace")
                    yield ToolEvent(
                        "error",
                        f"sandbox /run returned {resp.status_code}: {body[:500]}",
                        tool_name=name, tool_call_id=tool_call_id,
                    )
                    return
                # byte-level SSE parse: emit each frame the moment its
                # terminating blank line arrives (reference local.py:207-274)
                buf = b""
                async for chunk in resp.aiter_raw():
                    buf += chunk
                    while b"\n\n" in buf:
                        frame, buf = buf.split(b"\n\n", 1)
                        ev = self._parse_frame(frame, name, tool_call_id)
                        if ev is not None and ev.kind == "spans":
                            # spans recorded inside the sandbox subprocess
                            # (they trail the terminal result): stitch into
                            # the parent trace, never surface to the agent
                            if isinstance(ev.data, dict):
                                tracing.stitch(ev.data)
                            continue
                        if terminal_seen:
                            # post-terminal tail: only the spans frame above
                            # and [DONE] are expected — [DONE] ends the
                            # stream, anything else is dropped (a sandbox
                            # must not stream past its result)
                            if ev is None and b"[DONE]" in frame:
                                return
                            continue
                        if ev is None:
                            continue
                        if ev.terminal:
                            terminal_seen = True
                        yield ev
        except Exception as e:
            # httpx transport errors, malformed URLs (e.g. a sandbox whose
            # port is gone — httpx.InvalidURL subclasses Exception, not
            # HTTPError), and raw socket errors all mean the same thing to
            # the agent: this sandbox is unreachable.  UNLESS the terminal
            # event already went out — then the failure happened during the
            # post-terminal tail (spans frame / [DONE]) and surfacing it
            # would emit a SECOND terminal event for the same call.
            if terminal_seen:
                logger.debug("sandbox stream died after the terminal "
                             "event: %s", e)
                return
            yield ToolEvent(
                "error", f"sandbox connection failed: {e}",
                tool_name=name, tool_call_id=tool_call_id,
            )
            return
        if not terminal_seen:
            # stream ended without a terminal event (sandbox crashed
            # mid-tool): surface that rather than hanging the agent
            yield ToolEvent(
                "error", "sandbox stream ended without a result",
                tool_name=name, tool_call_id=tool_call_id,
            )

    def _parse_frame(
        self, frame: bytes, name: str, tool_call_id: Optional[str]
    ) -> Optional[ToolEvent]:
        for line in frame.split(b"\n"):
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                return None
            try:
                obj = json.loads(payload)
            except json.JSONDecodeError:
                logger.warning("unparseable sandbox SSE frame: %r", payload[:200])
                return None
            return ToolEvent(
                kind=obj.get("kind", "delta"),
                data=obj.get("data"),
                tool_name=name,
                tool_call_id=tool_call_id,
            )
        return None

    # -- lifecycle -----------------------------------------------------

    async def claim(self, config: SandboxConfig) -> bool:
        try:
            r = await self._client.post(
                f"{self.url}/claim", json=config.to_dict(), timeout=10.0
            )
            if r.status_code == 409:
                return False
            r.raise_for_status()
            claimed = bool(r.json().get("claimed"))
            if claimed and config.vm_api_key:
                self._vm_api_key = config.vm_api_key
            return claimed
        except Exception as e:  # unreachable/malformed sandbox == not claimed
            logger.warning("claim failed for %s: %s", self.sandbox_id, e)
            return False

    async def reset(self) -> None:
        try:
            r = await self._client.post(
                f"{self.url}/reset", headers=self._auth_headers(), timeout=10.0
            )
            r.raise_for_status()
            # only a confirmed reset releases the key — the server still
            # requires it otherwise
            self._vm_api_key = None
        except Exception as e:
            logger.warning("reset failed for %s: %s", self.sandbox_id, e)
