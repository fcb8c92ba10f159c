"""Client-side SSE reconstruction — the reference playground's consumer
contract, as a reusable Python implementation.

The serving protocol (server/sse.py) emits four event kinds over one SSE
stream: OpenAI chat chunks, streaming ``tool_result`` deltas, a
``tool_messages`` batch, and ``agent_done`` (plus ``error``), terminated by
``data: [DONE]``.  The reference's Next.js playground reconstructs a chat
transcript from that stream (playground/src/app/page.tsx:127-320); this
module implements the same reconstruction rules so that:

* examples and tests can consume the live stream exactly the way the real
  frontend does (the contract is *proved*, not assumed), and
* the in-tree playground (server/playground.html) mirrors this logic in JS.

Reconstruction rules (the page.tsx contract):

* OpenAI chunks accumulate into the trailing assistant message; a chunk id
  different from the current completion id starts a NEW assistant message
  (per-completion segmentation — one agent iteration per completion id).
* ``delta.tool_calls`` entries accumulate by ``index``: id and name
  overwrite, ``function.arguments`` string-concatenates.
* ``tool_result`` deltas append to the tool message with the same
  ``tool_call_id``, creating it (followed by a fresh empty assistant
  message) on first delta.
* ``tool_messages`` replaces the prior tool/assistant-with-tool-calls
  messages with the server's canonical batch (the durable form), again
  followed by a fresh empty assistant message.
* ``agent_done`` drops a trailing empty assistant message.
* ``[DONE]`` ends the stream.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional


class SSEMessageReconstructor:
    """Feed SSE lines (or whole payloads); read `.messages` at any point."""

    def __init__(self) -> None:
        self.messages: List[Dict[str, Any]] = []
        self.done = False
        self.errors: List[Dict[str, Any]] = []
        self._completion_id: Optional[str] = None
        self._content: List[str] = []
        self._tool_calls: Dict[int, Dict[str, str]] = {}

    # -- feeding --------------------------------------------------------

    def feed_line(self, line: str) -> None:
        line = line.rstrip("\r\n")
        if not line.startswith("data: "):
            return
        payload = line[len("data: "):]
        if payload == "[DONE]":
            self.done = True
            return
        try:
            event = json.loads(payload)
        except json.JSONDecodeError:
            return
        self.feed_event(event)

    def feed_text(self, text: str) -> None:
        for line in text.splitlines():
            self.feed_line(line)

    def feed_lines(self, lines: Iterable[str]) -> None:
        for line in lines:
            self.feed_line(line)

    # -- event handling (page.tsx:127-320 semantics) --------------------

    def feed_event(self, event: Dict[str, Any]) -> None:
        etype = event.get("type")
        if etype == "agent_done":
            self._drop_trailing_empty_assistant(require_no_tool_calls=True)
            return
        if etype == "error":
            self.errors.append(event)
            return
        if etype == "tool_result":
            self._on_tool_result(event)
            return
        if etype == "tool_messages" and event.get("messages"):
            self._on_tool_messages(event["messages"])
            return
        choice = (event.get("choices") or [None])[0]
        if choice and choice.get("delta") is not None:
            self._on_chunk(event, choice)

    # -- handlers -------------------------------------------------------

    def _last(self) -> Optional[Dict[str, Any]]:
        return self.messages[-1] if self.messages else None

    def _drop_trailing_empty_assistant(
        self, require_no_tool_calls: bool = False
    ) -> None:
        last = self._last()
        if (
            last is not None
            and last.get("role") == "assistant"
            and not last.get("content")
            and (not require_no_tool_calls or not last.get("tool_calls"))
        ):
            self.messages.pop()

    def _on_tool_result(self, event: Dict[str, Any]) -> None:
        tcid = event.get("tool_call_id")
        for msg in self.messages:
            if msg.get("role") == "tool" and msg.get("tool_call_id") == tcid:
                msg["content"] = (msg.get("content") or "") + (
                    event.get("delta") or ""
                )
                return
        # first delta for this call: drop a bare trailing assistant stub,
        # add the tool message, restart an assistant message after it
        last = self._last()
        if (
            last is not None
            and last.get("role") == "assistant"
            and not last.get("content")
            and not last.get("tool_calls")
        ):
            self.messages.pop()
        self.messages.append({
            "role": "tool",
            "content": event.get("delta") or "",
            "tool_call_id": tcid,
            "name": event.get("tool_name"),
        })
        self.messages.append({"role": "assistant", "content": ""})

    def _on_tool_messages(self, batch: List[Dict[str, Any]]) -> None:
        self._drop_trailing_empty_assistant()
        kept = [
            m for m in self.messages
            if not (
                m.get("role") == "tool"
                or (m.get("role") == "assistant" and m.get("tool_calls"))
            )
        ]
        self.messages = kept + list(batch) + [
            {"role": "assistant", "content": ""}
        ]

    def _on_chunk(self, event: Dict[str, Any], choice: Dict[str, Any]) -> None:
        delta = choice.get("delta") or {}
        chunk_id = event.get("id")
        if chunk_id and chunk_id != self._completion_id:
            if self._completion_id is not None:
                # new agent iteration: reset accumulators; keep the previous
                # assistant message if it holds anything
                self._content = []
                self._tool_calls = {}
                last = self._last()
                if (
                    last is not None
                    and last.get("role") == "assistant"
                    and (last.get("content") or last.get("tool_calls"))
                ):
                    self.messages.append({"role": "assistant", "content": ""})
            self._completion_id = chunk_id

        if self._last() is None or self._last().get("role") != "assistant":
            self.messages.append({"role": "assistant", "content": ""})

        if delta.get("tool_calls"):
            for tc in delta["tool_calls"]:
                idx = tc.get("index", 0)
                acc = self._tool_calls.setdefault(
                    idx, {"id": "", "name": "", "arguments": ""}
                )
                if tc.get("id"):
                    acc["id"] = tc["id"]
                fn = tc.get("function") or {}
                if fn.get("name"):
                    acc["name"] = fn["name"]
                if fn.get("arguments"):
                    acc["arguments"] += fn["arguments"]
            self._last()["tool_calls"] = self._tool_calls_list()

        if delta.get("content"):
            self._content.append(delta["content"])
            self._last()["content"] = "".join(self._content)

        if choice.get("finish_reason") == "tool_calls":
            last = self._last()
            last["content"] = last.get("content") or None
            last["tool_calls"] = self._tool_calls_list()

    def _tool_calls_list(self) -> List[Dict[str, Any]]:
        return [
            {
                "id": acc["id"],
                "type": "function",
                "function": {"name": acc["name"],
                             "arguments": acc["arguments"]},
            }
            for acc in self._tool_calls.values()
        ]
