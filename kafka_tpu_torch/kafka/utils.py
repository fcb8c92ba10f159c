"""Kafka-layer helpers: event-stream re-accumulation and playbook tables
(copied from kafka_tpu/kafka/utils.py).

`MessageAccumulator` rebuilds persistable `Message`s from the live event
stream of a run; `playbooks_to_markdown` renders per-thread playbooks into
the markdown table the prompt tier embeds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.toolcalls import ToolCallAccumulator
from ..core.types import Message


class MessageAccumulator:
    """Folds the agent event protocol back into ordered `Message`s."""

    def __init__(self) -> None:
        self.messages: List[Message] = []
        self._content: List[str] = []
        self._acc = ToolCallAccumulator()
        self._current_id: Optional[str] = None
        self.final_content: str = ""
        self.done_reason: Optional[str] = None

    def add_event(self, event: Dict[str, Any]) -> None:
        etype = event.get("type")
        if event.get("object") == "chat.completion.chunk":
            self._add_chunk(event)
        elif etype == "tool_result":
            if event.get("done"):
                kind = event.get("kind")
                data = event.get("data")
                text = data if isinstance(data, str) else str(data)
                content = f"Error: {text}" if kind == "error" else text
                self.messages.append(
                    Message(
                        role="tool",
                        content=content,
                        tool_call_id=event.get("tool_call_id"),
                    )
                )
        elif etype == "agent_done":
            self._flush_assistant()
            self.final_content = event.get("final_content") or ""
            self.done_reason = event.get("reason")

    def _add_chunk(self, chunk: Dict[str, Any]) -> None:
        cid = chunk.get("id")
        if self._current_id is not None and cid != self._current_id:
            self._flush_assistant()
        self._current_id = cid
        for choice in chunk.get("choices", []):
            delta = choice.get("delta", {})
            if delta.get("content"):
                self._content.append(delta["content"])
            self._acc.add_deltas(delta.get("tool_calls"))
            if choice.get("finish_reason"):
                self._flush_assistant()

    def _flush_assistant(self) -> None:
        content = "".join(self._content)
        tool_calls = self._acc.result() if self._acc.has_calls else None
        if content or tool_calls:
            self.messages.append(
                Message(
                    role="assistant",
                    content=content or None,
                    tool_calls=tool_calls,
                )
            )
        self._content = []
        self._acc.clear()
        self._current_id = None


def playbooks_to_markdown(playbooks: List[Dict[str, Any]]) -> str:
    """Render playbooks as a markdown section for the system prompt."""
    if not playbooks:
        return ""
    lines = [
        "# Playbooks",
        "",
        "Follow the matching playbook when a task fits its trigger:",
        "",
        "| Playbook | When to use | Steps |",
        "|---|---|---|",
    ]
    for pb in playbooks:
        name = str(pb.get("name", "")).replace("|", "\\|")
        trigger = str(pb.get("trigger", pb.get("description", ""))).replace("|", "\\|")
        content = str(pb.get("content", "")).replace("\n", "<br>").replace("|", "\\|")
        lines.append(f"| {name} | {trigger} | {content} |")
    return "\n".join(lines)
