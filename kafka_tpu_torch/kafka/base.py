"""KafkaAgent — the orchestrator contract + thread-history replay.

Parity: reference src/kafka/base.py:24-319.  `run` executes the agent loop
statelessly; `run_with_thread` adds durable thread semantics: fetch
history, sanitize, persist the new inbound messages, stream the run while
re-accumulating every streamed delta/tool-call into `Message`s, and persist
those at the end (:171-310).  The thread store is the recovery log — a
crashed server replays the thread and the TPU engine re-prefills its KV
cache from it (SURVEY §5.4).

Copied from kafka_tpu/kafka/base.py; the port's engine re-prefills from
the thread the same way.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, AsyncIterator, Dict, List, Optional

from ..core.sanitize import sanitize_messages_for_openai
from ..core.types import Message
from ..db.base import DBClient
from .utils import MessageAccumulator

logger = logging.getLogger("kafka_tpu_torch.kafka")


class KafkaAgent(abc.ABC):
    """Orchestrator ABC: initialize/cleanup/get_tools/run/run_with_thread."""

    #: thread store used by run_with_thread (set by the implementation)
    thread_db: Optional[DBClient] = None

    @abc.abstractmethod
    async def initialize(self) -> None:
        """Wire providers (LLM, tools, prompts, compaction). Idempotent."""

    async def cleanup(self) -> None:
        """Release connections. Idempotent."""

    @abc.abstractmethod
    def get_tools(self) -> List[Dict[str, Any]]:
        """Available tools in OpenAI format."""

    @abc.abstractmethod
    def run(
        self,
        messages: List[Any],
        model: Optional[str] = None,
        temperature: float = 0.7,
        max_tokens: Optional[int] = None,
        **kwargs: Any,
    ) -> AsyncIterator[Dict[str, Any]]:
        """Stateless agent run over `messages`; yields the event protocol
        (OpenAI chunks / tool_result / agent_done — agents/base.py)."""

    async def run_with_thread(
        self,
        thread_id: str,
        new_messages: List[Any],
        model: Optional[str] = None,
        temperature: float = 0.7,
        max_tokens: Optional[int] = None,
        **kwargs: Any,
    ) -> AsyncIterator[Dict[str, Any]]:
        """Run with durable thread history (reference base.py:171-310).

        History and the new inbound messages are persisted before the run
        starts; assistant/tool messages produced by the run are persisted
        after it completes (accumulated live from the stream).
        """
        if self.thread_db is None:
            raise RuntimeError("run_with_thread requires a thread store")
        db = self.thread_db
        await db.create_thread(thread_id)  # no-op if it exists
        history = [
            Message.from_dict(m) for m in await db.get_thread_messages(thread_id)
        ]
        new_msgs = [
            m if isinstance(m, Message) else Message.from_dict(dict(m))
            for m in new_messages
        ]
        await db.add_messages(thread_id, [m.to_dict() for m in new_msgs])
        working = sanitize_messages_for_openai(history + new_msgs)

        acc = MessageAccumulator()
        try:
            async for event in self.run(
                [m.to_dict() for m in working],
                model=model,
                temperature=temperature,
                max_tokens=max_tokens,
                **kwargs,
            ):
                acc.add_event(event)
                yield event
        finally:
            # persist whatever the run produced, even on mid-run failure —
            # a resumed thread must see the partial turn (tool results that
            # DID execute) rather than silently losing it
            to_save = [m.to_dict() for m in acc.messages]
            if to_save:
                await db.add_messages(thread_id, to_save)

    async def __aenter__(self) -> "KafkaAgent":
        await self.initialize()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.cleanup()
