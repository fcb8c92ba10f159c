"""Thread persistence and the single model turn of the serving path.

From kafka_tpu/kafka/base.py (`KafkaAgent.run_with_thread`): a thread's
history is loaded, the new inbound messages are persisted before the run,
and the assistant messages the run produced are re-accumulated from the
event stream and persisted after it — even on a mid-run failure.

`run_turn` is the one model turn the main path needs: it streams the LLM's
chunks as OpenAI chunk dicts and ends with the `agent_done` event the
protocol's clients wait for.  `run_thread_turn` runs it inside
`run_with_thread` and keys the engine's KV prefix cache by the thread
(kafka_tpu/kafka/v1.py:150), so each turn prefills only the conversation
suffix.  The tool-calling agent loop, prompts, playbooks and compaction
wait for a later slice of the port.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from ..core.sanitize import sanitize_messages_for_openai
from ..core.types import Message, Usage
from ..db.base import DBClient
from ..llm.base import LLMProvider, to_message_dicts
from .utils import MessageAccumulator


async def run_turn(
    llm: LLMProvider,
    messages: List[Any],
    system_prompt: Optional[str] = None,
    **llm_kwargs: Any,
) -> AsyncIterator[Dict[str, Any]]:
    """One model turn: chunk dicts, then {"type": "agent_done", ...}."""
    working = to_message_dicts(messages)
    if system_prompt and not any(m.get("role") == "system" for m in working):
        working.insert(0, {"role": "system", "content": system_prompt})
    usage = Usage()
    content: List[str] = []
    async for chunk in llm.stream_completion(working, **llm_kwargs):
        if chunk.content:
            content.append(chunk.content)
        if chunk.usage:
            usage.prompt_tokens += chunk.usage.get("prompt_tokens", 0)
            usage.completion_tokens += chunk.usage.get("completion_tokens", 0)
            usage.total_tokens += chunk.usage.get("total_tokens", 0)
            usage.cached_prompt_tokens += (
                chunk.usage.get("prompt_tokens_details") or {}
            ).get("cached_tokens", 0)
        yield chunk.to_openai_dict()
    yield {
        "type": "agent_done",
        "reason": "text_response",
        "final_content": "".join(content),
        "usage": usage.to_dict(),
    }


async def run_with_thread(
    db: DBClient,
    thread_id: str,
    new_messages: List[Any],
    run: Callable[[List[Dict[str, Any]]], AsyncIterator[Dict[str, Any]]],
) -> AsyncIterator[Dict[str, Any]]:
    """Run `run(history + new messages)` with durable thread history: the
    new inbound messages are persisted before the run starts, the
    assistant messages it produced after it ends."""
    await db.create_thread(thread_id)  # no-op if it exists
    history = [Message.from_dict(m)
               for m in await db.get_thread_messages(thread_id)]
    new_msgs = [m if isinstance(m, Message) else Message.from_dict(dict(m))
                for m in new_messages]
    await db.add_messages(thread_id, [m.to_dict() for m in new_msgs])
    working = sanitize_messages_for_openai(history + new_msgs)
    acc = MessageAccumulator()
    try:
        async for event in run([m.to_dict() for m in working]):
            acc.add_event(event)
            yield event
    finally:
        # persist whatever the run produced, even on mid-run failure
        to_save = [m.to_dict() for m in acc.messages]
        if to_save:
            await db.add_messages(thread_id, to_save)


def run_thread_turn(
    db: DBClient,
    llm: LLMProvider,
    thread_id: str,
    new_messages: List[Any],
    system_prompt: Optional[str] = None,
    **llm_kwargs: Any,
) -> AsyncIterator[Dict[str, Any]]:
    """One model turn on a thread: history in, new messages and reply
    persisted.  The thread id is the request's prefix_key, so the
    engine's radix cache serves the earlier turns' KV (providers without
    a cache ignore it)."""
    llm_kwargs.setdefault("prefix_key", thread_id)
    return run_with_thread(
        db, thread_id, new_messages,
        lambda working: run_turn(llm, working, system_prompt, **llm_kwargs),
    )
