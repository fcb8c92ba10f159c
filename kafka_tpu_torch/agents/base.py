"""The tool-calling agent loop (a jax-free copy of kafka_tpu/agents/base.py).

Behavior parity with the reference agent (src/agents/base.py:54-440):

* injects an `idle` termination tool (:113-130) — the model calls it when
  the task is complete;
* streams LLM output as OpenAI-format chunk dicts, accumulating tool-call
  deltas by index (:285-331);
* executes tool calls through the ToolProvider, streaming their events
  (:417-425); sequential by default, optionally in parallel (a capability
  the reference lists but never implemented — SURVEY §2.2);
* terminates on idle call, plain-text response, or `max_iterations` (50);
* on a context-length error, compacts the conversation once per run and
  retries (:234-271).

One deliberate divergence: the reference buffered the ENTIRE LLM stream
before yielding (base.py:231-233) so an error could trigger compaction —
destroying time-to-first-token.  The local engine counts tokens pre-flight
and raises `ContextLengthError` *before* streaming begins, so chunks here
are forwarded as they arrive; compaction retry still works because the
error always precedes the first chunk.  Mid-stream errors after tokens
have been emitted are re-raised (nothing was ever going to un-emit them).

Event protocol yielded by `run()` (consumed by kafka/server tiers):
  * OpenAI `chat.completion.chunk` dicts — token/tool-call deltas;
  * `{"type": "tool_result", "tool_call_id", "name", "kind", "data",
     "done"}` — streamed tool output;
  * `{"type": "agent_done", "reason", "final_content"}` — terminal, with
    reason in {"idle", "text_response", "max_iterations"}.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

from .. import tracing
from ..core.toolcalls import ToolCallAccumulator, parse_tool_arguments
from ..core.types import Message, Usage, new_completion_id
from ..llm.base import LLMProvider, to_message_dicts
from ..llm.compaction import ContextCompactionProvider, is_context_length_error
from ..tools.base import ToolProvider
from ..tools.types import ToolEvent

logger = logging.getLogger("kafka_tpu_torch.agent")

IDLE_TOOL_NAME = "idle"
IDLE_TOOL = {
    "type": "function",
    "function": {
        "name": IDLE_TOOL_NAME,
        "description": (
            "Call this tool when you have fully completed the user's task "
            "and there is nothing left to do. Provide a short final summary."
        ),
        "parameters": {
            "type": "object",
            "properties": {
                "summary": {
                    "type": "string",
                    "description": "Final summary of what was accomplished.",
                }
            },
        },
    },
}

MAX_ITERATIONS_DEFAULT = 50  # reference: src/agents/base.py:78


class Agent:
    def __init__(
        self,
        llm_provider: LLMProvider,
        tool_provider: Optional[ToolProvider] = None,
        system_prompt: Optional[str] = None,
        prompt_provider: Optional[Any] = None,
        context_compaction_provider: Optional[ContextCompactionProvider] = None,
        max_iterations: int = MAX_ITERATIONS_DEFAULT,
        parallel_tools: bool = False,
        inject_idle_tool: bool = True,
        background_tool_turns: bool = False,
    ):
        self.llm = llm_provider
        self.tools = tool_provider
        self.system_prompt = system_prompt
        self.prompt_provider = prompt_provider
        self.compaction = context_compaction_provider
        self.max_iterations = max_iterations
        self.parallel_tools = parallel_tools
        self.inject_idle_tool = inject_idle_tool
        # turns that follow tool execution carry the tool
        # RESULTS in their prompt — with this knob (and a provider that
        # supports_background) their prefill rides the engine's
        # background class, yielding to interactive work each scheduler
        # iteration instead of convoying someone else's TTFT.
        self.background_tool_turns = background_tool_turns

    # ------------------------------------------------------------------

    async def _resolve_system_prompt(self) -> Optional[str]:
        """`system_prompt` string wins; else ask the prompt provider.

        Parity: reference src/agents/base.py:102-104 (string bypass).
        """
        if self.system_prompt is not None:
            return self.system_prompt
        if self.prompt_provider is not None:
            get = self.prompt_provider.get_system_prompt
            result = get()
            if asyncio.iscoroutine(result):
                result = await result
            return result
        return None

    def _tool_defs(self) -> List[Dict[str, Any]]:
        defs = list(self.tools.get_tools()) if self.tools else []
        if self.inject_idle_tool:
            defs.append(IDLE_TOOL)
        return defs

    def _compaction_fit(self, tool_defs: List[Dict[str, Any]]):
        """Token budget predicate that includes tool-definition overhead.

        The compaction provider can't know the tool schemas rendered into
        the prompt; without this, a compacted conversation can pass the
        provider's internal fit and still overflow once tools are added.
        Requires a counting provider (the TPU engine); None otherwise.
        """
        count = getattr(self.llm, "count_prompt_tokens", None)
        limit = getattr(self.llm, "max_prompt_tokens", None)
        if count is None or limit is None:
            return None
        budget = max(1, limit - min(256, limit // 2))
        tools = tool_defs or None
        return lambda msgs: count(msgs, tools=tools) <= budget

    # ------------------------------------------------------------------

    async def run(
        self,
        messages: Sequence[Any],
        model: Optional[str] = None,
        temperature: float = 0.7,
        max_tokens: Optional[int] = None,
        tool_choice: Any = None,
        **llm_kwargs: Any,
    ) -> AsyncIterator[Dict[str, Any]]:
        """Run the agent loop over `messages`, yielding the event protocol.

        tool_choice follows OpenAI semantics: "required" constrains every
        assistant turn to emit schema-valid tool-call JSON (the idle tool
        terminates the run); {"type": "function", "function": {"name": X}}
        forces one call to X, then reverts to free generation.  Constrained
        decoding needs provider support (build_tool_call_mask_fn) — without
        it the choice is advisory only.
        """
        working: List[Dict[str, Any]] = to_message_dicts(messages)
        sys_prompt = await self._resolve_system_prompt()
        if sys_prompt and not any(m.get("role") == "system" for m in working):
            working.insert(0, {"role": "system", "content": sys_prompt})
        tool_defs = self._tool_defs()
        compaction_attempted = False
        run_id = new_completion_id()
        final_content: List[str] = []
        # Real usage accounting across the WHOLE agent run (the reference
        # returned zeroed usage on the agent path, SURVEY §5.1): per-turn
        # usage frames sum here and ride out on agent_done.
        run_usage = Usage()

        iteration = 0
        # set after a tool batch when background_tool_turns is on: the
        # NEXT turn's prompt is dominated by tool results, so its
        # prefill may ride the background class
        next_turn_background = False
        while iteration < self.max_iterations:
            iteration += 1
            acc = ToolCallAccumulator()
            content_parts: List[str] = []
            streamed_any = False
            iter_kwargs = dict(llm_kwargs)
            if next_turn_background and getattr(
                self.llm, "supports_background", False
            ):
                iter_kwargs.setdefault("background", True)
            iter_tools = tool_defs
            if tool_choice == "none":
                iter_tools = None  # OpenAI semantics: no tool use at all
            elif tool_choice is not None and "logits_mask_fn" not in iter_kwargs:
                mask_fn = self.llm.build_tool_call_mask_fn(
                    tool_defs, tool_choice
                )
                if mask_fn is not None:
                    iter_kwargs["logits_mask_fn"] = mask_fn
            try:
                with tracing.span("agent.turn",
                                  attrs={"iteration": iteration}):
                    stream = self.llm.stream_completion(
                        working,
                        model=model,
                        temperature=temperature,
                        max_tokens=max_tokens,
                        tools=iter_tools if iter_tools else None,
                        **iter_kwargs,
                    )
                    async for chunk in stream:
                        streamed_any = streamed_any or bool(
                            chunk.content or chunk.tool_calls
                        )
                        if chunk.content:
                            content_parts.append(chunk.content)
                        if chunk.usage:
                            run_usage.prompt_tokens += chunk.usage.get(
                                "prompt_tokens", 0)
                            run_usage.completion_tokens += chunk.usage.get(
                                "completion_tokens", 0)
                            run_usage.total_tokens += chunk.usage.get(
                                "total_tokens", 0)
                            run_usage.cached_prompt_tokens += (
                                chunk.usage.get("prompt_tokens_details")
                                or {}
                            ).get("cached_tokens", 0)
                        acc.add_deltas(chunk.tool_calls)
                        yield chunk.to_openai_dict()
            except Exception as e:
                if (
                    is_context_length_error(e)
                    and self.compaction is not None
                    and not compaction_attempted
                    and not streamed_any
                ):
                    compaction_attempted = True
                    logger.info("context overflow on iteration %d; compacting",
                                iteration)
                    with tracing.span("compaction",
                                      attrs={"iteration": iteration}):
                        working = await self.compaction.compact(
                            working, model,
                            fit=self._compaction_fit(tool_defs),
                        )
                    iteration -= 1  # retry doesn't consume an iteration
                    continue
                raise

            if isinstance(tool_choice, dict):
                # specific function forced exactly once; cleared only after
                # the stream succeeded, so a compaction retry keeps the force
                tool_choice = None

            content = "".join(content_parts)
            tool_calls = acc.result() if acc.has_calls else None
            assistant_msg: Dict[str, Any] = {"role": "assistant"}
            if content:
                assistant_msg["content"] = content
                final_content.append(content)
            if tool_calls:
                assistant_msg["tool_calls"] = tool_calls
            working.append(assistant_msg)

            if not tool_calls:
                # plain text answer -> done (reference base.py:354-362)
                yield {
                    "type": "agent_done",
                    "reason": "text_response",
                    "final_content": content,
                    "usage": run_usage.to_dict(),
                }
                return

            # idle handling: terminal regardless of position in the batch
            idle_call = next(
                (
                    tc for tc in tool_calls
                    if tc.get("function", {}).get("name") == IDLE_TOOL_NAME
                ),
                None,
            )
            exec_calls = [tc for tc in tool_calls if tc is not idle_call]

            next_turn_background = False
            if exec_calls:
                if self.parallel_tools and len(exec_calls) > 1:
                    event_iter = self._run_tools_parallel(exec_calls)
                else:
                    event_iter = self._run_tools_sequential(exec_calls)
                async for item in event_iter:
                    if isinstance(item, dict):
                        yield item
                    else:  # completed tool message to append
                        working.append(item.to_dict())
                # The last tool's terminal event just landed — this IS
                # the tool-gap's end, before the follow-up prompt is even
                # composed.  Fire the thread's expected-return hint so a
                # demote-in-linger cancels / a demoted thread's wake
                # prefetch overlaps the message assembly (the
                # TPU provider forwards to the engine, others lack the
                # hook).
                note = getattr(self.llm, "note_tool_return", None)
                if note is not None:
                    note(llm_kwargs.get("prefix_key"))
                next_turn_background = self.background_tool_turns

            if idle_call is not None:
                args = parse_tool_arguments(
                    idle_call.get("function", {}).get("arguments")
                )
                summary = args.get("summary", "")
                working.append(
                    {
                        "role": "tool",
                        "tool_call_id": idle_call.get("id"),
                        "content": "Task completed.",
                    }
                )
                yield {
                    "type": "tool_result",
                    "tool_call_id": idle_call.get("id"),
                    "name": IDLE_TOOL_NAME,
                    "kind": "result",
                    "data": summary or "Task completed.",
                    "done": True,
                }
                yield {
                    "type": "agent_done",
                    "reason": "idle",
                    "final_content": summary or content
                    or " ".join(final_content),
                    "usage": run_usage.to_dict(),
                }
                return

        yield {
            "type": "agent_done",
            "reason": "max_iterations",
            "final_content": " ".join(final_content),
            "usage": run_usage.to_dict(),
        }

    # ------------------------------------------------------------------

    async def _execute_one(
        self, tc: Dict[str, Any]
    ) -> AsyncIterator[Any]:
        """Yield tool_result event dicts, then the tool Message (last)."""
        fn = tc.get("function", {})
        name = fn.get("name", "")
        call_id = tc.get("id") or ""
        result_text: List[str] = []
        error_text: Optional[str] = None
        if self.tools is None:
            error_text = f"no tool provider configured (tool: {name})"
            yield {
                "type": "tool_result", "tool_call_id": call_id, "name": name,
                "kind": "error", "data": error_text, "done": True,
            }
        else:
            async for ev in self.tools.run_tool_stream(
                name, fn.get("arguments"), call_id
            ):
                assert isinstance(ev, ToolEvent)
                if ev.kind == "result":
                    result_text.append(ev.text())
                elif ev.kind == "error":
                    error_text = ev.text()
                yield {
                    "type": "tool_result",
                    "tool_call_id": call_id,
                    "name": name,
                    "kind": ev.kind,
                    "data": ev.data,
                    "done": ev.terminal,
                }
        content = (
            f"Error: {error_text}" if error_text is not None
            else "".join(result_text)
        )
        yield Message(role="tool", content=content or "", tool_call_id=call_id)

    async def _run_tools_sequential(
        self, calls: List[Dict[str, Any]]
    ) -> AsyncIterator[Any]:
        for tc in calls:
            async for item in self._execute_one(tc):
                yield item

    async def _run_tools_parallel(
        self, calls: List[Dict[str, Any]]
    ) -> AsyncIterator[Any]:
        """Fan tool calls out concurrently, merging their event streams.

        Tool messages are withheld until all calls finish, then emitted in
        call order so the conversation stays aligned with `tool_calls`.
        """
        queue: "asyncio.Queue" = asyncio.Queue()
        DONE = object()
        tool_msgs: Dict[int, Message] = {}

        async def pump(idx: int, tc: Dict[str, Any]) -> None:
            try:
                async for item in self._execute_one(tc):
                    if isinstance(item, Message):
                        tool_msgs[idx] = item
                    else:
                        await queue.put(item)
            except Exception as e:
                # mirror the sequential path's visibility: the real cause
                # reaches both the event stream and the conversation
                logger.exception("parallel tool execution failed")
                detail = f"{type(e).__name__}: {e}"
                tool_msgs[idx] = Message(
                    role="tool", content=f"Error: {detail}",
                    tool_call_id=tc.get("id") or "",
                )
                await queue.put({
                    "type": "tool_result",
                    "tool_call_id": tc.get("id") or "",
                    "name": (tc.get("function") or {}).get("name", ""),
                    "kind": "error",
                    "data": detail,
                    "done": True,
                })
            finally:
                await queue.put(DONE)

        tasks = [
            asyncio.create_task(pump(i, tc)) for i, tc in enumerate(calls)
        ]
        try:
            remaining = len(tasks)
            while remaining:
                item = await queue.get()
                if item is DONE:
                    remaining -= 1
                    continue
                yield item
        finally:
            for t in tasks:
                t.cancel()
        for i in range(len(calls)):
            msg = tool_msgs.get(i)
            if msg is None:  # pump crashed before producing a message
                msg = Message(
                    role="tool",
                    content="Error: tool execution failed",
                    tool_call_id=calls[i].get("id") or "",
                )
            yield msg
