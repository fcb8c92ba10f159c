"""Context-compaction primitives: error classification, safe splitting,
structural validation, and the provider ABC.

Behavior parity with the reference (src/llm/context_compaction/base.py):

* `is_context_length_error` (:10-65) — multi-provider string-pattern
  classifier, extended here with a fast path for the engine's typed
  `ContextLengthError` (the local engine raises pre-flight; the patterns
  remain so foreign error strings still classify).
* `find_safe_split_point` (:68-112) — never separates an
  assistant-with-tool_calls message from the tool results answering it.
* `validate_message_structure` (:115-168) — drops orphan tool results and
  empty assistant messages.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Sequence

from ...core.types import ContextLengthError

# Error-string fragments that indicate a context-window overflow across
# provider families (the reference matched these against remote API errors).
CONTEXT_LENGTH_PATTERNS = (
    "context_length_exceeded",
    "context length",
    "maximum context",
    "prompt is too long",
    # anthropic: "input length and `max_tokens` exceed context limit" —
    # matched on the distinctive phrase, not the bare "max_tokens" token,
    # so validation errors like "max_tokens must be positive" don't
    # trigger a pointless compaction retry
    "exceed context limit",
    "too many tokens",
    "token limit",
    "input is too long",
    "request too large",
    "exceeds the limit",
    "reduce the length",
    "string too long",
)


def is_context_length_error(error: BaseException) -> bool:
    """True when `error` indicates the prompt exceeded the model context."""
    if isinstance(error, ContextLengthError):
        return True
    text = str(error).lower()
    return any(p in text for p in CONTEXT_LENGTH_PATTERNS)


def _opens_tool_calls(msg: Dict[str, Any]) -> bool:
    return msg.get("role") == "assistant" and bool(msg.get("tool_calls"))


def find_safe_split_point(messages: Sequence[Dict[str, Any]], target: int) -> int:
    """Largest split index <= target that doesn't sever a tool-call pair.

    Messages before the split are summarized/dropped; messages from the
    split on are kept.  A split is unsafe if it would keep a `tool` result
    whose assistant-with-tool_calls message was summarized away (orphan), or
    summarize results while keeping their assistant message is impossible by
    construction (results follow their call).  Walk the target backward to
    the nearest safe boundary; index 0 is always safe.
    """
    target = max(0, min(target, len(messages)))
    s = target
    while s > 0:
        # unsafe iff the message AT the boundary is a tool result answering
        # a call opened before the boundary, or the boundary lands between
        # an assistant-with-tool_calls and its first result
        at = messages[s] if s < len(messages) else None
        before = messages[s - 1]
        if at is not None and at.get("role") == "tool":
            s -= 1
            continue
        if _opens_tool_calls(before):
            s -= 1
            continue
        return s
    return 0


def validate_message_structure(
    messages: Sequence[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Drop orphan tool results and empty assistant messages.

    Same window semantics as core.sanitize but operating on dicts (the
    compaction layer works on OpenAI-wire dicts throughout).
    """
    out: List[Dict[str, Any]] = []
    open_ids: set = set()
    for m in messages:
        role = m.get("role")
        if role == "assistant":
            if not m.get("content") and not m.get("tool_calls"):
                continue  # empty assistant message
            if m.get("tool_calls"):
                open_ids = {
                    tc.get("id") for tc in m["tool_calls"] if tc.get("id")
                }
            else:
                open_ids = set()
            out.append(m)
        elif role == "tool":
            tcid = m.get("tool_call_id")
            if tcid and tcid in open_ids:
                open_ids.discard(tcid)
                out.append(m)
            # else: orphan, dropped
        else:
            open_ids = set()
            out.append(m)
    return out


class ContextCompactionProvider(abc.ABC):
    """Shrinks a conversation that no longer fits the model context.

    Parity: reference src/llm/context_compaction/base.py (ABC) — `compact`
    returns a new message list expected to fit; implementations must never
    produce orphan tool messages.

    `fit`, when given, is the caller's token-aware budget predicate
    (True = the message list fits).  The caller knows request overhead the
    provider cannot — tool definitions added at render time — so a passed
    fit overrides any provider-internal default.
    """

    @abc.abstractmethod
    async def compact(
        self,
        messages: List[Dict[str, Any]],
        model: str | None = None,
        fit: Any | None = None,
    ) -> List[Dict[str, Any]]:
        raise NotImplementedError
