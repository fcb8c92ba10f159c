"""Compaction strategies: LLM summarization with truncation fallback.

Parity with the reference's two providers
(src/llm/context_compaction/v1.py:49-313):

* `SummarizationCompactionProvider` — summarize the oldest `summarize_ratio`
  of the conversation via an LLM call, keep the rest verbatim, insert the
  summary as a system message (with `cache_control: ephemeral` metadata, as
  the reference does for Anthropic prompt caching); falls back to safe
  truncation on any failure.
* `TruncationCompactionProvider` — keep system messages + the last N
  conversation messages at a tool-pair-safe boundary.

Unlike the reference, the summarization call goes to the *local* TPU
provider — no second network hop — and the target size can be validated
pre-flight by token counting when the provider exposes it.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from ..base import LLMProvider
from .base import (
    ContextCompactionProvider,
    find_safe_split_point,
    validate_message_structure,
)

# Optional fit predicate: True when a message list fits the model context.
# The local engine can count tokens exactly (TPULLMProvider.count_prompt_
# tokens), which the reference never could — its compaction was blind
# message-count heuristics plus one retry. With a `fit`, both strategies
# tighten until the result actually fits.
FitFn = Callable[[List[Dict[str, Any]]], bool]


def fit_from_provider(llm: LLMProvider, margin: int = 256) -> Optional[FitFn]:
    """Build a token-aware fit predicate from a provider that can count.

    `margin` reserves room for the generation itself.
    """
    count = getattr(llm, "count_prompt_tokens", None)
    limit = getattr(llm, "max_prompt_tokens", None)
    if count is None or limit is None:
        return None
    # never let the generation margin eat more than half a small window
    budget = limit - min(margin, limit // 2)
    return lambda msgs: count(msgs) <= max(1, budget)

logger = logging.getLogger("kafka_tpu_torch.compaction")

SUMMARY_SYSTEM_PROMPT = (
    "You are a conversation summarizer. Produce a concise but complete "
    "summary of the conversation so far: user goals, decisions made, tool "
    "calls and their key results, current state, and any unresolved items. "
    "Write it so an assistant can seamlessly continue the conversation."
)

SUMMARY_PREFIX = "[Conversation summary — earlier messages were compacted]\n"

# Per-model max summary output budget (reference: v1.py:20-46 kept a
# per-model table; the local engine reads its own config instead, this
# table only caps the request).
DEFAULT_MAX_SUMMARY_TOKENS = 1024


def _content_len(m: Dict[str, Any]) -> int:
    c = m.get("content")
    if isinstance(c, str):
        return len(c)
    if isinstance(c, list):
        return sum(len(p.get("text", "")) for p in c if isinstance(p, dict))
    return 0


def _halve_content(m: Dict[str, Any]) -> Dict[str, Any]:
    """Copy of `m` with its longest text halved, newest chars kept."""
    marker = "[…trimmed…] "
    c = m.get("content")
    m = dict(m)
    if isinstance(c, str):
        m["content"] = marker + c[len(c) // 2 :]
    elif isinstance(c, list):
        parts = [dict(p) if isinstance(p, dict) else p for p in c]
        longest = max(
            (p for p in parts if isinstance(p, dict) and p.get("text")),
            key=lambda p: len(p["text"]),
            default=None,
        )
        if longest is not None:
            longest["text"] = marker + longest["text"][len(longest["text"]) // 2 :]
        m["content"] = parts
    return m


def _trim_contents(messages: List[Dict[str, Any]], fit: FitFn,
                   max_rounds: int = 64) -> List[Dict[str, Any]]:
    """Halve the largest message contents until `fit` passes (or floor)."""
    out = list(messages)
    for _ in range(max_rounds):
        if fit(out):
            return out
        i = max(range(len(out)), key=lambda j: _content_len(out[j]), default=None)
        if i is None or _content_len(out[i]) <= 32:
            break  # nothing meaningful left to trim
        out[i] = _halve_content(out[i])
    return out


def _split_system(messages: List[Dict[str, Any]]):
    """Leading system messages vs the conversation body."""
    i = 0
    while i < len(messages) and messages[i].get("role") == "system":
        i += 1
    return list(messages[:i]), list(messages[i:])


class TruncationCompactionProvider(ContextCompactionProvider):
    """Keep system messages + the newest `keep_last` conversation messages.

    Parity: reference v1.py:242-313 (keep-last-50 default).
    """

    def __init__(self, keep_last: int = 50, fit: Optional[FitFn] = None):
        self.keep_last = keep_last
        self.fit = fit

    async def compact(
        self,
        messages: List[Dict[str, Any]],
        model: Optional[str] = None,
        fit: Optional[FitFn] = None,
    ) -> List[Dict[str, Any]]:
        eff_fit = fit or self.fit
        system_msgs, convo = _split_system(messages)
        keep = self.keep_last
        out = validate_message_structure(messages)
        while len(convo) > 0:
            if len(convo) > keep:
                split = find_safe_split_point(convo, len(convo) - keep)
                out = validate_message_structure(system_msgs + convo[split:])
            if eff_fit is None or eff_fit(out) or keep <= 1:
                break
            keep //= 2  # still over budget: tighten and retry
        if eff_fit is not None and not eff_fit(out):
            # last resort: individual messages larger than the window —
            # trim their text content (newest chars kept) until it fits
            out = _trim_contents(out, eff_fit)
        if len(messages) != len(out):
            logger.info(
                "truncation compaction: %d -> %d messages",
                len(messages), len(out),
            )
        return out


class SummarizationCompactionProvider(ContextCompactionProvider):
    """Summarize the oldest portion of the conversation via an LLM call.

    Parity: reference v1.py:49-239. `summarize_ratio` of the conversation
    (by message count) is summarized; the remainder is kept verbatim after
    a tool-pair-safe split.
    """

    def __init__(
        self,
        llm_provider: LLMProvider,
        model: Optional[str] = None,
        summarize_ratio: float = 0.75,
        min_messages: int = 10,
        max_summary_tokens: int = DEFAULT_MAX_SUMMARY_TOKENS,
        temperature: float = 0.3,
        fallback: Optional[ContextCompactionProvider] = None,
        fit: Optional[FitFn] = None,
    ):
        self.llm = llm_provider
        self.model = model
        self.summarize_ratio = summarize_ratio
        self.min_messages = min_messages
        self.max_summary_tokens = max_summary_tokens
        self.temperature = temperature
        self.fit = fit if fit is not None else fit_from_provider(llm_provider)
        self.fallback = fallback or TruncationCompactionProvider(fit=self.fit)

    async def compact(
        self,
        messages: List[Dict[str, Any]],
        model: Optional[str] = None,
        fit: Optional[FitFn] = None,
    ) -> List[Dict[str, Any]]:
        eff_fit = fit or self.fit
        system_msgs, convo = _split_system(messages)
        if len(convo) < self.min_messages:
            # too short to summarize meaningfully — safe truncation
            return await self.fallback.compact(messages, model, fit=eff_fit)
        target = int(len(convo) * self.summarize_ratio)
        split = find_safe_split_point(convo, target)
        if split <= 0:
            return await self.fallback.compact(messages, model, fit=eff_fit)
        to_summarize, kept = convo[:split], convo[split:]
        try:
            summary = await self._summarize(to_summarize, model or self.model)
        except Exception as e:
            logger.warning("summarization failed (%s); falling back", e)
            return await self.fallback.compact(messages, model, fit=eff_fit)
        summary_msg: Dict[str, Any] = {
            "role": "system",
            "content": [
                {
                    "type": "text",
                    "text": SUMMARY_PREFIX + summary,
                    # Anthropic-style prompt-cache hint; passthrough metadata
                    # for providers that understand it (reference v1.py:198).
                    "cache_control": {"type": "ephemeral"},
                }
            ],
        }
        rebuilt = system_msgs + [summary_msg] + kept
        out = validate_message_structure(rebuilt)
        if eff_fit is not None and not eff_fit(out):
            # summary + kept tail still over budget (huge tail messages):
            # hand the rebuilt list to token-aware truncation, preserving
            # the summary (it sits in the system prefix now)
            out = await self.fallback.compact(out, model, fit=eff_fit)
        logger.info(
            "summarization compaction: %d messages -> %d (summarized %d)",
            len(messages), len(out), split,
        )
        return out

    async def _summarize(
        self, messages: List[Dict[str, Any]], model: Optional[str]
    ) -> str:
        transcript = _render_transcript(messages)
        transcript = self._cap_transcript(transcript)
        extra: Dict[str, Any] = {}
        if getattr(self.llm, "supports_background", False):
            # the summarization call is maintenance work on the
            # serving engine — ride the background class so it never
            # convoys an interactive request's TTFT (the output is
            # byte-identical to a foreground run; only scheduling
            # priority differs).  OpenAI-shaped providers would choke on
            # the kwarg, hence the capability gate.
            extra["background"] = True
        resp = await self.llm.completion(
            [
                {"role": "system", "content": SUMMARY_SYSTEM_PROMPT},
                {
                    "role": "user",
                    "content": "Summarize this conversation:\n\n" + transcript,
                },
            ],
            model=model,
            temperature=self.temperature,
            max_tokens=self.max_summary_tokens,
            **extra,
        )
        content = resp.content or ""
        if not content.strip():
            raise RuntimeError("summarizer returned empty content")
        return content.strip()

    def _cap_transcript(self, transcript: str) -> str:
        """Shrink the transcript until the summarization request itself fits
        the summarizer's context (keeps the newest portion)."""
        probe = lambda t: [
            {"role": "system", "content": SUMMARY_SYSTEM_PROMPT},
            {"role": "user", "content": "Summarize this conversation:\n\n" + t},
        ]
        fit = self.fit if self.fit is not None else fit_from_provider(self.llm)
        if fit is None:
            return transcript
        omitted = "[earlier part of the conversation omitted]\n"
        while transcript and not fit(probe(transcript)):
            if len(transcript) <= 64:
                break  # can't shrink further; caller falls back on error
            cut = max(len(transcript) // 4, 64)
            transcript = omitted + transcript[cut:]
        return transcript


def _render_transcript(messages: List[Dict[str, Any]]) -> str:
    """Flatten messages (incl. tool calls/results) to plain text."""
    lines: List[str] = []
    for m in messages:
        role = m.get("role", "?")
        content = m.get("content")
        if isinstance(content, list):
            content = " ".join(
                p.get("text", "[image]")
                for p in content
                if isinstance(p, dict)
            )
        if content:
            lines.append(f"{role}: {content}")
        for tc in m.get("tool_calls") or []:
            fn = tc.get("function", {})
            lines.append(
                f"{role} called tool {fn.get('name')}({fn.get('arguments')})"
            )
    return "\n".join(lines)
