"""Provider-level message utilities (a copy of kafka_tpu/llm/utils.py).

Parity targets from the reference's provider utils (src/llm/utils.py):
model→provider routing heuristic (:11-29) and image pruning to the newest
N images (:85-130).  Message normalization for Gemini-style providers
(:32-82) is irrelevant to a local engine and intentionally absent; the
related opaque-field passthrough (thought_signature, portkey.py:282-287)
IS preserved — unknown top-level message keys round-trip through
core.types.Message.extra and the thread store.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

MAX_IMAGES_DEFAULT = 19  # reference cap: src/llm/portkey.py:276


def infer_provider_from_model(model: str) -> str:
    """Heuristic model-name → provider-family routing.

    Kept for wire compatibility with clients that pass foreign model ids;
    anything unrecognized maps to "tpu", the reference's name for the
    in-process engine (kept so both packages route alike).
    """
    m = (model or "").lower()
    if m.startswith(("gpt-", "o1", "o3", "o4", "chatgpt")):
        return "openai"
    if m.startswith("claude"):
        return "anthropic"
    if m.startswith("gemini"):
        return "google"
    if m.startswith(("mistral", "mixtral", "ministral")):
        return "mistral"
    return "tpu"


def _is_image_part(part: Any) -> bool:
    return isinstance(part, dict) and part.get("type") in ("image_url", "image")


def count_images(messages: List[Dict[str, Any]]) -> int:
    n = 0
    for m in messages:
        c = m.get("content")
        if isinstance(c, list):
            n += sum(1 for p in c if _is_image_part(p))
    return n


def prune_images(
    messages: List[Dict[str, Any]], max_images: int = MAX_IMAGES_DEFAULT
) -> List[Dict[str, Any]]:
    """Keep only the newest `max_images` images across the conversation.

    Older images are replaced with a short text placeholder so message
    structure (and tool-call pairing) is preserved.  Returns a deep-ish copy
    when pruning happens; returns the input list unchanged otherwise.
    """
    total = count_images(messages)
    if total <= max_images:
        return messages
    to_drop = total - max_images
    out: List[Dict[str, Any]] = []
    dropped = 0
    for m in messages:
        c = m.get("content")
        if dropped < to_drop and isinstance(c, list) and any(
            _is_image_part(p) for p in c
        ):
            m = copy.copy(m)
            new_parts: List[Any] = []
            for p in c:
                if dropped < to_drop and _is_image_part(p):
                    new_parts.append(
                        {"type": "text", "text": "[image removed to fit context]"}
                    )
                    dropped += 1
                else:
                    new_parts.append(p)
            m["content"] = new_parts
        out.append(m)
    return out
