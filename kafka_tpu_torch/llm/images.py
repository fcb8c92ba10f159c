"""Image content-part decoding for the vision serving path (a copy of
kafka_tpu/llm/images.py; the error names the "torch" provider).

The reference accepted OpenAI-wire image parts and forwarded them to
vision-capable provider models (src/llm/portkey.py:276 kept the newest 19
via utils.prune_images).  Here the parts are decoded locally — base64
data-URLs (and raw base64) to RGB pixel arrays sized for the ViT
(models/vision.py) — and each image part is replaced in the message text
by a single NUL sentinel character that the provider expands into
`num_patches` placeholder token ids after chat-template encoding.

The NUL sentinel is sound for the serving tokenizer (models/tokenizer.py
ByteTokenizer): NUL maps to byte token 0, and sentinelize_images STRIPS
any user-supplied NUL first (JSON's \\u0000 escape is legal, so incoming
text CAN carry one — unstripped it would collide with the sentinel and
let text pick where image embeddings land).  A subword checkpoint
tokenizer would instead use its own native image token (e.g. Llava's
<image>); the provider refuses vision + non-NUL-roundtripping tokenizers
at construction.
"""

from __future__ import annotations

import base64
import binascii
import io
from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.types import LLMProviderError

IMAGE_SENTINEL = "\x00"


class ImageDecodeError(LLMProviderError):
    """Malformed image part (bad base64 / unsupported format) — a client
    error, mapped to HTTP 400 like other invalid_request errors."""

    def __init__(self, detail: str, provider: str = "torch"):
        super().__init__(
            f"could not decode image: {detail} (invalid_request_error)",
            status_code=400, provider=provider,
        )


def _image_url_of(part: Dict[str, Any]) -> str:
    if part.get("type") == "image_url":
        url = part.get("image_url")
        if isinstance(url, dict):
            url = url.get("url")
        return url or ""
    # Anthropic-style {"type": "image", "source": {"data": ..}} passthrough
    src = part.get("source") or {}
    return src.get("data") or part.get("data") or ""


def decode_image(part: Dict[str, Any], image_size: int) -> np.ndarray:
    """One OpenAI-wire image part -> [S, S, 3] float32 in [0, 1]."""
    from PIL import Image

    url = _image_url_of(part)
    if not url:
        raise ImageDecodeError("image part carries no data")
    if url.startswith("data:"):
        try:
            _, b64 = url.split(",", 1)
        except ValueError:
            raise ImageDecodeError("malformed data URL")
    elif url.startswith(("http://", "https://")):
        raise ImageDecodeError(
            "remote image URLs are not fetched (no egress from the "
            "serving tier); send a base64 data URL"
        )
    else:
        b64 = url
    try:
        raw = base64.b64decode(b64, validate=True)
        img = Image.open(io.BytesIO(raw)).convert("RGB")
    except (binascii.Error, ValueError, OSError) as e:
        raise ImageDecodeError(str(e))
    img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def sentinelize_images(
    messages: List[Dict[str, Any]],
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Replace each image part with the NUL sentinel text part; return
    (rewritten messages, the original image parts in document order).
    Decode-free — count_prompt_tokens uses this to price a prompt without
    touching pixels.

    User-supplied NUL characters are STRIPPED from every text first: JSON
    forbids raw control bytes but allows the \\u0000 escape, so without
    this an attacker-chosen text NUL would collide with the sentinel and
    bind the image embeddings to a position the text picked."""

    def clean(s: Any) -> Any:
        return s.replace(IMAGE_SENTINEL, "") if isinstance(s, str) else s

    out: List[Dict[str, Any]] = []
    image_parts: List[Dict[str, Any]] = []
    for m in messages:
        c = m.get("content")
        if isinstance(c, str):
            if IMAGE_SENTINEL in c:
                m = {**m, "content": clean(c)}
            out.append(m)
            continue
        if not isinstance(c, list):
            out.append(m)
            continue
        parts: List[Any] = []
        changed = False
        for p in c:
            if isinstance(p, dict) and p.get("type") in ("image_url", "image"):
                image_parts.append(p)
                parts.append({"type": "text", "text": IMAGE_SENTINEL})
                changed = True
            elif (isinstance(p, dict) and p.get("type") == "text"
                  and IMAGE_SENTINEL in (p.get("text") or "")):
                parts.append({**p, "text": clean(p["text"])})
                changed = True
            else:
                parts.append(p)
        if changed:
            m = {**m, "content": parts}
        out.append(m)
    return out, image_parts


def extract_images(
    messages: List[Dict[str, Any]], image_size: int
) -> Tuple[List[Dict[str, Any]], List[np.ndarray]]:
    """sentinelize + decode: (rewritten messages, pixel arrays)."""
    out, parts = sentinelize_images(messages)
    return out, [decode_image(p, image_size) for p in parts]


def expand_placeholders(
    prompt_ids: List[int],
    sentinel_id: int,
    image_token_id: int,
    num_patches: int,
    n_images: int,
) -> Tuple[List[int], np.ndarray]:
    """Expand each sentinel token into `num_patches` placeholder ids.

    Returns (new ids, [n_images * num_patches] absolute positions of the
    placeholder tokens, image-major in document order — exactly the rows
    the vision encoder produced)."""
    ids: List[int] = []
    positions: List[int] = []
    seen = 0
    for t in prompt_ids:
        if t == sentinel_id and seen < n_images:
            positions.extend(range(len(ids), len(ids) + num_patches))
            ids.extend([image_token_id] * num_patches)
            seen += 1
        else:
            ids.append(t)
    if seen != n_images:
        raise ImageDecodeError(
            f"placeholder mismatch: {n_images} images but {seen} "
            "sentinels survived tokenization"
        )
    return ids, np.asarray(positions, np.int32)
