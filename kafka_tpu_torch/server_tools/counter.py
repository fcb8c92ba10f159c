"""Streaming demo tool.

Parity: reference server_tools/counter.py:13-44 — `count_slowly` exists to
demonstrate (and test) streamed tool results end to end.
"""

from __future__ import annotations

import asyncio

from ..tools.types import Tool


def counter_tool() -> Tool:
    async def count_slowly(limit: int = 5, delay: float = 0.2):
        for i in range(1, int(limit) + 1):
            yield f"{i}\n"
            await asyncio.sleep(max(0.0, float(delay)))

    return Tool(
        name="count_slowly",
        description=(
            "Counts from 1 to limit, streaming one number at a time. "
            "For demonstrating streaming tool output."
        ),
        parameters={
            "type": "object",
            "properties": {
                "limit": {"type": "integer", "default": 5},
                "delay": {"type": "number", "default": 0.2},
            },
        },
        handler=count_slowly,
    )
