"""PromptProviderV1 — loads the 13 markdown sections in fixed order.

Parity: reference src/prompts/v1.py:15-117 (section list + default
sandbox-environment enrichment).  Dynamic per-thread additions —
`global_prompt` from the thread config and playbooks rendered as a
markdown table — are appended by the kafka orchestrator exactly as the
reference does (src/kafka/v1.py:196-225, :330-357) via `add_section`.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

from .base import PromptProvider, PromptSection

SECTIONS_DIR = os.path.join(os.path.dirname(__file__), "sections")

#: fixed load order (file name prefixes define order; names are the stems)
SECTION_FILES = (
    "01_intro.md",
    "02_environment.md",
    "03_capabilities.md",
    "04_decision_tree.md",
    "05_tool_guidelines.md",
    "06_shell.md",
    "07_notebook.md",
    "08_planner.md",
    "09_web.md",
    "10_communication.md",
    "11_safety.md",
    "12_memory.md",
    "13_completion.md",
)

DEFAULT_SANDBOX_ENV = (
    "A Linux sandbox VM with a persistent filesystem, Python 3, and "
    "common CLI tools. Network access may be restricted."
)


def _default_variables() -> Dict[str, Any]:
    return {
        "sandbox_env": DEFAULT_SANDBOX_ENV,
        "current_date": datetime.date.today().isoformat(),
    }


class PromptProviderV1(PromptProvider):
    def __init__(
        self,
        variables: Optional[Dict[str, Any]] = None,
        sections_dir: str = SECTIONS_DIR,
    ):
        # refresh the date at render time unless the caller pinned one —
        # a long-running server must not tell the model yesterday's date
        self._pinned_date = "current_date" in (variables or {})
        merged = _default_variables()
        merged.update(variables or {})
        sections = []
        for i, fname in enumerate(SECTION_FILES):
            path = os.path.join(sections_dir, fname)
            with open(path, "r", encoding="utf-8") as f:
                content = f.read()
            name = fname.split(".", 1)[0].split("_", 1)[1]
            sections.append(
                PromptSection(name=name, content=content, order=(i + 1) * 10)
            )
        super().__init__(sections=sections, variables=merged)

    def get_system_prompt(self, variables: Optional[Dict[str, Any]] = None) -> str:
        if not self._pinned_date and not (variables or {}).get("current_date"):
            variables = {
                **(variables or {}),
                "current_date": datetime.date.today().isoformat(),
            }
        return super().get_system_prompt(variables)
