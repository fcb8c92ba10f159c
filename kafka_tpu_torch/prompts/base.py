"""Section-composed system prompts with {{var}} enrichment.

Parity: reference src/prompts/base.py — `PromptSection`s rendered in order
(:57, :251-274), enable/disable/add/remove/reorder (:326-424), `{{var}}`
substitution with enrichment variables, and validation (:484-524) that
flags unresolved variables.  Sections are markdown files or inline strings;
the provider is pure (no IO at render time) so the agent can re-render per
request with per-thread variables.
"""

from __future__ import annotations

import abc
import re
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

_VAR_RE = re.compile(r"\{\{\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*\}\}")


class PromptValidationError(ValueError):
    pass


@dataclass(frozen=True)
class PromptSection:
    """One named block of the system prompt."""

    name: str
    content: str
    order: int = 0
    enabled: bool = True

    @property
    def variables(self) -> List[str]:
        """`{{var}}` names referenced by this section."""
        return sorted(set(_VAR_RE.findall(self.content)))

    def render(self, variables: Dict[str, Any]) -> str:
        def sub(m: re.Match) -> str:
            name = m.group(1)
            if name in variables:
                return str(variables[name])
            return m.group(0)  # left intact; validation catches it

        return _VAR_RE.sub(sub, self.content)


class PromptProvider(abc.ABC):
    """Composes the system prompt from ordered, toggleable sections."""

    def __init__(
        self,
        sections: Optional[Sequence[PromptSection]] = None,
        variables: Optional[Dict[str, Any]] = None,
    ):
        self._sections: Dict[str, PromptSection] = {}
        for s in sections or []:
            self._sections[s.name] = s
        #: default enrichment variables, overridable per render
        self.variables: Dict[str, Any] = dict(variables or {})

    # -- section management (reference base.py:326-424) ----------------

    def add_section(
        self,
        name: str,
        content: str,
        order: Optional[int] = None,
        enabled: bool = True,
    ) -> None:
        if order is None:
            order = 1 + max(
                (s.order for s in self._sections.values()), default=0
            )
        self._sections[name] = PromptSection(name, content, order, enabled)

    def remove_section(self, name: str) -> None:
        self._sections.pop(name, None)

    def enable_section(self, name: str) -> None:
        self._set_enabled(name, True)

    def disable_section(self, name: str) -> None:
        self._set_enabled(name, False)

    def _set_enabled(self, name: str, enabled: bool) -> None:
        s = self._sections.get(name)
        if s is None:
            raise KeyError(f"unknown prompt section: {name}")
        self._sections[name] = replace(s, enabled=enabled)

    def reorder_section(self, name: str, order: int) -> None:
        s = self._sections.get(name)
        if s is None:
            raise KeyError(f"unknown prompt section: {name}")
        self._sections[name] = replace(s, order=order)

    def get_section(self, name: str) -> Optional[PromptSection]:
        return self._sections.get(name)

    @property
    def sections(self) -> List[PromptSection]:
        """Enabled+disabled sections in render order."""
        return sorted(self._sections.values(), key=lambda s: (s.order, s.name))

    # -- rendering -----------------------------------------------------

    def get_system_prompt(
        self, variables: Optional[Dict[str, Any]] = None
    ) -> str:
        """Render enabled sections in order, joined by blank lines."""
        merged = {**self.variables, **(variables or {})}
        parts = [
            s.render(merged).strip()
            for s in self.sections
            if s.enabled
        ]
        return "\n\n".join(p for p in parts if p)

    def validate(
        self, variables: Optional[Dict[str, Any]] = None
    ) -> List[str]:
        """Names of unresolved `{{var}}`s across enabled sections.

        Parity: reference base.py:484-524 (validation returns problems
        rather than raising; callers decide severity).
        """
        merged = {**self.variables, **(variables or {})}
        missing: List[str] = []
        for s in self.sections:
            if not s.enabled:
                continue
            for v in s.variables:
                if v not in merged and v not in missing:
                    missing.append(v)
        return missing
