"""Sequential-thinking planner tools.

Parity: reference server_tools/planner.py:14-307 — a stateful in-process
planning server with numbered thoughts, revisions, branches, and named
checkpoints, exposed as three tools: `sequentialthinking`,
`saveThoughtCheckpoint`, `loadThoughtCheckpoint`.

One reference bug deliberately fixed: its `_thinking_server` was a module
global shared by every thread/request (flagged in SURVEY §5.2).  Here the
server instance is owned by the `PlannerTools` factory — one per wiring —
and thread-keyed internally, so concurrent threads don't interleave plans.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..tools.types import Tool


@dataclass
class Thought:
    number: int
    content: str
    revises: Optional[int] = None
    branch_id: Optional[str] = None


@dataclass
class PlanState:
    thoughts: List[Thought] = field(default_factory=list)
    branches: Dict[str, List[Thought]] = field(default_factory=dict)
    next_number: int = 1


class SequentialThinkingServer:
    """Holds plan state per session key (thread id or 'default')."""

    def __init__(self) -> None:
        self._plans: Dict[str, PlanState] = {}
        self._checkpoints: Dict[str, Dict[str, PlanState]] = {}

    def _plan(self, session: str) -> PlanState:
        return self._plans.setdefault(session, PlanState())

    def think(
        self,
        thought: str,
        session: str = "default",
        thought_number: Optional[int] = None,
        total_thoughts: Optional[int] = None,
        next_thought_needed: bool = True,
        is_revision: bool = False,
        revises_thought: Optional[int] = None,
        branch_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        plan = self._plan(session)
        number = thought_number or plan.next_number
        t = Thought(
            number=number,
            content=thought,
            revises=revises_thought if is_revision else None,
            branch_id=branch_id,
        )
        if branch_id:
            plan.branches.setdefault(branch_id, []).append(t)
        else:
            plan.thoughts.append(t)
        plan.next_number = max(plan.next_number, number) + 1
        return {
            "thought_number": number,
            "total_thoughts": total_thoughts or len(plan.thoughts),
            "next_thought_needed": next_thought_needed,
            "branches": sorted(plan.branches),
            "thought_history_length": len(plan.thoughts),
        }

    def save_checkpoint(self, name: str, session: str = "default") -> Dict[str, Any]:
        plans = self._checkpoints.setdefault(name, {})
        plans[session] = copy.deepcopy(self._plan(session))
        return {"checkpoint": name, "thoughts": len(plans[session].thoughts)}

    def load_checkpoint(self, name: str, session: str = "default") -> Dict[str, Any]:
        plans = self._checkpoints.get(name)
        if plans is None or session not in plans:
            return {"error": f"no checkpoint named {name!r}"}
        self._plans[session] = copy.deepcopy(plans[session])
        state = self._plans[session]
        return {
            "checkpoint": name,
            "thoughts": len(state.thoughts),
            "history": [
                {"number": t.number, "content": t.content}
                for t in state.thoughts
            ],
        }


class PlannerTools:
    """Factory bundling the three planner tools over one server instance."""

    def __init__(self) -> None:
        self.server = SequentialThinkingServer()

    def tools(self) -> List[Tool]:
        srv = self.server

        def sequentialthinking(
            thought: str,
            thoughtNumber: Optional[int] = None,
            totalThoughts: Optional[int] = None,
            nextThoughtNeeded: bool = True,
            isRevision: bool = False,
            revisesThought: Optional[int] = None,
            branchId: Optional[str] = None,
            session: str = "default",
            **_: Any,
        ) -> str:
            return json.dumps(
                srv.think(
                    thought,
                    session=session,
                    thought_number=thoughtNumber,
                    total_thoughts=totalThoughts,
                    next_thought_needed=nextThoughtNeeded,
                    is_revision=isRevision,
                    revises_thought=revisesThought,
                    branch_id=branchId,
                )
            )

        def saveThoughtCheckpoint(name: str, session: str = "default", **_: Any) -> str:
            return json.dumps(srv.save_checkpoint(name, session=session))

        def loadThoughtCheckpoint(name: str, session: str = "default", **_: Any) -> str:
            return json.dumps(srv.load_checkpoint(name, session=session))

        return [
            Tool(
                name="sequentialthinking",
                description=(
                    "Record one step of sequential thinking. Supports "
                    "revising earlier thoughts (isRevision/revisesThought) "
                    "and alternative branches (branchId). Use for planning "
                    "multi-step work before executing it."
                ),
                parameters={
                    "type": "object",
                    "properties": {
                        "thought": {"type": "string"},
                        "thoughtNumber": {"type": "integer"},
                        "totalThoughts": {"type": "integer"},
                        "nextThoughtNeeded": {"type": "boolean"},
                        "isRevision": {"type": "boolean"},
                        "revisesThought": {"type": "integer"},
                        "branchId": {"type": "string"},
                    },
                    "required": ["thought"],
                },
                handler=sequentialthinking,
            ),
            Tool(
                name="saveThoughtCheckpoint",
                description="Save the current plan state under a name.",
                parameters={
                    "type": "object",
                    "properties": {"name": {"type": "string"}},
                    "required": ["name"],
                },
                handler=saveThoughtCheckpoint,
            ),
            Tool(
                name="loadThoughtCheckpoint",
                description="Restore the plan state saved under a name.",
                parameters={
                    "type": "object",
                    "properties": {"name": {"type": "string"}},
                    "required": ["name"],
                },
                handler=loadThoughtCheckpoint,
            ),
        ]
