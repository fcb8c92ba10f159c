"""Sandbox tier types.

Parity: reference src/sandbox/types.py (SandboxConfig :10, SandboxInfo :38)
and src/sandbox/base.py:15-27 (SandboxState, SandboxError).  The streaming
`ToolEvent` lives in tools/types.py (shared with local tools).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class SandboxState(str, enum.Enum):
    CREATING = "creating"
    RUNNING = "running"
    STOPPED = "stopped"
    ERROR = "error"
    UNKNOWN = "unknown"


class SandboxError(Exception):
    pass


@dataclass
class SandboxConfig:
    """Claim-time configuration injected into a sandbox.

    Parity: the claim-config env the reference builds per thread
    (src/sandbox/manager.py:85-147): thread id, API key, model access,
    memory DSN, arbitrary env.
    """

    thread_id: Optional[str] = None
    vm_api_key: Optional[str] = None
    env: Dict[str, str] = field(default_factory=dict)
    tool_timeout_s: float = 300.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "thread_id": self.thread_id,
            "vm_api_key": self.vm_api_key,
            "env": self.env,
            "tool_timeout_s": self.tool_timeout_s,
        }


@dataclass
class SandboxInfo:
    sandbox_id: str
    state: SandboxState = SandboxState.UNKNOWN
    url: Optional[str] = None
    healthy: bool = False
    claimed: bool = False
    metadata: Dict[str, Any] = field(default_factory=dict)
