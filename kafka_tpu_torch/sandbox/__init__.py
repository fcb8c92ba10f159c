"""Sandbox tier: tool-execution runtimes behind the sandbox HTTP protocol.

Client side: Sandbox ABC, LocalSandbox (HTTP/SSE), LazySandbox,
SandboxManager + factories (subprocess, warm pools).
Server side: sandbox/server.py — the in-tree sandbox implementation
(shell sessions, notebook kernels) the factories spawn.
"""

from .base import Sandbox
from .lazy import LazySandbox
from .local import LocalSandbox
from .manager import SandboxFactory, SandboxManager
from .process import ProcessSandboxFactory
from .remote import RemoteSandboxFactory
from .tools import (
    SandboxTool,
    notebook_tools,
    sandbox_builtin_tools,
    shell_tools,
)
from .types import SandboxConfig, SandboxError, SandboxInfo, SandboxState
from .warm import HTTPWarmSandboxFactory, ProcessWarmPool, WarmSandboxFactory

__all__ = [
    "HTTPWarmSandboxFactory",
    "LazySandbox",
    "LocalSandbox",
    "ProcessSandboxFactory",
    "RemoteSandboxFactory",
    "ProcessWarmPool",
    "Sandbox",
    "SandboxConfig",
    "SandboxError",
    "SandboxFactory",
    "SandboxInfo",
    "SandboxManager",
    "SandboxState",
    "SandboxTool",
    "WarmSandboxFactory",
    "notebook_tools",
    "sandbox_builtin_tools",
    "shell_tools",
]
