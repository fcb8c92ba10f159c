"""Default MCP server configurations.

Parity: reference server_tools/mcp_servers.py:8-13 (a remote `fetch`
server by default). Here the default set is read from the
KAFKA_TORCH_MCP_SERVERS env var (JSON list of MCPServerConfig fields) so
deployments choose their own servers; with the var unset we fall back to
the reference's remote fetch server. Connect failures are non-fatal by
design (AgentToolProvider warns and skips), so an offline deployment pays
only a connect timeout — set KAFKA_TORCH_MCP_SERVERS='[]' to skip entirely.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List

from ..tools.types import MCPServerConfig

logger = logging.getLogger("kafka_tpu_torch.server_tools")

_REFERENCE_DEFAULT = [
    {"name": "fetch", "url": "https://remote.mcpservers.org/fetch/mcp"},
]


def default_mcp_servers() -> List[MCPServerConfig]:
    raw = os.environ.get("KAFKA_TORCH_MCP_SERVERS")
    if raw is None:
        entries = _REFERENCE_DEFAULT
    else:
        try:
            entries = json.loads(raw)
        except json.JSONDecodeError as e:
            logger.warning("KAFKA_TORCH_MCP_SERVERS is not valid JSON (%s); "
                           "using no MCP servers", e)
            return []
        if not isinstance(entries, list):
            logger.warning("KAFKA_TORCH_MCP_SERVERS must be a JSON list; "
                           "using no MCP servers")
            return []
    configs: List[MCPServerConfig] = []
    for entry in entries:
        try:
            configs.append(MCPServerConfig(**entry))
        except TypeError as e:
            logger.warning("bad MCP server entry %r: %s — skipping",
                           entry, e)
    return configs
