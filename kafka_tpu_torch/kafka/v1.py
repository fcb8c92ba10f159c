"""KafkaV1Provider — concrete wiring of the whole stack.

Parity: reference src/kafka/v1.py:24-357, with the central substitution:
the LLM provider is the in-process engine (the port's
llm/torch_provider.py on the H100), not a remote gateway.  Copied from
kafka_tpu/kafka/v1.py.  The engine is an expensive shared singleton, so unlike the
reference (which built a fresh Portkey client per thread, v1.py:177-181)
this provider RECEIVES the LLMProvider and shares it across threads; what
is per-thread is the prompt (global_prompt + playbooks from the thread
config, v1.py:196-225), the tool set, and the agent instance.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

from ..agents import Agent
from ..db.base import DBClient
from ..llm.base import LLMProvider
from ..llm.compaction import (
    ContextCompactionProvider,
    SummarizationCompactionProvider,
)
from ..prompts import PromptProviderV1
from ..tools import AgentToolProvider, MCPServerConfig, Tool
from .base import KafkaAgent
from .utils import playbooks_to_markdown

logger = logging.getLogger("kafka_tpu_torch.kafka.v1")


class KafkaV1Provider(KafkaAgent):
    def __init__(
        self,
        llm_provider: LLMProvider,
        thread_db: Optional[DBClient] = None,
        tools: Optional[Sequence[Tool]] = None,
        mcp_servers: Optional[Sequence[MCPServerConfig]] = None,
        thread_id: Optional[str] = None,
        system_prompt: Optional[str] = None,
        default_model: Optional[str] = None,
        compaction_provider: Optional[ContextCompactionProvider] = None,
        max_iterations: int = 50,
        parallel_tools: bool = False,
        prompt_variables: Optional[Dict[str, Any]] = None,
    ):
        self.llm = llm_provider
        self.thread_db = thread_db
        self._tools = list(tools or [])
        self._mcp_servers = list(mcp_servers or [])
        self.thread_id = thread_id
        self.system_prompt = system_prompt
        self.default_model = default_model
        self._compaction = compaction_provider
        self.max_iterations = max_iterations
        self.parallel_tools = parallel_tools
        self._prompt_variables = dict(prompt_variables or {})
        self.tool_provider: Optional[AgentToolProvider] = None
        self.prompt_provider: Optional[PromptProviderV1] = None
        self.agent: Optional[Agent] = None
        self._initialized = False

    # ------------------------------------------------------------------

    async def initialize(self) -> None:
        if self._initialized:
            return

        # per-thread config (model override, global_prompt, playbooks) —
        # reference v1.py:135-158
        thread_config: Dict[str, Any] = {}
        if self.thread_id and self.thread_db is not None:
            try:
                thread_config = (
                    await self.thread_db.get_thread_config(self.thread_id)
                ) or {}
            except Exception as e:
                logger.warning("thread config fetch failed: %s", e)
        # per-thread model override beats the request/server default: it is
        # the operator's explicit per-thread routing decision (the analog of
        # the reference's per-thread virtual-key routing, v1.py:135-158)
        if thread_config.get("model"):
            self.default_model = thread_config["model"]

        self.tool_provider = AgentToolProvider(
            tools=self._tools, mcp_servers=self._mcp_servers
        )
        await self.tool_provider.connect()

        if self._compaction is None:
            self._compaction = SummarizationCompactionProvider(
                self.llm, model=self.default_model
            )

        # prompt provider + dynamic sections (reference v1.py:196-225)
        if self.system_prompt is None:
            self.prompt_provider = PromptProviderV1(
                variables=self._prompt_variables
            )
            global_prompt = thread_config.get("global_prompt")
            if global_prompt:
                self.prompt_provider.add_section("global_prompt", global_prompt)
            playbooks = thread_config.get("playbooks") or []
            table = playbooks_to_markdown(playbooks)
            if table:
                self.prompt_provider.add_section("playbooks", table)

        self.agent = Agent(
            llm_provider=self.llm,
            tool_provider=self.tool_provider,
            system_prompt=self.system_prompt,
            prompt_provider=self.prompt_provider,
            context_compaction_provider=self._compaction,
            max_iterations=self.max_iterations,
            parallel_tools=self.parallel_tools,
        )
        self._initialized = True

    async def cleanup(self) -> None:
        if self.tool_provider is not None:
            await self.tool_provider.disconnect()
        self._initialized = False

    # ------------------------------------------------------------------

    def get_tools(self) -> List[Dict[str, Any]]:
        return self.tool_provider.get_tools() if self.tool_provider else []

    def register_tool(self, tool: Tool) -> None:
        if self.tool_provider is None:
            self._tools.append(tool)
        else:
            self.tool_provider.register_tool(tool)

    async def run(
        self,
        messages: List[Any],
        model: Optional[str] = None,
        temperature: float = 0.7,
        max_tokens: Optional[int] = None,
        **kwargs: Any,
    ) -> AsyncIterator[Dict[str, Any]]:
        if not self._initialized:
            await self.initialize()
        assert self.agent is not None
        if self.thread_id is not None:
            # Thread-scoped runs key the engine's KV prefix cache by thread,
            # so each turn re-prefills only the conversation suffix
            # (BASELINE config 2; providers without a cache ignore it).
            kwargs.setdefault("prefix_key", self.thread_id)
        async for event in self.agent.run(
            messages,
            model=model or self.default_model,
            temperature=temperature,
            max_tokens=max_tokens,
            **kwargs,
        ):
            yield event
