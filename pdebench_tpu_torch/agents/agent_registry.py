"""Name -> agent class registry.

Behavioral parity (reference: pdebench/agents/agent_registry.py:11-73).
Anything not registered here is treated as a plain LLM model name by the
driver (routed through core.llm_client).

Copy of pdebench_tpu/agents/agent_registry.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

from .base_agent import BaseAgent


class AgentRegistry:
    _registry: Dict[str, Type[BaseAgent]] = {}

    @classmethod
    def register(cls, name: str, agent_cls: Type[BaseAgent]) -> None:
        cls._registry[name] = agent_cls

    @classmethod
    def is_registered(cls, name: str) -> bool:
        return name in cls._registry

    @classmethod
    def names(cls):
        return sorted(cls._registry)

    @classmethod
    def create(
        cls, name: str, config: Optional[Dict[str, Any]] = None
    ) -> BaseAgent:
        if name not in cls._registry:
            raise KeyError(
                f"agent '{name}' is not registered; known: {cls.names()}"
            )
        return cls._registry[name](config)


def get_agent(name: str, config: Optional[Dict[str, Any]] = None) -> BaseAgent:
    return AgentRegistry.create(name, config)


def register(name: str):
    """Class decorator: @register('my-agent')."""

    def deco(agent_cls: Type[BaseAgent]):
        AgentRegistry.register(name, agent_cls)
        return agent_cls

    return deco
