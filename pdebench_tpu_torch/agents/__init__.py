from .base_agent import AgentResponse, BaseAgent
from .agent_registry import AgentRegistry, get_agent

# register the bundled wrappers
from . import wrappers as _wrappers  # noqa: F401

__all__ = ["AgentResponse", "BaseAgent", "AgentRegistry", "get_agent"]
