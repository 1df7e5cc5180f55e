"""Agent abstraction: code-writing agents behind a uniform interface.

Behavioral parity (reference: pdebench/agents/base_agent.py:12-105):
AgentResponse dataclass + BaseAgent ABC with _setup / generate_solution
/ cleanup lifecycle.

Copy of pdebench_tpu/agents/base_agent.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AgentResponse:
    code: str
    success: bool = True
    error_message: str = ""
    raw_response: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def cost_usd(self) -> float:
        return float(self.metadata.get("cost_usd", 0.0))


class BaseAgent(ABC):
    """A code-writing agent. Subclasses implement generate_solution."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self._setup()

    def _setup(self) -> None:
        """Optional one-time initialization (imports, workspace)."""

    @abstractmethod
    def generate_solution(
        self, prompt: str, context: Optional[Dict[str, Any]] = None
    ) -> AgentResponse:
        """Produce solver code for the prompted case."""

    def cleanup(self) -> None:
        """Optional teardown (temp dirs, subprocesses)."""
