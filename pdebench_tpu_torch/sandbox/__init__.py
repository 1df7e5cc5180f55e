from .executor import ExecutionResult, execute_agent_function
from .cpp_executor import CppExecutor

__all__ = ["ExecutionResult", "execute_agent_function", "CppExecutor"]
