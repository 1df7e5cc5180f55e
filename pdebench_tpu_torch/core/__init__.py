from .prompt_builder import generate_prompt, generate_nl_description
from .llm_client import call_llm, SUPPORTED_AGENTS, PRICING, extract_code
from .feedback_prompt import create_feedback_prompt

__all__ = [
    "generate_prompt",
    "generate_nl_description",
    "call_llm",
    "SUPPORTED_AGENTS",
    "PRICING",
    "extract_code",
    "create_feedback_prompt",
]
