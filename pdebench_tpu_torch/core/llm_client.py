"""Unified multi-provider LLM client with usage/cost accounting.

Behavioral parity (reference: pdebench/core/llm_client.py:27-408): a
SUPPORTED_AGENTS registry mapping agent names to (provider, model id), a
PRICING table in $/Mtok, markdown code-block extraction, and a
`call_llm(agent, prompt)` entry returning (code, meta) with token/cost/
latency accounting. Provider SDKs (openai / anthropic-on-bedrock /
google-genai / dashscope) are imported lazily and failures surface as
LLMError — the benchmark harness treats that as an LLM_ERROR status, so
the pipeline is fully testable offline via the 'mock' provider.

Copy of pdebench_tpu/core/llm_client.py.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, Optional, Tuple

# agent name -> (provider, model id)
SUPPORTED_AGENTS: Dict[str, Tuple[str, str]] = {
    # OpenAI
    "gpt-4o": ("openai", "gpt-4o"),
    "gpt-4o-mini": ("openai", "gpt-4o-mini"),
    "gpt-4.1": ("openai", "gpt-4.1"),
    "o3-mini": ("openai", "o3-mini"),
    "o4-mini": ("openai", "o4-mini"),
    "gpt-5": ("openai", "gpt-5"),
    # Anthropic via Bedrock (reference used boto3/bedrock)
    "claude-sonnet-4": ("bedrock", "anthropic.claude-sonnet-4-20250514-v1:0"),
    "claude-opus-4": ("bedrock", "anthropic.claude-opus-4-20250514-v1:0"),
    "claude-3-7-sonnet": ("bedrock", "anthropic.claude-3-7-sonnet-20250219-v1:0"),
    # Google
    "gemini-2.5-pro": ("google", "gemini-2.5-pro"),
    "gemini-2.5-flash": ("google", "gemini-2.5-flash"),
    # Qwen via DashScope's OpenAI-compatible endpoint
    "qwen-max": ("dashscope", "qwen-max"),
    "qwen-coder": ("dashscope", "qwen2.5-coder-32b-instruct"),
    "deepseek-v3": ("dashscope", "deepseek-v3"),
    # offline testing
    "mock": ("mock", "mock"),
}

# $ per million tokens: (input, output)
PRICING: Dict[str, Tuple[float, float]] = {
    "gpt-4o": (2.5, 10.0),
    "gpt-4o-mini": (0.15, 0.6),
    "gpt-4.1": (2.0, 8.0),
    "o3-mini": (1.1, 4.4),
    "o4-mini": (1.1, 4.4),
    "gpt-5": (1.25, 10.0),
    "claude-sonnet-4": (3.0, 15.0),
    "claude-opus-4": (15.0, 75.0),
    "claude-3-7-sonnet": (3.0, 15.0),
    "gemini-2.5-pro": (1.25, 10.0),
    "gemini-2.5-flash": (0.3, 2.5),
    "qwen-max": (1.6, 6.4),
    "qwen-coder": (0.5, 1.5),
    "deepseek-v3": (0.27, 1.1),
    "mock": (0.0, 0.0),
}


class LLMError(RuntimeError):
    pass


def extract_code(text: str, language_hints=("python", "cpp", "c++")) -> str:
    """Pull solver code out of markdown fences (largest block wins).

    Reference: llm_client.py:27-44.
    """
    blocks = re.findall(r"```(?:\w+\+*)?\s*\n(.*?)```", text, re.DOTALL)
    if blocks:
        return max(blocks, key=len).strip()
    return text.strip()


def _estimate_cost(agent: str, in_tok: int, out_tok: int) -> float:
    pin, pout = PRICING.get(agent, (0.0, 0.0))
    return (in_tok * pin + out_tok * pout) / 1e6


def _call_openai_compat(model, prompt, base_url, api_key, max_tokens):
    from openai import OpenAI

    client = OpenAI(base_url=base_url, api_key=api_key)
    resp = client.chat.completions.create(
        model=model,
        messages=[{"role": "user", "content": prompt}],
        max_tokens=max_tokens,
    )
    usage = resp.usage
    return resp.choices[0].message.content, (
        usage.prompt_tokens if usage else 0,
        usage.completion_tokens if usage else 0,
    )


_MOCK_CALL_COUNT = 0


def _call_provider(
    provider: str, model: str, prompt: str, max_tokens: int
) -> Tuple[str, Tuple[int, int]]:
    if provider == "mock":
        # deterministic offline stub for pipeline tests; a response file
        # lets tests round-trip arbitrary solver code (e.g. the docs
        # guide examples) through the full driver without a network.
        # "\n===NEXT===\n"-separated chunks are served sequentially
        # (cycling at the end) so multi-call loops — feedback retries,
        # repeated sampling — are testable offline too.
        resp_file = os.environ.get("PDEBENCH_MOCK_RESPONSE_FILE")
        if resp_file:
            text = open(resp_file).read()
            chunks = text.split("\n===NEXT===\n")
            global _MOCK_CALL_COUNT
            text = chunks[min(_MOCK_CALL_COUNT, len(chunks) - 1)]
            _MOCK_CALL_COUNT += 1
            return text, (len(prompt) // 4, len(text) // 4)
        return (
            "```python\nimport numpy as np\n\ndef solve(case_spec):\n"
            "    grid = case_spec.get('oracle_config', case_spec)['output']['grid']\n"
            "    shape = (grid['nz'], grid['ny'], grid['nx']) if grid.get('nz') "
            "else (grid['ny'], grid['nx'])\n"
            "    return {'u': np.zeros(shape), 'solver_info': {\n"
            "        'mesh_resolution': 16, 'element_degree': 1,\n"
            "        'ksp_type': 'cg', 'pc_type': 'jacobi', 'rtol': 1e-8}}\n```",
            (len(prompt) // 4, 128),
        )
    if provider == "openai":
        return _call_openai_compat(
            model, prompt, None, os.environ.get("OPENAI_API_KEY"), max_tokens
        )
    if provider == "dashscope":
        return _call_openai_compat(
            model,
            prompt,
            "https://dashscope.aliyuncs.com/compatible-mode/v1",
            os.environ.get("DASHSCOPE_API_KEY"),
            max_tokens,
        )
    if provider == "bedrock":
        import json as _json

        import boto3

        client = boto3.client(
            "bedrock-runtime",
            region_name=os.environ.get("AWS_REGION", "us-west-2"),
        )
        body = {
            "anthropic_version": "bedrock-2023-05-31",
            "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": prompt}],
        }
        resp = client.invoke_model(modelId=model, body=_json.dumps(body))
        data = _json.loads(resp["body"].read())
        text = "".join(
            blk.get("text", "") for blk in data.get("content", [])
        )
        usage = data.get("usage", {})
        return text, (
            usage.get("input_tokens", 0),
            usage.get("output_tokens", 0),
        )
    if provider == "google":
        from google import genai

        client = genai.Client(api_key=os.environ.get("GOOGLE_API_KEY"))
        resp = client.models.generate_content(model=model, contents=prompt)
        meta = getattr(resp, "usage_metadata", None)
        return resp.text, (
            getattr(meta, "prompt_token_count", 0) or 0,
            getattr(meta, "candidates_token_count", 0) or 0,
        )
    raise LLMError(f"unknown provider: {provider}")


def call_llm(
    agent: str,
    prompt: str,
    max_tokens: int = 16384,
    extract: bool = True,
) -> Tuple[str, Dict[str, Any]]:
    """Call the named agent; returns (code_or_text, meta).

    meta: {model, provider, input_tokens, output_tokens, cost_usd,
    latency_sec}. Raises LLMError on provider failure (the driver maps
    this to an LLM_ERROR case status).
    """
    if agent not in SUPPORTED_AGENTS:
        raise LLMError(
            f"unsupported agent '{agent}'; known: {sorted(SUPPORTED_AGENTS)}"
        )
    provider, model = SUPPORTED_AGENTS[agent]
    t0 = time.time()
    try:
        text, (in_tok, out_tok) = _call_provider(
            provider, model, prompt, max_tokens
        )
    except LLMError:
        raise
    except Exception as e:
        raise LLMError(f"{provider}/{model} call failed: {e}") from e
    latency = time.time() - t0
    meta = {
        "model": model,
        "provider": provider,
        "input_tokens": in_tok,
        "output_tokens": out_tok,
        "cost_usd": _estimate_cost(agent, in_tok, out_tok),
        "latency_sec": latency,
    }
    return (extract_code(text) if extract else text), meta
