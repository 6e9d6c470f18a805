"""OpenAI-compatible request/response models, from
``moe_infinity_tpu/entrypoints/openai/protocol.py``: ``CompletionRequest``
and ``ChatCompletionRequest`` with the standard sampling fields mapped onto
the generate keywords, as plain dataclasses (the server is stdlib-only).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


def _gen_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def _sampling_kwargs(req) -> Dict[str, Any]:
    """The request's sampling fields as generate keywords."""
    kw: Dict[str, Any] = {}
    if req.temperature == 0.0:
        kw["temperature"] = 0.0
    else:
        kw["do_sample"] = True
        kw["temperature"] = req.temperature
    if req.top_p != 1.0:
        kw["top_p"] = req.top_p
    if getattr(req, "top_k", 0):
        kw["top_k"] = req.top_k
    if getattr(req, "min_p", 0.0):
        kw["min_p"] = req.min_p
    if req.presence_penalty:
        kw["presence_penalty"] = req.presence_penalty
    if req.frequency_penalty:
        kw["frequency_penalty"] = req.frequency_penalty
    if getattr(req, "repetition_penalty", 1.0) != 1.0:
        kw["repetition_penalty"] = req.repetition_penalty
    if req.seed is not None:
        kw["seed"] = req.seed
    if getattr(req, "logit_bias", None):
        # OpenAI sends {token_id_string: bias}; map to int token ids
        kw["logit_bias"] = {
            int(t): float(v) for t, v in req.logit_bias.items()
        }
    return kw


def stop_list(stop: Union[str, List[str], None]) -> List[str]:
    if stop is None:
        return []
    return [stop] if isinstance(stop, str) else [s for s in stop if s]


@dataclass
class CompletionRequest:
    model: str = ""
    prompt: Union[str, List[str]] = ""
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    n: int = 1
    stream: bool = False
    stop: Union[str, List[str], None] = None
    seed: Optional[int] = None
    echo: bool = False
    logprobs: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    best_of: Optional[int] = None
    logit_bias: Optional[Dict[str, float]] = None
    # accepted for OpenAI-client compatibility; unused
    suffix: Optional[str] = None
    user: Optional[str] = None

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "CompletionRequest":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_generate_kwargs(self) -> Dict[str, Any]:
        kw = {"max_new_tokens": self.max_tokens, **_sampling_kwargs(self)}
        if self.logprobs:
            kw["logprobs"] = int(self.logprobs)
        return kw


@dataclass
class ChatCompletionRequest:
    model: str = ""
    messages: List[Dict[str, str]] = field(default_factory=list)
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    n: int = 1
    stream: bool = False
    stop: Union[str, List[str], None] = None
    seed: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logit_bias: Optional[Dict[str, float]] = None
    user: Optional[str] = None

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "ChatCompletionRequest":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_generate_kwargs(self) -> Dict[str, Any]:
        return {
            "max_new_tokens": self.max_completion_tokens or self.max_tokens or 16,
            **_sampling_kwargs(self),
        }


def usage(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def completion_response(model: str, text: str, prompt_tokens: int,
                        completion_tokens: int, finish_reason: str = "stop"):
    return {
        "id": _gen_id("cmpl"),
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": text,
                "logprobs": None,
                "finish_reason": finish_reason,
            }
        ],
        "usage": usage(prompt_tokens, completion_tokens),
    }


def chat_response(model: str, text: str, prompt_tokens: int,
                  completion_tokens: int, finish_reason: str = "stop"):
    return {
        "id": _gen_id("chatcmpl"),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish_reason,
            }
        ],
        "usage": usage(prompt_tokens, completion_tokens),
    }


def chat_chunk(rid: str, model: str, delta: str, finish: Optional[str] = None):
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "delta": {"content": delta} if delta else {},
                "finish_reason": finish,
            }
        ],
    }
