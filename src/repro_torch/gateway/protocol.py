"""OpenAI-compatible request/response shapes + SSE framing.

A copy of ``repro.gateway.protocol``. Pure data layer — no torch, no
sockets. The HTTP server parses request
bodies through :func:`parse_completion` / :func:`parse_chat`, the
engine thread tokenizes through :func:`tokenize_prompt` /
:func:`tokenize_messages`, and responses are assembled by the
``completion_*`` / ``chat_*`` builders. Tokenization is shared with
the tests and the load generator, so a gateway completion and a direct
scheduler run see byte-identical token ids (the token-identity
acceptance bar).

Chat prompts are flattened deterministically — message i becomes
``[role] content`` with BOS only on the first — and every message end
is a :class:`PromptSegments` boundary, so conversation prefixes (the
agent-loop mix) and shared system prompts (the support mix) land on
cacheable range keys.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.segments import PromptSegments

ROLES = ("system", "user", "assistant", "tool")
SSE_DONE = b"data: [DONE]\n\n"


class BadRequest(Exception):
    """Maps to HTTP 400 with an OpenAI-style error body."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise BadRequest(msg)


# ---------------------------------------------------------------------------
# request parsing
# ---------------------------------------------------------------------------

@dataclass
class ParsedRequest:
    """A validated completion/chat request, pre-tokenization."""
    kind: str                          # "completion" | "chat"
    prompt: str = ""                   # completion mode
    messages: Tuple[Tuple[str, str], ...] = ()   # chat mode (role, content)
    max_tokens: int = 16
    stream: bool = False
    tenant: str = "default"
    model: str = ""
    # end-to-end latency budget in seconds (extension field): the
    # engine prices fetch plans against it, skips attempts that can't
    # finish inside it, and rides the remaining budget to the peers
    deadline_s: Optional[float] = None
    echo_meta: Dict[str, object] = field(default_factory=dict)


def _common_opts(body: dict, req: ParsedRequest,
                 max_tokens_cap: int) -> None:
    mt = body.get("max_tokens", 16)
    _require(isinstance(mt, int) and not isinstance(mt, bool) and mt >= 1,
             "'max_tokens' must be a positive integer")
    _require(mt <= max_tokens_cap,
             f"'max_tokens' must be <= {max_tokens_cap}")
    req.max_tokens = mt
    stream = body.get("stream", False)
    _require(isinstance(stream, bool), "'stream' must be a boolean")
    req.stream = stream
    # the gateway decodes greedily (token-identity with the scheduler
    # is the contract); any sampling temperature is a client error
    temp = body.get("temperature", 0)
    _require(isinstance(temp, (int, float)) and not isinstance(temp, bool)
             and float(temp) == 0.0,
             "'temperature' must be 0 (greedy): this gateway serves "
             "deterministic completions")
    user = body.get("user", "")
    _require(isinstance(user, str), "'user' must be a string")
    if user:
        req.tenant = user
    model = body.get("model", "")
    _require(isinstance(model, str), "'model' must be a string")
    req.model = model
    ddl = body.get("deadline_s")
    if ddl is not None:
        _require(isinstance(ddl, (int, float))
                 and not isinstance(ddl, bool) and float(ddl) > 0.0,
                 "'deadline_s' must be a positive number")
        req.deadline_s = float(ddl)


def parse_completion(body: dict, max_tokens_cap: int = 256
                     ) -> ParsedRequest:
    _require(isinstance(body, dict), "request body must be a JSON object")
    req = ParsedRequest(kind="completion")
    prompt = body.get("prompt")
    _require(isinstance(prompt, str) and len(prompt) > 0,
             "'prompt' must be a non-empty string")
    req.prompt = prompt
    _common_opts(body, req, max_tokens_cap)
    return req


def parse_chat(body: dict, max_tokens_cap: int = 256) -> ParsedRequest:
    _require(isinstance(body, dict), "request body must be a JSON object")
    req = ParsedRequest(kind="chat")
    messages = body.get("messages")
    _require(isinstance(messages, list) and len(messages) > 0,
             "'messages' must be a non-empty array")
    parsed = []
    for i, m in enumerate(messages):
        _require(isinstance(m, dict), f"messages[{i}] must be an object")
        role, content = m.get("role"), m.get("content")
        _require(role in ROLES,
                 f"messages[{i}].role must be one of {ROLES}")
        _require(isinstance(content, str) and len(content) > 0,
                 f"messages[{i}].content must be a non-empty string")
        parsed.append((role, content))
    req.messages = tuple(parsed)
    _common_opts(body, req, max_tokens_cap)
    return req


# ---------------------------------------------------------------------------
# tokenization (shared by gateway, tests, and the load generator)
# ---------------------------------------------------------------------------

def tokenize_prompt(tok, prompt: str) -> PromptSegments:
    """Plain completion prompt: one segment, boundary at full length."""
    ids = tok.encode(prompt, bos=True)
    return PromptSegments.make(ids, [len(ids)])


def tokenize_messages(tok, messages: Sequence[Tuple[str, str]]
                      ) -> PromptSegments:
    """Chat transcript -> token ids with a range boundary after every
    message, so shared conversation prefixes become cacheable keys."""
    ids: List[int] = []
    bounds: List[int] = []
    for i, (role, content) in enumerate(messages):
        ids.extend(tok.encode(f"[{role}] {content}", bos=(i == 0)))
        bounds.append(len(ids))
    return PromptSegments.make(ids, bounds)


def tokenize_request(tok, req: ParsedRequest) -> PromptSegments:
    if req.kind == "chat":
        return tokenize_messages(tok, req.messages)
    return tokenize_prompt(tok, req.prompt)


# ---------------------------------------------------------------------------
# response building
# ---------------------------------------------------------------------------

def _usage(n_prompt: int, n_out: int) -> dict:
    return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
            "total_tokens": n_prompt + n_out}


def _cache_meta(meta: dict) -> dict:
    """Non-OpenAI extension: how the prompt cache served this request,
    and the trace id (``GET /v1/traces/<trace_id>``) where tracing is on."""
    out = {"matched_tokens": int(meta.get("matched_tokens", 0)),
           "served_by": meta.get("served_by", "")}
    if meta.get("trace_id"):
        out["trace_id"] = meta["trace_id"]
    return out


def completion_response(tok, rid: str, created: int, model: str,
                        tokens: List[int], n_prompt: int,
                        finish_reason: str, meta: dict) -> dict:
    return {
        "id": rid, "object": "text_completion", "created": created,
        "model": model,
        "choices": [{"index": 0, "text": tok.decode(tokens),
                     "token_ids": [int(t) for t in tokens],
                     "finish_reason": finish_reason}],
        "usage": _usage(n_prompt, len(tokens)),
        "cache": _cache_meta(meta),
    }


def chat_response(tok, rid: str, created: int, model: str,
                  tokens: List[int], n_prompt: int,
                  finish_reason: str, meta: dict) -> dict:
    return {
        "id": rid, "object": "chat.completion", "created": created,
        "model": model,
        "choices": [{"index": 0,
                     "message": {"role": "assistant",
                                 "content": tok.decode(tokens)},
                     "token_ids": [int(t) for t in tokens],
                     "finish_reason": finish_reason}],
        "usage": _usage(n_prompt, len(tokens)),
        "cache": _cache_meta(meta),
    }


def stream_chunk(tok, rid: str, created: int, model: str, kind: str,
                 token: Optional[int],
                 finish_reason: Optional[str]) -> bytes:
    """One SSE event: ``data: {json}\\n\\n``. ``token=None`` emits the
    terminal finish chunk (followed by ``data: [DONE]`` by the
    caller)."""
    if kind == "chat":
        delta = {} if token is None else \
            {"role": "assistant", "content": tok.decode([token])}
        choice = {"index": 0, "delta": delta,
                  "finish_reason": finish_reason}
        obj = "chat.completion.chunk"
    else:
        choice = {"index": 0,
                  "text": "" if token is None else tok.decode([token]),
                  "finish_reason": finish_reason}
        obj = "text_completion"
    if token is not None:
        choice["token_id"] = int(token)
    payload = {"id": rid, "object": obj, "created": created,
               "model": model, "choices": [choice]}
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


def error_body(message: str, etype: str = "invalid_request_error",
               code: Optional[int] = None) -> bytes:
    err = {"message": message, "type": etype}
    if code is not None:
        err["code"] = code
    return json.dumps({"error": err}).encode()
