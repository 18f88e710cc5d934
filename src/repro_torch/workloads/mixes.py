"""Deterministic generators for the three replay mixes.

A verbatim copy of ``repro.workloads.mixes`` (stdlib only): the same seed
gives the reference's requests, word for word.

Every generator has the same shape::

    mix(n_requests, seed=0, rate_per_s=8.0, **mix_kw) -> List[WorkloadRequest]

Arrivals follow a seeded Poisson process (exponential gaps) so replay
drives the gateway the way production traffic would — bursty, not a
closed loop. Text is synthetic but word-stable: the same seed always
produces the same token ids through :class:`WordHashTokenizer`, which
is what makes cross-run token-identity checks possible.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

Message = Tuple[str, str]                      # (role, content)


@dataclass
class WorkloadRequest:
    """One replayable chat request."""
    tenant: str
    messages: Tuple[Message, ...]
    max_new_tokens: int = 8
    arrival_s: float = 0.0                      # offset from replay start
    session: str = ""                           # agent-loop session id
    mix: str = ""

    def body(self, stream: bool = False) -> dict:
        """The OpenAI chat-completions request body for this entry."""
        return {
            "messages": [{"role": r, "content": c}
                         for r, c in self.messages],
            "max_tokens": self.max_new_tokens,
            "stream": stream,
            "user": self.tenant,
        }


def _words(rng: random.Random, n: int) -> str:
    return " ".join(f"w{rng.randrange(10_000)}" for _ in range(n))


def _arrivals(rng: random.Random, n: int, rate_per_s: float
              ) -> List[float]:
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_per_s) if rate_per_s > 0 else 0.0
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# mix 1: customer support — one hot system prompt
# ---------------------------------------------------------------------------

def customer_support(n_requests: int, seed: int = 0,
                     rate_per_s: float = 8.0, n_tenants: int = 3,
                     system_words: int = 48, question_words: int = 6,
                     max_new_tokens: int = 8) -> List[WorkloadRequest]:
    """Every request shares one long system prompt; the user question
    is short and unique. Cache behaviour: one cold upload, then every
    request is a long-prefix partial hit."""
    rng = random.Random(seed)
    system = ("You are the support assistant for AcmeEdge devices. "
              + _words(rng, system_words))
    arrivals = _arrivals(rng, n_requests, rate_per_s)
    out = []
    for i in range(n_requests):
        q = f"ticket {i}: " + _words(rng, question_words)
        out.append(WorkloadRequest(
            tenant=f"support-{rng.randrange(n_tenants)}",
            messages=(("system", system), ("user", q)),
            max_new_tokens=max_new_tokens,
            arrival_s=arrivals[i], mix="support"))
    return out


# ---------------------------------------------------------------------------
# mix 2: RAG — Zipf-popular document pool
# ---------------------------------------------------------------------------

def _zipf_pick(rng: random.Random, n: int, a: float) -> int:
    """Index in [0, n) with P(i) ~ 1/(i+1)^a (finite Zipf, inverse CDF)."""
    weights = [1.0 / (i + 1) ** a for i in range(n)]
    total = sum(weights)
    x = rng.random() * total
    for i, w in enumerate(weights):
        x -= w
        if x <= 0:
            return i
    return n - 1


def rag(n_requests: int, seed: int = 0, rate_per_s: float = 8.0,
        n_tenants: int = 2, n_docs: int = 12, docs_per_request: int = 2,
        zipf_a: float = 1.2, doc_words: int = 24, question_words: int = 5,
        max_new_tokens: int = 8) -> List[WorkloadRequest]:
    """Requests stuff ``docs_per_request`` documents drawn from a
    Zipf-popular pool, *sorted most-popular-first*, so the hot head
    document(s) form a shared prefix across requests even when the
    tail documents differ."""
    rng = random.Random(seed)
    docs = [f"[doc {d}] " + _words(rng, doc_words) for d in range(n_docs)]
    arrivals = _arrivals(rng, n_requests, rate_per_s)
    out = []
    for i in range(n_requests):
        picked = set()
        while len(picked) < min(docs_per_request, n_docs):
            picked.add(_zipf_pick(rng, n_docs, zipf_a))
        context = [("system", docs[d]) for d in sorted(picked)]
        q = f"query {i}: " + _words(rng, question_words)
        out.append(WorkloadRequest(
            tenant=f"rag-{rng.randrange(n_tenants)}",
            messages=tuple(context) + (("user", q),),
            max_new_tokens=max_new_tokens,
            arrival_s=arrivals[i], mix="rag"))
    return out


# ---------------------------------------------------------------------------
# mix 3: agent loops — growing conversation prefixes
# ---------------------------------------------------------------------------

def agent_loops(n_requests: int, seed: int = 0, rate_per_s: float = 8.0,
                n_sessions: int = 3, step_words: int = 10,
                max_new_tokens: int = 8) -> List[WorkloadRequest]:
    """``n_sessions`` interleaved agent sessions; each turn appends a
    tool observation to the transcript, so turn *t*'s prompt extends
    turn *t-1*'s. The cache serves every turn after the first from the
    previous turn's uploaded ranges."""
    rng = random.Random(seed)
    arrivals = _arrivals(rng, n_requests, rate_per_s)
    transcripts: Dict[int, List[Message]] = {
        s: [("system", f"agent session {s}: plan and act. "
             + _words(rng, step_words))]
        for s in range(n_sessions)
    }
    out = []
    for i in range(n_requests):
        s = i % n_sessions                      # round-robin keeps every
        turn = len(transcripts[s])              # session growing evenly
        transcripts[s].append(
            ("tool", f"step {turn}: " + _words(rng, step_words)))
        out.append(WorkloadRequest(
            tenant=f"agent-{s}",
            messages=tuple(transcripts[s]),
            max_new_tokens=max_new_tokens,
            arrival_s=arrivals[i],
            session=f"s{s}", mix="agent"))
    return out


MIXES = {
    "support": customer_support,
    "rag": rag,
    "agent": agent_loops,
}
