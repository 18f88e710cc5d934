"""Multi-tenant workload replay: three production prompt mixes.

The port's copy of ``repro.workloads``: deterministic request generators
(seeded stdlib ``random``) for the gateway's load and tests. Each mix
shares prefixes its own way:

* ``support`` — customer support: one hot system prompt, a short
  question; the system prefix is cached once and served to everyone.
* ``rag`` — retrieval augmentation: Zipf-popular documents before the
  question, most popular first, so the popular head is a shared prefix.
* ``agent`` — agent loops: a session's transcript grows turn by turn, so
  every turn resumes from the previous turn's cache.
"""
from repro_torch.workloads.mixes import (  # noqa: F401
    MIXES, WorkloadRequest, agent_loops, customer_support, rag,
)
