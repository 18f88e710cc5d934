"""PyTorch / CUDA port of the distributed prompt-cache system.

A second package beside the JAX reference (``repro``): it imports
``torch`` and never ``jax`` or ``repro``. The module layout mirrors the
reference so each counterpart is easy to find. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version.

It covers the paper's edge request on dense, SSM and MLA models: prompt
keys, the Bloom catalog, the cache server, v2 and v3 (``PC3``) state
blobs, prefill with prefix resume (from a recurrent state for the SSM),
greedy decode, the batched engine and scheduler, the network (simulated
Wi-Fi, the TCP wire, supervised peer daemons) and the multi-peer cache
fabric (directory, placement, replication, fetch planner, deadlines and
hedged fetches, the ``Fabric`` facade, the session pool), the
OpenAI-compatible HTTP gateway with its workload mixes, and the hand-written
Hopper kernels (``kernels/csrc``: attention prefill and decode, MLA
decode, the SSD chunk scan).
"""
