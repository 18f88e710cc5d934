"""PyTorch / CUDA port of the distributed prompt-cache system.

A second package beside the JAX reference (``repro``): it imports
``torch`` and never ``jax`` or ``repro``. The module layout mirrors the
reference so each counterpart is easy to find. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version.

It covers the paper's edge request on a dense model and on an SSM:
prompt keys, the Bloom catalog, the cache server, v2 state blobs,
prefill with prefix resume (from a recurrent state for the SSM), greedy
decode, and the hand-written Hopper kernels (``kernels/csrc``: attention
prefill and decode, the SSD chunk scan).
"""
