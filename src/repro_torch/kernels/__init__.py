"""Hand-written Hopper kernels with their plain PyTorch versions.

``flash_prefill.flash_prefill``, ``flash_decode.flash_decode``,
``ssd_scan.ssd_scan`` and ``mla_decode.mla_decode`` launch CUDA kernels
for tensors on the card and run the plain versions for tensors on the
CPU. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
