"""Hand-written Hopper kernels with their plain PyTorch versions.

``flash_prefill.flash_prefill`` and ``flash_decode.flash_decode`` launch
CUDA kernels for tensors on the card and run the plain versions for
tensors on the CPU. Each wrapper counts its launches in
``<wrapper>.launches``.
"""
