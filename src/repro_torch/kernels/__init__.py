"""Hand-written Hopper kernels with their plain PyTorch versions.

``flash_prefill.flash_prefill``, ``flash_decode.flash_decode``,
``ssd_scan.ssd_scan``, ``mla_decode.mla_decode`` and
``moe_gemm.moe_gemm`` launch CUDA kernels for tensors on the card and
run the plain versions for tensors on the CPU. Each wrapper counts its
launches in ``<wrapper>.launches``. ``flash_prefill``, ``moe_gemm`` and
``ssd_scan`` carry their gradients on the card
(``flash_prefill.flash_prefill_bwd``, ``moe_gemm.moe_gemm_wgrad`` and
``moe_gemm`` reading its weights transposed, ``ssd_scan.ssd_scan_bwd``);
the two decode kernels refuse an input that requires grad there
(``build.refuse_grad``): no training path runs them.
"""
