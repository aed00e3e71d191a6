"""Hand-written CUDA kernels for the port, with their plain versions.

- ``bdmm``            : block-diagonal matmul, fp or int8 weights, general
                        and decode-shaped grids (``csrc/bdmm.cu``)
- ``paged_attention`` : decode-step attention over the paged KV pool
                        (``csrc/paged_attention.cu``)
- ``paged_prefill``   : chunked-prefill attention over the same pool
                        (``csrc/paged_prefill.cu``)
- ``quant``           : per-output-channel int8 block quantization
- ``ops``             : backend routing (``set_backend("cuda" | "torch")``)
- ``ref``             : the plain PyTorch versions

Kernels are built with ``nvcc`` on first use (``_build``), never at import.
"""
