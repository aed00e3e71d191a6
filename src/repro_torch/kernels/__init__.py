"""Hand-written CUDA kernels for the port, with their plain versions.

- ``bdmm``            : block-diagonal matmul, fp or int8 weights, general
                        and decode-shaped grids (``csrc/bdmm.cu``)
- ``fused_ffn``       : the perm-fused packed MLP (up, gate, down) in one
                        launch, fp or int8 weights (``csrc/fused_ffn.cu``)
- ``masked_matmul``   : ``act(x @ (M∘W) + b)`` in both orientations and the
                        masked weight gradient ``(xᵀ g) ∘ M`` of
                        masked-dense training (``csrc/masked_matmul.cu``)
- ``paged_attention`` : decode-step attention over the paged KV pool
                        (``csrc/paged_attention.cu``) and the speculative
                        verify window (``csrc/paged_verify.cu``)
- ``paged_prefill``   : chunked-prefill attention over the same pool
                        (``csrc/paged_prefill.cu``)
- ``quant``           : per-output-channel int8 block quantization and int4
                        nibble storage
- ``ops``             : backend routing (``set_backend("cuda" | "torch")``)
                        and the autograd rules of bdmm and masked_matmul
- ``ref``             : the plain PyTorch versions

Kernels are built with ``nvcc`` on first use (``_build``), never at import.
"""
