"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch on the host side and hand-written CUDA kernels
(``csrc/``) for every Pallas TPU kernel on its path. It never imports JAX or
``repro``: the numpy-only modules it needs are copied here.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve`). On a CPU tensor
every kernel wrapper takes its plain PyTorch version; on a CUDA tensor it
launches the kernel or raises.

Ported so far (the paged int8 serving path):

- ``core``: masks, permutations, policy plans, fold gathers, MPD linear,
  ``quantize_packed``;
- ``kernels``: ``bdmm`` (general + decode-shaped), ``paged_attention``
  (decode), ``paged_prefill_attention``, their plain versions and routing;
- ``models``: norms, RoPE, embeddings, the unfused FFN, paged attention and
  the attention-only ``Model``;
- ``serve``: page pool, prefix trie, scheduler, greedy/top-k sampling,
  metrics, and the paged continuous-batching ``Engine``;
- ``launch.serve``: the serving launcher.
"""
