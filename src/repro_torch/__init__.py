"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch on the host side and hand-written CUDA kernels
(``csrc/``) for every Pallas TPU kernel on its path. It never imports JAX or
``repro``: the numpy-only modules it needs are copied here.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve`). On a CPU tensor
every kernel wrapper takes its plain PyTorch version; on a CUDA tensor it
launches the kernel or raises.

Ported so far (paged int8 serving; single-device training in the
paper-faithful masked-dense mode or the packed mode, folded to serving; and
the paper's Fig-3 deploy chain through a packed artifact on disk):

- ``core``: masks (with ``chain_specs``), permutations, policy plans,
  fold/unfold and the fold gathers, MPD linear in all three modes,
  ``fold_model``, the permutation-fusion rewrite and ``quantize_packed``
  (int8, int4 storage);
- ``kernels``: ``bdmm`` (general + decode-shaped), ``fused_ffn``,
  ``masked_matmul`` (both orientations) and ``sddmm_masked``,
  ``paged_attention`` (decode), ``paged_prefill_attention``, their plain
  versions, routing and the autograd rules;
- ``models``: norms, RoPE, embeddings, the unfused and the fused FFN,
  MoE (capacity-bounded top-k routing, a shared expert), training and
  paged attention, and ``Model`` for attention and attention + MoE
  patterns (loss with the MoE aux term, mask projection, ``to_packed``);
- ``configs``: olmo-1b, granite-8b, minitron-4b, command-r-plus-104b,
  qwen2-moe-a2.7b, llama4-maverick-400b-a17b and LeNet-300-100;
- ``checkpoint``: ``save``/``restore`` and the packed artifact
  (``export_packed``/``load_packed``), in the reference's format;
- ``optim``, ``data`` (``SyntheticLM``), ``dist`` (the step-time monitor)
  and ``train``: AdamW/SGD and the training loop;
- ``serve``: page pool, prefix trie, scheduler, greedy/top-k sampling,
  metrics, and the paged continuous-batching ``Engine``;
- ``launch.serve`` and ``launch.train``: the launchers.
"""
