"""Hand-written CUDA kernels (sm_90a) of the BK and serving hot paths.

One module per Pallas kernel file of the JAX package, named after it:
``ghost_norm``, ``clipped_grad``, ``grad_norm_direct``,
``emb_norm.emb_ghost_norm``, ``emb_grad.emb_clipped_grad``,
``moe_ghost.{moe_ghost_norm, moe_direct_norm, moe_clipped_grad}``,
``fused_clip.fused_clip_grad`` and, on the serving prefill,
``flash_attention`` and ``wkv6``. Each module holds the wrappers (validate
their operands, allocate the outputs, launch on the current stream, count
their launches in ``<wrapper>.launches``) and the plain PyTorch versions
beside them. A wrapper runs the plain version for CPU tensors only; for a
CUDA tensor it launches its kernel or raises. ``build`` compiles and loads
the library.
"""
