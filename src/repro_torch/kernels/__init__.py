"""Hand-written CUDA kernels (sm_90a) of the BK and serving hot paths.

One module per Pallas kernel file of the JAX package, named after it:
``ghost_norm``, ``clipped_grad``, ``grad_norm_direct``,
``emb_norm.emb_ghost_norm``, ``emb_grad.emb_clipped_grad``,
``moe_ghost.{moe_ghost_norm, moe_direct_norm, moe_clipped_grad}``,
``fused_clip.fused_clip_grad`` and, on the serving prefill,
``flash_attention`` and ``wkv6``; and one kernel with no Pallas
counterpart, ``counter_noise`` (phase 4's draw and add). Each module holds
the wrappers (validate their operands, allocate the outputs, launch on the
current stream, count their launches in ``<wrapper>.launches``) and the
plain PyTorch versions beside them. A wrapper runs the plain version for CPU tensors only; for a
CUDA tensor it launches its kernel or raises; for meta tensors while a
plan records (``meta.recording``, ``launch.steps.plan_cell``) it takes the
CUDA tensor's path, allocations and route included, against ``meta.LIB``,
which launches nothing and records; other meta tensors it refuses. ``build`` compiles and loads the library.
"""
