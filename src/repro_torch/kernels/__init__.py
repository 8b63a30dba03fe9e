"""Hand-written CUDA kernels (sm_90a) of the BK hot path.

One module per kernel, named after the JAX package's Pallas kernel it
replaces: ``ghost_norm``, ``clipped_grad``, ``emb_norm.emb_ghost_norm`` and
``emb_grad.emb_clipped_grad``. Each module holds the wrapper (validates its
operands, allocates the outputs, launches on the current stream, counts its
launches in ``<wrapper>.launches``) and the plain PyTorch version beside it.
A wrapper runs the plain version for CPU tensors only; for a CUDA tensor it
launches its kernel or raises. ``build`` compiles and loads the library.
"""
