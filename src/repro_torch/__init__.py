"""PyTorch/CUDA port of the Book-Keeping DP training engine.

Mirrors the layout and names of the JAX package ``repro`` module by module;
params keep its flat ``/``-joined keys and layouts. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``. The hot-path kernels are
hand-written CUDA C++ for sm_90a (``repro_torch.kernels``); on CPU tensors
their wrappers run the plain PyTorch versions.
"""
