"""PyTorch / CUDA port of ``guassianhand_tpu`` for NVIDIA Hopper (H100).

The subpackage layout mirrors the JAX package module for module, so each
port module sits at the same path as its counterpart. Plain tensor code is
PyTorch; the tile-composite forward is a hand-written CUDA kernel
(``ops/rasterize_cuda.py``, source in ``csrc/``) with a plain-PyTorch twin
that the CPU tests use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
