"""PyTorch / CUDA port of ``guassianhand_tpu`` for NVIDIA Hopper (H100).

The subpackage layout mirrors the JAX package module for module, so each
port module sits at the same path as its counterpart. Plain tensor code is
PyTorch; the tile composite's forward and backward and the sorted-segment
sum of its gradients are hand-written CUDA kernels (``ops/rasterize_cuda.py``
and ``ops/segreduce_cuda.py``, sources in ``csrc/``), each with a
plain-PyTorch twin that the CPU tests use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
