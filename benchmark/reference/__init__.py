"""The benchmark's plain reference: the one-shot avatar, its data layer
and its fit in plain PyTorch and float32, which the output check holds the
program to.

Frozen copies of the program's plain route (the modules of the same names
under ``guassianhand_tpu_torch``), with the CUDA kernels' routes taken
out: the projection is the plain one, the interaction attention plain
matmul and softmax (``ops/blockwise_attention.py``), the composite written
anew (``ops/rasterize.py``) and Adam written out (``train/fit.py``). The
layers the program runs in bf16 round through ``precision.lowp``, which
leaves them float32 here and is the control's lower precision. Nothing
here imports the program; the copies change only with the benchmark.
"""
