"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version, a wrapper and a launch count (port of ``cliffordtpu/kernels``).

Sources live in ``cliffordtpu_torch/csrc``; ``build.py`` compiles them.
"""
