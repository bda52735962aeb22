"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``csrc/`` holds the sources, ``_build`` compiles and loads them)."""
