"""Hand-written GPU kernels of the port, each beside its plain PyTorch version.

Nothing here builds or loads CUDA code at import time: the shared library is
built by ``_build.load_library`` at the first kernel launch.
"""
